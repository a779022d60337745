"""Gold-model transmitter: full 802.11a/n/ac 20 MHz waveform synthesis.

Produces baseband sample streams numerically identical (float tolerance) to
the reference PY-TB generator (``tools/phy80211.py:79-830``):
L / HT / VHT formats, SISO and 2x2, and VHT NDP sounding packets.

Design: instead of the reference's per-field object pipeline, every OFDM
symbol is assembled as a row of a (n_chunks, nss, 64) frequency grid plus a
per-chunk scale; time conversion, guard insertion and boundary windowing are
single vectorized passes, the structure a batched TX runs over a packet axis.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .params import Fmt, PhyConfig, N_SERVICE, N_TAIL
from . import bits as B
from . import sig as S


# ---------------------------------------------------------------------------
# Data-field bit pipeline
# ---------------------------------------------------------------------------

def data_field_bits(cfg: PhyConfig, payload: bytes, sigb_crc: np.ndarray) -> np.ndarray:
    """SERVICE + PSDU(+EOF/oct pad) + [tail] + pad bits, pre-scrambling."""
    pbits = T.bytes_to_bits(payload)
    if cfg.fmt == Fmt.VHT:
        service = np.concatenate([np.zeros(8, np.uint8), sigb_crc])
        psdu = np.concatenate(
            [pbits] + [T.VHT_EOF_BITS] * cfg.n_pad_eof
            + [np.zeros(8 * cfg.n_pad_octet, np.uint8)])
        return np.concatenate([service, psdu, np.zeros(cfg.n_pad_bits, np.uint8)])
    service = np.zeros(N_SERVICE, np.uint8)
    return np.concatenate(
        [service, pbits, np.zeros(N_TAIL * cfg.nes, np.uint8),
         np.zeros(cfg.n_pad_bits, np.uint8)])


def encode_data_bits(cfg: PhyConfig, data_bits: np.ndarray, seed: int = 93) -> np.ndarray:
    """Scramble -> (tail handling) -> BCC -> puncture.  Returns coded stream."""
    scrambled = B.scramble(data_bits, seed)
    if cfg.fmt == Fmt.VHT:
        # VHT scrambles everything, then the last 6 scrambled bits are
        # replaced by clean zero tails appended to each encoder's input.
        enc_in = np.concatenate(
            [scrambled[: cfg.nsym * cfg.ndbps - 6], np.zeros(6, np.uint8)])
    else:
        scrambled = scrambled.copy()
        scrambled[N_SERVICE + 8 * cfg.psdu_len: N_SERVICE + 8 * cfg.psdu_len + 6 * cfg.nes] = 0
        enc_in = scrambled
    return B.bcc_encode_punct(enc_in, cfg.cr)


def modulate_data_symbols(cfg: PhyConfig, coded: np.ndarray) -> np.ndarray:
    """Coded stream -> per-stream QAM symbols, shape (nss, nsym, nsd)."""
    legacy = cfg.fmt == Fmt.L
    if cfg.nss == 1:
        streams = coded[None]
    else:
        streams = B.stream_parse(coded, cfg.nbpscs, cfg.nss, cfg.nsym)
    tab = T.qam_table(cfg.nbpscs)
    out = np.empty((cfg.nss, cfg.nsym, cfg.nsd), dtype=np.complex128)
    for iss in range(cfg.nss):
        inted = B.interleave(streams[iss], cfg.nbpscs, legacy, iss, cfg.nss)
        chips = inted.astype(np.int64).reshape(-1, cfg.nbpscs) @ (1 << np.arange(cfg.nbpscs))
        out[iss] = tab[chips].reshape(cfg.nsym, cfg.nsd)
    return out


# ---------------------------------------------------------------------------
# Symbol/grid assembly helpers
# ---------------------------------------------------------------------------

def _bpsk_grid_legacy(inted_bits: np.ndarray, qbpsk: bool = False) -> np.ndarray:
    """48 interleaved SIG bits -> 64-bin grid with legacy pilots [1,1,1,-1]."""
    g = np.zeros(64, dtype=np.complex128)
    g[T.DATA_IDX_L] = T.qam_table(1, qbpsk)[inted_bits]
    g[T.PILOT_IDX] = T.PILOT_L
    return g


def _ifft(grid: np.ndarray) -> np.ndarray:
    return np.fft.ifft(np.fft.ifftshift(grid, axes=-1), axis=-1)


def _time_sym(grids: np.ndarray, ntf: int, nss: int) -> np.ndarray:
    """(..., 64) grids -> (..., 80) GI-prefixed scaled time symbols."""
    x = _ifft(grids) / np.sqrt(ntf * nss)
    return np.concatenate([x[..., 48:], x], axis=-1)


def _apply_csd(grids: np.ndarray, nss: int, legacy_part: bool) -> np.ndarray:
    """grids (nss, 64) -> cyclic-shifted per stream."""
    tab = T.CSD_LEGACY_NS if legacy_part else T.CSD_NL_NS
    out = grids.astype(np.complex128).copy()
    for iss in range(nss):
        out[iss] = out[iss] * T.csd_phase(tab[nss - 1][iss])
    return out


def _apply_q(grids: np.ndarray, bfq: np.ndarray | None) -> np.ndarray:
    """Per-subcarrier spatial mapping: grids (nss, 64), bfq (64, nss, nss)."""
    if bfq is None:
        return grids
    return np.einsum("kij,jk->ik", bfq, grids)


def window_concat(chunks: list[np.ndarray]) -> np.ndarray:
    """Concatenate (nss, n_i) time chunks, halving both edge samples at every
    interior boundary (PY-TB procConcat2Symbol semantics)."""
    out = [c.astype(np.complex128).copy() for c in chunks]
    for i in range(len(out) - 1):
        out[i][..., -1] *= 0.5
        out[i + 1][..., 0] *= 0.5
    return np.concatenate(out, axis=-1)


# ---------------------------------------------------------------------------
# Preamble fields
# ---------------------------------------------------------------------------

def legacy_training(nss: int) -> list[np.ndarray]:
    """[L-STF (nss,160), L-LTF (nss,160)]."""
    stf = _apply_csd(np.tile(T.STF_GRID, (nss, 1)), nss, True)
    ltf = _apply_csd(np.tile(T.LTF_L_GRID, (nss, 1)), nss, True)
    xs = _ifft(stf) / np.sqrt(T.NTF_STF_L * nss)
    xl = _ifft(ltf) / np.sqrt(T.NTF_LTF_L * nss)
    stf160 = np.concatenate([xs[:, 32:], xs, xs], axis=-1)
    ltf160 = np.concatenate([xl[:, 32:], xl, xl], axis=-1)
    return [stf160, ltf160]


def lsig_field(cfg, nss: int) -> np.ndarray:
    inted = B.interleave(B.bcc_encode_punct(S.lsig_bits(cfg), "1/2"), 1, True)
    grid = _bpsk_grid_legacy(inted)
    grids = _apply_csd(np.tile(grid, (nss, 1)), nss, True)
    return _time_sym(grids, T.NTF_SIG_L, nss)


def _dual_sym_sig(bits48x2: np.ndarray, nss: int, qbpsk_first: bool) -> list[np.ndarray]:
    """HT-SIG (both QBPSK) / VHT-SIG-A (BPSK then QBPSK): two 80-sample syms."""
    coded = B.bcc_encode_punct(bits48x2, "1/2")
    out = []
    for i, qb in enumerate((qbpsk_first, True)):
        inted = B.interleave(coded[48 * i: 48 * (i + 1)], 1, True)
        grid = _bpsk_grid_legacy(inted, qbpsk=qb)
        grids = _apply_csd(np.tile(grid, (nss, 1)), nss, True)
        out.append(_time_sym(grids, T.NTF_SIG_NL, nss))
    return out


def nl_training(nss: int, nltf: int, fmt: Fmt, bfq=None) -> list[np.ndarray]:
    """[NL-STF (nss,80), NL-LTF_1..n (nss,80)] with CSD (+Q for MU)."""
    stf = _apply_q(_apply_csd(np.tile(T.STF_GRID, (nss, 1)), nss, False), bfq)
    chunks = [_time_sym(stf, T.NTF_STF_NL, nss)]
    pilot_mask = np.zeros(64, dtype=bool)
    pilot_mask[T.PILOT_IDX] = True
    for i in range(nltf):
        grids = np.empty((nss, 64), dtype=np.complex128)
        for iss in range(nss):
            g = T.LTF_NL_GRID * T.P_LTF[iss, i]
            if fmt == Fmt.VHT:
                g = np.where(pilot_mask, T.LTF_NL_GRID * T.R_LTF[i], g)
            grids[iss] = g
        grids = _apply_q(_apply_csd(grids, nss, False), bfq)
        chunks.append(_time_sym(grids, T.NTF_LTF_NL, nss))
    return chunks


def vhtsigb_field(inted_bits: np.ndarray, nss: int, bfq=None) -> np.ndarray:
    """VHT-SIG-B: BPSK on the 52-tone layout, VHT pilots, NL CSD (+Q)."""
    grids = np.zeros((nss, 64), dtype=np.complex128)
    for iss in range(nss):
        g = np.zeros(64, dtype=np.complex128)
        g[T.DATA_IDX_NL] = T.qam_table(1)[inted_bits]
        g[T.PILOT_IDX] = T.PILOT_VHT
        grids[iss] = g
    grids = _apply_q(_apply_csd(grids, nss, False), bfq)
    return _time_sym(grids, T.NTF_SIGB, nss)


def interleave_sigb(cfg_bits: np.ndarray) -> np.ndarray:
    """Encode + interleave SIG-B bits with the 1-stream NL interleaver."""
    return B.interleave(B.bcc_encode_punct(cfg_bits, "1/2"), 1, False)


def data_pilots(fmt: Fmt, nss: int, nsym: int) -> np.ndarray:
    """Per-symbol pilot values, shape (nsym, nss, 4), polarity applied."""
    if fmt == Fmt.L:
        base, start = np.tile(T.PILOT_L, (nss, 1)), 1
        rotate = False
    elif fmt == Fmt.HT:
        base, start = T.PILOT_HT20[nss - 1], 3
        rotate = True
    else:
        base, start = np.tile(T.PILOT_VHT, (nss, 1)), 4
        rotate = True
    out = np.empty((nsym, nss, 4), dtype=np.float64)
    for n in range(nsym):
        pol = T.PILOT_POLARITY[(start + n) % 127]
        rolled = np.roll(base, -n, axis=1) if rotate else base
        out[n] = rolled * pol
    return out


def data_field(cfg: PhyConfig, symbols: np.ndarray, bfq=None,
               pilots: np.ndarray | None = None) -> list[np.ndarray]:
    """QAM symbols (nss, nsym, nsd) -> list of (nss, 80) time chunks."""
    legacy = cfg.fmt == Fmt.L
    didx = T.DATA_IDX_L if legacy else T.DATA_IDX_NL
    ntf = T.NTF_DATA_L if legacy else T.NTF_DATA_NL
    if pilots is None:
        pilots = data_pilots(cfg.fmt, cfg.nss, cfg.nsym)
    chunks = []
    for n in range(cfg.nsym):
        grids = np.zeros((cfg.nss, 64), dtype=np.complex128)
        grids[:, didx] = symbols[:, n]
        grids[:, T.PILOT_IDX] = pilots[n]
        # data symbols always use the non-legacy CSD table (zero for 1SS)
        grids = _apply_q(_apply_csd(grids, cfg.nss, False), bfq)
        chunks.append(_time_sym(grids, ntf, cfg.nss))
    return chunks


# ---------------------------------------------------------------------------
# Full waveforms
# ---------------------------------------------------------------------------

def tx_waveform(cfg: PhyConfig, payload: bytes, seed: int = 93,
                group_id: int | None = None, partial_aid: int = 0) -> np.ndarray:
    """Complete PPDU baseband, shape (nss, cfg.n_samples)."""
    nss = cfg.nss
    chunks = legacy_training(nss) + [lsig_field(cfg, nss)]
    sigb_crc = np.zeros(8, np.uint8)
    if cfg.fmt == Fmt.HT:
        chunks += _dual_sym_sig(S.htsig_bits(cfg), nss, qbpsk_first=True)
        chunks += nl_training(nss, cfg.nltf, Fmt.HT)
    elif cfg.fmt == Fmt.VHT:
        gid = (63 if group_id is None else group_id)
        chunks += _dual_sym_sig(S.vhtsiga_bits(cfg, gid, partial_aid), nss,
                                qbpsk_first=False)
        chunks += nl_training(nss, cfg.nltf, Fmt.VHT)
        sigb, sigb_crc = S.vhtsigb_bits(cfg)
        chunks.append(vhtsigb_field(interleave_sigb(sigb), nss))
    if not cfg.is_ndp:
        data_bits = data_field_bits(cfg, payload, sigb_crc)
        coded = encode_data_bits(cfg, data_bits, seed)
        symbols = modulate_data_symbols(cfg, coded)
        chunks += data_field(cfg, symbols)
    return window_concat(chunks)


