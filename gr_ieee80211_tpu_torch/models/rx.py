"""Batched receive engine: the known-config chain and the general
``RxEngine``.

Port of ``gr_ieee80211_tpu.models.rx``.  The reference fuses each stage
into one XLA program; here the stages run eagerly on the device of the
input stream, and the reference's ``lax.cond`` gates (the decision-
directed chanest gate, the decode tiers) are host branches on counts read
back from that device.

* ``rx_chain_count`` / ``rx_chain_ok``: the known-config chain, detect ->
  dedup -> sync -> decode -> count;
* ``RxEngine``: the streaming receiver.  A fused front end (detect, sync,
  L-SIG / HT-SIG / VHT-SIG-A decode) feeds host-side classification into
  buckets of canonical configs, each decoded as one batch; NDPs get their
  channel estimate; homogeneous blocks arm the speculative one-pass path
  (``_spec_core``).  Up to 2 receive antennas and 2 spatial streams (ZF).

* ``rx_chain_count_mu`` / ``rx_chain_ok_mu`` and ``RxEngine(mu_pos=...)``:
  the MU-MIMO station's decode.  The channel estimate spans all space-time
  streams of the PPDU, the station's own column equalizes its VHT-SIG-B
  and its data, and SIG-B is validated against the CRC in the SERVICE
  field.  Without ``mu_pos`` an MU PPDU falls through to the HT-SIG /
  L-SIG classification, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..gold import bits as GB
from ..gold import mac as MAC
from ..gold import sig as S
from ..runtime.native import deagg_vht
from ..spec import tables as T
from ..spec.params import Fmt, PhyConfig
from ..ops import crc as CRC
from ..ops import frontend as FE
from ..ops import ofdm as OF
from ..ops import viterbi as V
from ..ops.cplx import (CF, cstack, csum, from_numpy_cf, from_numpy_cf_bf16,
                        from_numpy_cf_i8)
from ..ops.fastdecode import adaptive_decode

# offsets relative to ltf_idx (nominal L-LTF window start)
LSIG_GI = 128
NLSIG_GI = 208

#: min spacing between distinct packet triggers (a packet's own HT/VHT-STF
#: re-fires the detector at +560; packets are >= 720 samples)
TRIG_DEDUP_SPACING = 700

#: decision-directed second-pass chanest gate: batches whose L-LTF
#: repeat-difference SNR proxy lies between the modulation's lower bound
#: and this value run ops.ofdm.refine_chanest_data (the reference's rule)
DD_GATE_SNR_DB = 23.5

#: per-(nbpscs, coding rate) lower dd gate bound (dB)
_DD_GATE_LO = {(1, "1/2"): 0.0, (1, "3/4"): 1.5,
               (2, "1/2"): 2.5, (2, "3/4"): 4.5,
               (4, "1/2"): 7.5, (4, "3/4"): 11.5,
               (6, "2/3"): 14.5, (6, "3/4"): 15.5, (6, "5/6"): 17.0,
               (8, "3/4"): 20.0, (8, "5/6"): 21.5}

#: bucket-shape canonicalization ladder (the reference's): many payload
#: lengths share one decode shape.  The port keeps it because it decides
#: which rows decode together and on what trellis length, which the
#: results depend on (the batch-level dd gate, the padded trellis end)
_NSYM_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16, 20, 26, 32, 40, 52, 64,
                80, 104, 128, 160, 208, 256, 320, 416, 512, 640, 832, 1024,
                1366)

#: min extra trellis steps between the real tail and a canonically padded
#: trellis end (survivor paths merge within ~16 constraint lengths)
_CANON_MERGE_STEPS = 96


@functools.lru_cache(maxsize=4096)
def canonical_cfg(cfg: PhyConfig) -> PhyConfig:
    """Round a data config's nsym up the ladder (padding the decode with
    garbage symbols) so many payload lengths share one decode shape.

    Returns ``cfg`` unchanged on an exact ladder hit, for MU/NDP configs,
    or when no rung gives both >= _CANON_MERGE_STEPS of trellis margin and
    a consistent max-length config (e.g. near the 4095 B cap)."""
    if cfg.mu_nsym or cfg.is_ndp:
        return cfg
    nsym = cfg.nsym

    def rung_cfg(rung):
        max_len = min((rung * cfg.ndbps - 16 - 6) // 8, 4095)
        cand = PhyConfig(cfg.fmt, cfg.mcs, cfg.nss, max_len, ampdu=cfg.ampdu)
        return cand if cand.nsym == rung and max_len >= cfg.length else None

    for rung in _NSYM_LADDER:
        if rung == nsym:
            if cfg.fmt == Fmt.VHT:
                # VHT psdu_len is nsym-determined: the max-length config
                # has identical decode shapes
                cand = rung_cfg(rung)
                if cand is not None:
                    return cand
            # HT/L exact hits keep the exact shape (a canon trellis end
            # would sit inside survivor-merge range of the real tail)
            return cfg
        if rung > nsym and (rung - nsym) * cfg.ndbps >= _CANON_MERGE_STEPS:
            cand = rung_cfg(rung)
            return cfg if cand is None else cand
    return cfg


#: batch-size rungs for bucket decodes; rows are padded with duplicates of
#: row 0 and the tail results ignored.  The padding is part of the result
#: (the dd gate is a batch SNR; segmented_pays reads B), so it is kept
_BATCH_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
                 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def _pad_batch(n: int) -> int:
    for r in _BATCH_LADDER:
        if r >= n:
            return r
    return -(-n // 4096) * 4096


def dedup_triggers(cand: np.ndarray) -> np.ndarray:
    """Keep the first candidate of each <TRIG_DEDUP_SPACING cluster."""
    if len(cand) == 0:
        return cand.astype(np.int32)
    keep = np.concatenate([[True], np.diff(cand) > TRIG_DEDUP_SPACING])
    return cand[keep].astype(np.int32)


@dataclasses.dataclass
class RxResult:
    ok: bool
    fmt: Fmt | None = None
    mcs: int = 0
    nss: int = 1
    start: int = 0
    cfo_hz: float = 0.0
    psdu: bytes = b""
    mpdus: list = dataclasses.field(default_factory=list)
    is_ndp: bool = False
    ndp_chan: np.ndarray | None = None
    trig: int = 0        #: trigger (packet-start) sample index
    #: sync-time SNR estimate 10log10(ac/(1-ac)) and mean windowed power
    snr_db: float = 0.0
    rssi: float = 0.0
    #: VHT SIG-B re-encode SNR estimate
    sssnr0: float | None = None


# ---------------------------------------------------------------------------
# cores
# ---------------------------------------------------------------------------

def _sync_core(stream: CF, trigs: torch.Tensor):
    """Candidate triggers -> (ltf_idx abs, peak, cfo, rssi).

    One bf16-staged (B, 464) window at the 16-aligned trigger covers the
    STF window [0:80) and the LTF search span [80:448)."""
    trigs16 = torch.div(trigs, 16, rounding_mode="floor") * 16
    wins = FE.gather_windows_bf16(stream, trigs16, 464)
    cfo0 = FE.coarse_cfo_batch(wins[:, :80])
    off, peak, cfo, rssi = FE.ltf_fine_sync_cfo(wins[:, 80: 448], cfo0)
    return trigs16 + 80 + off, peak, cfo, rssi


@functools.lru_cache(maxsize=None)
def _perm_on(name: str, device: torch.device) -> torch.Tensor:
    perm = (T.interleave_perm_legacy(1) if name == "legacy"
            else T.interleave_perm_nl(1))
    return torch.from_numpy(np.asarray(perm, np.int64)).to(device)


def _sig_core(stream: CF, ltf_idx: torch.Tensor, cfo: torch.Tensor):
    """Decode L-SIG + both non-legacy SIG hypotheses for a sync batch.

    Returns (lsig_bits (B, 24), ht_bits (B, 48), vht_bits (B, 48)) uint8.
    The three trellises pad to the same 54-step chunk, so they decode as
    one stacked batch (rows are independent: bit-equal to three calls)."""
    xs = FE.derotate_batch(stream, ltf_idx, cfo, 368 + 128)
    h = OF.legacy_chanest(xs, 0)
    dl = OF._idx("DATA_IDX_L", xs.device)
    perm = _perm_on("legacy", xs.device)

    def eq_sym(gi_start):
        g = OF.fft_syms(xs[:, gi_start + 16: gi_start + 80]) / h
        return g[:, dl][:, perm]

    e_lsig = eq_sym(LSIG_GI)
    e1 = eq_sym(NLSIG_GI)
    e2 = eq_sym(NLSIG_GI + 80)
    vht_llr = torch.cat([e1.re, e2.im], dim=1)
    ht_llr = torch.cat([e1.im, e2.im], dim=1)
    B = xs.shape[0]
    lsig_pairs = torch.nn.functional.pad(V.depuncture(e_lsig.re, "1/2", 24),
                                         (0, 0, 0, 24))
    pairs = torch.cat([lsig_pairs, V.depuncture(ht_llr, "1/2", 48),
                       V.depuncture(vht_llr, "1/2", 48)], dim=0)
    bits = V.viterbi_decode(pairs)
    return bits[:B, :24], bits[B: 2 * B], bits[2 * B:]


def _data_start(cfg: PhyConfig) -> int:
    if cfg.fmt == Fmt.L:
        return 208
    if cfg.fmt == Fmt.HT:
        return 208 + 160 + 80 + 80 * cfg.nltf
    return 208 + 160 + 80 + 80 * cfg.nltf + 80


def _mu_starts(n_total: int) -> tuple[int, int, int, int]:
    """(nltf, VHT-LTF start, SIG-B start, data start) of an MU PPDU with
    ``n_total`` space-time streams, relative to ltf_idx."""
    nltf = int(T.N_LTF_OF_NSTS[n_total])
    ltf_start = 208 + 160 + 80
    sigb_start = ltf_start + 80 * nltf
    return nltf, ltf_start, sigb_start, sigb_start + 80


def _mu_sigb_core(stream: CF, ltf_idx: torch.Tensor, cfo: torch.Tensor,
                  n_total: int, own: int) -> torch.Tensor:
    """Batched MU VHT-SIG-B decode for one (nsts-tuple, mu_pos) group.

    stream: one antenna's (N,) samples.  Estimates the full n_total-stream
    channel from the VHT-LTFs, selects the user's own column, equalizes
    the SIG-B symbol and Viterbi-decodes its 26 bits: (B, 26) uint8.  The
    window gather is the float32 one (the payload's is bf16-staged)."""
    nltf, ltf_start, sigb_start, _ = _mu_starts(n_total)
    dev = stream.device
    xs = FE.derotate_batch(stream, ltf_idx, cfo, sigb_start + 80)
    h, pilot_h = OF.nl_chanest(xs[:, None], ltf_start, nltf, n_total)
    h_own = h[:, 0, own]                                 # (B, 64)
    g = OF.fft_syms(xs[:, sigb_start + 16: sigb_start + 80])
    _, pilv = _sigb_consts(dev)
    exp_p = pilot_h[:, 0] * pilv[None, :]
    ph = csum(g[:, OF._idx("PILOT_IDX", dev)].mul_conj(exp_p), dim=1).unit()
    g = g * CF(ph.re[:, None], -ph.im[:, None])
    didx = OF._idx("DATA_IDX_NL", dev)
    eq = g[:, didx] / h_own[:, didx]
    llr = eq.re[:, _perm_on("nl", dev)]
    return V.viterbi_decode(V.depuncture(llr, "1/2", 26))


def _payload_core_mu(cfg: PhyConfig, stream: CF, ltf_idx: torch.Tensor,
                     cfo: torch.Tensor, n_total: int, own: int,
                     nrx: int = 1, mpdu_len: int = 0,
                     record: list | None = None) -> dict:
    """MU-STA payload decode: like :func:`_payload_core`, but the channel
    estimate covers all n_total space-time streams and only the user's own
    column(s) equalize the data (cfg describes the user's own modulation,
    ``mu_nsym`` the PPDU's symbol count).  No channel refinement: the
    other users' streams share the training fields.  Returns ``psdu``,
    ``service`` and, with ``mpdu_len``, ``mpdu_fcs_ok``."""
    nltf, ltf_start, _, data_start = _mu_starts(n_total)
    n_need = data_start + 80 * cfg.nsym + 16
    xs = cstack([FE.derotate_batch(stream[r], ltf_idx, cfo, n_need,
                                   low_prec=True)
                 for r in range(nrx)], dim=1)
    h_all, pilot_h = OF.nl_chanest(xs, ltf_start, nltf, n_total)
    h = h_all[:, :, own: own + cfg.nss]
    grids = OF.fft_syms(cstack([OF.extract_sym_windows(xs[:, r], data_start,
                                                       cfg.nsym)
                                for r in range(nrx)], dim=1))
    llr = OF.equalize_and_demap(grids, h, pilot_h, cfg)
    coded = OF.deinterleave_deparse(llr, cfg)
    bits = adaptive_decode(coded, cfg.cr, cfg.n_trellis, record=record)
    data = OF.descramble_bits(bits)
    psdu_bits = data[:, 16: 16 + 8 * cfg.psdu_len]
    out = {"psdu": OF.bits_to_bytes_batch(psdu_bits), "service": data[:, :16]}
    if mpdu_len > 4:
        mpdu_bits = psdu_bits[:, 32: 32 + 8 * mpdu_len]
        out["mpdu_fcs_ok"] = CRC.fcs_ok_batch(mpdu_bits, 8 * mpdu_len)
    return out


@functools.lru_cache(maxsize=None)
def _crc8_affine() -> tuple[np.ndarray, np.ndarray]:
    """CRC8 over 20 bits as an affine GF(2) map: crc(b) = M @ b xor c0.

    M's columns come from unit-vector probes of the bit-serial oracle
    (spec.tables.crc8_bits), so SIG-B is validated against the SERVICE
    field on the device.  Returns (M (8, 20), c0 (8,)) float64."""
    n = 20
    c0 = T.crc8_bits(np.zeros(n, np.uint8)).astype(np.float64)
    cols = []
    for i in range(n):
        e = np.zeros(n, np.uint8)
        e[i] = 1
        cols.append((T.crc8_bits(e).astype(np.float64) + c0) % 2)
    return np.stack(cols, axis=1), c0


@functools.lru_cache(maxsize=None)
def _crc8_affine_on(device: torch.device):
    M, c0 = _crc8_affine()
    return torch.from_numpy(M.T.copy()).to(device), \
        torch.from_numpy(c0).to(device)


def _sigb_crc_ok(sigb_bits: torch.Tensor,
                 service: torch.Tensor) -> torch.Tensor:
    """SIG-B validation for a (B, 26) bit batch against (B, 16) SERVICE
    bits: the CRC of the 20 body bits equals SERVICE[8:16] and the tail is
    zero.  The product is taken in float64 (sums of at most 20 ones are
    exact in any float type, and a float64 product cannot take TF32)."""
    Mt, c0 = _crc8_affine_on(sigb_bits.device)
    crc = torch.remainder(sigb_bits[:, :20].to(torch.float64) @ Mt + c0, 2.0)
    tail_zero = sigb_bits[:, 20:26].to(torch.int32).sum(dim=1) == 0
    match = (crc == service[:, 8:16].to(torch.float64)).all(dim=1)
    return match & tail_zero


@functools.lru_cache(maxsize=None)
def _sigb_reencode_matrix() -> np.ndarray:
    """(52, 26) GF(2) map: decoded VHT-SIG-B bits -> interleaved coded
    bits (unit-vector probes of the gold BCC + interleaver)."""
    cols = []
    for i in range(26):
        e = np.zeros(26, np.uint8)
        e[i] = 1
        cols.append(GB.interleave(GB.bcc_encode_punct(e, "1/2"), 1, False)
                    .astype(np.float32))
    return np.stack(cols, axis=1)


@functools.lru_cache(maxsize=None)
def _sigb_consts(device: torch.device):
    return (torch.from_numpy(_sigb_reencode_matrix()).to(device),
            torch.from_numpy(np.asarray(T.PILOT_VHT, np.float32)).to(device))


def _sigb_snr(xs: CF, h: CF, data_start: int) -> torch.Tensor:
    """VHT SIG-B re-encode SNR (sssnr0) for a SISO batch.

    xs: (B, nrx, n) derotated windows; h: (B, nrx, nss, 64), the estimate
    the payload was equalized with.  Equalizes the SIG-B symbol, pilot-
    phase-corrects it, decodes the 26 bits, re-encodes and interleaves
    them and turns the residual constellation error into
    10 log10(52 / noise)."""
    dev = xs.device
    M, pilv = _sigb_consts(dev)
    sigb_start = data_start - 80
    g = OF.fft_syms(xs[:, 0, sigb_start + 16: sigb_start + 80])
    eq_all = g / h[:, 0, 0]
    pidx = OF._idx("PILOT_IDX", dev)
    ph = csum(eq_all[:, pidx] * pilv[None, :], dim=1).unit()
    eq = eq_all[:, OF._idx("DATA_IDX_NL", dev)].mul_conj(
        CF(ph.re[:, None], ph.im[:, None]))
    llr = eq.re[:, _perm_on("nl", dev)]
    sigb_bits = V.viterbi_decode(V.depuncture(llr, "1/2", 26))
    inted = torch.remainder(sigb_bits.to(torch.float32) @ M.T, 2.0)
    ideal = 2.0 * inted - 1.0
    noise = ((eq.re - ideal) ** 2 + eq.im ** 2).sum(dim=1)
    return 10.0 * torch.log10(52.0 / torch.clamp(noise, min=1e-9))


def _dd_gate(xs: CF, cfg: PhyConfig) -> bool:
    """The batch SNR proxy from the two L-LTF repeats (noise = their
    difference, signal = their sum) inside [mcs lower bound, 23.5 dB]."""
    l1 = OF.fft_syms(xs[:, 0, 0:64])
    l2 = OF.fft_syms(xs[:, 0, 64:128])
    nz = OF._ltf_consts(xs.device)["l_nzf"]
    d2 = ((l1 - l2).abs2() * nz).sum(dim=1)
    s2 = ((l1 + l2).abs2() * nz).sum(dim=1)
    dsum = d2.sum()
    sd = s2.sum() - dsum
    lo = _DD_GATE_LO.get((cfg.nbpscs, cfg.cr), 0.0)
    pred = ((sd < 2.0 * 10.0 ** (DD_GATE_SNR_DB / 10.0) * dsum)
            & (sd > 2.0 * 10.0 ** (lo / 10.0) * dsum))
    return bool(pred.item())


def _payload_core(cfg: PhyConfig, stream: CF, ltf_idx: torch.Tensor,
                  cfo: torch.Tensor, nrx: int = 1, mpdu_len: int = 0,
                  n_real: torch.Tensor | None = None,
                  want_sssnr: bool = False,
                  record: list | None = None) -> dict:
    """Payload demod + decode for one config bucket, with the reference's
    channel refinements (SISO and the gated dd pass, 1 stream only).

    stream: (>= nrx, N).  Returns a dict with ``psdu`` (B, psdu_len)
    uint8, ``service`` (B, 16), ``sssnr0`` (B,) with ``want_sssnr`` for
    VHT 1 SS, and ``mpdu_fcs_ok`` (VHT single-MPDU A-MPDU) or ``fcs_ok``
    (non-aggregated L/HT).  ``n_real``: per-row true trellis length of a
    canonicalized bucket.  ``record`` collects the decode tier and
    whether the dd pass ran (``"dd"``)."""
    data_start = _data_start(cfg)
    n_need = data_start + 80 * cfg.nsym + 16
    xs = cstack([FE.derotate_batch(stream[r], ltf_idx, cfo, n_need,
                                   low_prec=True)
                 for r in range(nrx)], dim=1)            # (B, nrx, n)
    pidx = OF._idx("PILOT_IDX", xs.device)
    if cfg.fmt == Fmt.L:
        h0 = OF.legacy_chanest(xs[:, 0], 0)
        h = h0[:, None, None, :]
        pilot_h = h0[:, pidx][:, None, :]
    else:
        h, pilot_h = OF.nl_chanest(xs, 208 + 160 + 80, cfg.nltf, cfg.nss)
        if cfg.nss == 1:
            sigb_gi = data_start - 80 if cfg.fmt == Fmt.VHT else None
            h, pilot_h = OF.refine_chanest_siso(xs, h, pilot_h, fmt=cfg.fmt,
                                                sigb_gi=sigb_gi)
        if cfg.fmt == Fmt.HT:
            pilot_h = csum(h[:, :, :, pidx], dim=2)
    grids = OF.fft_syms(cstack([OF.extract_sym_windows(xs[:, r], data_start,
                                                       cfg.nsym)
                                for r in range(nrx)], dim=1))
    if cfg.nss == 1 and _dd_gate(xs, cfg):
        h, pilot_h = OF.refine_chanest_data(grids, h, pilot_h, cfg)
        if record is not None:
            record.append("dd")
    llr = OF.equalize_and_demap(grids, h, pilot_h, cfg)
    coded = OF.deinterleave_deparse(llr, cfg)        # (B, nsym*ncbps)
    bits = adaptive_decode(coded, cfg.cr, cfg.n_trellis, n_real=n_real,
                           record=record)
    data = OF.descramble_bits(bits)
    psdu_bits = data[:, 16: 16 + 8 * cfg.psdu_len]
    out = {"psdu": OF.bits_to_bytes_batch(psdu_bits), "service": data[:, :16]}
    if want_sssnr and cfg.fmt == Fmt.VHT and cfg.nss == 1:
        out["sssnr0"] = _sigb_snr(xs, h, data_start)
    if cfg.fmt == Fmt.VHT and mpdu_len > 4:
        mpdu_bits = psdu_bits[:, 32: 32 + 8 * mpdu_len]
        out["mpdu_fcs_ok"] = CRC.fcs_ok_batch(mpdu_bits, 8 * mpdu_len)
    elif cfg.fmt != Fmt.VHT and not cfg.ampdu and cfg.psdu_len > 4:
        out["fcs_ok"] = CRC.fcs_ok_batch(psdu_bits, 8 * cfg.psdu_len)
    return out


def _ok_flags(out: dict) -> torch.Tensor:
    ok = out.get("mpdu_fcs_ok", out.get("fcs_ok"))
    if ok is None:
        raise ValueError("no FCS to check: VHT needs mpdu_len > 4, L/HT a "
                         "non-aggregated PSDU")
    return ok


def _triggers(stream0: CF, max_pkts: int) -> torch.Tensor:
    """detect -> dedup on one antenna's (N,) stream: (max_pkts,) int32
    trigger indices, ascending, padded -1."""
    m4 = FE.stf_metric_strided(stream0)
    cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts)
    return FE.dedup_triggers_device(cand, max_pkts,
                                    spacing=TRIG_DEDUP_SPACING)


def _detect_sync(cfg: PhyConfig, stream: CF, max_pkts: int, nrx: int = 1,
                 n_need: int | None = None):
    """detect -> dedup -> sync on antenna 0; returns (ltf_idx, ltf_idx
    clipped into the stream, cfo, valid), max_pkts rows each.  ``n_need``:
    samples a packet needs past ltf_idx (default: the SU layout of
    ``cfg``)."""
    if not 1 <= nrx <= stream.shape[0]:
        raise ValueError(f"nrx={nrx} but the stream has {stream.shape[0]} "
                         "antenna rows")
    trigs = _triggers(stream[0], max_pkts)
    valid = trigs >= 0
    trigs = torch.clamp(trigs, min=0)
    ltf_idx, peak, cfo, _rssi = _sync_core(stream[0], trigs)
    n = stream.shape[-1]
    if n_need is None:
        n_need = _data_start(cfg) + 80 * cfg.nsym + 16
    valid = valid & (peak > 0.5) & (ltf_idx + n_need < n)
    return ltf_idx, torch.clamp(ltf_idx, 0, n - n_need - 1), cfo, valid


def rx_chain_count(cfg: PhyConfig, stream: CF, nrx: int = 1,
                   mpdu_len: int = 0, max_pkts: int = 4096,
                   chunk: int | None = None, record: list | None = None):
    """Known-config chain: detect -> dedup -> sync -> decode -> count.

    stream: CF of (>= nrx, N) float32 (or bfloat16) tensors on the device
    the chain runs on.  Returns (n_fcs_ok, n_detected) as 0-dim int32
    tensors.  ``chunk`` decodes the max_pkts synced rows in chunks of
    this size (max_pkts % chunk == 0), bounding the decoder's
    temporaries; ``record`` collects each chunk's decode tier."""
    _, ltf_idx, cfo, valid = _detect_sync(cfg, stream, max_pkts, nrx)
    if chunk is None or max_pkts <= chunk:
        chunk = max_pkts
    if max_pkts % chunk:
        raise ValueError(f"max_pkts={max_pkts} is not a multiple of "
                         f"chunk={chunk}")
    n_ok = torch.zeros((), dtype=torch.int32, device=ltf_idx.device)
    for s in range(0, max_pkts, chunk):
        sl = slice(s, s + chunk)
        out = _payload_core(cfg, stream, ltf_idx[sl], cfo[sl], nrx=nrx,
                            mpdu_len=mpdu_len, record=record)
        n_ok = n_ok + (_ok_flags(out) & valid[sl]).sum().to(torch.int32)
    return n_ok, valid.sum().to(torch.int32)


def rx_chain_ok(cfg: PhyConfig, stream: CF, nrx: int = 1, mpdu_len: int = 0,
                max_pkts: int = 4096, record: list | None = None):
    """Like :func:`rx_chain_count` but per packet: returns (ok (max_pkts,)
    bool, ltf_idx (max_pkts,) int32, valid (max_pkts,) bool)."""
    ltf_idx, ltf_idx_c, cfo, valid = _detect_sync(cfg, stream, max_pkts, nrx)
    out = _payload_core(cfg, stream, ltf_idx_c, cfo, nrx=nrx,
                        mpdu_len=mpdu_len, record=record)
    return _ok_flags(out) & valid, ltf_idx.to(torch.int32), valid


def rx_chain_ok_mu(cfg: PhyConfig, stream: CF, n_total: int, own: int,
                   nrx: int = 1, mpdu_len: int = 0, max_pkts: int = 4096,
                   record: list | None = None):
    """Per-packet MU-STA chain: detect -> sync -> SIG-B -> payload.

    The MU twin of :func:`rx_chain_ok` (the station knows its group's
    config): decodes the user's VHT-SIG-B on antenna 0, validates it
    against the SERVICE-field CRC and the configured MCS, and decodes the
    payload through the user's own column of the n_total-stream channel.
    Returns (ok (max_pkts,) bool, ltf_idx (max_pkts,) int32, valid
    (max_pkts,) bool)."""
    n_need = _mu_starts(n_total)[3] + 80 * cfg.nsym + 16
    ltf_idx, ltf_idx_c, cfo, valid = _detect_sync(cfg, stream, max_pkts, nrx,
                                                  n_need=n_need)
    sigb_bits = _mu_sigb_core(stream[0], ltf_idx_c, cfo, n_total, own)
    pw = torch.tensor([1, 2, 4, 8], device=sigb_bits.device)
    sigb_mcs = (sigb_bits[:, 16:20].to(torch.int64) * pw).sum(dim=1)
    out = _payload_core_mu(cfg, stream, ltf_idx_c, cfo, n_total, own,
                           nrx=nrx, mpdu_len=mpdu_len, record=record)
    ok = (_ok_flags(out) & _sigb_crc_ok(sigb_bits, out["service"])
          & (sigb_mcs == cfg.mcs) & valid)
    return ok, ltf_idx.to(torch.int32), valid


def rx_chain_count_mu(cfg: PhyConfig, stream: CF, n_total: int, own: int,
                      nrx: int = 1, mpdu_len: int = 0, max_pkts: int = 4096,
                      record: list | None = None):
    """:func:`rx_chain_ok_mu` counted: (n_fcs_ok, n_detected) as 0-dim
    int32 tensors, the MU twin of :func:`rx_chain_count`."""
    ok, _, valid = rx_chain_ok_mu(cfg, stream, n_total, own, nrx=nrx,
                                  mpdu_len=mpdu_len, max_pkts=max_pkts,
                                  record=record)
    return ok.sum().to(torch.int32), valid.sum().to(torch.int32)


def _front(stream: CF, max_pkts: int):
    """detect -> dedup -> sync -> SIG on one antenna's (N,) stream.

    Returns (trigs, ltf_idx, peak, cfo, rssi, valid, sig bits (max_pkts,
    120) uint8 [lsig(24), ht(48), vht(48)])."""
    trigs = _triggers(stream, max_pkts)
    n = stream.shape[-1]
    ltf_idx, peak, cfo, rssi = _sync_core(stream, torch.clamp(trigs, min=0))
    valid = (trigs >= 0) & (peak > 0.5) & (ltf_idx + 600 < n)
    li_c = torch.clamp(ltf_idx, 0, max(n - 600, 0))
    bits = torch.cat(_sig_core(stream, li_c, cfo), dim=1)
    return trigs, ltf_idx, peak, cfo, rssi, valid, bits


def _meta(trigs, ltf_idx, peak, cfo, rssi, *flags) -> torch.Tensor:
    """(max_pkts, 5 + len(flags)) float32 [trig, ltf_idx, peak, cfo, rssi,
    flags...], the reference's one-readback layout."""
    cols = [trigs.to(torch.float32), ltf_idx.to(torch.float32), peak, cfo,
            rssi] + [f.to(torch.float32) for f in flags]
    return torch.stack(cols, dim=1)


def _front_core(stream: CF, max_pkts: int):
    """Fused front end: (meta (max_pkts, 6) float32 [trig, ltf_idx, peak,
    cfo, rssi, valid], bits (max_pkts, 120) uint8)."""
    trigs, ltf_idx, peak, cfo, rssi, valid, bits = _front(stream, max_pkts)
    return _meta(trigs, ltf_idx, peak, cfo, rssi, valid), bits


#: speculative-path psdu readback cap: compacted valid rows beyond this
#: fall back to the bucket path (and dense blocks disarm speculation)
SPEC_ROWS = 512


def _spec_core(cfg: PhyConfig, stream: CF, max_pkts: int, nrx: int = 1,
               n_real: torch.Tensor | None = None):
    """Speculative one-pass chain: front end + payload decode of every
    detected row under a presumed canonical config.

    Returns (meta (max_pkts, 7) [trig, ltf_idx, peak, cfo, rssi, valid,
    fits], bits (max_pkts, 120) uint8, psdu (SPEC_ROWS, psdu_len) uint8
    compacted to the first SPEC_ROWS valid rows in device order, sssnr0
    (SPEC_ROWS,))."""
    trigs, ltf_idx, peak, cfo, rssi, valid, bits = _front(stream[0], max_pkts)
    n = stream.shape[-1]
    n_need = _data_start(cfg) + 80 * cfg.nsym + 16
    fits = ltf_idx + n_need < n
    li2 = torch.clamp(ltf_idx, 0, max(n - n_need - 1, 0))
    want_sssnr = cfg.fmt == Fmt.VHT and cfg.nss == 1
    out = _payload_core(cfg, stream, li2, cfo, nrx=nrx, n_real=n_real,
                        want_sssnr=want_sssnr)
    meta = _meta(trigs, ltf_idx, peak, cfo, rssi, valid, fits)
    sssnr = out.get("sssnr0", torch.zeros(max_pkts, dtype=torch.float32,
                                          device=meta.device))
    k = min(SPEC_ROWS, max_pkts)
    vsel = FE.nonzero_padded(valid, k, max_pkts - 1)
    return meta, bits, out["psdu"][vsel], sssnr[vsel]


def _ndp_chan_core(stream: CF, ltf_idx: torch.Tensor, cfo: torch.Tensor,
                   nsts: int, nrx: int) -> CF:
    """Batched NDP channel estimate: (B,) sync positions -> (B, nrx, nsts,
    64) channel."""
    nltf = int(T.N_LTF_OF_NSTS[nsts])
    n_need = 208 + 160 + 80 + 80 * nltf
    xs = cstack([FE.derotate_batch(stream[r], ltf_idx, cfo, n_need)
                 for r in range(nrx)], dim=1)
    h, _ = OF.nl_chanest(xs, 208 + 160 + 80, nltf, nsts)
    return h


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _to_numpy_c(h: CF) -> np.ndarray:
    return h.re.cpu().numpy() + 1j * h.im.cpu().numpy()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

_INGEST = {"f32": from_numpy_cf, "bf16": from_numpy_cf_bf16,
           "i8": from_numpy_cf_i8}


class RxEngine:
    """Streaming receiver over a (nrx, N) IQ timeline.

    ``device`` is where the stream is uploaded and every stage runs; the
    default "cuda" raises where there is no card (pass "cpu" for the
    CPU, where the kernels' plain twins run).  ``ingest`` stages the
    upload as "f32" (exact), "bf16" (half the bytes) or "i8" (block-AGC
    int8, a quarter)."""

    def __init__(self, nrx: int = 1, mu_pos: int | None = None,
                 mu_gid: int | None = None, ingest_bf16: bool = False,
                 ingest: str | None = None, speculate: bool = True,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RxEngine(device='cuda') needs a CUDA card; "
                               "pass device='cpu' to run on the CPU")
        self.nrx = nrx
        #: MU-MIMO station position: with it, MU PPDUs decode this user's
        #: stream; ``mu_gid`` keeps only PPDUs of that group id
        self.mu_pos = mu_pos
        self.mu_gid = mu_gid
        self.ingest = ingest or ("bf16" if ingest_bf16 else "f32")
        if self.ingest not in _INGEST:
            raise ValueError(f"ingest must be one of {sorted(_INGEST)}")
        #: one-pass speculation: when the previous block's data traffic
        #: was homogeneous, the next block runs front end + decode for that
        #: config in one pass (_spec_core) and the host verifies per row
        self.speculate = speculate
        self._spec_canon: tuple | None = None
        #: SIG-bits -> classification cache (a pure parse)
        self._cls_cache: dict = {}

    # -- detection ---------------------------------------------------------
    def detect(self, stream0: CF, max_out: int = 4096) -> np.ndarray:
        """Candidate trigger indices of one antenna's (N,) device stream."""
        m4 = FE.stf_metric_strided(stream0)
        cand = FE.detect_plateaus_strided(m4, max_out=max_out).cpu().numpy()
        return dedup_triggers(cand[cand >= 0])

    # -- full pipeline -----------------------------------------------------
    def process(self, stream: np.ndarray) -> list[RxResult]:
        stream = np.atleast_2d(stream)
        return self.process_device(self._upload(stream), stream.shape[1])

    def _upload(self, stream: np.ndarray) -> CF:
        return _INGEST[self.ingest](stream, self.device)

    def _max_pkts(self, n_stream: int) -> int:
        # capacity from the real minimum trigger spacing (dedup keeps
        # triggers > 700 apart, quantized to 16 -> 704), padded to a power
        # of two; it sets the detector's max_out, so it is kept exactly
        min_sp = (TRIG_DEDUP_SPACING // 16) * 16
        cap = max(16, min(4096, n_stream // min_sp + 1))
        return 1 << (cap - 1).bit_length()

    def begin_process(self, stream: np.ndarray):
        """Upload a block and run its front end (or, when armed, the
        speculative one-pass decode); returns a handle for
        :meth:`finish_process`."""
        stream = np.atleast_2d(stream)
        dev = self._upload(stream)
        n_stream = stream.shape[1]
        spec = self._spec_canon if self.speculate else None
        if spec is not None:
            canon, nreal = spec
            max_pkts = self._max_pkts(n_stream)
            nr = torch.full((max_pkts,), nreal, dtype=torch.int32,
                            device=self.device)
            outs = _spec_core(canon, dev, max_pkts, nrx=self.nrx, n_real=nr)
            return (dev, n_stream, ("spec", spec) + outs)
        meta_d, bits_d = self._front_dispatch(dev, n_stream)
        return (dev, n_stream, ("front", meta_d, bits_d))

    def finish_process(self, handle) -> list[RxResult]:
        """Read a :meth:`begin_process` handle back and run classification
        + bucket decodes to completion."""
        dev, n_stream, rest = handle
        if rest[0] == "spec":
            _, spec, meta_d, bits_d, psdu_d, sssnr_d = rest
            return self._finish(dev, n_stream, meta_d, bits_d,
                                spec=(spec, _host(psdu_d), _host(sssnr_d)))
        return self._finish(dev, n_stream, rest[1], rest[2])

    def _front_dispatch(self, dev: CF, n_stream: int):
        return _front_core(dev[0], self._max_pkts(n_stream))

    def process_device(self, dev: CF, n_stream: int) -> list[RxResult]:
        """Run the full engine on an already device-resident (nrx, N) CF
        stream."""
        meta_d, bits_d = self._front_dispatch(dev, n_stream)
        return self._finish(dev, n_stream, meta_d, bits_d)

    def _finish(self, dev: CF, n_stream: int, meta_d, bits_d,
                spec=None) -> list[RxResult]:
        meta, sig_bits = _host(meta_d), _host(bits_d)
        keep = meta[:, 5] > 0.5
        fits = meta[keep, 6] > 0.5 if spec is not None else None
        meta, sig_bits = meta[keep], sig_bits[keep]
        if meta.shape[0] == 0:
            # idle block: keep the speculation armed
            return []
        trigs = meta[:, 0].astype(np.int64)
        ltf_idx = meta[:, 1].astype(np.int64)
        peak = meta[:, 2]
        cfo = meta[:, 3]
        snr_db = 10.0 * np.log10(peak / np.maximum(1.0 - peak, 1e-6))
        rssi = meta[:, 4]
        lsig_b = sig_bits[:, 0:24]
        ht_b = sig_bits[:, 24:72]
        vht_b = sig_bits[:, 72:120]

        buckets: dict[PhyConfig, list] = {}
        kinds: list = []
        results: list[RxResult | None] = [None] * len(ltf_idx)
        seen_canons: set = set()
        spec_canon, spec_psdu, spec_sssnr = spec if spec else (None,) * 3
        for i in range(len(ltf_idx)):
            key = sig_bits[i].tobytes()
            ent = self._cls_cache.get(key)
            if ent is None:
                lsig = S.parse_lsig(lsig_b[i])
                ent = ((None, None) if not lsig.ok
                       else self._classify(lsig, ht_b[i], vht_b[i]))
                if len(self._cls_cache) > 65536:
                    self._cls_cache.clear()
                self._cls_cache[key] = ent
            cfg, ndp = ent
            if ndp is not None:
                kinds.append(("ndp", ndp))
                continue
            if cfg is None:
                kinds.append(None)
                continue
            if isinstance(cfg, tuple):          # ("mu", siga, lsig)
                kinds.append(cfg)
                continue
            canon = canonical_cfg(cfg)
            if ltf_idx[i] + _data_start(canon) + 80 * canon.nsym + 16 \
                    > n_stream:
                # padded window overruns the block: fall back to exact shape
                canon = cfg
            if ltf_idx[i] + _data_start(cfg) + 80 * cfg.nsym + 16 \
                    > n_stream:
                kinds.append(None)
                continue
            seen_canons.add((canon, cfg.n_trellis))
            if (spec_canon is not None
                    and (canon, cfg.n_trellis) == spec_canon and fits[i]
                    and i < len(spec_psdu)):
                # speculation hit: the one-pass decode already has this row
                # (kept row i == compacted psdu row i)
                pb = spec_psdu[i][: cfg.psdu_len].tobytes()
                ss = (float(spec_sssnr[i])
                      if cfg.fmt == Fmt.VHT and cfg.nss == 1 else None)
                results[i] = self._mk_data_result(
                    cfg, pb, int(ltf_idx[i]), float(cfo[i]), int(trigs[i]),
                    float(snr_db[i]), float(rssi[i]), ss)
                kinds.append(("data", cfg))
                continue
            buckets.setdefault(canon, []).append((i, cfg))
            kinds.append(("data", cfg))
        for canon, all_items in buckets.items():
            # cap the bucket batch so the decision planes (n_trellis x 64 x
            # B bytes) stay within ~2 GB (the reference's cap)
            max_b = max(128,
                        -(-(1 << 31) // (canon.n_trellis * 64)) // 128 * 128)
            for c0 in range(0, len(all_items), max_b):
                self._decode_bucket(dev, canon, all_items[c0: c0 + max_b],
                                    ltf_idx, cfo, trigs, results, snr_db,
                                    rssi)
        # NDPs: one channel-estimate batch per nsts value
        ndp_groups: dict[int, list[int]] = {}
        for i, ki in enumerate(kinds):
            if ki is not None and ki[0] == "ndp":
                ndp_groups.setdefault(ki[1], []).append(i)
        for nsts, idxs in ndp_groups.items():
            sel = np.zeros(_pad_batch(len(idxs)), np.int64)
            sel[: len(idxs)] = idxs
            h = _ndp_chan_core(dev, self._rows(ltf_idx[sel]),
                               self._rows(cfo[sel]), nsts, self.nrx)
            hc = _to_numpy_c(h)
            for j, i in enumerate(idxs):
                r = RxResult(True, Fmt.VHT, 0, nsts, int(ltf_idx[i]),
                             float(cfo[i]), is_ndp=True, trig=int(trigs[i]),
                             snr_db=float(snr_db[i]), rssi=float(rssi[i]))
                r.ndp_chan = hc[j]
                results[i] = r
        self._process_mu(dev, ltf_idx, cfo, trigs, kinds, results, n_stream,
                         snr_db, rssi)
        # next-block speculation: homogeneous sparse data traffic arms it,
        # mixed data traffic or dense blocks disarm, data-free blocks (NDP,
        # MU, idle) leave it as it was
        if len(seen_canons) == 1 and len(ltf_idx) <= SPEC_ROWS:
            self._spec_canon = next(iter(seen_canons))
        elif seen_canons:
            self._spec_canon = None
        return [r for r in results if r is not None]

    def _rows(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _mk_data_result(self, cfg: PhyConfig, pb: bytes, ltf_idx: int,
                        cfo: float, trig: int, snr_db: float, rssi: float,
                        sssnr) -> RxResult:
        """Per-packet assembly: MPDU walk + FCS by format."""
        r = RxResult(False, cfg.fmt, cfg.mcs, cfg.nss, ltf_idx, cfo,
                     trig=trig, snr_db=snr_db, rssi=rssi)
        if sssnr is not None:
            r.sssnr0 = sssnr
        r.psdu = pb
        if cfg.fmt == Fmt.VHT:
            r.mpdus = deagg_vht(pb)
            r.ok = len(r.mpdus) > 0
        elif cfg.fmt == Fmt.HT and cfg.ampdu:
            r.mpdus = MAC.ampdu_deaggregate(pb, ht=True)
            r.ok = len(r.mpdus) > 0
        else:
            r.ok = GB.fcs_ok(pb)
            r.mpdus = [pb] if r.ok else []
        return r

    def _decode_bucket(self, dev: CF, canon: PhyConfig, items, ltf_idx, cfo,
                       trigs, results, snr_db, rssi):
        """items: [(packet index, exact PhyConfig)], decoded with the shared
        canonical config; each packet's real psdu is sliced from the padded
        decode (>= _CANON_MERGE_STEPS of trellis margin)."""
        nb = len(items)
        pad = _pad_batch(nb)
        sel = np.zeros(pad, np.int64)
        sel[:nb] = [i for i, _ in items]
        n_real = np.full(pad, canon.n_trellis, np.int32)
        n_real[:nb] = [c.n_trellis for _, c in items]
        want_sssnr = canon.fmt == Fmt.VHT and canon.nss == 1
        out = _payload_core(canon, dev, self._rows(ltf_idx[sel]),
                            self._rows(cfo[sel]), nrx=self.nrx,
                            n_real=self._rows(n_real), want_sssnr=want_sssnr)
        psdu = out["psdu"].cpu().numpy()
        sssnr = out["sssnr0"].cpu().numpy() if "sssnr0" in out else None
        for j, (i, cfg) in enumerate(items):
            pb = psdu[j][: cfg.psdu_len].tobytes()
            ss = float(sssnr[j]) if sssnr is not None else None
            results[i] = self._mk_data_result(
                cfg, pb, int(ltf_idx[i]), float(cfo[i]), int(trigs[i]),
                float(snr_db[i]), float(rssi[i]), ss)

    def _process_mu(self, dev: CF, ltf_idx, cfo, trigs, kinds, results,
                    n_stream: int, snr_db, rssi):
        """Batched MU-STA decode: one SIG-B pass per nsts tuple, then one
        payload decode per exact (mcs, length, nsym) config (MU configs
        take no canonical rung).  Two host readbacks a group: the SIG-B
        bits, then each bucket's PSDU and SERVICE bits."""
        groups: dict[tuple, list[int]] = {}
        for i, ki in enumerate(kinds):
            if ki is not None and ki[0] == "mu":
                groups.setdefault(ki[1].nsts, []).append(i)
        for nsts, idxs in groups.items():
            n_total = sum(nsts)
            own = sum(nsts[: self.mu_pos])
            sel = np.zeros(_pad_batch(len(idxs)), np.int64)
            sel[: len(idxs)] = idxs
            sigb_b = _host(_mu_sigb_core(dev[0], self._rows(ltf_idx[sel]),
                                         self._rows(cfo[sel]), n_total, own))
            nltf, _, _, data_start = _mu_starts(n_total)
            buckets: dict[PhyConfig, list[tuple[int, np.ndarray]]] = {}
            for j, i in enumerate(idxs):
                sigb = S.parse_vhtsigb(sigb_b[j], mu=True)
                lsig = kinds[i][2]
                n_data = lsig.nsym * 80 - (160 + 80 + 80 * nltf + 80)
                nsym = max(n_data // 80, 0)
                if (nsym == 0 or not sigb.ok or sigb.mcs > 8
                        or not (1 <= sigb.length <= 4095)):
                    continue
                if ltf_idx[i] + data_start + 80 * nsym + 16 > n_stream:
                    continue
                cfg = PhyConfig(Fmt.VHT, sigb.mcs, nsts[self.mu_pos],
                                sigb.length, ampdu=True, mu_nsym=nsym)
                if cfg.nsym != nsym:
                    continue
                buckets.setdefault(cfg, []).append((i, sigb.crc))
            for cfg, items in buckets.items():
                sel = np.zeros(_pad_batch(len(items)), np.int64)
                sel[: len(items)] = [i for i, _ in items]
                out = _payload_core_mu(cfg, dev, self._rows(ltf_idx[sel]),
                                       self._rows(cfo[sel]), n_total, own,
                                       nrx=self.nrx)
                psdu, service = _host(out["psdu"]), _host(out["service"])
                for j, (i, crc) in enumerate(items):
                    if not np.array_equal(service[j, 8:16], crc):
                        continue
                    r = RxResult(False, Fmt.VHT, cfg.mcs, cfg.nss,
                                 int(ltf_idx[i]), float(cfo[i]),
                                 trig=int(trigs[i]), snr_db=float(snr_db[i]),
                                 rssi=float(rssi[i]))
                    r.psdu = psdu[j].tobytes()
                    r.mpdus = MAC.ampdu_deaggregate(r.psdu)
                    r.ok = len(r.mpdus) > 0
                    results[i] = r

    def _classify(self, lsig, ht_bits, vht_bits):
        """-> (PhyConfig | ("mu", siga, lsig) | None, ndp_nss | None).
        Without ``mu_pos`` an MU VHT-SIG-A is skipped here and the PPDU
        falls through to the HT-SIG / L-SIG checks."""
        if lsig.mcs != 0:
            return PhyConfig(Fmt.L, lsig.mcs, 1, lsig.length), None
        siga = S.parse_vhtsiga(vht_bits)
        if siga.ok and siga.mu and self.mu_pos is not None:
            if self.mu_gid is not None and siga.group_id != self.mu_gid:
                return None, None
            if siga.nsts[self.mu_pos] == 0:
                return None, None
            return ("mu", siga, lsig), None
        if siga.ok and not siga.mu:
            nltf = int(T.N_LTF_OF_NSTS[siga.nss])
            n_data = lsig.nsym * 80 - (160 + 80 + 80 * nltf + 80)
            nsym = max(n_data // 80, 0)
            if nsym == 0:
                return None, siga.nss
            probe = PhyConfig(Fmt.VHT, siga.mcs, siga.nss, 1, ampdu=True)
            max_len = (nsym * probe.ndbps - 22) // 8
            if not (1 <= max_len <= 4095):
                return None, None
            cfg = PhyConfig(Fmt.VHT, siga.mcs, siga.nss, max_len, ampdu=True)
            return (cfg if cfg.nsym == nsym else None), None
        htsig = S.parse_htsig(ht_bits)
        if htsig.ok:
            nss = htsig.mcs // 8 + 1
            if nss <= self.nrx:
                cfg = PhyConfig(Fmt.HT, htsig.mcs, nss, htsig.length,
                                ampdu=htsig.ampdu)
                # L-SIG TXTIME plausibility bound: the HT-SIG-implied air
                # time must fit the L-SIG sample budget
                if lsig.nsym * 80 < cfg.nsym * 80 + 160 + 80 + 80 * cfg.nltf:
                    return None, None
                return cfg, None
            return None, None
        if lsig.ok:
            return PhyConfig(Fmt.L, 0, 1, lsig.length), None
        return None, None

    def _ndp_chan(self, dev: CF, ltf_idx: int, cfo: float,
                  nsts: int) -> np.ndarray:
        """One NDP's (nrx, nsts, 64) channel estimate."""
        h = _ndp_chan_core(dev, self._rows(np.array([ltf_idx])),
                           self._rows(np.array([cfo], np.float32)), nsts,
                           self.nrx)
        return _to_numpy_c(h)[0]

    # -- known-config fast path --------------------------------------------
    def decode_aligned(self, cfg: PhyConfig, stream: np.ndarray,
                       ltf_idx: np.ndarray, cfo: np.ndarray,
                       mpdu_len: int = 0) -> dict:
        """Decode a batch of same-config packets at known sync positions."""
        dev = from_numpy_cf(np.atleast_2d(stream), self.device)
        return _payload_core(cfg, dev, self._rows(np.asarray(ltf_idx)),
                             self._rows(np.asarray(cfo, np.float32)),
                             nrx=self.nrx, mpdu_len=mpdu_len)
