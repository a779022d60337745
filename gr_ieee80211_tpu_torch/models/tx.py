"""Batched transmit engine.

Port of ``gr_ieee80211_tpu.models.tx``.  One call per :class:`PhyConfig`
maps a (B, psdu_len) byte batch to (B, nss, n_samples) baseband CF
waveforms on the device of the payload tensor:

* bit pipeline (scramble/BCC/puncture/stream-parse/interleave) as XORs of
  shifted slices, one row gather of the scrambling sequence and one static
  gather;
* QAM mapping as table lookups, grid assembly as index assignment on a
  fresh tensor;
* the IFFT as ``cplx.idft64`` over (B, nss, nsym, 64);
* the preamble as a per-config constant template and the symbol-boundary
  windowing as one static scale mask over the whole waveform.

The per-config constants are numpy under ``lru_cache`` and reach the device
through a per-device cache.  Numerics match the gold TX (``gold.tx``) to
float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..gold import sig as S
from ..gold import tx as GTX
from ..ops import ofdm as OF
from ..ops.cplx import CF, cstack, from_numpy_cf, idft64, to_numpy
from ..spec import tables as T
from ..spec.params import Fmt, MuConfig, PhyConfig


def _boundary_mask(chunk_lens: list[int]) -> np.ndarray:
    """Window mask over the whole waveform: both samples at every field
    boundary are halved."""
    mask = np.ones(sum(chunk_lens), np.float32)
    pos = 0
    for ln in chunk_lens[:-1]:
        pos += ln
        mask[pos - 1] *= 0.5
        mask[pos] *= 0.5
    return mask


def _bit_pipeline_parts(cfg: PhyConfig, sigb_crc: np.ndarray) -> dict:
    """Per-config constants of one user's bit pipeline: SERVICE and pad
    bit templates, puncture keep indices, the interleave + stream-parse
    gather and the QAM table."""
    service = np.zeros(16, np.uint8)
    if cfg.fmt == Fmt.VHT:
        service[8:] = sigb_crc
        tail = np.concatenate(
            [np.tile(T.VHT_EOF_BITS, cfg.n_pad_eof),
             np.zeros(8 * cfg.n_pad_octet, np.uint8),
             np.zeros(cfg.n_pad_bits, np.uint8)])
    else:
        tail = np.zeros(6 * cfg.nes + cfg.n_pad_bits, np.uint8)
    # the RX gather has coded[i] = inter_flat[rxp[i]], so inter_flat =
    # coded[:, g] with g = rxp^{-1} (g[rxp[i]] = i)
    rxp = OF._deint_deparse_perm(cfg.fmt, cfg.nbpscs, cfg.nss, cfg.nsym)
    g = np.empty_like(rxp)
    g[rxp] = np.arange(len(rxp))
    pat = T.PUNCTURE[cfg.cr]
    n2 = 2 * cfg.n_trellis
    keep = np.tile(pat, -(-n2 // len(pat)))[:n2].astype(bool)
    qtab = T.qam_table(cfg.nbpscs)
    return dict(service=service, tail=tail.astype(np.uint8),
                tx_perm=g.astype(np.int64),
                punct_idx=np.nonzero(keep)[0].astype(np.int64),
                qam_re=qtab.real.astype(np.float32),
                qam_im=qtab.imag.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _static_parts(cfg: PhyConfig, group_id: int, partial_aid: int) -> dict:
    """Per-config constants: preamble template, pad bits, perms, masks."""
    nss = cfg.nss
    chunks = GTX.legacy_training(nss) + [GTX.lsig_field(cfg, nss)]
    sigb_crc = np.zeros(8, np.uint8)
    if cfg.fmt == Fmt.HT:
        chunks += GTX._dual_sym_sig(S.htsig_bits(cfg), nss, qbpsk_first=True)
        chunks += GTX.nl_training(nss, cfg.nltf, Fmt.HT)
    elif cfg.fmt == Fmt.VHT:
        chunks += GTX._dual_sym_sig(S.vhtsiga_bits(cfg, group_id, partial_aid),
                                    nss, qbpsk_first=False)
        chunks += GTX.nl_training(nss, cfg.nltf, Fmt.VHT)
        sigb, sigb_crc = S.vhtsigb_bits(cfg)
        chunks.append(GTX.vhtsigb_field(GTX.interleave_sigb(sigb), nss))
    pre = np.concatenate(chunks, axis=-1)          # (nss, n_pre), unhalved
    mask = _boundary_mask([c.shape[-1] for c in chunks] + [80] * cfg.nsym)
    csd = np.stack([T.csd_phase(T.CSD_NL_NS[nss - 1][s]) for s in range(nss)])
    scale = 1.0 / np.sqrt((T.NTF_DATA_L if cfg.fmt == Fmt.L
                           else T.NTF_DATA_NL) * nss)
    return dict(
        _bit_pipeline_parts(cfg, sigb_crc),
        pre_re=pre.real.astype(np.float32), pre_im=pre.imag.astype(np.float32),
        mask=mask,
        pilots=np.ascontiguousarray(                      # (nss, nsym, 4)
            OF._pilot_matrix(cfg.fmt, nss, cfg.nsym).transpose(1, 0, 2)),
        csd_re=csd.real.astype(np.float32), csd_im=csd.imag.astype(np.float32),
        scale=np.float32(scale))


def _on(parts: dict, device: torch.device) -> dict:
    """The numpy constants of ``parts`` as tensors on ``device``; other
    entries (configs, nested per-user dicts, scalars) pass through."""
    out = {}
    for k, v in parts.items():
        if isinstance(v, np.ndarray) and v.ndim:
            out[k] = torch.from_numpy(v).to(device)
        elif isinstance(v, tuple):
            out[k] = tuple(_on(u, device) for u in v)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _static_on(cfg: PhyConfig, group_id: int, partial_aid: int,
               device: torch.device) -> dict:
    return _on(_static_parts(cfg, group_id, partial_aid), device)


def _bcc_encode_batch(bits: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 -> (B, 2n) rate-1/2 coded, by XOR of tap-shifted
    slices."""
    B, n = bits.shape
    h = torch.nn.functional.pad(bits, (6, 0))

    def tap(k):  # b_{t-k}
        return h[:, 6 - k: 6 - k + n]
    a = tap(0) ^ tap(2) ^ tap(3) ^ tap(5) ^ tap(6)
    c = tap(0) ^ tap(1) ^ tap(2) ^ tap(3) ^ tap(6)
    return torch.stack([a, c], dim=-1).reshape(B, 2 * n)


@functools.lru_cache(maxsize=None)
def _seed_offsets() -> np.ndarray:
    """(128,) seed -> cyclic offset of its sequence in the 127-periodic
    scrambling sequence (through the seed's first 7 outputs)."""
    _, off_tab = OF._descramble_tables()
    word = np.zeros(128, np.int64)
    for sd in range(1, 128):
        w7 = T.scramble_seq(sd)[:7]
        word[sd] = int(sum(int(b) << i for i, b in enumerate(w7)))
    return off_tab[word].astype(np.int64)


@functools.lru_cache(maxsize=None)
def _seed_offsets_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_seed_offsets()).to(device)


def _scramble_batch(bits: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """XOR with the 127-periodic sequence starting at each packet's seed:
    a row gather of the shifted-sequence table ``descramble_bits`` uses."""
    _, mat = OF._descramble_on(bits.shape[1], bits.device)
    off = _seed_offsets_on(bits.device)[seeds.to(torch.int64)]
    return bits ^ mat[off]


def _bytes_to_bits(payload: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 bytes -> (B, 8n) uint8 bits, LSB first."""
    sh = torch.arange(8, dtype=torch.uint8, device=payload.device)
    return ((payload[:, :, None] >> sh) & 1).reshape(payload.shape[0], -1)


def _qam_streams(st: dict, cfg: PhyConfig, payload: torch.Tensor,
                 seeds: torch.Tensor) -> CF:
    """One user's bit pipeline: payload bytes -> (B, nss, nsym, nsd) QAM
    symbols.  VHT zeroes the last 6 trellis inputs after scrambling (the
    tail follows the padding); L/HT zero the tail where it stands."""
    B = payload.shape[0]
    data_bits = torch.cat([st["service"].expand(B, -1),
                           _bytes_to_bits(payload),
                           st["tail"].expand(B, -1)], dim=1)
    scrambled = _scramble_batch(data_bits, seeds)
    if cfg.fmt == Fmt.VHT:
        enc_in = torch.nn.functional.pad(
            scrambled[:, : cfg.n_trellis - 6], (0, 6))
    else:
        enc_in = scrambled.clone()
        t0 = 16 + 8 * cfg.psdu_len
        enc_in[:, t0: t0 + 6 * cfg.nes] = 0
    coded = _bcc_encode_batch(enc_in)[:, st["punct_idx"]]
    inter = coded[:, st["tx_perm"]]            # (B, nss*nsym*ncbpss) flat
    chips = inter.reshape(B, cfg.nss, cfg.nsym, cfg.nsd, cfg.nbpscs)
    pw = torch.tensor([1 << i for i in range(cfg.nbpscs)],
                      device=payload.device)
    chips = (chips.to(torch.int64) * pw).sum(dim=-1)
    return CF(st["qam_re"][chips], st["qam_im"][chips])


def _data_grids(sym: CF, pilots: torch.Tensor, didx: torch.Tensor,
                pidx: torch.Tensor) -> CF:
    """(B, nss, nsym, nsd) symbols + (nss, nsym, 4) pilot polarities ->
    (B, nss, nsym, 64) grids; the pilots go to the real part only."""
    B, nss, nsym, _ = sym.shape
    re = torch.zeros((B, nss, nsym, 64), dtype=torch.float32,
                     device=sym.device)
    im = torch.zeros_like(re)
    re[..., didx] = sym.re
    im[..., didx] = sym.im
    re[..., pidx] = pilots
    return CF(re, im)


def _gi80(xt: CF) -> CF:
    """(..., 64) time symbols -> (..., 80) GI-prefixed."""
    return CF(torch.cat([xt.re[..., 48:], xt.re], dim=-1),
              torch.cat([xt.im[..., 48:], xt.im], dim=-1))


def _finish_wave(pre: CF, data_time: CF, mask: torch.Tensor) -> CF:
    """(nss, n_pre) preamble + (B, nss, n_data) data -> masked waveform."""
    B = data_time.shape[0]
    return CF(torch.cat([pre.re.expand(B, -1, -1), data_time.re], dim=-1),
              torch.cat([pre.im.expand(B, -1, -1), data_time.im], dim=-1)
              ) * mask


def tx_batch(cfg: PhyConfig, payload: torch.Tensor, seeds: torch.Tensor,
             group_id: int = 0, partial_aid: int = 0) -> CF:
    """(B, cfg.length) uint8 + (B,) seeds -> (B, nss, n_samples) CF on the
    payload's device.

    ``payload`` carries cfg.length bytes per packet (the A-MPDU for VHT;
    none for an NDP, whose waveform is the preamble alone).
    """
    dev = payload.device
    st = _static_on(cfg, group_id, partial_aid, dev)
    B = payload.shape[0]
    sym = _qam_streams(st, cfg, payload, seeds)
    grids = _data_grids(
        sym, st["pilots"],
        OF._idx("DATA_IDX_L" if cfg.fmt == Fmt.L else "DATA_IDX_NL", dev),
        OF._idx("PILOT_IDX", dev))
    grids = grids * CF(st["csd_re"][None, :, None, :],
                       st["csd_im"][None, :, None, :])
    xt = idft64(grids) * float(st["scale"])        # (B, nss, nsym, 64)
    data_time = _gi80(xt).reshape(B, cfg.nss, cfg.nsym * 80)
    return _finish_wave(CF(st["pre_re"], st["pre_im"]), data_time, st["mask"])


# ---------------------------------------------------------------------------
# MU-MIMO / beamformed transmit
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _static_parts_mu(mu: MuConfig) -> dict:
    """Per-MU-config constants.

    Everything before the non-legacy STF is Q-independent (only NL-STF,
    the LTFs, SIG-B and the data symbols are spatially mapped), so the
    legacy preamble + VHT-SIG-A is one static time-domain template; the
    Q-dependent fields are kept as CSD'd frequency grids and mixed with the
    runtime Q.
    """
    nss = mu.nss_total
    if nss > 2:
        raise ValueError("at most 2 space-time streams in total")
    # -- Q-independent legacy/SIG-A template (nss, 640) --------------------
    leg_chunks = (GTX.legacy_training(nss) + [GTX.lsig_field(mu, nss)]
                  + GTX._dual_sym_sig(S.vhtsiga_bits(mu), nss,
                                      qbpsk_first=False))
    leg = np.concatenate(leg_chunks, axis=-1)
    # -- Q-dependent grids (CSD applied, Q deferred to runtime) ------------
    pilot_mask = np.zeros(64, dtype=bool)
    pilot_mask[T.PILOT_IDX] = True
    nl_grids = [GTX._apply_csd(np.tile(T.STF_GRID, (nss, 1)), nss, False)]
    nl_scales = [1.0 / np.sqrt(T.NTF_STF_NL * nss)]
    for i in range(mu.nltf):
        g = np.empty((nss, 64), dtype=np.complex128)
        for iss in range(nss):
            row = T.LTF_NL_GRID * T.P_LTF[iss, i]
            g[iss] = np.where(pilot_mask, T.LTF_NL_GRID * T.R_LTF[i], row)
        nl_grids.append(GTX._apply_csd(g, nss, False))
        nl_scales.append(1.0 / np.sqrt(T.NTF_LTF_NL * nss))
    # SIG-B: per-user bits, user streams stacked in order, then CSD
    sigb_streams, crcs = [], []
    for ucfg in mu.users:
        sigb, crc = S.vhtsigb_bits_mu(ucfg)
        crcs.append(crc)
        inted = GTX.interleave_sigb(sigb)
        for _ in range(ucfg.nss):
            sigb_streams.append(T.qam_table(1)[inted])
    g = np.zeros((nss, 64), dtype=np.complex128)
    for iss in range(nss):
        g[iss, T.DATA_IDX_NL] = sigb_streams[iss]
        g[iss, T.PILOT_IDX] = T.PILOT_VHT
    nl_grids.append(GTX._apply_csd(g, nss, False))
    nl_scales.append(1.0 / np.sqrt(T.NTF_SIGB * nss))
    nl_g = np.stack(nl_grids)                       # (nltf+2, nss, 64)

    users = tuple(dict(_bit_pipeline_parts(mu.user_padded(u), crcs[u]),
                       cfg=mu.user_padded(u))
                  for u in range(len(mu.users)))
    pilots = GTX.data_pilots(Fmt.VHT, nss, mu.nsym)  # (nsym, nss, 4)
    csd = np.stack([T.csd_phase(T.CSD_NL_NS[nss - 1][s]) for s in range(nss)])
    mask = _boundary_mask([c.shape[-1] for c in leg_chunks]
                          + [80] * (mu.nltf + 2) + [80] * mu.nsym)
    return dict(
        leg_re=leg.real.astype(np.float32), leg_im=leg.imag.astype(np.float32),
        nl_re=nl_g.real.astype(np.float32), nl_im=nl_g.imag.astype(np.float32),
        nl_scales=np.asarray(nl_scales, np.float32), users=users,
        pilots=np.ascontiguousarray(
            pilots.astype(np.float32).transpose(1, 0, 2)),  # (nss, nsym, 4)
        csd_re=csd.real.astype(np.float32), csd_im=csd.imag.astype(np.float32),
        data_scale=np.float32(1.0 / np.sqrt(T.NTF_DATA_NL * nss)), mask=mask)


@functools.lru_cache(maxsize=None)
def _static_mu_on(mu: MuConfig, device: torch.device) -> dict:
    return _on(_static_parts_mu(mu), device)


def _apply_q_grids(g: CF, q: CF, sub: str) -> CF:
    """Per-subcarrier spatial mapping out[...,i,...,k] = sum_j q[k,i,j]
    g[...,j,...,k].

    ``sub`` names the axes of the grids, e.g. "cjk" (preamble chunks) or
    "bjnk" (batched data symbols); j is the input-stream axis, k the
    subcarrier (last).  The contraction over j (at most 2 streams) is
    written out as float32 multiply-adds, so no matmul path (and so no
    TF32 whatever ``allow_tf32`` says) ever carries it.
    """
    ax = sub.index("j")
    lead = (slice(None),) * ax
    outs = []
    for i in range(q.shape[1]):
        acc = None
        for j in range(q.shape[2]):
            term = g[lead + (j,)] * CF(q.re[:, i, j], q.im[:, i, j])
            acc = term if acc is None else acc + term
        outs.append(acc)
    return cstack(outs, dim=ax)


def tx_batch_mu(mu: MuConfig, payloads: tuple, seeds: torch.Tensor,
                q: CF) -> CF:
    """Batched MU-MIMO / beamformed VHT transmit.

    ``payloads``: per-user (B, len_u) uint8 tensors; ``seeds``: (B,)
    scramble seeds (applied to every user, like the gold model); ``q``:
    (64, nss, nss) CF per-subcarrier spatial mapping.  Returns (B,
    nss_total, n_samples) CF, float32-parity with
    :func:`gold.tx.tx_waveform_mu`: the per-user bit pipelines are batched
    like :func:`tx_batch`'s and the per-subcarrier Q multiply runs over the
    whole (B, nss, nsym, 64) grid tensor at once.
    """
    dev = payloads[0].device
    st = _static_mu_on(mu, dev)
    B = payloads[0].shape[0]
    nss = mu.nss_total

    # -- per-user encode -> QAM streams, stacked on the stream axis --------
    streams = [_qam_streams(ust, ust["cfg"], payloads[u], seeds)
               for u, ust in enumerate(st["users"])]
    sym = CF(torch.cat([s.re for s in streams], dim=1),
             torch.cat([s.im for s in streams], dim=1))

    # -- data grids: pilots + CSD + Q + IFFT -------------------------------
    grids = _data_grids(sym, st["pilots"], OF._idx("DATA_IDX_NL", dev),
                        OF._idx("PILOT_IDX", dev))
    csd = CF(st["csd_re"][None, :, None, :], st["csd_im"][None, :, None, :])
    grids = _apply_q_grids(grids * csd, q, "bjnk")
    xt = idft64(grids) * float(st["data_scale"])
    data_time = _gi80(xt).reshape(B, nss, mu.nsym * 80)

    # -- Q-dependent preamble fields (NL-STF / LTFs / SIG-B) ---------------
    nl_g = _apply_q_grids(CF(st["nl_re"], st["nl_im"]), q, "cjk")
    nl_t = idft64(nl_g) * st["nl_scales"][:, None, None]
    nl_time = _gi80(nl_t)                           # (nltf+2, nss, 80)
    nl_time = CF(nl_time.re.permute(1, 0, 2).reshape(nss, -1),
                 nl_time.im.permute(1, 0, 2).reshape(nss, -1))
    pre = CF(torch.cat([st["leg_re"], nl_time.re], dim=-1),
             torch.cat([st["leg_im"], nl_time.im], dim=-1))
    return _finish_wave(pre, data_time, st["mask"])


def _payload_array(payloads: list[bytes], length: int) -> np.ndarray:
    arr = np.zeros((len(payloads), length), np.uint8)
    for i, p in enumerate(payloads):
        if len(p) != length:
            raise ValueError(f"payload {i} has {len(p)} bytes, the config "
                             f"says {length}")
        arr[i] = np.frombuffer(p, np.uint8)
    return arr


class TxEngine:
    """Host-facing batched transmitter.

    ``device`` is where the waveforms are synthesized; the default "cuda"
    raises where there is no card (pass "cpu" for the CPU)."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TxEngine(device='cuda') needs a CUDA card; "
                               "pass device='cpu' to run on the CPU")

    def _seeds(self, seeds, B: int) -> torch.Tensor:
        if seeds is None:
            seeds = np.full(B, 93, np.int64)
        return torch.from_numpy(np.asarray(seeds, np.int64)).to(self.device)

    def tx(self, cfg: PhyConfig, payloads: list[bytes], seeds=None,
           group_id: int = 0, partial_aid: int = 0) -> np.ndarray:
        """Batch of equal-config payloads -> (B, nss, n_samples) complex64."""
        arr = torch.from_numpy(_payload_array(payloads, cfg.length))
        cf = tx_batch(cfg, arr.to(self.device),
                      self._seeds(seeds, len(payloads)), group_id, partial_aid)
        return to_numpy(cf)

    def tx_mu(self, mu: MuConfig, payloads: list[list[bytes]],
              bfq: np.ndarray, seeds=None) -> np.ndarray:
        """MU batch: per-user payload lists -> (B, nss_total, n) complex64.

        ``payloads[u]`` holds user u's B equal-length byte strings; ``bfq``
        is the (64, nss, nss) per-subcarrier spatial mapping (the type-10
        wire blob's layout).
        """
        arrs = tuple(
            torch.from_numpy(_payload_array(payloads[u], ucfg.length)
                             ).to(self.device)
            for u, ucfg in enumerate(mu.users))
        cf = tx_batch_mu(mu, arrs, self._seeds(seeds, len(payloads[0])),
                         from_numpy_cf(np.asarray(bfq), self.device))
        return to_numpy(cf)
