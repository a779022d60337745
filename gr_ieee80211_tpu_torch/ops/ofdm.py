"""Batched OFDM demodulation (port of ``gr_ieee80211_tpu.ops.ofdm``).

All functions take (B, ...) :class:`CF` pairs with the packet batch
leading, in the reference's layouts: DFT over (..., 64) windows onto the
fftshifted grid, channel estimation and refinement, equalization, LLR
demap, the deinterleave/deparse gather, descrambling and byte packing,
for up to two receive antennas and two spatial streams (ZF/MRC).
Two stages of a bucket run as one hand-written CUDA kernel each on the
card: the channel estimate (:func:`payload_chanest`, K7) and the
demodulation from the windows to coded-order LLRs
(:func:`payload_demod`, K8); CPU tensors take their plain twins.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..gold.tx import data_pilots
from ..spec import tables as T
from ..spec.params import Fmt, PhyConfig
from ..utils import trace
from .cplx import CF, _dft64_mats, cstack, csum, dft64
from .cuda_lib import launch, on_cuda, require


def _t(a: np.ndarray, device) -> torch.Tensor:
    """A host table on ``device``: one upload from pageable memory, which
    synchronizes."""
    with trace.sync("table_upload"):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@functools.lru_cache(maxsize=None)
def _idx(name: str, device: torch.device) -> torch.Tensor:
    """Tone index tables of ``spec.tables`` as int64 tensors."""
    return _t(getattr(T, name).astype(np.int64), device)


def fft_syms(wins: CF) -> CF:
    """(..., 64) time windows -> fftshifted grids."""
    return dft64(wins)


def extract_sym_windows(xs: CF, start: int, nsym: int) -> CF:
    """xs (B, n) CFO-corrected samples -> (B, nsym, 64) FFT windows for
    symbols whose GIs begin at start + 80*k."""
    B = xs.shape[0]
    s0 = start + T.N_GI
    if xs.shape[1] >= s0 + 80 * nsym:
        span = xs[:, s0: s0 + 80 * nsym]
        return CF(span.re.reshape(B, nsym, 80)[:, :, :64],
                  span.im.reshape(B, nsym, 80)[:, :, :64])
    idx = _t((s0 + 80 * np.arange(nsym)[:, None]
              + np.arange(64)[None, :]).reshape(-1), xs.device)
    return CF(xs.re[:, idx].reshape(B, nsym, 64),
              xs.im[:, idx].reshape(B, nsym, 64))


# real-valued reference grids / masks (numpy host constants)
_LTF_L_REF = T.LTF_L_GRID.real.astype(np.float32)
_LTF_L_NZ = (_LTF_L_REF != 0)
_LTF_L_INV = np.where(_LTF_L_NZ, 1.0 / np.where(_LTF_L_NZ, _LTF_L_REF, 1),
                      0.0).astype(np.float32)
_LTF_NL_REF = T.LTF_NL_GRID.real.astype(np.float32)
_LTF_NL_NZ = (_LTF_NL_REF != 0)
_LTF_NL_INV = np.where(_LTF_NL_NZ, 1.0 / np.where(_LTF_NL_NZ, _LTF_NL_REF, 1),
                       0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ltf_consts(device: torch.device):
    return {k: _t(v, device) for k, v in dict(
        l_nz=_LTF_L_NZ, l_inv=_LTF_L_INV, nl_nz=_LTF_NL_NZ,
        nl_inv=_LTF_NL_INV, l_nzf=_LTF_L_NZ.astype(np.float32),
        nl_nzf=_LTF_NL_NZ.astype(np.float32)).items()}


def _mask_active(h: CF, nz: torch.Tensor) -> CF:
    return CF(torch.where(nz, h.re, torch.ones_like(h.re)),
              torch.where(nz, h.im, torch.zeros_like(h.im)))


def legacy_chanest(xs: CF, ltf_start: int = 0) -> CF:
    """(B, n) -> (B, 64) legacy channel estimate from the two L-LTF repeats."""
    c = _ltf_consts(xs.device)
    l1 = fft_syms(xs[:, ltf_start: ltf_start + 64])
    l2 = fft_syms(xs[:, ltf_start + 64: ltf_start + 128])
    h = (l1 + l2) * (0.5 * c["l_inv"])
    return _mask_active(h, c["l_nz"])


def nl_chanest(xs: CF, ltf_start: int, nltf: int,
               nss: int) -> tuple[CF, CF]:
    """Non-legacy P-matrix channel estimate (the reference's
    ``nrx_axis=True`` layout).

    xs: (B, nrx, n).  Returns (h, pilot_h): h (B, nrx, nss, 64), pilot_h
    (B, nrx, 4) summed-stream R-combined.
    """
    c = _ltf_consts(xs.device)
    pidx = _idx("PILOT_IDX", xs.device)
    grids = []
    for j in range(nltf):
        w = xs[:, :, ltf_start + 80 * j + 16: ltf_start + 80 * j + 80]
        grids.append(fft_syms(w))   # (B, nrx, 64)
    hs = []
    for s in range(nss):
        comb = grids[0] * float(T.P_LTF[s, 0])
        for j in range(1, nltf):
            comb = comb + grids[j] * float(T.P_LTF[s, j])
        h = comb * (c["nl_inv"] / nltf)
        hs.append(_mask_active(h, c["nl_nz"]))
    h = CF(torch.stack([x.re for x in hs], dim=2),
           torch.stack([x.im for x in hs], dim=2))     # (B, nrx, nss, 64)
    pref = _t(_LTF_NL_REF[T.PILOT_IDX], xs.device)
    pcomb = grids[0][:, :, pidx] * float(T.R_LTF[0])
    for j in range(1, nltf):
        pcomb = pcomb + grids[j][:, :, pidx] * float(T.R_LTF[j])
    pilot_h = pcomb * (1.0 / (pref * nltf))
    return h, pilot_h


@functools.lru_cache(maxsize=None)
def _delay_projector(legacy: bool = False):
    """(active idx, P_re, P_im): weighted LS projector onto the <=32-tap
    delay subspace over the 56 non-legacy (52 legacy) active tones
    (taps [-4, 28); weights 6:2 for L-combined vs NL-only tones, uniform 2
    for legacy estimates)."""
    act = np.flatnonzero(_LTF_L_NZ if legacy else _LTF_NL_NZ)
    ks = np.where(act > 32, act - 64, act).astype(np.float64)
    taps = np.arange(-4, 28)
    F = np.exp(-2j * np.pi * ks[:, None] * taps[None, :] / 64)
    wts = (np.full(act.shape, 2.0) if legacy
           else np.where(_LTF_L_NZ[act], 6.0, 2.0))
    P = F @ np.linalg.solve((F.conj().T * wts[None, :]) @ F,
                            F.conj().T * wts[None, :])
    return (act.astype(np.int32), P.real.astype(np.float32),
            P.imag.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _projector_on(legacy: bool, device: torch.device):
    act, p_re, p_im = _delay_projector(legacy)
    return _t(act.astype(np.int64), device), _t(p_re, device), _t(p_im, device)


def _project(hc_re: torch.Tensor, hc_im: torch.Tensor, legacy: bool = False):
    """Replace the active tones of (..., 64) estimates by their delay-
    subspace projection (float32 matmuls; TF32 stays off, the default)."""
    act, p_re, p_im = _projector_on(legacy, hc_re.device)
    a_re, a_im = hc_re[..., act], hc_im[..., act]
    s_re = a_re @ p_re.T - a_im @ p_im.T
    s_im = a_re @ p_im.T + a_im @ p_re.T
    hc_re = hc_re.clone()
    hc_im = hc_im.clone()
    hc_re[..., act] = s_re
    hc_im[..., act] = s_im
    return hc_re, hc_im


_L_TO_NL_GAIN = float(np.sqrt(52.0 / 56.0))
_REFINE_COH = 0.85


def _sign0(v: torch.Tensor) -> torch.Tensor:
    """sign(v) with 0 -> +1 (``jnp.sign(v) + (v == 0)``)."""
    return torch.sign(v) + (v == 0).to(v.dtype)


def refine_chanest_siso(xs: CF, h: CF, pilot_h: CF,
                        fmt: Fmt | None = None,
                        sigb_gi: int | None = None) -> tuple[CF, CF]:
    """1-stream channel-estimate refinement: L-LTF combine, decision-
    directed (Q)BPSK SIG-symbol observations, coherence gates and the
    delay-subspace projection (see the reference's docstring).

    xs: (B, nrx, n) derotated windows (origin = ltf_idx); h: (B, nrx, 1,
    64); pilot_h: (B, nrx, 4).  Returns refined (h, pilot_h)."""
    nrx = xs.shape[1]
    c = _ltf_consts(xs.device)
    nzl, nznl = c["l_nzf"], c["nl_nzf"]
    pidx = _idx("PILOT_IDX", xs.device)
    dmask_np = np.zeros(64, np.float32)
    dmask_np[T.DATA_IDX_L] = 1.0
    dmask = _t(dmask_np, xs.device)

    def gated_obs(obs: CF, ref: CF, nz: torch.Tensor):
        num = csum(ref.mul_conj(obs) * nz[None, :], dim=1)
        e_o = ((obs.re ** 2 + obs.im ** 2) * nz[None, :]).sum(dim=1)
        e_r = ((ref.re ** 2 + ref.im ** 2) * nz[None, :]).sum(dim=1)
        coh = num.abs() / torch.sqrt(torch.clamp(e_o * e_r, min=1e-12))
        corr = num.unit()
        rot = obs * CF(corr.re[:, None], corr.im[:, None])
        return rot, (coh > _REFINE_COH).to(torch.float32)

    out_re, out_im = [], []
    for r in range(nrx):
        h_l = legacy_chanest(xs[:, r], 0) * _L_TO_NL_GAIN
        h_n = h[:, r, 0]
        h_lr, g_l = gated_obs(h_l, h_n, nzl)
        w_l = 2.0 * nzl[None, :] * g_l[:, None]
        num_re = w_l * h_lr.re + h_n.re
        num_im = w_l * h_lr.im + h_n.im
        den = w_l + 1.0
        if fmt is not None:
            qbpsk = ((False, False, True) if fmt == Fmt.VHT
                     else (False, True, True))
            running = CF(num_re / den, num_im / den)
            for gi, qb in zip((128, 208, 288), qbpsk):
                g = fft_syms(xs[:, r, gi + 16: gi + 80])
                eq = g.mul_conj(running)
                if qb:                            # ideal = j*s, s = ±1
                    s = _sign0(eq.im)
                    obs = CF(g.im * s, -g.re * s)
                    m = dmask
                else:                             # ideal = s (pilots too)
                    s = _sign0(eq.re)
                    obs = CF(g.re * s, g.im * s)
                    m = nzl
                o, g_i = gated_obs(obs, running, m)
                w_i = m[None, :] * (g_l * g_i)[:, None]
                num_re = num_re + w_i * o.re
                num_im = num_im + w_i * o.im
                den = den + w_i
            if sigb_gi is not None:               # VHT-SIG-B: NL layout
                running = CF(num_re / den, num_im / den)
                g = fft_syms(xs[:, r, sigb_gi + 16: sigb_gi + 80])
                eq = g.mul_conj(running)
                s = _sign0(eq.re)
                obs = CF(g.re * s, g.im * s)
                o, g_i = gated_obs(obs, running, nznl)
                w_i = nznl[None, :] * g_i[:, None]
                num_re = num_re + w_i * o.re
                num_im = num_im + w_i * o.im
                den = den + w_i
        hc_re, hc_im = _project(num_re / den, num_im / den)
        out_re.append(hc_re)
        out_im.append(hc_im)
    h_re = torch.stack(out_re, dim=1)[:, :, None, :]
    h_im = torch.stack(out_im, dim=1)[:, :, None, :]
    return (CF(h_re, h_im),
            CF(h_re[:, :, 0][..., pidx], h_im[:, :, 0][..., pidx]))


#: the HT/VHT-LTFs' start in a payload window: L-LTF, L-SIG, two SIG
#: symbols and the HT/VHT-STF after the origin (``kNlLtf`` of K7)
NL_LTF_START = 208 + 160 + 80


def payload_chanest_ref(xs: CF, fmt: Fmt, nltf: int, nss: int,
                        sigb_gi: int | None = None) -> tuple[CF, CF]:
    """Plain twin of K7: the payload's channel estimate as eager torch
    operations.  L: one L-LTF estimate an antenna; HT/VHT: the P-matrix
    estimate, refined (:func:`refine_chanest_siso`) for one stream, with
    HT's pilots summed over the streams.

    xs: (B, nrx, n) derotated windows (origin = ltf_idx); ``sigb_gi``: the
    VHT-SIG-B symbol's GI (VHT, one stream).  Returns (h (B, nrx, nss, 64),
    pilot_h (B, nrx, 4))."""
    pidx = _idx("PILOT_IDX", xs.device)
    if fmt == Fmt.L:
        h0 = cstack([legacy_chanest(xs[:, r], 0) for r in range(xs.shape[1])],
                    dim=1)
        return h0[:, :, None, :], h0[:, :, pidx]
    h, pilot_h = nl_chanest(xs, NL_LTF_START, nltf, nss)
    if nss == 1:
        h, pilot_h = refine_chanest_siso(xs, h, pilot_h, fmt=fmt,
                                         sigb_gi=sigb_gi)
    if fmt == Fmt.HT:
        pilot_h = csum(h[:, :, :, pidx], dim=2)
    return h, pilot_h


#: (name in ``csrc/payload_chanest.cu``, floats) of K7's constant table
CHANEST_TABLE = (("kDftC", 4096), ("kDftS", 4096), ("kProjRe", 56 * 56),
                 ("kProjIm", 56 * 56), ("kLInv", 64), ("kNlInv", 64),
                 ("kDataL", 64), ("kActPos", 64), ("kPilot", 4),
                 ("kPLtf", 16), ("kRLtf", 4), ("kPilotRef", 4))


@functools.lru_cache(maxsize=None)
def _chanest_table(device: torch.device) -> torch.Tensor:
    """K7's constants in one float32 tensor on ``device``, built once:
    the twin's DFT matrices and delay projector, the LTF inverses, the
    legacy data mask, each tone's index among the 56 active ones (-1 off
    them), the pilot tones, the P matrix, the R row and the pilots'
    reference (layout ``CHANEST_TABLE``)."""
    c, s = _dft64_mats()
    act, p_re, p_im = _delay_projector(False)
    dmask = np.zeros(64, np.float32)
    dmask[T.DATA_IDX_L] = 1.0
    act_pos = np.full(64, -1.0, np.float32)
    act_pos[act] = np.arange(act.size)
    parts = (c, s, p_re, p_im, _LTF_L_INV, _LTF_NL_INV, dmask, act_pos,
             T.PILOT_IDX, T.P_LTF, T.R_LTF, _LTF_NL_REF[T.PILOT_IDX])
    assert [np.size(a) for a in parts] == [n for _, n in CHANEST_TABLE]
    tab = np.concatenate([np.ravel(a).astype(np.float32) for a in parts])
    with trace.sync("table_upload"):
        return torch.from_numpy(tab).to(device)


def payload_chanest(xs: CF, fmt: Fmt, nltf: int, nss: int,
                    sigb_gi: int | None = None) -> tuple[CF, CF]:
    """The payload's channel estimate of a bucket in one launch of K7
    (``csrc/payload_chanest.cu``): what :func:`payload_chanest_ref`
    computes, for every row and antenna.

    xs: (B, nrx, n) float32 derotated windows; fmt, nltf, nss: the bucket's
    config (nss 1 or 2); ``sigb_gi``: the VHT-SIG-B symbol's GI, used by
    the one-stream refinement.  Returns (h (B, nrx, nss, 64), pilot_h (B,
    nrx, 4)).  CPU tensors take the twin; CUDA tensors launch the kernel
    or raise."""
    require(xs.re.ndim == 3 and xs.im.shape == xs.re.shape,
            f"payload_chanest takes (B, nrx, n) windows, got "
            f"{tuple(xs.re.shape)} / {tuple(xs.im.shape)}")
    require(xs.re.dtype == torch.float32 and xs.im.dtype == torch.float32,
            "payload_chanest takes float32 windows")
    require(nss in (1, 2) and (fmt == Fmt.L and nss == 1
                               or fmt != Fmt.L and nss <= nltf <= 2),
            f"payload_chanest: no estimate for {fmt!r} with nltf={nltf}, "
            f"nss={nss}")
    if not on_cuda(xs.re, xs.im):
        return payload_chanest_ref(xs, fmt, nltf, nss, sigb_gi)
    return _chanest_kernel(xs, fmt, nltf, nss, sigb_gi,
                           refine=fmt != Fmt.L and nss == 1)


def _chanest_kernel(xs: CF, fmt: Fmt, nltf: int, nss: int,
                    sigb_gi: int | None, refine: bool) -> tuple[CF, CF]:
    """Launch K7 on CUDA windows; ``refine`` runs the one-stream refinement
    (``payload_chanest`` sets it for HT/VHT with one stream; without it a
    one-stream bucket gets the P-matrix estimate alone)."""
    require(xs.re.is_contiguous() and xs.im.is_contiguous(),
            "payload_chanest takes contiguous windows")
    B, nrx, n = xs.re.shape
    legacy = fmt == Fmt.L
    need = 128 if legacy else NL_LTF_START + 80 * nltf
    sigb = sigb_gi if refine and sigb_gi is not None else -1
    require(n >= max(need, sigb + 80),
            f"payload_chanest: windows of {n} samples end before the "
            f"training and SIG symbols it reads")
    dev = xs.re.device
    shape_h, shape_p = (B, nrx, 1 if legacy else nss, 64), (B, nrx, 4)
    h = CF(torch.empty(shape_h, dtype=torch.float32, device=dev),
           torch.empty(shape_h, dtype=torch.float32, device=dev))
    pilot_h = CF(torch.empty(shape_p, dtype=torch.float32, device=dev),
                 torch.empty(shape_p, dtype=torch.float32, device=dev))
    if B == 0 or nrx == 0:
        return h, pilot_h
    launch("gr80211_payload_chanest", dev, xs.re.data_ptr(),
           xs.im.data_ptr(), _chanest_table(dev).data_ptr(), h.re.data_ptr(),
           h.im.data_ptr(), pilot_h.re.data_ptr(), pilot_h.im.data_ptr(), n,
           B, nrx, int(fmt), 0 if legacy else nltf, nss, int(refine), sigb,
           _L_TO_NL_GAIN, _REFINE_COH, shape=(B, nrx, int(fmt), nss))
    return h, pilot_h


@functools.lru_cache(maxsize=None)
def _pilot_matrix(fmt: Fmt, nss: int, nsym: int) -> np.ndarray:
    return data_pilots(fmt, nss, nsym).astype(np.float32)  # (nsym, nss, 4)


_DD_COH = 0.80


def refine_chanest_data(grids: CF, h: CF, pilot_h: CF,
                        cfg: PhyConfig) -> tuple[CF, CF]:
    """Decision-directed DATA-symbol second-pass channel refinement (1 SS):
    hard-sliced QAM decisions and the known pilot polarities turn every
    payload symbol into a channel observation, combined with the prior
    under its nominal observation count, coherence-gated per (row, rx) and
    re-projected onto the delay subspace.

    grids: (B, nrx, nsym, 64) FFT'd symbol grids (pre phase-correction);
    h: (B, nrx, 1, 64); pilot_h: (B, nrx, 4).  Returns refined (h, pilot_h).
    """
    assert cfg.nss == 1
    dev = grids.device
    legacy = cfg.fmt == Fmt.L
    B, nrx, nsym, _ = grids.shape
    didx = _idx("DATA_IDX_L" if legacy else "DATA_IDX_NL", dev)
    pidx = _idx("PILOT_IDX", dev)
    pilots = _t(_pilot_matrix(cfg.fmt, 1, nsym)[:, 0], dev)   # (nsym, 4)

    exp_p = CF(pilot_h.re[:, :, None, :] * pilots[None, None],
               pilot_h.im[:, :, None, :] * pilots[None, None])
    rx_p = grids[:, :, :, pidx]                           # (B,nrx,nsym,4)
    ph = csum(rx_p.mul_conj(exp_p), dim=(1, 3)).unit()    # (B, nsym)

    phc = CF(ph.re[:, None, :, None], -ph.im[:, None, :, None])
    y = CF(grids.re[:, :, :, didx], grids.im[:, :, :, didx]) * phc
    hd = CF(h.re[:, :, 0][:, :, didx], h.im[:, :, 0][:, :, didx])
    g00 = hd.abs2().sum(dim=1)                            # (B, nsd)
    r0 = csum(hd.conj().reshape(B, nrx, 1, -1) * y, dim=1)
    eq = r0 * (1.0 / torch.clamp(g00, min=1e-20))[:, None, :]
    k = float(T.KMOD[cfg.nbpscs])
    if cfg.nbpscs == 1:
        s = CF(_sign0(eq.re), torch.zeros_like(eq.re))
    else:
        lev = 1 << (cfg.nbpscs // 2)

        def _slice_axis(v):
            q = torch.clamp(torch.round((v * k - 1.0) * 0.5),
                            -(lev // 2), lev // 2 - 1)
            return (2.0 * q + 1.0) * (1.0 / k)

        s = CF(_slice_axis(eq.re), _slice_axis(eq.im))
    es = s.abs2().sum(dim=1)                              # (B, nsd)
    prod = y * CF(s.re[:, None], -s.im[:, None])
    num = CF(prod.re.sum(dim=2), prod.im.sum(dim=2))
    num_p = csum(rx_p * CF(ph.re[:, None, :, None] * pilots[None, None],
                           -ph.im[:, None, :, None] * pilots[None, None]),
                 dim=2)                                   # (B, nrx, 4)

    hd_dd = num * (1.0 / torch.clamp(es, min=1e-12))[:, None, :]
    cg = csum(hd_dd.mul_conj(hd), dim=2)                  # (B, nrx)
    e_p = hd.abs2().sum(dim=2)
    e_d = hd_dd.abs2().sum(dim=2)
    gate = (cg.abs() / torch.sqrt(torch.clamp(e_p * e_d, min=1e-20))
            > _DD_COH).to(torch.float32)                  # (B, nrx)

    if legacy:
        w0_np = np.where(_LTF_L_NZ, 2.0, 1.0)
    else:
        w0_np = np.where(_LTF_NL_NZ, np.where(_LTF_L_NZ, 6.0, 2.0), 1.0)
    w0 = _t(w0_np.astype(np.float32), dev)
    den64 = torch.zeros((B, 1, 64), dtype=torch.float32, device=dev)
    den64[:, :, didx] += es[:, None]
    den64[:, :, pidx] += float(nsym)
    n_re = torch.zeros((B, nrx, 64), dtype=torch.float32, device=dev)
    n_im = torch.zeros((B, nrx, 64), dtype=torch.float32, device=dev)
    n_re[:, :, didx] += num.re
    n_re[:, :, pidx] += num_p.re
    n_im[:, :, didx] += num.im
    n_im[:, :, pidx] += num_p.im
    g = gate[:, :, None]
    hc_re = (w0 * h.re[:, :, 0] + g * n_re) / (w0 + g * den64)
    hc_im = (w0 * h.im[:, :, 0] + g * n_im) / (w0 + g * den64)
    hc_re, hc_im = _project(hc_re, hc_im, legacy)
    return (CF(hc_re[:, :, None, :], hc_im[:, :, None, :]),
            CF(hc_re[..., pidx], hc_im[..., pidx]))


def equalize_and_demap(grids: CF, h: CF, pilot_h: CF,
                       cfg: PhyConfig) -> torch.Tensor:
    """Per-symbol pilot phase correction + (ZF/MRC) equalization + LLR
    demap (the reference's ``nrx_axis=True`` layout), nrx <= 2, nss <= 2.

    grids: (B, nrx, nsym, 64); h: (B, nrx, nss, 64); pilot_h (B, nrx, 4).
    Returns interleaved LLRs (B, nss, nsym*ncbpss) float32."""
    B, nrx, nsym, _ = grids.shape
    dev = grids.device
    legacy = cfg.fmt == Fmt.L
    didx = _idx("DATA_IDX_L" if legacy else "DATA_IDX_NL", dev)
    pidx = _idx("PILOT_IDX", dev)
    pilots = _t(_pilot_matrix(cfg.fmt, cfg.nss, cfg.nsym), dev)  # (nsym,nss,4)
    if cfg.fmt == Fmt.HT and cfg.nss == 2:
        # HT 2-SS: the expected pilot is each stream's pilot channel times
        # its own polarity, summed over the streams
        hp = h[:, :, :, pidx]                                # (B,nrx,nss,4)
        pt = pilots.permute(1, 0, 2)[None, None]             # (1,1,nss,nsym,4)
        exp_p = CF((hp.re[:, :, :, None, :] * pt).sum(dim=2),
                   (hp.im[:, :, :, None, :] * pt).sum(dim=2))
    else:
        p0 = pilots[:, 0]                                    # (nsym, 4)
        exp_p = CF(pilot_h.re[:, :, None, :] * p0[None, None],
                   pilot_h.im[:, :, None, :] * p0[None, None])
    rx_p = grids[:, :, :, pidx]                              # (B,nrx,nsym,4)
    ph = csum(rx_p.mul_conj(exp_p), dim=(1, 3)).unit()       # (B, nsym)
    grids = grids * CF(ph.re[:, None, :, None], -ph.im[:, None, :, None])
    y = grids[:, :, :, didx]                                 # (B,nrx,nsym,nsd)
    hd = h[:, :, :, didx]                                    # (B,nrx,nss,nsd)
    if cfg.nss == 1 and nrx == 1:
        eq = (y[:, 0] / hd[:, 0, 0][:, None, :])[:, None]    # (B,1,nsym,nsd)
    elif cfg.nss == 1:
        # MRC through the normal equations; the Gram matrix is real
        h0 = hd[:, :, 0]
        g00 = h0.abs2().sum(dim=1)                           # (B, nsd)
        r0 = csum(h0.conj().reshape(B, nrx, 1, -1) * y, dim=1)
        eq = (r0 * (1.0 / torch.clamp(g00, min=1e-20))[:, None, :])[:, None]
    else:
        eq = zf_equalize(y, hd)
    llr = llr_demap(eq, cfg.nbpscs)                          # (B,nss,nsym,ncbpss)
    return llr.reshape(B, cfg.nss, -1)


def zf_equalize(y: CF, hd: CF) -> CF:
    """Two-stream ZF through the normal equations: the Gram matrix G =
    H^H H, its determinant and the explicit 2 x 2 inverse at each data
    subcarrier, applied to the matched-filter outputs H^H y.

    y: (B, nrx, nsym, nsd) pilot-phase-corrected data tones; hd: (B, nrx,
    2, nsd) the channel there.  Returns the equalized streams (B, 2, nsym,
    nsd).  Span ``rx.payload.zf``."""
    with trace.span("rx.payload.zf"):
        B, nrx = hd.shape[:2]
        h0 = hd[:, :, 0]
        g00 = h0.abs2().sum(dim=1)                           # (B, nsd)
        r0 = csum(h0.conj().reshape(B, nrx, 1, -1) * y, dim=1)
        # for two streams the Gram diagonal is real
        h1 = hd[:, :, 1]
        g11 = h1.abs2().sum(dim=1)
        g01 = csum(h0.conj().reshape(B, nrx, -1) * h1, dim=1)  # (B, nsd)
        r1 = csum(h1.conj().reshape(B, nrx, 1, -1) * y, dim=1)
        det = g00 * g11 - g01.abs2()                         # real (B, nsd)
        inv = 1.0 / torch.where(det.abs() > 1e-20, det,
                                torch.full_like(det, 1e-20))
        e0 = r0 * g11[:, None, :] - r1 * CF(g01.re[:, None, :],
                                            g01.im[:, None, :])
        e1 = r1 * g00[:, None, :] - r0 * CF(g01.re[:, None, :],
                                            -g01.im[:, None, :])
        return CF(torch.stack([e0.re, e1.re], dim=1) * inv[:, None, None, :],
                  torch.stack([e0.im, e1.im], dim=1) * inv[:, None, None, :])


def llr_demap(eq: CF, nbpscs: int) -> torch.Tensor:
    """(..., nsd) equalized QAM -> (..., nsd*nbpscs) piecewise-linear LLRs."""
    k = float(T.KMOD[nbpscs])
    zr, zi = eq.re * k, eq.im * k
    if nbpscs == 1:
        return zr.to(torch.float32)
    half = nbpscs // 2
    outs = []
    for v in (zr, zi):
        cur = v
        axis_llrs = [cur]
        for b in range(1, half):
            cur = (1 << (half - b)) - torch.abs(cur)
            axis_llrs.append(cur)
        outs.append(torch.stack(axis_llrs, dim=-1))
    out = torch.cat(outs, dim=-1)          # (..., nsd, nbpscs)
    return out.reshape(*zr.shape[:-1], -1).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _deint_deparse_perm(fmt: Fmt, nbpscs: int, nss: int,
                        nsym: int) -> np.ndarray:
    """Combined gather: interleaved per-stream LLRs (nss, nsym*ncbpss)
    flattened -> coded-stream order (nsym*ncbps,)."""
    legacy = fmt == Fmt.L
    nsd = 48 if legacy else 52
    ncbpss = nsd * nbpscs
    ncbps = ncbpss * nss
    perms = [T.interleave_perm_legacy(nbpscs) if legacy
             else T.interleave_perm_nl(nbpscs, iss, nss) for iss in range(nss)]
    out = np.empty(nsym * ncbps, dtype=np.int64)
    sp = T.stream_parser_perm(nbpscs, nss, 1, ncbpss)  # (nss, ncbpss)
    for sym in range(nsym):
        base = sym * ncbps
        for iss in range(nss):
            coded_pos = base + sp[iss]
            flat = iss * (nsym * ncbpss) + sym * ncbpss + perms[iss]
            out[coded_pos] = flat
    return out


@functools.lru_cache(maxsize=None)
def _perm_on(fmt: Fmt, nbpscs: int, nss: int, nsym: int,
             device: torch.device) -> torch.Tensor:
    return _t(_deint_deparse_perm(fmt, nbpscs, nss, nsym), device)


def deinterleave_deparse(llr: torch.Tensor, cfg: PhyConfig) -> torch.Tensor:
    """(B, nss, nsym*ncbpss) interleaved LLRs -> (B, nsym*ncbps) coded order."""
    perm = _perm_on(cfg.fmt, cfg.nbpscs, cfg.nss, cfg.nsym, llr.device)
    return llr.reshape(llr.shape[0], -1)[:, perm]


def payload_grids(xs: CF, data_start: int, nsym: int) -> CF:
    """(B, nrx, n) derotated windows -> (B, nrx, nsym, 64) grids of the
    data symbols whose GIs begin at data_start + 80*k."""
    return fft_syms(cstack([extract_sym_windows(xs[:, r], data_start, nsym)
                            for r in range(xs.shape[1])], dim=1))


def payload_demod_ref(xs: CF, data_start: int, h: CF, pilot_h: CF,
                      cfg: PhyConfig) -> torch.Tensor:
    """Plain twin of K8: the payload's demodulation as eager torch
    operations, the symbol DFTs (:func:`payload_grids`), then
    :func:`equalize_and_demap` and :func:`deinterleave_deparse`.  Returns
    coded-order LLRs (B, nsym*ncbps) float32."""
    llr = equalize_and_demap(payload_grids(xs, data_start, cfg.nsym), h,
                             pilot_h, cfg)
    return deinterleave_deparse(llr, cfg)


#: (name in ``csrc/payload_demod.cu``, floats) of the head of K8's constant
#: table; the pilot and permutation parts follow (:func:`_demod_parts`)
DEMOD_HEAD = (("kDftC", 4096), ("kDftS", 4096), ("kDataPosL", 64),
              ("kDataPosNl", 64), ("kPilotIdx", 4))
#: the data pilots repeat every 4 symbols (rotation) x 127 (polarity)
PILOT_PERIOD = 508
_PILOT_CFGS = ((Fmt.L, 1), (Fmt.HT, 1), (Fmt.HT, 2), (Fmt.VHT, 1),
               (Fmt.VHT, 2))
_PERM_CFGS = tuple([(True, m, 1) for m in (1, 2, 4, 6)]
                   + [(False, m, s) for s in (1, 2) for m in (1, 2, 4, 6, 8)])


@functools.lru_cache(maxsize=None)
def _demod_parts() -> tuple[np.ndarray, dict]:
    """K8's constants as one float32 host array, and where its parts start:
    the head (``DEMOD_HEAD``: the twin's DFT matrices, each tone's index
    among the data tones (-1 off them), the pilot tones); per (fmt, nss),
    ``("pilots", fmt, nss)``: ``gold/tx.data_pilots`` over one period,
    (508, rows, 4), two rows for HT with two streams (each stream's own
    polarities), else the first; per (legacy, nbpscs, nss), ``("perm",
    legacy, nbpscs, nss)``: the coded position within a symbol of each
    stream's interleaved LLR, (nss, ncbpss): the inverse of one symbol of
    :func:`_deint_deparse_perm`."""
    c, s = _dft64_mats()
    pos_l = np.full(64, -1.0)
    pos_l[T.DATA_IDX_L] = np.arange(T.DATA_IDX_L.size)
    pos_nl = np.full(64, -1.0)
    pos_nl[T.DATA_IDX_NL] = np.arange(T.DATA_IDX_NL.size)
    parts = [c, s, pos_l, pos_nl, T.PILOT_IDX]
    assert [np.size(a) for a in parts] == [n for _, n in DEMOD_HEAD]
    at, off = {}, sum(n for _, n in DEMOD_HEAD)
    for fmt, nss in _PILOT_CFGS:
        pil = data_pilots(fmt, nss, 2 * PILOT_PERIOD)
        assert np.array_equal(pil[:PILOT_PERIOD], pil[PILOT_PERIOD:])
        rows = 2 if fmt == Fmt.HT and nss == 2 else 1
        parts.append(pil[:PILOT_PERIOD, :rows])
        at["pilots", fmt, nss], off = off, off + parts[-1].size
    for legacy, nbpscs, nss in _PERM_CFGS:
        perm = _deint_deparse_perm(Fmt.L if legacy else Fmt.HT, nbpscs, nss, 1)
        parts.append(np.argsort(perm))
        at["perm", legacy, nbpscs, nss], off = off, off + perm.size
    tab = np.concatenate([np.ravel(a).astype(np.float32) for a in parts])
    return tab, at


@functools.lru_cache(maxsize=None)
def _demod_table(device: torch.device) -> torch.Tensor:
    """K8's constants (:func:`_demod_parts`) on ``device``, uploaded once."""
    with trace.sync("table_upload"):
        return torch.from_numpy(_demod_parts()[0]).to(device)


def payload_demod(xs: CF, data_start: int, h: CF, pilot_h: CF,
                  cfg: PhyConfig) -> torch.Tensor:
    """The payload's demodulation of a bucket in one launch of K8
    (``csrc/payload_demod.cu``): what :func:`payload_demod_ref` computes,
    the data symbols' DFTs, pilot phase, equalizer (SISO division, MRC or
    two-stream ZF), LLR demap and deinterleave / deparse, for every row.

    xs: (B, nrx, n) float32 derotated windows (origin = ltf_idx), nrx 1 or
    2; data_start: the first data symbol's GI; h: (B, nrx, nss, 64) and
    pilot_h: (B, nrx, 4) float32, the estimate to equalize with; cfg: the
    bucket's config (nss 1 or 2; ``cfg.nsym`` symbols).  Returns coded-order
    LLRs (B, nsym*ncbps) float32.  CPU tensors take the twin; CUDA tensors
    launch the kernel or raise."""
    require(xs.re.ndim == 3 and xs.im.shape == xs.re.shape,
            f"payload_demod takes (B, nrx, n) windows, got "
            f"{tuple(xs.re.shape)} / {tuple(xs.im.shape)}")
    B, nrx, n = xs.re.shape
    require(nrx in (1, 2) and cfg.nss in (1, 2),
            f"payload_demod: no equalizer for nrx={nrx}, nss={cfg.nss}")
    require(h.re.shape == h.im.shape == (B, nrx, cfg.nss, 64)
            and pilot_h.re.shape == pilot_h.im.shape == (B, nrx, 4),
            f"payload_demod: estimates {tuple(h.re.shape)} / "
            f"{tuple(pilot_h.re.shape)} do not fit windows {(B, nrx, n)} "
            f"and nss={cfg.nss}")
    require(all(t.dtype == torch.float32 for t in (*xs, *h, *pilot_h)),
            "payload_demod takes float32 windows and estimates")
    require(0 <= data_start and data_start + 80 * cfg.nsym <= n,
            f"payload_demod: windows of {n} samples end before the "
            f"{cfg.nsym} data symbols from {data_start}")
    if not on_cuda(*xs, *h, *pilot_h):
        return payload_demod_ref(xs, data_start, h, pilot_h, cfg)
    return _demod_kernel(xs, data_start, h, pilot_h, cfg)


def _demod_kernel(xs: CF, data_start: int, h: CF, pilot_h: CF,
                  cfg: PhyConfig) -> torch.Tensor:
    """Launch K8 on CUDA windows; the estimates are made contiguous (the
    MU path equalizes with a slice of its streams)."""
    require(xs.re.is_contiguous() and xs.im.is_contiguous(),
            "payload_demod takes contiguous windows")
    B, nrx, n = xs.re.shape
    dev = xs.re.device
    out = torch.empty((B, cfg.nsym * cfg.ncbps), dtype=torch.float32,
                      device=dev)
    if B == 0 or cfg.nsym == 0:
        return out
    h = CF(h.re.contiguous(), h.im.contiguous())
    pilot_h = CF(pilot_h.re.contiguous(), pilot_h.im.contiguous())
    at = _demod_parts()[1]
    launch("gr80211_payload_demod", dev, xs.re.data_ptr(), xs.im.data_ptr(),
           h.re.data_ptr(), h.im.data_ptr(), pilot_h.re.data_ptr(),
           pilot_h.im.data_ptr(), _demod_table(dev).data_ptr(),
           out.data_ptr(), n, B, nrx, cfg.nss, int(cfg.fmt), cfg.nbpscs,
           cfg.nsym, data_start, at["pilots", cfg.fmt, cfg.nss],
           at["perm", cfg.fmt == Fmt.L, cfg.nbpscs, cfg.nss],
           float(T.KMOD[cfg.nbpscs]), shape=(B, nrx, cfg.nss, cfg.nsym))
    return out


@functools.lru_cache(maxsize=None)
def _descramble_tables():
    seq127 = T.scramble_seq(0x7F, 127)
    off = np.zeros(128, dtype=np.int32)
    ext = np.concatenate([seq127, seq127[:7]])
    for o in range(127):
        w = 0
        for i in range(7):
            w |= int(ext[o + i]) << i
        off[w] = o
    return seq127, off


@functools.lru_cache(maxsize=None)
def _descramble_matrix(n: int) -> np.ndarray:
    """(127, n) float32: row o = the 127-periodic scramble sequence shifted
    by offset o."""
    seq127, _ = _descramble_tables()
    idx = (np.arange(127)[:, None] + np.arange(n)[None, :]) % 127
    return seq127[idx].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _descramble_on(n: int, device: torch.device):
    _, off = _descramble_tables()
    return (_t(off.astype(np.int64), device),
            _t(_descramble_matrix(n).astype(np.uint8), device))


def descramble_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 scrambled bits -> descrambled (first 7 bits zeroed).

    The packet's scrambler offset comes from its first 7 bits (the zero
    SERVICE bits carry the raw sequence); its shifted sequence is a
    direct row gather of :func:`_descramble_matrix`."""
    B, n = bits.shape
    off_tab, mat = _descramble_on(n, bits.device)
    with trace.sync("const_upload"):
        pw = torch.tensor([1 << i for i in range(7)], device=bits.device)
    w = (bits[:, :7].to(torch.int64) * pw).sum(dim=1)
    out = bits ^ mat[off_tab[w]].to(bits.dtype)
    out[:, :7] = 0
    return out


def bits_to_bytes_batch(bits: torch.Tensor) -> torch.Tensor:
    """(B, 8*n) bits -> (B, n) uint8, LSB-first per byte."""
    B, nb = bits.shape
    with trace.sync("const_upload"):
        pw = torch.tensor([1 << i for i in range(8)], device=bits.device)
    return (bits.reshape(B, nb // 8, 8).to(torch.int64) * pw
            ).sum(dim=-1).to(torch.uint8)
