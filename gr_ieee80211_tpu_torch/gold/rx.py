"""Gold-model receiver: full 802.11a/n/ac 20 MHz RX chain in clear numpy.

Covers the behavior of the reference RX blocks (trigger/sync/signal/demod/
decode, ``lib/{trigger,sync,signal,demod,demod2,decode}_impl
.cc``) and the PY-TB offline receiver (``tools/phy80211.py:919-1016``):

* STF plateau trigger + coarse CFO, L-LTF sync + fine CFO, SNR estimate
* legacy channel estimate, L-SIG decode, HT-SIG vs VHT-SIG-A dual hypothesis
* non-legacy (P-matrix) channel estimation: SISO, 2x2 SU-MIMO, per-user
  MU-MIMO combining, VHT NDP channel export
* per-symbol equalization + pilot residual-phase tracking, soft LLR demap,
  (stream deparse +) deinterleave, depuncture, soft Viterbi, descramble,
  FCS / A-MPDU deaggregation

This is the oracle the batched engine (models/rx.py) is tested against,
and the direct analog of the reference's "PY-TB validates GR-TRX" strategy.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from ..spec import tables as T
from ..spec.params import Fmt, PhyConfig
from . import bits as B
from . import sig as S
from . import mac as MAC

# Timing convention: ``ltf_idx`` from ltf_sync lands ~6 samples inside GI2
# (mid-shoulder + 10).  All later FFT windows are taken at nominal offsets
# relative to ltf_idx, so every window shares the same small early shift and
# it cancels inside the channel estimate (the reference achieves the same
# robustness with C8P_SYM_SAMP_SHIFT=8, lib/cloud80211phy.h:33).


# ---------------------------------------------------------------------------
# Front end: correlators, trigger, sync
# ---------------------------------------------------------------------------

def _movsum(x: np.ndarray, w: int) -> np.ndarray:
    c = np.cumsum(np.concatenate([[0], x]))
    return c[w:] - c[:-w]


def stf_metric(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(plateau metric m[n], lag-16 autocorr c[n]) for the STF detector."""
    prod = x[:-16] * np.conj(x[16:])
    c = _movsum(prod, 48)
    p = _movsum(np.abs(x) ** 2, 64)
    n = min(len(c), len(p))
    m = np.abs(c[:n]) / np.maximum(p[:n], 1e-12)
    return m, c[:n]


def find_triggers(m: np.ndarray, thresh: float = 0.3, run: int = 20) -> list[int]:
    """Start indices of plateaus of at least ``run`` samples above thresh."""
    above = m > thresh
    out = []
    i, n = 0, len(above)
    while i < n:
        if above[i]:
            j = i
            while j < n and above[j]:
                j += 1
            if j - i >= run:
                out.append(i)
                i = j + 400  # skip the rest of this burst's preamble
            else:
                i = j + 1    # short blip: keep scanning
        else:
            i += 1
    return out


def ltf_sync(x: np.ndarray, start: int):
    """Search [start, start+240) for the L-LTF; returns (ltf_index, peak) or None.

    Sliding 64-lag normalized autocorrelation; timing = midpoint of the 80%
    shoulders of the peak plateau (the reference's robust-GI-center rule),
    plus a +10 safety offset into GI2.
    """
    w = x[start: start + 240 + 128]
    if len(w) < 240:
        return None
    npts = len(w) - 128
    seg = np.lib.stride_tricks.sliding_window_view(w, 64)
    a = (seg[:npts] * np.conj(seg[64: 64 + npts])).sum(axis=1)
    pw = (np.abs(seg) ** 2).sum(axis=1)
    ac = np.abs(a) / np.maximum(np.sqrt(pw[:npts] * pw[64: 64 + npts]), 1e-12)
    k = int(np.argmax(ac))
    peak = ac[k]
    if peak < 0.5:
        return None
    lo = k
    for i in range(k, max(k - 32, 0) - 1, -1):
        if abs(ac[i] - 0.8 * peak) < abs(ac[lo] - 0.8 * peak):
            lo = i
    hi = k
    for i in range(k, min(k + 32, npts - 1) + 1):
        if abs(ac[i] - 0.8 * peak) < abs(ac[hi] - 0.8 * peak):
            hi = i
    mid = (lo + hi) // 2
    return start + mid + 10, float(peak)


def coarse_cfo(x: np.ndarray, start: int, n: int = 64) -> float:
    """CFO (Hz) from lag-16 STF autocorrelation."""
    prod = (x[start: start + n] * np.conj(x[start + 16: start + 16 + n])).mean()
    return -np.angle(prod) / 16 / (2 * np.pi) * 20e6


def fine_cfo(x: np.ndarray, ltf_idx: int, cfo0: float) -> float:
    """Refine with the lag-64 L-LTF autocorrelation after derotating cfo0."""
    n = np.arange(128)
    w = x[ltf_idx: ltf_idx + 128] * np.exp(-1j * 2 * np.pi * cfo0 / 20e6 * n)
    prod = (w[:64] * np.conj(w[64:128])).mean()
    return cfo0 - np.angle(prod) / 64 / (2 * np.pi) * 20e6


def derotate(x: np.ndarray, start: int, n: int, cfo_hz: float) -> np.ndarray:
    t = np.arange(n)
    return x[start: start + n] * np.exp(-1j * 2 * np.pi * cfo_hz / 20e6 * t)


# ---------------------------------------------------------------------------
# OFDM demod helpers
# ---------------------------------------------------------------------------

def fft_sym(w64: np.ndarray) -> np.ndarray:
    """64 time samples -> fftshifted 64-bin grid (k = i - 32)."""
    return np.fft.fftshift(np.fft.fft(w64, axis=-1), axes=-1)


def sym_window(x: np.ndarray, sym_start: int) -> np.ndarray:
    """64-bin grid of the symbol whose GI nominally begins at ``sym_start``
    (offsets relative to ltf_idx; see timing convention above)."""
    return fft_sym(x[sym_start + T.N_GI: sym_start + T.N_GI + 64])


def legacy_chan_est(x: np.ndarray, ltf_idx: int) -> np.ndarray:
    """64-bin legacy channel estimate from the two L-LTF repeats."""
    l1 = fft_sym(x[ltf_idx: ltf_idx + 64])
    l2 = fft_sym(x[ltf_idx + 64: ltf_idx + 128])
    ref = T.LTF_L_GRID
    h = np.ones(64, dtype=np.complex128)
    nz = ref != 0
    h[nz] = (l1[nz] + l2[nz]) / ref[nz] / 2.0
    return h


def llr_demap(eq: np.ndarray, nbpscs: int) -> np.ndarray:
    """Per-subcarrier equalized QAM -> nbpscs soft LLRs (reference piecewise
    forms, ``lib/cloud80211phy.cc:2090-2148``)."""
    z = eq * T.KMOD[nbpscs]
    if nbpscs == 1:
        return z.real[..., None].reshape(*eq.shape[:-1], -1)
    half = nbpscs // 2
    out = np.empty(eq.shape + (nbpscs,), dtype=np.float64)
    for axis, v in ((0, z.real), (1, z.imag)):
        cur = v
        out[..., axis * half] = cur
        for b in range(1, half):
            cur = (1 << (half - b)) - np.abs(cur)
            out[..., axis * half + b] = cur
    return out.reshape(*eq.shape[:-1], -1)


def pilot_phase(eq_pilots: np.ndarray, expected: np.ndarray) -> complex:
    """Unit phasor correcting residual CFO phase from the 4 pilot tones."""
    s = np.sum(eq_pilots * np.conj(expected))
    a = np.abs(s)
    return s / a if a > 1e-12 else 1.0


# ---------------------------------------------------------------------------
# Non-legacy channel estimation
# ---------------------------------------------------------------------------

def nl_chan_est(ltf_grids: np.ndarray, nss: int, fmt: Fmt) -> np.ndarray:
    """P-matrix channel estimate.

    ltf_grids: (nltf, nrx, 64) FFT grids of the non-legacy LTF symbols.
    Returns H (nrx, nss, 64); at VHT pilot tones the per-stream estimate is
    invalid (R-row), callers use `nl_pilot_chan` there.
    """
    nltf = ltf_grids.shape[0]
    ref = T.LTF_NL_GRID
    nz = ref != 0
    h = np.zeros((ltf_grids.shape[1], nss, 64), dtype=np.complex128)
    for s in range(nss):
        comb = np.zeros_like(ltf_grids[0])
        for j in range(nltf):
            comb += ltf_grids[j] * T.P_LTF[s, j]
        h[:, s, nz] = comb[:, nz] / ref[nz] / nltf
        h[:, s, ~nz] = 1.0
    return h


def nl_pilot_chan(ltf_grids: np.ndarray) -> np.ndarray:
    """Summed-stream channel at the 4 pilot tones from the R-row combining
    (VHT LTF pilot tones are sent identically, R-weighted, on all streams).

    Returns (nrx, 4)."""
    nltf = ltf_grids.shape[0]
    ref = T.LTF_NL_GRID[T.PILOT_IDX]
    comb = np.zeros((ltf_grids.shape[1], 4), dtype=np.complex128)
    for j in range(nltf):
        comb += ltf_grids[j][:, T.PILOT_IDX] * T.R_LTF[j]
    return comb / ref / nltf


def zf_equalize(y: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Zero-forcing: y (nrx, nsc), h (nrx, nss, nsc) -> (nss, nsc)."""
    nrx, nss, nsc = h.shape
    if nrx == 1 and nss == 1:
        return (y / h[0])[0][None]
    hh = h.transpose(2, 0, 1)                      # (nsc, nrx, nss)
    yv = y.T[..., None]                            # (nsc, nrx, 1)
    gram = np.conj(hh.transpose(0, 2, 1)) @ hh     # (nsc, nss, nss)
    rhs = np.conj(hh.transpose(0, 2, 1)) @ yv      # (nsc, nss, 1)
    out = np.linalg.solve(gram, rhs)[..., 0]       # (nsc, nss)
    return out.T


# ---------------------------------------------------------------------------
# Packet results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RxPacket:
    ok: bool
    fmt: Fmt | None = None
    mcs: int = 0
    nss: int = 1
    length: int = 0
    psdu: bytes = b""
    mpdus: list = dataclasses.field(default_factory=list)
    start: int = 0
    cfo_hz: float = 0.0
    snr_db: float = 0.0
    rssi: float = 0.0    #: mean windowed power at sync (reference rssi tag)
    ampdu: bool = False
    is_ndp: bool = False
    ndp_chan: np.ndarray | None = None     # (nrx, nsts, 64) for NDP sounding
    ndp_ltf_grids: np.ndarray | None = None  # raw (nltf, nrx, 64)
    sigb_len: int = 0
    mu: bool = False


# ---------------------------------------------------------------------------
# Payload decoding helpers
# ---------------------------------------------------------------------------

def _decode_payload(cfg: PhyConfig, llr_stream: np.ndarray) -> np.ndarray:
    """Per-stream interleaved LLRs -> descrambled data bits.

    llr_stream: (nss, nsym*ncbpss) in interleaved order.
    """
    des = []
    for iss in range(cfg.nss):
        des.append(B.deinterleave(llr_stream[iss], cfg.nbpscs,
                                  cfg.fmt == Fmt.L, iss, cfg.nss))
    if cfg.nss == 1:
        coded = des[0]
    else:
        coded = B.stream_deparse(np.stack(des), cfg.nbpscs, cfg.nsym)
    pairs = B.depuncture_llr(coded, cfg.cr, cfg.n_trellis)
    bits = B.viterbi_decode(pairs)
    data, _seed = B.descramble(bits)
    return data


def _assemble(cfg: PhyConfig, data_bits: np.ndarray, rx: RxPacket) -> None:
    if cfg.fmt == Fmt.VHT:
        psdu_bits = data_bits[16: 16 + 8 * cfg.psdu_len]
        rx.psdu = T.bits_to_bytes(psdu_bits)
        rx.mpdus = MAC.ampdu_deaggregate(rx.psdu)
        rx.ok = len(rx.mpdus) > 0
    else:
        psdu_bits = data_bits[16: 16 + 8 * cfg.psdu_len]
        rx.psdu = T.bits_to_bytes(psdu_bits)
        if cfg.ampdu:
            rx.mpdus = MAC.ampdu_deaggregate(rx.psdu, ht=True)
            rx.ok = len(rx.mpdus) > 0
        else:
            rx.ok = B.fcs_ok(rx.psdu)
            rx.mpdus = [rx.psdu] if rx.ok else []


def _demod_data(xs: np.ndarray, data_start: int, cfg: PhyConfig,
                h: np.ndarray, pilot_h: np.ndarray) -> np.ndarray:
    """Demod nsym data symbols -> (nss, nsym*ncbpss) interleaved LLRs.

    xs: (nrx, n) CFO-corrected samples; h: (nrx, nss, 64); pilot_h: (nrx, 4)
    summed-stream pilot channel.
    """
    legacy = cfg.fmt == Fmt.L
    didx = T.DATA_IDX_L if legacy else T.DATA_IDX_NL
    from .tx import data_pilots
    pilots = data_pilots(cfg.fmt, cfg.nss, cfg.nsym)   # (nsym, nss, 4)
    llrs = np.empty((cfg.nss, cfg.nsym, cfg.ncbpss), dtype=np.float64)
    for n in range(cfg.nsym):
        grids = np.stack([sym_window(xs[r], data_start + 80 * n)
                          for r in range(xs.shape[0])])
        # residual-phase reference: expected rx pilot = sum_s h_pilot_s * p_s[n]
        if cfg.fmt == Fmt.HT and cfg.nss == 2:
            # HT streams carry different pilot patterns; per-stream pilot
            # channel is valid (P rows apply at pilot tones too)
            expected = np.einsum("rsk,sk->rk", h[:, :, T.PILOT_IDX],
                                 pilots[n].astype(np.complex128))
        else:
            # all streams transmit the same pilots: use the summed channel
            expected = pilot_h * pilots[n][0][None, :]
        ph = pilot_phase(grids[:, T.PILOT_IDX].reshape(-1), expected.reshape(-1))
        grids = grids * np.conj(ph)
        eq = zf_equalize(grids[:, didx], h[:, :, didx])
        llrs[:, n] = llr_demap(eq, cfg.nbpscs).reshape(cfg.nss, -1)
    return llrs.reshape(cfg.nss, -1)


def _pilot_h_per_stream(h: np.ndarray) -> np.ndarray:
    """HT: per-stream channel at pilot tones (valid: P rows apply at pilots).

    h: (nrx, nss, 64) -> (nrx, nss, 4)."""
    return h[:, :, T.PILOT_IDX]


# ---------------------------------------------------------------------------
# Top-level receiver
# ---------------------------------------------------------------------------

def receive(stream: np.ndarray, mu_pos: int | None = None,
            max_packets: int = 1000) -> list[RxPacket]:
    """Demodulate every packet found in a (nrx, n) or (n,) sample stream."""
    xs_all = np.atleast_2d(np.asarray(stream))
    x0 = xs_all[0]
    m, _c = stf_metric(x0)
    packets = []
    for trig in find_triggers(m):
        if len(packets) >= max_packets:
            break
        pkt = _receive_one(xs_all, trig, mu_pos)
        if pkt is not None:
            packets.append(pkt)
    return packets


def _receive_one(xs_all: np.ndarray, trig: int, mu_pos) -> RxPacket | None:
    x0 = xs_all[0]
    sync = ltf_sync(x0, trig + 80)
    if sync is None:
        return None
    ltf_idx, peak = sync
    cfo = coarse_cfo(x0, trig, 64)
    cfo = fine_cfo(x0, ltf_idx, cfo)
    snr = 10 * np.log10(peak / max(1 - peak, 1e-6))
    rssi = float(np.mean(np.abs(x0[ltf_idx: ltf_idx + 64]) ** 2))

    need = len(x0) - ltf_idx
    xs = np.stack([derotate(xs_all[r], ltf_idx, need, cfo)
                   for r in range(xs_all.shape[0])])
    if need < 208 + 80:
        return None
    h_l = legacy_chan_est(xs[0], 0)

    # L-SIG
    g = fft_sym(xs[0][144: 208]) / np.where(np.abs(h_l) > 1e-9, h_l, 1)
    llr = B.deinterleave(g[T.DATA_IDX_L].real, 1, True)
    lsig_bits = B.viterbi_decode(B.depuncture_llr(llr, "1/2", 24))
    lsig = S.parse_lsig(lsig_bits)
    if not lsig.ok:
        return None
    rx = RxPacket(False, start=ltf_idx, cfo_hz=cfo, snr_db=snr, rssi=rssi)
    n_data_samp = lsig.nsym * 80
    if need < 208 + n_data_samp:
        return None

    if lsig.mcs != 0:
        return _rx_legacy(xs, lsig, rx)

    # HT-SIG vs VHT-SIG-A dual hypothesis on the next two symbols
    sig_start = 208
    g1 = fft_sym(xs[0][sig_start + 16: sig_start + 80])
    g2 = fft_sym(xs[0][sig_start + 96: sig_start + 160])
    hnz = np.where(np.abs(h_l) > 1e-9, h_l, 1)
    e1, e2 = g1 / hnz, g2 / hnz
    d1, d2 = e1[T.DATA_IDX_L], e2[T.DATA_IDX_L]
    vht_llr = np.concatenate([B.deinterleave(d1.real, 1, True),
                              B.deinterleave(d2.imag, 1, True)])
    ht_llr = np.concatenate([B.deinterleave(d1.imag, 1, True),
                             B.deinterleave(d2.imag, 1, True)])
    vht_bits = B.viterbi_decode(B.depuncture_llr(vht_llr, "1/2", 48))
    siga = S.parse_vhtsiga(vht_bits)
    if siga.ok:
        return _rx_vht(xs, lsig, siga, rx, mu_pos)
    ht_bits = B.viterbi_decode(B.depuncture_llr(ht_llr, "1/2", 48))
    htsig = S.parse_htsig(ht_bits)
    if htsig.ok:
        return _rx_ht(xs, lsig, htsig, rx)
    return _rx_legacy(xs, lsig, rx)  # legacy mcs0 data after all


def _rx_legacy(xs, lsig, rx: RxPacket) -> RxPacket:
    cfg = PhyConfig(Fmt.L, lsig.mcs, 1, lsig.length)
    if cfg.nsym * 80 + 208 > xs.shape[1]:
        return rx
    h_l = legacy_chan_est(xs[0], 0)
    h = h_l[None, None, :]
    pilot_h = h_l[T.PILOT_IDX][None, :]
    llrs = _demod_data(xs[:1], 208, cfg, h, pilot_h)
    data = _decode_payload(cfg, llrs)
    rx.fmt, rx.mcs, rx.nss, rx.length = Fmt.L, lsig.mcs, 1, lsig.length
    _assemble(cfg, data, rx)
    return rx


def _nl_ltf_grids(xs: np.ndarray, start: int, nltf: int) -> np.ndarray:
    """(nltf, nrx, 64) grids of the non-legacy LTF symbols beginning at
    ``start`` (each 80 samples, window at GI end)."""
    out = np.empty((nltf, xs.shape[0], 64), dtype=np.complex128)
    for j in range(nltf):
        for r in range(xs.shape[0]):
            out[j, r] = fft_sym(xs[r][start + 80 * j + 16: start + 80 * j + 80])
    return out


def _rx_ht(xs, lsig, htsig, rx: RxPacket) -> RxPacket:
    nss = htsig.mcs // 8 + 1
    if nss > xs.shape[0]:
        return rx  # cannot separate more streams than antennas
    cfg = PhyConfig(Fmt.HT, htsig.mcs, nss, htsig.length, ampdu=htsig.ampdu)
    # plausibility bound: the HT-SIG-implied air time must fit inside the
    # L-SIG TXTIME budget (reference lib/demod_impl.cc:185-199 rejects
    # CRC-valid HT-SIGs whose nSym overruns the spoofed L-SIG length)
    if lsig.nsym * 80 < cfg.nsym * 80 + 160 + 80 + 80 * cfg.nltf:
        return rx
    # layout after L-SIG: HT-SIG 160, HT-STF 80, LTFs
    ltf_start = 208 + 160 + 80
    data_start = ltf_start + 80 * cfg.nltf
    if data_start + 80 * cfg.nsym > xs.shape[1]:
        return rx
    grids = _nl_ltf_grids(xs, ltf_start, cfg.nltf)
    h = nl_chan_est(grids, nss, Fmt.HT)
    pilot_h = h[:, :, T.PILOT_IDX].sum(axis=1)
    llrs = _demod_data(xs, data_start, cfg, h, pilot_h)
    data = _decode_payload(cfg, llrs)
    rx.fmt, rx.mcs, rx.nss, rx.length = Fmt.HT, htsig.mcs, nss, htsig.length
    rx.ampdu = htsig.ampdu
    _assemble(cfg, data, rx)
    return rx


def _rx_vht(xs, lsig, siga, rx: RxPacket, mu_pos) -> RxPacket:
    rx.mu = siga.mu
    if siga.mu:
        return _rx_vht_mu(xs, lsig, siga, rx, mu_pos or 0)
    nss = siga.nss
    nltf = int(T.N_LTF_OF_NSTS[nss])
    ltf_start = 208 + 160 + 80
    sigb_start = ltf_start + 80 * nltf
    data_start = sigb_start + 80
    if data_start > xs.shape[1]:
        return rx
    grids = _nl_ltf_grids(xs, ltf_start, nltf)
    h = nl_chan_est(grids, nss, Fmt.VHT)
    pilot_h = nl_pilot_chan(grids)

    # VHT-SIG-B: identical on all streams -> effective channel sum_s h_s
    gb = np.stack([sym_window(xs[r], sigb_start) for r in range(xs.shape[0])])
    ph = pilot_phase(gb[:, T.PILOT_IDX].reshape(-1),
                     (pilot_h * T.PILOT_VHT[None, :]).reshape(-1))
    gb = gb * np.conj(ph)
    h_eff = h[:, :, :].sum(axis=1)          # (nrx, 64)
    num = (np.conj(h_eff[:, T.DATA_IDX_NL]) * gb[:, T.DATA_IDX_NL]).sum(axis=0)
    den = (np.abs(h_eff[:, T.DATA_IDX_NL]) ** 2).sum(axis=0)
    eqb = num / np.maximum(den, 1e-12)
    sigb_llr = B.deinterleave(eqb.real, 1, False)
    sigb_bits = B.viterbi_decode(B.depuncture_llr(sigb_llr, "1/2", 26))
    sigb = S.parse_vhtsigb(sigb_bits, mu=False)
    rx.sigb_len = sigb.length

    # symbol count from L-SIG spoofed length
    n_data_samp = lsig.nsym * 80 - (160 + 80 + 80 * nltf + 80)
    nsym = max(n_data_samp // 80, 0)
    rx.fmt, rx.mcs, rx.nss = Fmt.VHT, siga.mcs, nss
    if nsym == 0:
        rx.is_ndp = True
        rx.ok = True
        rx.ndp_ltf_grids = grids
        rx.ndp_chan = h
        return rx
    # infer APEP length from SIG-B; fall back to the L-SIG sample budget when
    # SIG-B looks implausible (reference plausibility bound)
    cfg = None
    if sigb.ok and 1 <= rx.sigb_len <= 4095:
        cand = PhyConfig(Fmt.VHT, siga.mcs, nss, rx.sigb_len, ampdu=True)
        if cand.nsym == nsym:
            cfg = cand
    if cfg is None:
        cfg = _vht_cfg_for_nsym(siga.mcs, nss, nsym)
        if cfg is None:
            return rx
    if data_start + 80 * cfg.nsym > xs.shape[1]:
        return rx
    rx.length = rx.sigb_len
    llrs = _demod_data(xs[:, :], data_start, cfg, h, pilot_h)
    data = _decode_payload(cfg, llrs)
    _assemble(cfg, data, rx)
    # SIG-B CRC cross-check rides in SERVICE bits 8..15
    if not np.array_equal(data[8:16], sigb.crc):
        rx.ok = False
    return rx


def _vht_cfg_for_nsym(mcs, nss, nsym) -> PhyConfig | None:
    """Largest valid APEP length whose cfg yields exactly nsym symbols."""
    probe = PhyConfig(Fmt.VHT, mcs, nss, 1, ampdu=True)
    max_len = (nsym * probe.ndbps - 16 - 6) // 8
    if max_len < 1 or max_len > 4095:
        return None
    cfg = PhyConfig(Fmt.VHT, mcs, nss, max_len, ampdu=True)
    return cfg if cfg.nsym == nsym else None


def _rx_vht_mu(xs, lsig, siga, rx: RxPacket, mu_pos: int) -> RxPacket:
    """MU-MIMO STA receive: 1 antenna, extract own stream via P combining."""
    nsts = list(siga.nsts)
    n_total = sum(nsts)
    nltf = int(T.N_LTF_OF_NSTS[n_total])
    ltf_start = 208 + 160 + 80
    sigb_start = ltf_start + 80 * nltf
    data_start = sigb_start + 80
    grids = _nl_ltf_grids(xs, ltf_start, nltf)
    # own stream index = sum of nsts before mu_pos
    own = sum(nsts[:mu_pos])
    h_all = nl_chan_est(grids, n_total, Fmt.VHT)     # (nrx, nsts, 64)
    h_own = h_all[:, own: own + nsts[mu_pos]]
    pilot_h = nl_pilot_chan(grids)

    gb = np.stack([sym_window(xs[r], sigb_start) for r in range(xs.shape[0])])
    ph = pilot_phase(gb[:, T.PILOT_IDX].reshape(-1),
                     (pilot_h * T.PILOT_VHT[None, :]).reshape(-1))
    gb = gb * np.conj(ph)
    eqb = (gb[:, T.DATA_IDX_NL] / h_own[:, 0, T.DATA_IDX_NL])[0]
    sigb_llr = B.deinterleave(eqb.real, 1, False)
    sigb_bits = B.viterbi_decode(B.depuncture_llr(sigb_llr, "1/2", 26))
    sigb = S.parse_vhtsigb(sigb_bits, mu=True)

    n_data_samp = lsig.nsym * 80 - (160 + 80 + 80 * nltf + 80)
    nsym = max(n_data_samp // 80, 0)
    rx.fmt, rx.nss, rx.mcs = Fmt.VHT, nsts[mu_pos], sigb.mcs
    rx.sigb_len = sigb.length
    rx.length = sigb.length
    if nsym == 0:
        rx.is_ndp = True
        rx.ok = True
        rx.ndp_ltf_grids = grids
        rx.ndp_chan = h_all
        return rx
    if not sigb.ok or not (0 <= sigb.mcs <= 8) or not (1 <= sigb.length <= 4095):
        rx.ok = False
        return rx
    cfg = PhyConfig(Fmt.VHT, sigb.mcs, nsts[mu_pos], max(sigb.length, 1),
                    ampdu=True, mu_nsym=nsym)
    if data_start + 80 * nsym > xs.shape[1]:
        return rx
    llrs = _demod_data(xs, data_start, cfg, h_own, pilot_h)
    data = _decode_payload(cfg, llrs)
    if not np.array_equal(data[8:16], sigb.crc):
        rx.ok = False
        return rx
    _assemble(cfg, data, rx)
    return rx
