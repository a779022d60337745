"""Batched RX front end: STF detection, trigger dedup, window gathers,
LTF timing, CFO estimation and derotation.

Port of ``gr_ieee80211_tpu.ops.frontend``.  The reference's TPU
workarounds (the blocked 64-sample gathers with their shift cascade, the
two-level ``_compact_indices``) become direct indexing and
``torch.nonzero``; their semantics are kept: windows read zeros past the
stream end, the payload and sync gathers stage samples through bfloat16
as the reference's do (the SIG and NDP gathers stay float32), and
candidate lists are ascending and padded with -1.

The reference's Pallas derotation (``derotate_pallas``, K3) is the CUDA
kernel behind :func:`derotate` (``csrc/derotate.cu``), with its plain
twin :func:`derotate_ref`.  Like the reference, the receive chain does
not run it: ``derotate_batch`` uses the factored-phasor form.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import trace
from .cplx import CF, expj
from .cuda_lib import launch, on_cuda, require

FS = 20e6

_MOVSUM_BLK = 1 << 15
#: block length of the reference's float32 prefix sums (XLA:CPU scans a
#: cumulative sum in blocks of 16, see :func:`_cumsum_ordered`)
_SCAN_BASE = 16


def _cumsum_ordered(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumsum along the last axis, summed in the order
    the reference's ``jnp.cumsum`` takes on the CPU: each block of 16 in
    sequence, the block totals scanned the same way (recursively), and
    each block offset by the exclusive prefix of the totals before it.

    ``torch.cumsum`` accumulates in another order (in float64 on the
    CPU), and the last-bit differences move LTF timing on the flat top of
    the autocorrelation peak; in this order the moving sums, and so the
    timing, are bit-equal to the reference's."""
    b = _SCAN_BASE
    n = x.shape[-1]
    nb = -(-n // b)
    xb = F.pad(x, (0, nb * b - n)).reshape(*x.shape[:-1], nb, b)
    for i in range(1, min(b, n)):      # a lone short block needs n - 1
        xb[..., i] += xb[..., i - 1]
    if nb == 1:
        return xb[..., 0, :n]
    excl = F.pad(_cumsum_ordered(xb[..., -1])[..., :-1], (1, 0))
    return (xb + excl[..., None]).reshape(*x.shape[:-1], nb * b)[..., :n]


def _movsums(xs: list[torch.Tensor], ws: list[int]) -> list[torch.Tensor]:
    """Moving sums ``_movsum(x, w)`` of several arrays with one leading
    shape, from ONE ordered cumsum over their stack.  The cumsum is
    causal, so right-padding each array to the longest leaves its prefix
    sums unchanged; one call pays the sequential scan's launches once."""
    n = max(x.shape[-1] for x in xs)
    c = F.pad(_cumsum_ordered(torch.stack(
        [F.pad(x, (0, n - x.shape[-1])) for x in xs])), (1, 0))
    return [c[i, ..., w: x.shape[-1] + 1] - c[i, ..., : x.shape[-1] + 1 - w]
            for i, (x, w) in enumerate(zip(xs, ws))]


def _movsum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Moving window sum along the last axis, out[n] = sum x[n:n+w], from
    float32 cumsum differences in the reference's summation order.

    Long 1-D inputs are cut into 32k blocks with w-sample overlap and the
    cumsum restarts per block: a single float32 cumsum-difference drifts
    over multi-megasample streams."""
    assert w - 1 <= _MOVSUM_BLK, w
    n_out = x.shape[-1] - w + 1
    if x.ndim > 1 or x.shape[-1] <= _MOVSUM_BLK:
        return _movsums([x], [w])[0]
    K = _MOVSUM_BLK
    nblk = -(-n_out // K)
    xp = F.pad(x, (0, (nblk + 1) * K - x.shape[-1]))
    main = xp[: nblk * K].reshape(nblk, K)
    ov = xp[K:].reshape(nblk, K)[:, : w - 1]
    c = F.pad(_cumsum_ordered(torch.cat([main, ov], dim=1)), (1, 0))
    return (c[:, w:] - c[:, :-w]).reshape(-1)[:n_out]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    torch has no float32 FMA, so the sum is taken in float64, where the
    product of two float32 values is exact, and rounded to odd (the
    TwoSum error, then one ulp toward it when the last bit is even); the
    cast to float32 then rounds once, as the FMA does."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).to(torch.float32)


def _ltf_metric(a: CF, y: torch.Tensor) -> torch.Tensor:
    """``|a| / sqrt(y)`` in the arithmetic the reference's XLA:CPU emits
    for it: ``re*re + im*im`` contracted into one FMA, and the division
    rewritten as ``sqrt(.) * rsqrt(y)``, the rsqrt an estimate refined by
    two Newton steps whose multiply-adds are contracted too.  The last
    bits decide the argmax on the flat top of the LTF autocorrelation.
    The reference's estimate is the CPU's ``vrsqrtps`` table, which torch
    cannot reach; the correctly rounded value stands in for it, so the
    metric can still differ from the reference's in its last bit."""
    mag = torch.sqrt(_fma(a.re, a.re, a.im * a.im))
    r = (1.0 / torch.sqrt(y.double())).to(torch.float32)
    minus1 = torch.full_like(y, -1.0)
    for _ in range(2):
        r = _fma(r * -0.5, _fma(y * r, r, minus1), r)
    return mag * r


def _movcount(flags: torch.Tensor, w: int) -> torch.Tensor:
    """Moving count of 0/1 flags over w, out[n] = sum flags[n:n+w], as
    exact int32 sums (equal to the reference's float32 sums of flags)."""
    c = F.pad(torch.cumsum(flags.to(torch.int32), dim=-1, dtype=torch.int32),
              (1, 0))
    return c[..., w:] - c[..., :-w]


_POWER_FLOOR_REL = 1e-3


def _floor(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(_POWER_FLOOR_REL * p.mean(), min=1e-12)


def stf_metrics(x: CF):
    """x (n,) -> (metric m, lag-16 autocorrelation CF), aligned to x[0]:
    the per-sample plateau metric |sum_48 x[k] conj x[k+16]| over the
    64-sample power (floored), which the time-sharded front end reads.

    The products and magnitudes take the multiply-adds XLA:CPU contracts
    them into (``re*re' + im*im'`` as ``fma(re, re', im*im')``), so the
    moving sums are bit-equal to the reference's and the metric is within
    an ulp of it."""
    n = x.shape[-1]
    a, b = x[: n - 16], x[16:]
    prod = CF(_fma(a.re, b.re, a.im * b.im), _fma(a.im, b.re, -(a.re * b.im)))
    c = CF(_movsum(prod.re, 48), _movsum(prod.im, 48))
    p = _movsum(_fma(x.re, x.re, x.im * x.im), 64)
    k = min(c.shape[-1], p.shape[-1])
    c = c[..., :k]
    mag = torch.sqrt(_fma(c.re, c.re, c.im * c.im))
    return mag / torch.maximum(p[..., :k], _floor(p)), c


DETECT_STRIDE = 16
DETECT_ROW = 8192
_DET_OV = 96


def _chunk_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum every DETECT_STRIDE lanes, accumulating in float32."""
    r, n = x.shape
    n4 = n // DETECT_STRIDE
    return (x[:, : n4 * DETECT_STRIDE].reshape(r, n4, DETECT_STRIDE)
            .to(torch.float32).sum(dim=-1))


def stf_metric_strided(x: CF) -> torch.Tensor:
    """Plateau metric at DETECT_STRIDE positions, flat (n // 16,).

    The stream is viewed as (n_rows, ROW + overlap) rows so every moving
    sum is a short-axis 2-D op, exactly as the reference cuts it."""
    s = DETECT_STRIDE
    n = x.shape[-1]
    n_rows = -(-n // DETECT_ROW)
    pad = (n_rows + 1) * DETECT_ROW - n

    def mk(v):
        vp = F.pad(v, (0, pad))
        main = vp[: n_rows * DETECT_ROW].reshape(n_rows, DETECT_ROW)
        ov = vp[DETECT_ROW:].reshape(n_rows, DETECT_ROW)[:, :_DET_OV]
        return torch.cat([main, ov], dim=1)

    rows = CF(mk(x.re), mk(x.im))
    prod = rows[:, : rows.shape[-1] - 16].mul_conj(rows[:, 16:])
    cre, cim, p = _movsums([_chunk_rows(prod.re), _chunk_rows(prod.im),
                            _chunk_rows(rows.abs2())],
                           [48 // s, 48 // s, 64 // s])
    k = DETECT_ROW // s
    m = (torch.sqrt(cre[:, :k] ** 2 + cim[:, :k] ** 2)
         / torch.maximum(p[:, :k], _floor(p)))
    return m.reshape(-1)[: n // s]


def nonzero_padded(mask: torch.Tensor, size: int,
                   fill: int = -1) -> torch.Tensor:
    """Ascending indices of the set entries of a 1-D mask, cut or padded
    to ``size`` with ``fill`` (``jnp.nonzero(size=, fill_value=)``).
    The count of set entries is read back: one synchronization."""
    with trace.sync("nonzero"):
        idx = torch.nonzero(mask, as_tuple=True)[0][:size]
    return F.pad(idx, (0, size - idx.shape[0]), value=fill)


def detect_plateaus(m: torch.Tensor, thresh: float = 0.3, run: int = 20,
                    max_out: int = 4096, suppress: int = 0,
                    confirm: tuple | None = None) -> torch.Tensor:
    """Plateau-start detection; (max_out,) int32 candidates padded -1.

    ``confirm=(win, need)`` keeps a start only if >= need of the win
    points from it are above threshold; ``suppress`` drops a start with
    another start within the preceding ``suppress`` points."""
    above = (m > thresh).to(torch.int32)
    run_ok = _movcount(above, run) >= run
    nr = run_ok.shape[-1]
    prev = F.pad(above[:-1], (1, 0))
    start = run_ok & (prev[:nr] == 0) & (above[:nr] > 0)
    if confirm is not None:
        win, need = confirm
        cnt = _movcount(F.pad(above, (0, win)), win)[:nr]
        start = start & (cnt >= need)
    if suppress:
        prev_cnt = _movcount(F.pad(start.to(torch.int32), (suppress, 0)),
                             suppress)[:nr]
        start = start & (prev_cnt == 0)
    return nonzero_padded(start, max_out).to(torch.int32)


_SUPPRESS_STRIDED = 700 // DETECT_STRIDE


def detect_plateaus_strided(m4: torch.Tensor, thresh: float = 0.3,
                            max_out: int = 4096) -> torch.Tensor:
    """Candidate trigger sample indices from the strided metric (padded
    -1): run of 3 strided points, plateau-length confirmation (8, 6) and
    pre-dedup cluster suppression, as the reference."""
    idx = detect_plateaus(m4, thresh=thresh, run=3, max_out=max_out,
                          suppress=_SUPPRESS_STRIDED, confirm=(8, 6))
    return torch.where(idx >= 0, idx * DETECT_STRIDE, idx)


def dedup_triggers_device(cand: torch.Tensor, max_out: int,
                          spacing: int = 700) -> torch.Tensor:
    """Keep the first candidate of each >spacing-gap cluster of ascending
    -1-padded candidates; (max_out,) int32 padded -1."""
    prev = F.pad(cand[:-1], (1, 0), value=-(1 << 30))
    keep = (cand >= 0) & (cand - prev > spacing)
    pos = nonzero_padded(keep, max_out)
    return torch.where(pos >= 0, cand[torch.clamp(pos, min=0)],
                       torch.full_like(pos, -1)).to(torch.int32)


def gather_windows(x: CF, starts: torch.Tensor, n: int) -> CF:
    """x (N,) + starts (B,) (0 <= start <= N) -> (B, n) float32 windows;
    samples past the stream end read as zeros."""
    def one(v):
        vp = F.pad(v.to(torch.float32), (0, n))
        return vp.unfold(0, n, 1)[starts.to(torch.int64)]
    return CF(one(x.re), one(x.im))


def gather_windows_bf16(x: CF, starts: torch.Tensor, n: int) -> CF:
    """Like :func:`gather_windows` but through a bfloat16 staging copy of
    the stream (~49 dB SQNR), returned as float32."""
    def one(v):
        vp = F.pad(v.to(torch.bfloat16), (0, n))
        return vp.unfold(0, n, 1)[starts.to(torch.int64)].to(torch.float32)
    return CF(one(x.re), one(x.im))


def ltf_fine_sync_cfo(wins: CF, cfo0: torch.Tensor):
    """Fused fine timing + fine CFO on (B, 368) windows at trigger+80.

    Timing is the midpoint of the 80% shoulders of the lag-64
    autocorrelation peak, +8 (aimed early into the GI); the fine CFO is the
    angle of the same autocorrelation at that offset, unwrapped by the
    coarse estimate ``cfo0``.  Returns (offset (B,) int32, peak (B,),
    cfo_hz (B,), rssi (B,))."""
    B, n = wins.shape
    npts = n - 128
    dev = wins.device
    prod = wins[:, : n - 64].mul_conj(wins[:, 64:])
    are, aim, pw = _movsums([prod.re, prod.im, wins.abs2()], [64] * 3)
    a = CF(are, aim)                                      # (B, n-127)
    ac = _ltf_metric(a[:, :npts], torch.clamp(
        pw[:, :npts] * pw[:, 64: 64 + npts], min=1e-24))
    k = torch.argmax(ac, dim=1)
    peak = torch.gather(ac, 1, k[:, None])[:, 0]
    idx = torch.arange(npts, device=dev)[None, :]
    tgt = 0.8 * peak[:, None]
    d = torch.abs(ac - tgt)
    kk = k[:, None]
    in_l = (idx <= kk) & (idx >= kk - 32)
    in_r = (idx >= kk) & (idx <= kk + 32)
    big = torch.full_like(d, 1e9)
    lo = torch.argmin(torch.where(in_l, d, big), dim=1)
    hi = torch.argmin(torch.where(in_r, d, big), dim=1)
    mid = torch.div(lo + hi, 2, rounding_mode="floor") + 8
    ci = torch.clamp(mid, 0, a.shape[1] - 1)[:, None]
    s_re = torch.gather(a.re, 1, ci)[:, 0]
    s_im = torch.gather(a.im, 1, ci)[:, 0]
    phase0 = 2 * np.pi * 64.0 * cfo0 / FS
    ang = torch.atan2(s_im, s_re) + phase0
    ang = ang - 2 * np.pi * torch.round(ang / (2 * np.pi))
    cfo = cfo0 - ang / 64 / (2 * np.pi) * FS
    rssi = torch.gather(pw, 1, k[:, None])[:, 0] / 64.0
    return mid.to(torch.int32), peak, cfo, rssi


def ltf_fine_sync(wins: CF):
    """Per-packet L-LTF timing on (B, 368) windows at trigger+80: (offset
    (B,) int32, peak (B,)), :func:`ltf_fine_sync_cfo` without its CFO and
    RSSI."""
    off, peak, _, _ = ltf_fine_sync_cfo(
        wins, torch.zeros(wins.shape[0], dtype=torch.float32,
                          device=wins.device))
    return off, peak


def coarse_cfo_batch(stf_wins: CF) -> torch.Tensor:
    """(B, >=80) windows at the trigger -> CFO Hz from lag-16 autocorr."""
    prod = stf_wins[:, :64].mul_conj(stf_wins[:, 16:80])
    s = CF(prod.re.mean(dim=1), prod.im.mean(dim=1))
    return -s.angle() / 16 / (2 * np.pi) * FS


#: float32(-2 pi), the factor a Python float becomes beside float32 data
NEG_TWO_PI = float(np.float32(-2 * np.pi))


def fine_cfo_batch(ltf_wins: CF, cfo0: torch.Tensor) -> torch.Tensor:
    """(B, 128) LTF windows + coarse CFO -> refined CFO Hz: the windows
    derotated by ``cfo0``, then the angle of their lag-64
    autocorrelation (float32, in the reference's order)."""
    t = torch.arange(128, dtype=torch.float32, device=cfo0.device)
    w = ltf_wins * expj(NEG_TWO_PI * cfo0[:, None] / FS * t[None, :])
    prod = w[:, :64].mul_conj(w[:, 64:128])
    s = CF(prod.re.mean(dim=1), prod.im.mean(dim=1))
    return cfo0 - s.angle() / 64 / (2 * np.pi) * FS


def _derotate_factored(wins: CF, cfo: torch.Tensor, n: int) -> CF:
    """wins * exp(-j 2pi cfo t / FS) with t = 64*q + r factored phasors:
    (B, n/64 + 64) transcendentals instead of (B, n), applied as two
    broadcast complex products (the lane phasor, then the block phasor)."""
    B = wins.shape[0]
    dev = wins.device
    w = (-2 * np.pi / FS) * cfo                      # (B,) rad/sample
    n_hi = -(-n // 64)
    hi = expj(w[:, None] * (64.0 * torch.arange(n_hi, dtype=torch.float32,
                                                device=dev))[None])
    lo = expj(w[:, None] * torch.arange(64, dtype=torch.float32,
                                        device=dev)[None])
    pad = n_hi * 64 - n
    re = F.pad(wins.re, (0, pad)).reshape(B, n_hi, 64)
    im = F.pad(wins.im, (0, pad)).reshape(B, n_hi, 64)
    out = CF(re, im) * CF(lo.re[:, None, :], lo.im[:, None, :])
    out = out * CF(hi.re[:, :, None], hi.im[:, :, None])
    return CF(out.re.reshape(B, -1)[:, :n], out.im.reshape(B, -1)[:, :n])


#: float32(-2 pi / FS): the reference's derotation rate per Hz of CFO
#: (a Python float multiplying a float32 array rounds to float32 first)
W_SCALE = float(np.float32(-2 * np.pi / FS))


def derotate_ref(wins: CF, cfo: torch.Tensor, n: int) -> CF:
    """Plain twin of K3: wins (B, n) * exp(j w t), w = W_SCALE * cfo, the
    phase w * t in float32 (the Pallas ``_derotate_kernel``'s order)."""
    w = W_SCALE * cfo
    t = torch.arange(n, dtype=torch.float32, device=wins.device)
    ph = w[:, None] * t[None, :]
    c, s = torch.cos(ph), torch.sin(ph)
    return CF(wins.re * c - wins.im * s, wins.re * s + wins.im * c)


def derotate(wins: CF, cfo: torch.Tensor, n: int) -> CF:
    """wins (B, n) * exp(-j 2pi cfo t / FS) in one pass (K3, the port of
    ``derotate_pallas``).  CPU tensors take :func:`derotate_ref`; CUDA
    tensors launch the kernel or raise."""
    B = wins.shape[0]
    require(wins.re.shape == (B, n) and wins.im.shape == (B, n)
            and cfo.shape == (B,), "derotate shapes")
    require(all(t.dtype == torch.float32 for t in (wins.re, wins.im, cfo)),
            "derotate takes float32")
    if not on_cuda(wins.re, wins.im, cfo):
        return derotate_ref(wins, cfo, n)
    re, im, cfo = (t.contiguous() for t in (wins.re, wins.im, cfo))
    out_re = torch.empty_like(re)
    out_im = torch.empty_like(im)
    if B == 0 or n == 0:
        return CF(out_re, out_im)
    launch("gr80211_derotate", re.device, re.data_ptr(), im.data_ptr(),
           cfo.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), n, B,
           W_SCALE, shape=(B, n))
    return CF(out_re, out_im)


def derotate_batch(x: CF, starts: torch.Tensor, cfo: torch.Tensor,
                   n: int, low_prec: bool = False) -> CF:
    """Gather (B, n) windows at ``starts`` and derotate each by its CFO
    (factored phasors).  ``low_prec`` stages the gather through bfloat16
    (the payload windows); the default float32 gather serves the SIG and
    NDP windows."""
    gw = gather_windows_bf16 if low_prec else gather_windows
    return _derotate_factored(gw(x, starts, n), cfo, n)
