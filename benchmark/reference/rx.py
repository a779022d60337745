"""Frozen copy of the gold receiver's front end and NDP channel estimate
(``gold/rx.py`` of gr_ieee80211_tpu_torch), in clear numpy: the STF plateau
trigger and coarse CFO, the L-LTF sync and fine CFO, and the non-legacy
(P-matrix) channel estimate of a VHT NDP.  The benchmark's comparison
needs nothing more of the receiver: decoded packets are held to the
packets the benchmark sent.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .params import Fmt

# Timing convention: ``ltf_idx`` from ltf_sync lands ~6 samples inside GI2
# (mid-shoulder + 10).  All later FFT windows are taken at nominal offsets
# relative to ltf_idx, so every window shares the same small early shift and
# it cancels inside the channel estimate (the reference achieves the same
# robustness with C8P_SYM_SAMP_SHIFT=8, lib/cloud80211phy.h:33).


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


def fft_sym(w64: np.ndarray) -> np.ndarray:
    """64 time samples -> fftshifted 64-bin grid (k = i - 32)."""
    return np.fft.fftshift(np.fft.fft(w64, axis=-1), axes=-1)


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


def _nl_ltf_grids(xs: np.ndarray, start: int, nltf: int) -> np.ndarray:
    """(nltf, nrx, 64) grids of the non-legacy LTF symbols beginning at
    ``start`` (each 80 samples, window at GI end)."""
    out = np.empty((nltf, xs.shape[0], 64), dtype=np.complex128)
    for j in range(nltf):
        for r in range(xs.shape[0]):
            out[j, r] = fft_sym(xs[r][start + 80 * j + 16: start + 80 * j + 80])
    return out
