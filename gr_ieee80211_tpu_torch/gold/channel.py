"""Channel / impairment models for loopback testing and PER sweeps.

Mirrors the reference harness behavior: amplitude scaling + CFO rotation +
zero gaps (``tools/phy80211.py:1018-1034``) and calibrated
AWGN (``tools/performance/perf_siso.py:125-157``: signal amplitude 0.1875 =
L-LTF RMS, noise amplitude = amp / 10^(SNR/20)).
"""
from __future__ import annotations

import numpy as np

SAMPLE_RATE = 20e6
REF_SIG_AMP = 0.1875  # L-LTF RMS amplitude used by the reference PER harness


def apply_cfo(sig: np.ndarray, cfo_hz: float, fs: float = SAMPLE_RATE) -> np.ndarray:
    """Rotate by exp(+j*2*pi*cfo*t); matches PY-TB __genSignalWithCfo."""
    n = np.arange(sig.shape[-1])
    return sig * np.exp(1j * 2 * np.pi * cfo_hz / fs * n)


def frame_stream(ss_sig: np.ndarray, amp: float = 1.0, cfo_hz: float = 0.0,
                 num: int = 1, gap: int = 10000) -> np.ndarray:
    """(nss, n) burst -> repeated gapped stream like PY-TB genFinalSig."""
    ss_sig = np.atleast_2d(ss_sig)
    sig = apply_cfo(ss_sig * amp, cfo_hz)
    z = np.zeros((sig.shape[0], gap), dtype=sig.dtype)
    parts = []
    for _ in range(num):
        parts += [z, sig]
    parts.append(z)
    return np.concatenate(parts, axis=-1)


def awgn(sig: np.ndarray, noise_amp: float, rng: np.random.Generator) -> np.ndarray:
    """Complex AWGN with per-component std = noise_amp/sqrt(2) so the complex
    noise power is noise_amp^2 (fastnoise_source_c amplitude semantics)."""
    n = (rng.normal(size=sig.shape) + 1j * rng.normal(size=sig.shape))
    return sig + noise_amp / np.sqrt(2) * n


def noise_amp_for_snr(sig_amp: float, snr_db: float) -> float:
    return sig_amp / (10 ** (snr_db / 20))


def mimo_channel(ss_sig: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Apply a flat MIMO channel: y[r] = sum_t h[r,t] x[t]; h (nrx, ntx)."""
    return np.einsum("rt,tn->rn", h, np.atleast_2d(ss_sig))


def multipath_channel(ss_sig: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Per-antenna-pair FIR channel: taps (nrx, ntx, L)."""
    x = np.atleast_2d(ss_sig)
    nrx, ntx, L = taps.shape
    n = x.shape[-1]
    y = np.zeros((nrx, n + L - 1), dtype=np.complex128)
    for r in range(nrx):
        for t in range(ntx):
            y[r] += np.convolve(x[t], taps[r, t])
    return y[:, :n]
