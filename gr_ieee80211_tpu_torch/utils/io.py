"""Sample-file I/O in GNU Radio interleaved complex-float32 format.

Copy of ``gr_ieee80211_tpu.utils.io`` (numpy only).  Byte-compatible
with the reference project's ``genSigBinFile`` / ``procLoadComplexBin``
(``tools/phy80211.py:1037-1061``, ``phy80211header.py:1380-1391``), so
waveforms interchange with GR flowgraphs (file_source / file_sink at
20 Msps).
"""
from __future__ import annotations

import numpy as np


def write_cf32(path: str, samples: np.ndarray) -> None:
    """Write a 1-D complex stream as interleaved float32 (re, im)."""
    np.asarray(samples, dtype=np.complex64).tofile(path)


def read_cf32(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.complex64)


def write_streams(prefix: str, ss_sig: np.ndarray) -> list[str]:
    """Write one file per stream using the reference's naming convention:
    ``{prefix}_{nss}x{nss}_{i}.bin``."""
    ss_sig = np.atleast_2d(ss_sig)
    nss = ss_sig.shape[0]
    paths = []
    for i in range(nss):
        p = f"{prefix}_{nss}x{nss}_{i}.bin"
        write_cf32(p, ss_sig[i])
        paths.append(p)
    return paths


def write_streams_ow(prefix: str, ss_sig: np.ndarray) -> list[str]:
    """openwifi FPGA text format: one ``{prefix}_{nss}x{nss}_{i}.txt`` per
    stream, one "<int re> <int im>" line per sample (samples are expected
    pre-scaled to DAC integer range, e.g. x236298 for legacy/VHT like the
    reference's pktGenOwExample).  Mirrors ``genSigOwTextFile``
    (``tools/phy80211.py:1099-1124``)."""
    ss_sig = np.atleast_2d(ss_sig)
    nss = ss_sig.shape[0]
    paths = []
    for i in range(nss):
        p = f"{prefix}_{nss}x{nss}_{i}.txt"
        s = ss_sig[i]
        re = s.real.astype(np.int64)
        im = s.imag.astype(np.int64)
        with open(p, "w") as f:
            f.writelines(f"{r} {j}\n" for r, j in zip(re, im))
        paths.append(p)
    return paths


def read_streams_ow(path: str) -> np.ndarray:
    """Read one openwifi text stream back to complex128."""
    data = np.loadtxt(path)
    data = np.atleast_2d(data)
    return data[:, 0] + 1j * data[:, 1]
