"""ctypes bindings for the native host runtime (``native/phyrt.cpp`` at
the repository root), as far as the receive engine needs them.

Builds ``libphyrt.so`` on first use (``make`` in ``native/``) and falls
back to the pure-Python walk in :mod:`..gold.mac`, so the port works
without a toolchain.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


@functools.lru_cache(maxsize=1)
def _lib():
    so = os.path.join(_NATIVE_DIR, "libphyrt.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.phyrt_deagg_vht.restype = ctypes.c_int
    lib.phyrt_deagg_vht.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]
    return lib


def deagg_vht(psdu: bytes, max_out: int = 64) -> list[bytes]:
    """FCS-valid MPDUs from a VHT A-MPDU (native delimiter walk)."""
    lib = _lib()
    if lib is None:
        from ..gold.mac import ampdu_deaggregate
        return ampdu_deaggregate(psdu)
    offs = np.zeros(max_out, np.int32)
    lens = np.zeros(max_out, np.int32)
    n = lib.phyrt_deagg_vht(psdu, len(psdu),
                            offs.ctypes.data_as(ctypes.c_void_p),
                            lens.ctypes.data_as(ctypes.c_void_p), max_out)
    return [psdu[offs[i]: offs[i] + lens[i]] for i in range(n)]
