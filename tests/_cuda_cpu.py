"""A kernel source of ``gr_ieee80211_tpu_torch/csrc`` built for the CPU:
g++ on the source with ``tests/cuda_cpu_shim.h`` in place of the CUDA
runtime (one OS thread per CUDA thread), each ``<<<...>>>`` launch
rewritten into the shim's ``emu_launch`` and each ``extern __shared__``
array into a pointer to the shim's dynamic shared memory.  Float and
double operations round as the card's ``_rn`` instructions do
(``-ffp-contract=off``), so the tests hold the kernel's arithmetic to its
twin's on the CPU."""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from gr_ieee80211_tpu_torch.ops import cuda_lib as CL

SHIM = Path(__file__).resolve().parent / "cuda_cpu_shim.h"


def cpu_source(src: str) -> str:
    """The CUDA source ``src`` rewritten for the shim; exactly one launch."""
    src = src.replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                     lambda m: f"emu_launch({m.group(2)}, [&] "
                               f"{{ {m.group(1)}({m.group(3)}); }});",
                     src, flags=re.S)
    assert n == 1
    return re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_dynamic_smem);", src)


def build(name: str, entry: str, out_dir: Path):
    """``csrc/<name>.cu`` built for the CPU: its C entry point ``entry``,
    with the wrapper's argument types (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    cpp, so = out_dir / f"{name}.cpp", out_dir / f"{name}.so"
    cpp.write_text(cpu_source((CL.CSRC / f"{name}.cu").read_text()))
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                          "-fPIC", "-shared", "-pthread", "-o", str(so),
                          str(cpp)], capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = CL._ENTRY_POINTS[entry]
    fn.restype = ctypes.c_int
    return fn
