"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for sm_90a into one
shared library with a plain C interface, loaded with ``ctypes``.  The
sources compile in parallel (one ``nvcc -c`` each, all started
together) and are linked once; the library is named by a hash of every
source and the flags, so an edited source never loads a stale build.
Nothing is built or loaded when a module is imported: the first kernel
launch builds.

The wrappers that launch the kernels (``ops/viterbi_kernels.py``,
``ops/viterbi.scan_viterbi``, ``ops/frontend.derotate``) share the
helpers here: the CPU-tensor / CUDA-tensor split (:func:`on_cuda`), the
alignment of vector-loaded operands (:func:`aligned`) and the launch
counters (:func:`counted`, :func:`reset_launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

#: (C function, argument types) of every kernel entry point; each returns
#: cudaGetLastError() after its launch (0 = launched)
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRY_POINTS = {
    "gr80211_acs_sweep": [_VP] * 4 + [_CI, _CI, _VP],
    "gr80211_traceback_sweep": [_VP] * 3 + [_CI, _CI, _VP],
    "gr80211_acs_sweep_packed": [_VP] * 6 + [_CI, _CI, _VP],
    "gr80211_traceback_sweep_packed": [_VP] * 4 + [_CI, _CI, _VP],
    "gr80211_derotate": [_VP] * 5 + [_CI, _CI, _CF, _VP],
    "gr80211_scan_viterbi": [_VP] * 3 + [_CI, _CI, _CI, _VP],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "csrc/*.cu on a machine with the CUDA toolkit")
    return path


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, float, str]:
    """Compile every ``csrc/*.cu`` (once per content) and return (library
    path, build seconds, compiler output)."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode() + b"\0" + s.read_bytes())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / f"libgr80211_kernels_{tag}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc_bin = nvcc()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{s.stem}_{tag}.{os.getpid()}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc_bin, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s.name, p.returncode, log)
              for s, p, log in zip(srcs, procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc_bin, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    return (out, time.perf_counter() - t0,
            "".join(logs) + link.stdout + link.stderr)


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    so = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def on_cuda(*ts) -> bool:
    """True for CUDA tensors, False for CPU tensors (the twins' domain);
    anything else, or a mix, raises."""
    kinds = {t.device.type for t in ts}
    require(len(kinds) == 1 and kinds <= {"cpu", "cuda"},
            f"tensors must all be on one CPU or CUDA device, got {kinds}")
    if "cuda" in kinds:
        require(len({t.device for t in ts}) == 1,
                "tensors on different CUDA devices")
    return "cuda" in kinds


def aligned(t, nbytes: int):
    """Contiguous and aligned for the kernels' vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def launch(name: str, device, *args):
    """Call the C entry point ``name`` on ``device``'s current stream
    (pointers and ints in ``args``) and raise if the launch was refused."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


#: every wrapper that launches a kernel, in registration order
_COUNTED: list = []


def counted(fn):
    """Give a kernel wrapper a ``launches`` counter and a ``shapes`` set of
    the problem shapes it launched at (both updated by the wrapper where
    it launches its kernel, and nowhere else)."""
    fn.launches = 0
    fn.shapes = set()
    _COUNTED.append(fn)
    return fn


def reset_launch_counts():
    for fn in _COUNTED:
        fn.launches = 0
        fn.shapes = set()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _COUNTED}


def launch_shapes() -> dict[str, set]:
    """Each wrapper's launch shapes since the last reset."""
    return {fn.__name__: set(fn.shapes) for fn in _COUNTED}
