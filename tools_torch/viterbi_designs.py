#!/usr/bin/env python3
"""Time the earlier design of the Viterbi kernels beside the package's.

    python3 tools_torch/viterbi_designs.py [T] [B]

The package's K1 (``acs_sweep``) and K2 (``traceback_sweep``) are one
warp per packet on packet-major data with two decision words a step; its
K4 (``acs_sweep_packed``) and K5 (``traceback_sweep_packed``) are one
warp per packet in blocks of 32 neighbouring packets on the reference's
batch-minor planes.  The design they replaced (one thread per packet,
batch-minor planes, a traceback whose loads depend on the state;
``earlier_viterbi.cu`` beside this file) is kept only as a baseline: this
tool builds it with ``nvcc`` into the package's build directory, checks
that both designs give the same decisions, metrics and bits on the same
LLRs, and times them in turns (earlier, new, new, earlier) with CUDA
events, on random LLRs and on noisy codewords (the earlier tracebacks'
loads depend on the decisions, the package's do not).  It needs a CUDA
card and ``nvcc``.  :func:`compare` (K1/K2) and :func:`compare_packed`
(K4/K5) are also what ``chip_smoke.py`` calls for its ``earlier_ms``
entries.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "earlier_viterbi.cu"
_VP, _CI = ctypes.c_void_p, ctypes.c_int


def start_build():
    """Start ``nvcc`` on the baseline source; returns (Popen or None,
    library path).  Lets a caller overlap this build with others."""
    from gr_ieee80211_tpu_torch.ops import cuda_lib as CL
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    out = CL.BUILD_DIR / f"libearlier_viterbi_{tag}.so"
    if out.exists():
        return None, out
    CL.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [CL.nvcc(), *CL.NVCC_FLAGS, "-shared", "-o", str(out), str(SRC)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


@functools.lru_cache(maxsize=None)
def _lib(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for fn in (lib.earlier_acs_sweep, lib.earlier_acs_sweep_packed):
        fn.argtypes = [_VP] * 6 + [_CI, _CI, _VP]
    for fn in (lib.earlier_traceback_sweep,
               lib.earlier_traceback_sweep_packed):
        fn.argtypes = [_VP] * 4 + [_CI, _CI, _VP]
    return lib


def finish_build(handle) -> tuple[ctypes.CDLL, str]:
    """Wait for :func:`start_build`; returns (library, compiler output)."""
    proc, out = handle
    log = ""
    if proc is not None:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SRC.name}:\n{log}")
    return _lib(out), log


def _call(fn, *args):
    import torch
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier kernel launch failed: cudaError {rc}")


def earlier_acs(lib, llr0, llr1, pm0, packed: bool = False):
    """(T, B) planes, (64, B) metrics -> decision planes x 2 and the
    final (64, B) metrics: the earlier K1 ((T, 32, B) uint8 0/1 planes)
    or, ``packed``, the earlier K4 ((T/4, 32, B), four steps a byte)."""
    import torch
    n_steps, B = llr0.shape
    dec_lo = torch.empty((n_steps // 4 if packed else n_steps, 32, B),
                         dtype=torch.uint8, device=llr0.device)
    dec_hi = torch.empty_like(dec_lo)
    pm = torch.empty_like(pm0)
    _call(lib.earlier_acs_sweep_packed if packed else lib.earlier_acs_sweep,
          llr0.data_ptr(), llr1.data_ptr(), pm0.data_ptr(),
          dec_lo.data_ptr(), dec_hi.data_ptr(), pm.data_ptr(), n_steps, B)
    return dec_lo, dec_hi, pm


def earlier_traceback(lib, dec_lo, dec_hi, start, packed: bool = False):
    """Decision planes, (B,) start -> (T, B) bits: the earlier K2, or,
    ``packed``, the earlier K5 over (T/4, 32, B) planes."""
    import torch
    n_rows, _, B = dec_lo.shape
    n_steps = 4 * n_rows if packed else n_rows
    bits = torch.empty((n_steps, B), dtype=torch.uint8, device=dec_lo.device)
    _call(lib.earlier_traceback_sweep_packed if packed
          else lib.earlier_traceback_sweep, dec_lo.data_ptr(),
          dec_hi.data_ptr(), start.data_ptr(), bits.data_ptr(), n_steps, B)
    return bits


def _ms(fn, reps):
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(lib, llr, reps: int = 10) -> dict:
    """Both designs on the (B, T, 2) LLR pairs ``llr`` (CUDA): equal
    outputs required; returns the times in ms, each the mean of the two
    turns of ``reps`` launches (earlier, new, new, earlier)."""
    import torch
    from gr_ieee80211_tpu_torch.ops import viterbi_kernels as VK
    B = llr.shape[0]
    llr0 = llr[:, :, 0].T.contiguous()
    llr1 = llr[:, :, 1].T.contiguous()
    pm0 = VK.state0_metrics(B, llr.device)
    pm0_t = pm0.T.contiguous()
    start = VK.state0_start(B, llr.device)
    dec, pm = VK.acs_sweep(llr, pm0)
    dec_lo, dec_hi, pm_e = earlier_acs(lib, llr0, llr1, pm0_t)
    bits = VK.traceback_sweep(dec, start)
    bits_e = earlier_traceback(lib, dec_lo, dec_hi, start)
    torch.cuda.synchronize()
    lo, hi = VK.planes_from_words(dec)
    if not (torch.equal(lo, dec_lo) and torch.equal(hi, dec_hi)
            and torch.equal(pm.T, pm_e) and torch.equal(bits.T, bits_e)):
        raise AssertionError("the two designs disagree")
    del lo, hi
    turns = {"acs_earlier": lambda: earlier_acs(lib, llr0, llr1, pm0_t),
             "acs": lambda: VK.acs_sweep(llr, pm0),
             "tb_earlier": lambda: earlier_traceback(lib, dec_lo, dec_hi,
                                                     start),
             "tb": lambda: VK.traceback_sweep(dec, start)}
    return _in_turns(turns, ("acs", "tb"), reps)


def _in_turns(turns: dict, kinds, reps: int) -> dict:
    """``{name}_ms`` and ``{name}_earlier_ms`` for each kind: the mean of
    two turns of ``reps`` launches (earlier, new, new, earlier)."""
    out = {}
    for kind in kinds:
        order = (f"{kind}_earlier", kind, kind, f"{kind}_earlier")
        times = {k: [] for k in order}
        for k in order:
            times[k].append(_ms(turns[k], reps))
        for k, v in times.items():
            out[k + "_ms"] = sum(v) / len(v)
    return out


def compare_packed(lib, llr, reps: int = 10) -> dict:
    """:func:`compare` for K4/K5: both designs on the batch-minor planes
    of the (B, T, 2) LLR pairs ``llr`` from pinned metrics and a state-0
    start; equal planes, metrics and bits required."""
    import torch
    from gr_ieee80211_tpu_torch.ops import viterbi_kernels as VK
    B = llr.shape[0]
    llr0 = llr[:, :, 0].T.contiguous()
    llr1 = llr[:, :, 1].T.contiguous()
    pm0 = VK.state0_metrics(B, llr.device).T.contiguous()
    start = VK.state0_start(B, llr.device)
    new = VK.acs_sweep_packed(llr0, llr1, pm0)
    old = earlier_acs(lib, llr0, llr1, pm0, packed=True)
    bits = VK.traceback_sweep_packed(new[0], new[1], start)
    bits_e = earlier_traceback(lib, old[0], old[1], start, packed=True)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(new, old))
            and torch.equal(bits, bits_e)):
        raise AssertionError("the two packed designs disagree")
    dec_lo, dec_hi, _ = new
    turns = {"acs_packed_earlier": lambda: earlier_acs(lib, llr0, llr1, pm0,
                                                       packed=True),
             "acs_packed": lambda: VK.acs_sweep_packed(llr0, llr1, pm0),
             "tb_packed_earlier": lambda: earlier_traceback(
                 lib, dec_lo, dec_hi, start, packed=True),
             "tb_packed": lambda: VK.traceback_sweep_packed(dec_lo, dec_hi,
                                                            start)}
    return _in_turns(turns, ("acs_packed", "tb_packed"), reps)


def make_llrs(rng, kind: str, n_steps: int, B: int):
    """(B, T, 2) float32 LLR pairs: ``random`` (no codeword: survivors
    wander, decisions look random) or ``coded`` (BCC codewords of random
    messages at ~4 dB with every third second LLR punctured to zero, as a
    receiver sees them: survivors merge, decisions follow the message)."""
    import numpy as np
    from gr_ieee80211_tpu_torch.gold.bits import bcc_encode
    if kind == "random":
        llr = rng.normal(size=(B, n_steps, 2)) * 4.0
    else:
        msg = rng.integers(0, 2, (B, n_steps)).astype(np.uint8)
        msg[:, -6:] = 0
        coded = np.stack([bcc_encode(m) for m in msg]).reshape(B, n_steps, 2)
        llr = (2.0 * coded - 1.0) * 4.0 + rng.normal(size=coded.shape) * 2.5
    llr = llr.astype(np.float32)
    llr[:, 1::3, 1] = 0.0
    return llr


def main(argv) -> int:
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    if not torch.cuda.is_available():
        print("viterbi_designs: needs a CUDA card", file=sys.stderr)
        return 2
    n_steps = int(argv[1]) if len(argv) > 1 else 4480
    B = int(argv[2]) if len(argv) > 2 else 4096
    from gr_ieee80211_tpu_torch.ops import cuda_lib as CL
    handle = start_build()              # beside the package's sources
    package_log = CL.build()[2]
    lib, log = finish_build(handle)
    for line in (package_log + log).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(" ", line.strip())
    rng = np.random.default_rng(7)
    res = {}
    for kind in ("random", "coded"):
        llr = torch.from_numpy(make_llrs(rng, kind, n_steps, B)).cuda()
        res[kind] = {**compare(lib, llr), **compare_packed(lib, llr)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "T": n_steps, "B": B, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
