"""Timing, device and output helpers shared by the port's harness tools.

* :func:`require_device` turns ``--device`` into a ``torch.device``; "cuda"
  raises where there is no card (no fallback to the CPU).
* :func:`call_ms` times warmed calls: CUDA events around each call on the
  card, the host clock around a synchronized call on the CPU; median and
  quartiles.
* :func:`device_info` is the card's ``nvidia-smi`` name and power limit,
  or ``"cpu"``.
* :func:`out_path` puts a tool's JSON under ``results_torch/`` unless
  ``--out`` names another file; :func:`write_json` writes it.
* :func:`with_counters` runs a function between two ``utils/trace`` snapshots
  and returns the counters that moved (:func:`moved`);
  :func:`kernel_launches` turns those into the kernels' launches and
  K1/K2's launch shapes, :func:`decode_path` into the decode tiers and
  dd passes that ran.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
RESULTS = REPO / "results_torch"


def require_device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} needs a CUDA card; pass "
                           "--device cpu to run on the CPU")
    return dev


def synchronize(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def call_ms(fn, dev, reps: int, warm: int = 2) -> dict:
    """``warm`` untimed calls of ``fn``, then ``reps`` timed ones:
    {"median_ms", "q1_ms", "q3_ms", "ms"} (each call on its own)."""
    import torch
    for _ in range(warm):
        fn()
    synchronize(dev)
    ms = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end))
        else:
            tic = time.perf_counter()
            fn()
            ms.append(1e3 * (time.perf_counter() - tic))
    q = statistics.quantiles(ms, n=4) if len(ms) > 1 else [ms[0]] * 3
    return {"median_ms": statistics.median(ms), "q1_ms": q[0],
            "q3_ms": q[2], "ms": ms}


def device_info(dev) -> str:
    """``nvidia-smi``'s "name, power limit" of the card (the first line),
    or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def out_path(name: str, out: str | None = None) -> Path:
    """``out`` when given, else ``results_torch/<name>``."""
    return Path(out) if out else RESULTS / name


def write_json(path: Path, blob: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(blob, indent=1) + "\n")


def moved(before: dict, after: dict) -> dict:
    """Counter name -> change, for each counter that differs between two
    ``trace.snapshot()`` readings."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def kernel_launches(diff: dict) -> dict:
    """``{"launches": {wrapper: n}, "k1_k2_shapes": [[B, T], ...]}`` from
    the :func:`moved` counters: every kernel wrapper (0 where none
    launched) and the (B, T) shapes K1/K2 launched at."""
    from gr_ieee80211_tpu_torch.ops import cuda_lib as CL
    names = [CL.wrapper_name(ep) for ep in CL._ENTRY_POINTS]
    shapes = {tuple(int(d) for d in k.rsplit(".", 1)[1].split("x"))
              for k in diff if k.startswith(("kernel.acs_sweep.at.",
                                             "kernel.traceback_sweep.at."))}
    return {"launches": {n: int(diff.get(f"kernel.{n}.launches", 0))
                         for n in names},
            "k1_k2_shapes": sorted(list(s) for s in shapes)}


def decode_path(diff: dict) -> list[str]:
    """The decode tiers (``decode.tier.<name>``) and dd passes (``"dd"``)
    among the :func:`moved` counters, each as often as it ran, sorted."""
    out = []
    for k, n in sorted(diff.items()):
        if k.startswith("decode.tier."):
            out += [k[len("decode.tier."):]] * int(n)
        elif k == "rx.payload.dd":
            out += ["dd"] * int(n)
    return out


def with_counters(fn, dev):
    """``fn()`` between two counter snapshots, the device synchronized
    before the second: (result, the :func:`moved` counters)."""
    from gr_ieee80211_tpu_torch.utils import trace
    before = trace.snapshot()
    out = fn()
    synchronize(dev)
    return out, moved(before, trace.snapshot())
