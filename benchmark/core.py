"""Shared pieces of the benchmark: the import guard, the device record,
worker processes, the span wrappers and the reading of the profiler's
trace.  Everything here is the benchmark's own yardstick; it imports
nothing of the program under test at module level.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

#: top-level module names that must never be loaded by a run: JAX and the
#: JAX package the port was made from (compared whole, so the port's own
#: ``gr_ieee80211_tpu_torch`` passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "gr_ieee80211_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def guard(where: str):
    """Exit 3 (no result) if a forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"benchmark: {where}: forbidden modules loaded: {found}",
              file=sys.stderr)
        sys.exit(3)


def workers(n: int | None = None):
    """A pool of spawned worker processes (numpy only; the program is never
    imported there).  Use it in a ``with`` block."""
    n = n or max(1, min(8, os.cpu_count() or 1))
    return multiprocessing.get_context("spawn").Pool(n)


@contextlib.contextmanager
def one_core(torch):
    """Run the body on one fixed core with one PyTorch CPU thread, the
    process's earlier affinity and thread count restored after it: the
    measured stretch's host work then meets the same core every run
    (worker pools run outside it, on every core)."""
    cpus = sorted(os.sched_getaffinity(0))
    threads = torch.get_num_threads()
    os.sched_setaffinity(0, {cpus[-1]})
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        os.sched_setaffinity(0, cpus)


def percentile(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), q))


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it (a card below
    700 W runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def device_record(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count)),
            "power_limit": power_limit()}


def resolve(target: str):
    """"module:Owner.attr" -> (owner object, attribute name)."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name


def short(target: str) -> str:
    return target.partition(":")[2]


class Spans:
    """Wraps program functions, named "module:qualname", for one stretch.

    ``mode="sync"``: each call is timed by the host clock between two
    device synchronizations (inclusive: its own device work and launch
    overhead, children included) and filed under its caller's span.
    ``mode="annotate"``: each call only opens a profiler range named
    ``span:<qualname>`` (no synchronization) and its first argument's
    shape is kept, for the readers of the profiler's trace."""

    def __init__(self, targets, mode: str, sync=None):
        self.mode, self.sync = mode, sync
        self.calls: list[tuple[str, str | None, float]] = []
        self.shapes: dict[str, list[tuple]] = {}
        self._stack: list[str] = []
        self._undo = []
        for t in dict.fromkeys(targets):
            self._wrap(t)

    def _wrap(self, target: str):
        import torch
        owner, name = resolve(target)
        fn = getattr(owner, name)
        key = short(target)

        if self.mode == "sync":
            def wrapped(*a, **k):
                parent = self._stack[-1] if self._stack else None
                self._stack.append(key)
                self.sync()
                tic = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.sync()
                    self.calls.append(
                        (key, parent, time.perf_counter() - tic))
                    self._stack.pop()
        else:
            def wrapped(*a, **k):
                if a and hasattr(a[0], "shape"):
                    self.shapes.setdefault(key, []).append(
                        tuple(a[0].shape))
                with torch.profiler.record_function("span:" + key):
                    return fn(*a, **k)
        setattr(owner, name, wrapped)
        self._undo.append((owner, name, fn))

    def close(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()


class DeviceTrace:
    """The device's own events of a profiled stretch, in seconds.

    ``busy_s``: the union of kernel, copy and set intervals inside the
    window; ``window_s``: the window's length; ``kernels``: [(name, s)]
    summed by name; ``gaps``: [(span open on the host, s)] the idle
    intervals between device events, named by the innermost
    ``span:``/``entry:`` range open at their middle; ``inside(key)``: the
    device seconds of the work launched inside ``span:<key>`` ranges."""

    DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
    LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

    def __init__(self, events: list[dict], window: str):
        xs = [e for e in events if e.get("ph") == "X"]
        win = [e for e in xs if e.get("name") == window]
        if not win:
            raise RuntimeError(f"profiled window {window!r} not in the trace")
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        self.window_s = (w1 - w0) * 1e-6
        dev = sorted((e for e in xs if e.get("cat") in self.DEVICE_CATS
                      and w0 <= e["ts"] < w1), key=lambda e: e["ts"])
        self.n_device_events = len(dev)
        ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
                         for e in xs if e.get("cat") == "user_annotation"
                         and e["name"].startswith(("span:", "entry:"))),
                        key=lambda r: r[0])
        self._ranges = ranges
        busy, gaps, cur = 0.0, {}, None
        for e in dev:
            s, t = e["ts"], min(e["ts"] + e["dur"], w1)
            if cur is None:
                cur = [s, t]
                continue
            if s > cur[1]:
                busy += cur[1] - cur[0]
                name = self._open_at((cur[1] + s) / 2)
                gaps[name] = gaps.get(name, 0.0) + (s - cur[1])
                cur = [s, t]
            else:
                cur[1] = max(cur[1], t)
        if cur is not None:
            busy += cur[1] - cur[0]
        self.busy_s = busy * 1e-6
        kern: dict[str, float] = {}
        for e in dev:
            kern[e["name"]] = kern.get(e["name"], 0.0) + e["dur"] * 1e-6
        self.kernels = sorted(kern.items(), key=lambda kv: -kv[1])
        self.gaps = sorted(((k, v * 1e-6) for k, v in gaps.items()),
                           key=lambda kv: -kv[1])
        launch_ts = {e["args"]["correlation"]: (e["ts"], e.get("tid"))
                     for e in xs if e.get("cat") in self.LAUNCH_CATS
                     and "correlation" in e.get("args", {})}
        self._dev_launch = [(e["dur"] * 1e-6,
                             launch_ts.get(e.get("args", {}).get("correlation")))
                            for e in dev]

    def _open_at(self, t: float) -> str:
        best = None
        for s, e, name, _ in self._ranges:
            if s > t:
                break
            if e >= t and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "outside the benchmark's spans"

    def inside(self, key: str) -> float | None:
        """Device seconds of the events launched inside ``span:<key>``
        ranges; None where no range of that name was recorded."""
        rs = [(s, e, tid) for s, e, name, tid in self._ranges
              if name == "span:" + key]
        if not rs:
            return None
        total = 0.0
        for dur, launch in self._dev_launch:
            if launch is None:
                continue
            ts, tid = launch
            if any(s <= ts <= e and tid == rt for s, e, rt in rs):
                total += dur
        return total


@contextlib.contextmanager
def profiled(torch, window: str):
    """Profile the body (host and device activity) inside one range named
    ``window``; yields a list that holds the :class:`DeviceTrace` after
    the body.  The trace file lives in the temporary directory only while
    it is read."""
    from torch.profiler import ProfilerActivity, profile
    box: list[DeviceTrace] = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(window):
            yield box
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    box.append(DeviceTrace(events, window))


class Readings:
    """What a per-layer reader sees: the synchronized spans of the span
    stretch over its ``items`` (blocks or calls), and the profiled
    stretch's shapes and :class:`DeviceTrace`."""

    def __init__(self, spans: Spans, items: int, annotated: Spans,
                 device: DeviceTrace | None):
        self._spans, self.items = spans, items
        self._annotated, self.device = annotated, device

    def per_item_ms(self, key: str, parent: str | None = "*",
                    default=None):
        hits = [s for k, p, s in self._spans.calls
                if k == key and (parent == "*" or p == parent)]
        if not hits or not self.items:
            return default
        return 1e3 * sum(hits) / self.items

    def per_item_calls(self, key: str):
        n = sum(1 for k, _, _ in self._spans.calls if k == key)
        return n / self.items if n and self.items else None

    def shapes(self, key: str) -> list[tuple]:
        return self._annotated.shapes.get(key, [])
