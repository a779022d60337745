#!/usr/bin/env python3
"""Checks of the port's counters and spans (``utils/trace.py``) on the card.

    python3 tools_torch/trace_check.py sync [--workload daemon_mixed_30dB]
        [--seed N] [--device cuda] [--out results_torch/trace_sync.json]
    python3 tools_torch/trace_check.py overhead [--workload ...] [--seed N]
        [--runs 5] [--seconds 51] [--out results_torch/trace_overhead.json]
    python3 tools_torch/trace_check.py wait [--workload ...] [--seed N]
        [--runs 5] [--out results_torch/trace_wait.json]

* ``sync``: the cell's inputs from the seed (the generator of the cell's
  entry: ``benchmark/generate.py``, ``generate_2x2.py`` or
  ``generate_mu.py``),
  one warm pass of ``RxEngine`` over its blocks (``begin_process`` then
  ``finish_process``, block by block, as the benchmark's entry), then one pass under
  ``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing call
  PyTorch reports is kept with the line of the port that made it, beside
  the change of the program's ``sync.<site>`` counters over the same
  pass.  Exits 1 where PyTorch's count of the port's own synchronizations
  and ``sync.total``'s differ (the tool's own call that turns the mode
  off reports one more, outside the port).  Beside them, the change of
  the ``decode.*`` counters (rows, failed rows, calls by tier), of the
  kernel wrappers' launches, of the bucket calls and rows, of
  speculation's ``rx.spec.*`` and of the MU station's ``rx.mu.*``
  counters over the pass, and whether K7's
  launches (``kernel.payload_chanest.launches``) equal
  ``rx.bucket.calls`` and K8's (``kernel.payload_demod.launches``)
  ``rx.bucket.calls`` + ``rx.mu.calls`` (the MU payload decode
  demodulates through K8 and estimates its channel without K7).
* ``overhead``: untraced runs of the cell (``benchmark/run.py --trace
  0``), in turns with the program's spans off (as the benchmark runs)
  and forced on (``trace.enable()`` before the run), one seed, ``--runs``
  of each: each run's line and, per side, the median and quartiles of
  ``msamples_per_s`` and ``block_ms_p90``.
* ``wait``: the benchmark's profiled stretch (its entry's first
  ``PROFILED_ITEMS`` blocks, the wrappers' annotations on, one core)
  three ways in turns, ``--runs`` times: spans off, spans on, spans on
  under the profiler.  Each way the host's block time (and on over off,
  pass by pass: the cost of the spans); with spans on the summed
  ``sync.*`` span time a block (``trace.spans()``) and each span's self
  time a block (``trace.summary()``: the host's time by stage); profiled,
  also the summed ``span:sync.*`` ranges of the profiler's trace, which
  ``sync_wait_ms_per_block`` reads; by site, and medians.

Both print one JSON line and write it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools_torch import timing  # noqa: E402

PKG = "gr_ieee80211_tpu_torch"
#: runs benchmark/run.py in this process with the program's spans on
SPANS_ON = ("import runpy, sys; sys.path.insert(0, '.'); "
            "from gr_ieee80211_tpu_torch.utils import trace; trace.enable(); "
            "sys.argv = ['benchmark/run.py'] + sys.argv[1:]; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")


def _site(stack) -> str:
    """The innermost frame of the port in a stack: "file:line function"
    (elsewhere: the innermost frames outside ``warnings``)."""
    for f in reversed(stack):
        if f"/{PKG}/" in f.filename and not f.filename.endswith("trace.py"):
            rel = f.filename.split(f"/{PKG}/", 1)[1]
            return f"{rel}:{f.lineno} {f.name}"
    own = [f for f in stack if not f.filename.endswith("warnings.py")]
    return "outside the port: " + " < ".join(
        f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in own[-1:-5:-1])


def generator(cfg: dict):
    """The benchmark's generator of a configuration's entry."""
    import importlib
    name = {"rx_engine_blocks": "generate",
            "rx_engine_blocks_2x2": "generate_2x2",
            "rx_engine_blocks_mu": "generate_mu"}[cfg["entry"]]
    return importlib.import_module(f"benchmark.{name}")


def mode_sync(a) -> dict:
    import torch
    from benchmark import core
    from benchmark.run import load_cell
    from gr_ieee80211_tpu_torch.models.rx import RxEngine
    from gr_ieee80211_tpu_torch.utils import trace
    _, _, cfg, tr = load_cell(a.workload)
    with core.workers() as pool:
        views = generator(cfg).make(tr, cfg, a.seed, pool)["views"]
    dev = timing.require_device(a.device)
    eng = RxEngine(nrx=cfg["nrx"], device=dev, **cfg["engine"])

    def one_pass():
        for v in views:
            eng.finish_process(eng.begin_process(v))

    one_pass()                                   # warm: every shape once
    timing.synchronize(dev)
    seen: list[str] = []
    before = trace.snapshot()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def keep(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                seen.append(_site(traceback.extract_stack()))
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = keep
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            one_pass()
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    moved = timing.moved(before, trace.snapshot())
    counted = {k: v for k, v in moved.items() if k.startswith("sync.")}
    by_line: dict[str, int] = {}
    for s in seen:
        by_line[s] = by_line.get(s, 0) + 1
    in_port = sum(n for k, n in by_line.items()
                  if not k.startswith("outside the port"))
    bucket = moved.get("rx.bucket.calls", 0)
    mu = moved.get("rx.mu.calls", 0)
    k7 = moved.get("kernel.payload_chanest.launches", 0)
    k8 = moved.get("kernel.payload_demod.launches", 0)
    return {"mode": "sync", "workload": a.workload, "seed": a.seed,
            "blocks": len(views), "pytorch_syncs": len(seen),
            "pytorch_syncs_in_port": in_port,
            "counted_syncs": counted.get("sync.total", 0),
            "agree": in_port == counted.get("sync.total", 0),
            "counted_by_site": dict(sorted(counted.items())),
            "decode_and_launches": {
                k: v for k, v in sorted(moved.items())
                if k.startswith(("decode.", "kernel.", "rx.bucket.",
                                 "rx.mu.", "rx.payload.", "rx.spec."))
                and ".at." not in k},
            "bucket_calls": bucket,
            "mu_calls": mu,
            "k7_k8_launches": [k7, k8],
            "k7_a_bucket_k8_a_bucket_or_mu_call": (k7 == bucket
                                                   and k8 == bucket + mu),
            **timing.kernel_launches(moved),
            "pytorch_by_line": dict(sorted(by_line.items(),
                                           key=lambda kv: -kv[1]))}


def _quart(xs: list[float]) -> dict:
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": q[1], "q1": q[0], "q3": q[2],
            "iqr_over_median": (q[2] - q[0]) / q[1] if q[1] else None}


def mode_overhead(a) -> dict:
    runs = []
    for i in range(2 * a.runs):
        side = ("off", "on")[(i + i // 2) % 2]    # off on on off off on ...
        args = ["--workload", a.workload, "--seed", str(a.seed),
                "--seconds", str(a.seconds), "--trace", "0"]
        cmd = ([sys.executable, "benchmark/run.py"] + args if side == "off"
               else [sys.executable, "-c", SPANS_ON] + args)
        tic = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        try:
            res = json.loads(line)
        except json.JSONDecodeError:
            res = {"error": p.stderr[-2000:]}
        m = res.get("metrics", {})
        runs.append({"side": side, "rc": p.returncode,
                     "seconds": time.perf_counter() - tic,
                     "correct": res.get("correct"),
                     **{k: v["value"] for k, v in m.items()},
                     **({"error": res["error"]} if "error" in res else {})})
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    out = {"mode": "overhead", "workload": a.workload, "seed": a.seed,
           "seconds": a.seconds, "runs": runs}
    for side in ("off", "on"):
        for k in ("msamples_per_s", "block_ms_p90", "setup_s"):
            xs = [r[k] for r in runs if r["side"] == side and k in r]
            if xs:
                out[f"{side}.{k}"] = _quart(xs)
    return out


def mode_wait(a) -> dict:
    import importlib
    import torch
    from benchmark import core
    from benchmark.run import PROFILED_ITEMS, cell_metrics, load_cell, reader
    from gr_ieee80211_tpu_torch.utils import trace
    bench, w, cfg, tr = load_cell(a.workload)
    entry = importlib.import_module(f"benchmark.entries.{cfg['entry']}")
    with core.workers() as pool:
        run = entry.Run(cfg, tr, a.seed, a.device, pool)
    targets = [t for m in cell_metrics(bench, w["name"], "per_layer")
               for t in reader(m["name"]).SPANS]

    def by_site(pairs) -> dict:
        out: dict[str, float] = {}
        for name, s in pairs:
            out[name] = out.get(name, 0.0) + 1e3 * s / PROFILED_ITEMS
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def stretch(side: str) -> dict:
        run.i = 0
        trace.reset()
        (trace.disable if side == "off" else trace.enable)()
        ann = core.Spans(targets, "annotate")
        try:
            if side == "profiled":
                with core.profiled(torch, "bench:profiled") as box:
                    secs = [run.step() for _ in range(PROFILED_ITEMS)]
            else:
                secs = [run.step() for _ in range(PROFILED_ITEMS)]
        finally:
            ann.close()
            trace.disable()
        out = {"side": side, "block_ms": 1e3 * sum(secs) / PROFILED_ITEMS}
        if side == "off":
            return out
        spans = by_site((s.name, s.t1 - s.t0) for s in trace.spans()
                        if s.name.startswith("sync."))
        out.update(span_wait_ms_per_block=sum(spans.values()),
                   span_wait_by_site=spans)
        if side == "on":
            out["self_ms_per_block"] = by_site(
                (k, v["self_s"]) for k, v in trace.summary().items())
        else:
            rs = by_site((n[len("span:"):], 1e-6 * (e - s))
                         for s, e, n, _ in box[0]._ranges
                         if n.startswith("span:sync."))
            out["range_wait_ms_per_block"] = sum(rs.values())
            out["range_wait_by_site"] = rs
        return out

    sides = ("off", "on", "profiled")
    reps = []
    with core.one_core(torch):
        run.warm()
        for i in range(a.runs):
            rep = {}
            for side in sides if i % 2 == 0 else sides[::-1]:
                rep[side] = stretch(side)
                print(json.dumps(rep[side]), file=sys.stderr, flush=True)
            reps.append(rep)
    out = {"mode": "wait", "workload": a.workload, "seed": a.seed,
           "blocks": PROFILED_ITEMS, "runs": reps,
           "on_over_off.block_ms": _quart([r["on"]["block_ms"] /
                                           r["off"]["block_ms"]
                                           for r in reps])}
    for side in sides:
        for k in ("block_ms", "span_wait_ms_per_block",
                  "range_wait_ms_per_block"):
            xs = [r[side][k] for r in reps if k in r[side]]
            if xs:
                out[f"{side}.{k}"] = _quart(xs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("sync", "overhead", "wait"))
    ap.add_argument("--workload", default="daemon_mixed_30dB")
    ap.add_argument("--seed", type=int, default=3000001301)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    out = {"sync": mode_sync, "overhead": mode_overhead,
           "wait": mode_wait}[a.mode](a)
    out["device"] = timing.device_info(timing.require_device(a.device))
    print(json.dumps(out), flush=True)
    timing.write_json(timing.out_path(f"trace_{a.mode}.json", a.out), out)
    return 0 if out.get("agree", True) else 1


if __name__ == "__main__":
    sys.exit(main())
