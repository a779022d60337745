#!/usr/bin/env python3
"""Run one cell of the benchmark of gr_ieee80211_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json.  Everything else
is found by name: its configuration ``benchmark/configs/<config>.json``
(sizes, the program's entry ``benchmark/entries/<entry>.py``, the
comparison's limits), its traffic mix ``benchmark/traffic/<traffic>.json``
(read by the one generator, ``benchmark/generate.py``) and each per-layer
metric's reader ``benchmark/metrics/<metric>.py``.

A run needs the cards the cell asks for (it exits 2, printing no result,
without them), makes its inputs from ``--seed`` (in worker processes),
then, on one fixed core with one PyTorch CPU thread, warms every shape
its traffic uses (set-up, ``setup_s``) and:

* ``--trace 0``: decodes the inputs in turn, in whole passes, for at least
  ``--seconds`` seconds and reports the cell's end-to-end metrics;
* ``--trace 1``: profiles a short stretch (the device's busy time, its
  busiest operations, its idle gaps named by the span open on the host),
  then times the spans the per-layer readers ask for, synchronized, over
  a second stretch, and reports the cell's per-layer metrics.

After the window the program's state is freed and the frozen numpy
reference judges every output of the window; ``correct`` is whether
every number compared is within its limit.  The last lines on standard
error and the last key of the result give each number beside its limit.
The last line of standard output is the result, one JSON object.  A run
exits 3, printing no result, when JAX or the JAX package is loaded, at
its start or once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the profiled stretch of a traced run, in items (blocks or calls): long
#: enough to hold every kind of block, short enough to keep the trace small
PROFILED_ITEMS = 4
#: the synchronized span stretch of a traced run: every input once
SPAN_PASSES = 1
#: device operations are named by their first characters in the breakdown
NAME_CHARS = 120


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the workload, its configuration, its traffic)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    tr = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return bench, w, cfg, tr


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}")


def window(run, seconds: float) -> tuple[list[float], float]:
    """Whole passes over the inputs, in turn, until ``seconds`` have passed:
    (host seconds of each item, wall seconds from the first item's start
    to the last one's end).  Whole passes keep every run's work the same
    mix, whatever the program's speed."""
    secs = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or len(secs) % run.n:
        secs.append(run.step())
    return secs, time.perf_counter() - t0


def traced(torch, core, run, metrics: list[dict]) -> tuple[dict, dict]:
    """Per-layer metrics and the breakdown of a traced run."""
    targets = [t for m in metrics for t in reader(m["name"]).SPANS]
    ann = core.Spans(targets, "annotate")
    try:
        with core.profiled(torch, "bench:profiled") as box:
            for _ in range(PROFILED_ITEMS):
                run.step()
    finally:
        ann.close()
    dev = box[0]
    spans = core.Spans(targets, "sync", sync=torch.cuda.synchronize)
    n_items = SPAN_PASSES * run.n
    try:
        for _ in range(n_items):
            run.step()
    finally:
        spans.close()
    t = core.Readings(spans, n_items, ann, dev)
    out = {}
    for m in metrics:
        v = reader(m["name"]).read(t)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = {"device_ops": [[k[:NAME_CHARS], v]
                                for k, v in dev.kernels[:10]],
                 "idle_gaps": [[k, v] for k, v in dev.gaps[:10]]}
    return out, {"busy_s": dev.busy_s, "window_s": dev.window_s,
                 "breakdown": breakdown}


def run_cell(bench: dict, w: dict, cfg: dict, tr: dict, seed: int,
             seconds: float, trace: int, device: str = "cuda") -> dict:
    """Set up, run the window (or the traced stretches), free the program,
    judge; returns the result object.  ``device`` "cpu" serves the tests,
    which drive a run without a card at small sizes."""
    import torch
    from benchmark import core
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    entry = importlib.import_module(f"benchmark.entries.{cfg['entry']}")
    with core.workers() as pool:
        run = entry.Run(cfg, tr, seed, device, pool)
    with core.one_core(torch):
        run.warm()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_START
        if trace:
            metrics, dev_extra = traced(
                torch, core, run,
                cell_metrics(bench, w["name"], "per_layer"))
        else:
            secs, wall = window(run, seconds)
            e2e = run.end_to_end(secs, wall)
            e2e["setup_s"] = {"value": setup_s, "unit": "s"}
            metrics = {m["name"]: e2e[m["name"]] for m in
                       cell_metrics(bench, w["name"], "end_to_end")}
            dev_extra = {}
    core.guard("after the window")
    dev = (core.device_record(torch, w["chips"]) if cuda
           else {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
    dev.update({k: v for k, v in dev_extra.items() if k != "breakdown"})
    run.free()

    judged = entry.check(run)
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in judged["numbers"].items()}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": judged["attempted"], "failed": judged["failed"],
              "metrics": metrics, "device": dev}
    if "breakdown" in dev_extra:
        result["breakdown"] = dev_extra["breakdown"]
    result["readings"] = judged.get("readings", {})
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from benchmark import core
    core.guard("start")
    bench, w, cfg, tr = load_cell(a.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < w["chips"]:
        print(f"benchmark: {a.workload} needs {w['chips']} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    result = run_cell(bench, w, cfg, tr, a.seed, a.seconds, a.trace)
    core.guard("before the result")
    for k, v in result["readings"].items():
        print(f"reading {k}: {v} (not compared)", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
