#!/usr/bin/env python3
"""The readings a cell's limits are set from: the numbers its comparison
gives for the program and for its control, seed by seed, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds <n> [<n> ...] \\
        [--control-seeds <n> ...] [--fault <name> --fault-seeds <n> ...] \\
        [--device cuda]

For each seed: the cell's inputs, one pass of the program over every
input (the outputs a run compares), for the control seeds one pass of
the configuration's control (its lower-precision path), and for the
fault seeds one pass of the program with a fault of ``faults.py``
planted, over the same inputs; then the reference judges each.  Prints
one JSON line a seed and side with every number beside the
configuration's current limit.  The benchmark's own runs never run the
control or a fault.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def one_pass(entry, cfg, tr, seed, device, pool, side, fault,
             inputs=None):
    import contextlib
    from benchmark.faults import FAULTS
    from gr_ieee80211_tpu_torch.models import rx as RX
    run = entry.Run(cfg, tr, seed, device, pool, control=side == "control",
                    inputs=inputs)
    with (FAULTS[fault](RX) if side == "fault"
          else contextlib.nullcontext()):
        for _ in range(run.n):
            run.step()
    run.free()
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default="decoded_bits_altered")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import importlib
    from benchmark import core
    from benchmark.run import load_cell
    _, _, cfg, tr = load_cell(a.workload)
    entry = importlib.import_module(f"benchmark.entries.{cfg['entry']}")
    limits = cfg["limits"]
    with core.workers() as pool:
        for seed in dict.fromkeys(a.seeds + a.control_seeds + a.fault_seeds):
            tic = time.perf_counter()
            sides = [side for side, seeds in (
                ("program", a.seeds), ("control", a.control_seeds),
                ("fault", a.fault_seeds)) if seed in seeds]
            inputs = None
            for side in sides:
                run = one_pass(entry, cfg, tr, seed, a.device, pool, side,
                               a.fault, inputs)
                inputs = run.inputs
                judged = entry.check(run)
                print(json.dumps({
                    "seed": seed, "side": side if side != "fault"
                    else f"fault {a.fault}",
                    "attempted": judged["attempted"],
                    "failed": judged["failed"],
                    "numbers": {k: [v, limits[k]]
                                for k, v in judged["numbers"].items()},
                    "readings": judged.get("readings", {}),
                    "seconds": time.perf_counter() - tic}), flush=True)
    core.guard("end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
