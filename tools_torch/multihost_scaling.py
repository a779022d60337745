#!/usr/bin/env python3
"""Fixed work per process over 1, 2 and 4 processes of the port's
multi-process scale-out (``parallel.distributed``).

    python3 tools_torch/multihost_scaling.py [--ranks 1,2,4] [--device cuda]
        [--out results_torch/multihost_scaling.json]

Runs ``tools_torch/mesh_worker.py`` as N processes over Gloo, 2 shards
each, for N in ``--ranks``, in both modes, and records each rank's
median time of 5 synchronized runs (its ``SPTIME`` / ``DPTIME`` line):

* dp: ``payload_decode_multihost`` of 32 windows a process (copies of the
  built-in stream's first VHT MCS2 packet); every window must pass the
  FCS on every configuration;
* sp: ``rx_chain_multihost`` on a built-in stream of 8 packets a process,
  ingested a slice a process; every packet must be detected and decode.

What it measures: with one card, every rank's shards share ``cuda:0``
(NCCL refuses two ranks on one device, so the ranks meet over Gloo, whose
collectives stage the halos and counts through host tensors), and the
ranks share the host's cores. The curve is the cost of the process
boundary (process-group collectives, one CUDA context and one launch
queue a process, host contention) at fixed work per process, not scaling
across cards or hosts, which one card cannot show.
"""
from __future__ import annotations

import argparse
import json
import re
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools_torch import timing  # noqa: E402

SHARDS = 2                               # shards a process
B_LOCAL = 32                             # dp windows a process
PKTS_PER_PROC = 8                        # sp packets a process


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_workers(n_proc: int, mode: str, dev, extra=()):
    """``n_proc`` mesh_worker processes; each rank's ((ok, det), ms,
    launches, K1/K2 shapes)."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tools_torch" / "mesh_worker.py"),
         str(r), str(n_proc), str(port), mode, "--local-shards", str(SHARDS),
         "--backend", "gloo", "--device", dev.type, "--reps", "5", *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_proc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        m = re.search(r"RESULT ok=(\d+) det=(\d+)", text)
        t = re.search(rf"{mode.upper()}TIME ms=([0-9.]+)", text)
        n = re.search(r"LAUNCHES (\{.*\})", text)
        s = re.search(r"SHAPES (\[.*\])", text)
        if p.returncode != 0 or not (m and t and n and s):
            raise RuntimeError(f"{mode} rank {r} of {n_proc} exited "
                               f"{p.returncode}:\n{text[-2000:]}")
        res.append(((int(m.group(1)), int(m.group(2))), float(t.group(1)),
                    json.loads(n.group(1)), json.loads(s.group(1))))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    if dev.type == "cuda":
        # one build before the ranks start, so no two nvcc runs race
        from gr_ieee80211_tpu_torch.ops import cuda_lib as CL
        CL.build()
    curve = {"dp": [], "sp": []}
    launches, shapes = {}, set()

    def note(res):
        for _, _, counts, sh in res:
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            shapes.update(tuple(bt) for bt in sh)

    for n in (int(x) for x in a.ranks.split(",")):
        res = run_workers(n, "dp", dev, ("--b-local", str(B_LOCAL),
                                         "--n-pkt", "16"))
        note(res)
        if not all(r[0] == (B_LOCAL * n, B_LOCAL * n) for r in res):
            raise RuntimeError(f"dp n={n}: {[r[0] for r in res]}")
        ts = [r[1] for r in res]
        curve["dp"].append({"n_proc": n, "b_local": B_LOCAL,
                            "ms_per_step_max": max(ts),
                            "ms_per_step_all": ts})
        print(f"dp n={n}: {ts}", flush=True)
        n_pkt = PKTS_PER_PROC * n
        res = run_workers(n, "sp", dev, ("--n-pkt", str(n_pkt),
                                         "--max-pkts", str(max(8, n_pkt))))
        note(res)
        # every rank prints the global counts
        if not all(r[0] == (n_pkt, n_pkt) for r in res):
            raise RuntimeError(f"sp n={n}: {[r[0] for r in res]}")
        ts = [r[1] for r in res]
        curve["sp"].append({"n_proc": n, "pkts_per_proc": PKTS_PER_PROC,
                            "ms_per_chain_max": max(ts),
                            "ms_per_chain_all": ts})
        print(f"sp n={n}: {ts}", flush=True)
    out = timing.out_path("multihost_scaling.json", a.out)
    timing.write_json(out, {
        "mode": "fixed_work_per_process",
        "device": timing.device_info(dev),
        "backend": f"gloo, {SHARDS} shards a process, every shard on "
                   f"{dev.type}{':0' if dev.type == 'cuda' else ''}",
        "caveat": ("one device shared by every rank, and one host: this "
                   "measures the process boundary (Gloo collectives through "
                   "host tensors, a CUDA context and launch queue a process, "
                   "host contention) at fixed work per process, not scaling "
                   "across cards or hosts. Every configuration decoded "
                   "every packet."),
        "curve": curve, "launches": launches,
        "k1_k2_shapes": sorted(list(bt) for bt in shapes)})
    print(json.dumps({"out": str(out), "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
