#!/usr/bin/env python3
"""One process of the port's multi-process scale-out
(``gr_ieee80211_tpu_torch.parallel.distributed``).

    python3 tools_torch/mesh_worker.py RANK WORLD PORT {sp,dp} \\
        [--local-shards 4] [--backend nccl|gloo] [--device cuda|cpu] \\
        [--iq FILE.npy] [--n-pkt 16] [--max-pkts 16] [--b-local 8] [--reps 3]

Joins a process group of WORLD processes at tcp://localhost:PORT with
--local-shards shards of its own, ingests only this rank's slice of the
input and runs the time-sharded chain (``sp``,
``rx_chain_multihost``) or the packet-sharded decode (``dp``,
``payload_decode_multihost``) once with the kernels' launch counters
zeroed, then --reps more times on the clock.  It prints

    RESULT ok=<n_ok> det=<n_det>      global counts, the same on every rank
    SPTIME ms=<median> | DPTIME ms=<median>   host clock, synchronized
    LAUNCHES {"acs_sweep": n, ...}    this rank's launches in the first run
    SHAPES [[B, T], ...]              the (B, T) K1/K2 launched at in it

Input: ``--iq FILE.npy`` is memory-mapped and sliced by rank (sp: an (N,)
complex64 stream; dp: (B, n_samp) windows), its config beside it in
FILE.json (:func:`save_capture` writes both).  Without it, the built-in
stream of :func:`build_stream` (--n-pkt VHT MCS2 packets), whose dp
windows are --b-local copies of its first packet per rank.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))


def build_stream(n_pkt: int = 16):
    """(cfg, mpdu_len, stream): ``n_pkt`` copies of one VHT MCS2 40 B
    A-MPDU, 1400 samples apart, from sample 1000, in a zero stream padded
    to a multiple of 8 samples."""
    from gr_ieee80211_tpu_torch.gold import mac, tx
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    mpdu = mac.qos_data_frame(b"x" * 40, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 2, 1, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    spacing = len(wave) + 1400
    stream = np.zeros(-(-(n_pkt * spacing + 4096) // 8) * 8, np.complex64)
    for i in range(n_pkt):
        stream[1000 + i * spacing: 1000 + i * spacing + len(wave)] = wave
    return cfg, len(mpdu), stream


def save_capture(path, iq: np.ndarray, cfg, mpdu_len: int) -> None:
    """Write ``iq`` as complex64 to ``path`` (.npy) and the config the
    workers decode it with to the .json beside it."""
    path = Path(path)
    np.save(path, np.ascontiguousarray(iq, np.complex64))
    path.with_suffix(".json").write_text(json.dumps({
        "fmt": int(cfg.fmt), "mcs": cfg.mcs, "nss": cfg.nss,
        "length": cfg.length, "ampdu": bool(cfg.ampdu),
        "mpdu_len": mpdu_len}))


def load_capture(path):
    """(cfg, mpdu_len, memory-mapped samples) of :func:`save_capture`."""
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    cfg = PhyConfig(Fmt(meta["fmt"]), meta["mcs"], meta["nss"],
                    meta["length"], meta["ampdu"])
    return cfg, meta["mpdu_len"], np.load(path, mmap_mode="r")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("mode", choices=("sp", "dp"))
    ap.add_argument("--local-shards", type=int, default=4)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iq", default=None)
    ap.add_argument("--n-pkt", type=int, default=16,
                    help="packets of the built-in stream")
    ap.add_argument("--max-pkts", type=int, default=16,
                    help="packets a shard decodes at most (sp)")
    ap.add_argument("--b-local", type=int, default=8,
                    help="windows a rank decodes (dp, built-in stream)")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)

    import torch
    from gr_ieee80211_tpu_torch.parallel import distributed as D
    from gr_ieee80211_tpu_torch.utils import trace
    from tools_torch import timing
    if torch.device(a.device).type == "cpu":
        torch.set_num_threads(2)

    D.bootstrap(f"tcp://localhost:{a.port}", a.world, a.rank,
                backend=a.backend, local_shards=a.local_shards)
    try:
        if a.iq:
            cfg, mpdu_len, data = load_capture(a.iq)
        else:
            cfg, mpdu_len, data = build_stream(a.n_pkt)
        mesh = D.global_mesh((a.mode,), device=a.device)
        if a.mode == "sp":
            n = len(data) // a.world
            pieces = D.distribute_stream(data[a.rank * n: (a.rank + 1) * n],
                                         mesh)
            run, _ = D.rx_chain_multihost(cfg, mesh, mpdu_len=mpdu_len,
                                          max_pkts_per_shard=a.max_pkts)
        else:
            run, n_samp = D.payload_decode_multihost(cfg, mesh,
                                                     mpdu_len=mpdu_len)
            if a.iq:
                b = len(data) // a.world
                wins = data[a.rank * b: (a.rank + 1) * b]
            else:
                p0 = int(np.flatnonzero(np.abs(data) > 0)[0])
                wins = np.tile(data[p0 + 188: p0 + 188 + n_samp][None],
                               (a.b_local, 1))
            pieces = D.distribute_windows(wins, mesh)

        def once():
            out = run(pieces)
            if a.mode == "sp":
                return tuple(int(x) for x in out)
            return int(out[2]), len(data) if a.iq else a.b_local * a.world

        sync = (torch.cuda.synchronize if mesh.local_devices[0].type == "cuda"
                else (lambda: None))
        before = trace.snapshot()
        n_ok, n_det = once()
        sync()
        kern = timing.kernel_launches(timing.moved(before, trace.snapshot()))
        ts = []
        for _ in range(a.reps):
            tic = time.perf_counter()
            once()
            sync()
            ts.append(1e3 * (time.perf_counter() - tic))
        print(f"RESULT ok={n_ok} det={n_det}", flush=True)
        if ts:
            print(f"{a.mode.upper()}TIME ms={statistics.median(ts):.1f}",
                  flush=True)
        print(f"LAUNCHES {json.dumps(kern['launches'])}", flush=True)
        print(f"SHAPES {json.dumps(kern['k1_k2_shapes'])}", flush=True)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
