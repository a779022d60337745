#!/usr/bin/env python3
"""Full-chain throughput against SNR: the adaptive decode's operating curve.

    python3 tools_torch/bench_snr_sweep.py [--device cuda] [--batch 4096]
        [--snrs 16 37 2] [--reps 16] [--out results_torch/throughput_vs_snr.json]

The bench configuration (VHT MCS7 1 SS, a 530 B MPDU, B packets, 900 Hz
CFO; ``tools_tpu/bench_snr_sweep.py``'s stream: ``default_rng(1)``, the
payload, then one noise draw per point) through ``rx_chain_count`` at each
SNR of ``range(*--snrs)``: ms/batch (median and quartiles of ``--reps``
warmed calls, CUDA events on the card), packets/s, ``n_ok``/``n_det``,
the decode tiers taken (``fast``, ``tile<k>``, ``win<k>``, ``full``; ``dd``
when the decision-directed pass ran) and the launches of K1/K2 in the
first call of each point, so the curve shows where the tiers hand over:
the algebraic fast path at high SNR, the row tiles in the middle and the
full sweep at the floor.

Prints one JSON line per point to stderr and writes all of them to
``--out``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools_torch import bench, timing  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--snrs", nargs=3, type=int, default=[16, 37, 2])
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf

    B = a.batch
    rng = np.random.default_rng(1)
    cfg, mpdu, _, wave = bench.bench_packet(rng)
    clean = bench.lay(wave, B)
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    rows = []
    for snr in range(*a.snrs):
        x = from_numpy_cf(bench.noisy(clean, rms, snr, rng)[None], dev)
        p = bench.run_point(PRX, cfg, len(mpdu), x, B, dev, a.reps)
        rows.append({"snr_db": snr, **p})
        bench.log(f"snr {snr:2d} dB: {p['ms_per_batch']:7.2f} ms/batch "
                  f"{p['pkt_per_s']:10,.0f} pkt/s  ok {p['n_ok']}/{B} "
                  f"det {p['n_det']}  path {p['path']}  K1 "
                  f"{p['launches']['acs_sweep']} K2 "
                  f"{p['launches']['traceback_sweep']}")
        del x
    out = timing.out_path("throughput_vs_snr.json", a.out)
    timing.write_json(out, {"config": f"VHT mcs7 1ss 500B B={B} one device",
                            "device": timing.device_info(dev),
                            "reps": a.reps, "points": rows})
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
