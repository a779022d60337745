#!/usr/bin/env python3
"""Transmit throughput: batched waveform synthesis on the device.

    python3 tools_torch/bench_tx.py [B] [--mu] [--device cuda] [--reps 50]
        [--out results_torch/bench_tx.json]

``tx_batch`` of B (default 4096) VHT MCS7 1 SS A-MPDUs of one 530 B MPDU
(a 500 B payload from ``default_rng(3)``, as ``tools_tpu/bench_tx.py``),
scrambler seeds 1..127 in turn; with ``--mu``, ``tx_batch_mu`` of B
two-user PPDUs (both MCS7, the second user's MPDU from the payload's first
300 bytes) through a random (64, 2, 2) Q.  The payloads, seeds and Q are
on the device before the clock starts; each of ``--reps`` warmed calls is
timed on its own (CUDA events on the card), and the median gives
packets/s and samples/s. Packet 0 is held to the numpy gold model
(``max_abs_err_vs_gold``).

Prints one JSON line and merges it, under its metric's name, into
``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools_torch import bench, timing  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=4096)
    ap.add_argument("--mu", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    import torch
    from gr_ieee80211_tpu_torch.gold import mac, tx as gtx
    from gr_ieee80211_tpu_torch.models import tx as PTX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf, to_numpy
    from gr_ieee80211_tpu_torch.spec.params import Fmt, MuConfig, PhyConfig

    B = a.batch
    rng = np.random.default_rng(3)
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, *bench.ADDR, 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    seeds_np = (np.arange(B) % 127 + 1).astype(np.int64)
    seeds = torch.from_numpy(seeds_np).to(dev)

    def tile(psdu):
        return torch.from_numpy(np.tile(np.frombuffer(psdu, np.uint8),
                                        (B, 1))).to(dev)
    if a.mu:
        mpdu1 = mac.qos_data_frame(payload[:300], "02:00:00:00:00:11",
                                   "00:c0:ca:b1:5b:e1", "02:00:00:00:00:11",
                                   8)
        am1 = mac.ampdu_aggregate_vht([mpdu1])
        mu = MuConfig((PhyConfig(Fmt.VHT, 7, 1, len(am), ampdu=True),
                       PhyConfig(Fmt.VHT, 7, 1, len(am1), ampdu=True)),
                      group_id=2)
        q_np = (rng.normal(size=(64, 2, 2))
                + 1j * rng.normal(size=(64, 2, 2))) / np.sqrt(2)
        q = from_numpy_cf(q_np, dev)
        pays = (tile(am), tile(am1))
        metric = "tx_mu_2user_ppdus_per_s_per_chip_vht_mcs7"
        unit = "PPDUs/s"

        def call():
            return PTX.tx_batch_mu(mu, pays, seeds, q)
        gold = gtx.tx_waveform_mu(mu, [am, am1], q_np, seed=int(seeds_np[0]))
    else:
        cfg = PhyConfig(Fmt.VHT, 7, 1, len(am), ampdu=True)
        arr = tile(am)
        metric = "tx_synthesis_packets_per_s_per_chip_vht_mcs7_500B"
        unit = "packets/s"

        def call():
            return PTX.tx_batch(cfg, arr, seeds)
        gold = gtx.tx_waveform(cfg, am, seed=int(seeds_np[0]), group_id=0,
                               partial_aid=0)
    wave0 = to_numpy(call()[0:1])[0]
    n_samp = wave0.shape[-1]
    err = float(np.abs(wave0 - gold).max())
    t = timing.call_ms(call, dev, a.reps)
    dt = t["median_ms"] / 1e3
    bench.log(f"{t['median_ms']:.3f} ms/batch of {B} (q1 {t['q1_ms']:.3f}, "
              f"q3 {t['q3_ms']:.3f}); wave {n_samp} samples/pkt; packet 0 "
              f"within {err:.2e} of the gold model")
    blob = {"metric": metric, "value": B / dt, "unit": unit,
            "samples_per_s": B * n_samp / dt, "ms_per_batch": t["median_ms"],
            "q1_ms": t["q1_ms"], "q3_ms": t["q3_ms"], "batch": B,
            "samples_per_packet": n_samp, "max_abs_err_vs_gold": err,
            "device": timing.device_info(dev)}
    print(json.dumps(blob))
    path = timing.out_path("bench_tx.json", a.out)
    cur = json.loads(path.read_text()) if path.exists() else {}
    cur[metric] = blob
    timing.write_json(path, cur)
    return 0


if __name__ == "__main__":
    sys.exit(main())
