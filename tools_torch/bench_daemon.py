#!/usr/bin/env python3
"""Sustained streaming-daemon throughput: the highest lossless ingest rate.

    python3 tools_torch/bench_daemon.py [--rates 20,40,60,80,120,160,220,300]
        [--seconds 12] [--block 524288] [--halo 16384] [--pkts 200]
        [--resident-blocks 10] [--device cuda]
        [--out results_torch/daemon_throughput.json]

Measures the runtime path that takes the place of the reference's
flowgraph, on a capture of ``--pkts`` VHT MCS7 500 B packets (700 Hz CFO,
32 dB, 400-sample gaps; ``default_rng(5)``):

1. resident: one block (the capture tiled to ``--block`` + 16384 samples)
   staged once as bfloat16 on the device, then ``RxEngine(ingest="bf16")
   .process_device`` (front end + bucketed decode) on it
   ``--resident-blocks`` times, host clock: the engine's block rate
   without ingest;
2. the rate ladder: the capture replayed whole, k times, into a native
   ``IqRing(1 << 24)`` by a rate-controlled writer (1<<16-sample writes,
   never ahead of the target sample clock) on this thread, an
   ``RxStreamer`` (int8 ingest, overlap-save blocks, one block in flight)
   decoding on its own thread. A rung is lossless when no ring write was
   short (no sample dropped) and every packet passed the FCS after the
   drain; the ladder climbs until the first lossy rung, after a warm-up
   run at 5 Msamples/s (or the first rung's rate, if lower).

The reference's real-time claim is 20 Msamples/s. Where even the lowest
rung is lossy, ``max_lossless`` is null. Writes the runs, and the
kernels' launch counts and K1/K2's launch shapes over all of them, to
``--out`` and prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools_torch import bench, timing  # noqa: E402

RESIDENT_HALO = 16384


def make_capture(n_pkts=200, snr_db=32.0, seed=5):
    """(capture complex64, n_pkts): ``n_pkts`` VHT MCS7 500 B packets."""
    from gr_ieee80211_tpu_torch.gold import channel, mac, tx
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    rng = np.random.default_rng(seed)
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    psdu = mac.ampdu_aggregate_vht([mac.qos_data_frame(payload, *bench.ADDR,
                                                       7)])
    cfg = PhyConfig(Fmt.VHT, 7, 1, len(psdu), ampdu=True)
    wave = channel.apply_cfo(tx.tx_waveform(cfg, psdu, group_id=0,
                                            partial_aid=0)[0], 700.0)
    spacing = len(wave) + 400
    cap = np.zeros(n_pkts * spacing + 1024, np.complex64)
    for i in range(n_pkts):
        cap[512 + i * spacing: 512 + i * spacing + len(wave)] = wave
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    cap += (rng.normal(size=len(cap)) + 1j * rng.normal(size=len(cap))
            ).astype(np.complex64) * (rms / 10 ** (snr_db / 20) / np.sqrt(2))
    return cap.astype(np.complex64), n_pkts


def run_resident(cap, block_len, n_blocks, dev):
    """The engine's block rate on one device-resident bfloat16 block."""
    from gr_ieee80211_tpu_torch.models.rx import RxEngine
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf_bf16
    block = np.tile(cap, -(-block_len // len(cap)) + 1)[
        : block_len + RESIDENT_HALO]
    x = from_numpy_cf_bf16(block[None], dev)
    eng = RxEngine(nrx=1, ingest="bf16", device=dev)
    res = eng.process_device(x, len(block))        # warm-up
    n_pkt, n_ok = len(res), sum(1 for r in res if r.ok)
    tic = time.perf_counter()
    for _ in range(n_blocks):
        eng.process_device(x, len(block))
    dt = (time.perf_counter() - tic) / n_blocks
    return {"block_len": block_len, "ms_per_block": dt * 1e3,
            "pkts_per_block": n_pkt, "ok_per_block": n_ok,
            "msps": block_len / dt / 1e6, "pkt_per_s": n_ok / dt}


def run_rate(cap, pkts_per_cap, rate_msps, seconds, block_len, halo, dev,
             ingest="i8"):
    """One rung: feed the capture at ``rate_msps`` for ``seconds``."""
    from gr_ieee80211_tpu_torch.models.rx import RxEngine
    from gr_ieee80211_tpu_torch.runtime import native as NAT
    from gr_ieee80211_tpu_torch.runtime.streaming import RxStreamer
    ring = NAT.IqRing(1 << 24)
    streamer = RxStreamer(ring, RxEngine(nrx=1, ingest=ingest, device=dev),
                          block_len=block_len, halo=halo, poll_s=0.002)
    streamer.start()
    rate = rate_msps * 1e6
    chunk = 1 << 16
    n_caps = max(1, int(rate * seconds / len(cap)))
    dropped = fed = 0
    tic = time.perf_counter()
    try:
        for _ in range(n_caps):
            for off in range(0, len(cap), chunk):
                piece = cap[off: off + chunk]
                # rate control: never run ahead of the target sample clock
                while fed > (time.perf_counter() - tic) * rate:
                    time.sleep(0.0005)
                w = ring.write(piece)
                dropped += len(piece) - w     # ring full: the rest is lost
                fed += w                      # accepted samples only
        feed_s = time.perf_counter() - tic
        streamer.stop(drain=True, timeout=600)
        streamer.join(timeout=600)
        if streamer.is_alive() or streamer.error is not None:
            raise RuntimeError(f"streamer at {rate_msps} Msps did not drain: "
                               f"{streamer.error!r}")
    finally:
        streamer.stop()
        streamer.join(timeout=60)
        ring.close()
    expected = n_caps * pkts_per_cap
    return {"rate_msps": rate_msps, "seconds_fed": feed_s,
            "samples_fed": fed, "samples_dropped": dropped,
            "blocks": streamer.n_blocks, "pkts_expected": expected,
            "pkts_detected": streamer.n_packets, "pkts_ok": streamer.n_ok,
            "achieved_msps": fed / feed_s / 1e6,
            "pkt_per_s": streamer.n_ok / feed_s,
            "lossless": dropped == 0 and streamer.n_ok == expected}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rates", default="20,40,60,80,120,160,220,300")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--block", type=int, default=1 << 19)
    ap.add_argument("--halo", type=int, default=16384)
    ap.add_argument("--pkts", type=int, default=200)
    ap.add_argument("--resident-blocks", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)

    cap, pkts = make_capture(n_pkts=a.pkts)
    bench.log(f"capture: {len(cap) / 1e6:.2f} M samples, {pkts} pkts")
    rates = [float(x) for x in a.rates.split(",")]

    def runs_on_card():
        resident = run_resident(cap, a.block, a.resident_blocks, dev)
        bench.log(f"resident block processing: {resident}")
        # the first blocks warm the allocator and the per-config constants
        warm = run_rate(cap, pkts, min(5.0, rates[0]),
                        max(2.0, a.seconds / 6), a.block, a.halo, dev)
        bench.log(f"warm-up: {warm}")
        runs, best = [], None
        for r in rates:
            res = run_rate(cap, pkts, r, a.seconds, a.block, a.halo, dev)
            runs.append(res)
            bench.log(f"rate {r} Msps: {res}")
            if not res["lossless"]:
                break
            best = res
        return resident, warm, runs, best
    (resident, warm, runs, best), moved = timing.with_counters(runs_on_card,
                                                               dev)
    kern = timing.kernel_launches(moved)
    bench.log(f"kernel launches (resident, warm-up and rungs): "
              f"{kern['launches']}")
    out = timing.out_path("daemon_throughput.json", a.out)
    timing.write_json(out, {
        "device": timing.device_info(dev), "block_len": a.block,
        "halo": a.halo, "capture_pkts": pkts, "payload": 500, "mcs": "VHT7",
        "resident_block_processing": resident,
        "ingest": "i8 (2 B a sample, block-AGC quantization) + RxStreamer "
                  "with one block in flight (block k+1's upload and front "
                  "end queued before block k's decode finishes)",
        "warmup": warm, "max_lossless": best, "runs": runs, **kern,
        "reference_realtime_msps": 20,
        "note": "a rung feeds the capture at its rate from this process's "
                "main thread while the streamer decodes on another; the "
                "ring holds 1<<24 samples, so a rung above the engine's "
                "sustained block rate fills it and drops samples. "
                "max_lossless is null when the lowest rung already lost "
                "samples or packets."})
    print(json.dumps({"max_lossless_msps": best["rate_msps"] if best else None,
                      "pkt_per_s": best["pkt_per_s"] if best else None,
                      "resident_msps": resident["msps"], "out": str(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
