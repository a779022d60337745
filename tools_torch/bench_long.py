#!/usr/bin/env python3
"""Long-trellis throughput: VHT MCS0 4000 B payloads at a full batch,
decoded in chunks.

    python3 tools_torch/bench_long.py [B] [CHUNK] [--device cuda]
        [--reps 8] [--out results_torch/bench_long.json]

A VHT MCS0 A-MPDU of one 4038 B MPDU is a trellis of 32,318 steps
(``cfg.n_trellis`` is printed; K1 runs it padded to 32,320).
``rx_chain_count(chunk=CHUNK)`` decodes the B synced rows CHUNK at a time
(B = 1024, CHUNK = 128 by default), so the decoder's temporaries are a
chunk's: where rows leave the algebraic fast path, K1 writes (CHUNK, T,
2) int32 decision words, 4 x 2 x T bytes a row (~33 MB for 128 rows,
~265 MB for all 1024), beside the (CHUNK, T, 2) float32 LLR pairs it
reads; the stream itself (B x ~100k samples) is ~0.8 GB of float32 pairs
on the card. The stream: ``default_rng(1)``,
the payload, B copies with 900 Hz CFO and 240-sample gaps, 32 dB AWGN.

Prints one JSON line (ms/batch, packets/s, Msamples/s, counts, tiers,
kernel launches) and writes it to ``--out``.
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
    ap.add_argument("batch", type=int, nargs="?", default=1024)
    ap.add_argument("chunk", type=int, nargs="?", default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf

    B, chunk = a.batch, a.chunk
    rng = np.random.default_rng(1)
    cfg, mpdu, _, wave = bench.bench_packet(rng, n_payload=4000, mcs=0)
    bench.log(f"cfg: VHT mcs0 1ss, psdu {cfg.psdu_len} B, nsym {cfg.nsym}, "
              f"trellis {cfg.n_trellis}, wave {len(wave)}; B={B} "
              f"chunk={chunk}")
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    x = from_numpy_cf(bench.noisy(bench.lay(wave, B), rms, 32.0, rng)[None],
                      dev)
    p = bench.run_point(PRX, cfg, len(mpdu), x, B, dev, a.reps, chunk=chunk)
    ref = bench.ref_ceiling(cfg, llr_per_sym=52)
    blob = {"config": f"VHT mcs0 1ss 4000B (trellis {cfg.n_trellis}), "
                      f"B={B} chunk={chunk}, one device",
            "n_trellis": cfg.n_trellis, "device": timing.device_info(dev),
            "reps": a.reps, **p, "vs_ref_ceiling": p["pkt_per_s"] / ref}
    bench.log(f"{p['ms_per_batch']:.1f} ms/batch; {p['pkt_per_s']:,.0f} "
              f"pkt/s; {p['msamp_per_s']:.0f} Msamp/s; ok {p['n_ok']}/{B}; "
              f"det {p['n_det']}; path {sorted(set(p['path']))}; launches "
              f"{p['launches']}")
    timing.write_json(timing.out_path("bench_long.json", a.out), blob)
    print(json.dumps(blob))
    return 0


if __name__ == "__main__":
    sys.exit(main())
