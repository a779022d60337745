#!/usr/bin/env python3
"""Time warmed ``rx_chain_count`` calls of one tree on the bench stream.

    python3 tools_torch/chain_time.py make STREAMS.npz
    python3 tools_torch/chain_time.py time STREAMS.npz [ROOT] [REPS]

``make`` writes the 4096-packet VHT MCS7 500 B streams of
``chip_smoke.py`` (32 dB and 18 dB) once.  ``time`` imports the port from
the tree at ROOT (default: this checkout), runs the chain REPS times per
operating point after two warm-up calls, host clock around each call
ending in a synchronize, and prints one JSON line with the medians and
quartiles in ms.  To compare two commits, unpack the other one beside
this checkout and alternate ``time`` processes between the two roots
within one session on one card: the stream file is shared, and the
config class is taken from the tree under test.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def make(path: str) -> int:
    import numpy as np
    sys.path.insert(0, str(HERE))
    import chip_smoke as CS
    cfg, mpdu, _, _, streams = CS.bench_streams()
    np.savez(path, hi=streams[CS.SNR_HI], lo=streams[CS.SNR_LO],
             cfg=np.array([int(cfg.fmt), cfg.mcs, cfg.nss, cfg.length,
                           int(cfg.ampdu)]),
             mpdu_len=len(mpdu), n_pkts=CS.B)
    return 0


def timed(path: str, root: str, reps: int) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chain_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    data = np.load(path)
    fmt, mcs, nss, length, ampdu = (int(v) for v in data["cfg"])
    cfg = PRX.PhyConfig(PRX.Fmt(fmt), mcs, nss, length, ampdu=bool(ampdu))
    n_pkts, mpdu_len = int(data["n_pkts"]), int(data["mpdu_len"])
    out = {"root": root, "reps": reps,
           "card": torch.cuda.get_device_name(0)}
    for name in ("hi", "lo"):
        x = from_numpy_cf(data[name][None], torch.device("cuda", 0))
        ms, counts = [], None
        for i in range(reps + 2):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            res = PRX.rx_chain_count(cfg, x, mpdu_len=mpdu_len,
                                     max_pkts=n_pkts)
            counts = tuple(int(v) for v in res)
            torch.cuda.synchronize()
            if i >= 2:
                ms.append(1e3 * (time.perf_counter() - tic))
        q = statistics.quantiles(ms, n=4)
        out[name] = {"median_ms": statistics.median(ms), "q1_ms": q[0],
                     "q3_ms": q[2], "n_ok": counts[0], "n_det": counts[1]}
    print(json.dumps(out))
    return 0


def main(argv) -> int:
    if len(argv) >= 3 and argv[1] == "make":
        return make(argv[2])
    if len(argv) >= 3 and argv[1] == "time":
        root = str(Path(argv[3]).resolve()) if len(argv) > 3 else str(HERE)
        return timed(argv[2], root, int(argv[4]) if len(argv) > 4 else 15)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv))
