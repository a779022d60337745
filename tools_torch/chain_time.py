#!/usr/bin/env python3
"""Time warmed ``rx_chain_count`` calls, or engine (b)'s daemon blocks,
of one tree on the streams of ``chip_smoke.py``.

    python3 tools_torch/chain_time.py make STREAMS.npz
    python3 tools_torch/chain_time.py time STREAMS.npz [ROOT] [REPS]
    python3 tools_torch/chain_time.py engine STREAMS.npz [ROOT] [REPS]
    python3 tools_torch/chain_time.py sync STREAMS.npz [ROOT] [REPS]

``make`` writes the 4096-packet VHT MCS7 500 B streams of
``chip_smoke.py`` (32 dB and 18 dB) and engine (b)'s 16-block daemon
stream once.  ``time`` imports the port from the tree at ROOT (default:
this checkout), runs the chain REPS times per operating point after two
warm-up calls, host clock around each call ending in a synchronize, and
prints one JSON line with the medians and quartiles in ms.  ``engine``
runs ``chip_smoke.run_blocks`` over the daemon stream with a fresh
speculating ``RxEngine`` of the tree at ROOT, one untimed pass and then
REPS (default 3) timed ones, and prints the median ms per block.
``sync`` times the engine's LTF timing + CFO stage alone
(``models.rx._sync_core`` on the 4096 triggers of the 18 dB stream), REPS
(default 50) warmed calls.  To compare two commits, unpack the other one beside
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
    daemon, sent = CS.daemon_stream(np.random.default_rng(23))
    np.savez(path, hi=streams[CS.SNR_HI], lo=streams[CS.SNR_LO],
             cfg=np.array([int(cfg.fmt), cfg.mcs, cfg.nss, cfg.length,
                           int(cfg.ampdu)]),
             mpdu_len=len(mpdu), n_pkts=CS.B, daemon=daemon,
             n_sent=len(sent))
    return 0


def engine(path: str, root: str, reps: int) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chain_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as CS                 # imports no port module
    sys.path.insert(0, root)
    from gr_ieee80211_tpu_torch.models import rx as PRX
    data = np.load(path)
    stream, n_sent = data["daemon"], int(data["n_sent"])
    ms = []
    for i in range(reps + 1):
        got, _, secs = CS.run_blocks(PRX.RxEngine(nrx=1, speculate=True),
                                     stream)
        if len(got) != n_sent or not all(r.ok for r in got):
            raise RuntimeError(f"{len(got)} results, {n_sent} sent")
        if i >= 1:
            ms.append(1e3 * sum(secs) / CS.N_BLOCKS)
    print(json.dumps({"root": root, "reps": reps,
                      "card": torch.cuda.get_device_name(0),
                      "engine_b_ms_per_block": statistics.median(ms),
                      "passes_ms_per_block": ms}))
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


def sync(path: str, root: str, reps: int) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chain_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import CF, from_numpy_cf
    x = from_numpy_cf(np.load(path)["lo"][None], torch.device("cuda", 0))
    x = CF(x.re[0], x.im[0])
    trigs = torch.from_numpy(PRX.RxEngine(nrx=1).detect(x).astype(
        np.int32)).cuda()
    ms = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        PRX._sync_core(x, trigs)
        torch.cuda.synchronize()
        if i >= 2:
            ms.append(1e3 * (time.perf_counter() - tic))
    q = statistics.quantiles(ms, n=4)
    print(json.dumps({"root": root, "reps": reps, "n_trigs": len(trigs),
                      "card": torch.cuda.get_device_name(0),
                      "sync_core_median_ms": statistics.median(ms),
                      "q1_ms": q[0], "q3_ms": q[2]}))
    return 0


def main(argv) -> int:
    if len(argv) >= 3 and argv[1] == "make":
        return make(argv[2])
    if len(argv) >= 3 and argv[1] == "time":
        root = str(Path(argv[3]).resolve()) if len(argv) > 3 else str(HERE)
        return timed(argv[2], root, int(argv[4]) if len(argv) > 4 else 15)
    if len(argv) >= 3 and argv[1] == "engine":
        root = str(Path(argv[3]).resolve()) if len(argv) > 3 else str(HERE)
        return engine(argv[2], root, int(argv[4]) if len(argv) > 4 else 3)
    if len(argv) >= 3 and argv[1] == "sync":
        root = str(Path(argv[3]).resolve()) if len(argv) > 3 else str(HERE)
        return sync(argv[2], root, int(argv[4]) if len(argv) > 4 else 50)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv))
