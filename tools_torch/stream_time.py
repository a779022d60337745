#!/usr/bin/env python3
"""Where the streamer's time goes beside the engine's own.

    python3 tools_torch/stream_time.py [ROUNDS]

Decodes ``chip_smoke.py``'s engine (b) stream (16 blocks of 1<<19 + 16384
samples: mixed traffic, and two homogeneous stretches that arm the
speculative path) on the card in five ways, in turns, ROUNDS times
(default 2), each with a fresh ``RxEngine`` after one untimed pass has
warmed the per-config constants:

* ``serial``: ``chip_smoke.run_blocks`` on the main thread, begin and
  finish of each block back to back (engine (b)'s protocol);
* ``thread``: the same loop on a worker thread;
* ``inflight``: the streamer's order on the main thread, without a ring:
  ``begin_process(k)`` before ``finish_process(k-1)``;
* ``streamer``: ``RxStreamer`` over a native ``IqRing`` fed as
  ``rx_daemon.py --file`` feeds it;
* ``reported``: the same with ``PhyRxReporter`` sending every MPDU to a
  MAC listener thread (``chip_smoke.py`` (h1)).

Prints one JSON line per round and way (ms per block, each block's ms,
which blocks ran the speculative one-pass decode, results owned) and a
last line with each way's median.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def run_inflight(CS, eng, stream):
    """The streamer's pipelining without its ring: block k is begun
    before block k-1 is finished; (owned results, kinds, block ms)."""
    import numpy as np
    import torch
    lctx = np.zeros(CS.LCTX, np.complex64)
    out, kinds, done, pending = [], [], [], None
    t0 = time.perf_counter()

    def finish(p):
        handle, k = p
        lo = 0 if k == 0 else CS.LCTX
        res = eng.finish_process(handle)
        torch.cuda.synchronize()
        done.append(time.perf_counter())
        out.extend(r for r in res if lo <= r.trig < CS.LCTX + CS.BLOCK)

    for k in range(CS.N_BLOCKS):
        block = stream[k * CS.BLOCK: k * CS.BLOCK + CS.BLOCK + CS.HALO]
        view = np.concatenate([lctx, block])[None]
        lctx = block[CS.BLOCK - CS.LCTX: CS.BLOCK]
        handle = eng.begin_process(view)
        kinds.append(handle[2][0])
        if pending is not None:
            finish(pending)
        pending = (handle, k)
    finish(pending)
    return out, kinds, list(np.diff([t0] + done) * 1e3)


def run_streamer(CS, PRX, NAT, RS, U, stream, report: bool):
    """``chip_smoke.replay`` (phase (h1)'s streamer), with or without the
    reporter and its listener."""
    import numpy as np
    eng = CS.ClockedEngine(PRX.RxEngine(nrx=1, device="cuda"))
    got = []
    mac = CS.MacListener() if report else None
    try:
        _, t0 = CS.replay(NAT, RS, U, eng, stream, "stream_time", mac,
                          got.append)
    finally:
        if mac is not None:
            mac.close()
    n = CS.N_BLOCKS
    return got, eng.kinds[:n], list(np.diff([t0] + eng.done[:n]) * 1e3)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stream_time: needs a CUDA card", file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as CS
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.runtime import native as NAT
    from gr_ieee80211_tpu_torch.runtime import streaming as RS
    from gr_ieee80211_tpu_torch.runtime import udp_phy as U
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    if not NAT.available():
        raise RuntimeError("the native runtime (libphyrt) did not load")
    stream, sent = CS.daemon_stream(np.random.default_rng(23))

    def serial():
        got, kinds, secs = CS.run_blocks(PRX.RxEngine(nrx=1), stream,
                                         CS.N_BLOCKS)
        return got, kinds, [1e3 * s for s in secs]

    def thread():
        box = {}
        th = threading.Thread(target=lambda: box.update(r=serial()))
        th.start()
        th.join()
        return box["r"]

    ways = {"serial": serial, "thread": thread,
            "inflight": lambda: run_inflight(CS, PRX.RxEngine(nrx=1),
                                              stream),
            "streamer": lambda: run_streamer(CS, PRX, NAT, RS, U, stream,
                                             False),
            "reported": lambda: run_streamer(CS, PRX, NAT, RS, U, stream,
                                             True)}
    serial()                                # warm-up, not timed
    per_way = {w: [] for w in ways}
    for r in range(rounds):
        order = list(ways) if r % 2 == 0 else list(ways)[::-1]
        for w in order:
            got, kinds, block_ms = ways[w]()
            if len(got) != len(sent) or not all(g.ok for g in got):
                raise RuntimeError(f"{w}: {len(got)} results, "
                                   f"{len(sent)} sent")
            ms = float(np.mean(block_ms))
            per_way[w].append(ms)
            print(json.dumps({"way": w, "round": r, "ms_per_block": ms,
                              "block_ms": [round(x, 1) for x in block_ms],
                              "kinds": kinds, "results": len(got)}),
                  flush=True)
    print(json.dumps({"median_ms_per_block": {
        w: statistics.median(v) for w, v in per_way.items()},
        "rounds": rounds, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
