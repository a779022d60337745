"""Entry of the two-antenna rx-daemon configuration: ``RxEngine(nrx=2)``
fed two-row daemon blocks, as ``rx_daemon.py --udp-iq P1 P2`` feeds it
(rx2.grc).

The blocks are driven as ``rx_engine_blocks`` drives one row (its
``Run``: ``begin_process`` then ``finish_process``, one block in flight,
the streamer's ownership rule, the blocks replayed in turn), from inputs
that ``generate_2x2.py`` makes.  The comparison is ``rx_engine_blocks.
judge``'s (packets held to what was sent, each NDP's (2, 2, 64) estimate
to the frozen receiver's at the program's own start and CFO) and one
number more, ``mimo_ref_missed`` (:func:`ref_missed`).
"""
from __future__ import annotations

import numpy as np

from .. import generate, generate_2x2
from ..reference import mimo_rx as MRX
from ..reference.params import Fmt, PhyConfig
from . import rx_engine_blocks as E


class Run(E.Run):
    """``rx_engine_blocks.Run`` on the two-row inputs of mix ``tr``."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device: str, pool,
                 control: bool = False, inputs: dict | None = None):
        super().__init__(cfg, tr, seed, device, pool, control=control,
                         inputs=inputs or generate_2x2.make(tr, cfg, seed,
                                                            pool))


def sent_cfg(f: dict) -> PhyConfig:
    return PhyConfig(Fmt(f["fmt"]), f["mcs"], f["nss"], f["length"],
                     ampdu=f["ampdu"])


def ref_missed(views, sent, outputs) -> tuple[int, dict]:
    """The sent 2-stream data packets that the program reports, not ok or
    not with every MPDU sent, and that the plain float64 reference
    (``reference/mimo_rx.py``) decodes to the PSDU sent at the program's
    own start and CFO; each counted once however many replays show it.
    The reference runs on these packets only.  Returns (that count,
    readings: how many 2-stream data packets the program missed, and of
    those how many the reference missed too)."""
    misses: dict = {}
    for k, res in outputs:
        starts = [s for s, _ in sent[k]]
        got = E._pair(res, np.array(starts, np.int64))
        for j, (_, f) in enumerate(sent[k]):
            rs = got.get(j, [])
            if f["is_ndp"] or f["nss"] != 2 or len(rs) != 1:
                continue
            r = rs[0]
            if not (r["ok"] and r["mpdus"] == f["mpdus"]):
                misses.setdefault((k, j), r)
    groups: dict = {}
    for (k, j), r in misses.items():
        groups.setdefault(sent_cfg(sent[k][j][1]), []).append((k, j, r))
    decoded = 0
    for cfg, items in groups.items():
        out = MRX.decode_at([views[k] for k, _, _ in items],
                            [r["start"] for _, _, r in items],
                            [r["cfo_hz"] for _, _, r in items], cfg)
        for (k, j, _), pb in zip(items, out["psdu"]):
            f = sent[k][j][1]
            psdu, _ = generate._psdu(cfg.fmt, f["mpdus"])
            decoded += pb[: cfg.length] == psdu
    return decoded, {"mimo_2ss_undecoded": len(misses),
                     "mimo_ref_also_undecoded": len(misses) - decoded}


def judge(views, sent, lctx: int, block: int, outputs) -> dict:
    """``rx_engine_blocks.judge``, plus ``mimo_ref_missed`` among the
    compared numbers (limit 0: at the program's own sync a float64
    receiver should lose nothing the program keeps) and its readings."""
    j = E.judge(views, sent, lctx, block, outputs)
    missed, readings = ref_missed(views, sent, outputs)
    j["numbers"]["mimo_ref_missed"] = missed
    j["readings"].update(readings)
    return j


def check(run: Run) -> dict:
    return judge(run.inputs["views"], run.inputs["sent"], run.lctx,
                 run.block, run.outputs())
