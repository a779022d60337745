"""Entry of the MU-MIMO station's rx-daemon configuration:
``RxEngine(nrx=1, mu_pos=, mu_gid=)`` fed one-row daemon blocks, as
``rx_daemon.py --mu-pos P --mu-gid G`` feeds it (GR-WiFi's cmu_v3
station: ``demod(mupos, mugid)``).

The blocks are driven as ``rx_engine_blocks`` drives them (its ``Run``:
``begin_process`` then ``finish_process``, one block in flight, the
streamer's ownership rule, the blocks replayed in turn; the engine's
options, the station's position and group included, are the
configuration's ``engine``), from inputs that ``generate_mu.py`` makes.
The comparison is ``rx_engine_blocks.judge``'s over the packets
addressed to the station (an MU PPDU of its group held to its own
user's MCS, stream and MPDUs), with two additions (:func:`judge`).
"""
from __future__ import annotations

import numpy as np

from .. import generate, generate_mu
from ..reference import mu_rx as MURX
from ..reference.params import Fmt
from . import rx_engine_blocks as E


class Run(E.Run):
    """``rx_engine_blocks.Run`` on the MU station's inputs of mix ``tr``."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device: str, pool,
                 control: bool = False, inputs: dict | None = None):
        super().__init__(cfg, tr, seed, device, pool, control=control,
                         inputs=inputs or generate_mu.make(tr, cfg, seed,
                                                           pool))


def foreign_reported(foreign, outputs) -> tuple[int, int]:
    """The other group's MU PPDUs that some result pairs with, each counted
    once however many replays show it: (all of them, those whose result
    is not ok).  ``rx_engine_blocks.judge`` already counts an ok one, as
    a result that pairs with no packet sent."""
    hit: dict = {}
    for k, res in outputs:
        starts = np.array(foreign[k], np.int64)
        if not len(starts):
            continue
        for r in res:
            d = np.abs(starts + E.LTF_LEAD - r["start"])
            if d.min() < E.PAIR_SAMPLES:
                key = (k, int(np.argmin(d)))
                hit[key] = hit.get(key, False) or r["ok"]
    return len(hit), sum(1 for ok in hit.values() if not ok)


def ref_missed(views, sent, outputs) -> tuple[int, dict]:
    """The MU PPDUs of the station's group that the program reports, not
    ok or not with every MPDU sent, and that the plain float64 reference
    (``reference/mu_rx.py``) decodes to the PSDU sent, its SERVICE check
    passing, at the program's own start and CFO; each counted once
    however many replays show it.  The reference runs on these PPDUs
    only.  Returns (that count, readings: how many MU PPDUs of the group
    the program missed, and of those how many the reference missed
    too)."""
    misses: dict = {}
    for k, res in outputs:
        got = E._pair(res, np.array([s for s, _ in sent[k]], np.int64))
        for j, (_, f) in enumerate(sent[k]):
            rs = got.get(j, [])
            if not f.get("mu") or len(rs) != 1:
                continue
            r = rs[0]
            if not (r["ok"] and r["mpdus"] == f["mpdus"]):
                misses.setdefault((k, j), r)
    decoded = 0
    for (k, j), r in misses.items():
        f = sent[k][j][1]
        (row,) = MURX.decode_at([views[k]], [r["start"]], [r["cfo_hz"]],
                                f["nsts_total"], f["own_stream"], f["nss"],
                                f["nsym"])
        psdu, _ = generate._psdu(Fmt.VHT, f["mpdus"])
        decoded += (row["cfg"] is not None and row["service_ok"]
                    and row["psdu"][: f["length"]] == psdu)
    return decoded, {"mu_own_undecoded": len(misses),
                     "mu_ref_also_undecoded": len(misses) - decoded}


def judge(views, sent, foreign, lctx: int, block: int, outputs) -> dict:
    """``rx_engine_blocks.judge``, with the other group's MU PPDUs that a
    result reports added to ``packets_misreported`` and to ``failed``
    (the station must report none of them, ok or not; each one handed
    over counts in ``attempted``), and ``mu_ref_missed`` among the
    compared numbers (limit 0: at the program's own sync a float64
    receiver should lose no MU PPDU the program keeps) with its
    readings."""
    j = E.judge(views, sent, lctx, block, outputs)
    n_foreign, n_not_ok = foreign_reported(foreign, outputs)
    j["numbers"]["packets_misreported"] += n_not_ok
    j["attempted"] += sum(len(foreign[k]) for k, _ in outputs)
    j["failed"] += n_foreign
    missed, readings = ref_missed(views, sent, outputs)
    j["numbers"]["mu_ref_missed"] = missed
    j["readings"].update(readings, mu_foreign_reported=n_foreign)
    return j


def check(run: Run) -> dict:
    return judge(run.inputs["views"], run.inputs["sent"],
                 run.inputs["foreign"], run.lctx, run.block, run.outputs())
