"""Entry of the rx-daemon configurations: ``RxEngine`` fed one daemon
block at a time, as ``tools_torch/rx_daemon.py`` and the streamer feed it.

Each block goes through ``begin_process`` (the upload from the host
included) and then ``finish_process``, one block in flight, and the
results are kept by the streamer's ownership rule: a block reports the
packets whose trigger lies in its own span (for block 0, from its first
sample; for the others, past the left context).  The blocks of the mix
are replayed in turn.

The comparison runs after the window: every result of every replay is
held to the packets the benchmark sent (their format, MCS, streams and
MPDU bytes), and each NDP's channel estimate to the frozen numpy
receiver's (``reference/rx.py``, float64; see :func:`judge`).
"""
from __future__ import annotations

import numpy as np

from .. import core, generate
from ..reference import rx as GRX
from ..reference.params import Fmt
from ..reference.tables import LTF_NL_GRID

#: the samples of a packet before its L-LTF index: L-STF and the GI2
#: (used only to pair a result with the packet it reports)
LTF_LEAD = 190
#: a result pairs with the sent packet whose start + LTF_LEAD is nearest,
#: if closer than this (packets are at least 300 samples apart)
PAIR_SAMPLES = 250
#: an NDP's estimate is also read against the reference's at the
#: reference's own sync where the two syncs agree to within this many
#: samples (a later window runs into the next symbol on the cyclically
#: shifted second stream); farther apart, they are counted
SYNC_AGREE = 4
#: NDP channel estimates are held to the reference's at the program's
#: own start and CFO, over the L-STF..VHT-LTF span
NDP_SPAN = 208 + 160 + 80 + 80 * 2 + 64


class Run:
    """One run of the entry: the inputs of mix ``tr`` from ``seed``, the
    engine of configuration ``cfg`` on ``device`` (``control=True`` applies
    the configuration's ``control`` overrides: its lower-precision path;
    ``inputs`` reuses another run's)."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device: str, pool,
                 control: bool = False, inputs: dict | None = None):
        import torch
        from gr_ieee80211_tpu_torch.models.rx import RxEngine
        self.torch = torch
        self.inputs = inputs or generate.make(tr, cfg, seed, pool)
        geo = cfg["blocks"]
        self.block, self.lctx = (geo["owned_samples"],
                                 geo["left_context_samples"])
        opts = dict(cfg["engine"])
        if control:
            opts.update(cfg["control"]["engine"])
        self.eng = RxEngine(nrx=cfg["nrx"], device=device, **opts)
        self.cuda = self.eng.device.type == "cuda"
        self.n = len(self.inputs["views"])
        self.i = 0
        self.out: list[tuple[int, list]] = []

    def _block(self, k: int) -> list:
        h = self.eng.begin_process(self.inputs["views"][k])
        res = self.eng.finish_process(h)
        if self.cuda:
            self.torch.cuda.synchronize()
        return res

    def warm(self):
        """One pass over every block: every shape the window will use."""
        for k in range(self.n):
            self._block(k)

    def step(self) -> float:
        """Decode the next block in turn; returns its host seconds."""
        import time
        k = self.i % self.n
        with self.torch.profiler.record_function("entry:block"):
            tic = time.perf_counter()
            res = self._block(k)
            dt = time.perf_counter() - tic
        lo = 0 if k == 0 else self.lctx
        self.out.append((k, [r for r in res
                             if lo <= r.trig < self.lctx + self.block]))
        self.i += 1
        return dt

    def end_to_end(self, secs: list[float], wall: float) -> dict:
        return {"msamples_per_s": {
                    "value": len(secs) * self.block / wall / 1e6,
                    "unit": "Msamples/s"},
                "block_ms_p90": {"value": 1e3 * core.percentile(secs, 90),
                                 "unit": "ms"}}

    def free(self):
        """Drop the engine and its device state before the reference."""
        self.eng = None
        if self.cuda:
            self.torch.cuda.empty_cache()

    def outputs(self) -> list[tuple[int, list[dict]]]:
        return [(k, [as_fields(r) for r in res]) for k, res in self.out]


def as_fields(r) -> dict:
    return {"start": int(r.start), "ok": bool(r.ok), "fmt": int(r.fmt),
            "mcs": int(r.mcs), "nss": int(r.nss), "is_ndp": bool(r.is_ndp),
            "mpdus": list(r.mpdus), "psdu_len": len(r.psdu),
            "cfo_hz": float(r.cfo_hz), "snr_db": float(r.snr_db),
            "rssi": float(r.rssi),
            "ndp_chan": None if r.ndp_chan is None
            else np.asarray(r.ndp_chan)}


def reference_sync(x: np.ndarray, sent_start: int):
    """The frozen receiver's own sync of the packet the benchmark put at
    ``sent_start`` of row ``x`` (complex128): its STF trigger, searched
    from a little before that sample, its L-LTF index and fine CFO; None
    where it finds none."""
    lo = max(sent_start - 200, 0)
    w = x[lo: sent_start + 800]
    m, _ = GRX.stf_metric(w)
    trigs = GRX.find_triggers(m)
    if not trigs:
        return None
    trig = lo + trigs[0]
    sync = GRX.ltf_sync(x, trig + 80)
    if sync is None:
        return None
    start = sync[0]
    return start, float(GRX.fine_cfo(x, start, GRX.coarse_cfo(x, trig, 64)))


def ndp_channel_at(view: np.ndarray, start: int, cfo_hz: float,
                   nsts: int) -> np.ndarray:
    """The reference's NDP channel estimate (nrx, nsts, 64) at a given sync
    position and CFO."""
    x = view.astype(np.complex128)
    xs = np.stack([GRX.derotate(x[r], start, min(NDP_SPAN, x.shape[1] - start),
                                cfo_hz) for r in range(x.shape[0])])
    nltf = 2 if nsts == 2 else 1
    return GRX.nl_chan_est(GRX._nl_ltf_grids(xs, 448, nltf), nsts, Fmt.VHT)


def shifted(h: np.ndarray, samples: int) -> np.ndarray:
    """A channel estimate (..., 64 fftshifted bins) as it reads from FFT
    windows ``samples`` later: bin k turns by exp(2 pi j k samples / 64)."""
    k = np.arange(64) - 32
    return h * np.exp(2j * np.pi * k * samples / 64)


def _pair(results: list[dict], starts: np.ndarray) -> dict:
    """sent index (or -1 - i for unpaired result i) -> [results]."""
    out: dict[int, list[dict]] = {}
    for i, r in enumerate(results):
        j = int(np.argmin(np.abs(starts + LTF_LEAD - r["start"]))) \
            if len(starts) else -1
        if j < 0 or abs(starts[j] + LTF_LEAD - r["start"]) >= PAIR_SAMPLES:
            j = -1 - i
        out.setdefault(j, []).append(r)
    return out


def judge(views, sent, lctx: int, block: int, outputs) -> dict:
    """Hold every replay's results to what was sent and to the reference.

    Compared (each with its limit, by the caller), each packet counted
    once however many replays show it:

    * ``packets_lost``: sent packets reported not once (never, or twice);
    * ``packets_misreported``: results whose format, MCS, streams or NDP
      flag differ from the packet sent, or that carry an MPDU that was not
      sent (a result pairing with no sent packet included, if ok);
    * ``data_undecoded_share``: the share of sent data packets whose
      result is not ok with every MPDU sent;
    * ``ndp_chan_rel_err``: the largest gap between an NDP's channel
      estimate and the reference's at the program's own start and CFO,
      over the reference's largest magnitude.

    Readings, not compared (see PERF.md): ``ndp_chan_rel_err_ref_sync``,
    the same gap against the reference's estimate at its own sync, turned
    to the program's start, over the occupied bins of the NDPs whose two
    starts lie within SYNC_AGREE (the largest, and the median of each
    NDP's largest: ``..._median``); ``ndp_sync_disagreements``, the NDPs
    where the starts do not.  Also ``attempted`` (sent packets handed over, all
    replays) and ``failed`` (those lost, misreported or undecoded)."""
    lost, wrong, undecoded = set(), set(), set()
    n_data = 0
    for k in {k for k, _ in outputs}:
        n_data += sum(1 for _, f in sent[k] if not f["is_ndp"])
    ndp_err = 0.0
    witness: dict = {}
    disagree = set()
    attempted = failed = 0
    at_prog: dict = {}
    at_ref: dict = {}
    occ = LTF_NL_GRID != 0
    for k, res in outputs:
        starts = np.array([s for s, _ in sent[k]], np.int64)
        got = _pair(res, starts)
        attempted += len(starts)
        bad = set()
        for j, rs in got.items():
            if j < 0:
                wrong.update((k, "unsent", r["start"]) for r in rs if r["ok"])
                continue
            f = sent[k][j][1]
            for r in rs:
                if ((r["fmt"], r["mcs"], r["nss"], r["is_ndp"])
                        != (f["fmt"], f["mcs"], f["nss"], f["is_ndp"])
                        or any(m not in f["mpdus"] for m in r["mpdus"])):
                    wrong.add((k, j))
                    bad.add(j)
        for j, (s0, f) in enumerate(sent[k]):
            rs = got.get(j, [])
            if len(rs) != 1:
                lost.add((k, j))
                bad.add(j)
                continue
            r = rs[0]
            if not f["is_ndp"] and not (r["ok"] and r["mpdus"] == f["mpdus"]):
                undecoded.add((k, j))
                bad.add(j)
            if not (r["is_ndp"] and r["ndp_chan"] is not None):
                continue
            key = (k, r["start"], r["cfo_hz"], r["nss"])
            if key not in at_prog:
                at_prog[key] = ndp_channel_at(views[k], *key[1:])
            h = at_prog[key]
            ndp_err = max(ndp_err, float(np.abs(r["ndp_chan"] - h).max()
                                         / max(np.abs(h).max(), 1e-30)))
            if (k, j) not in at_ref:
                at_ref[(k, j)] = reference_sync(
                    views[k][0].astype(np.complex128), s0)
            own = at_ref[(k, j)]
            if own is None or abs(own[0] - r["start"]) > SYNC_AGREE:
                disagree.add((k, j))
                continue
            g = shifted(ndp_channel_at(views[k], own[0], own[1], r["nss"]),
                        r["start"] - own[0])
            gap = float(np.abs(r["ndp_chan"] - g)[..., occ].max()
                        / max(np.abs(g[..., occ]).max(), 1e-30))
            witness[(k, j)] = max(witness.get((k, j), 0.0), gap)
        failed += len(bad)
    return {"numbers": {"packets_lost": len(lost),
                        "packets_misreported": len(wrong),
                        "data_undecoded_share": len(undecoded) / max(n_data, 1),
                        "ndp_chan_rel_err": ndp_err},
            "readings": {"ndp_chan_rel_err_ref_sync":
                         max(witness.values(), default=0.0),
                         "ndp_chan_rel_err_ref_sync_median":
                         float(np.median(list(witness.values())))
                         if witness else 0.0,
                         "ndp_sync_disagreements": len(disagree)},
            "attempted": attempted, "failed": failed}


def check(run: Run) -> dict:
    """Judge the window's outputs against the packets sent and the frozen
    reference (in this process: only the NDPs need the reference)."""
    return judge(run.inputs["views"], run.inputs["sent"], run.lctx,
                 run.block, run.outputs())
