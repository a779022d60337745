#!/usr/bin/env python3
"""The two-antenna receive path held to the plain reference, and one pass
of a cell's results kept for a comparison between two trees.

    python3 tools_torch/mimo_check.py ref [--seed N] [--device cuda]
        [--out results_torch/mimo_ref_check.json] [--small]
    python3 tools_torch/mimo_check.py muref [--seed N] [--device cuda]
        [--out results_torch/mu_ref_check.json] [--small]
    python3 tools_torch/mimo_check.py dump --workload daemon_mixed_30dB
        --seed N --out FILE.npz [--root TREE] [--device cuda]
    python3 tools_torch/mimo_check.py same A.npz B.npz

* ``ref``: the inputs of cell ``daemon_2x2_mixed_30dB`` from the seed, one
  warm pass of ``RxEngine(nrx=2)`` over its blocks, then one pass in
  which every two-stream bucket's ``_payload_core`` call keeps its
  channel estimate (``ops.ofdm.payload_chanest``), its coded-order LLRs
  (``ops.ofdm.payload_demod``: K8 on the card), its equalized symbols
  where the twin runs (``ops.ofdm.zf_equalize``, on the CPU; K8 keeps
  them to itself) and its SERVICE and PSDU bits.  Each real row is then
  decoded by
  ``benchmark/reference/mimo_rx.py`` (float64, on the CPU) from the same
  view at the program's own start and CFO under the packet's own
  transmit vector, and the two compared: (a) the (2, 2, 64) estimates
  over the occupied tones, relative to the reference's largest
  magnitude; (b) the equalized symbols (where kept) and the LLRs of the
  packet's own symbols, taken back to the interleaved order through the
  inverse of the deinterleave / deparse permutation, relative to the
  reference's rms; (c) the SERVICE and PSDU
  bits, which must be equal wherever either decodes the PSDU sent.
  Prints the largest gaps, their medians over the rows and the rows
  whose bits differ (and whether either side decoded the packet), as
  one JSON line, and writes it to ``--out``; exits 1 where bits differ
  on a packet that either side decodes.
* ``muref``: the inputs of cell ``daemon_mu_sta_30dB`` from the seed, one
  warm pass of the station's ``RxEngine(nrx=1, mu_pos=, mu_gid=)`` over
  its blocks, then one pass in which every MU payload call
  (``_payload_core_mu``) keeps its rows' coded-order LLRs
  (``ops.ofdm.payload_demod``: K8 on the card) and every SIG-B pass
  (``_mu_sigb_core``) its bits.  Every MU PPDU of the station's group
  that a block owns is then decoded by ``benchmark/reference/mu_rx.py``
  (float64, on the CPU, in worker processes) at the program's own start
  and CFO, and the two compared: the SIG-B bits, the PSDU bytes, and
  the LLRs (where the reference's SIG-B gives the program's config)
  relative to the reference's rms.  Prints the largest and median LLR
  gaps, how many PPDUs each side decodes to the PSDU sent, and the
  PPDUs whose bits differ, as one JSON line, and writes it to
  ``--out``; exits 1 where the reference decodes a PPDU to the PSDU
  sent and the program does not.
* ``dump``: one pass of the cell's blocks (after a warm pass) through the
  engine of the tree ``--root`` (default this one), every kept result's
  fields, ``psdu`` and ``sssnr0`` included, into ``--out``; beside them,
  every ``_payload_core`` call's config, PSDU and SERVICE bits, FCS
  flags and ``sssnr0``, and the channel estimate its equalizer took
  (``ops.ofdm.payload_demod``'s ``h`` and ``pilot_h``, or on a tree
  without it ``equalize_and_demap``'s: the stage's own, or the dd pass's
  where that ran).
* ``same``: whether two dumps agree: every field, PSDU, SERVICE bit and
  FCS flag bit for bit; every ``sssnr0`` within ``SSSNR_DB``; every
  estimate of an L or two-stream call bit for bit, of a one-stream
  HT/VHT call (refined: K7 and its twin sum the tones in other orders)
  within ``REFINED_REL`` of the row's largest |h|.  Prints the largest
  ``sssnr0`` and refined gaps; exits 1 where a field differs or a gap
  passes its limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CELL_2X2 = "daemon_2x2_mixed_30dB"
CELL_MU = "daemon_mu_sta_30dB"
FIELDS = ("trig", "start", "ok", "fmt", "mcs", "nss", "is_ndp", "cfo_hz",
          "snr_db", "rssi", "sssnr0")
#: ``same``'s limits: dB on ``sssnr0``; a refined estimate's gap over the
#: row's largest |h| (the card test's limit for K7 against its twin)
SSSNR_DB = 0.01
REFINED_REL = 1e-5


def _cplx(x) -> np.ndarray:
    return x.re.cpu().numpy() + 1j * x.im.cpu().numpy()


def ref_pass(seed: int, device: str, small: bool = False):
    """(views, [one dict a two-stream bucket call: its rows' (exact
    config, start, CFO), the view's index, and what the program made]).
    ``small``: three blocks of 32768 owned samples (a check on the CPU)."""
    from benchmark import core, generate_2x2
    from benchmark.run import load_cell
    from gr_ieee80211_tpu_torch.models import rx as RX
    from gr_ieee80211_tpu_torch.ops import ofdm as OF
    from tools_torch import timing
    _, _, cfg, tr = load_cell(CELL_2X2)
    if small:
        cfg["blocks"].update(owned_samples=1 << 15, halo_samples=8192)
        tr["layout"]["n_blocks"] = 3
    with core.workers() as pool:
        inp = generate_2x2.make(tr, cfg, seed, pool)
    views = inp["views"]
    dev = timing.require_device(device)
    eng = RX.RxEngine(nrx=2, device=dev, **cfg["engine"])
    for v in views:
        eng.finish_process(eng.begin_process(v))

    kept: list[dict] = []
    cur: dict = {}
    orig = (RX.RxEngine._decode_bucket, RX._payload_core, OF.payload_chanest,
            OF.zf_equalize, OF.payload_demod)

    def bucket(self, d, canon, items, ltf_idx, cfo, *rest):
        if canon.nss == 2:
            cur["items"] = [(c, int(ltf_idx[i]), float(cfo[i]))
                            for i, c in items]
            cur["canon"] = canon
        try:
            return orig[0](self, d, canon, items, ltf_idx, cfo, *rest)
        finally:
            cur.clear()

    def payload(canon, *x, **k):
        out = orig[1](canon, *x, **k)
        if "items" in cur:
            kept.append(dict(cur, psdu=out["psdu"].cpu().numpy(),
                             service=out["service"].cpu().numpy()))
        return out

    def chan(*x, **k):
        h, ph = orig[2](*x, **k)
        if "items" in cur:
            cur["h"] = _cplx(h)
        return h, ph

    def zf(*x, **k):
        eq = orig[3](*x, **k)
        if "items" in cur:
            cur["eq"] = _cplx(eq)
        return eq

    def demod(*x, **k):
        coded = orig[4](*x, **k)
        if "items" in cur:
            cur["coded"] = coded.cpu().numpy()
        return coded

    (RX.RxEngine._decode_bucket, RX._payload_core, OF.payload_chanest,
     OF.zf_equalize, OF.payload_demod) = bucket, payload, chan, zf, demod
    try:
        for k, v in enumerate(views):
            cur_view = len(kept)
            eng.finish_process(eng.begin_process(v))
            for b in kept[cur_view:]:
                b["view"] = k
    finally:
        (RX.RxEngine._decode_bucket, RX._payload_core, OF.payload_chanest,
         OF.zf_equalize, OF.payload_demod) = orig
    return inp, kept


def _sent_psdu(sent, start: int) -> bytes | None:
    """The PSDU the generator sent at the packet a start pairs with."""
    from benchmark import generate
    from benchmark.entries import rx_engine_blocks as E
    for s0, f in sent:
        if abs(s0 + E.LTF_LEAD - start) < E.PAIR_SAMPLES:
            return generate._psdu(f["fmt"], f["mpdus"])[0]
    return None


def _ref_row(item) -> dict:
    """One row decoded by the reference (in a worker process): (window
    (2, n) from the program's start, CFO, transmit vector fields)."""
    import torch
    from benchmark.reference import mimo_rx as MRX
    from benchmark.reference.params import Fmt, PhyConfig
    torch.set_num_threads(1)
    win, cfo, (fmt, mcs, nss, length, ampdu) = item
    rc = PhyConfig(Fmt(fmt), mcs, nss, length, ampdu=ampdu)
    ref = MRX.decode_at([win], [0], [cfo], rc)
    return {k: ref[k][0].numpy() for k in ("h", "eq", "llr", "bits")}


def _interleaved(b: dict) -> np.ndarray:
    """A bucket's coded-order LLRs (B, nsym*ncbps) back in the equalizer's
    order, (B, nss, nsym*ncbpss): the inverse of the deinterleave /
    deparse permutation."""
    from gr_ieee80211_tpu_torch.ops import ofdm as OF
    c, coded = b["canon"], b["coded"]
    perm = OF._deint_deparse_perm(c.fmt, c.nbpscs, c.nss, c.nsym)
    out = np.empty_like(coded)
    out[:, perm] = coded
    return out.reshape(coded.shape[0], c.nss, -1)


def compare(inp: dict, kept: list[dict]) -> dict:
    from benchmark import core
    from benchmark.reference import mimo_rx as MRX
    from benchmark.reference.params import Fmt, PhyConfig
    occ = np.abs(MRX.T.LTF_NL_GRID) > 0
    views = inp["views"]
    rows, items = [], []
    for b in kept:
        for j, (c, li, cfo) in enumerate(b["items"]):
            rc = PhyConfig(Fmt(int(c.fmt)), c.mcs, c.nss, c.length,
                           ampdu=c.ampdu)
            rows.append((b, j, c, li, rc))
            items.append((views[b["view"]][:, li: li + MRX.n_need(rc)], cfo,
                          (int(c.fmt), c.mcs, c.nss, c.length, c.ampdu)))
    with core.workers() as pool:
        refs = pool.map(_ref_row, items, chunksize=4)
    h_gap, eq_gap, llr_gap, bad = [], [], [], []
    for b in kept:
        b["llr"] = _interleaved(b)
    for (b, j, c, li, rc), ref in zip(rows, refs):
        hr = ref["h"]
        h_gap.append(float(np.abs(b["h"][j] - hr)[..., occ].max()
                           / np.abs(hr[..., occ]).max()))
        if "eq" in b:
            er = ref["eq"]
            ep = b["eq"][j][:, : rc.nsym]
            eq_gap.append(float(np.abs(ep - er).max()
                                / np.sqrt(np.mean(np.abs(er) ** 2))))
        lr = ref["llr"].reshape(2, -1)
        lp = b["llr"][j].reshape(2, -1)[:, : lr.shape[1]]
        llr_gap.append(float(np.abs(lp - lr).max()
                             / np.sqrt(np.mean(lr ** 2))))
        bits = ref["bits"]
        pb = np.unpackbits(b["psdu"][j][: rc.psdu_len], bitorder="little")
        if not (np.array_equal(b["service"][j], bits[:16]) and
                np.array_equal(pb, bits[16: 16 + 8 * rc.psdu_len])):
            sent = _sent_psdu(inp["sent"][b["view"]], li)
            n = rc.length
            bad.append({"view": b["view"], "start": li,
                        "cfg": [int(c.fmt), c.mcs, c.nss, c.length],
                        "program_decodes": bytes(b["psdu"][j][:n]) == sent,
                        "reference_decodes": bytes(np.packbits(
                            bits[16: 16 + 8 * n], bitorder="little"))
                        == sent})

    def q(xs):
        return {"max": max(xs), "median": float(np.median(xs))} if xs \
            else None
    return {"buckets": len(kept), "rows": len(h_gap), "h_rel_gap": q(h_gap),
            "eq_rel_gap": q(eq_gap), "llr_rel_gap": q(llr_gap),
            "bits_differ": len(bad),
            "bits_differ_where_either_decodes": sum(
                r["program_decodes"] or r["reference_decodes"] for r in bad),
            "rows_bits_differ": bad[:20]}


def mode_ref(a) -> int:
    sys.path.insert(0, str(ROOT))
    from tools_torch import timing
    inp, kept = ref_pass(a.seed, a.device, a.small)
    out = {"mode": "ref", "seed": a.seed,
           "device": timing.device_info(timing.require_device(a.device)),
           **compare(inp, kept)}
    line = json.dumps(out)
    print(line)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(line + "\n")
    return 1 if out["bits_differ_where_either_decodes"] else 0


def mu_ref_pass(seed: int, device: str, small: bool = False):
    """(inputs, results a view, the MU SIG-B passes' and payload calls'
    taps a view) of one pass of the MU station's cell.  ``small``: the
    cell at its CPU test size (``benchmark/tests/cell_small_mu.py``)."""
    from benchmark import core, generate_mu
    from benchmark.run import load_cell
    from gr_ieee80211_tpu_torch.models import rx as RX
    from gr_ieee80211_tpu_torch.ops import ofdm as OF
    from tools_torch import timing
    if small:
        from benchmark.tests.cell_small_mu import small_cell
        _, _, cfg, tr = small_cell()
    else:
        _, _, cfg, tr = load_cell(CELL_MU)
    with core.workers() as pool:
        inp = generate_mu.make(tr, cfg, seed, pool)
    dev = timing.require_device(device)
    eng = RX.RxEngine(nrx=1, device=dev, **cfg["engine"])
    for v in inp["views"]:
        eng.finish_process(eng.begin_process(v))
    taps: dict = {"sigb": {}, "coded": {}}
    cur: list = []
    orig = (RX._mu_sigb_core, RX._payload_core_mu, OF.payload_demod)

    def sigb(stream, ltf_idx, *x, **k):
        bits = orig[0](stream, ltf_idx, *x, **k)
        for li, b in zip(ltf_idx.cpu().numpy(), bits.cpu().numpy()):
            taps["sigb"].setdefault(int(li), b)
        return bits

    def payload(c, stream, ltf_idx, *x, **k):
        cur.append((c, ltf_idx.cpu().numpy()))
        try:
            return orig[1](c, stream, ltf_idx, *x, **k)
        finally:
            cur.pop()

    def demod(*x, **k):
        coded = orig[2](*x, **k)
        if cur:
            c, lis = cur[-1]
            for li, row in zip(lis, coded.cpu().numpy()):
                taps["coded"].setdefault((int(li), c.mcs, c.nsym), row)
        return coded

    res, kept = [], []
    (RX._mu_sigb_core, RX._payload_core_mu, OF.payload_demod) = (
        sigb, payload, demod)
    try:
        for v in inp["views"]:
            taps = {"sigb": {}, "coded": {}}
            res.append(eng.finish_process(eng.begin_process(v)))
            kept.append(taps)
    finally:
        (RX._mu_sigb_core, RX._payload_core_mu, OF.payload_demod) = orig
    return inp, res, kept


def _mu_ref_row(item) -> dict:
    """One MU PPDU decoded by the reference (in a worker process): (window
    (1, n) from the program's start, CFO, nsts_total, own stream, nss,
    nsym)."""
    import torch
    from benchmark.reference import mu_rx as MURX
    torch.set_num_threads(1)
    win, cfo, n_total, own, nss, nsym = item
    (row,) = MURX.decode_at([win], [0], [cfo], n_total, own, nss, nsym)
    c = row["cfg"]
    return {"sigb": row["sigb"].numpy(),
            "cfg": None if c is None else (c.mcs, c.nsym),
            "llr": row["llr"].numpy() if c is not None else None,
            "psdu": row.get("psdu"), "service_ok": row.get("service_ok")}


def mu_compare(inp: dict, res: list, kept: list) -> dict:
    from benchmark import core, generate
    from benchmark.entries import rx_engine_blocks as E
    from benchmark.reference import mu_rx as MURX
    from benchmark.reference.params import Fmt
    rows, items = [], []
    for k, (sent, rs) in enumerate(zip(inp["sent"], res)):
        got = E._pair([E.as_fields(r) | {"psdu": r.psdu} for r in rs],
                      np.array([s for s, _ in sent], np.int64))
        for j, (_, f) in enumerate(sent):
            if not f.get("mu") or len(got.get(j, [])) != 1:
                continue
            r = got[j][0]
            n = MURX.n_need(f["nsts_total"], f["nsym"])
            rows.append((k, j, f, r))
            items.append((inp["views"][k][:, r["start"]: r["start"] + n],
                          r["cfo_hz"], f["nsts_total"], f["own_stream"],
                          f["nss"], f["nsym"]))
    with core.workers() as pool:
        refs = pool.map(_mu_ref_row, items, chunksize=4)
    gaps, differ = [], []
    prog_ok = ref_ok = ref_only = 0
    for (k, j, f, r), ref in zip(rows, refs):
        sent_psdu, _ = generate._psdu(Fmt.VHT, f["mpdus"])
        p_dec = r["ok"] and r["mpdus"] == f["mpdus"]
        r_dec = bool(ref["cfg"] is not None and ref["service_ok"]
                     and ref["psdu"][: f["length"]] == sent_psdu)
        prog_ok += p_dec
        ref_ok += r_dec
        ref_only += r_dec and not p_dec
        coded = kept[k]["coded"].get((r["start"],) + (ref["cfg"] or ()))
        if coded is not None:
            lr = ref["llr"]
            gaps.append(float(np.abs(coded[: lr.size] - lr).max()
                              / np.sqrt(np.mean(lr ** 2))))
        sb = kept[k]["sigb"].get(r["start"])
        same_sigb = sb is not None and np.array_equal(sb, ref["sigb"])
        same_psdu = ref["psdu"] is not None and r["psdu"] == ref["psdu"]
        if not (same_sigb and (same_psdu or not (p_dec or r_dec))):
            differ.append({"view": k, "start": r["start"], "mcs": f["mcs"],
                           "sigb_equal": same_sigb, "psdu_equal": same_psdu,
                           "program_decodes": p_dec,
                           "reference_decodes": r_dec})

    def q(xs):
        return {"max": max(xs), "median": float(np.median(xs))} if xs \
            else None
    return {"ppdus": len(rows), "llr_rows": len(gaps),
            "llr_rel_gap": q(gaps), "program_decodes": prog_ok,
            "reference_decodes": ref_ok, "reference_only": ref_only,
            "bits_differ": len(differ), "rows_bits_differ": differ[:20]}


def mode_muref(a) -> int:
    sys.path.insert(0, str(ROOT))
    from tools_torch import timing
    inp, res, kept = mu_ref_pass(a.seed, a.device, a.small)
    out = {"mode": "muref", "seed": a.seed,
           "device": timing.device_info(timing.require_device(a.device)),
           **mu_compare(inp, res, kept)}
    line = json.dumps(out)
    print(line)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(line + "\n")
    return 1 if out["reference_only"] else 0


def mode_dump(a) -> int:
    sys.path.insert(0, str(ROOT))
    from tools_torch.trace_check import generator     # this tree's tools
    # the program and the benchmark of the tree measured
    sys.path.insert(0, str(Path(a.root).resolve() if a.root else ROOT))
    from benchmark import core
    from benchmark.run import load_cell
    from gr_ieee80211_tpu_torch.models import rx as RX
    from gr_ieee80211_tpu_torch.ops import ofdm as OF
    _, _, cfg, tr = load_cell(a.workload)
    with core.workers() as pool:
        views = generator(cfg).make(tr, cfg, a.seed, pool)["views"]
    eng = RX.RxEngine(nrx=cfg["nrx"], device=a.device, **cfg["engine"])
    for v in views:
        eng.finish_process(eng.begin_process(v))

    calls: list[dict] = []
    # the stage that takes the estimate: K8's wrapper, or on a tree
    # without it the eager equalizer (h and pilot_h after one more
    # argument: the windows and the data start, or the grids)
    stage = ("payload_demod" if hasattr(OF, "payload_demod")
             else "equalize_and_demap")
    at = 2 if stage == "payload_demod" else 1
    orig = (RX._payload_core, getattr(OF, stage))

    def payload(canon, *x, **k):
        calls.append({"cfg": np.array([int(canon.fmt), canon.mcs,
                                       canon.nss])})
        out = orig[0](canon, *x, **k)
        calls[-1].update({f: out[f].cpu().numpy() for f in (
            "psdu", "service", "fcs_ok", "mpdu_fcs_ok", "sssnr0")
            if f in out})
        return out

    def demod(*x, **k):
        calls[-1].update(h=_cplx(x[at]), pilot_h=_cplx(x[at + 1]))
        return orig[1](*x, **k)

    RX._payload_core = payload
    setattr(OF, stage, demod)
    try:
        res = [r for v in views
               for r in eng.finish_process(eng.begin_process(v))]
    finally:
        RX._payload_core = orig[0]
        setattr(OF, stage, orig[1])
    cols = {f: np.array([np.nan if getattr(r, f) is None
                         else float(getattr(r, f)) for r in res])
            for f in FIELDS}
    psdu = np.array([r.psdu.hex() for r in res])
    per_call = {f"call{i:05d}.{k}": v for i, c in enumerate(calls)
                for k, v in c.items()}
    np.savez(a.out, psdu=psdu, **cols, **per_call)
    print(json.dumps({"mode": "dump", "root": a.root or str(ROOT),
                      "results": len(res), "calls": len(calls),
                      "out": a.out}))
    return 0


def mode_same(a) -> int:
    x, y = np.load(a.a), np.load(a.b)
    differ = sorted(set(x.files) ^ set(y.files))
    ss_gap, h_gap = 0.0, 0.0
    for k in sorted(set(x.files) & set(y.files)):
        u, v = x[k], y[k]
        if u.shape != v.shape:
            differ.append(k)
        elif k.endswith("sssnr0"):
            both = np.isnan(u) == np.isnan(v)
            d = np.abs(u - v)[~np.isnan(u) & ~np.isnan(v)]
            ss_gap = max(ss_gap, float(d.max(initial=0.0)))
            if not both.all() or ss_gap > SSSNR_DB:
                differ.append(k)
        elif k.endswith((".h", ".pilot_h")):
            fmt, _, nss = x[k.rsplit(".", 1)[0] + ".cfg"]
            if fmt == 0 or nss == 2:
                if not np.array_equal(u, v):
                    differ.append(k)
                continue
            ref = x[k.rsplit(".", 1)[0] + ".h"]
            hmax = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
            gap = float((np.abs(u - v).reshape(u.shape[0], -1).max(axis=1)
                         / hmax).max(initial=0.0))
            h_gap = max(h_gap, gap)
            if gap > REFINED_REL:
                differ.append(k)
        elif not np.array_equal(u, v, equal_nan=u.dtype.kind == "f"):
            differ.append(k)
    print(json.dumps({"mode": "same", "results": int(x["psdu"].shape[0]),
                      "calls": sum(k.endswith(".cfg") for k in x.files),
                      "sssnr0_max_gap_db": ss_gap,
                      "refined_h_max_rel_gap": h_gap,
                      "fields_differ": differ[:50]}))
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("ref")
    r.add_argument("--seed", type=int, default=3000001500)
    r.add_argument("--device", default="cuda")
    r.add_argument("--out", default="results_torch/mimo_ref_check.json")
    r.add_argument("--small", action="store_true")
    m = sub.add_parser("muref")
    m.add_argument("--seed", type=int, default=3000001900)
    m.add_argument("--device", default="cuda")
    m.add_argument("--out", default="results_torch/mu_ref_check.json")
    m.add_argument("--small", action="store_true")
    d = sub.add_parser("dump")
    d.add_argument("--workload", default="daemon_mixed_30dB")
    d.add_argument("--seed", type=int, required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--root")
    d.add_argument("--device", default="cuda")
    s = sub.add_parser("same")
    s.add_argument("a")
    s.add_argument("b")
    a = ap.parse_args(argv)
    return {"ref": mode_ref, "muref": mode_muref, "dump": mode_dump,
            "same": mode_same}[a.mode](a)


if __name__ == "__main__":
    sys.exit(main())
