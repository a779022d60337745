#!/usr/bin/env python3
"""The two-antenna receive path held to the plain reference, and one pass
of a cell's results kept for a comparison between two trees.

    python3 tools_torch/mimo_check.py ref [--seed N] [--device cuda]
        [--out results_torch/mimo_ref_check.json] [--small]
    python3 tools_torch/mimo_check.py dump --workload daemon_mixed_30dB
        --seed N --out FILE.npz [--root TREE] [--device cuda]
    python3 tools_torch/mimo_check.py same A.npz B.npz

* ``ref``: the inputs of cell ``daemon_2x2_mixed_30dB`` from the seed, one
  warm pass of ``RxEngine(nrx=2)`` over its blocks, then one pass in
  which every two-stream bucket's ``_payload_core`` call keeps its
  channel estimate (``ops.ofdm.nl_chanest``), its equalized symbols
  (``ops.ofdm.zf_equalize``), its LLRs (``equalize_and_demap``) and its
  SERVICE and PSDU bits.  Each real row is then decoded by
  ``benchmark/reference/mimo_rx.py`` (float64, on the CPU) from the same
  view at the program's own start and CFO under the packet's own
  transmit vector, and the two compared: (a) the (2, 2, 64) estimates
  over the occupied tones, relative to the reference's largest
  magnitude; (b) the equalized symbols and the LLRs of the packet's own
  symbols, relative to the reference's rms; (c) the SERVICE and PSDU
  bits, which must be equal wherever either decodes the PSDU sent.
  Prints the largest gaps, their medians over the rows and the rows
  whose bits differ (and whether either side decoded the packet), as
  one JSON line, and writes it to ``--out``; exits 1 where bits differ
  on a packet that either side decodes.
* ``dump``: one pass of the cell's blocks (after a warm pass) through the
  engine of the tree ``--root`` (default this one), every kept result's
  fields, ``psdu`` and ``sssnr0`` included, into ``--out``.
* ``same``: whether two dumps agree field for field, bit for bit; exits
  1 where they do not.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CELL_2X2 = "daemon_2x2_mixed_30dB"
FIELDS = ("trig", "start", "ok", "fmt", "mcs", "nss", "is_ndp", "cfo_hz",
          "snr_db", "rssi", "sssnr0")


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
    orig = (RX.RxEngine._decode_bucket, RX._payload_core, OF.nl_chanest,
            OF.zf_equalize, OF.equalize_and_demap)

    def bucket(self, d, canon, items, ltf_idx, cfo, *rest):
        if canon.nss == 2:
            cur["items"] = [(c, int(ltf_idx[i]), float(cfo[i]))
                            for i, c in items]
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

    def demap(*x, **k):
        llr = orig[4](*x, **k)
        if "items" in cur:
            cur["llr"] = llr.cpu().numpy()
        return llr

    (RX.RxEngine._decode_bucket, RX._payload_core, OF.nl_chanest,
     OF.zf_equalize, OF.equalize_and_demap) = bucket, payload, chan, zf, demap
    try:
        for k, v in enumerate(views):
            cur_view = len(kept)
            eng.finish_process(eng.begin_process(v))
            for b in kept[cur_view:]:
                b["view"] = k
    finally:
        (RX.RxEngine._decode_bucket, RX._payload_core, OF.nl_chanest,
         OF.zf_equalize, OF.equalize_and_demap) = orig
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
    for (b, j, c, li, rc), ref in zip(rows, refs):
        hr = ref["h"]
        h_gap.append(float(np.abs(b["h"][j] - hr)[..., occ].max()
                           / np.abs(hr[..., occ]).max()))
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


def mode_dump(a) -> int:
    sys.path.insert(0, str(Path(a.root).resolve() if a.root else ROOT))
    from benchmark import core, generate
    from benchmark.run import load_cell
    from gr_ieee80211_tpu_torch.models.rx import RxEngine
    _, _, cfg, tr = load_cell(a.workload)
    with core.workers() as pool:
        views = generate.make(tr, cfg, a.seed, pool)["views"]
    eng = RxEngine(nrx=cfg["nrx"], device=a.device, **cfg["engine"])
    for v in views:
        eng.finish_process(eng.begin_process(v))
    res = [r for v in views for r in eng.finish_process(eng.begin_process(v))]
    cols = {f: np.array([np.nan if getattr(r, f) is None
                         else float(getattr(r, f)) for r in res])
            for f in FIELDS}
    psdu = np.array([r.psdu.hex() for r in res])
    np.savez(a.out, psdu=psdu, **cols)
    print(json.dumps({"mode": "dump", "root": a.root or str(ROOT),
                      "results": len(res), "out": a.out}))
    return 0


def mode_same(a) -> int:
    x, y = np.load(a.a), np.load(a.b)
    differ = [k for k in x.files
              if x[k].shape != y[k].shape or not np.array_equal(
                  x[k], y[k], equal_nan=x[k].dtype.kind == "f")]
    print(json.dumps({"mode": "same", "results": int(x["psdu"].shape[0]),
                      "fields_differ": differ}))
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("ref")
    r.add_argument("--seed", type=int, default=3000001500)
    r.add_argument("--device", default="cuda")
    r.add_argument("--out", default="results_torch/mimo_ref_check.json")
    r.add_argument("--small", action="store_true")
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
    return {"ref": mode_ref, "dump": mode_dump, "same": mode_same}[a.mode](a)


if __name__ == "__main__":
    sys.exit(main())
