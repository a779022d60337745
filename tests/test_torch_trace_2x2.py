"""The counters and spans of the two-antenna path (``utils/trace.py``), on
the CPU: one pass of ``RxEngine(nrx=2)`` over the small two-antenna cell's
blocks (three blocks of 32768 owned samples: one- and two-stream packets,
A-MPDUs, NDPs) with tracing on.  ``rx.bucket.rows_2ss`` counts the rows of
the two-stream buckets exactly, and a ``rx.payload.zf`` span sits inside
the demap of each two-stream bucket and of no other.  On a card, the
same pass makes the same synchronizations, site by site."""
import numpy as np
import pytest
import torch

from benchmark import generate_2x2
from benchmark.tests.cell_small_2x2 import small_cell
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.utils import trace

SEED = 2**31 + 77


class _Serial:
    def map(self, f, items, chunksize=1):
        return list(map(f, items))


@pytest.fixture(scope="module")
def views():
    _, _, cfg, tr = small_cell(ndp_share=0.1)
    return cfg, generate_2x2.make(tr, cfg, SEED, _Serial())["views"]


def _pass(cfg, views, device: str) -> tuple[dict, list]:
    """One pass of a fresh engine over the blocks: (the counters' change,
    the results)."""
    eng = PRX.RxEngine(nrx=2, device=device, **cfg["engine"])
    before = trace.snapshot()
    res = [eng.finish_process(eng.begin_process(v)) for v in views]
    after = trace.snapshot()
    return {k: after[k] - before.get(k, 0) for k in after}, res


@pytest.fixture(scope="module")
def traced(views):
    cfg, vs = views
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    buckets = []
    orig = PRX.RxEngine._decode_bucket

    def bucket(self, dev, canon, items, *a, **k):
        buckets.append((canon.nss, len(items)))
        return orig(self, dev, canon, items, *a, **k)
    trace.reset()
    trace.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(PRX.RxEngine, "_decode_bucket", bucket)
            counts, res = _pass(cfg, vs, "cpu")
        spans = trace.spans()
    finally:
        trace.disable()
        trace.reset()
        torch.set_num_threads(n)
    return {"counts": counts, "res": res, "spans": spans,
            "buckets": buckets}


def test_rows_2ss_counts_the_two_stream_rows(traced):
    rows2 = sum(n for nss, n in traced["buckets"] if nss == 2)
    rows = sum(n for _, n in traced["buckets"])
    assert 0 < rows2 < rows
    assert traced["counts"]["rx.bucket.rows_2ss"] == rows2
    assert traced["counts"]["rx.bucket.rows"] == rows
    assert any(r.nss == 2 and r.ok and not r.is_ndp
               for res in traced["res"] for r in res)


def test_zf_spans_sit_in_two_stream_buckets_only(traced):
    spans = traced["spans"]
    zf = [s for s in spans if s.name == "rx.payload.zf"]
    demap = [s for s in spans if s.name == "rx.payload.demod"]
    assert all(s.parent == "rx.payload.demod" for s in zf)
    holds = [any(d.t0 <= z.t0 and z.t1 <= d.t1 and z.block == d.block
                 for z in zf) for d in demap]
    n2 = sum(1 for nss, _ in traced["buckets"] if nss == 2)
    assert len(zf) == n2 == sum(holds)
    assert len(demap) == len(traced["buckets"]) > n2


@pytest.mark.gpu
def test_the_cards_syncs_are_the_cpus(views):
    """The same blocks on the card and on the CPU, each after a first pass
    that fills the device's table caches (and builds the kernels): every
    ``sync.<site>`` counter moves by the same amount, and the results
    agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, vs = views
    _pass(cfg, vs, "cpu")
    cpu, res_cpu = _pass(cfg, vs, "cpu")
    _pass(cfg, vs, "cuda")
    card, res_card = _pass(cfg, vs, "cuda")
    sync = lambda c: {k: v for k, v in c.items()
                      if k.startswith("sync.") and v}
    assert sync(card) == sync(cpu), (sync(card), sync(cpu))
    assert [[(r.start, r.ok, r.mpdus) for r in b] for b in res_card] == \
        [[(r.start, r.ok, r.mpdus) for r in b] for b in res_cpu]
    for b, c in zip(res_card, res_cpu):
        for r, s in zip(b, c):
            if r.is_ndp:
                assert np.allclose(r.ndp_chan, s.ndp_chan, atol=1e-4)
