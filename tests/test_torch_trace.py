"""The port's counters and spans (``utils/trace.py``) and where the
receive path records them, on the CPU.

One pass of a speculating ``RxEngine`` over the benchmark cell's mixed
traffic at its small test size (three blocks of 32768 owned samples: L,
HT and VHT packets, A-MPDUs, NDPs; the last block twice, the second time
through the speculative one-pass path) runs with tracing off, and one with
tracing on, both under a ``torch.profiler`` CPU trace but for the last
block: the results are the same, the spans nest as the engine's stages
do and show in the trace, and the counters agree with what wrappers
around the engine's functions count."""
import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.tests.cell_small import small_cell
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.runtime.streaming import RxStreamer
from gr_ieee80211_tpu_torch.utils import trace
from tools_torch.rx_daemon import engine_line

SEED = 2**31 + 99
FIELDS = ("ok", "fmt", "mcs", "nss", "start", "trig", "cfo_hz", "snr_db",
          "rssi", "psdu", "mpdus", "is_ndp", "sssnr0")


class _Serial:
    """The generator's worker pool, in this process."""

    def map(self, f, items, chunksize=1):
        return list(map(f, items))


def _pass(views, bounds=None):
    """One speculating engine over every block, under a ``torch.profiler``
    CPU trace, then the last block again, which the last block's one data
    packet has armed the speculation for: (results, block ids, the
    profiled event names)."""
    _, _, cfg, _ = small_cell()
    eng = PRX.RxEngine(nrx=1, device="cpu", **cfg["engine"])
    res, bids = [], []

    def one(v):
        t0 = time.perf_counter()
        h = eng.begin_process(v)
        res.append(eng.finish_process(h))
        bids.append(h[-1])
        if bounds is not None:
            bounds[h[-1]] = (t0, time.perf_counter())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for v in views:
            one(v)
    one(views[-1])
    return res, bids, [e.name for e in prof.events()]


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(2)
    _, _, cfg, tr = small_cell()
    views = generate.make(tr, cfg, SEED, _Serial())["views"]
    trace.disable()
    trace.reset()
    res_off, _, events_off = _pass(views)
    off = {"res": res_off, "spans": trace.spans(), "counts": trace.snapshot(),
           "events": events_off}

    calls, items_seen, decodes, rows, dd = [0], [0], [0], [0], [0]
    orig_bucket, orig_decode = PRX.RxEngine._decode_bucket, PRX.adaptive_decode
    orig_refine = PRX.OF.refine_chanest_data

    def bucket(self, dev, canon, items, *a, **k):
        calls[0] += 1
        items_seen[0] += len(items)
        return orig_bucket(self, dev, canon, items, *a, **k)

    def decode(coded, *a, **k):
        decodes[0] += 1
        rows[0] += coded.shape[0]
        return orig_decode(coded, *a, **k)

    def refine(*a, **k):
        dd[0] += 1
        return orig_refine(*a, **k)

    trace.reset()
    trace.enable()
    bounds = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(PRX.RxEngine, "_decode_bucket", bucket)
            mp.setattr(PRX, "adaptive_decode", decode)
            mp.setattr(PRX.OF, "refine_chanest_data", refine)
            res_on, bids, events = _pass(views, bounds)
    finally:
        trace.disable()
    on = {"res": res_on, "spans": trace.spans(), "counts": trace.snapshot(),
          "summary": trace.summary(), "bids": bids, "bounds": bounds,
          "events": events, "calls": calls[0],
          "items": items_seen[0], "decodes": decodes[0], "rows": rows[0],
          "dd": dd[0]}
    trace.reset()
    return off, on


def test_results_equal_with_tracing_on_and_off(runs):
    off, on = runs
    assert sum(map(len, off["res"])) > 5
    assert [len(r) for r in off["res"]] == [len(r) for r in on["res"]]
    for ra, rb in zip(off["res"], on["res"]):
        for a, b in zip(ra, rb):
            for f in FIELDS:
                assert getattr(a, f) == getattr(b, f), f
            assert (a.ndp_chan is None) == (b.ndp_chan is None)
            if a.ndp_chan is not None:
                assert np.array_equal(a.ndp_chan, b.ndp_chan)
    assert any(r.is_ndp for res in on["res"] for r in res)


def test_off_records_no_span_and_opens_no_range(runs):
    off, _ = runs
    assert off["spans"] == []
    assert not [n for n in off["events"] if n.startswith("span:")]
    # the counters are always on
    assert off["counts"]["rx.blocks"] == 4
    assert off["counts"]["sync.total"] > 0


def test_spans_nest_as_the_stages_do(runs):
    _, on = runs
    spans = on["spans"]
    names = {s.name for s in spans}
    for n in ("rx.upload", "rx.front", "rx.spec", "rx.readback",
              "rx.classify",
              "rx.bucket", "rx.ndp", "rx.assemble", "rx.payload.derotate",
              "rx.payload.chanest", "rx.payload.dd_gate",
              "rx.payload.demod", "rx.payload.decode", "rx.payload.bytes",
              "rx.payload.crc", "sync.nonzero", "sync.rows",
              "sync.front_readback", "sync.bucket_readback",
              "sync.spec_readback"):
        assert n in names, n
    # the symbol grids are taken apart from the demodulation only for a dd
    # pass, one a pass, in its bucket call
    fft = [s for s in spans if s.name == "rx.payload.fft"]
    dd = [s for s in spans if s.name == "rx.payload.dd"]
    assert len(fft) == len(dd) == on["counts"].get("rx.payload.dd", 0)
    for f, d in zip(fft, dd):
        assert f.block == d.block and f.t1 <= d.t0, (f, d)
    for s in spans:
        if s.name.startswith("rx.payload."):
            assert s.parent in ("rx.bucket", "rx.spec"), s
        if s.name == "rx.bucket":
            assert s.parent is None
        if s.name.startswith("sync."):
            # a wait is never wrapped around another one
            assert s.parent is None or not s.parent.startswith("sync."), s
        assert 0.0 <= s.self_s <= s.t1 - s.t0, s
    for v in on["summary"].values():
        assert 0.0 <= v["self_s"] <= v["total_s"]


def test_every_span_carries_its_block(runs):
    _, on = runs
    bids = on["bids"]
    assert len(set(bids)) == len(bids) == 4
    assert {s.block for s in on["spans"]} == set(bids)
    for s in on["spans"]:
        t0, t1 = on["bounds"][s.block]
        assert t0 <= s.t0 <= s.t1 <= t1, s


def test_bucket_and_tier_counters_match_the_wrappers(runs):
    _, on = runs
    c = on["counts"]
    assert on["calls"] > 0
    assert c["rx.bucket.calls"] == on["calls"]
    assert c["rx.bucket.rows"] == on["items"]
    assert c["rx.blocks"] == 4
    # one tier a decode, one rx.payload.dd a dd pass
    assert on["decodes"] > 0
    assert sum(v for k, v in c.items()
               if k.startswith("decode.tier.")) == on["decodes"]
    assert c.get("rx.payload.dd", 0) == on["dd"]
    assert c["decode.rows"] == on["rows"]
    assert 0 <= c["decode.rows_failed"] <= c["decode.rows"]
    assert c["rx.spec.armed_blocks"] == 1
    assert c["rx.spec.hits"] == 1 and "rx.spec.misses" not in c


def test_sync_total_is_the_sum_of_its_sites(runs):
    for run in runs:
        c = run["counts"]
        sites = sum(v for k, v in c.items()
                    if k.startswith("sync.") and k != "sync.total")
        assert c["sync.total"] == sites > 0
    _, on = runs
    # each counted wait is one span, and its sites' counts are whole
    n_spans = collections.Counter(s.name for s in on["spans"]
                                  if s.name.startswith("sync."))
    for k, n in n_spans.items():
        assert on["counts"][k] >= n


def test_profiler_trace_shows_the_spans(runs):
    _, on = runs
    ev = set(on["events"])
    for n in ("span:rx.front", "span:rx.bucket", "span:rx.payload.decode",
              "span:sync.nonzero", "span:sync.bucket_readback"):
        assert n in ev, n
    # the benchmark's wrapper names stay its own
    assert not ev & {"span:_front_core", "span:RxEngine._finish",
                     "span:RxEngine._decode_bucket", "span:viterbi_decode",
                     "entry:block"}


# ---------------------------------------------------------------------------
# the registry itself
# ---------------------------------------------------------------------------

@pytest.fixture
def clean():
    was = trace._on
    trace.disable()
    trace.reset()
    yield
    trace.reset()
    (trace.enable if was else trace.disable)()


def test_off_span_is_one_shared_no_op(clean):
    assert trace.span("a") is trace.span("b")
    assert trace.in_block(1) is trace.span("a")
    with trace.span("a"), trace.sync("x", 3):
        pass
    assert trace.spans() == []
    assert trace.snapshot()["sync.x"] == 3


def test_counts_snapshot_and_reset(clean):
    trace.count("a")
    trace.count("a", 2)
    trace.count("b", 0.5)
    s = trace.snapshot()
    assert s["a"] == 3 and s["b"] == 0.5
    s["a"] = 100                      # a copy
    assert trace.snapshot()["a"] == 3
    # nothing but what was counted: no launch on the CPU
    assert set(s) == {"a", "b"}
    trace.reset()
    assert "a" not in trace.snapshot()


def test_snapshot_is_a_read(clean):
    """Two readers in one process see the same counters."""
    trace.count("a", 4)
    with trace.sync("x"):
        pass
    first = trace.snapshot()
    assert trace.snapshot() == first
    assert first["a"] == 4 and first["sync.x"] == first["sync.total"] == 1


def test_self_time_subtracts_the_children(clean):
    trace.enable()
    with trace.in_block(7):
        with trace.span("outer"):
            with trace.span("inner"):
                time.sleep(0.02)
    sp = {s.name: s for s in trace.spans()}
    assert sp["inner"].parent == "outer" and sp["outer"].parent is None
    assert {s.block for s in sp.values()} == {7}
    assert sp["outer"].child_s == pytest.approx(
        sp["inner"].t1 - sp["inner"].t0)
    assert 0.0 <= sp["outer"].self_s < sp["outer"].t1 - sp["outer"].t0
    summ = trace.summary()
    assert summ["outer"]["count"] == 1
    assert summ["inner"]["self_s"] == pytest.approx(summ["inner"]["total_s"])


def test_spans_are_bounded(clean, monkeypatch):
    import collections as C
    monkeypatch.setattr(trace, "_spans", C.deque(maxlen=4))
    trace.enable()
    for i in range(10):
        with trace.span(f"s{i}"):
            pass
    assert [s.name for s in trace.spans()] == ["s6", "s7", "s8", "s9"]


def test_counts_lose_no_update_across_threads(clean):
    """More threads than cores, a short switch interval: every increment
    lands."""
    n_threads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [trace.count("c")
                                               for _ in range(n)])
              for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert trace.snapshot()["c"] == n_threads * n


# ---------------------------------------------------------------------------
# the streamer and the daemon's reader
# ---------------------------------------------------------------------------

class _Ring:
    """An IqRing stand-in holding ``n`` samples."""

    def __init__(self, n):
        self.fill = n

    def read_block(self, n, halo):
        if self.fill < n + halo:
            return None
        self.fill -= n
        return np.zeros(n + halo, np.complex64)


class _Engine:
    def begin_process(self, view):
        return view.shape

    def finish_process(self, handle):
        return []


def test_streamer_counts_blocks_and_backlog():
    ring = _Ring(5 * 1024 + 512)
    s = RxStreamer(ring, _Engine(), block_len=1024, halo=512, poll_s=0.001)
    s.start()
    deadline = time.time() + 30
    while s.n_blocks < 5 and time.time() < deadline:
        time.sleep(0.005)
    s.stop()
    s.join(timeout=30)
    assert not s.is_alive() and s.error is None
    assert s.n_blocks == 5
    assert s.fill_max == 5 * 1024 + 512


def test_daemon_stats_line_reads_the_registry():
    line = engine_line({"sync.total": 12, "rx.bucket.calls": 3,
                        "rx.bucket.rows": 4, "rx.spec.hits": 1,
                        "rx.spec.misses": 2, "decode.rows": 7}, 99)
    assert line == ("syncs 12  buckets 3 rows 4  spec hits 1 misses 2  "
                    "backlog 99")
