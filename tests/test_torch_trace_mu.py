"""The counters and spans of the MU station's decode (``utils/trace.py``),
on the CPU: one stream of known PPDUs (``tests/_mu_streams.py``) through
``RxEngine(nrx=1, mu_pos=1, mu_gid=2)`` with tracing on.  Each ``rx.mu.*``
counter moves by exactly what the stream holds; ``rx.mu.sigb`` sits in
``rx.mu``, and each MU payload call records the stage spans of
``_payload_core`` inside ``rx.mu``; the operator's stats line prints the
MU counters for a station."""
import pytest
import torch

from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.utils import trace
from tools_torch.rx_daemon import engine_line
from _mu_streams import mu_stream, pair

#: two good PPDUs of the group, one of each alteration, two of group 3
KINDS = ("own", "sigb_tail", "foreign", "service", "own", "data",
         "foreign")
STAGES = ("rx.payload.derotate", "rx.payload.chanest", "rx.payload.demod",
          "rx.payload.decode", "rx.payload.bytes", "rx.payload.crc")


@pytest.fixture(scope="module")
def traced():
    """The stream once through a station engine, spans on: the counters'
    change, the spans, the results, what was sent, and the real rows of
    each ``_payload_core_mu`` call the engine made."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    x, sent = mu_stream(1, 41, KINDS)
    calls = []
    orig_core = PRX._payload_core_mu

    def core(cfg, stream, ltf_idx, *a, **k):
        calls.append(cfg)
        return orig_core(cfg, stream, ltf_idx, *a, **k)
    trace.reset()
    trace.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(PRX, "_payload_core_mu", core)
            eng = PRX.RxEngine(nrx=1, mu_pos=1, mu_gid=2, device="cpu")
            before = trace.snapshot()
            res = eng.finish_process(eng.begin_process(x[None]))
            after = trace.snapshot()
        spans = trace.spans()
    finally:
        trace.disable()
        trace.reset()
        torch.set_num_threads(n)
    moved = {k: after[k] - before.get(k, 0) for k in after}
    return {"moved": moved, "spans": spans, "res": res, "sent": sent,
            "calls": calls}


def test_the_streams_ppdus_come_out_as_sent(traced):
    got = pair(traced["res"], traced["sent"])
    assert sorted(got) == [0, 1, 3, 4, 5]
    assert [got[j][0].ok for j in (0, 1, 3, 4, 5)] == \
        [True, False, False, True, False]


def test_mu_counters_count_the_stream(traced):
    m, calls = traced["moved"], traced["calls"]
    decodable = 4                     # all of the group but the SIG-B one
    assert m["rx.mu.rows"] == 5
    assert m["rx.mu.foreign"] == 2
    assert m["rx.mu.groups"] == 1
    assert m["rx.mu.sigb_rejected"] == 1
    assert m["rx.mu.service_rejected"] == 1
    assert m["rx.mu.calls"] == len(calls) == len(set(calls))
    assert m["rx.mu.call_rows"] == decodable
    assert m.get("rx.bucket.calls", 0) == m.get("rx.bucket.rows", 0) == 0


def test_mu_spans_nest_as_the_stages_do(traced):
    spans = traced["spans"]
    mu = [s for s in spans if s.name == "rx.mu"]
    sigb = [s for s in spans if s.name == "rx.mu.sigb"]
    assert len(mu) == 1 and len(sigb) == 1
    assert sigb[0].parent == "rx.mu"
    assert mu[0].t0 <= sigb[0].t0 and sigb[0].t1 <= mu[0].t1
    n_calls = traced["moved"]["rx.mu.calls"]
    for name in STAGES:
        st = [s for s in spans if s.name == name]
        assert len(st) == n_calls, name
        assert all(s.parent == "rx.mu" and mu[0].t0 <= s.t0
                   and s.t1 <= mu[0].t1 for s in st), name
    assert {s.block for s in spans if s.name.startswith("rx.mu")} == \
        {mu[0].block} != {None}


def test_the_stats_line_prints_the_mu_counters():
    c = {"sync.total": 12, "rx.bucket.calls": 3, "rx.bucket.rows": 4,
         "rx.mu.rows": 30, "rx.mu.calls": 28, "rx.mu.sigb_rejected": 1,
         "rx.mu.service_rejected": 2}
    line = engine_line(c, 99, mu=True)
    assert line == ("syncs 12  buckets 3 rows 4  spec hits 0 misses 0  "
                    "backlog 99  mu rows 30  mu calls 28  mu rejected 1/2")
    assert "mu" not in engine_line(c, 99)
