"""The port's ``RxStreamer`` over the port's ``RxEngine(device="cpu")`` vs
the JAX package's streamer over the JAX engine, on one small mixed
stream: the lists of ``(trig, start, fmt, mcs, nss, ok, mpdus)`` are
equal.  Start is held exactly where the host computes the reference's
LTF metric as measured (``test_torch_engine.ltf_metric_as_measured``;
the port's ``ops.frontend._ltf_metric`` takes XLA:CPU's arithmetic),
elsewhere to the engine tests' bound.  Its own file because it pays the
JAX engine's CPU compile."""
import numpy as np
import pytest
import torch

from gr_ieee80211_tpu.gold import channel, mac, tx as gtx
from gr_ieee80211_tpu.models.rx import RxEngine as JEngine
from gr_ieee80211_tpu.runtime import native as JNAT
from gr_ieee80211_tpu.runtime.streaming import RxStreamer as JStreamer
from gr_ieee80211_tpu.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.models.rx import RxEngine as PEngine
from gr_ieee80211_tpu_torch.runtime import native as PNAT
from gr_ieee80211_tpu_torch.runtime.streaming import RxStreamer as PStreamer
from test_torch_engine import assert_same_starts

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not PNAT.available(),
                                reason="native runtime unavailable")

BLOCK, HALO = 8192, 4096

#: (fmt, mcs, payload bytes); the third packet starts 50 samples before
#: the first block edge, so its trigger is in block 0 and its LTF in 1
PACKETS = [(Fmt.L, 4, 60), (Fmt.HT, 2, 50), (Fmt.VHT, 4, 60),
           (Fmt.L, 7, 80), (Fmt.HT, 5, 80), (Fmt.VHT, 7, 80),
           (Fmt.VHT, 1, 30), (Fmt.HT, 7, 100)]


def _stream():
    rng = np.random.default_rng(21)
    s = np.zeros(3 * BLOCK, np.complex64)
    pos, sent = 300, []
    for k, (fmt, mcs, n) in enumerate(PACKETS):
        mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, n,
                                                     dtype=np.uint8)),
                                  "02:00:00:00:00:01", "02:00:00:00:00:02",
                                  "02:00:00:00:00:01", k)
        if fmt == Fmt.VHT:
            psdu = mac.ampdu_aggregate_vht([mpdu])
            cfg = PhyConfig(fmt, mcs, 1, len(psdu), ampdu=True)
            w = gtx.tx_waveform(cfg, psdu, group_id=0, partial_aid=0)[0]
        else:
            w = gtx.tx_waveform(PhyConfig(fmt, mcs, 1, len(mpdu)), mpdu)[0]
        if k == 2:
            assert pos < BLOCK - 50
            pos = BLOCK - 50
        assert pos + len(w) < len(s) - 200, k
        s[pos: pos + len(w)] = channel.apply_cfo(w, 700.0 - 150 * k)
        sent.append((pos, mpdu))
        pos += len(w) + 600
    rms = np.sqrt(np.mean(np.abs(w) ** 2))
    return channel.awgn(s[None], rms / 10 ** (30 / 20), rng)[0], sent


def _run(native, streamer_cls, engine, stream):
    ring = native.IqRing(1 << 16)
    got = []
    st = streamer_cls(ring, engine, block_len=BLOCK, halo=HALO,
                      on_result=got.append)
    st.start()
    assert ring.write(stream) == len(stream)
    st.stop(drain=True, timeout=600)
    st.join(timeout=600)
    assert not st.is_alive() and st.error is None, st.error
    ring.close()
    return sorted((r.trig, r.start, None if r.fmt is None else int(r.fmt),
                   r.mcs, r.nss, bool(r.ok), list(r.mpdus)) for r in got)


def test_streamer_matches_the_reference_streamer():
    stream, sent = _stream()
    ref = _run(JNAT, JStreamer, JEngine(nrx=1), stream)
    got = _run(PNAT, PStreamer, PEngine(nrx=1, device="cpu"), stream)
    assert [r[:1] + r[2:] for r in got] == [r[:1] + r[2:] for r in ref]
    assert_same_starts([r[1] for r in ref], [r[1] for r in got])
    assert len(got) == len(PACKETS)
    assert [r[6] for r in got] == [[m] for _, m in sent]
    assert all(r[5] for r in got)
    edge = [r for r in got if r[0] < BLOCK <= r[1]]
    assert len(edge) == 1
