"""The port's ``RxEngine`` vs the JAX package's on streaming-style input:
begin/finish with the speculative one-pass path (hit and miss) and
canonicalized mixed lengths in one bucket.  The comparison
and its tolerances are those of ``test_torch_engine.py``."""
import numpy as np
import torch

from gr_ieee80211_tpu.gold import channel, mac, tx as gtx
from gr_ieee80211_tpu.models import rx as JRX
from gr_ieee80211_tpu.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.spec.params import from_reference
from test_torch_engine import _mk, _wave, assert_same_results, both

torch.set_num_threads(2)


def _blk(rng, payload, cfg, snr=30.0, num=3, cfo=450.0):
    wave = _wave(cfg, payload)
    s = channel.frame_stream(wave, 1.0, cfo, num=num, gap=1100)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    return channel.awgn(s, rms / 10 ** (snr / 20), rng)


def test_engine_speculative_hit_and_miss():
    """Homogeneous traffic arms the speculation; the next block decodes
    through the one-pass ``_spec_core`` (a hit), and a config change
    misses and falls back to the bucket path — each block's results equal
    the reference engine's, and the armed state follows it."""
    rng = np.random.default_rng(91)
    mpdu7, pay7, cfg7 = _mk(rng, Fmt.VHT, 7, 1)
    mpdu4, pay4, cfg4 = _mk(rng, Fmt.VHT, 4, 1, n=90)
    blocks = [_blk(rng, pay7, cfg7), _blk(rng, pay7, cfg7),
              _blk(rng, pay4, cfg4)]
    jeng, peng = JRX.RxEngine(nrx=1), PRX.RxEngine(nrx=1, device="cpu")
    kinds = []
    for blk, mpdu in zip(blocks, (mpdu7, mpdu7, mpdu4)):
        handle = peng.begin_process(blk)
        kinds.append(handle[2][0])
        got = peng.finish_process(handle)
        ref = jeng.finish_process(jeng.begin_process(blk))
        assert_same_results(ref, got)
        canon, n_trellis = jeng._spec_canon
        assert (from_reference(canon), n_trellis) == peng._spec_canon
        assert sum(r.ok and r.mpdus[0] == mpdu for r in got) == 3
    assert kinds == ["front", "spec", "spec"]


def test_engine_canonical_mixed_lengths():
    """Five VHT MCS4 lengths share canonical buckets (longer trellises,
    per-row n_real): the real bits are identical to the reference's."""
    rng = np.random.default_rng(21)
    parts = [np.zeros(400, np.complex64)]
    mpdus = []
    for k, plen in enumerate((60, 75, 92, 120, 133)):
        mpdu = mac.qos_data_frame(bytes([k]) * plen, "f4:69:d5:80:0f:a0",
                                  "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0",
                                  3)
        am = mac.ampdu_aggregate_vht([mpdu])
        cfg = PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True)
        w = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
        parts += [channel.apply_cfo(w, 300.0).astype(np.complex64),
                  np.zeros(300, np.complex64)]
        mpdus.append(mpdu)
    stream = channel.awgn(np.concatenate(parts), 0.02 / 10 ** (30 / 20), rng)
    got = both(stream * 5.0, nrx=1)
    assert {r.mpdus[0] for r in got if r.ok} == set(mpdus)
    assert sum(r.ok for r in got) == 5
