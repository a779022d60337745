"""A-MPDU walks, dense traffic and the reduced ingest modes through the
port's ``RxEngine`` vs the JAX package's: 3-MPDU VHT (native delimiter
walk) and HT A-MPDUs, 40 packets at near-minimum spacing, and bf16 /
int8 uploads.  The comparison and its tolerances are those of
``test_torch_engine.py``."""
import numpy as np
import pytest
import torch

from gr_ieee80211_tpu.gold import channel, mac, tx as gtx
from gr_ieee80211_tpu.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.models import rx as PRX
from test_torch_engine import _mk, _wave, both

torch.set_num_threads(2)


def _blk(rng, payload, cfg, snr=30.0, num=3, cfo=450.0):
    wave = _wave(cfg, payload)
    s = channel.frame_stream(wave, 1.0, cfo, num=num, gap=1100)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    return channel.awgn(s, rms / 10 ** (snr / 20), rng)


@pytest.mark.parametrize("fmt", [Fmt.VHT, Fmt.HT])
def test_engine_multi_mpdu_ampdu(fmt):
    """3-MPDU A-MPDUs: the VHT (native) and HT delimiter walks."""
    rng = np.random.default_rng(61 if fmt == Fmt.VHT else 62)
    mpdus = [mac.qos_data_frame(bytes(rng.integers(0, 256, 40 + 30 * k,
                                                   dtype=np.uint8)),
                                "02:00:00:00:00:01", "02:00:00:00:00:02",
                                "02:00:00:00:00:01", k) for k in range(3)]
    if fmt == Fmt.VHT:
        am = mac.ampdu_aggregate_vht(mpdus)
        cfg = PhyConfig(Fmt.VHT, 5, 1, len(am), ampdu=True)
    else:
        am = mac.ampdu_aggregate_ht(mpdus)
        cfg = PhyConfig(Fmt.HT, 4, 1, len(am), ampdu=True)
    wave = _wave(cfg, am)[0]
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, 1.0, 400.0, num=2, gap=1000)
    stream = channel.awgn(stream, rms / 10 ** (32 / 20), rng)
    got = both(stream, nrx=1)
    assert [r.mpdus for r in got if r.ok] == [mpdus, mpdus]


def test_engine_dense_min_spacing():
    """40 VHT packets 60 samples apart: every start detected and decoded."""
    rng = np.random.default_rng(51)
    mpdu = mac.qos_data_frame(b"dense!" * 5, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 7, 1, len(am), ampdu=True)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)
    stream = channel.frame_stream(wave, 1.0, 300.0, num=40, gap=60)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream, rms / 10 ** (30 / 20), rng)
    eng = PRX.RxEngine(nrx=1, device="cpu")
    trigs = eng.detect(eng._upload(stream)[0])
    assert len(trigs) == 40
    got = both(stream, nrx=1)
    assert sum(r.ok and r.mpdus[0] == mpdu for r in got) == 40


@pytest.mark.parametrize("ingest", ["bf16", "i8"])
def test_engine_reduced_ingest_matches(ingest):
    """bf16 (half the upload bytes) and int8 block-AGC (a quarter) ingest
    decode like the reference's, packet for packet."""
    rng = np.random.default_rng(61 if ingest == "bf16" else 77)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, 7, 1)
    stream = _blk(rng, payload, cfg, num=4, cfo=650.0 if ingest == "bf16"
                  else 500.0)
    got = both(stream, nrx=1, ingest=ingest)
    assert sum(r.ok and r.mpdus[0] == mpdu for r in got) == 4
