"""The whole slice: the port's known-config chain (rx_chain_count /
rx_chain_ok) vs the JAX package's on the same streams.  Counts, per-packet
FCS flags, ltf_idx and valid flags must be equal."""
import numpy as np
import pytest
import torch

from gr_ieee80211_tpu.gold import channel, mac, tx as gtx
from gr_ieee80211_tpu.models import rx as JRX
from gr_ieee80211_tpu.ops.cplx import from_host
from gr_ieee80211_tpu.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.ops import fastdecode as PFD
from gr_ieee80211_tpu_torch.ops import viterbi_kernels as PVK
from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
from gr_ieee80211_tpu_torch.spec.params import from_reference
from tools_torch import timing

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _stream(fmt, mcs, snr, num=5, seed=53, n=120):
    """``num`` copies of one packet (900 Hz CFO, 500-sample gaps) + AWGN;
    returns (cfg, mpdu_len for the chain, stream (1, N))."""
    rng = np.random.default_rng(seed)
    mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                              "02:00:00:00:00:01", "02:00:00:00:00:02",
                              "02:00:00:00:00:01", 1)
    if fmt == Fmt.VHT:
        payload = mac.ampdu_aggregate_vht([mpdu])
        cfg = PhyConfig(fmt, mcs, 1, len(payload), ampdu=True)
        wave = gtx.tx_waveform(cfg, payload, group_id=0, partial_aid=0)
        mpdu_len = len(mpdu)
    else:
        cfg = PhyConfig(fmt, mcs, 1, len(mpdu))
        wave = gtx.tx_waveform(cfg, mpdu)
        mpdu_len = 0
    stream = channel.frame_stream(wave[0], 1.0, 900.0, num=num, gap=500)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    return cfg, mpdu_len, channel.awgn(stream, rms / 10 ** (snr / 20), rng)


def _jax_count(cfg, ml, s, **kw):
    return tuple(int(x) for x in JRX.rx_chain_count(
        cfg, from_host(s), nrx=1, mpdu_len=ml, max_pkts=8, **kw))


def _port_count(cfg, ml, s, **kw):
    return tuple(int(x) for x in PRX.rx_chain_count(
        from_reference(cfg), from_numpy_cf(s, "cpu"), mpdu_len=ml,
        max_pkts=8, **kw))


@pytest.mark.parametrize("chunk", [None, 4])
def test_rx_chain_count_matches(chunk):
    """The bench hot path at 32 dB (VHT MCS7): 5 packets detected and
    decoded, unchunked and in chunks of 4, equal to the reference."""
    cfg, ml, s = _stream(Fmt.VHT, 7, 32.0)
    got, moved = timing.with_counters(
        lambda: _port_count(cfg, ml, s, chunk=chunk), CPU)
    rec = timing.decode_path(moved)
    assert got == _jax_count(cfg, ml, s, chunk=chunk) == (5, 5)
    assert len(rec) == (1 if chunk is None else 2) and "dd" not in rec


@pytest.mark.parametrize("fmt,mcs,snr", [(Fmt.VHT, 7, 32.0), (Fmt.L, 3, 20.0),
                                         (Fmt.HT, 4, 22.0)])
def test_rx_chain_ok_matches(fmt, mcs, snr):
    cfg, ml, s = _stream(fmt, mcs, snr, num=4)
    ref = [np.asarray(x) for x in JRX.rx_chain_ok(
        cfg, from_host(s), nrx=1, mpdu_len=ml, max_pkts=8)]
    got = [x.numpy() for x in PRX.rx_chain_ok(
        from_reference(cfg), from_numpy_cf(s, "cpu"), mpdu_len=ml,
        max_pkts=8)]
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    assert got[2].sum() == 4 and got[0].sum() == 4


def test_chain_forced_through_viterbi(monkeypatch):
    """Low SNR (VHT MCS2 at 8 dB): detected packets carry channel hard
    errors (nonzero syndromes), so the decode leaves the algebraic fast
    path for the full sweep, the dd chanest pass runs, the K1/K2 twins do
    the decoding, and every packet still passes FCS, as in the reference."""
    cfg, ml, s = _stream(Fmt.VHT, 2, 8.0)
    calls = {"acs": 0, "tb": 0}
    syn_seen = []
    acs_ref, tb_ref = PVK.acs_sweep_ref, PVK.traceback_ref
    ias = PFD.inverse_and_syndrome

    def acs_spy(*a):
        calls["acs"] += 1
        return acs_ref(*a)

    def tb_spy(*a):
        calls["tb"] += 1
        return tb_ref(*a)

    def ias_spy(*a, **k):
        out = ias(*a, **k)
        syn_seen.append(out[1].clone())
        return out

    monkeypatch.setattr(PVK, "acs_sweep_ref", acs_spy)
    monkeypatch.setattr(PVK, "traceback_ref", tb_spy)
    monkeypatch.setattr(PFD, "inverse_and_syndrome", ias_spy)
    got, moved = timing.with_counters(lambda: _port_count(cfg, ml, s), CPU)
    assert got == _jax_count(cfg, ml, s) == (5, 5)
    assert sorted(timing.decode_path(moved)) == ["dd", "full"]
    assert calls["acs"] >= 1 and calls["tb"] >= 1
    assert int((syn_seen[0] > 0).sum()) == 8
    # the packets themselves (not only the unused padding rows) had errors
    _, ltf_c, cfo, valid = PRX._detect_sync(
        from_reference(cfg), from_numpy_cf(s, "cpu"), 8)
    assert int(valid.sum()) == 5
    assert int((syn_seen[0][valid] > 0).sum()) >= 3


def _bench_stream_18db(n_pkts):
    """The first ``n_pkts`` packets of bench.py's 18 dB stream (VHT MCS7,
    500 B payload, 900 Hz CFO, 240-sample gaps), drawn from its seed in
    its order: the 32 dB noise of the whole 4096-packet stream first."""
    rng = np.random.default_rng(1)
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 7, 1, len(am), ampdu=True)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    spacing = len(wave) + 240
    n_all = 4096 * spacing + 2048
    rng.normal(size=n_all)
    rng.normal(size=n_all)
    cut = 1024 + n_pkts * spacing
    re = rng.normal(size=n_all)[:cut]
    im = rng.normal(size=n_all)[:cut]
    s = np.zeros(cut, np.complex64)
    w = channel.apply_cfo(wave, 900.0).astype(np.complex64)
    for i in range(n_pkts):
        s[1024 + i * spacing: 1024 + i * spacing + len(wave)] = w
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    s += (re + 1j * im).astype(np.complex64) * (rms / 10 ** (18 / 20)
                                                / np.sqrt(2))
    return cfg, len(mpdu), s[None]


def test_chain_ok_matches_on_bench_stream_18db():
    """A marginal SNR, where float differences can flip packets: the first
    128 packets of the bench's 18 dB stream run the dd pass and the full
    sweep, and every per-packet FCS flag, ltf_idx and valid flag equals
    the reference's.  (The LTF timing of the whole 4096-packet stream is
    held in ``test_torch_frontend.py``.)"""
    cfg, ml, s = _bench_stream_18db(128)
    ref = [np.asarray(x) for x in JRX.rx_chain_ok(
        cfg, from_host(s), nrx=1, mpdu_len=ml, max_pkts=128)]
    out, moved = timing.with_counters(lambda: PRX.rx_chain_ok(
        from_reference(cfg), from_numpy_cf(s, "cpu"), mpdu_len=ml,
        max_pkts=128), CPU)
    got = [x.numpy() for x in out]
    assert sorted(timing.decode_path(moved)) == ["dd", "full"]
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    assert got[2].sum() == 128 and 0 < got[0].sum() < 128


def test_chain_rejects_unported_configs():
    cfg, ml, s = _stream(Fmt.VHT, 7, 32.0, num=1)
    cfg = from_reference(cfg)
    with pytest.raises(ValueError):
        PRX.rx_chain_count(cfg, from_numpy_cf(np.stack([s[0], s[0]]), "cpu"),
                           nrx=3, mpdu_len=ml, max_pkts=8)
    with pytest.raises(ValueError):
        PRX.rx_chain_count(cfg, from_numpy_cf(s, "cpu"), mpdu_len=ml,
                           max_pkts=8, chunk=3)
    with pytest.raises(ValueError):
        PRX.rx_chain_count(cfg, from_numpy_cf(s, "cpu"), mpdu_len=0,
                           max_pkts=8)
