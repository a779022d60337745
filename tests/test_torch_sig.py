"""SIG decode and classification: the port vs the JAX package.

Exact: the stacked L-SIG / HT-SIG / VHT-SIG-A bits of ``_sig_core`` at
the same sync positions, ``canonical_cfg`` over every format, MCS and
length (step 37), and ``RxEngine._classify`` on real, forged, NDP and MU
SIG words.  Engine-level: NDP channel estimates and the per-packet
SNR/RSSI/sssnr0 metadata, held as in ``test_torch_engine.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gr_ieee80211_tpu.gold import channel, mac, rx as grx, sig as S
from gr_ieee80211_tpu.gold import tx as gtx
from gr_ieee80211_tpu.models import rx as JRX
from gr_ieee80211_tpu.ops.cplx import from_host
from gr_ieee80211_tpu.spec import tables as T
from gr_ieee80211_tpu.spec.params import Fmt, MuConfig, PhyConfig
from gr_ieee80211_tpu_torch.gold import sig as PS
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
from gr_ieee80211_tpu_torch.spec.params import from_reference
from test_torch_engine import _mk, _wave, both

torch.set_num_threads(2)


def test_sig_core_matches():
    """L-SIG, HT-SIG and VHT-SIG-A bits of L, HT and VHT packets (25 dB,
    1234 Hz CFO), decoded at the reference's own sync positions."""
    rng = np.random.default_rng(19)
    s = np.zeros(9 * 2500 + 1000, np.complex64)
    starts = []
    for i, (fmt, mcs) in enumerate([(Fmt.L, 2), (Fmt.HT, 5), (Fmt.VHT, 3)]
                                   * 3):
        _, payload, cfg = _mk(rng, fmt, mcs, 1, n=40)
        w = channel.apply_cfo(_wave(cfg, payload)[0], 1234.0)
        p = 500 + 2500 * i + int(rng.integers(0, 16))
        s[p: p + len(w)] = w
        starts.append(p)
    s = channel.awgn(s, 0.05 / 10 ** (25 / 20), rng)
    trigs = jnp.asarray(np.array(starts, np.int32) - 30)
    li, _, cfo, _ = JRX._sync_core(from_host(s), trigs)
    ref = [np.asarray(b) for b in JRX._sig_core(from_host(s), li, cfo)]
    got = [b.numpy() for b in PRX._sig_core(
        from_numpy_cf(s, "cpu"), torch.from_numpy(np.array(li)),
        torch.from_numpy(np.array(cfo)))]
    for r, g in zip(ref, got):
        assert g.dtype == np.uint8 and np.array_equal(r, g)
    assert all(S.parse_lsig(b).ok for b in got[0])
    assert sum(S.parse_htsig(b).ok for b in got[1]) == 3
    assert sum(S.parse_vhtsiga(b).ok for b in got[2]) == 3


def _configs():
    for mcs in range(8):
        yield Fmt.L, mcs, 1
    for mcs in range(16):
        yield Fmt.HT, mcs, mcs // 8 + 1
    for nss in (1, 2):
        for mcs in range(9):
            yield Fmt.VHT, mcs, nss


def test_canonical_cfg_matches():
    n = 0
    for fmt, mcs, nss in _configs():
        for length in range(1, 4096, 37):
            for ampdu in ((True,) if fmt == Fmt.VHT else (False, True)):
                try:
                    cfg = PhyConfig(fmt, mcs, nss, length, ampdu=ampdu)
                except (ValueError, AssertionError):
                    continue
                assert PRX.canonical_cfg(from_reference(cfg)) == \
                    from_reference(JRX.canonical_cfg(cfg)), cfg
                n += 1
    assert n > 5000


def _with_crc(body34):
    return np.array(list(body34) + list(T.crc8_bits(body34)) + [0] * 6,
                    np.uint8)


def _sig_cases():
    """(lsig bits, ht bits, vht bits) words: real L/HT/VHT headers, forged
    HT lengths and bits, an NDP, an MU VHT-SIG-A and garbage."""
    zeros = np.zeros(48, np.uint8)
    for mcs in range(8):
        cfg = PhyConfig(Fmt.L, mcs, 1, 300)
        yield S.lsig_bits(cfg), zeros, zeros
    for mcs, length in ((1, 100), (7, 1500), (12, 700), (15, 4000)):
        cfg = PhyConfig(Fmt.HT, mcs, mcs // 8 + 1, length, ampdu=mcs > 8)
        yield S.lsig_bits(cfg), S.htsig_bits(cfg), zeros
    real = PhyConfig(Fmt.HT, 1, 1, 100)
    yield (S.lsig_bits(real), S.htsig_bits(PhyConfig(Fmt.HT, 1, 1, 400)),
           zeros)                                      # L-SIG budget fails
    for bit in (28, 29, 30, 32):
        body = list(S.htsig_bits(real)[:34])
        body[bit] = 1
        yield S.lsig_bits(real), _with_crc(body), zeros
    for mcs, nss, length in ((5, 1, 200), (8, 1, 3000), (4, 2, 900),
                             (0, 1, 4000)):
        cfg = PhyConfig(Fmt.VHT, mcs, nss, length, ampdu=True)
        yield S.lsig_bits(cfg), np.zeros(48, np.uint8), S.vhtsiga_bits(cfg)
    for nss in (1, 2):
        ndp = PhyConfig(Fmt.VHT, 0, nss, 0, ampdu=True)
        yield S.lsig_bits(ndp), zeros, S.vhtsiga_bits(ndp)
    mu = MuConfig((PhyConfig(Fmt.VHT, 4, 1, 300, ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, 200, ampdu=True)), group_id=2)
    yield S.lsig_bits(mu), zeros, S.vhtsiga_bits(mu)
    rng = np.random.default_rng(3)
    for _ in range(8):
        yield (rng.integers(0, 2, 24).astype(np.uint8),
               rng.integers(0, 2, 48).astype(np.uint8),
               rng.integers(0, 2, 48).astype(np.uint8))


@pytest.mark.parametrize("nrx", [1, 2])
def test_classify_matches(nrx):
    jeng = JRX.RxEngine(nrx=nrx)
    peng = PRX.RxEngine(nrx=nrx, device="cpu")
    kinds = set()
    for lb, hb, vb in _sig_cases():
        lsig = S.parse_lsig(lb)
        if not lsig.ok:
            continue
        ref = jeng._classify(lsig, hb, vb)
        got = peng._classify(PS.parse_lsig(lb), hb, vb)
        if ref[0] is not None:          # the port's own config class
            ref = (from_reference(ref[0]),) + tuple(ref[1:])
        assert got == ref, (ref, got)
        kinds.add("ndp" if got[1] is not None else
                  "none" if got[0] is None else got[0].fmt.name)
    assert kinds == {"L", "HT", "VHT", "ndp", "none"}


def test_engine_ndp_channel_2x2():
    """VHT NDPs (nsts = 2) on 2 antennas: one batched channel estimate,
    equal (to float32 rounding) to the one-NDP ``_ndp_chan``."""
    rng = np.random.default_rng(13)
    h = (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))) / np.sqrt(2)
    ndp = gtx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                          group_id=0, partial_aid=0)
    one = channel.frame_stream(channel.mimo_channel(ndp, h), 1.0, 120.0,
                               gap=400)
    stream = np.concatenate([np.zeros((2, 256), np.complex64)]
                            + [one.astype(np.complex64)] * 3, axis=1)
    stream = channel.awgn(stream, 0.01 / 10 ** (35 / 20), rng)
    got = both(stream, nrx=2)
    ndps = [r for r in got if r.is_ndp]
    assert len(ndps) == 3 and all(r.ndp_chan.shape == (2, 2, 64)
                                  for r in ndps)
    eng = PRX.RxEngine(nrx=2, device="cpu")
    one_h = eng._ndp_chan(eng._upload(stream), ndps[1].start, ndps[1].cfo_hz,
                          2)
    scale = np.abs(ndps[1].ndp_chan).max()
    assert np.abs(one_h - ndps[1].ndp_chan).max() <= 1e-5 * scale


@pytest.mark.parametrize("mcs,snr_set", [(2, 14.0), (4, 22.0)])
def test_engine_snr_rssi_metadata(mcs, snr_set):
    """Per-packet SNR/RSSI/sssnr0 (the dd pass runs at these SNRs) equal
    the reference engine's and sit near the gold receiver's and the
    injected level."""
    rng = np.random.default_rng(101)
    mpdu, payload, cfg = _mk(rng, Fmt.VHT, mcs, 1)
    wave = _wave(cfg, payload)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, 1.0, 650.0, num=4, gap=1100)
    stream = channel.awgn(stream, rms / 10 ** (snr_set / 20), rng)
    got = [r for r in both(stream, nrx=1) if r.ok]
    gold = [p for p in grx.receive(stream) if p.ok]
    assert len(got) == 4 and len(gold) == 4
    for r, g in zip(got, gold):
        assert abs(r.snr_db - g.snr_db) < 1.0
        assert -6.0 < r.sssnr0 - snr_set < 2.0
