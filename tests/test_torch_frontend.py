"""RX front end: the port vs the JAX package on the same streams.

Exact: moving sums of 0/1 flags, detection candidates, dedup, triggers,
bf16-staged window gathers and LTF timing offsets.  Float
metrics, CFO and derotated windows agree to float32 rounding (sums taken
in another order; transcendentals from another library): samples rel
1e-4 of their scale, the detection metric 2e-3 absolute (see the test),
CFO within 0.5 Hz.  The moving sums are bit-equal: the port adds in the
reference's order.  The derotation kernel's twin (K3) is held to the
reference's Pallas kernel, run in interpret mode, to 2e-4 absolute on
unit-variance samples (sin/cos of phases up to ~400 rad from two
libraries).
"""
from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gr_ieee80211_tpu.gold import channel, mac, tx as gtx
from gr_ieee80211_tpu.models import rx as JRX
from gr_ieee80211_tpu.ops import frontend as JFE
from gr_ieee80211_tpu.ops.cplx import CF as JCF, from_host
from gr_ieee80211_tpu.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.ops import frontend as PFE
from gr_ieee80211_tpu_torch.ops.cplx import CF as PCF, from_numpy_cf
from gr_ieee80211_tpu_torch.utils import trace

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def stream():
    """Five VHT MCS4 packets at 25 dB with 1234 Hz CFO, plus the packet
    start positions."""
    rng = np.random.default_rng(17)
    mpdu = mac.qos_data_frame(b"y" * 60, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True)
    wave = channel.apply_cfo(gtx.tx_waveform(cfg, am)[0], 1234.0)
    s = np.zeros(5 * 3000 + 2000, np.complex64)
    starts = []
    for i in range(5):
        p = 500 + i * 3000 + int(rng.integers(0, 8))
        s[p: p + len(wave)] = wave
        starts.append(p)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    return channel.awgn(s, rms / 10 ** (25 / 20), rng), np.array(starts)


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-12)


def test_movsum_paths():
    rng = np.random.default_rng(1)
    flags = (rng.random(100_000) < 0.3).astype(np.float32)   # blocked path
    for w in (3, 8, 43):
        assert np.array_equal(np.asarray(JFE._movsum(jnp.asarray(flags), w)),
                              PFE._movsum(torch.from_numpy(flags), w).numpy())
    x = rng.normal(size=(4, 1000)).astype(np.float32)       # 2-D path
    _close(JFE._movsum(jnp.asarray(x), 64),
           PFE._movsum(torch.from_numpy(x), 64), 1e-5)


def test_detection_matches(stream):
    s, starts = stream
    jm = np.array(JFE.stf_metric_strided(from_host(s)))
    pm = PFE.stf_metric_strided(from_numpy_cf(s, "cpu")).numpy()
    # the metric is a ratio of float32 cumsum differences over 8192-sample
    # rows: its residue scales with the row's accumulated energy, so quiet
    # gaps late in a row carry ~1e-3 absolute (far below the 0.3 threshold)
    assert np.abs(jm - pm).max() <= 2e-3
    jc = np.asarray(JFE.detect_plateaus_strided(jnp.asarray(jm), max_out=24))
    # the same metric gives the same candidates (the algorithm), and the
    # port's own metric does too (end to end)
    pc = PFE.detect_plateaus_strided(torch.from_numpy(jm), max_out=24)
    assert np.array_equal(jc, pc.numpy())
    pc2 = PFE.detect_plateaus_strided(torch.from_numpy(pm), max_out=24)
    assert np.array_equal(jc, pc2.numpy())
    jt = np.asarray(JFE.dedup_triggers_device(jnp.asarray(jc), 8))
    pt = PFE.dedup_triggers_device(pc2, 8).numpy()
    assert pt.dtype == np.int32 and np.array_equal(jt, pt)
    assert (pt[:5] >= 0).all() and (pt[5:] == -1).all()
    assert np.abs(pt[:5] - starts).max() < 200


def test_dedup_matches_host_rule():
    c = np.array([100, 160, 660, 3000, 3560, 9000, -1, -1], dtype=np.int32)
    out = PFE.dedup_triggers_device(torch.from_numpy(c), 5)
    assert out.tolist() == [100, 3000, 9000, -1, -1]
    assert np.array_equal(
        np.asarray(JFE.dedup_triggers_device(jnp.asarray(c), 5)), out.numpy())


def test_gathers_match():
    rng = np.random.default_rng(9)
    N = 20000
    x = rng.normal(size=N).astype(np.float32)
    y = rng.normal(size=N).astype(np.float32)
    jcf = JCF(jnp.asarray(x), jnp.asarray(y))
    pcf = PCF(torch.from_numpy(x), torch.from_numpy(y))
    for n in (464, 531):
        starts = np.concatenate([rng.integers(0, N - n - 64, 12),
                                 [0, 16, N - n - 17]]).astype(np.int32)
        st = torch.from_numpy(starts)
        exp = np.stack([x[s: s + n] for s in starts])
        got = PFE.gather_windows_bf16(pcf, st, n)
        assert np.array_equal(
            got.re.numpy(),
            torch.from_numpy(exp).to(torch.bfloat16).float().numpy())
        assert np.array_equal(
            np.asarray(JFE.gather_windows_bf16(jcf, jnp.asarray(starts), n).im),
            got.im.numpy())
        # the reference's blocked gather (the sync path's) takes 16-aligned
        # starts; the port's sync aligns them before the plain gather
        st16 = torch.div(st, 16, rounding_mode="floor") * 16
        assert np.array_equal(
            np.asarray(JFE.gather_windows_blocked_bf16(
                jcf, jnp.asarray(starts), n).re),
            PFE.gather_windows_bf16(pcf, st16, n).re.numpy())
    # windows overrunning the stream read zeros past its end
    tail = PFE.gather_windows_bf16(pcf, torch.tensor([N - 10]), 64).re.numpy()[0]
    assert np.array_equal(
        tail[:10], torch.from_numpy(x[-10:]).to(torch.bfloat16).float().numpy())
    assert not tail[10:].any()


def test_sync_and_cfo_match(stream):
    s, starts = stream
    trigs = (starts - 40).astype(np.int32)
    jl, jp, jc, jr = (np.asarray(v) for v in
                      JRX._sync_core(from_host(s), jnp.asarray(trigs)))
    pl, pp, pc, pr = (v.numpy() for v in
                      PRX._sync_core(from_numpy_cf(s, "cpu"),
                                     torch.from_numpy(trigs)))
    assert np.array_equal(jl, pl)
    _close(jp, pp, 1e-4)
    _close(jr, pr, 1e-4)
    assert np.abs(jc - pc).max() < 0.5
    assert np.abs(pc - 1234.0).max() < 2000.0


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to an exact rational, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(err)
    near = [c for c, e in zip(cands, err) if e == best]
    return min(near, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma_rounds_once():
    """``_fma`` equals a*b + c computed exactly and rounded once to
    float32, on random triples and on triples built so that a float64
    sum rounded twice would land on the wrong side of a float32 tie."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=3000).astype(np.float32)
    b = rng.normal(size=3000).astype(np.float32)
    c = (rng.normal(size=3000) * 10.0 ** rng.integers(-8, 3, 3000)
         ).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies on a float32 tie; c = 2^-60
    # moves it off, by less than a float64 ulp, so a sum rounded to float64
    # first falls back onto the tie and then to the wrong (even) side
    tie = np.float32(1 + 2.0 ** -12)
    a = np.concatenate([a, np.full(4, tie)])
    b = np.concatenate([b, np.full(4, tie)])
    c = np.concatenate([c, np.array([2.0 ** -60, -2.0 ** -60, 0.0,
                                     2.0 ** -30], np.float32)])
    got = PFE._fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_sync_matches_on_whole_bench_stream_18db():
    """The LTF timing of every packet of the bench's 18 dB stream (4096
    packets, VHT MCS7, 900 Hz CFO) equals the reference's: the metric's
    last bits, which decide the argmax on the flat top of the peak, come
    out of the port's ``_ltf_metric`` as XLA:CPU computes them (one of
    these packets started one sample early while the port divided
    ``|a| / sqrt(pw pw)`` as written).  Exact where the host computes the
    reference's metric as measured (``ltf_metric_as_measured``); elsewhere
    the rsqrt estimate is the CPU's own, and the engine tests' bound holds:
    at most one start in 20 moved, by at most 2 samples, and the RSSI read
    at the argmax within 1%."""
    from test_torch_engine import assert_same_starts, ltf_metric_as_measured
    from test_torch_rx import _bench_stream_18db
    _, _, s = _bench_stream_18db(4096)
    pcf = from_numpy_cf(s, "cpu")
    trigs = PRX.RxEngine(device="cpu").detect(PCF(pcf.re[0], pcf.im[0]))
    assert len(trigs) == 4096
    trigs = trigs.astype(np.int32)
    jl, jp, _, jr = (np.asarray(v) for v in JRX._sync_core(
        from_host(s[0]), jnp.asarray(trigs)))
    pl, pp, _, pr = (v.numpy() for v in PRX._sync_core(
        PCF(pcf.re[0], pcf.im[0]), torch.from_numpy(trigs)))
    assert_same_starts(jl, pl)
    _close(jp, pp, 1e-6)
    if ltf_metric_as_measured():
        assert np.array_equal(jr, pr)
    else:
        assert np.all(np.abs(jr - pr) <= 1e-2 * np.abs(jr))


def test_derotation_matches(stream):
    s, starts = stream
    rng = np.random.default_rng(3)
    cfo = (rng.normal(size=5) * 8e4).astype(np.float32)
    st = (starts + 190).astype(np.int32)
    j = JFE.derotate_batch(from_host(s), jnp.asarray(st), jnp.asarray(cfo),
                           1200, low_prec=True)
    p = PFE.derotate_batch(from_numpy_cf(s, "cpu"), torch.from_numpy(st),
                           torch.from_numpy(cfo), 1200, low_prec=True)
    _close(np.asarray(j.re), p.re.numpy(), 1e-4)
    _close(np.asarray(j.im), p.im.numpy(), 1e-4)


def test_movsum_is_bit_equal():
    """Float moving sums in the reference's summation order (blocks of
    16), 1-D blocked and 2-D."""
    rng = np.random.default_rng(2)
    for shape, w in (((4, 400), 64), ((3, 304), 64), ((70000,), 3),
                     ((7, 520), 4)):
        x = rng.normal(size=shape).astype(np.float32)
        assert np.array_equal(np.asarray(JFE._movsum(jnp.asarray(x), w)),
                              PFE._movsum(torch.from_numpy(x), w).numpy())


def test_float32_gather_and_derotation_match(stream):
    """The SIG/NDP path: float32 windows (zeros past the end) and the
    default float32 derotate_batch.  The reference's blocked gather
    returns NaN, not zeros, more than 64 samples past the end (an
    out-of-range ``jnp.take``), so only in-stream windows are compared."""
    s, starts = stream
    pcf = from_numpy_cf(s, "cpu")
    st = np.concatenate([starts + 190, [len(s) - 100]]).astype(np.int32)
    g = PFE.gather_windows(pcf, torch.from_numpy(st), 496)
    assert g.re.dtype == torch.float32
    assert np.array_equal(g.re.numpy()[:-1], np.stack(
        [s.real[k: k + 496] for k in st[:-1]]).astype(np.float32))
    assert np.array_equal(g.im.numpy()[-1, :100],
                          s.imag[-100:].astype(np.float32))
    assert not g.re.numpy()[-1, 100:].any()
    st = st[:-1]
    cfo = np.random.default_rng(4).normal(size=len(st)).astype(np.float32)
    j = JFE.derotate_batch(from_host(s), jnp.asarray(st),
                           jnp.asarray(cfo * 8e4), 496)
    p = PFE.derotate_batch(pcf, torch.from_numpy(st),
                           torch.from_numpy(cfo * 8e4), 496)
    _close(np.asarray(j.re), p.re.numpy(), 1e-4)
    _close(np.asarray(j.im), p.im.numpy(), 1e-4)


@pytest.mark.parametrize("B,n", [(3, 331), (130, 1984), (8, 4500)])
def test_derotate_twin_matches_pallas(B, n):
    """K3's twin vs the reference's Pallas derotation (interpret mode) at
    its own test's shapes and CFOs; the wrapper runs the twin on CPU
    tensors without counting a launch."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
    cfo = rng.normal(size=B).astype(np.float32) * 8e4
    ref = JFE.derotate_pallas(JCF(jnp.asarray(x.real, jnp.float32),
                                  jnp.asarray(x.imag, jnp.float32)),
                              jnp.asarray(cfo), n)
    before = trace.snapshot()
    got = PFE.derotate(from_numpy_cf(x, "cpu"), torch.from_numpy(cfo), n)
    assert not {k for k, v in trace.snapshot().items()
                if k.startswith("kernel.") and v != before.get(k, 0)}
    for a, b in ((ref.re, got.re), (ref.im, got.im)):
        assert np.abs(np.asarray(a) - b.numpy()).max() < 2e-4
    fac = PFE._derotate_factored(from_numpy_cf(x, "cpu"),
                                 torch.from_numpy(cfo), n)
    assert np.abs(fac.re.numpy() - got.re.numpy()).max() < 2e-4


def test_derotate_wrapper_checks_inputs():
    x = from_numpy_cf(np.ones((2, 10), complex), "cpu")
    with pytest.raises(ValueError):
        PFE.derotate(x, torch.zeros(3), 10)
    with pytest.raises(ValueError):
        PFE.derotate(x, torch.zeros(2, dtype=torch.float64), 10)


@pytest.mark.gpu
def test_derotate_kernel_matches_twin_on_card():
    """K3 on the card vs its twin on the card (1e-5 of the sample scale:
    the precise sincosf and torch's sin/cos round differently in the last
    bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    for B, n in ((3, 331), (300, 2500)):
        x = rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))
        cfo = torch.from_numpy(rng.normal(size=B).astype(np.float32) * 8e4)
        w = from_numpy_cf(x, "cuda")
        got = PFE.derotate(w, cfo.cuda(), n)
        ref = PFE.derotate_ref(w, cfo.cuda(), n)
        for a, b in ((got.re, ref.re), (got.im, ref.im)):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
