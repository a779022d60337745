"""The port's scale-out layer vs the JAX package's on the CPU.

The same seeded numpy inputs go through the JAX programs of
``gr_ieee80211_tpu.parallel.mesh`` (on the conftest's 8 virtual CPU
devices, the Pallas Viterbi in interpret mode, as ``tests/test_mesh.py``
runs them) and through ``gr_ieee80211_tpu_torch.parallel.mesh`` on
``device="cpu"`` with 8 shards, at ``tests/test_mesh.py``'s programs and
sizes.

Exact: candidate indices, PSDU bytes, FCS flags and counts, the moving
sums of the per-sample STF metric, LTF offsets.  Floats: the STF metric
within 1e-6 absolute (values up to ~1; the last bit of XLA:CPU's
division is not torch's), the LTF peak within 1e-6 relative, the fine
CFO within 0.5 Hz of the reference's (cos/sin from two libraries; a
rotation of 2 pi 0.5 Hz / 20 MHz a sample).  The one stated exception is
the LTF near-tie: on the noisier chain the counts are exact where
``test_torch_engine.ltf_metric_as_measured()`` holds, and within one
packet elsewhere.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_ieee80211_tpu.gold import channel, mac, sounding, tx as gtx
from gr_ieee80211_tpu.ops import frontend as JFE
from gr_ieee80211_tpu.ops.cplx import CF as JCF, from_host
from gr_ieee80211_tpu.parallel import mesh as JM
from gr_ieee80211_tpu.spec.params import Fmt, MuConfig, PhyConfig
from gr_ieee80211_tpu_torch import entry as PE
from gr_ieee80211_tpu_torch.ops import frontend as PFE
from gr_ieee80211_tpu_torch.ops.cplx import CF as PCF, from_numpy_cf
from gr_ieee80211_tpu_torch.parallel import mesh as PM
from gr_ieee80211_tpu_torch.spec.params import from_reference
from test_torch_engine import ltf_metric_as_measured

torch.set_num_threads(2)

N = 8                                   # shards, as tests/test_mesh.py


def _need_devices():
    if len(jax.devices()) < N:
        pytest.skip(f"the JAX side needs {N} devices")


def _mk_cfg(rng, n=80):
    """tests/test_mesh.py's packet: a random n-byte MPDU as a VHT MCS4
    A-MPDU; returns (mpdu, cfg, A-MPDU)."""
    mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                              "02:00:00:00:00:01", "02:00:00:00:00:02",
                              "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    return mpdu, PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True), am


def _pad8(s):
    return np.pad(s, (0, -len(s) % N)).astype(np.complex64)


def _jmesh(axis):
    _need_devices()
    return JM.make_mesh(N, axes=(axis,))


def _pmesh(axis):
    return PM.make_mesh(N, axes=(axis,), device="cpu")


# ---------------------------------------------------------------------------
# the three front-end functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sync_stream():
    """tests/test_spec.py's sync case: 8 VHT MCS4 packets with 1234 Hz
    CFO at 25 dB; returns (stream, trigger positions)."""
    rng = np.random.default_rng(17)
    mpdu = mac.qos_data_frame(b"y" * 60, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True)
    wave = channel.apply_cfo(gtx.tx_waveform(cfg, am)[0], 1234.0)
    stream = np.zeros(8 * 3000 + 2000, np.complex64)
    trigs = []
    for i in range(8):
        p = 500 + i * 3000 + int(rng.integers(0, 8))
        stream[p: p + len(wave)] = wave
        trigs.append(p)
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    return (channel.awgn(stream, rms / 10 ** (25 / 20), rng).astype(
        np.complex64), np.asarray(trigs, np.int32))


@pytest.mark.parametrize("n", [5000, 70000], ids=["short", "blocked"])
def test_stf_metrics_matches(n):
    """Per-sample STF metric on noise with packets; the long case takes
    the 32k-block moving sums of a multi-megasample stream."""
    rng = np.random.default_rng(n)
    _, cfg, am = _mk_cfg(rng)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05
    for p in range(700, n - len(wave), 4 * len(wave)):
        x[p: p + len(wave)] += wave
    x = x.astype(np.complex64)
    mj, cj = JFE.stf_metrics(from_host(x))
    mp, cp = PFE.stf_metrics(from_numpy_cf(x, "cpu"))
    assert np.array_equal(np.asarray(cj.re), cp.re.numpy())
    assert np.array_equal(np.asarray(cj.im), cp.im.numpy())
    assert mp.shape == np.asarray(mj).shape
    assert np.abs(np.asarray(mj) - mp.numpy()).max() < 1e-6


def _sync_windows(sync_stream):
    stream, trigs = sync_stream
    jw = JFE.gather_windows_bf16(from_host(stream[None])[0],
                                 jnp.asarray(trigs), 464)
    pw = PFE.gather_windows_bf16(from_numpy_cf(stream, "cpu"),
                                 torch.from_numpy(trigs), 464)
    return jw, pw


def test_ltf_fine_sync_matches(sync_stream):
    jw, pw = _sync_windows(sync_stream)
    off_j, peak_j = JFE.ltf_fine_sync(jw[:, 80:448])
    off_p, peak_p = PFE.ltf_fine_sync(pw[:, 80:448])
    assert off_p.dtype == torch.int32
    assert np.array_equal(np.asarray(off_j), off_p.numpy())
    np.testing.assert_allclose(peak_p.numpy(), np.asarray(peak_j), rtol=1e-6)


def test_fine_cfo_batch_matches(sync_stream):
    """The port's fine_cfo_batch against the reference's on the same LTF
    windows, and (tests/test_spec.py's fusion check, on the port) the two
    halves ltf_fine_sync -> 128-sample row -> fine_cfo_batch against the
    fused ltf_fine_sync_cfo: same offsets and peaks, CFO within 0.01 Hz."""
    jw, pw = _sync_windows(sync_stream)
    cfo0 = PFE.coarse_cfo_batch(pw[:, :80])
    off, peak = PFE.ltf_fine_sync(pw[:, 80:448])
    rows = (80 + off.long())[:, None] + torch.arange(128)[None]
    ltf = PCF(torch.gather(pw.re, 1, rows), torch.gather(pw.im, 1, rows))
    cfo_two = PFE.fine_cfo_batch(ltf, cfo0)
    off_f, peak_f, cfo_f, _ = PFE.ltf_fine_sync_cfo(pw[:, 80:448], cfo0)
    assert torch.equal(off, off_f) and torch.allclose(peak, peak_f)
    assert (cfo_two - cfo_f).abs().max() < 0.01
    assert (cfo_f.abs() - 1234.0).abs().max() < 500   # the CFO sent
    cfo_j = JFE.fine_cfo_batch(JCF(jnp.asarray(ltf.re.numpy()),
                                   jnp.asarray(ltf.im.numpy())),
                               jnp.asarray(cfo0.numpy()))
    assert np.abs(np.asarray(cfo_j) - cfo_two.numpy()).max() < 0.5


# ---------------------------------------------------------------------------
# the sharded programs
# ---------------------------------------------------------------------------

def test_extend_matches_numpy():
    """Block + the left neighbour's tail + the right neighbour's head,
    circularly: the reference's two ppermutes."""
    rng = np.random.default_rng(5)
    n_blk, k, lh, halo = 4, 10, 3, 6
    x = (rng.normal(size=n_blk * k) + 1j * rng.normal(size=n_blk * k)
         ).astype(np.complex64)
    blocks = PM._split(from_numpy_cf(x, "cpu"), ["cpu"] * n_blk)
    for i in range(n_blk):
        idx = (i * k + np.arange(-lh, k + halo)) % (n_blk * k)
        for lh_i, sl in ((lh, idx), (0, idx[lh:])):
            got = PM._extend(blocks, i, lh_i, halo)
            assert np.array_equal(got.re.numpy() + 1j * got.im.numpy(), x[sl])
    with pytest.raises(ValueError):
        PM._extend(blocks, 0, 0, k + 1)


def test_frontend_sp_matches():
    """tests/test_mesh.py's seed-13 stream: the (8, 64) candidate arrays
    are equal, and give one trigger per packet."""
    rng = np.random.default_rng(13)
    _, cfg, am = _mk_cfg(rng)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    stream = _pad8(channel.frame_stream(wave, 1.0, 0.0, num=6, gap=2000)[0])
    jm = _jmesh("sp")
    with jm:
        ref = np.asarray(JM.frontend_sp(jm, max_out_per_shard=64)(
            from_host(stream)))
    got = PM.frontend_sp(_pmesh("sp"), max_out_per_shard=64)(
        from_numpy_cf(stream, "cpu")).numpy()
    assert got.shape == (N, 64) and got.dtype == np.int32
    assert np.array_equal(ref.reshape(N, 64), got)
    from gr_ieee80211_tpu_torch.models.rx import dedup_triggers
    assert len(dedup_triggers(np.sort(got[got >= 0]))) == 6


def _dp_windows(nrx):
    """(cfg, mpdu_len, (16, [nrx,] n_samp) windows): tests/test_mesh.py's
    seed-7 windows for nrx 1; for nrx 2 the dry run's VHT MCS2 2-SS packet
    through a seeded 2x2 mix."""
    if nrx == 1:
        rng = np.random.default_rng(7)
        mpdu, cfg, am = _mk_cfg(rng)
        wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
        n_samp = JM.payload_decode_dp(cfg, _jmesh("dp"), len(mpdu))[1]
        return cfg, len(mpdu), np.tile(wave[188: 188 + n_samp][None], (16, 1))
    rng = np.random.default_rng(0)
    mpdu = mac.qos_data_frame(b"x" * 40, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 2, 2, len(am), ampdu=True)
    h2 = np.eye(2) + 0.25 * (rng.normal(size=(2, 2))
                             + 1j * rng.normal(size=(2, 2)))
    mixed = h2 @ gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)
    n_samp = JM.payload_decode_dp(cfg, _jmesh("dp"), len(mpdu), nrx=2)[1]
    return cfg, len(mpdu), np.tile(mixed[:, 188: 188 + n_samp][None],
                                   (16, 1, 1))


@pytest.mark.parametrize("nrx", [1, 2])
def test_payload_decode_dp_matches(nrx):
    cfg, ml, wins = _dp_windows(nrx)
    wins = wins.astype(np.complex64)
    jm = _jmesh("dp")
    step, n_samp = JM.payload_decode_dp(cfg, jm, mpdu_len=ml, nrx=nrx)
    with jm:
        ref = [np.asarray(v) for v in step(from_host(wins))]
    pstep, pn = PM.payload_decode_dp(from_reference(cfg), _pmesh("dp"),
                                     mpdu_len=ml, nrx=nrx)
    got = [v.numpy() for v in pstep(from_numpy_cf(wins, "cpu"))]
    assert pn == n_samp == wins.shape[-1]
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    assert int(got[2]) == 16 and got[1].all()


@pytest.mark.parametrize("snr,seed", [(30.0, 11), (11.0, 19)],
                         ids=["clean", "noisy"])
def test_rx_chain_sp_matches(snr, seed):
    """12 packets across 8 shards, some straddling a shard boundary: the
    global (n_ok, n_det) equal the reference's.  At 11 dB some packets
    fail FCS; there the counts are exact on a host whose XLA:CPU LTF
    metric is the one measured, and within one packet elsewhere."""
    rng = np.random.default_rng(seed)
    mpdu, cfg, am = _mk_cfg(rng)
    wave = gtx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    stream = channel.frame_stream(wave, 1.0, 600.0, num=12, gap=1400)[0]
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = _pad8(channel.awgn(stream[None], rms / 10 ** (snr / 20), rng)[0])
    blk = len(stream) // N
    starts = 1000 + np.arange(12) * (len(wave) + 1400)
    assert any(s // blk != (s + len(wave)) // blk for s in starts)
    jm = _jmesh("sp")
    chain, halo = JM.rx_chain_sp(cfg, jm, mpdu_len=len(mpdu),
                                 max_pkts_per_shard=16)
    with jm:
        ref = tuple(int(x) for x in chain(from_host(stream)))
    pchain, phalo = PM.rx_chain_sp(from_reference(cfg), _pmesh("sp"),
                                   mpdu_len=len(mpdu), max_pkts_per_shard=16)
    got = tuple(int(x) for x in pchain(from_numpy_cf(stream, "cpu")))
    assert phalo == halo
    assert ref[1] == 12
    if snr >= 30.0:
        assert got == ref == (12, 12)
        return
    assert ref[0] < 12                  # the noisy case loses packets
    if ltf_metric_as_measured():
        assert got == ref
    else:
        assert got[1] == ref[1] and abs(got[0] - ref[0]) <= 1


def _mu_capture(rng):
    """The dry run's MU capture: user 0 of a two-user ZF-precoded PPDU
    heard through its 1x2 channel; returns (user 0's config, mpdu_len,
    (6144,) capture)."""
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    mpdu = mac.qos_data_frame(b"x" * 40, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    am1 = mac.ampdu_aggregate_vht([mac.qos_data_frame(
        b"u1" * 12, "02:00:00:00:00:11", "02:00:00:00:00:01",
        "02:00:00:00:00:11", 2)])
    mu = MuConfig((PhyConfig(Fmt.VHT, 2, 1, len(am), ampdu=True),
                   PhyConfig(Fmt.VHT, 1, 1, len(am1), ampdu=True)),
                  group_id=2)
    h_rows = np.repeat(np.stack(h_sta)[:, 0][:, :, None], 56, axis=2)
    q = sounding.q_to_grid(sounding.zf_q(h_rows))
    burst = channel.mimo_channel(gtx.tx_waveform_mu(mu, [am, am1], q),
                                 h_sta[0])[0]
    one = np.zeros(6144, np.complex64)
    one[512: 512 + len(burst)] = burst.astype(np.complex64)
    u0 = mu.users[0]
    return (PhyConfig(Fmt.VHT, u0.mcs, 1, u0.psdu_len, ampdu=True,
                      mu_nsym=mu.nsym), len(mpdu), one)


def test_mu_chain_dp_matches():
    """The dry run's MU capture, one capture a shard, each with its own
    noise from 6 to 30 dB (the 6 dB one fails): equal (n_ok, n_det),
    exact under the LTF-metric gate, within one packet elsewhere."""
    rng = np.random.default_rng(0)
    cfg, ml, one = _mu_capture(rng)
    rms = np.sqrt(np.mean(np.abs(one[one != 0]) ** 2))
    caps = np.stack([channel.awgn(one, rms / 10 ** (snr / 20), rng)
                     for snr in np.linspace(6, 30, N)]).astype(np.complex64)
    jm = _jmesh("dp")
    with jm:
        ref = tuple(int(x) for x in JM.mu_chain_dp(
            cfg, jm, n_total=2, own=0, mpdu_len=ml)(from_host(caps)))
    got = tuple(int(x) for x in PM.mu_chain_dp(
        from_reference(cfg), _pmesh("dp"), n_total=2, own=0, mpdu_len=ml)(
            from_numpy_cf(caps, "cpu")))
    assert got[1] == ref[1] == N and 0 < ref[0] < N
    if ltf_metric_as_measured():
        assert got == ref
    else:
        assert abs(got[0] - ref[0]) <= 1


# ---------------------------------------------------------------------------
# the entry twin
# ---------------------------------------------------------------------------

def test_entry_matches_jax():
    """The flagship step on its seeded noise input: the PSDU bytes equal
    the JAX entry's (the noise rows decode to the same bits: none of
    their LLRs falls within float32 rounding of a Viterbi tie)."""
    import __graft_entry__ as GE
    jfn, jargs = GE.entry()
    ref = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = PE.entry("cpu")
    assert all(a.device.type == "cpu" for a in (args[0].re, *args[1:]))
    got = fn(*args).numpy()
    assert got.shape == ref.shape == (8, 549) and got.dtype == np.uint8
    assert np.array_equal(got, ref)


def test_entry_on_real_packets():
    """The entry's step on 8 real VHT MCS7 520 B packets (30 dB) at their
    LTF windows: the port's bytes equal the JAX step's and the bytes
    sent."""
    import __graft_entry__ as GE
    jfn, _ = GE.entry()
    fn, _ = PE.entry("cpu")
    rng = np.random.default_rng(3)
    cfg = PhyConfig(Fmt.VHT, 7, 1, 520, ampdu=True)
    sent = [bytes(rng.integers(0, 256, 520, dtype=np.uint8)) for _ in range(8)]
    waves = [gtx.tx_waveform(cfg, p, group_id=0, partial_aid=0)[0]
             for p in sent]
    span = len(waves[0]) + 300
    stream = np.zeros(8 * span + 400, np.complex64)
    for i, w in enumerate(waves):
        stream[200 + i * span: 200 + i * span + len(w)] = w
    rms = np.sqrt(np.mean(np.abs(waves[0]) ** 2))
    stream = channel.awgn(stream, rms / 10 ** (30 / 20), rng).astype(
        np.complex64)[None]
    ltf = (200 + 188 + span * np.arange(8)).astype(np.int32)
    cfo = np.zeros(8, np.float32)
    ref = np.asarray(jax.jit(jfn)(from_host(stream), jnp.asarray(ltf),
                                  jnp.asarray(cfo)))
    got = fn(from_numpy_cf(stream, "cpu"), torch.from_numpy(ltf),
             torch.from_numpy(cfo)).numpy()
    assert np.array_equal(got, ref)
    assert all(bytes(got[i, :520]) == sent[i] for i in range(8))


def test_dryrun_multichip_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        PE.dryrun_multichip(N, device="cpu")
    assert buf.getvalue().strip() == (
        "dryrun ok: dp decoded 16/16, sp detected 14/14 packets, sp chain "
        "decoded 16/16, dp 2x2 decoded 16/16, dp MU decoded 8/8")


@pytest.mark.parametrize("call", [
    lambda: PM.make_mesh(2), lambda: PE.entry(),
    lambda: PE.dryrun_multichip(2)], ids=["make_mesh", "entry", "dryrun"])
def test_the_card_is_the_default(call):
    """Without an argument the entry points run on the card, and without
    one they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        call()


def test_mesh_shapes():
    """The reference's shape rules, round-robin placement on the CPU."""
    for n, axes, shape in ((8, ("dp",), (8,)), (8, ("dp", "sp"), (2, 4)),
                           (6, ("dp", "sp"), (2, 3)), (7, ("dp", "sp"), (1, 7))):
        m = PM.make_mesh(n, axes=axes, device="cpu")
        assert m.shape == shape and m.axis_names == axes
        assert len(m.devices) == n and len(m.shards) == shape[-1]
        assert JM.make_mesh(n, axes=axes).devices.shape == shape
