"""Viterbi ACS (K1) / traceback (K2) twins, their packed variants (K4 /
K5) and decode host side vs the Pallas reference (interpret mode on the
CPU), and the plain SIG-field decoder (K6's twin) vs the reference's XLA
one: bit-exact.

The port's plain PyTorch twins stand in for the CUDA kernels on the CPU;
the kernels themselves are held to the twins on the card (the ``gpu``
test here and ``chip_smoke.py``).
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gr_ieee80211_tpu.gold import bits as GB
from gr_ieee80211_tpu.ops import viterbi as JV
from gr_ieee80211_tpu.ops import viterbi_pallas as JVP
from gr_ieee80211_tpu_torch.ops import cuda_lib as PCL
from gr_ieee80211_tpu_torch.ops import viterbi as PV
from gr_ieee80211_tpu_torch.ops import viterbi_kernels as PVK

torch.set_num_threads(2)


def _planes(rng, T_, B_):
    """Random LLR planes with zero runs (punctured positions and the zero
    tail padding tie the ACS candidates)."""
    l0 = rng.normal(size=(T_, B_)).astype(np.float32) * 3.0
    l1 = rng.normal(size=(T_, B_)).astype(np.float32) * 3.0
    l1[1::3] = 0.0
    head, tail = (40, 70) if T_ > 128 else (8, 10)
    l0[: head] = 0.0
    l0[-tail:] = 0.0
    l1[-tail:] = 0.0
    return l0, l1


def _pm0(kind, B_):
    """(64, B) initial metrics, the reference's layout (None = pinned)."""
    if kind == "pinned":
        return None
    if kind == "uniform":
        return np.zeros((64, B_), np.float32)
    return np.random.default_rng(2).normal(size=(64, B_)).astype(np.float32)


def _pairs(l0, l1):
    """(T, B) planes -> the port's packet-major (B, T, 2) LLR pairs."""
    return torch.from_numpy(np.ascontiguousarray(np.stack([l0.T, l1.T], -1)))


def _port_pm0(pm0):
    return None if pm0 is None else torch.from_numpy(
        np.ascontiguousarray(pm0.T))


def _jax_planes(l0, l1, B_):
    """The reference kernels want the batch on a 128 multiple: pad with
    zero-LLR packets; callers drop the padding columns."""
    pad = -B_ % 128
    return (jnp.asarray(np.pad(l0, ((0, 0), (0, pad)))),
            jnp.asarray(np.pad(l1, ((0, 0), (0, pad)))))


def _jax_pm0(pm0, B_):
    if pm0 is None:
        return None
    return jnp.asarray(np.pad(pm0, ((0, 0), (0, -B_ % 128))))


@pytest.mark.parametrize("kind,T_,B_", [
    ("pinned", 320, 128), ("uniform", 320, 128), ("random", 320, 128),
    ("uniform", 128, 37), ("pinned", 128, 1), ("random", 64, 33)])
def test_acs_twin_matches_pallas(kind, T_, B_):
    """K1's twin (packet-major, decision words) == the Pallas kernel
    (interpret mode), decisions through ``planes_from_words``; also B not
    a multiple of 32, B = 1 and a single chunk T = 64."""
    rng = np.random.default_rng(1)
    l0, l1 = _planes(rng, T_, B_)
    pm0 = _pm0(kind, B_)
    jd = JVP.acs_sweep(*_jax_planes(l0, l1, B_), _jax_pm0(pm0, B_),
                       interpret=True)
    dec, pm = PVK.acs_sweep(_pairs(l0, l1), _port_pm0(pm0))
    assert dec.dtype == torch.int32 and dec.shape == (B_, T_, 2)
    assert pm.dtype == torch.float32 and pm.shape == (B_, 64)
    dec_lo, dec_hi = PVK.planes_from_words(dec)
    assert dec_lo.dtype == torch.uint8
    assert np.array_equal(np.asarray(jd[0])[:, :, :B_], dec_lo.numpy())
    assert np.array_equal(np.asarray(jd[1])[:, :, :B_], dec_hi.numpy())
    assert np.array_equal(np.asarray(jd[2])[:, :B_], pm.numpy().T)
    assert torch.equal(PVK.words_from_planes(dec_lo, dec_hi), dec)


def test_words_planes_roundtrip():
    """``words_from_planes(planes_from_words(x)) == x`` for any words,
    sign bit included, and the other way round for any 0/1 planes."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (5, 64, 2),
                                      dtype=np.int64).astype(np.int32))
    x[0, 0] = torch.tensor([-1, -2 ** 31], dtype=torch.int32)
    lo, hi = PVK.planes_from_words(x)
    assert lo.shape == (64, 32, 5) and int(lo.max()) == 1
    assert torch.equal(PVK.words_from_planes(lo, hi), x)
    planes = torch.from_numpy(rng.integers(0, 2, (2, 64, 32, 3),
                                           dtype=np.uint8))
    back = PVK.planes_from_words(PVK.words_from_planes(planes[0], planes[1]))
    assert torch.equal(back[0], planes[0]) and torch.equal(back[1], planes[1])


@pytest.mark.parametrize("start,T_,B_", [
    ("state0", 256, 128), ("argmax", 256, 128), ("argmax", 128, 37),
    ("state0", 128, 1), ("argmax", 64, 33)])
def test_traceback_twin_matches_pallas(start, T_, B_):
    """K2's twin over the words of the Pallas kernel's planes == the
    Pallas traceback (interpret mode)."""
    rng = np.random.default_rng(2)
    l0, l1 = _planes(rng, T_, B_)
    pm0 = np.zeros((64, B_), np.float32)
    dl, dh, pm = JVP.acs_sweep(*_jax_planes(l0, l1, B_), _jax_pm0(pm0, B_),
                               interpret=True)
    if start == "state0":
        mask0, s0 = None, None
    else:
        best = np.asarray(jnp.argmax(pm, axis=0))
        mask0 = jnp.asarray((np.arange(64)[:, None] == best[None])
                            .astype(np.float32))
        s0 = PVK.argmax_start(torch.from_numpy(np.array(pm).T[:B_].copy()))
        assert np.array_equal(s0.numpy(), best[:B_].astype(np.int32))
    ref = np.asarray(JVP.traceback_sweep(dl, dh, mask0, interpret=True))
    dec = PVK.words_from_planes(
        torch.from_numpy(np.asarray(dl)[:, :, :B_].astype(np.uint8)),
        torch.from_numpy(np.asarray(dh)[:, :, :B_].astype(np.uint8)))
    got = PVK.traceback_sweep(dec, s0)
    assert got.dtype == torch.uint8 and got.shape == (B_, T_)
    assert np.array_equal(ref[:, :B_].astype(np.uint8), got.numpy().T)


def _coded_llr(rng, B_, T_, sigma):
    msg = rng.integers(0, 2, (B_, T_)).astype(np.uint8)
    msg[:, -6:] = 0
    llr = np.empty((B_, T_, 2), np.float32)
    for i in range(B_):
        enc = GB.bcc_encode(msg[i]).astype(np.float32)
        llr[i] = (2 * enc - 1).reshape(-1, 2)
    llr += rng.normal(size=llr.shape).astype(np.float32) * sigma
    return llr, msg


@pytest.mark.parametrize("B_,T_,sigma", [(5, 200, 0.3), (130, 100, 0.3),
                                         (7, 391, 1.0)])
def test_viterbi_decode_matches_pallas(B_, T_, sigma):
    """Monolithic decode (T padded to 64, no batch padding) == the Pallas
    decode bit for bit, noisy enough that the trellis does real work."""
    rng = np.random.default_rng(6)
    llr, msg = _coded_llr(rng, B_, T_, sigma)
    ref = np.asarray(JVP.viterbi_decode_pallas(jnp.asarray(llr),
                                               segmented="auto"))
    got = PVK.viterbi_decode(torch.from_numpy(llr))
    assert got.dtype == torch.uint8 and got.shape == (B_, T_)
    assert np.array_equal(ref, got.numpy())
    if sigma < 0.5:
        assert np.array_equal(got.numpy(), msg)


def test_segmented_decode_matches_pallas():
    rng = np.random.default_rng(5)
    llr, msg = _coded_llr(rng, 4, 2200, 0.4)
    ref = np.asarray(JVP.viterbi_decode_pallas(jnp.asarray(llr),
                                               segmented=True))
    got = PVK._viterbi_decode_segmented(torch.from_numpy(llr))
    assert np.array_equal(ref, got.numpy())
    assert np.array_equal(got.numpy(), msg)
    mono = PVK.viterbi_decode(torch.from_numpy(llr))
    assert np.array_equal(mono.numpy(), got.numpy())


@pytest.mark.parametrize("cr", ["1/2", "2/3", "3/4", "5/6"])
def test_depuncture_matches(cr):
    rng = np.random.default_rng(3)
    T_ = 331
    _, nk = JV.depuncture_indices(cr, T_)
    llr = rng.normal(size=(3, nk + 5)).astype(np.float32)
    ref = np.asarray(JV.depuncture(jnp.asarray(llr), cr, T_))
    got = PV.depuncture(torch.from_numpy(llr), cr, T_)
    assert np.array_equal(ref, got.numpy())


def test_wrappers_check_inputs_and_count_only_kernels():
    """Bad shapes/dtypes raise; CPU tensors run the twin without touching
    the launch counters (they count kernel launches only)."""
    PVK.reset_launch_counts()
    x = torch.zeros((4, 64, 2))
    with pytest.raises(ValueError):
        PVK.acs_sweep(torch.zeros((4, 60, 2)))
    with pytest.raises(ValueError):
        PVK.acs_sweep(torch.zeros((64, 4)))
    with pytest.raises(ValueError):
        PVK.acs_sweep(x.double())
    with pytest.raises(ValueError):
        PVK.acs_sweep(x, torch.zeros((64, 4)))
    dec, pm = PVK.acs_sweep(x)
    with pytest.raises(ValueError):
        PVK.traceback_sweep(dec, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        PVK.traceback_sweep(dec.to(torch.int64))
    bits = PVK.traceback_sweep(dec)
    assert bits.shape == (4, 64) and not bits.any()
    assert PVK.acs_sweep.launches == 0 and PVK.traceback_sweep.launches == 0


@pytest.mark.gpu
def test_kernels_match_twins_on_card():
    """K1/K2 on the card == their twins on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(4)
    dev = torch.device("cuda", 0)
    for T_, B_ in ((640, 300), (64, 1), (128, 37)):
        llr = _pairs(*_planes(rng, T_, B_)).to(dev)
        for pm0 in (None, torch.zeros((B_, 64), device=dev)):
            got = PVK.acs_sweep(llr, pm0)
            ref = PVK.acs_sweep_ref(llr, PVK.state0_metrics(B_, dev)
                                    if pm0 is None else pm0)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
            for s0 in (PVK.state0_start(B_, dev), PVK.argmax_start(got[1])):
                assert torch.equal(PVK.traceback_sweep(got[0], s0),
                                   PVK.traceback_ref(got[0], s0))


def _sig_llrs(rng, B_, T_):
    """Noisy SIG-like LLR pairs with ties: punctured-style zeros, exact
    integer values and runs of equal magnitudes."""
    x = (rng.normal(size=(B_, T_, 2)) * 2.0).astype(np.float32)
    x[:, ::3, 1] = 0.0
    x[: B_ // 4] = np.round(x[: B_ // 4])
    x[B_ // 4: B_ // 2] = np.sign(x[B_ // 4: B_ // 2])
    return x


@pytest.mark.parametrize("T_", [24, 26, 48, 200])
@pytest.mark.parametrize("from_zero", [True, False])
def test_plain_viterbi_decode_matches_xla(T_, from_zero):
    """The SIG decoder (CHUNK = 54 renormalization, strict cand1 > cand0,
    traceback from state 0 or the argmax) == the reference's XLA one."""
    rng = np.random.default_rng(T_)
    x = _sig_llrs(rng, 64, T_)
    ref = np.asarray(JV.viterbi_decode(jnp.asarray(x),
                                       traceback_from_zero=from_zero))
    got = PV.viterbi_decode(torch.from_numpy(x), from_zero)
    assert got.dtype == torch.uint8 and np.array_equal(ref, got.numpy())


def test_plain_viterbi_stacked_rows_equal_separate():
    """Trellises padding to the same 54-step chunk decode as one stacked
    batch bit-equal to separate calls (how the SIG core decodes L-SIG,
    HT-SIG and VHT-SIG-A together)."""
    rng = np.random.default_rng(9)
    a, b = _sig_llrs(rng, 8, 24), _sig_llrs(rng, 8, 48)
    sep = [PV.viterbi_decode(torch.from_numpy(v)).numpy() for v in (a, b)]
    pad = np.concatenate([a, np.zeros((8, 24, 2), np.float32)], axis=1)
    both = PV.viterbi_decode(torch.from_numpy(np.concatenate([pad, b])))
    assert np.array_equal(both[:8, :24].numpy(), sep[0])
    assert np.array_equal(both[8:].numpy(), sep[1])
    assert np.array_equal(PV.decode_coded_llrs(
        torch.from_numpy(b.reshape(8, -1)), "1/2", 48).numpy(), sep[1])


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 26)), torch.zeros((4, 26, 3)), torch.zeros((26, 2)),
    torch.zeros((4, 26, 2), dtype=torch.float64),
    torch.zeros((4, 26, 2), dtype=torch.bfloat16),
    torch.zeros((4, 26, 2), device="meta")])
def test_scan_viterbi_wrapper_checks_inputs(bad):
    """K6's wrapper refuses what the kernel cannot take: shapes other than
    (B, T, 2), dtypes other than float32, devices other than one CPU or
    CUDA device; no launch is counted."""
    PCL.reset_launch_counts()
    with pytest.raises(ValueError):
        PV.scan_viterbi(bad)
    assert PV.scan_viterbi.launches == 0


@pytest.mark.parametrize("T_,B_", [(24, 3), (26, 8), (48, 1), (55, 5),
                                   (0, 2), (26, 0)])
@pytest.mark.parametrize("from_zero", [True, False])
def test_scan_viterbi_runs_the_twin_on_cpu(T_, B_, from_zero):
    """CPU tensors take the twin, through ``scan_viterbi`` and through
    ``viterbi_decode`` (which hands it float32), and count no launch."""
    PCL.reset_launch_counts()
    x = torch.from_numpy(_sig_llrs(np.random.default_rng(T_), B_, T_))
    ref = PV.viterbi_decode_ref(x, from_zero)
    assert ref.dtype == torch.uint8 and ref.shape == (B_, T_)
    assert torch.equal(PV.scan_viterbi(x, from_zero), ref)
    assert torch.equal(PV.viterbi_decode(x.double(), from_zero), ref)
    assert PV.scan_viterbi.launches == 0
    assert PCL.launch_counts()["scan_viterbi"] == 0


def test_scan_viterbi_source_matches_wrapper():
    """The C entry point, its argument list and the constants K6 shares
    with its wrapper agree: CHUNK, the shared-memory step limit, and
    (llr, bits, decisions, n_steps, batch, from_zero, stream)."""
    src = (PCL.CSRC / "scan_viterbi.cu").read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == PV.CHUNK
    assert (int(re.search(r"kSmemSteps = (\d+);", src).group(1))
            == PV.SMEM_STEPS)
    sig = re.search(r"int gr80211_scan_viterbi\(([^)]*)\)", src).group(1)
    args = [a.split()[-1].lstrip("*") for a in sig.split(",")]
    assert args == ["llr", "bits", "decisions", "n_steps", "batch",
                    "from_zero", "stream"]
    types = PCL._ENTRY_POINTS["gr80211_scan_viterbi"]
    assert types == [PCL._VP] * 3 + [PCL._CI] * 3 + [PCL._VP]
    assert PCL.CSRC / "scan_viterbi.cu" in PCL.sources()


@pytest.mark.parametrize("kind", ["pinned", "uniform"])
def test_packed_twins_match_pallas(kind):
    """K4/K5 twins vs the reference's packed Pallas kernels (interpret
    mode, T = 256, B = 128): planes equal as values (the port's uint8 vs
    the reference's int8 0..15), final metrics and bits exact, and equal
    to the unpacked K1/K2 twins."""
    rng = np.random.default_rng(11)
    T_, B_ = 256, 128
    l0, l1 = _planes(rng, T_, B_)
    pm0 = _pm0(kind, B_)
    jpm0 = None if pm0 is None else jnp.asarray(pm0)
    jd = JVP.acs_sweep_packed(jnp.asarray(l0), jnp.asarray(l1), jpm0,
                              interpret=True)
    tl0, tl1 = torch.from_numpy(l0), torch.from_numpy(l1)
    tpm0 = None if pm0 is None else torch.from_numpy(pm0)
    pd = PVK.acs_sweep_packed(tl0, tl1, tpm0)
    assert pd[0].dtype == torch.uint8 and pd[0].shape == (T_ // 4, 32, B_)
    for a, b in zip(jd, pd):
        assert np.array_equal(np.asarray(a).astype(np.float32),
                              b.numpy().astype(np.float32))
    dec, pm = PVK.acs_sweep(_pairs(l0, l1), _port_pm0(pm0))
    dl, dh = PVK.planes_from_words(dec)
    assert torch.equal(PVK.pack_planes(dl), pd[0])
    assert torch.equal(PVK.pack_planes(dh), pd[1]) and torch.equal(pm.T, pd[2])
    best = np.asarray(jnp.argmax(jd[2], axis=0))
    mask0 = jnp.asarray((np.arange(64)[:, None] == best[None])
                        .astype(np.float32))
    for jmask, start in ((None, None),
                         (mask0, torch.from_numpy(best.astype(np.int32)))):
        ref = np.asarray(JVP.traceback_sweep_packed(jd[0], jd[1], jmask,
                                                    interpret=True))
        got = PVK.traceback_sweep_packed(pd[0], pd[1], start)
        assert got.dtype == torch.uint8
        assert np.array_equal(ref, got.numpy().astype(np.float32))
        assert torch.equal(got, PVK.traceback_sweep(dec, start).T)


@pytest.mark.parametrize("kind,T_,B_", [
    ("uniform", 128, 37), ("pinned", 64, 33), ("random", 64, 100),
    ("pinned", 128, 1), ("uniform", 192, 130)])
def test_packed_twins_match_pallas_shapes(kind, T_, B_):
    """K4/K5 twins == the packed Pallas kernels (interpret mode) where the
    batch is no multiple of 32 or 128 on the port's side (the reference
    gets it padded with zero-LLR packets), B = 1 and a single chunk
    T = 64; traceback from state 0 and from the argmax.  Exact."""
    rng = np.random.default_rng(12)
    l0, l1 = _planes(rng, T_, B_)
    pm0 = _pm0(kind, B_)
    jd = JVP.acs_sweep_packed(*_jax_planes(l0, l1, B_), _jax_pm0(pm0, B_),
                              interpret=True)
    pd = PVK.acs_sweep_packed(torch.from_numpy(l0), torch.from_numpy(l1),
                              None if pm0 is None else torch.from_numpy(pm0))
    assert pd[0].dtype == torch.uint8 and pd[0].shape == (T_ // 4, 32, B_)
    assert pd[2].dtype == torch.float32 and pd[2].shape == (64, B_)
    assert int(pd[0].max()) <= 15 and int(pd[1].max()) <= 15
    for a, b in zip(jd, pd):
        assert np.array_equal(np.asarray(a)[..., :B_].astype(np.float32),
                              b.numpy().astype(np.float32))
    best = np.asarray(jnp.argmax(jd[2], axis=0))
    mask0 = jnp.asarray((np.arange(64)[:, None] == best[None])
                        .astype(np.float32))
    s0 = torch.from_numpy(best[:B_].astype(np.int32))
    assert torch.equal(PVK.argmax_start(pd[2].T.contiguous()), s0)
    for jmask, start in ((None, None), (mask0, s0)):
        ref = np.asarray(JVP.traceback_sweep_packed(jd[0], jd[1], jmask,
                                                    interpret=True))
        got = PVK.traceback_sweep_packed(pd[0], pd[1], start)
        assert got.dtype == torch.uint8 and got.shape == (T_, B_)
        assert np.array_equal(ref[:, :B_], got.numpy().astype(np.float32))


def test_pack_unpack_roundtrip():
    """``unpack_planes(pack_planes(x)) == x`` for any 0/1 planes and
    ``pack_planes(unpack_planes(y)) == y`` for any bytes 0..15; bit i of
    a byte is step 4q+i."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.integers(0, 2, (64, 32, 5), dtype=np.uint8))
    y = PVK.pack_planes(x)
    assert y.dtype == torch.uint8 and y.shape == (16, 32, 5)
    assert torch.equal(PVK.unpack_planes(y), x)
    assert torch.equal(y[3], x[12] + 2 * x[13] + 4 * x[14] + 8 * x[15])
    z = torch.from_numpy(rng.integers(0, 16, (16, 32, 7), dtype=np.uint8))
    u = PVK.unpack_planes(z)
    assert u.shape == (64, 32, 7) and int(u.max()) == 1
    assert torch.equal(PVK.pack_planes(u), z)


def test_packed_wrappers_check_inputs():
    PVK.reset_launch_counts()
    x = torch.zeros((64, 4))
    with pytest.raises(ValueError):
        PVK.acs_sweep_packed(torch.zeros((60, 4)), torch.zeros((60, 4)))
    dl, dh, _ = PVK.acs_sweep_packed(x, x)
    with pytest.raises(ValueError):
        PVK.traceback_sweep_packed(dl.to(torch.int8), dh)
    assert not PVK.traceback_sweep_packed(dl, dh).any()
    assert PVK.acs_sweep_packed.launches == 0
    assert PVK.traceback_sweep_packed.launches == 0


@pytest.mark.gpu
def test_packed_kernels_match_twins_on_card():
    """K4/K5 on the card == their twins and == K1/K2 on the card, from
    pinned and uniform metrics and from both starts, for both block sizes
    of the kernels (8 packets up to B = 1024, 32 beyond): whole blocks
    (64), a batch that ends inside a block (100, 300, 1100) and one whose
    rows move byte by byte (37, 1037)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(4)
    dev = torch.device("cuda", 0)
    for T_, B_ in ((640, 300), (128, 64), (128, 100), (64, 37),
                   (128, 1100), (64, 1037)):
        planes = _planes(rng, T_, B_)
        l0, l1 = (torch.from_numpy(a).to(dev) for a in planes)
        for pm0 in (PVK.state0_metrics(B_, dev).T.contiguous(),
                    torch.zeros((64, B_), device=dev)):
            got = PVK.acs_sweep_packed(l0, l1, pm0)
            ref = PVK.acs_sweep_packed_ref(l0, l1, pm0)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
            dec, pm = PVK.acs_sweep(_pairs(*planes).to(dev),
                                    pm0.T.contiguous())
            assert torch.equal(pm.T, got[2])
            for s0 in (PVK.state0_start(B_, dev), PVK.argmax_start(pm)):
                bits = PVK.traceback_sweep_packed(got[0], got[1], s0)
                assert torch.equal(
                    bits, PVK.traceback_packed_ref(got[0], got[1], s0))
                assert torch.equal(bits, PVK.traceback_sweep(dec, s0).T)


def test_chip_smoke_reads_ptxas_output():
    """``chip_smoke.ptxas_summary`` names each kernel (a template with its
    argument), its registers, shared memory and spills from ``nvcc
    -Xptxas -v`` output; the script fails a run on any spill."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sym = "_ZN43_GLOBAL__N__7f84d0d6_10_viterbi_cu_58d9a972"
    log = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{sym}17acs_packed_kernelILi8EEEvPKfS2_S2_PhS3_Pfiii' for 'sm_90a'
ptxas info    : Function properties for {sym}17acs_packed_kernelILi8EEEvPKfS2_S2_PhS3_Pfiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size, 12288 bytes smem
ptxas info    : Compiling entry function '{sym}10acs_kernelEPK6float2PKfP5uint2Pfii' for 'sm_90a'
ptxas info    : Function properties for {sym}10acs_kernelEPK6float2PKfP5uint2Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 37 registers, used 0 barriers, 1024 bytes smem
ptxas info    : Compiling entry function '{sym}15derotate_kernelEPKfS1_S1_PfS2_iif' for 'sm_90a'
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 23 registers, used 0 barriers, 32 bytes cumulative stack size
"""
    assert smoke.ptxas_summary(log) == {
        "acs_packed_kernel<8>": {"registers": 64, "smem_bytes": 12288,
                                 "spill_bytes": 8},
        "acs_kernel": {"registers": 37, "smem_bytes": 1024, "spill_bytes": 0},
        "derotate_kernel": {"registers": 23, "smem_bytes": 0,
                            "spill_bytes": 0}}
