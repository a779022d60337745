"""Viterbi ACS (K1) / traceback (K2) twins, their packed variants (K4 /
K5) and decode host side vs the Pallas reference (interpret mode on the
CPU), and the plain SIG-field decoder vs the reference's XLA one:
bit-exact.

The port's plain PyTorch twins stand in for the CUDA kernels on the CPU;
the kernels themselves are held to the twins on the card (the ``gpu``
test here and ``chip_smoke.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gr_ieee80211_tpu.gold import bits as GB
from gr_ieee80211_tpu.ops import viterbi as JV
from gr_ieee80211_tpu.ops import viterbi_pallas as JVP
from gr_ieee80211_tpu_torch.ops import viterbi as PV
from gr_ieee80211_tpu_torch.ops import viterbi_kernels as PVK

torch.set_num_threads(2)


def _planes(rng, T_, B_):
    """Random LLR planes with zero runs (punctured positions and the zero
    tail padding tie the ACS candidates)."""
    l0 = rng.normal(size=(T_, B_)).astype(np.float32) * 3.0
    l1 = rng.normal(size=(T_, B_)).astype(np.float32) * 3.0
    l1[1::3] = 0.0
    l0[: 40] = 0.0
    l0[-70:] = 0.0
    l1[-70:] = 0.0
    return l0, l1


def _pm0(kind, B_):
    if kind == "pinned":
        return None
    if kind == "uniform":
        return np.zeros((64, B_), np.float32)
    return np.random.default_rng(2).normal(size=(64, B_)).astype(np.float32)


@pytest.mark.parametrize("kind", ["pinned", "uniform", "random"])
def test_acs_twin_matches_pallas(kind):
    rng = np.random.default_rng(1)
    T_, B_ = 320, 128
    l0, l1 = _planes(rng, T_, B_)
    pm0 = _pm0(kind, B_)
    jd = JVP.acs_sweep(jnp.asarray(l0), jnp.asarray(l1),
                       None if pm0 is None else jnp.asarray(pm0),
                       interpret=True)
    pd = PVK.acs_sweep(torch.from_numpy(l0), torch.from_numpy(l1),
                       None if pm0 is None else torch.from_numpy(pm0))
    assert np.array_equal(np.asarray(jd[0]), pd[0].numpy())
    assert np.array_equal(np.asarray(jd[1]), pd[1].numpy())
    assert np.array_equal(np.asarray(jd[2]), pd[2].numpy())
    assert pd[0].dtype == torch.uint8 and pd[2].dtype == torch.float32


@pytest.mark.parametrize("start", ["state0", "argmax"])
def test_traceback_twin_matches_pallas(start):
    rng = np.random.default_rng(2)
    T_, B_ = 256, 128
    l0, l1 = _planes(rng, T_, B_)
    pm0 = np.zeros((64, B_), np.float32)
    dl, dh, pm = JVP.acs_sweep(jnp.asarray(l0), jnp.asarray(l1),
                               jnp.asarray(pm0), interpret=True)
    if start == "state0":
        mask0, s0 = None, None
    else:
        best = np.asarray(jnp.argmax(pm, axis=0))
        mask0 = jnp.asarray((np.arange(64)[:, None] == best[None])
                            .astype(np.float32))
        s0 = PVK.argmax_start(torch.from_numpy(np.array(pm)))
        assert np.array_equal(s0.numpy(), best.astype(np.int32))
    ref = np.asarray(JVP.traceback_sweep(dl, dh, mask0, interpret=True))
    got = PVK.traceback_sweep(torch.from_numpy(np.asarray(dl).astype(np.uint8)),
                              torch.from_numpy(np.asarray(dh).astype(np.uint8)),
                              s0)
    assert got.dtype == torch.uint8
    assert np.array_equal(ref.astype(np.uint8), got.numpy())


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
    x = torch.zeros((64, 4))
    with pytest.raises(ValueError):
        PVK.acs_sweep(torch.zeros((60, 4)), torch.zeros((60, 4)))
    with pytest.raises(ValueError):
        PVK.acs_sweep(x.double(), x.double())
    dl, dh, pm = PVK.acs_sweep(x, x)
    with pytest.raises(ValueError):
        PVK.traceback_sweep(dl, dh, torch.zeros(4, dtype=torch.int64))
    bits = PVK.traceback_sweep(dl, dh)
    assert bits.shape == (64, 4) and not bits.any()
    assert PVK.acs_sweep.launches == 0 and PVK.traceback_sweep.launches == 0


@pytest.mark.gpu
def test_kernels_match_twins_on_card():
    """K1/K2 on the card == their twins on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(4)
    dev = torch.device("cuda", 0)
    l0, l1 = (torch.from_numpy(a).to(dev) for a in _planes(rng, 640, 300))
    for pm0 in (None, torch.zeros((64, 300), device=dev)):
        got = PVK.acs_sweep(l0, l1, pm0)
        ref = PVK.acs_sweep_ref(l0, l1, PVK.state0_metrics(300, dev)
                                if pm0 is None else pm0)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        for s0 in (PVK.state0_start(300, dev), PVK.argmax_start(got[2])):
            assert torch.equal(PVK.traceback_sweep(got[0], got[1], s0),
                               PVK.traceback_ref(got[0], got[1], s0))


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
    dl, dh, pm = PVK.acs_sweep(tl0, tl1, tpm0)
    assert torch.equal(PVK.pack_planes(dl), pd[0])
    assert torch.equal(PVK.pack_planes(dh), pd[1]) and torch.equal(pm, pd[2])
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
        assert torch.equal(got, PVK.traceback_sweep(dl, dh, start))


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
    """K4/K5 on the card == their twins and == K1/K2 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(4)
    dev = torch.device("cuda", 0)
    l0, l1 = (torch.from_numpy(a).to(dev) for a in _planes(rng, 640, 300))
    for pm0 in (PVK.state0_metrics(300, dev),
                torch.zeros((64, 300), device=dev)):
        got = PVK.acs_sweep_packed(l0, l1, pm0)
        ref = PVK.acs_sweep_packed_ref(l0, l1, pm0)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        dl, dh, _ = PVK.acs_sweep(l0, l1, pm0)
        for s0 in (PVK.state0_start(300, dev), PVK.argmax_start(got[2])):
            bits = PVK.traceback_sweep_packed(got[0], got[1], s0)
            assert torch.equal(bits, PVK.traceback_packed_ref(got[0], got[1],
                                                              s0))
            assert torch.equal(bits, PVK.traceback_sweep(dl, dh, s0))
