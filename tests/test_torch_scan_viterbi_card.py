"""K6 (``csrc/scan_viterbi.cu``, the SIG-field Viterbi decoder in one
launch) against its plain twin ``ops/viterbi.viterbi_decode_ref`` on the
card, bit for bit, at the shapes the receive path gives it.

Every test needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_scan_viterbi_card.py

(the twin itself is held to the JAX package's decoder on the CPU by
``tests/test_torch_viterbi.py``).
"""
import numpy as np
import pytest
import torch

from gr_ieee80211_tpu_torch.ops import cuda_lib as PCL
from gr_ieee80211_tpu_torch.ops import viterbi as PV

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _sig_llrs(rng, B_, T_):
    """SIG-like LLR pairs with ties: punctured zeros, exact integers and
    signs only; with B >= 8 one row carries a NaN and one infinities (a
    padded bucket row divides by a zero channel estimate)."""
    x = (rng.normal(size=(B_, T_, 2)) * 2.0).astype(np.float32)
    x[:, ::3, 1] = 0.0
    x[: B_ // 4] = np.round(x[: B_ // 4])
    x[B_ // 4: B_ // 2] = np.sign(x[B_ // 4: B_ // 2])
    if B_ >= 8:
        x[-1, T_ // 2, 0] = np.nan
        x[-2, 2: 5] = np.inf
        x[-3, 1, 1] = -np.inf
    return torch.from_numpy(x)


def _held(x, from_zero):
    """K6 on ``x`` == the twin on the card; exactly one launch."""
    before = PV.scan_viterbi.launches
    got = PV.viterbi_decode(x, from_zero)
    assert PV.scan_viterbi.launches == before + 1
    ref = PV.viterbi_decode_ref(x, from_zero)
    assert got.dtype == torch.uint8 and got.shape == x.shape[:2]
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("T_", [24, 26, 48, 54, 55, 200])
@pytest.mark.parametrize("B_", [1, 3, 8, 37, 128, 3 * 192])
@pytest.mark.parametrize("from_zero", [True, False])
def test_k6_matches_twin(T_, B_, from_zero):
    """SIG (24, 48), SIG-B (26), one chunk exactly (54), one step past it
    (55) and several chunks (200), across the batch ladder."""
    dev = _card()
    x = _sig_llrs(np.random.default_rng(1000 * T_ + B_), B_, T_).to(dev)
    _held(x, from_zero)


def test_k6_stacked_front_end_call():
    """The front end's one call: L-SIG (24 steps, zero-padded to 48),
    HT-SIG and VHT-SIG-A (48) stacked, equal to the twin and to three
    separate launches."""
    dev = _card()
    rng = np.random.default_rng(5)
    B_ = 37
    lsig, ht, vht = (_sig_llrs(rng, B_, t).to(dev) for t in (24, 48, 48))
    pairs = torch.cat([torch.nn.functional.pad(lsig, (0, 0, 0, 24)), ht,
                       vht])
    bits = _held(pairs, True)
    assert torch.equal(bits[:B_, :24], PV.viterbi_decode(lsig))
    assert torch.equal(bits[B_: 2 * B_], PV.viterbi_decode(ht))
    assert torch.equal(bits[2 * B_:], PV.viterbi_decode(vht))


@pytest.mark.parametrize("from_zero", [True, False])
def test_k6_long_trellis_takes_the_scratch_path(from_zero):
    """T = 4480 (4482 padded steps, past the shared-memory limit): the
    decision words go to a global scratch buffer."""
    dev = _card()
    assert -(-4480 // PV.CHUNK) * PV.CHUNK > PV.SMEM_STEPS
    x = _sig_llrs(np.random.default_rng(7), 64, 4480).to(dev)
    _held(x, from_zero)


def test_k6_noisy_code_words_decode():
    """On BCC code words in noise K6 returns the message (the trellis does
    real work), as the twin does."""
    dev = _card()
    from gr_ieee80211_tpu_torch.gold import bits as GB
    rng = np.random.default_rng(9)
    msg = rng.integers(0, 2, (16, 26)).astype(np.uint8)
    msg[:, -6:] = 0
    enc = np.stack([GB.bcc_encode(m) for m in msg]).astype(np.float32)
    llr = (2 * enc - 1).reshape(16, 26, 2)
    llr += rng.normal(size=llr.shape).astype(np.float32) * 0.4
    got = _held(torch.from_numpy(llr).to(dev), True)
    assert np.array_equal(got.cpu().numpy(), msg)


def test_k6_empty_and_counted():
    """Empty batches or trellises launch nothing; the wrapper's counter is
    the registry's ``scan_viterbi``."""
    dev = _card()
    PCL.reset_launch_counts()
    assert PV.viterbi_decode(torch.zeros((0, 26, 2), device=dev)).shape == (
        0, 26)
    assert PV.viterbi_decode(torch.zeros((3, 0, 2), device=dev)).shape == (
        3, 0)
    assert PCL.launch_counts()["scan_viterbi"] == 0
    PV.viterbi_decode(torch.zeros((3, 26, 2), device=dev))
    assert PCL.launch_counts()["scan_viterbi"] == 1
