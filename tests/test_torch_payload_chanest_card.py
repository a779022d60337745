"""K7 (``csrc/payload_chanest.cu``, the payload channel estimate of a
bucket in one launch) against its plain twin
``ops/ofdm.payload_chanest_ref`` on the card, at the batch ladder of the
receive path (1, 2, 8, 64) and the chain's 4096 rows, on one and two
antennas, for every branch of the stage: L, HT and VHT (with and without
SIG-B) with one stream, HT and VHT with two, at 30 and 10 dB.

Tolerances: where nothing is summed over the tones (the L and P-matrix
estimates, and a one-stream bucket's estimate before its refinement) K7
is bit-equal to the twin; the refined one-stream estimates lie within
1e-5 of each row's largest |h| (~100 float32 ulps: the twin's 64-tone
sums and its cuBLAS projection take an order the kernel cannot know; a
flipped sign decision or coherence gate would move h by orders of
magnitude more).  Each case prints its largest gap.

Every test needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs where the card is:

    python -m pytest --noconftest -q -s tests/test_torch_payload_chanest_card.py
"""
import pytest
import torch

import _chanest_windows as W
from gr_ieee80211_tpu_torch.ops import ofdm as OF
from gr_ieee80211_tpu_torch.ops.cplx import CF, csum, from_numpy_cf
from gr_ieee80211_tpu_torch.spec.params import Fmt
from gr_ieee80211_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu

BATCHES = (1, 2, 8, 64, 4096)
#: (fmt, mcs, nss, with SIG-B) of the stage's branches
CASES = [(Fmt.L, 5, 1, False), (Fmt.HT, 3, 1, False), (Fmt.VHT, 4, 1, True),
         (Fmt.VHT, 4, 1, False), (Fmt.HT, 11, 2, False),
         (Fmt.VHT, 5, 2, True)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _launches(wrapper: str) -> float:
    """``kernel.<wrapper>.launches`` in the program's counter registry."""
    return trace.snapshot().get(f"kernel.{wrapper}.launches", 0)


def _equal(a: CF, b: CF) -> bool:
    return torch.equal(a.re, b.re) and torch.equal(a.im, b.im)


def _row_gap(got: CF, ref: CF, hmax: torch.Tensor) -> torch.Tensor:
    """Each row's largest gap over its largest |h|."""
    gap = torch.maximum((got.re - ref.re).abs(), (got.im - ref.im).abs())
    return gap.reshape(gap.shape[0], -1).amax(dim=1) / hmax


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0].name}{c[2]}"
                         f"{'sigb' if c[3] else ''}")
@pytest.mark.parametrize("nrx", [1, 2])
@pytest.mark.parametrize("snr", [30.0, 10.0])
def test_k7_matches_twin(case, nrx, snr):
    """One launch a call, at every batch of the ladder; bit-equal where
    nothing is summed over the tones, within 1e-5 of the row's largest
    |h| where the refinement sums."""
    dev = _card()
    fmt, mcs, nss, _ = case
    seed = 1000 * int(fmt) + 100 * nss + 10 * nrx + int(snr)
    cfg, x, sigb_gi = W.windows(fmt, mcs, nss, nrx, max(BATCHES), snr, seed)
    sigb_gi = sigb_gi if case[3] else None
    xs_all = from_numpy_cf(x, dev)
    refine = fmt != Fmt.L and nss == 1
    worst = 0.0
    for B in BATCHES:
        xs = CF(xs_all.re[:B], xs_all.im[:B])
        before = _launches("payload_chanest")
        got = OF.payload_chanest(xs, fmt, cfg.nltf, nss, sigb_gi)
        assert _launches("payload_chanest") == before + 1
        ref = OF.payload_chanest_ref(xs, fmt, cfg.nltf, nss, sigb_gi)
        torch.cuda.synchronize()
        assert got[0].re.shape == ref[0].re.shape == (B, nrx, nss, 64)
        assert got[1].re.shape == ref[1].re.shape == (B, nrx, 4)
        if not refine:
            assert _equal(got[0], ref[0]) and _equal(got[1], ref[1]), B
            continue
        hmax = torch.sqrt(ref[0].re ** 2 + ref[0].im ** 2).reshape(
            B, -1).amax(dim=1)
        gap = torch.maximum(_row_gap(got[0], ref[0], hmax),
                            _row_gap(got[1], ref[1], hmax))
        assert bool((gap <= 1e-5).all()), (B, float(gap.max()))
        worst = max(worst, float(gap.max()))
        # the estimate before the refinement: the P-matrix one, bit-equal
        h0, p0 = OF.nl_chanest(xs, OF.NL_LTF_START, cfg.nltf, 1)
        if fmt == Fmt.HT:
            pidx = OF._idx("PILOT_IDX", dev)
            p0 = csum(CF(h0.re[..., pidx], h0.im[..., pidx]), dim=2)
        h1, p1 = OF._chanest_kernel(xs, fmt, cfg.nltf, nss, sigb_gi, False)
        assert _equal(h1, h0) and _equal(p1, p0), B
    print(f"K7 {fmt.name} nss {nss} sigb {sigb_gi is not None} nrx {nrx} "
          f"{snr:g} dB: largest refined gap {worst:.3g} of max |h|")


def test_k7_empty_batch_and_counted():
    """An empty bucket launches nothing; a launch counts once as the
    registry's ``kernel.payload_chanest.launches`` and once at its
    shape."""
    dev = _card()
    before = trace.snapshot()
    z = torch.zeros((0, 1, 900), device=dev)
    h, p = OF.payload_chanest(CF(z, z), Fmt.HT, 1, 1, None)
    assert h.re.shape == (0, 1, 1, 64) and p.re.shape == (0, 1, 4)
    assert _launches("payload_chanest") == before.get(
        "kernel.payload_chanest.launches", 0)
    x = torch.zeros((3, 1, 900), device=dev)
    OF.payload_chanest(CF(x, x), Fmt.L, 0, 1, None)
    after = trace.snapshot()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if k.startswith("kernel.") and v != before.get(k, 0)}
    assert moved == {"kernel.payload_chanest.launches": 1,
                     f"kernel.payload_chanest.at.3x1x{int(Fmt.L)}x1": 1}


def test_k7_refuses_what_it_cannot_take():
    """Non-contiguous windows, windows that end before the training and
    SIG symbols, and a mix of devices raise before any launch."""
    dev = _card()
    before = _launches("payload_chanest")
    x = torch.zeros((3, 2, 1800), device=dev)
    with pytest.raises(ValueError):
        OF.payload_chanest(CF(x[:, :, ::2], x[:, :, ::2]), Fmt.L, 0, 1)
    short = torch.zeros((3, 1, 500), device=dev)
    with pytest.raises(ValueError):
        OF.payload_chanest(CF(short, short), Fmt.HT, 1, 1)
    with pytest.raises(ValueError):
        OF.payload_chanest(CF(x, x), Fmt.VHT, 1, 1, 1800)
    with pytest.raises(ValueError):
        OF.payload_chanest(CF(x, x.cpu()), Fmt.L, 0, 1)
    assert _launches("payload_chanest") == before
