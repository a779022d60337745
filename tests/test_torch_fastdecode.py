"""Syndrome-gated adaptive decoder: the port vs the JAX package, bit-exact
on every tier (fast, row tile, windowed, full), with and without per-row
``n_real`` masking, and on the intermediate candidate, syndrome and
dirty-window flags."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gr_ieee80211_tpu.gold import bits as GB
from gr_ieee80211_tpu.ops import fastdecode as JFD
from gr_ieee80211_tpu_torch.ops import fastdecode as PFD
from tools_torch import timing

torch.set_num_threads(2)

RATES = ("1/2", "2/3", "3/4", "5/6")


def _llr_batch(rng, cr, T, B, flips_per_row=None):
    """B random data rows encoded (unterminated), +-4 LLRs, with
    ``flips_per_row[b]`` coded-bit sign flips."""
    data = rng.integers(0, 2, (B, T)).astype(np.uint8)
    llrs = []
    for b in range(B):
        cs = GB.bcc_encode_punct(data[b], cr)
        llr = (cs.astype(np.float32) * 2 - 1) * 4.0
        if flips_per_row:
            pos = rng.choice(len(cs), flips_per_row[b], replace=False)
            llr[pos] = -llr[pos]
        llrs.append(llr)
    return np.stack(llrs), data


def _both(llr, cr, T, n_real=None, **kw):
    """(JAX bits, port bits, the port's decode tiers counted) for the same
    LLRs."""
    ref = np.asarray(JFD.adaptive_decode(
        jnp.asarray(llr), cr, T,
        n_real=None if n_real is None else jnp.asarray(n_real), **kw))
    got, moved = timing.with_counters(lambda: PFD.adaptive_decode(
        torch.from_numpy(llr), cr, T,
        n_real=None if n_real is None else torch.from_numpy(n_real), **kw),
        torch.device("cpu"))
    assert got.dtype == torch.uint8
    return ref, got.numpy(), timing.decode_path(moved)


@pytest.mark.parametrize("cr", RATES)
def test_fast_tier_equals_data_and_reference(cr):
    rng = np.random.default_rng(3)
    T = 733
    llr, data = _llr_batch(rng, cr, T, 4)
    ref, got, rec = _both(llr, cr, T)
    assert rec == ["fast"]
    assert np.array_equal(got, ref) and np.array_equal(got, data)


@pytest.mark.parametrize("cr", RATES)
def test_inverse_and_syndrome_match(cr):
    rng = np.random.default_rng(4)
    T = 500
    llr, _ = _llr_batch(rng, cr, T, 5, flips_per_row=[0, 4, 1, 0, 9])
    jd, js = JFD.inverse_and_syndrome(jnp.asarray(llr), cr, T)
    pd, ps = PFD.inverse_and_syndrome(torch.from_numpy(llr), cr, T)
    assert np.array_equal(np.asarray(jd), pd.numpy())
    assert np.array_equal(np.asarray(js), ps.numpy())
    assert ps.dtype == torch.int32 and ps[0] == 0 and ps[1] >= 4
    jm = JFD._mism_recompute(jnp.asarray(llr), jd, cr, T, None)
    pm = PFD._mism_recompute(torch.from_numpy(llr), pd, cr, T)
    assert np.array_equal(np.asarray(jm), pm.numpy())
    nwin = -(-T // JFD.WIN_K)
    assert np.array_equal(np.asarray(JFD._window_dirty(jm, T, nwin)),
                          PFD._window_dirty(pm, T, nwin).numpy())


@pytest.mark.parametrize("cr,T,B,flips,kw,tier", [
    ("3/4", 600, 8, [0, 3, 0, 0, 7, 0, 0, 1], dict(fallback=4), "tile4"),
    ("1/2", 480, 32, [3] * 6 + [0] * 26, dict(fallback=2), "tile8"),
    ("1/2", 480, 6, [2, 2, 2, 2, 2, 0], dict(fallback=2), "full"),
    ("3/4", 1300, 32, [2] * 32, dict(fallback=16, win_tiers=(128,)),
     "win128"),
])
def test_tiers_match_reference(cr, T, B, flips, kw, tier):
    """Each rung of the ladder reproduces the reference's bits exactly."""
    rng = np.random.default_rng(5)
    llr, _ = _llr_batch(rng, cr, T, B, flips_per_row=flips)
    ref, got, rec = _both(llr, cr, T, **kw)
    assert rec == [tier]
    assert np.array_equal(got, ref)


def test_windowed_tier_edges_and_overflow():
    """Errors in the first and last windows (the state-0 pin and the zero
    tail) stay exact on the windowed tier; dense errors overflow it to the
    full sweep, still exact."""
    rng = np.random.default_rng(7)
    cr, T, B = "3/4", 1300, 32
    llr, _ = _llr_batch(rng, cr, T, B, flips_per_row=[2] * B)
    llr[0, 1] = -llr[0, 1]
    llr[1, -2] = -llr[1, -2]
    ref, got, rec = _both(llr, cr, T, fallback=16, win_tiers=(128,))
    assert rec == ["win128"] and np.array_equal(got, ref)
    llr, _ = _llr_batch(rng, "1/2", T, 16)
    llr = np.where(rng.random(llr.shape) < 0.03, -llr, llr).astype(np.float32)
    ref, got, rec = _both(llr, "1/2", T, fallback=4, win_tiers=(128,))
    assert rec == ["full"] and np.array_equal(got, ref)


@pytest.mark.parametrize("cr", ["2/3", "5/6"])
def test_fast_then_row_tile(cr):
    """The same rows clean (fast path) and with one errored row (row tile),
    at the rates the tier tests above do not use."""
    rng = np.random.default_rng(11)
    T = 1200
    llr, data = _llr_batch(rng, cr, T, 4)
    ref, got, rec = _both(llr, cr, T)
    assert rec == ["fast"] and np.array_equal(got, ref)
    assert np.array_equal(got, data)
    llr[0, 40:43] = -llr[0, 40:43]
    ref, got, rec = _both(llr, cr, T, fallback=2)
    assert rec == ["tile2"] and np.array_equal(got, ref)


@pytest.mark.parametrize("cr,flips,kw,tier", [
    ("3/4", [0] * 6, {}, "fast"),
    ("1/2", [0, 2, 0, 0, 0, 0], dict(fallback=2), "tile2"),
    ("2/3", [1] * 32, dict(fallback=16, win_tiers=(128,)), "win128"),
])
def test_n_real_masking_matches(cr, flips, kw, tier):
    """Canonicalized-bucket rows: each row is a real codeword of n_real
    steps followed by garbage up to the bucket's trellis length.  The
    mask keeps the garbage out of the syndrome (so clean rows stay on
    the fast path), the real bits come out exact, and every output bit
    equals the reference's."""
    rng = np.random.default_rng(13)
    T, B = 1200, len(flips)
    n_real = rng.integers(900, T + 1, B).astype(np.int32)
    n_real[0] = T
    llr, data = _llr_batch(rng, cr, T, B, flips_per_row=flips)
    for b in range(B):
        keep_from = len(PFD._keep_mask(cr, 2 * int(n_real[b])).nonzero()[0])
        llr[b, keep_from:] = rng.normal(size=llr.shape[1] - keep_from) * 4
    jd, js = JFD.inverse_and_syndrome(jnp.asarray(llr), cr, T,
                                      jnp.asarray(n_real))
    pd, ps = PFD.inverse_and_syndrome(torch.from_numpy(llr), cr, T,
                                      torch.from_numpy(n_real))
    assert np.array_equal(np.asarray(jd), pd.numpy())
    assert np.array_equal(np.asarray(js), ps.numpy())
    jm = JFD._mism_recompute(jnp.asarray(llr), jd, cr, T,
                             jnp.asarray(n_real))
    pm = PFD._mism_recompute(torch.from_numpy(llr), pd, cr, T,
                             torch.from_numpy(n_real))
    assert np.array_equal(np.asarray(jm), pm.numpy())
    ref, got, rec = _both(llr, cr, T, n_real=n_real, **kw)
    assert rec == [tier] and np.array_equal(got, ref)
    for b in range(B):
        if flips[b] == 0:
            assert np.array_equal(got[b, : n_real[b]], data[b, : n_real[b]])
