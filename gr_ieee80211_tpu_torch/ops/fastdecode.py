"""Syndrome-gated adaptive BCC decoding: algebraic inverse + Viterbi fallback.

Port of ``gr_ieee80211_tpu.ops.fastdecode`` (see its module docstring for
the derivation).  A causal windowed GF(2) inverse recovers the data when
the hard bits form a codeword; a re-encode syndrome counts hard errors
per row, and rows that fail go to the Viterbi kernels (:mod:`.viterbi_kernels`)
through the same tier ladder as the reference:

* fast:       every syndrome is 0, the algebraic inverse is the answer;
* tile<k>:    <= k failing rows are gathered and decoded whole;
* win<k>:     <= k dirty WIN_K-step windows are re-decoded with overlap;
* full:       the whole batch runs the full sweep.

The reference's ``lax.cond`` ladder becomes Python branches on counts
read back with ``.item()``; its one-hot matmul and rank-cumsum merges
become direct index scatters.  The tier that ran counts as
``decode.tier.<name>`` in ``utils/trace``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..spec import tables as T
from ..utils import trace
from . import viterbi as V
from .frontend import nonzero_padded
from .viterbi_kernels import decode_window_rows, viterbi_decode

KB = 60
FALLBACK_B = 128
WIN_K = 256
WIN_W = 128
WIN_T = WIN_K + 2 * WIN_W
WIN_MARGIN = 64
PIN_LLR = -1e5
WIN_TIERS = (2048, 8192, 16384)


# ---------------------------------------------------------------------------
# GF(2) stencil (host numpy, cached per code rate)
# ---------------------------------------------------------------------------

def _enc_matrix(nd: int) -> np.ndarray:
    """(2*nd, nd) GF(2) encoding matrix (zero initial state)."""
    E = np.zeros((2 * nd, nd), np.uint8)
    for t in range(nd):
        for k in range(7):
            if t - k >= 0:
                E[2 * t, t - k] ^= T.G0_TAPS[k]
                E[2 * t + 1, t - k] ^= T.G1_TAPS[k]
    return E


def _keep_mask(cr: str, ncoded: int) -> np.ndarray:
    """Puncture keep mask over a depunctured stream."""
    idx, _ = V.depuncture_indices(cr, -(-ncoded // 2))
    m = np.zeros(2 * (-(-ncoded // 2)), bool)
    m[idx] = True
    return m[:ncoded]


def _gf2_solve(M: np.ndarray, Rhs: np.ndarray) -> np.ndarray | None:
    """Solve M X = Rhs over GF(2); returns X ((cols, k)) or None."""
    M = M.copy().astype(np.uint8)
    R = Rhs.copy().astype(np.uint8)
    r, c = M.shape
    piv_of_col = {}
    row = 0
    for col in range(c):
        sel = np.nonzero(M[row:, col])[0]
        if len(sel) == 0:
            continue
        p = row + sel[0]
        if p != row:
            M[[row, p]] = M[[p, row]]
            R[[row, p]] = R[[p, row]]
        hit = np.nonzero(M[:, col])[0]
        hit = hit[hit != row]
        M[hit] ^= M[row]
        R[hit] ^= R[row]
        piv_of_col[col] = row
        row += 1
        if row == r:
            break
    if R[~M.any(axis=1)].any():
        return None
    X = np.zeros((c, R.shape[1]), np.uint8)
    for col, pr in piv_of_col.items():
        X[col] = R[pr]
    return X


@functools.lru_cache(maxsize=None)
def _interior_matrix(cr: str) -> np.ndarray:
    """(3*2KB, KB) f32 causal stencil: data block i from depunctured coded
    blocks [i-1, i, i+1] (punctured rows 0)."""
    nd = 5 * KB
    Ep = _enc_matrix(nd)
    keep = _keep_mask(cr, 2 * nd)
    S2 = 2 * KB
    rows = np.arange(S2, 4 * S2)
    sub_keep = keep[rows]
    A = Ep[rows][sub_keep]
    tgt = np.zeros((5 * KB, KB), np.uint8)
    tgt[np.arange(2 * KB, 3 * KB), np.arange(KB)] = 1
    X = _gf2_solve(A.T, tgt)
    if X is None:                                  # pragma: no cover
        raise ValueError(f"no windowed inverse for rate {cr}")
    Xd = np.zeros((3 * S2, KB), np.float32)
    Xd[np.nonzero(sub_keep)[0]] = X
    for k in range(KB):                            # causality certificate
        nz = np.nonzero(Xd[:, k])[0]
        assert nz.max() <= 2 * (KB + k) + 1, (cr, k, nz.max())
    return Xd


@functools.lru_cache(maxsize=None)
def _interior_on(cr: str, device: torch.device) -> torch.Tensor:
    with trace.sync("table_upload"):
        return torch.from_numpy(_interior_matrix(cr)).to(device)


@functools.lru_cache(maxsize=None)
def _keep_on(cr: str, ncoded: int, device: torch.device) -> torch.Tensor:
    with trace.sync("table_upload"):
        return torch.from_numpy(_keep_mask(cr, ncoded).astype(np.float32)
                                ).to(device)


# ---------------------------------------------------------------------------
# algebraic inverse + syndrome
# ---------------------------------------------------------------------------

def _hard_inverse(hard_flat: torch.Tensor, cr: str,
                  n_trellis: int) -> torch.Tensor:
    """(B, 2T) depunctured hard bits (f32 0/1) -> (B, T) data bits f32.

    The GF(2) product is a float32 matmul of 0/1 values: every product is
    exact and the sums stay below 2^11, so it is exact on any backend (TF32
    included, whose inputs keep 0/1 exactly)."""
    B = hard_flat.shape[0]
    S2 = 2 * KB
    nblk = -(-n_trellis // KB)
    total = nblk * S2
    x = F.pad(hard_flat, (S2, total + S2 - 2 * n_trellis))
    w = torch.cat([x[:, off: off + total].reshape(B, nblk, S2)
                   for off in (0, S2, 2 * S2)], dim=-1)
    d = torch.remainder(w @ _interior_on(cr, hard_flat.device), 2)
    return d.reshape(B, -1)[:, :n_trellis]


def _mismatch(d: torch.Tensor, hard_flat: torch.Tensor, cr: str,
              n_trellis: int, live: torch.Tensor | None = None):
    """(B, 2*n_trellis) 0/1 indicator of kept (and live) coded positions
    where re-encode(d) != hard."""
    B = d.shape[0]
    h = F.pad(d, (6, 0))

    def tap(k):
        return h[:, 6 - k: 6 - k + n_trellis]

    a = torch.remainder(tap(0) + tap(2) + tap(3) + tap(5) + tap(6), 2)
    c = torch.remainder(tap(0) + tap(1) + tap(2) + tap(3) + tap(6), 2)
    re = torch.stack([a, c], dim=-1).reshape(B, 2 * n_trellis)
    keep = _keep_on(cr, 2 * n_trellis, d.device)
    mism = torch.abs(re - hard_flat) * keep[None, :]
    return mism if live is None else mism * live


def _hard(coded_llr: torch.Tensor, cr: str, n_trellis: int,
          n_real: torch.Tensor | None):
    """(hard, live): (B, 2*n_trellis) depunctured hard bits (f32 0/1,
    punctured = 0) and, for per-row real lengths ``n_real``, the (B, 2T)
    f32 mask of positions < 2*n_real that zeroes ``hard`` beyond them
    (None without ``n_real``)."""
    hard = V.depuncture_flat((coded_llr > 0).to(torch.float32), cr, n_trellis)
    if n_real is None:
        return hard, None
    pos = torch.arange(2 * n_trellis, device=hard.device)
    live = (pos[None, :] < 2 * n_real.to(torch.int64)[:, None]
            ).to(torch.float32)
    return hard * live, live


def inverse_and_syndrome(coded_llr: torch.Tensor, cr: str, n_trellis: int,
                         n_real: torch.Tensor | None = None):
    """Algebraic-invert and re-encode-check a batch of punctured LLRs.

    Returns (d8 (B, T) uint8 candidate, syn (B,) int32 per-row hard-error
    count over kept positions in [0, n_real)).  The causal stencil keeps
    bits [0, n_real) exact when the stream beyond is masked."""
    hard, live = _hard(coded_llr, cr, n_trellis, n_real)
    d = _hard_inverse(hard, cr, n_trellis)
    syn = _mismatch(d, hard, cr, n_trellis, live).sum(dim=1).to(torch.int32)
    return d.to(torch.uint8), syn


def _mism_recompute(coded_llr: torch.Tensor, d8: torch.Tensor, cr: str,
                    n_trellis: int, n_real: torch.Tensor | None = None):
    """The (B, 2T) mismatch indicator of the candidate ``d8``."""
    hard, live = _hard(coded_llr, cr, n_trellis, n_real)
    return _mismatch(d8.to(torch.float32), hard, cr, n_trellis, live)


def _window_dirty(mism: torch.Tensor, n_trellis: int,
                  nwin: int) -> torch.Tensor:
    """(B, 2T) per-position mismatch -> (B, nwin) dirty window flags
    (mismatch inside the window or within WIN_MARGIN steps of it)."""
    B = mism.shape[0]
    m = F.pad(mism, (0, 2 * (nwin * WIN_K - n_trellis)))
    w = m.reshape(B, nwin, 2 * WIN_K)
    own = w.sum(dim=2)
    last = w[:, :, 2 * (WIN_K - WIN_MARGIN):].sum(dim=2)
    first = w[:, :, : 2 * WIN_MARGIN].sum(dim=2)
    left = F.pad(last, (1, 0))[:, :nwin]
    right = F.pad(first, (0, 1))[:, 1:]
    return (own + left + right) > 0


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------

def _tile(k: int, coded_llr: torch.Tensor, d8: torch.Tensor,
          need: torch.Tensor, cr: str, n_trellis: int) -> torch.Tensor:
    """Decode the <= k failing rows whole and scatter them back."""
    B = coded_llr.shape[0]
    idx = nonzero_padded(need, k, B)
    rows = torch.clamp(idx, max=B - 1)
    pairs_k = V.depuncture(coded_llr[rows], cr, n_trellis)
    bits = viterbi_decode(pairs_k)          # segmented rule at width k
    real = idx < B
    out = d8.clone()
    with trace.sync("mask_index", 2):
        out[idx[real]] = bits[real]
    return out


def _win_tile(k: int, coded_llr: torch.Tensor, d8: torch.Tensor,
              dirty: torch.Tensor, cr: str, n_trellis: int,
              nwin: int) -> torch.Tensor:
    """Re-decode the <= k dirty windows (WIN_K kept steps, WIN_W warmup
    each side) and scatter them back into the algebraic candidate."""
    B = coded_llr.shape[0]
    full = V.depuncture_flat(coded_llr, cr, n_trellis)
    P = WIN_W + nwin * WIN_K + WIN_W
    flat = F.pad(full, (2 * WIN_W, 2 * (P - WIN_W - n_trellis)))
    flat[:, : 2 * WIN_W] = PIN_LLR               # state-0 pin for window 0
    dflat = dirty.reshape(-1)
    flat_idx = nonzero_padded(dflat, k, B * nwin)
    safe = torch.clamp(flat_idx, max=B * nwin - 1)
    wins = flat.unfold(1, 2 * WIN_T, 2 * WIN_K)  # (B, nwin, 2*WIN_T) view
    win = wins[safe // nwin, safe % nwin].reshape(k, WIN_T, 2)
    kept = decode_window_rows(win, WIN_W, WIN_K)  # (k, WIN_K)
    d8p = F.pad(d8, (0, nwin * WIN_K - n_trellis)).reshape(B * nwin, WIN_K)
    real = flat_idx < B * nwin
    with trace.sync("mask_index", 2):
        d8p[flat_idx[real]] = kept[real]
    return d8p.reshape(B, nwin * WIN_K)[:, :n_trellis]


def _full(coded_llr: torch.Tensor, cr: str, n_trellis: int) -> torch.Tensor:
    return viterbi_decode(V.depuncture(coded_llr, cr, n_trellis))


def adaptive_decode(coded_llr: torch.Tensor, cr: str, n_trellis: int,
                    fallback: int = FALLBACK_B,
                    n_real: torch.Tensor | None = None,
                    win_tiers: tuple = WIN_TIERS) -> torch.Tensor:
    """Depuncture + decode with the syndrome-gated fast path.

    coded_llr: (B, >=n_kept) punctured LLRs (positive = coded bit 1).
    n_real: optional (B,) true trellis length per row of a canonicalized
    (rounded-up) bucket: the syndrome and the fast path then cover only
    each row's real region.
    Returns (B, n_trellis) uint8, equal to the reference's bits on every
    tier."""
    B = coded_llr.shape[0]
    d8, syn = inverse_and_syndrome(coded_llr, cr, n_trellis, n_real)
    need = syn > 0
    with trace.sync("decode.n_fail"):
        n_fail = int(need.sum().item())
    trace.count("decode.rows", B)
    trace.count("decode.rows_failed", n_fail)

    def done(name, out):
        trace.count("decode.tier." + name)
        return out

    if n_fail == 0:
        return done("fast", d8)
    nwin = -(-n_trellis // WIN_K)
    wtiers = [t for t in sorted(win_tiers, reverse=True) if t < B * nwin]
    use_win = n_trellis >= 4 * WIN_K and bool(wtiers)
    row_tiers = (fallback,) if use_win else (16 * fallback, 4 * fallback,
                                             fallback)
    # the reference nests its conds with the last-listed tier outermost
    for k in reversed([t for t in row_tiers if t < B]):
        if n_fail <= k:
            return done(f"tile{k}",
                        _tile(k, coded_llr, d8, need, cr, n_trellis))
    if use_win:
        with trace.sync("decode.syn_sum"):
            use_win = 2 * int(syn.sum().item()) <= 32 * wtiers[0]
    if use_win:
        mism = _mism_recompute(coded_llr, d8, cr, n_trellis, n_real)
        dirty = _window_dirty(mism, n_trellis, nwin)
        with trace.sync("decode.n_dirty"):
            n_dirty = int(dirty.sum().item())
        for k in reversed(wtiers):
            if n_dirty <= k:
                return done(f"win{k}", _win_tile(k, coded_llr, d8, dirty, cr,
                                                 n_trellis, nwin))
    return done("full", _full(coded_llr, cr, n_trellis))
