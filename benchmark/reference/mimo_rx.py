"""The plain reference of the two-antenna receiver: a data packet's decode
from a known sync, in plain PyTorch, float64 / complex128.

Given the (nrx, n) samples of a packet from its L-LTF index on, its CFO
and its transmit vector (``params.PhyConfig``: HT MCS 8-15 or VHT 2
streams MCS 0-8 for SU-MIMO; L, HT MCS 0-7 or VHT 1 stream through
maximum-ratio combining), :func:`decode` runs, in order, the clauses of
IEEE Std 802.11-2020:

1. derotation by the CFO;
2. the channel estimate: two streams (or one HT/VHT stream) from the
   HT-LTFs / VHT-LTFs through the P matrix (19.3.9.4.6, 21.3.8.3.5: the
   VHT-LTF pilot tones carry the R row, so there the estimate is that of
   the streams' sum); L from the two L-LTF repeats (17.3.3);
3. the FFT of the data symbols;
4. the common phase of each symbol from its pilots (17.3.5.10, 19.3.11.10,
   21.3.10.10; HT two streams: the expected pilot is each stream's
   channel times that stream's own pilot pattern, summed over the
   streams);
5. zero forcing through the explicit inverse of the 2 x 2 Gram matrix
   H^H H at each data subcarrier (one stream: maximum-ratio combining);
6. the max-log demap of each Gray-coded axis (17.3.5.8);
7. each stream's deinterleave (17.3.5.7, 19.3.11.8.3 with the frequency
   rotation of the second stream) and the stream deparser (19.3.11.7.2,
   21.3.10.6);
8. depuncture (17.3.5.6) and a straightforward batched Viterbi decode of
   the K = 7 code (133, 171 octal) from state 0, ending in the best
   state;
9. descramble (17.3.5.5): the seed from the SERVICE field's first 7 bits;
10. the PSDU bytes, first bit least significant.

Departures, each a convention of the program under test, taken so that
its numbers can be compared with these:

* input: the samples are read as the program's payload path reads them,
  each float32 part rounded to bfloat16 (to nearest, ties to even)
  before the float64 arithmetic: that staging is the program's stated
  design, and ZF amplifies its rounding by the channel's condition, so a
  reader of the exact samples decodes a few marginal 2-stream packets
  that no receiver on the staged samples can; this reference judges the
  receiver's arithmetic on the input the receiver sees;
* timing: the FFT windows lie at nominal offsets from the program's own
  L-LTF index, which sits a few samples inside the guard interval; every
  window (training and data) shares the shift, so it cancels in the
  equalized symbols;
* LLRs: the piecewise-linear form of max-log for Gray-coded square QAM
  (D_0 = x, D_k = 2^(m-k) - |D_(k-1)| on an axis of 2^m levels), in
  units of the constellation's lattice (the symbol times KMOD), with no
  noise or channel-state weighting; positive means bit 1;
* the one-stream estimate is the LTF's alone: none of the program's
  refinements (L-LTF combining, SIG symbols, the delay subspace, the
  decision-directed pass).

It imports torch, numpy and its frozen siblings ``tables.py`` /
``params.py`` only (the one module of this directory that imports
torch): nothing of the program, nothing of JAX.  TF32 never
applies (nothing here is float32), and :func:`decode` turns it off for
its own duration all the same.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import tables as T
from .params import Fmt, PhyConfig

C128 = torch.complex128
F64 = torch.float64
FS = 20e6
#: the non-legacy LTFs start this far after the L-LTF index (its two
#: repeats 128, L-SIG 80, HT-SIG / VHT-SIG-A 160, HT-STF / VHT-STF 80)
NL_LTF = 128 + 80 + 160 + 80
#: the L-LTF's two 64-sample repeats start at the L-LTF index
L_LTF = 0


def data_start(cfg: PhyConfig) -> int:
    """The data field's first symbol (its guard interval), from the L-LTF
    index."""
    if cfg.fmt == Fmt.L:
        return 128 + 80
    n = NL_LTF + 80 * cfg.nltf
    return n + 80 if cfg.fmt == Fmt.VHT else n


def n_need(cfg: PhyConfig) -> int:
    return data_start(cfg) + 80 * cfg.nsym + 16


@contextlib.contextmanager
def _no_tf32():
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ---------------------------------------------------------------------------
# 1-4: derotate, estimate, FFT, common phase
# ---------------------------------------------------------------------------

def staged(seg: np.ndarray) -> torch.Tensor:
    """Complex samples as the program's payload path stages them: each
    float32 part rounded to bfloat16, then complex128."""
    part = lambda a: torch.as_tensor(np.ascontiguousarray(
        a, np.float32)).bfloat16().double()
    return torch.complex(part(seg.real), part(seg.imag))


def window(view, start: int, cfo_hz: float, n: int) -> torch.Tensor:
    """(nrx, n) complex128 samples of ``view`` (nrx, N) from ``start``,
    staged (:func:`staged`) and derotated by ``cfo_hz`` (phase 0 at
    ``start``); zeros past the end."""
    seg = staged(np.asarray(view)[:, start: start + n])
    out = torch.zeros((seg.shape[0], n), dtype=C128)
    out[:, : seg.shape[1]] = seg
    t = torch.arange(n, dtype=F64)
    return out * torch.exp(-2j * np.pi * cfo_hz / FS * t)


def fft64(w: torch.Tensor) -> torch.Tensor:
    """(..., 64) time samples -> the 64 bins k = -32..31."""
    return torch.fft.fftshift(torch.fft.fft(w, dim=-1), dim=-1)


def _sym(xs: torch.Tensor, gi: int) -> torch.Tensor:
    """FFT of the symbol whose guard interval begins at ``gi``."""
    return fft64(xs[..., gi + 16: gi + 80])


def chanest(xs: torch.Tensor, cfg: PhyConfig) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(H (B, nrx, nss, 64), pilot channel (B, nrx, 4)): the LTF estimate
    of each stream, and at the pilot tones the channel their pilots see
    (a VHT-LTF pilot tone carries the R row: the streams' sum)."""
    pk = torch.as_tensor(T.PILOT_IDX, dtype=torch.int64)
    if cfg.fmt == Fmt.L:
        ref = torch.as_tensor(T.LTF_L_GRID, dtype=C128)
        y = (fft64(xs[..., L_LTF: L_LTF + 64])
             + fft64(xs[..., L_LTF + 64: L_LTF + 128])) / 2
        h = torch.where(ref != 0, y / torch.where(ref != 0, ref, 1), 1)
        return h[:, :, None, :], h[..., pk]
    ref = torch.as_tensor(T.LTF_NL_GRID, dtype=C128)
    nz = ref != 0
    nltf = cfg.nltf
    ys = [_sym(xs, NL_LTF + 80 * j) for j in range(nltf)]   # (B, nrx, 64)
    hs = []
    for s in range(cfg.nss):
        acc = sum(float(T.P_LTF[s, j]) * ys[j] for j in range(nltf))
        hs.append(torch.where(nz, acc / torch.where(nz, ref, 1) / nltf, 1))
    h = torch.stack(hs, dim=2)
    if cfg.fmt == Fmt.VHT:
        acc = sum(float(T.R_LTF[j]) * ys[j] for j in range(nltf))
        ph = acc[..., pk] / ref[pk] / nltf
    else:
        ph = h[..., pk].sum(dim=2)
    return h, ph


def pilot_values(cfg: PhyConfig) -> torch.Tensor:
    """(nsym, nss, 4) pilot values of the data symbols, polarity applied:
    L the fixed pattern from p_1 on; HT each stream's pattern Psi, rotated
    a symbol at a time, from p_3; VHT the one pattern on every stream,
    rotated, from p_4."""
    if cfg.fmt == Fmt.L:
        base, first, rot = np.tile(T.PILOT_L, (1, 1)), 1, False
    elif cfg.fmt == Fmt.HT:
        base, first, rot = T.PILOT_HT20[cfg.nss - 1], 3, True
    else:
        base, first, rot = np.tile(T.PILOT_VHT, (cfg.nss, 1)), 4, True
    out = np.empty((cfg.nsym, cfg.nss, 4))
    for n in range(cfg.nsym):
        pat = np.roll(base, -n, axis=1) if rot else base
        out[n] = pat * T.PILOT_POLARITY[(first + n) % 127]
    return torch.as_tensor(out, dtype=F64)


def data_grids(xs: torch.Tensor, cfg: PhyConfig) -> torch.Tensor:
    """(B, nrx, nsym, 64) FFTs of the data symbols."""
    d0 = data_start(cfg)
    w = torch.stack([xs[..., d0 + 80 * n + 16: d0 + 80 * n + 80]
                     for n in range(cfg.nsym)], dim=2)
    return fft64(w)


def phase_corrected(grids: torch.Tensor, h: torch.Tensor,
                    pilot_h: torch.Tensor, cfg: PhyConfig) -> torch.Tensor:
    """The data grids turned by each symbol's common phase: the angle of
    the received pilots against the expected ones, over antennas and
    pilots."""
    pk = torch.as_tensor(T.PILOT_IDX, dtype=torch.int64)
    pv = pilot_values(cfg).to(C128)                        # (nsym, nss, 4)
    if cfg.fmt == Fmt.HT and cfg.nss == 2:
        hp = h[..., pk]                                    # (B, nrx, 2, 4)
        expect = (hp[:, :, None] * pv[None, None]).sum(dim=3)
    else:
        expect = pilot_h[:, :, None, :] * pv[None, None, :, 0]
    c = (grids[..., pk] * expect.conj()).sum(dim=(1, 3))   # (B, nsym)
    return grids * torch.exp(-1j * torch.angle(c))[:, None, :, None]


# ---------------------------------------------------------------------------
# 5-6: equalize, demap
# ---------------------------------------------------------------------------

def data_idx(cfg: PhyConfig) -> torch.Tensor:
    return torch.as_tensor(T.DATA_IDX_L if cfg.fmt == Fmt.L
                           else T.DATA_IDX_NL, dtype=torch.int64)


def equalize(y: torch.Tensor, hd: torch.Tensor) -> torch.Tensor:
    """y (B, nrx, nsym, nsd), hd (B, nrx, nss, nsd) -> (B, nss, nsym, nsd).
    Two streams: x = (H^H H)^-1 H^H y with the 2 x 2 inverse written out
    (adjugate over determinant); one stream: maximum-ratio combining."""
    hh = hd.conj()
    if hd.shape[2] == 1:
        g = (hd.abs() ** 2).sum(dim=1)                      # (B, 1, nsd)
        return (hh[:, :, 0, None] * y).sum(dim=1)[:, None] / g[:, :, None]
    g = torch.einsum("brsk,brtk->bstk", hh, hd)             # (B, 2, 2, nsd)
    det = g[:, 0, 0] * g[:, 1, 1] - g[:, 0, 1] * g[:, 1, 0]
    inv = torch.stack([torch.stack([g[:, 1, 1], -g[:, 0, 1]], dim=1),
                       torch.stack([-g[:, 1, 0], g[:, 0, 0]], dim=1)],
                      dim=1) / det[:, None, None]
    mf = torch.einsum("brsk,brnk->bsnk", hh, y)             # H^H y
    return torch.einsum("bstk,btnk->bsnk", inv, mf)


def demap(eq: torch.Tensor, nbpscs: int) -> torch.Tensor:
    """(..., nsd) equalized symbols -> (..., nsd * nbpscs) LLRs, the bits
    of each subcarrier in order (first the I axis' m, then the Q axis'):
    the piecewise-linear max-log form (module docstring)."""
    k = float(T.KMOD[nbpscs])
    if nbpscs == 1:
        return eq.real * k
    m = nbpscs // 2
    axes = []
    for v in (eq.real * k, eq.imag * k):
        d = [v]
        for j in range(1, m):
            d.append(2.0 ** (m - j) - d[-1].abs())
        axes.append(torch.stack(d, dim=-1))
    out = torch.cat(axes, dim=-1)
    return out.reshape(*eq.shape[:-1], -1)


# ---------------------------------------------------------------------------
# 7: deinterleave, deparse
# ---------------------------------------------------------------------------

def interleave_map(cfg: PhyConfig, iss: int) -> np.ndarray:
    """r[k]: where the interleaver puts bit k of stream ``iss`` (0-based)
    in a symbol.  Legacy: 16 columns (17-17, 17-18); HT / VHT 20 MHz: 13
    columns, 4 nbpscs rows, and for two streams the frequency rotation of
    11 nbpscs (19-80 .. 19-82)."""
    nb = cfg.nbpscs
    s = max(nb // 2, 1)
    if cfg.fmt == Fmt.L:
        n, ncol = 48 * nb, 16
    else:
        n, ncol = 52 * nb, 13
    k = np.arange(n)
    i = (n // ncol) * (k % ncol) + k // ncol
    j = s * (i // s) + (i + n - (ncol * i) // n) % s
    if cfg.fmt != Fmt.L and cfg.nss > 1:
        j = (j - ((2 * iss) % 3 + 3 * (iss // 3)) * 11 * nb) % n
    return j


def deparse_map(cfg: PhyConfig) -> tuple[np.ndarray, np.ndarray]:
    """(stream, position) of each coded bit q of a symbol: blocks of s =
    max(1, nbpscs / 2) bits go to the streams in turn."""
    s = max(cfg.nbpscs // 2, 1)
    q = np.arange(cfg.ncbps)
    return (q // s) % cfg.nss, s * (q // (s * cfg.nss)) + q % s


def coded_llrs(llr: torch.Tensor, cfg: PhyConfig) -> torch.Tensor:
    """(B, nss, nsym, ncbpss) interleaved LLRs a stream -> (B, nsym *
    ncbps) in the encoder's order."""
    deint = torch.stack([llr[:, s][..., torch.as_tensor(
        interleave_map(cfg, s))] for s in range(cfg.nss)], dim=1)
    st, pos = (torch.as_tensor(a) for a in deparse_map(cfg))
    return deint[:, st, :, pos].permute(1, 2, 0).reshape(llr.shape[0], -1)


# ---------------------------------------------------------------------------
# 8: depuncture, Viterbi
# ---------------------------------------------------------------------------

def depuncture(llr: torch.Tensor, cr: str, n_steps: int) -> torch.Tensor:
    """(B, n) punctured LLRs -> (B, n_steps, 2) rate-1/2 pairs, the
    removed ones as 0."""
    keep = np.asarray(T.PUNCTURE[cr], bool)
    full = np.tile(keep, -(-2 * n_steps // len(keep)))[: 2 * n_steps]
    out = torch.zeros((llr.shape[0], 2 * n_steps), dtype=llr.dtype)
    out[:, torch.as_tensor(np.flatnonzero(full))] = \
        llr[:, : int(full.sum())]
    return out.reshape(llr.shape[0], n_steps, 2)


def _trellis():
    """state = the last six input bits, the newest in bit 5; for each next
    state its two predecessors and the two coded bits from each."""
    taps = [int("".join(map(str, g)), 2) for g in (T.G0_TAPS, T.G1_TAPS)]
    prev = np.zeros((64, 2), np.int64)
    out = np.zeros((64, 2, 2), np.float64)
    for ns in range(64):
        u = ns >> 5
        for x in range(2):
            s = ((ns & 31) << 1) | x
            reg = (u << 6) | s          # b_t, b_t-1 .. b_t-6 from bit 6 down
            prev[ns, x] = s
            for c, g in enumerate(taps):
                out[ns, x, c] = bin(reg & g).count("1") & 1
    return torch.as_tensor(prev), torch.as_tensor(2 * out - 1)


def viterbi(pairs: torch.Tensor) -> torch.Tensor:
    """(B, T, 2) LLR pairs (positive: coded bit 1) -> (B, T) uint8 input
    bits: the path from state 0 that correlates best with the LLRs,
    ending in whichever state scores most."""
    B, n, _ = pairs.shape
    prev, sign = _trellis()
    metric = torch.full((B, 64), -torch.inf, dtype=F64)
    metric[:, 0] = 0.0
    choice = torch.empty((n, B, 64), dtype=torch.uint8)
    p = pairs.to(F64)
    for t in range(n):
        bm = torch.einsum("bc,sxc->bsx", p[:, t], sign)     # (B, 64, 2)
        cand = metric[:, prev] + bm
        metric, x = cand.max(dim=2)
        choice[t] = x.to(torch.uint8)
    state = metric.argmax(dim=1)
    bits = torch.empty((B, n), dtype=torch.uint8)
    rows = torch.arange(B)
    for t in range(n - 1, -1, -1):
        bits[:, t] = (state >> 5).to(torch.uint8)
        state = prev[state, choice[t, rows, state].to(torch.int64)]
    return bits


# ---------------------------------------------------------------------------
# 9-10: descramble, bytes
# ---------------------------------------------------------------------------

def _scrambler(seed: int, n: int) -> np.ndarray:
    """x^7 + x^4 + 1 from the 7-bit state ``seed`` (x7 .. x1 from bit 6)."""
    st, out = seed, np.empty(n, np.uint8)
    for i in range(n):
        b = ((st >> 6) ^ (st >> 3)) & 1
        out[i] = b
        st = ((st << 1) & 0x7E) | b
    return out


def descramble(bits: torch.Tensor) -> torch.Tensor:
    """(B, n) scrambled data bits -> descrambled: the SERVICE field's
    first 7 bits are zero before scrambling, so they show the scrambler's
    sequence, and the state that makes it is the seed."""
    first = {tuple(_scrambler(s, 7)): s for s in range(1, 128)}
    out = bits.clone()
    for b in range(bits.shape[0]):
        seed = first.get(tuple(int(v) for v in bits[b, :7]))
        if seed is None:
            continue
        out[b] ^= torch.as_tensor(_scrambler(seed, bits.shape[1]))
    return out


def to_bytes(bits: torch.Tensor) -> list[bytes]:
    w = torch.as_tensor([1 << i for i in range(8)], dtype=torch.int64)
    v = (bits.reshape(bits.shape[0], -1, 8).to(torch.int64) * w).sum(-1)
    return [bytes(r.to(torch.uint8).tolist()) for r in v]


# ---------------------------------------------------------------------------
# the whole decode
# ---------------------------------------------------------------------------

def decode(xs: torch.Tensor, cfg: PhyConfig) -> dict:
    """Decode a batch of packets of one transmit vector.

    xs: (B, nrx, >= n_need(cfg)) derotated samples from the L-LTF index
    (:func:`window`).  Returns ``h`` (B, nrx, nss, 64) and ``pilot_h``
    (B, nrx, 4), the estimates; ``eq`` (B, nss, nsym, nsd) the equalized
    symbols; ``llr`` (B, nss, nsym, ncbpss) the interleaved LLRs;
    ``bits`` (B, nsym * ndbps) the decoded, descrambled data bits; and
    ``psdu`` [bytes] the PSDU of each."""
    with _no_tf32():
        xs = xs.to(C128)
        h, pilot_h = chanest(xs, cfg)
        grids = phase_corrected(data_grids(xs, cfg), h, pilot_h, cfg)
        di = data_idx(cfg)
        eq = equalize(grids[..., di], h[..., di])
        llr = demap(eq, cfg.nbpscs)
        coded = coded_llrs(llr, cfg)
        bits = descramble(viterbi(depuncture(coded, cfg.cr, cfg.n_trellis)))
        psdu = to_bytes(bits[:, 16: 16 + 8 * cfg.psdu_len])
    return {"h": h, "pilot_h": pilot_h, "eq": eq, "llr": llr, "bits": bits,
            "psdu": psdu}


def decode_at(views, starts, cfos, cfg: PhyConfig) -> dict:
    """:func:`decode` of packets each given by its view (nrx, N), its
    L-LTF index and its CFO in Hz (the program's own, say)."""
    n = n_need(cfg)
    xs = torch.stack([window(v, int(s), float(c), n)
                      for v, s, c in zip(views, starts, cfos)])
    return decode(xs, cfg)
