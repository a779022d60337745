"""Gold-model bit pipeline: scramble, BCC, puncture, interleave, Viterbi.

Clarity-first vectorized numpy; validated bit-exactly against the reference
PY-TB (``tools/phy80211header.py:763-1045``) by
the spec-parity tests.  These routines are the oracle for the batched
torch ops in ``gr_ieee80211_tpu_torch.ops``.
"""
from __future__ import annotations

import numpy as np
import zlib

from ..spec import tables as T


# ---------------------------------------------------------------------------
# Scrambler
# ---------------------------------------------------------------------------

def scramble(bits: np.ndarray, seed: int) -> np.ndarray:
    """XOR with the 127-periodic scrambler sequence started at ``seed``."""
    bits = np.asarray(bits, dtype=np.uint8)
    seq = T.scramble_seq(seed)
    reps = -(-len(bits) // 127)
    return bits ^ np.tile(seq, reps)[: len(bits)]


def descramble(bits: np.ndarray) -> tuple[np.ndarray, int]:
    """Recover the seed from the first 7 bits (service field is zeros) and
    descramble; returns (descrambled bits with first 7 forced to 0, seed)."""
    bits = np.asarray(bits, dtype=np.uint8)
    # first 7 scrambled bits are the raw LFSR output; reconstruct the state
    # that *produced* them: state bits x7..x1 == out[0..6] reversed recurrence.
    # Simpler: search the 127 cyclic offsets (tiny, exact).
    seq127 = T.scramble_seq(0x7F)  # any maximal sequence is a cyclic shift
    target = bits[:7]
    full = np.concatenate([seq127, seq127[:7]])
    for off in range(127):
        if np.array_equal(full[off : off + 7], target):
            seq = np.tile(seq127, -(-((len(bits)) + off) // 127) + 1)[off : off + len(bits)]
            out = bits ^ seq
            out[:7] = 0
            return out, _seed_from_first7(target)
    # all-zero degenerate input
    return bits.copy(), 0


def _seed_from_first7(out7: np.ndarray) -> int:
    """The LFSR state whose next 7 outputs equal ``out7`` (MSB-first pack)."""
    for seed in range(1, 128):
        if np.array_equal(T.scramble_seq(seed)[:7], out7):
            return seed
    return 0


# ---------------------------------------------------------------------------
# BCC encode / puncture / depuncture
# ---------------------------------------------------------------------------

def bcc_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 convolutional encode; returns interleaved (a0,b0,a1,b1,..).

    Vectorized as two XOR-convolutions of the zero-history-padded input with
    the generator taps.
    """
    b = np.asarray(bits, dtype=np.uint8)
    hist = np.concatenate([np.zeros(6, dtype=np.uint8), b])
    # windows[t] = [b_t, b_{t-1}, ..., b_{t-6}]
    win = np.lib.stride_tricks.sliding_window_view(hist, 7)[:, ::-1]
    a = (win & T.G0_TAPS).sum(axis=1) % 2
    c = (win & T.G1_TAPS).sum(axis=1) % 2
    out = np.empty(2 * len(b), dtype=np.uint8)
    out[0::2] = a
    out[1::2] = c
    return out


def puncture(coded: np.ndarray, cr: str) -> np.ndarray:
    pat = T.PUNCTURE[cr]
    keep = np.tile(pat, -(-len(coded) // len(pat)))[: len(coded)].astype(bool)
    return coded[keep]


def depuncture_llr(llr: np.ndarray, cr: str, n_steps: int) -> np.ndarray:
    """Insert zero-LLRs at punctured positions; returns (n_steps, 2) pairs."""
    pat = T.PUNCTURE[cr]
    full = np.zeros(2 * n_steps, dtype=llr.dtype)
    keep = np.tile(pat, -(-len(full) // len(pat)))[: len(full)].astype(bool)
    nk = int(keep.sum())
    full[keep] = llr[:nk]
    return full.reshape(n_steps, 2)


def bcc_encode_punct(bits: np.ndarray, cr: str) -> np.ndarray:
    return puncture(bcc_encode(bits), cr)


# ---------------------------------------------------------------------------
# Interleaving (per-symbol, vectorized across symbols)
# ---------------------------------------------------------------------------

def interleave(bits: np.ndarray, nbpscs: int, fmt_legacy: bool,
               iss: int = 0, nss: int = 1) -> np.ndarray:
    """Interleave a whole stream = concatenation of per-symbol blocks."""
    perm = (T.interleave_perm_legacy(nbpscs) if fmt_legacy
            else T.interleave_perm_nl(nbpscs, iss, nss))
    ncbpss = len(perm)
    blocks = np.asarray(bits, dtype=np.uint8).reshape(-1, ncbpss)
    out = np.empty_like(blocks)
    out[:, perm] = blocks
    return out.reshape(-1)


def deinterleave(vals: np.ndarray, nbpscs: int, fmt_legacy: bool,
                 iss: int = 0, nss: int = 1) -> np.ndarray:
    perm = (T.interleave_perm_legacy(nbpscs) if fmt_legacy
            else T.interleave_perm_nl(nbpscs, iss, nss))
    ncbpss = len(perm)
    blocks = np.asarray(vals).reshape(-1, ncbpss)
    return blocks[:, perm].reshape(-1)


def stream_parse(coded: np.ndarray, nbpscs: int, nss: int, nsym: int) -> np.ndarray:
    """Split the single-encoder coded stream into nss per-stream bit streams.

    Returns (nss, nsym*ncbpss).  Round-robin s = max(nbpscs/2, 1) bits per
    stream (19.3.11.7 with nES = 1).
    """
    ncbps = len(coded) // nsym
    ncbpss = ncbps // nss
    idx = T.stream_parser_perm(nbpscs, nss, 1, ncbpss)  # (nss, ncbpss)
    blocks = np.asarray(coded, dtype=np.uint8).reshape(nsym, ncbps)
    out = blocks[:, idx]                      # (nsym, nss, ncbpss)
    return out.transpose(1, 0, 2).reshape(nss, -1)


def stream_deparse(ss_vals: np.ndarray, nbpscs: int, nsym: int) -> np.ndarray:
    """Inverse of stream_parse for LLRs: (nss, nsym*ncbpss) -> coded order."""
    nss = ss_vals.shape[0]
    ncbpss = ss_vals.shape[1] // nsym
    ncbps = ncbpss * nss
    idx = T.stream_parser_perm(nbpscs, nss, 1, ncbpss)
    blocks = np.empty((nsym, ncbps), dtype=ss_vals.dtype)
    per_sym = ss_vals.reshape(nss, nsym, ncbpss).transpose(1, 0, 2)
    for iss in range(nss):
        blocks[:, idx[iss]] = per_sym[:, iss]
    return blocks.reshape(-1)


# ---------------------------------------------------------------------------
# Gold Viterbi (max-accumulation over LLRs; bit=1 <-> positive LLR)
# ---------------------------------------------------------------------------

def viterbi_decode(llr_pairs: np.ndarray, start_state_zero: bool = True) -> np.ndarray:
    """Soft Viterbi over (T, 2) depunctured LLR pairs; traceback from state 0.

    Semantics match the reference one-shot decoder
    (``tools/phy80211header.py:980-1045``): path metric adds
    the LLR of each coded bit that is 1; punctured positions carry LLR 0.
    """
    nxt, out = T.viterbi_tables()
    n = llr_pairs.shape[0]
    NEG = -1e15
    pm = np.full(64, NEG)
    pm[0] = 0.0
    decisions = np.zeros((n, 64), dtype=np.uint8)
    c0a, c0b, c1a, c1b = T.viterbi_acs_tables()
    order = np.arange(64)
    even = (2 * order) % 64
    odd = even + 1
    for t in range(n):
        l0, l1 = llr_pairs[t]
        cand0 = pm[even] + c0a * l0 + c0b * l1
        cand1 = pm[odd] + c1a * l0 + c1b * l1
        take1 = cand1 > cand0
        decisions[t] = take1
        pm = np.where(take1, cand1, cand0)
    # traceback
    bits = np.zeros(n, dtype=np.uint8)
    s = 0 if start_state_zero else int(pm.argmax())
    for t in range(n - 1, -1, -1):
        bits[t] = s >> 5
        s = (2 * s) % 64 + int(decisions[t, s])
    return bits


# ---------------------------------------------------------------------------
# FCS
# ---------------------------------------------------------------------------

def fcs32(data: bytes) -> bytes:
    """4-byte little-endian CRC32 FCS."""
    return int.to_bytes(zlib.crc32(bytes(data)) & 0xFFFFFFFF, 4, "little")


def fcs_ok(frame: bytes) -> bool:
    """True if ``frame`` (payload || FCS) passes the CRC32 residue check."""
    if len(frame) <= 4:
        return False
    return zlib.crc32(bytes(frame)) == T.CRC32_RESIDUE
