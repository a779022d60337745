"""Gold-model bit pipeline, transmit side: scramble, BCC, puncture, interleave.

Clarity-first vectorized numpy; validated bit-exactly against the reference
PY-TB (``tools/phy80211header.py:763-1045``) by
the spec-parity tests.  These routines are the oracle for the batched
torch ops in ``gr_ieee80211_tpu_torch.ops``.
"""
from __future__ import annotations

import numpy as np
import zlib

from . import tables as T


# ---------------------------------------------------------------------------
# Scrambler
# ---------------------------------------------------------------------------

def scramble(bits: np.ndarray, seed: int) -> np.ndarray:
    """XOR with the 127-periodic scrambler sequence started at ``seed``."""
    bits = np.asarray(bits, dtype=np.uint8)
    seq = T.scramble_seq(seed)
    reps = -(-len(bits) // 127)
    return bits ^ np.tile(seq, reps)[: len(bits)]


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


# ---------------------------------------------------------------------------
# Gold Viterbi (max-accumulation over LLRs; bit=1 <-> positive LLR)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# FCS
# ---------------------------------------------------------------------------

def fcs32(data: bytes) -> bytes:
    """4-byte little-endian CRC32 FCS."""
    return int.to_bytes(zlib.crc32(bytes(data)) & 0xFFFFFFFF, 4, "little")


