"""Batched CRC32 (FCS) checking as a GF(2) matrix product.

Port of ``gr_ieee80211_tpu.ops.crc``: for a fixed frame length L,
``crc(frame) = M_L^T bits + c_L (mod 2)``, so a batch is one (B, L) x
(L, 32) float32 matmul followed by ``mod 2``.  The inputs are 0/1 and
the sums stay below 2^24, so the product is exact on any backend (TF32
keeps 0/1 inputs exactly and accumulates in float32).
"""
from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from ..utils import trace


@functools.lru_cache(maxsize=None)
def _crc_matrix(nbits: int):
    """(M, c): crc32(bits) == M^T b + c over GF(2), bit order LSB-first
    per byte; column j of M is crc32 of the frame with only bit j set,
    xor crc32 of the all-zero frame."""
    assert nbits % 8 == 0
    nbytes = nbits // 8
    zero = bytes(nbytes)
    c = zlib.crc32(zero) & 0xFFFFFFFF
    M = np.zeros((nbits, 32), dtype=np.float32)
    for bit_in_byte in range(8):
        onehot = bytes([1 << bit_in_byte])
        # crc of the one-hot byte followed by k zero bytes, for every k
        crc_k = np.zeros(nbytes, dtype=np.uint64)
        cur = zlib.crc32(onehot) & 0xFFFFFFFF
        crc_k[nbytes - 1] = cur
        for k in range(1, nbytes):
            cur = zlib.crc32(b"\x00", cur) & 0xFFFFFFFF
            crc_k[nbytes - 1 - k] = cur
        for p in range(nbytes):
            # crc is affine: A e = crc(e) ^ crc(0); the frame's leading
            # zero bytes do not change crc(e) relative to crc(zeros)
            zp = zlib.crc32(bytes(nbytes - p)) & 0xFFFFFFFF
            ae = crc_k[p] ^ zp
            bitpos = 8 * p + bit_in_byte
            for ob in range(32):
                M[bitpos, ob] = (ae >> ob) & 1
    cbits = np.array([(c >> ob) & 1 for ob in range(32)], dtype=np.float32)
    return M, cbits


RESIDUE_BITS = np.array([(558161692 >> i) & 1 for i in range(32)],
                        dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _crc_on(nbits: int, device: torch.device):
    M, c = _crc_matrix(nbits)
    with trace.sync("table_upload", 3):
        return (torch.from_numpy(M).to(device),
                torch.from_numpy(c).to(device),
                torch.from_numpy(RESIDUE_BITS).to(device))


def crc32_bits(bits: torch.Tensor, nbits: int) -> torch.Tensor:
    """(B, nbits) bits -> (B, 32) crc32 bits (LSB first), float 0/1."""
    M, c, _ = _crc_on(nbits, bits.device)
    return torch.remainder(bits.to(torch.float32) @ M + c, 2.0)


def fcs_ok_batch(frame_bits: torch.Tensor, nbits: int) -> torch.Tensor:
    """(B, nbits) frame(+FCS) bits -> (B,) bool residue check."""
    _, _, residue = _crc_on(nbits, frame_bits.device)
    return (crc32_bits(frame_bits, nbits) == residue).all(dim=1)
