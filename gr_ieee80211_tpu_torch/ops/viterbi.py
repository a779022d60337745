"""Batched soft Viterbi decoder and depuncturing for the 802.11 BCC
(port of ``gr_ieee80211_tpu.ops.viterbi``).

:func:`viterbi_decode` is the reference's plain-array decoder, which the
SIG fields use (T = 24, 26, 48) and the data-parallel payload windows
(``parallel/mesh.payload_decode_dp``).  Its semantics differ from the
payload kernels' (:mod:`.viterbi_kernels`) and are kept exactly: (B, 64)
metrics with predecessors ``2s mod 64`` and ``2s+1 mod 64``, a strict
``cand1 > cand0`` choice, zero-LLR padding to a ``CHUNK`` = 54 multiple
with renormalization once per chunk, and traceback from state 0 or from
the argmax of the final metrics.  The reference computes it as a
``lax.scan`` outside any Pallas kernel.  On the card it is one launch of
the hand-written kernel K6 (``csrc/scan_viterbi.cu``, wrapper
:func:`scan_viterbi`); its plain twin :func:`viterbi_decode_ref` (a loop
over the trellis) runs for CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..spec import tables as T
from ..utils import trace
from .cuda_lib import aligned, launch, on_cuda, require

NEG = -1e9
#: trellis steps per renormalization (the reference's scan chunk)
CHUNK = 54
#: padded trellises up to this many steps keep K6's decision words in
#: shared memory; longer ones take a global scratch buffer
#: (``kSmemSteps`` of ``csrc/scan_viterbi.cu``)
SMEM_STEPS = 1512


@functools.lru_cache(maxsize=None)
def _acs_consts(device: torch.device):
    """(c0a, c0b, c1a, c1b) (1, 64) float32: coded bits of the transitions
    from p0 = 2s' mod 64 and p1 = p0 + 1 into s'."""
    tables = T.viterbi_acs_tables()
    with trace.sync("table_upload", len(tables)):
        return tuple(torch.from_numpy(c).to(device)[None, :] for c in tables)


def viterbi_decode(llr_pairs: torch.Tensor,
                   traceback_from_zero: bool = True) -> torch.Tensor:
    """(B, T, 2) depunctured LLRs (positive = coded bit 1) -> (B, T)
    uint8 bits, bit-equal to the reference's ``viterbi_decode``: K6 for
    CUDA tensors, the twin for CPU tensors.

    Rows are independent, so callers may stack trellises of different
    lengths that pad to the same CHUNK multiple (zero LLRs past each
    row's end) into one call."""
    return scan_viterbi(llr_pairs.to(torch.float32), traceback_from_zero)


def scan_viterbi(llr: torch.Tensor,
                 traceback_from_zero: bool = True) -> torch.Tensor:
    """The decode of :func:`viterbi_decode` in one launch of K6.

    llr: (B, T, 2) float32 LLR pairs, any T.  Returns (B, T) uint8 bits.
    CPU tensors take the twin :func:`viterbi_decode_ref`; CUDA tensors
    launch the kernel or raise."""
    require(llr.ndim == 3 and llr.shape[2] == 2,
            f"scan_viterbi takes (B, T, 2) LLR pairs, got {tuple(llr.shape)}")
    require(llr.dtype == torch.float32, "scan_viterbi takes float32")
    if not on_cuda(llr):
        return viterbi_decode_ref(llr, traceback_from_zero)
    B, n_steps, _ = llr.shape
    dev = llr.device
    bits = torch.empty((B, n_steps), dtype=torch.uint8, device=dev)
    if B == 0 or n_steps == 0:
        return bits
    n_pad = -(-n_steps // CHUNK) * CHUNK
    scratch = (torch.empty((B, n_pad, 2), dtype=torch.int32, device=dev)
               if n_pad > SMEM_STEPS else None)
    llr = aligned(llr, 8)
    launch("gr80211_scan_viterbi", dev, llr.data_ptr(), bits.data_ptr(),
           None if scratch is None else scratch.data_ptr(), n_steps, B,
           int(traceback_from_zero), shape=(B, n_steps))
    return bits


def viterbi_decode_ref(llr_pairs: torch.Tensor,
                       traceback_from_zero: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of K6: the reference's scan as a loop over the
    trellis, (B, T, 2) LLR pairs -> (B, T) uint8 bits."""
    B, n_steps, _ = llr_pairs.shape
    dev = llr_pairs.device
    n_pad = -(-n_steps // CHUNK) * CHUNK
    x = torch.nn.functional.pad(llr_pairs.to(torch.float32),
                                (0, 0, 0, n_pad - n_steps))
    c0a, c0b, c1a, c1b = _acs_consts(dev)
    # the products are exact (0/1 coefficients), so taking them for every
    # step at once leaves the reference's sums (pm + a*l0) + b*l1 unchanged
    l0 = x[:, :, 0:1].transpose(0, 1)                 # (T, B, 1)
    l1 = x[:, :, 1:2].transpose(0, 1)
    a0, b0 = c0a * l0, c0b * l1                       # (T, B, 64)
    a1, b1 = c1a * l0, c1b * l1
    pm = torch.full((B, 64), NEG, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    dec = torch.empty((n_pad, B, 64), dtype=torch.bool, device=dev)
    for t in range(n_pad):
        pme = pm.reshape(B, 32, 2)
        p0 = pme[:, :, 0].repeat(1, 2)
        p1 = pme[:, :, 1].repeat(1, 2)
        cand0 = (p0 + a0[t]) + b0[t]
        cand1 = (p1 + a1[t]) + b1[t]
        torch.gt(cand1, cand0, out=dec[t])
        pm = torch.maximum(cand0, cand1)
        if (t + 1) % CHUNK == 0:
            pm = pm - pm.max(dim=1, keepdim=True).values
    if traceback_from_zero:
        s = torch.zeros(B, dtype=torch.int64, device=dev)
    else:
        s = torch.argmax(pm, dim=1)
    bits = torch.empty((B, n_pad), dtype=torch.uint8, device=dev)
    dec8 = dec.to(torch.int64)
    for t in range(n_pad - 1, -1, -1):
        bits[:, t] = s >> 5
        d = torch.gather(dec8[t], 1, s[:, None])[:, 0]
        s = (2 * s) % 64 + d
    return bits[:, :n_steps]


@functools.lru_cache(maxsize=None)
def depuncture_indices(cr: str, n_steps: int):
    """(keep positions, n_kept) for scattering LLRs into the 2*T stream."""
    pat = T.PUNCTURE[cr]
    keep = np.tile(pat, -(-2 * n_steps // len(pat)))[: 2 * n_steps].astype(bool)
    return np.nonzero(keep)[0].astype(np.int32), int(keep.sum())


@functools.lru_cache(maxsize=None)
def depuncture_index_tensor(cr: str, n_steps: int, device: torch.device):
    idx, _ = depuncture_indices(cr, n_steps)
    with trace.sync("table_upload"):
        return torch.from_numpy(idx.astype(np.int64)).to(device)


def depuncture_flat(llr: torch.Tensor, cr: str, n_steps: int) -> torch.Tensor:
    """(B, n_coded) punctured values -> (B, 2*n_steps), zeros inserted."""
    _, nk = depuncture_indices(cr, n_steps)
    idx = depuncture_index_tensor(cr, n_steps, llr.device)
    full = llr.new_zeros((llr.shape[0], 2 * n_steps))
    full[:, idx] = llr[:, :nk]
    return full


def depuncture(llr: torch.Tensor, cr: str, n_steps: int) -> torch.Tensor:
    """(B, n_coded) punctured LLRs -> (B, n_steps, 2) with zeros inserted."""
    return depuncture_flat(llr, cr, n_steps).reshape(llr.shape[0], n_steps, 2)


def decode_coded_llrs(llr: torch.Tensor, cr: str, n_steps: int) -> torch.Tensor:
    """Depuncture + decode: (B, n_coded) LLRs -> (B, n_steps) uint8."""
    return viterbi_decode(depuncture(llr, cr, n_steps))
