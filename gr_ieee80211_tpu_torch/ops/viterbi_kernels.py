"""Viterbi forward ACS (K1) and traceback (K2) for the 802.11 BCC, and
their 4-steps-per-byte packed variants (K4, K5).

Port of ``gr_ieee80211_tpu.ops.viterbi_pallas``.  The kernels are CUDA C++
for sm_90a in ``csrc/viterbi.cu``, built at first use by
:mod:`.cuda_lib`.  Beside each kernel sits its plain PyTorch twin
(``acs_sweep_ref``, ``traceback_ref``, ``acs_sweep_packed_ref``,
``traceback_packed_ref``) with the same operation order and
renormalization cadence; the wrappers take the twin only for tensors on
the CPU and, for CUDA tensors, launch the kernel or raise.  As in the
reference, only K1/K2 are on the decode path; K4/K5 stand alone.

Semantics held bit for bit to the Pallas kernels:

* T is a multiple of ``T_CHUNK`` = 64 (callers pad with zero LLRs) and
  the metrics renormalize to their max after every 64 steps;
* the branch metrics are ``bm = a00*l0 + a10*l1``, ``q = (l0+l1) - bm``
  and ties keep the even predecessor (strict ``cand_b > cand_a``);
* the traceback starts from a per-packet state (0, or the argmax of the
  final metrics) and emits ``bit = state >= 32``.

Layouts.  K1/K2 are packet-major, as the decode callers hold their data:
(B, T, 2) float32 LLR pairs in, (B, 64) metrics, (B, T) uint8 bits out,
and the decisions as two 32-bit words a step, ``dec`` (B, T, 2) int32
(the bits of a uint32): bit j of ``dec[b, t, 0]`` is state pair j's
low-half decision (new state j), bit j of ``dec[b, t, 1]`` its high-half
decision (new state 32 + j); 1 = the odd predecessor won.
:func:`planes_from_words` / :func:`words_from_planes` map the words to
the reference's (T, 32, B) 0/1 planes.

K4/K5 keep the reference's batch-minor layout, since only the tests hold
them (to the Pallas planes): (T, B) LLR planes and (64, B) metrics in,
(T/4, 32, B) uint8 decision planes (``acs_sweep_packed``, the TPU kernel
``viterbi_pallas.acs_sweep_packed``), (T, B) bits out
(``traceback_sweep_packed``, the TPU kernel
``viterbi_pallas.traceback_sweep_packed``).  At (T, B) = (4480, 4096) K4
is bound by its operations (4.7e9 lane-operations, ~0.14 ms on an H100;
its 442 MB take ~0.13 ms) and K5 by its 312 MB (~0.09 ms).  Both kernels
run one warp per packet in blocks of 32 neighbouring packets (8 for a
batch of up to 1024, which would fill too few SMs otherwise) and do the
transposing between the batch-minor planes and the warp's packet in
shared memory, so every row of a plane moves as whole 32 B sectors and
no load from device memory depends on the trellis state; any B is taken
(rows move as 32-bit words when B % 4 == 0, else byte by byte).  The
design notes are at the head of ``csrc/viterbi.cu``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda_lib import aligned as _aligned, counted, launch
from .cuda_lib import on_cuda as _on_cuda, require as _require
from .cuda_lib import reset_launch_counts  # noqa: F401  (re-exported)

NEG = -1e9
T_CHUNK = 64
#: the reference's lane-tile width; kept only for the measured
#: segmented-decode rule (:func:`segmented_pays`)
B_TILE = 1024


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _branch_masks_np() -> tuple[np.ndarray, np.ndarray]:
    """(a00, a10) 0/1 float32 (32, 1): output bits of the even predecessor
    p = 2j under input bit 0, out0 = p4^p3^p1^p0, out1 = p5^p4^p3^p0."""
    p = 2 * np.arange(32)[:, None]
    bit = lambda k: (p >> k) & 1  # noqa: E731
    a00 = (bit(4) ^ bit(3) ^ bit(1) ^ bit(0)) & 1
    a10 = (bit(5) ^ bit(4) ^ bit(3) ^ bit(0)) & 1
    return a00.astype(np.float32), a10.astype(np.float32)


def state0_metrics(B: int, device) -> torch.Tensor:
    """(B, 64) initial path metrics pinned to state 0 (packet start)."""
    pm = torch.full((B, 64), NEG, dtype=torch.float32, device=device)
    pm[:, 0] = 0.0
    return pm


def state0_start(B: int, device) -> torch.Tensor:
    """(B,) int32 traceback start state 0 (tail-terminated packets); the
    reference's one-hot ``state0_mask``."""
    return torch.zeros(B, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# decision words <-> the reference's decision planes
# ---------------------------------------------------------------------------

def _pack_words(take: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 -> (...) int32 holding bit j = take[..., j]."""
    sh = torch.arange(32, dtype=torch.int64, device=take.device)
    v = (take.to(torch.int64) << sh).sum(dim=-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def words_from_planes(dec_lo: torch.Tensor,
                      dec_hi: torch.Tensor) -> torch.Tensor:
    """(T, 32, B) 0/1 planes (the reference's layout) -> (B, T, 2) int32
    decision words."""
    return torch.stack([_pack_words(dec_lo.permute(2, 0, 1)),
                        _pack_words(dec_hi.permute(2, 0, 1))], dim=-1)


def planes_from_words(dec: torch.Tensor):
    """(B, T, 2) int32 decision words -> (dec_lo, dec_hi) (T, 32, B) uint8
    0/1 planes, the reference's layout."""
    sh = torch.arange(32, dtype=torch.int32, device=dec.device)
    bits = ((dec[..., None] >> sh) & 1).to(torch.uint8)     # (B, T, 2, 32)
    return (bits[:, :, 0].permute(1, 2, 0).contiguous(),
            bits[:, :, 1].permute(1, 2, 0).contiguous())


# ---------------------------------------------------------------------------
# K1: forward ACS
# ---------------------------------------------------------------------------

def _acs_steps(llr0: torch.Tensor, llr1: torch.Tensor, p: torch.Tensor):
    """The ACS recursion on batch-minor operands, shared by the twins of
    K1 and K4: llr0/llr1 (T, B), p (64, B) -> boolean decisions (T, 32, B)
    x 2 and the final metrics.  Same operation order and renormalization
    cadence as the Pallas ``_make_acs_kernel``."""
    n_steps, B = llr0.shape
    a00_np, a10_np = _branch_masks_np()
    a00 = torch.from_numpy(a00_np).to(llr0.device)
    a10 = torch.from_numpy(a10_np).to(llr0.device)
    dec_lo = torch.empty((n_steps, 32, B), dtype=torch.bool,
                         device=llr0.device)
    dec_hi = torch.empty_like(dec_lo)
    for t in range(n_steps):
        l0 = llr0[t][None, :]
        l1 = llr1[t][None, :]
        ev = p[0::2]
        od = p[1::2]
        bm = a00 * l0 + a10 * l1
        q = (l0 + l1) - bm
        ca_lo = ev + bm
        cb_lo = od + q
        ca_hi = ev + q
        cb_hi = od + bm
        take_lo = cb_lo > ca_lo
        take_hi = cb_hi > ca_hi
        dec_lo[t] = take_lo
        dec_hi[t] = take_hi
        p = torch.cat([torch.where(take_lo, cb_lo, ca_lo),
                       torch.where(take_hi, cb_hi, ca_hi)], dim=0)
        if (t + 1) % T_CHUNK == 0:
            p = p - p.max(dim=0, keepdim=True).values
    return dec_lo, dec_hi, p


def acs_sweep_ref(llr: torch.Tensor, pm0: torch.Tensor):
    """Plain PyTorch twin of K1: (B, T, 2) LLR pairs and (B, 64) metrics
    -> (B, T, 2) int32 decision words and the final (B, 64) metrics."""
    dec_lo, dec_hi, p = _acs_steps(llr[:, :, 0].T, llr[:, :, 1].T, pm0.T)
    return words_from_planes(dec_lo, dec_hi), p.T.contiguous()


@counted
def acs_sweep(llr: torch.Tensor, pm0: torch.Tensor | None = None):
    """Forward ACS over the whole trellis (K1).

    llr: (B, T, 2) float32 LLR pairs, T % 64 == 0; pm0: (B, 64) float32
    initial metrics (default: pinned to state 0).  Returns the decision
    words (B, T, 2) int32 (see the module docstring) and the final
    metrics (B, 64)."""
    _require(llr.ndim == 3 and llr.shape[2] == 2,
             f"acs_sweep takes (B, T, 2) LLR pairs, got {tuple(llr.shape)}")
    B, n_steps, _ = llr.shape
    if pm0 is None:
        pm0 = state0_metrics(B, llr.device)
    _require(n_steps % T_CHUNK == 0, f"T={n_steps} not a multiple of 64")
    _require(pm0.shape == (B, 64), f"pm0 shape {tuple(pm0.shape)}")
    _require(llr.dtype == torch.float32 and pm0.dtype == torch.float32,
             "acs_sweep takes float32")
    if not _on_cuda(llr, pm0):
        return acs_sweep_ref(llr, pm0)
    dev = llr.device
    if B == 0 or n_steps == 0:
        return (torch.empty((B, n_steps, 2), dtype=torch.int32, device=dev),
                pm0.clone())
    llr, pm0 = _aligned(llr, 8), pm0.contiguous()
    dec = torch.empty((B, n_steps, 2), dtype=torch.int32, device=dev)
    pm = torch.empty((B, 64), dtype=torch.float32, device=dev)
    launch("gr80211_acs_sweep", dev, llr.data_ptr(), pm0.data_ptr(),
           dec.data_ptr(), pm.data_ptr(), n_steps, B)
    acs_sweep.launches += 1
    acs_sweep.shapes.add((B, n_steps))
    return dec, pm


# ---------------------------------------------------------------------------
# K2: traceback
# ---------------------------------------------------------------------------

def traceback_ref(dec: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K2: walk the state index backwards over the
    (B, T, 2) decision words -> (B, T) uint8 bits."""
    B, n_steps, _ = dec.shape
    s = start.to(torch.int32)
    bits = torch.empty((B, n_steps), dtype=torch.uint8, device=dec.device)
    for t in range(n_steps - 1, -1, -1):
        hi = s >> 5
        j = s & 31
        bits[:, t] = hi.to(torch.uint8)
        word = torch.where(hi.bool(), dec[:, t, 1], dec[:, t, 0])
        s = 2 * j + ((word >> j) & 1)
    return bits


@counted
def traceback_sweep(dec: torch.Tensor,
                    start: torch.Tensor | None = None) -> torch.Tensor:
    """(B, T, 2) int32 decision words -> (B, T) uint8 bits (K2).

    start: (B,) int32 survivor start state (default 0); the reference's
    one-hot ``mask0`` is ``start`` as a one-hot column."""
    _require(dec.ndim == 3 and dec.shape[2] == 2
             and dec.shape[1] % T_CHUNK == 0,
             f"traceback_sweep takes (B, T, 2) words, T % 64 == 0, got "
             f"{tuple(dec.shape)}")
    B, n_steps, _ = dec.shape
    if start is None:
        start = state0_start(B, dec.device)
    _require(start.shape == (B,), "traceback_sweep start shape")
    _require(dec.dtype == torch.int32 and start.dtype == torch.int32,
             "traceback_sweep takes int32 words and an int32 start")
    if not _on_cuda(dec, start):
        return traceback_ref(dec, start)
    dev = dec.device
    bits = torch.empty((B, n_steps), dtype=torch.uint8, device=dev)
    if B == 0 or n_steps == 0:
        return bits
    dec, start = _aligned(dec, 8), start.contiguous()
    launch("gr80211_traceback_sweep", dev, dec.data_ptr(), start.data_ptr(),
           bits.data_ptr(), n_steps, B)
    traceback_sweep.launches += 1
    traceback_sweep.shapes.add((B, n_steps))
    return bits


# ---------------------------------------------------------------------------
# K4 / K5: packed decision planes (4 steps per byte; not on the decode path)
# ---------------------------------------------------------------------------

def pack_planes(dec: torch.Tensor) -> torch.Tensor:
    """(T, 32, B) 0/1 planes -> (T/4, 32, B) uint8, bit i of plane q =
    step 4q+i (the reference's int8 values 0..15)."""
    n_steps, _, B = dec.shape
    w = torch.tensor([1, 2, 4, 8], dtype=torch.uint8, device=dec.device)
    return (dec.reshape(n_steps // 4, 4, 32, B) * w[None, :, None, None]
            ).sum(dim=1, dtype=torch.uint8)


def unpack_planes(packed: torch.Tensor) -> torch.Tensor:
    """(T/4, 32, B) packed planes -> (T, 32, B) uint8 0/1."""
    n_q, _, B = packed.shape
    sh = torch.arange(4, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> sh[None, :, None, None]) & 1
    return bits.reshape(4 * n_q, 32, B)


def acs_sweep_packed_ref(llr0: torch.Tensor, llr1: torch.Tensor,
                         pm0: torch.Tensor):
    """Plain twin of K4: K1's recursion, then the packing."""
    dec_lo, dec_hi, pm = _acs_steps(llr0, llr1, pm0)
    return (pack_planes(dec_lo.to(torch.uint8)),
            pack_planes(dec_hi.to(torch.uint8)), pm)


@counted
def acs_sweep_packed(llr0: torch.Tensor, llr1: torch.Tensor,
                     pm0: torch.Tensor | None = None):
    """Forward ACS with packed decision planes (K4).

    llr0, llr1: (T, B) float32 planes, T % 64 == 0; pm0: (64, B) initial
    metrics (default: pinned to state 0).  Returns (dec_lo, dec_hi) as
    (T/4, 32, B) uint8, bit i = step 4q+i's decision, and the final
    metrics (64, B), equal to K1's transposed."""
    n_steps, B = llr0.shape
    if pm0 is None:
        pm0 = state0_metrics(B, llr0.device).T.contiguous()
    _require(n_steps % T_CHUNK == 0, f"T={n_steps} not a multiple of 64")
    _require(llr1.shape == llr0.shape and pm0.shape == (64, B),
             f"shapes {tuple(llr0.shape)} {tuple(llr1.shape)} "
             f"{tuple(pm0.shape)}")
    _require(all(t.dtype == torch.float32 for t in (llr0, llr1, pm0)),
             "acs_sweep_packed takes float32")
    if not _on_cuda(llr0, llr1, pm0):
        return acs_sweep_packed_ref(llr0, llr1, pm0)
    llr0, llr1, pm0 = (t.contiguous() for t in (llr0, llr1, pm0))
    dev = llr0.device
    dec_lo = torch.empty((n_steps // 4, 32, B), dtype=torch.uint8, device=dev)
    dec_hi = torch.empty_like(dec_lo)
    pm = torch.empty((64, B), dtype=torch.float32, device=dev)
    if B == 0 or n_steps == 0:
        return dec_lo, dec_hi, pm0.clone()
    launch("gr80211_acs_sweep_packed", dev, llr0.data_ptr(), llr1.data_ptr(),
           pm0.data_ptr(), dec_lo.data_ptr(), dec_hi.data_ptr(),
           pm.data_ptr(), n_steps, B)
    acs_sweep_packed.launches += 1
    acs_sweep_packed.shapes.add((B, n_steps))
    return dec_lo, dec_hi, pm


def traceback_packed_ref(dec_lo: torch.Tensor, dec_hi: torch.Tensor,
                         start: torch.Tensor) -> torch.Tensor:
    """Plain twin of K5: unpack, then K2's twin; (T, B) bits."""
    dec = words_from_planes(unpack_planes(dec_lo), unpack_planes(dec_hi))
    return traceback_ref(dec, start).T.contiguous()


@counted
def traceback_sweep_packed(dec_lo: torch.Tensor, dec_hi: torch.Tensor,
                           start: torch.Tensor | None = None) -> torch.Tensor:
    """(T/4, 32, B) packed planes -> (T, B) uint8 bits (K5); the
    reference returns the same values as float32."""
    _require(dec_lo.ndim == 3 and dec_lo.shape[1] == 32
             and dec_hi.shape == dec_lo.shape
             and 4 * dec_lo.shape[0] % T_CHUNK == 0,
             "traceback_sweep_packed shapes")
    n_q, _, B = dec_lo.shape
    n_steps = 4 * n_q
    if start is None:
        start = state0_start(B, dec_lo.device)
    _require(start.shape == (B,), "traceback_sweep_packed start shape")
    _require(dec_lo.dtype == torch.uint8 and dec_hi.dtype == torch.uint8
             and start.dtype == torch.int32,
             "traceback_sweep_packed takes uint8 planes and an int32 start")
    if not _on_cuda(dec_lo, dec_hi, start):
        return traceback_packed_ref(dec_lo, dec_hi, start)
    dec_lo, dec_hi, start = (t.contiguous() for t in (dec_lo, dec_hi, start))
    dev = dec_lo.device
    bits = torch.empty((n_steps, B), dtype=torch.uint8, device=dev)
    if B == 0 or n_steps == 0:
        return bits
    launch("gr80211_traceback_sweep_packed", dev, dec_lo.data_ptr(),
           dec_hi.data_ptr(), start.data_ptr(), bits.data_ptr(), n_steps, B)
    traceback_sweep_packed.launches += 1
    traceback_sweep_packed.shapes.add((B, n_steps))
    return bits


def argmax_start(pm: torch.Tensor) -> torch.Tensor:
    """(B, 64) final metrics -> (B,) int32 ML end state (first max, as
    ``jnp.argmax``)."""
    return torch.argmax(pm, dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# host side: monolithic and segmented decode
# ---------------------------------------------------------------------------

def _pad_batch(B: int) -> int:
    """The reference's padded lane batch (one 128-multiple tile, or a
    B_TILE multiple beyond one tile); only :func:`segmented_pays` reads it."""
    if B <= B_TILE:
        return -(-B // 128) * 128
    return -(-B // B_TILE) * B_TILE


def segmented_pays(B: int, T: int) -> bool:
    """True when the segmented decode is chosen over the monolithic sweep.

    The rule is the reference's, measured on its own chip; it is kept so
    the port decodes the same rows the same way.  Re-measuring it on the
    GPU is queued in ROADMAP.md."""
    return _pad_batch(B) <= 128 and T >= 16384


#: segmented decoding (see the reference's viterbi_pallas): each trellis
#: splits into S segments of K kept steps plus SEG_W warmup steps on each
#: side, decoded as extra batch rows from uniform metrics
SEG_W = 128
SEG_TARGET_K = 1024
#: front-pad LLR strongly favoring coded bit 0 (state-0 pin for segment 0)
PIN_LLR = -1e5


def _seg_geometry(B: int, T: int):
    """(S, K) segment count and kept steps per segment for (B, T)."""
    S = max(2, -(-T // SEG_TARGET_K))
    K = 2 * SEG_W * -(-T // (2 * SEG_W * S))
    S = -(-T // K)
    return S, K


def viterbi_decode(llr_pairs: torch.Tensor) -> torch.Tensor:
    """(B, T, 2) float32 depunctured LLRs -> (B, T) uint8 bits, traceback
    from state 0 (port of ``viterbi_decode_pallas`` with
    ``segmented="auto"``): the segmented decode where
    :func:`segmented_pays`, else one sweep with T padded to a multiple of
    64 with zero LLRs."""
    B, n_steps, _ = llr_pairs.shape
    if segmented_pays(B, n_steps):
        return _viterbi_decode_segmented(llr_pairs)
    Tp = -(-n_steps // T_CHUNK) * T_CHUNK
    x = torch.nn.functional.pad(llr_pairs, (0, 0, 0, Tp - n_steps))
    dec, _ = acs_sweep(x)
    return traceback_sweep(dec)[:, :n_steps].contiguous()


def decode_window_rows(win: torch.Tensor, keep_from: int,
                       keep: int) -> torch.Tensor:
    """(N, width, 2) LLR windows -> (N, keep) bits: ACS from uniform
    metrics, traceback from the argmax end state, keep steps
    [keep_from, keep_from + keep)."""
    pm0 = torch.zeros((win.shape[0], 64), dtype=torch.float32,
                      device=win.device)
    dec, pm_f = acs_sweep(win, pm0)
    bits = traceback_sweep(dec, argmax_start(pm_f))
    return bits[:, keep_from: keep_from + keep]


def _viterbi_decode_segmented(llr_pairs: torch.Tensor) -> torch.Tensor:
    """Overlap-save over the trellis: S segments of K steps, each decoded
    with SEG_W warmup steps on both sides; segment 0's pre-history is
    PIN_LLR (forced zero bits = the state-0 start pin)."""
    B, n_steps, _ = llr_pairs.shape
    W = SEG_W
    S, K = _seg_geometry(B, n_steps)
    P = W + S * K + W
    flat = llr_pairs.new_zeros((B, 2 * P))
    flat[:, : 2 * W] = PIN_LLR
    flat[:, 2 * W: 2 * W + 2 * n_steps] = llr_pairs.reshape(B, 2 * n_steps)
    # segment s spans steps [s*K, s*K + K + 2W) of the padded stream
    win = flat.unfold(1, 2 * (K + 2 * W), 2 * K).reshape(B * S, K + 2 * W, 2)
    kept = decode_window_rows(win, W, K)              # (B*S, K)
    return kept.reshape(B, S * K)[:, :n_steps].contiguous()
