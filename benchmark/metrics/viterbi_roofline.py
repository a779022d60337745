"""Kernels: the share of its roofline that the payload Viterbi decode
reaches.

The decode is ``ops/viterbi_kernels.viterbi_decode`` as the decode ladder
calls it (``ops/fastdecode.viterbi_decode``): (B, T, 2) float32 LLR pairs
in, (B, T) uint8 bits out.  Its least time is counted from (B, T) alone,
whatever kernels implement it:

* bytes: the LLRs read once, B*T*2 float32, and the bits written once,
  B*T uint8: 9*B*T bytes at 3.35e12 B/s (H100 SXM HBM3);
* operations: each trellis step of each packet costs 260 lane
  operations: 64 states x (2 branch metrics + 1 compare + 1 select) = 256
  for add-compare-select, and 4 for the traceback's state update, at
  3.35e13 lane operations/s: NVIDIA's published 67 TFLOP/s float32 FMA
  rate counted as 33.5e12 FMAs, one lane operation each (an assumed rate;
  the card's power limit is printed beside it).

The least time is the larger of the two (operations: 260 / 3.35e13 s a
step against 9 / 3.35e12), summed over the calls of the profiled
stretch, over the device time of everything those calls launched
(kernels, copies, sets; the profiler's trace, by launch correlation).
Nothing to read (no call) gives no value."""
SPANS = ("gr_ieee80211_tpu_torch.ops.fastdecode:viterbi_decode",)

PEAK_BYTES_S = 3.35e12
PEAK_LANE_OPS_S = 67e12 / 2
OPS_PER_STEP = 260
BYTES_PER_STEP = 2 * 4 + 1


def bound_s(B: int, T: int) -> float:
    return max(B * T * BYTES_PER_STEP / PEAK_BYTES_S,
               B * T * OPS_PER_STEP / PEAK_LANE_OPS_S)


def read(t):
    key = "viterbi_decode"
    shapes = t.shapes(key)
    dev = t.device.inside(key) if t.device is not None else None
    if not shapes or not dev:
        return None
    return 100.0 * sum(bound_s(s[0], s[1]) for s in shapes) / dev
