// K6 scan_viterbi: the SIG-field Viterbi decoder of the 802.11 BCC (K=7,
// generators 133o/171o, 64 states) in one launch, hand-written for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes (ops/cuda_lib.py) and
// wrapped in gr_ieee80211_tpu_torch/ops/viterbi.py (``scan_viterbi``),
// which also holds its plain PyTorch twin (``viterbi_decode_ref``).
//
// K6 replaces no Pallas kernel: the JAX package decodes L-SIG, HT-SIG,
// VHT-SIG-A and VHT-SIG-B (and the data-parallel payload windows of
// parallel/mesh.py) with a lax.scan that XLA compiles into one loop on
// the device.  The port ran the same recursion as a Python loop of eager
// torch operations: ~8 launches a forward step and ~6 a traceback step,
// about 760 launches for a 26-bit SIG-B on a few 64-wide vectors, where
// the card idled while the host issued them.  Here the whole decode is
// one launch.
//
// Semantics, bit for bit those of the twin (the reference's scan):
//   * the trellis is padded with zero LLRs to a multiple of kChunk = 54;
//   * initial metrics -1e9, state 0 at 0;
//   * new state s has the predecessors p0 = 2s mod 64 and p1 = p0 + 1,
//     both with input bit s >> 5, and the candidates
//     cand0 = (pm[p0] + c0a[s]*l0) + c0b[s]*l1,
//     cand1 = (pm[p1] + c1a[s]*l0) + c1b[s]*l1,
//     with the 0/1 coefficients the coded bits of each transition; the
//     products are kept (__fmul_rn), so zeros and infinities behave as in
//     the twin, and every sum is an _rn intrinsic (no FMA contraction;
//     the build also passes --fmad=false);
//   * the decision is cand1 > cand0 (strict), the survivor
//     torch.maximum(cand0, cand1), NaN propagating;
//   * after every 54th step, the last one included, pm -= max(pm) (NaN
//     propagating, as torch.max);
//   * the traceback starts from state 0, or from the argmax of the final
//     metrics (the lowest index on ties, NaN above every number: as
//     torch.argmax), and emits bit s >> 5 a step; the padding steps'
//     bits are dropped.
//
// Bound.  The trellis is serial and tiny: a SIG-B decode is 54 steps of
// 64 states, ~14 K lane-operations a row, nothing a card's lanes or
// bytes notice.  What bounds it is the launch and the dependent chain of
// one row: 54 forward steps of shuffle -> add -> add -> compare -> select
// and 54 traceback steps of a few integer operations, a few microseconds.
// At (B, T) = (1024, 4480) (the data-parallel payload windows, 4482
// padded steps) the lane operations (64 states x (4 multiplies, 4 adds,
// a compare, a select) = 640 a step and row, 2.9e9) take ~0.09 ms at an
// H100's 3.35e13 float32 lane-operations a second, the bytes (37 MB of
// LLR pairs, 73 MB of decision words written and read, 4.6 MB of bits)
// ~0.03 ms; one row's chain of 4482 dependent steps is longer still.
//
// Design: one warp per row, kWarps rows a block.  Lane l holds the
// metrics of states l and l + 32, which share their predecessors
// 2l mod 64 and 2l+1 mod 64: four __shfl_sync a step fetch them (from
// the low or the high metric of lanes 2l & 31 and (2l & 31) + 1, by
// l >= 16).  The LLR pairs of 32 steps come in as one coalesced 256 B
// load, a tile ahead, and are broadcast by shuffles.  The decisions of
// the 64 states leave a step as one 64-bit word (two __ballot_sync: bit
// s = state s's decision); lane u keeps step u's word of each 32-step
// tile, so a tile's words go out as one 256 B store.  Renormalization is
// a 5-step warp max, the argmax a (value, index) warp reduction.  The
// decision words stay in shared memory when the padded trellis is at
// most kSmemSteps long (every SIG / SIG-B call: 54 steps, 432 B a row),
// otherwise in a global scratch buffer the wrapper allocates; the same
// code runs on both through a generic pointer.  The traceback is walked
// by the whole warp in step (the state is warp-uniform): each tile of 32
// words is loaded once, a tile ahead, and broadcast by shuffles, and
// lane u keeps step u's bit, so the bits leave as one 32 B store.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 54;   // renormalization cadence (the scan's CHUNK)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;    // rows (warps) per block
constexpr float kNeg = -1e9f;
// Padded trellises up to this many steps keep their decision words in
// shared memory: kWarps x 1512 x 8 B = 47.25 KB, under the 48 KB a block
// gets without opting in.  ops/viterbi.py's SMEM_STEPS is the same number.
constexpr int kSmemSteps = 1512;

// Coded bit of the generator `g` (taps on b_t .. b_{t-6} as bits 6 .. 0)
// for input bit b from state s (bit 5 = b_{t-1} .. bit 0 = b_{t-6}).
__host__ __device__ constexpr unsigned coded_bit(unsigned g, int s, int b) {
  const unsigned w =
      ((static_cast<unsigned>(b) << 6) | static_cast<unsigned>(s)) & g;
  unsigned p = 0;
  for (int i = 0; i < 7; ++i) p ^= (w >> i) & 1u;
  return p;
}

// Bit s = the coefficient of new state s: `odd` picks the predecessor
// p1 = p0 + 1 over p0 = 2s mod 64, `second` the generator 171o over 133o
// (c0a, c0b, c1a, c1b of spec/tables.viterbi_acs_tables).
__host__ __device__ constexpr uint64_t coef_mask(bool odd, bool second) {
  uint64_t m = 0;
  for (int s = 0; s < 64; ++s) {
    const int p = (2 * s) % 64 + (odd ? 1 : 0);
    m |= static_cast<uint64_t>(coded_bit(second ? 0171u : 0133u, p, s >> 5))
         << s;
  }
  return m;
}

constexpr uint64_t kC0A = coef_mask(false, false);
constexpr uint64_t kC0B = coef_mask(false, true);
constexpr uint64_t kC1A = coef_mask(true, false);
constexpr uint64_t kC1B = coef_mask(true, true);

__device__ __forceinline__ float coef(uint64_t mask, int s) {
  return ((mask >> s) & 1u) ? 1.0f : 0.0f;
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (is_nan(a) || is_nan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// One state's candidates, decision and survivor metric.
__device__ __forceinline__ float acs(float p0, float p1, float l0, float l1,
                                     float c0a, float c0b, float c1a,
                                     float c1b, bool& take) {
  const float cand0 =
      __fadd_rn(__fadd_rn(p0, __fmul_rn(c0a, l0)), __fmul_rn(c0b, l1));
  const float cand1 =
      __fadd_rn(__fadd_rn(p1, __fmul_rn(c1a, l0)), __fmul_rn(c1b, l1));
  take = cand1 > cand0;
  return (is_nan(cand0) || is_nan(cand1)) ? __int_as_float(0x7fffffff)
                                          : (take ? cand1 : cand0);
}

// (value, index) a beats (value, index) b under torch.argmax's order.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  if (is_nan(va) != is_nan(vb)) return is_nan(va);
  if (!is_nan(va) && va != vb) return va > vb;
  return ia < ib;
}

// The argmax of a row's 64 metrics (lane l: states l, l + 32), in every lane.
__device__ __forceinline__ unsigned argmax_state(float lo, float hi,
                                                 int lane) {
  float v = lo;
  int i = lane;
  if (beats(hi, lane + 32, v, i)) {
    v = hi;
    i = lane + 32;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  return static_cast<unsigned>(i);
}

// One warp per row.  decisions: (B, n_pad) words in global memory, or
// null for shared memory (dynamic, kWarps x n_pad words).
__global__ void __launch_bounds__(32 * kWarps)
scan_viterbi_kernel(const float2* __restrict__ llr,  // (B, T) pairs (l0, l1)
                    uint8_t* __restrict__ bits,      // (B, T)
                    uint2* decisions,                // (B, n_pad) or null
                    int n_steps, int n_pad, int batch, int from_zero) {
  extern __shared__ uint2 s_dec[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= batch) return;              // a whole warp; no block barrier below
  const size_t row = static_cast<size_t>(b) * static_cast<size_t>(n_steps);
  const float2* lp = llr + row;
  uint2* dp = decisions != nullptr
                  ? decisions + static_cast<size_t>(b) * n_pad
                  : s_dec + static_cast<size_t>(w) * n_pad;
  const int hi_s = lane + 32;
  const float c0a_lo = coef(kC0A, lane), c0a_hi = coef(kC0A, hi_s);
  const float c0b_lo = coef(kC0B, lane), c0b_hi = coef(kC0B, hi_s);
  const float c1a_lo = coef(kC1A, lane), c1a_hi = coef(kC1A, hi_s);
  const float c1b_lo = coef(kC1B, lane), c1b_hi = coef(kC1B, hi_s);
  const int src_ev = (2 * lane) & 31;  // holds 2l mod 64 ...
  const int src_od = src_ev + 1;       // ... and 2l+1 mod 64 ...
  const bool upper = lane >= 16;       // ... in its high metric
  float lo = lane == 0 ? 0.0f : kNeg;
  float hi = kNeg;
  int since = 0;                       // steps since the last renormalization

  const float2 zero = make_float2(0.0f, 0.0f);
  float2 ahead = lane < n_steps ? lp[lane] : zero;
  for (int t0 = 0; t0 < n_pad; t0 += 32) {
    const float2 mine = ahead;
    const int t_next = t0 + 32 + lane;
    ahead = t_next < n_steps ? lp[t_next] : zero;
    const int n = min(32, n_pad - t0);
    unsigned keep_lo = 0u, keep_hi = 0u;
    for (int u = 0; u < n; ++u) {
      const float l0 = __shfl_sync(kFull, mine.x, u);
      const float l1 = __shfl_sync(kFull, mine.y, u);
      const float ev_l = __shfl_sync(kFull, lo, src_ev);
      const float ev_h = __shfl_sync(kFull, hi, src_ev);
      const float od_l = __shfl_sync(kFull, lo, src_od);
      const float od_h = __shfl_sync(kFull, hi, src_od);
      const float p0 = upper ? ev_h : ev_l;
      const float p1 = upper ? od_h : od_l;
      bool take_lo, take_hi;
      lo = acs(p0, p1, l0, l1, c0a_lo, c0b_lo, c1a_lo, c1b_lo, take_lo);
      hi = acs(p0, p1, l0, l1, c0a_hi, c0b_hi, c1a_hi, c1b_hi, take_hi);
      const unsigned w_lo = __ballot_sync(kFull, take_lo);
      const unsigned w_hi = __ballot_sync(kFull, take_hi);
      if (lane == u) {
        keep_lo = w_lo;
        keep_hi = w_hi;
      }
      if (++since == kChunk) {
        since = 0;
        float m = max_nan(lo, hi);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = max_nan(m, __shfl_xor_sync(kFull, m, o));
        lo = __fsub_rn(lo, m);
        hi = __fsub_rn(hi, m);
      }
    }
    if (lane < n) dp[t0 + lane] = make_uint2(keep_lo, keep_hi);
  }
  __syncwarp();                        // the words are visible to every lane

  unsigned s = from_zero ? 0u : argmax_state(lo, hi, lane);
  uint8_t* bp = bits + row;
  int t0 = ((n_pad - 1) / 32) * 32;
  uint2 ahead_d = lane < n_pad - t0 ? dp[t0 + lane] : make_uint2(0u, 0u);
  for (; t0 >= 0; t0 -= 32) {
    const uint2 mine = ahead_d;
    if (t0 >= 32) ahead_d = dp[t0 - 32 + lane];
    const int n = min(32, n_pad - t0);
    unsigned bit = 0u;
    for (int u = n - 1; u >= 0; --u) {
      const unsigned d_lo = __shfl_sync(kFull, mine.x, u);
      const unsigned d_hi = __shfl_sync(kFull, mine.y, u);
      if (lane == u) bit = s >> 5;
      const unsigned word = (s & 32u) ? d_hi : d_lo;
      s = ((2u * s) & 63u) | ((word >> (s & 31u)) & 1u);
    }
    if (t0 + lane < n_steps) bp[t0 + lane] = static_cast<uint8_t>(bit);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a trellis too long for shared memory and no
// scratch.  decisions: null, or (batch, n_pad) uint2 words with n_pad =
// n_steps rounded up to a multiple of 54.
int gr80211_scan_viterbi(const void* llr, void* bits, void* decisions,
                         int n_steps, int batch, int from_zero,
                         void* stream) {
  if (batch <= 0 || n_steps <= 0) return 0;
  const int n_pad = (n_steps + kChunk - 1) / kChunk * kChunk;
  if (decisions == nullptr && n_pad > kSmemSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = decisions == nullptr
                          ? static_cast<size_t>(kWarps) * n_pad * sizeof(uint2)
                          : 0;
  const int blocks = (batch + kWarps - 1) / kWarps;
  scan_viterbi_kernel<<<blocks, 32 * kWarps, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(llr), static_cast<uint8_t*>(bits),
      static_cast<uint2*>(decisions), n_steps, n_pad, batch, from_zero);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
