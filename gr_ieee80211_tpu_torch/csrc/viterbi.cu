// Viterbi forward add-compare-select (K1) and traceback (K2) for the
// 802.11 BCC (K=7, generators 133o/171o, 64 states), hand-written for
// Hopper (sm_90a), with the 4-steps-per-byte packed variants (K4, K5).
// Plain C interface, loaded with ctypes (ops/cuda_lib.py) and wrapped in
// gr_ieee80211_tpu_torch/ops/viterbi_kernels.py, which also holds the
// plain PyTorch twins these kernels are held to bit for bit.
//
// K1 acs_sweep replaces the Pallas kernel
//   gr_ieee80211_tpu/ops/viterbi_pallas.py::acs_sweep (_make_acs_kernel).
//   Bound at (T = 4480, B = 4096) on an H100 SXM: operations.  One step
//   of one packet is 32 butterflies x (4 adds, 2 compares, 2 selects) =
//   256 lane-operations, 4.7e9 in all, ~0.14 ms at the card's 3.35e13
//   float32 lane-operations a second; the bytes (147 MB of LLR pairs in,
//   147 MB of decision words out) take ~0.09 ms at 3.35 TB/s.
//   What is scarce on this card is threads in flight and dependent
//   latency, not lanes, so the design is one WARP per packet: lane j
//   owns the butterfly (2j, 2j+1) -> (j, 32+j) and keeps the two new
//   metrics in registers.  The next step's predecessors come by
//   __shfl_sync from lanes (2j)&31 and (2j+1)&31, from their low or high
//   metric by j >= 16.  B = 4096 gives 4096 warps (31 an SM) instead of
//   128, and a small batch still takes only its own serial chain
//   (T steps of one shuffle + add + compare + select).  Decisions leave
//   as two 32-bit words a step (__ballot_sync of the low and the high
//   halves' choices, bit j = state pair j); lane u keeps step u's words
//   of each 32-step block, so a block's 32 word pairs go out as one
//   coalesced 256 B store: 8 B a step and packet instead of 64.  The LLR
//   pairs of a block come in as one coalesced 256 B load, issued a block
//   ahead, and are broadcast to the lanes from shared memory.  Input and
//   output are packet-major ((B, T, 2) LLR pairs as the callers hold them,
//   (B, 64) metrics), so no transposes surround the kernel.  Metrics
//   renormalize to their max (a warp max, exact) every 64 steps, the
//   Pallas kernel's T_CHUNK cadence.
//
// K2 traceback_sweep replaces the Pallas kernel
//   gr_ieee80211_tpu/ops/viterbi_pallas.py::traceback_sweep
//   (_make_traceback_kernel).  Bound at (4480, 4096): bytes, 147 MB of
//   decision words in + 18 MB of bits out = ~0.05 ms; the serial chain
//   of one packet is 4480 x a few integer operations, ~0.02 ms.
//   Design: with both words of a step in one place, the address of step
//   t's load no longer depends on the state, so nothing serial waits on
//   memory.  One warp per packet loads 32 steps at once (256 B, one word
//   pair a lane, the next block a block ahead), parks them in shared
//   memory and walks them with the state in a register:
//   s = 2*(s&31) + ((word[s>>5] >> (s&31)) & 1), written as a shift
//   register of the decisions (hist = 2*hist + bit, s = hist & 63) so the
//   decoded bits (bit 5 of each state) need no instruction of their own.
//   The 32 bits of a block leave as one 32 B store, (B, T) bytes
//   packet-major.
//
// K4 acs_sweep_packed replaces the Pallas kernel
//   gr_ieee80211_tpu/ops/viterbi_pallas.py::acs_sweep_packed
//   (_make_acs_kernel_packed).  K1's function on batch-minor (T, B)
//   planes with four steps' decisions packed per byte: dec[q, j, b] bit i
//   = step 4q+i's decision for state pair j, (T/4, 32, B) planes.  Bound
//   as K1 with 0.29 GB moved (~0.09 ms); not on a decode path, so it
//   keeps the one-thread-per-packet sweep with 64 metrics in registers
//   (the de Bruijn predecessor split is a register renaming after full
//   unrolling): 128 warps for B = 4096, about one an SM, latency-bound.
//   Each step's 32 lo and 32 hi decisions collect as bits of one 32-bit
//   word each, and every 4 steps one byte per state pair is assembled
//   from the four words and stored.
//
// K5 traceback_sweep_packed replaces the Pallas kernel
//   gr_ieee80211_tpu/ops/viterbi_pallas.py::traceback_sweep_packed
//   (_make_traceback_kernel_packed).  K2's function over K4's planes:
//   step t reads bit t%4 of dec[t/4, j, b] (walking backwards this peels
//   each byte MSB first, as the Pallas kernel does).  One thread per
//   packet and one dependent byte load per step: latency-bound, off the
//   decode path.
//
// Bit-exactness with the reference: every sum is written with the _rn
// intrinsics (no FMA contraction; the build also passes --fmad=false),
// in the reference's operation order bm = a00*l0 + a10*l1,
// q = (l0 + l1) - bm, and ties keep the even predecessor (strict
// cand_b > cand_a).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;   // renormalization cadence (Pallas T_CHUNK)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;    // packets (warps) per block, K1 and K2

// Output-bit masks of the even predecessor p = 2j with input bit 0:
//   out0 = p4 ^ p3 ^ p1 ^ p0,   out1 = p5 ^ p4 ^ p3 ^ p0
__host__ __device__ constexpr unsigned out_mask(int which) {
  unsigned m = 0;
  for (int j = 0; j < 32; ++j) {
    const int p = 2 * j;
    const int b0 = ((p >> 4) ^ (p >> 3) ^ (p >> 1) ^ p) & 1;
    const int b1 = ((p >> 5) ^ (p >> 4) ^ (p >> 3) ^ p) & 1;
    m |= unsigned(which == 0 ? b0 : b1) << j;
  }
  return m;
}

constexpr unsigned kA00 = out_mask(0);
constexpr unsigned kA10 = out_mask(1);

// K1: one warp per packet; n_steps % 64 == 0 and n_steps >= 64.
__global__ void __launch_bounds__(32 * kWarps)
acs_kernel(const float2* __restrict__ llr,     // (B, T) pairs (l0, l1)
           const float* __restrict__ pm0,      // (B, 64)
           uint2* __restrict__ dec,            // (B, T) words (lo, hi)
           float* __restrict__ pm_out,         // (B, 64)
           int n_steps, int batch) {
  __shared__ float2 s_llr[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= batch) return;              // a whole warp; no block barrier below
  const size_t row = static_cast<size_t>(b) * static_cast<size_t>(n_steps);
  const float2* lp = llr + row;
  uint2* dp = dec + row;
  const float a00 = ((kA00 >> lane) & 1u) ? 1.0f : 0.0f;
  const float a10 = ((kA10 >> lane) & 1u) ? 1.0f : 0.0f;
  const int src_ev = (2 * lane) & 31;
  const int src_od = src_ev + 1;
  const bool upper = lane >= 16;       // predecessors 2j, 2j+1 are >= 32
  float lo = pm0[static_cast<size_t>(b) * 64 + lane];
  float hi = pm0[static_cast<size_t>(b) * 64 + 32 + lane];
  float2 ahead = lp[lane];

  for (int t0 = 0; t0 < n_steps; t0 += 32) {
    __syncwarp();
    s_llr[w][lane] = ahead;
    __syncwarp();
    if (t0 + 32 < n_steps) ahead = lp[t0 + 32 + lane];
    unsigned keep_lo = 0u, keep_hi = 0u;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const float2 l = s_llr[w][u];
      const float ev_l = __shfl_sync(kFull, lo, src_ev);
      const float ev_h = __shfl_sync(kFull, hi, src_ev);
      const float od_l = __shfl_sync(kFull, lo, src_od);
      const float od_h = __shfl_sync(kFull, hi, src_od);
      const float ev = upper ? ev_h : ev_l;
      const float od = upper ? od_h : od_l;
      const float bm = __fadd_rn(__fmul_rn(a00, l.x), __fmul_rn(a10, l.y));
      const float q = __fsub_rn(__fadd_rn(l.x, l.y), bm);
      const float ca_lo = __fadd_rn(ev, bm);
      const float cb_lo = __fadd_rn(od, q);
      const float ca_hi = __fadd_rn(ev, q);
      const float cb_hi = __fadd_rn(od, bm);
      const bool take_lo = cb_lo > ca_lo;
      const bool take_hi = cb_hi > ca_hi;
      const unsigned w_lo = __ballot_sync(kFull, take_lo);
      const unsigned w_hi = __ballot_sync(kFull, take_hi);
      if (lane == u) {
        keep_lo = w_lo;
        keep_hi = w_hi;
      }
      lo = take_lo ? cb_lo : ca_lo;
      hi = take_hi ? cb_hi : ca_hi;
    }
    dp[t0 + lane] = make_uint2(keep_lo, keep_hi);
    if ((t0 + 32) % kChunk == 0) {
      float m = fmaxf(lo, hi);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
      lo = __fsub_rn(lo, m);
      hi = __fsub_rn(hi, m);
    }
  }
  pm_out[static_cast<size_t>(b) * 64 + lane] = lo;
  pm_out[static_cast<size_t>(b) * 64 + 32 + lane] = hi;
}

// K2: one warp per packet; n_steps % 32 == 0 and n_steps >= 32.
__global__ void __launch_bounds__(32 * kWarps)
traceback_kernel(const uint2* __restrict__ dec,       // (B, T) words
                 const int32_t* __restrict__ start,   // (B,)
                 uint8_t* __restrict__ bits,          // (B, T)
                 int n_steps, int batch) {
  __shared__ uint2 s_dec[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= batch) return;
  const size_t row = static_cast<size_t>(b) * static_cast<size_t>(n_steps);
  const uint2* dp = dec + row;
  uint8_t* bp = bits + row;
  // The state is a 6-bit shift register of the decisions read, so one
  // word carries both: hist = (hist << 1) | decision, state = hist & 63.
  unsigned hist = static_cast<unsigned>(start[b]) & 63u;
  uint2 ahead = dp[n_steps - 32 + lane];

  for (int t0 = n_steps - 32; t0 >= 0; t0 -= 32) {
    __syncwarp();
    s_dec[w][lane] = ahead;
    __syncwarp();
    if (t0 >= 32) ahead = dp[t0 - 32 + lane];
    const unsigned prev = hist;
#pragma unroll
    for (int u = 31; u >= 0; --u) {
      const uint2 d = s_dec[w][u];
      // bit (state & 31) of word (state >> 5): bit `state` of the pair
      const unsigned long long pair =
          (static_cast<unsigned long long>(d.y) << 32) | d.x;
      hist = (hist << 1) | (static_cast<unsigned>(pair >> (hist & 63u)) & 1u);
    }
    // step t0+u started in state ((prev:hist) >> (u + 1)) & 63; its bit is
    // that state's bit 5, i.e. bit u + 6 of the 64-bit history prev:hist
    const unsigned out = (hist >> 6) | (prev << 26);
    bp[t0 + lane] = static_cast<uint8_t>((out >> lane) & 1u);
  }
}

__global__ void __launch_bounds__(32)
acs_packed_kernel(const float* __restrict__ llr0,
                  const float* __restrict__ llr1,
                  const float* __restrict__ pm0, uint8_t* __restrict__ dec_lo,
                  uint8_t* __restrict__ dec_hi, float* __restrict__ pm_out,
                  int n_steps, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t B = static_cast<size_t>(batch);
  float p[64];
#pragma unroll
  for (int s = 0; s < 64; ++s) p[s] = pm0[s * B + b];

  for (int t0 = 0; t0 < n_steps; t0 += kChunk) {
    for (int q = t0 / 4; q < (t0 + kChunk) / 4; ++q) {
      unsigned mlo[4], mhi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t t = 4 * static_cast<size_t>(q) + i;
        const float l0 = llr0[t * B + b];
        const float l1 = llr1[t * B + b];
        const float lsum = __fadd_rn(l0, l1);
        unsigned wl = 0u, wh = 0u;
        float n[64];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float a00 = ((kA00 >> j) & 1u) ? 1.0f : 0.0f;
          const float a10 = ((kA10 >> j) & 1u) ? 1.0f : 0.0f;
          const float bm = __fadd_rn(__fmul_rn(a00, l0), __fmul_rn(a10, l1));
          const float qq = __fsub_rn(lsum, bm);
          const float ev = p[2 * j];
          const float od = p[2 * j + 1];
          const float ca_lo = __fadd_rn(ev, bm);
          const float cb_lo = __fadd_rn(od, qq);
          const float ca_hi = __fadd_rn(ev, qq);
          const float cb_hi = __fadd_rn(od, bm);
          const bool take_lo = cb_lo > ca_lo;
          const bool take_hi = cb_hi > ca_hi;
          wl |= static_cast<unsigned>(take_lo) << j;
          wh |= static_cast<unsigned>(take_hi) << j;
          n[j] = take_lo ? cb_lo : ca_lo;
          n[32 + j] = take_hi ? cb_hi : ca_hi;
        }
        mlo[i] = wl;
        mhi[i] = wh;
#pragma unroll
        for (int s = 0; s < 64; ++s) p[s] = n[s];
      }
      uint8_t* dlo = dec_lo + static_cast<size_t>(q) * 32 * B + b;
      uint8_t* dhi = dec_hi + static_cast<size_t>(q) * 32 * B + b;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        unsigned vlo = 0u, vhi = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vlo |= ((mlo[i] >> j) & 1u) << i;
          vhi |= ((mhi[i] >> j) & 1u) << i;
        }
        dlo[j * B] = static_cast<uint8_t>(vlo);
        dhi[j * B] = static_cast<uint8_t>(vhi);
      }
    }
    float m = p[0];
#pragma unroll
    for (int s = 1; s < 64; ++s) m = fmaxf(m, p[s]);
#pragma unroll
    for (int s = 0; s < 64; ++s) p[s] = __fsub_rn(p[s], m);
  }
#pragma unroll
  for (int s = 0; s < 64; ++s) pm_out[s * B + b] = p[s];
}

__global__ void __launch_bounds__(128)
traceback_packed_kernel(const uint8_t* __restrict__ dec_lo,
                        const uint8_t* __restrict__ dec_hi,
                        const int32_t* __restrict__ start,
                        uint8_t* __restrict__ bits, int n_steps, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t B = static_cast<size_t>(batch);
  int s = start[b] & 63;
  for (int t = n_steps - 1; t >= 0; --t) {
    const int hi = s >> 5;
    const int j = s & 31;
    bits[t * B + b] = static_cast<uint8_t>(hi);
    const uint8_t* d = hi ? dec_hi : dec_lo;
    const uint8_t packed = d[(static_cast<size_t>(t >> 2) * 32 + j) * B + b];
    s = 2 * j + ((packed >> (t & 3)) & 1);
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int gr80211_acs_sweep(const void* llr, const void* pm0, void* dec,
                      void* pm_out, int n_steps, int batch, void* stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  acs_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(llr), static_cast<const float*>(pm0),
      static_cast<uint2*>(dec), static_cast<float*>(pm_out), n_steps, batch);
  return static_cast<int>(cudaGetLastError());
}

int gr80211_traceback_sweep(const void* dec, const void* start, void* bits,
                            int n_steps, int batch, void* stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  traceback_kernel<<<blocks, 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(dec), static_cast<const int32_t*>(start),
      static_cast<uint8_t*>(bits), n_steps, batch);
  return static_cast<int>(cudaGetLastError());
}

int gr80211_acs_sweep_packed(const void* llr0, const void* llr1,
                             const void* pm0, void* dec_lo, void* dec_hi,
                             void* pm_out, int n_steps, int batch,
                             void* stream) {
  const int threads = 32;
  const int blocks = (batch + threads - 1) / threads;
  acs_packed_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr0), static_cast<const float*>(llr1),
      static_cast<const float*>(pm0), static_cast<uint8_t*>(dec_lo),
      static_cast<uint8_t*>(dec_hi), static_cast<float*>(pm_out), n_steps,
      batch);
  return static_cast<int>(cudaGetLastError());
}

int gr80211_traceback_sweep_packed(const void* dec_lo, const void* dec_hi,
                                   const void* start, void* bits,
                                   int n_steps, int batch, void* stream) {
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  traceback_packed_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dec_lo), static_cast<const uint8_t*>(dec_hi),
      static_cast<const int32_t*>(start), static_cast<uint8_t*>(bits),
      n_steps, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
