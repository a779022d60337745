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
//   (_make_acs_kernel_packed).  K1's function on the reference's
//   batch-minor (T, B) planes with four steps' decisions a byte:
//   dec[q, j, b] bit i = step 4q+i's decision for state pair j,
//   (T/4, 32, B) planes.  Bound at (4480, 4096): operations, the same
//   4.7e9 as K1 (~0.14 ms); the bytes (147 MB of LLR planes in, 294 MB of
//   decision bytes out, 2 MB of metrics) take ~0.13 ms.
//   Design: one warp per packet as K1, lane j on butterfly j (the
//   add-compare-select is K1's, one device function, so the bit-exactness
//   rules stand in one place), in blocks of 32 warps = 32 neighbouring
//   packets, because in batch-minor planes a packet alone owns 4 bytes of
//   each 128 B LLR row and one byte of each 32 B decision row.  The block
//   loads a (32 steps, 32 packets) LLR tile as 128 B rows, a tile ahead,
//   and warp b reads its packet's column from shared memory as a
//   broadcast.  No ballots: lane j's own four decisions of a quad ARE its
//   byte (v |= take << i).  The bytes of a tile (8 quads x 64 rows x 32
//   packets, 16 KB) collect in shared memory with the word column
//   XOR-swizzled by the row (no bank conflicts on either side) and leave
//   as whole 32 B rows, four rows a warp store.  Two buffers of each
//   kind, so one __syncthreads() a tile.  The metrics enter and leave
//   through the same shared-memory transpose.
//   With 32 warps on every SM the kernel is bound by the SM's
//   instruction rate, not by one warp's chain, and there the predecessor
//   exchange through shared memory (two stores, __syncwarp, one 8-byte
//   load of metrics 2j, 2j+1) measured faster than K1's four shuffles
//   and two selects (and two shuffles with four selects slower than
//   both): K4 uses it;
//   the 16 KB it takes bring the block to 64 KB, over the 48 KB a kernel
//   gets without opting in.  Warps past the batch run on zeros like any
//   other (their bytes are never stored): a branch the compiler cannot
//   prove warp-uniform puts every collective under WARPSYNC brackets.
//
// K5 traceback_sweep_packed replaces the Pallas kernel
//   gr_ieee80211_tpu/ops/viterbi_pallas.py::traceback_sweep_packed
//   (_make_traceback_kernel_packed).  K2's function over K4's planes:
//   step t reads bit t%4 of dec[t/4, j, b] with j the state's low five
//   bits (walking backwards this peels each byte MSB first, as the Pallas
//   kernel does).  Bound at (4480, 4096): bytes, 294 MB of planes in + 18
//   MB of bits out = ~0.09 ms.
//   Design: the byte wanted depends on the state, so a walk straight over
//   the planes is T dependent trips to device memory.  Here a block of 32
//   warps = 32 packets loads a 32-step tile of both planes as whole 32 B
//   rows, a tile ahead, into shared memory, where the rows of a quad run
//   in state order; warp b walks its packet's column with the state in a
//   register (K2's shift register, one device function for both), one
//   dependent byte load from shared memory a step, none from device
//   memory.  Rebuilding K1's decision words with 64 ballots a tile, to
//   take the load out of the chain as K2 does, measured slower (13
//   instructions a step against 6): with 32 warps an SM the instructions
//   count, not the chain.  The 32 bits of
//   a tile leave through a (32, 32) byte tile as 32 B rows of the (T, B)
//   output.
//
// Both take any B: with B % 4 == 0 (and 4-byte aligned planes) rows move
// as 32-bit words, whole or absent; otherwise byte by byte.  And both
// adapt to it: a batch of up to 1024 packets makes at most 32 such
// blocks, which load 32 SMs to the full and leave 100 idle, so there a
// block is 8 warps = 8 packets (the kernels are templates on it): rows
// move as 8 B pieces of a sector, which costs nothing at this size, and
// at T = 4480 K4 takes 0.23-0.27 ms for B = 64..1024 and K5 0.16-0.18 ms
// (H100 SXM, 700 W), where 32-packet blocks take as long as they do for
// B = 4096 (0.60 and 0.28 ms).  Beyond 1024 packets 8-packet blocks lose.
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

// What a lane of a warp-per-packet ACS knows of the trellis: lane j owns
// the butterfly (2j, 2j+1) -> (j, 32+j).
struct LaneTrellis {
  float a00, a10;      // output bits of predecessor 2j under input 0
  int src_ev, src_od;  // lanes that hold predecessors 2j and 2j+1 ...
  bool upper;          // ... in their high metric (2j >= 32)
};

__device__ __forceinline__ LaneTrellis lane_trellis(int lane) {
  LaneTrellis c;
  c.a00 = ((kA00 >> lane) & 1u) ? 1.0f : 0.0f;
  c.a10 = ((kA10 >> lane) & 1u) ? 1.0f : 0.0f;
  c.src_ev = (2 * lane) & 31;
  c.src_od = c.src_ev + 1;
  c.upper = lane >= 16;
  return c;
}

// The metrics of a lane's two predecessors by four shuffles (K1): each
// source lane is read by two lanes that want different halves of it.
__device__ __forceinline__ void fetch_shfl4(const LaneTrellis& c, float lo,
                                            float hi, float& ev, float& od) {
  const float ev_l = __shfl_sync(kFull, lo, c.src_ev);
  const float ev_h = __shfl_sync(kFull, hi, c.src_ev);
  const float od_l = __shfl_sync(kFull, lo, c.src_od);
  const float od_h = __shfl_sync(kFull, hi, c.src_od);
  ev = c.upper ? ev_h : ev_l;
  od = c.upper ? od_h : od_l;
}


// Add, compare, select on a butterfly: the bit-exactness rules of K1 and
// K4.  The sums keep the reference's order with the _rn intrinsics; ties
// keep the even predecessor (strict >).
__device__ __forceinline__ void butterfly(const LaneTrellis& c, float2 l,
                                          float ev, float od, float& lo,
                                          float& hi, bool& take_lo,
                                          bool& take_hi) {
  const float bm = __fadd_rn(__fmul_rn(c.a00, l.x), __fmul_rn(c.a10, l.y));
  const float q = __fsub_rn(__fadd_rn(l.x, l.y), bm);
  const float ca_lo = __fadd_rn(ev, bm);
  const float cb_lo = __fadd_rn(od, q);
  const float ca_hi = __fadd_rn(ev, q);
  const float cb_hi = __fadd_rn(od, bm);
  take_lo = cb_lo > ca_lo;
  take_hi = cb_hi > ca_hi;
  lo = take_lo ? cb_lo : ca_lo;
  hi = take_hi ? cb_hi : ca_hi;
}

// Renormalize a packet's 64 metrics to their max (a warp max: exact).
__device__ __forceinline__ void renormalize(float& lo, float& hi) {
  float m = fmaxf(lo, hi);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  lo = __fsub_rn(lo, m);
  hi = __fsub_rn(hi, m);
}

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
  const LaneTrellis c = lane_trellis(lane);
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
      bool take_lo, take_hi;
      float ev, od;
      fetch_shfl4(c, lo, hi, ev, od);
      butterfly(c, s_llr[w][u], ev, od, lo, hi, take_lo, take_hi);
      const unsigned w_lo = __ballot_sync(kFull, take_lo);
      const unsigned w_hi = __ballot_sync(kFull, take_hi);
      if (lane == u) {
        keep_lo = w_lo;
        keep_hi = w_hi;
      }
    }
    dp[t0 + lane] = make_uint2(keep_lo, keep_hi);
    if ((t0 + 32) % kChunk == 0) renormalize(lo, hi);
  }
  pm_out[static_cast<size_t>(b) * 64 + lane] = lo;
  pm_out[static_cast<size_t>(b) * 64 + 32 + lane] = hi;
}

// One step of the survivor walk of K2 and K5.  The state is a 6-bit shift
// register of the decisions read, so one word carries both:
// hist = (hist << 1) | decision, state = hist & 63.  `decision` is taken
// from bit 0 of what the caller found for state hist & 63.
__device__ __forceinline__ unsigned walk_step(unsigned hist,
                                              unsigned decision) {
  return (hist << 1) | (decision & 1u);
}

// The decoded bits of 32 steps walked from history `prev` to `hist`: step
// u started in state ((prev:hist) >> (u + 1)) & 63 and its bit is that
// state's bit 5, i.e. bit u + 6 of the 64-bit history prev:hist.
__device__ __forceinline__ unsigned walk_bits(unsigned prev, unsigned hist) {
  return (hist >> 6) | (prev << 26);
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
      // bit (state & 31) of word (state >> 5): bit `state` of the pair
      const uint2 d = s_dec[w][u];
      const unsigned long long pair =
          (static_cast<unsigned long long>(d.y) << 32) | d.x;
      hist = walk_step(hist, static_cast<unsigned>(pair >> (hist & 63u)));
    }
    const unsigned out = walk_bits(prev, hist);
    bp[t0 + lane] = static_cast<uint8_t>((out >> lane) & 1u);
  }
}

// ---- K4 / K5: batch-minor planes, a block of P warps = P packets ----
//
// P is 32 (a row of a plane moves as a whole 32 B sector) or, for a batch
// too small to fill the card with such blocks, 8.

constexpr int kTile = 32;                    // steps a tile
constexpr int kMaxPackedThreads = 32 * 32;   // a block of 32 packets
constexpr int kTileRows = 64 * (kTile / 4);  // rows (quad, half, pair)

// A tile staged in shared memory is rows of P bytes = P/4 32-bit words
// (four packets' bytes each).  Where a warp writes one packet's byte of 32
// rows (K4's decisions, K5's bits) and P = 32, row r keeps word k in
// column k ^ swz(r), so that this warp, and a warp moving four whole rows,
// both touch 32 different banks.  (P = 8: two-way conflicts, left alone.)
template <int P>
__device__ __forceinline__ int swz(int r) {
  return P == 32 ? (r >> 2) & 7 : 0;
}

// Byte offset of packet w's byte in row j (< 32) of such a tile.
template <int P>
__device__ __forceinline__ int staged_byte(int j, int w) {
  return j * P + (((w >> 2) ^ swz<P>(j)) << 2) + (w & 3);
}

// The rows of a tile are moved as words, 128 rows a turn: in turn `it`
// thread tid has row it*128 + tid / (P/4) and its word tid % (P/4).
template <int P>
__device__ __forceinline__ int tile_row(int it, int tid) {
  return it * 128 + tid / (P / 4);
}

// Row r of the tile whose first quad is q0 lies in the lo or hi plane at
// this offset (bytes), before the packet's own.
__device__ __forceinline__ size_t plane_row(size_t q0, int r, size_t B) {
  return ((q0 + static_cast<size_t>(r >> 6)) * 32 + (r & 31)) * B;
}

// Four neighbouring packets' bytes of a row, as a word.  n_valid counts
// the bytes from p on that lie inside the batch (<= 0: none).  With
// `words` (B % 4 == 0, 4-byte aligned planes) a word is whole or absent
// and moves as one access; otherwise byte by byte.
__device__ __forceinline__ unsigned load4(const uint8_t* p, int n_valid,
                                          bool words) {
  if (words)
    return n_valid > 0 ? *reinterpret_cast<const unsigned*>(p) : 0u;
  unsigned v = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < n_valid) v |= static_cast<unsigned>(p[c]) << (8 * c);
  return v;
}

__device__ __forceinline__ void store4(uint8_t* p, unsigned v, int n_valid,
                                       bool words) {
  if (words) {
    if (n_valid > 0) *reinterpret_cast<unsigned*>(p) = v;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < n_valid) p[c] = static_cast<uint8_t>(v >> (8 * c));
}

// K4: n_steps % 64 == 0 and n_steps >= 64; any batch.  Dynamic shared
// memory: the exchange buffer, P x 2 x 64 floats.  (Launch bounds of the
// largest block for both sizes: told of 256 threads, ptxas squeezes the
// 8-packet kernels into 64 and 32 registers for occupancy, with spills.)
template <int P>
__global__ void __launch_bounds__(kMaxPackedThreads)
acs_packed_kernel(const float* __restrict__ llr0,      // (T, B)
                  const float* __restrict__ llr1,      // (T, B)
                  const float* __restrict__ pm0,       // (64, B)
                  uint8_t* __restrict__ dec_lo,        // (T/4, 32, B)
                  uint8_t* __restrict__ dec_hi,        // (T/4, 32, B)
                  float* __restrict__ pm_out,          // (64, B)
                  int n_steps, int batch, int words_) {
  constexpr int W = P / 4;                             // words a row
  __shared__ float2 s_llr[2][kTile][P];                // [step][packet]
  __shared__ __align__(16) unsigned s_dec[2][kTileRows * W];
  extern __shared__ float s_x[];                       // [warp][2][64]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int b0 = blockIdx.x * P;
  const size_t B = static_cast<size_t>(batch);
  const bool words = words_ != 0;
  const int n_tiles = n_steps / kTile;
  const LaneTrellis c = lane_trellis(lane);

  // This thread moves step tid / P of each LLR tile for packet tid % P
  // (rows of 4P bytes), and states tid / P, 32 + tid / P of the metrics.
  const int m_row = tid / P;
  const int m_col = tid % P;
  const bool col_ok = b0 + m_col < batch;
  const float* l0p = llr0 + static_cast<size_t>(m_row) * B + b0 + m_col;
  const float* l1p = llr1 + static_cast<size_t>(m_row) * B + b0 + m_col;
  const size_t tile_stride = static_cast<size_t>(kTile) * B;
  float2 ahead = col_ok ? make_float2(l0p[0], l1p[0]) : make_float2(0.f, 0.f);

  // The metrics come in (and leave) through a [state][P + 1] transpose
  // that borrows the decision buffer no tile is using: buffer 1 now,
  // buffer 0 after the last tile (n_tiles is even).
  float* s_pm = reinterpret_cast<float*>(s_dec[1]);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = 32 * k + m_row;
    s_pm[s * (P + 1) + m_col] = col_ok ? pm0[s * B + b0 + m_col] : 0.f;
  }
  s_llr[0][m_row][m_col] = ahead;
  __syncthreads();
  float lo = s_pm[lane * (P + 1) + w];
  float hi = s_pm[(32 + lane) * (P + 1) + w];
  if (col_ok) ahead = make_float2(l0p[tile_stride], l1p[tile_stride]);

  for (int n = 0; n < n_tiles; ++n) {
    const int buf = n & 1;
    uint8_t* sd = reinterpret_cast<uint8_t*>(s_dec[buf]) +
                  staged_byte<P>(lane, w);
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      unsigned v_lo = 0u, v_hi = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // The warp's 64 metrics in state order, in this step's copy of
        // the exchange buffer: lane j reads predecessors 2j, 2j+1.
        float* x = s_x + w * 128 + (i & 1) * 64;
        x[lane] = lo;
        x[32 + lane] = hi;
        __syncwarp();
        const float2 e = *reinterpret_cast<const float2*>(x + 2 * lane);
        bool take_lo, take_hi;
        butterfly(c, s_llr[buf][4 * q + i][w], e.x, e.y, lo, hi, take_lo,
                  take_hi);
        v_lo |= static_cast<unsigned>(take_lo) << i;
        v_hi |= static_cast<unsigned>(take_hi) << i;
      }
      sd[q * 64 * P] = static_cast<uint8_t>(v_lo);            // row (q, lo, j)
      sd[q * 64 * P + 32 * P] = static_cast<uint8_t>(v_hi);   // row (q, hi, j)
    }
    if (n & 1) renormalize(lo, hi);        // every kChunk = 2 tiles
    // The other buffers were last read before the previous barrier.
    if (n + 1 < n_tiles) s_llr[buf ^ 1][m_row][m_col] = ahead;
    __syncthreads();
    if (n + 2 < n_tiles && col_ok) {
      const size_t off = static_cast<size_t>(n + 2) * tile_stride;
      ahead = make_float2(l0p[off], l1p[off]);
    }
    const size_t q0 = static_cast<size_t>(n) * (kTile / 4);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = tile_row<P>(it, tid);
      const int col = tid % W;
      const int k = col ^ swz<P>(r);       // the word this column holds
      uint8_t* plane = (r & 32) ? dec_hi : dec_lo;
      store4(plane + plane_row(q0, r, B) + b0 + 4 * k, s_dec[buf][r * W + col],
             batch - b0 - 4 * k, words);
    }
  }

  float* s_out = reinterpret_cast<float*>(s_dec[0]);
  s_out[lane * (P + 1) + w] = lo;
  s_out[(32 + lane) * (P + 1) + w] = hi;
  __syncthreads();
  if (col_ok) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = 32 * k + m_row;
      pm_out[s * B + b0 + m_col] = s_out[s * (P + 1) + m_col];
    }
  }
}

// The words of the 32-step tile whose first quad is q0, as this thread
// moves them (see tile_row).
template <int P>
__device__ __forceinline__ void load_dec_tile(
    const uint8_t* __restrict__ dec_lo, const uint8_t* __restrict__ dec_hi,
    size_t q0, size_t B, int b0, int batch, bool words, int tid,
    unsigned (&v)[4]) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = tile_row<P>(it, tid);
    const int k = tid % (P / 4);
    const uint8_t* plane = (r & 32) ? dec_hi : dec_lo;
    v[it] = load4(plane + plane_row(q0, r, B) + b0 + 4 * k,
                  batch - b0 - 4 * k, words);
  }
}

template <int P>
__device__ __forceinline__ void park_dec_tile(unsigned* s,
                                              const unsigned (&v)[4],
                                              int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it)
    s[tile_row<P>(it, tid) * (P / 4) + tid % (P / 4)] = v[it];
}

// K5: n_steps % 64 == 0 and n_steps >= 64; any batch.  Tile n, counted
// from the end of the trellis, covers steps [T - 32(n+1), T - 32n).
template <int P>
__global__ void __launch_bounds__(kMaxPackedThreads)
traceback_packed_kernel(const uint8_t* __restrict__ dec_lo,   // (T/4, 32, B)
                        const uint8_t* __restrict__ dec_hi,   // (T/4, 32, B)
                        const int32_t* __restrict__ start,    // (B,)
                        uint8_t* __restrict__ bits,           // (T, B)
                        int n_steps, int batch, int words_) {
  constexpr int W = P / 4;                                    // words a row
  __shared__ __align__(16) unsigned s_dec[2][kTileRows * W];
  __shared__ __align__(16) unsigned s_bits[2][kTile * W];     // [step][packet]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int b0 = blockIdx.x * P;
  const size_t B = static_cast<size_t>(batch);
  const bool words = words_ != 0;
  const int n_tiles = n_steps / kTile;
  const size_t q_last = static_cast<size_t>(n_steps / 4 - kTile / 4);
  unsigned hist =
      b0 + w < batch ? static_cast<unsigned>(start[b0 + w]) & 63u : 0u;

  unsigned ahead[4];
  load_dec_tile<P>(dec_lo, dec_hi, q_last, B, b0, batch, words, tid, ahead);
  park_dec_tile<P>(s_dec[0], ahead, tid);
  __syncthreads();
  load_dec_tile<P>(dec_lo, dec_hi, q_last - kTile / 4, B, b0, batch, words,
                   tid, ahead);

  for (int n = 0; n < n_tiles; ++n) {
    const int buf = n & 1;
    const int t0 = n_steps - kTile * (n + 1);
    const unsigned prev = hist;
    // Rows run (quad, half, pair) = (quad, state): the decision of step
    // 4q+i in state s is bit i of this packet's byte of row 64q + s.
    const uint8_t* sd = reinterpret_cast<const uint8_t*>(s_dec[buf]) + w;
#pragma unroll
    for (int q = kTile / 4 - 1; q >= 0; --q) {
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        const unsigned v = sd[(q * 64 + (hist & 63u)) * P];
        hist = walk_step(hist, v >> i);
      }
    }
    const unsigned out = walk_bits(prev, hist);
    // lane u holds step t0 + u's bit: row u of the bits tile
    reinterpret_cast<uint8_t*>(s_bits[buf])[staged_byte<P>(lane, w)] =
        static_cast<uint8_t>((out >> lane) & 1u);
    // The other buffers were last read before the previous barrier.
    if (n + 1 < n_tiles) park_dec_tile<P>(s_dec[buf ^ 1], ahead, tid);
    __syncthreads();
    if (n + 2 < n_tiles)
      load_dec_tile<P>(dec_lo, dec_hi, q_last - static_cast<size_t>(n + 2) *
                       (kTile / 4), B, b0, batch, words, tid, ahead);
    if (tid < kTile * W) {                  // the bits tile's rows, as words
      const int r = tid / W;
      const int col = tid % W;
      const int k = col ^ swz<P>(r);
      store4(bits + static_cast<size_t>(t0 + r) * B + b0 + 4 * k,
             s_bits[buf][r * W + col], batch - b0 - 4 * k, words);
    }
  }
}

// K4 / K5 move rows as 32-bit words when every row start is 4-byte aligned.
int rows_are_words(int batch, const void* a, const void* b,
                          const void* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return batch % 4 == 0 && bits % 4 == 0;
}

// Blocks of 8 packets up to this batch (128 blocks, about one an SM), of
// 32 beyond it.
constexpr int kSmallBatch = 1024;

template <int P>
int launch_acs_packed(const void* llr0, const void* llr1,
                             const void* pm0, void* dec_lo, void* dec_hi,
                             void* pm_out, int n_steps, int batch,
                             void* stream) {
  // With P = 32 the static 48 KB and this buffer are above the default
  // limit, so the kernel opts in (per device, hence every call).
  const int exchange_bytes = P * 2 * 64 * 4;
  cudaFuncSetAttribute(acs_packed_kernel<P>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       exchange_bytes);
  acs_packed_kernel<P><<<(batch + P - 1) / P, 32 * P, exchange_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr0), static_cast<const float*>(llr1),
      static_cast<const float*>(pm0), static_cast<uint8_t*>(dec_lo),
      static_cast<uint8_t*>(dec_hi), static_cast<float*>(pm_out), n_steps,
      batch, rows_are_words(batch, dec_lo, dec_hi, dec_lo));
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_traceback_packed(const void* dec_lo, const void* dec_hi,
                                   const void* start, void* bits,
                                   int n_steps, int batch, void* stream) {
  traceback_packed_kernel<P><<<(batch + P - 1) / P, 32 * P, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dec_lo), static_cast<const uint8_t*>(dec_hi),
      static_cast<const int32_t*>(start), static_cast<uint8_t*>(bits),
      n_steps, batch, rows_are_words(batch, dec_lo, dec_hi, bits));
  return static_cast<int>(cudaGetLastError());
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
  return (batch <= kSmallBatch ? launch_acs_packed<8>
                               : launch_acs_packed<32>)(
      llr0, llr1, pm0, dec_lo, dec_hi, pm_out, n_steps, batch, stream);
}

int gr80211_traceback_sweep_packed(const void* dec_lo, const void* dec_hi,
                                   const void* start, void* bits,
                                   int n_steps, int batch, void* stream) {
  return (batch <= kSmallBatch ? launch_traceback_packed<8>
                               : launch_traceback_packed<32>)(
      dec_lo, dec_hi, start, bits, n_steps, batch, stream);
}

}  // extern "C"
