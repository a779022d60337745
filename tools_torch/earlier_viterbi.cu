// The earlier design of the Viterbi kernels: one thread per packet on
// batch-minor (T, B) planes.  K1/K2 with one byte per decision in
// (T, 32, B) planes, K4/K5 with four steps' decisions a byte in
// (T/4, 32, B) planes (64 metrics in a thread's registers, 64 scattered
// byte stores every 4 steps), and tracebacks whose load address depends
// on the state just read.  It is not part of the package: it is kept
// here only as the baseline that tools_torch/viterbi_designs.py builds
// and times beside the package's warp-per-packet kernels
// (gr_ieee80211_tpu_torch/csrc/viterbi.cu).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;   // renormalization cadence (Pallas T_CHUNK)

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

__global__ void __launch_bounds__(32)
acs_kernel(const float* __restrict__ llr0, const float* __restrict__ llr1,
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
    for (int t = t0; t < t0 + kChunk; ++t) {
      const float l0 = llr0[t * B + b];
      const float l1 = llr1[t * B + b];
      const float lsum = __fadd_rn(l0, l1);
      uint8_t* dlo = dec_lo + t * 32 * B + b;
      uint8_t* dhi = dec_hi + t * 32 * B + b;
      float n[64];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float a00 = ((kA00 >> j) & 1u) ? 1.0f : 0.0f;
        const float a10 = ((kA10 >> j) & 1u) ? 1.0f : 0.0f;
        const float bm = __fadd_rn(__fmul_rn(a00, l0), __fmul_rn(a10, l1));
        const float q = __fsub_rn(lsum, bm);
        const float ev = p[2 * j];
        const float od = p[2 * j + 1];
        const float ca_lo = __fadd_rn(ev, bm);
        const float cb_lo = __fadd_rn(od, q);
        const float ca_hi = __fadd_rn(ev, q);
        const float cb_hi = __fadd_rn(od, bm);
        const bool take_lo = cb_lo > ca_lo;
        const bool take_hi = cb_hi > ca_hi;
        dlo[j * B] = take_lo;
        dhi[j * B] = take_hi;
        n[j] = take_lo ? cb_lo : ca_lo;
        n[32 + j] = take_hi ? cb_hi : ca_hi;
      }
#pragma unroll
      for (int s = 0; s < 64; ++s) p[s] = n[s];
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
traceback_kernel(const uint8_t* __restrict__ dec_lo,
                 const uint8_t* __restrict__ dec_hi,
                 const int32_t* __restrict__ start, uint8_t* __restrict__ bits,
                 int n_steps, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t B = static_cast<size_t>(batch);
  int s = start[b] & 63;
  for (int t = n_steps - 1; t >= 0; --t) {
    const int hi = s >> 5;
    const int j = s & 31;
    bits[t * B + b] = static_cast<uint8_t>(hi);
    const uint8_t* d = hi ? dec_hi : dec_lo;
    s = 2 * j + d[(t * 32 + j) * B + b];
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

// Returns cudaGetLastError() after the launch (0 = launched).
int earlier_acs_sweep(const void* llr0, const void* llr1, const void* pm0,
                      void* dec_lo, void* dec_hi, void* pm_out, int n_steps,
                      int batch, void* stream) {
  const int threads = 32;
  const int blocks = (batch + threads - 1) / threads;
  acs_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr0), static_cast<const float*>(llr1),
      static_cast<const float*>(pm0), static_cast<uint8_t*>(dec_lo),
      static_cast<uint8_t*>(dec_hi), static_cast<float*>(pm_out), n_steps,
      batch);
  return static_cast<int>(cudaGetLastError());
}

int earlier_traceback_sweep(const void* dec_lo, const void* dec_hi,
                            const void* start, void* bits, int n_steps,
                            int batch, void* stream) {
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  traceback_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dec_lo), static_cast<const uint8_t*>(dec_hi),
      static_cast<const int32_t*>(start), static_cast<uint8_t*>(bits),
      n_steps, batch);
  return static_cast<int>(cudaGetLastError());
}

int earlier_acs_sweep_packed(const void* llr0, const void* llr1,
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

int earlier_traceback_sweep_packed(const void* dec_lo, const void* dec_hi,
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
