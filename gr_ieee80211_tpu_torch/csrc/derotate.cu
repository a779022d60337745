// Per-row CFO derotation (K3), hand-written for Hopper (sm_90a).  Plain C
// interface, loaded with ctypes (ops/cuda_lib.py) and wrapped by
// gr_ieee80211_tpu_torch/ops/frontend.py::derotate, which also holds the
// plain PyTorch twin (derotate_ref) this kernel is held to.
//
// K3 derotate replaces the Pallas kernel
//   gr_ieee80211_tpu/ops/frontend.py::derotate_pallas (_derotate_kernel):
//   out[r, t] = wins[r, t] * exp(j * w_r * t), w_r = float32(-2 pi / FS)
//   * cfo[r], with the phase w_r * t taken in float32 as the reference
//   does.  Like the reference, it is kept off the receive chain (the chain
//   runs the factored-phasor form, frontend._derotate_factored).
//   Work per sample: one sincosf and 6 float ops, 16 B read and 16 B
//   written.  Expected bound (not measured): device-memory bandwidth at
//   large B*n, or the sincosf argument reduction at long windows (the
//   phase reaches hundreds of radians at a 100k-sample window, so the
//   precise sincosf, not __sinf/__cosf or fast-math, is used: the fast
//   intrinsics lose accuracy far outside [-pi, pi]).  Design: one thread
//   per sample along a row (neighbouring threads on neighbouring
//   addresses, so every load and store is coalesced), rows on the grid's
//   y axis with a grid-stride loop for batches beyond its limit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
derotate_kernel(const float* __restrict__ re, const float* __restrict__ im,
                const float* __restrict__ cfo, float* __restrict__ out_re,
                float* __restrict__ out_im, int n, int batch, float w_scale) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float tf = static_cast<float>(t);
  for (int r = blockIdx.y; r < batch; r += gridDim.y) {
    const float w = __fmul_rn(w_scale, cfo[r]);
    const float ph = __fmul_rn(w, tf);
    float s, c;
    sincosf(ph, &s, &c);
    const size_t k = static_cast<size_t>(r) * n + t;
    const float x = re[k];
    const float y = im[k];
    out_re[k] = __fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s));
    out_im[k] = __fadd_rn(__fmul_rn(x, s), __fmul_rn(y, c));
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int gr80211_derotate(const void* re, const void* im, const void* cfo,
                     void* out_re, void* out_im, int n, int batch,
                     float w_scale, void* stream) {
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, batch < 65535 ? batch : 65535);
  derotate_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(cfo), static_cast<float*>(out_re),
      static_cast<float*>(out_im), n, batch, w_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
