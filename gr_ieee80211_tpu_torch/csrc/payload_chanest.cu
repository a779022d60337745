// K7 payload_chanest: the payload's channel estimate of one receive bucket
// in one launch, hand-written for Hopper (sm_90a).  Plain C interface,
// loaded with ctypes (ops/cuda_lib.py) and wrapped in
// gr_ieee80211_tpu_torch/ops/ofdm.py (``payload_chanest``), which also
// holds its plain PyTorch twin (``payload_chanest_ref``).
//
// K7 replaces no Pallas kernel: the JAX package computes this stage with
// jnp operations that XLA fuses into a few programs.  The port ran it as
// eager torch operations: per antenna two L-LTF and three SIG-symbol
// DFTs, five coherence-gated observations, sign decisions and the
// delay-subspace projection, ~60 launches of a few 64-wide vectors each,
// plus the HT/VHT-LTF DFTs and combines in front of them.  The card idled
// while the host issued them; here the whole stage is one launch.
//
// What it computes, per row b and antenna r (xs: the derotated window,
// t = 0 at the first L-LTF repeat):
//   * L (fmt 0): the L-LTF estimate h = (DFT(xs[0:64]) + DFT(xs[64:128]))
//     * (0.5 / L-LTF ref) on the 52 tones, 1 elsewhere; pilot_h = h at the
//     4 pilot tones;
//   * HT/VHT: the P-matrix estimate of each stream s from the nltf
//     HT/VHT-LTFs at 448 + 80 j + 16, (sum_j P[s][j] DFT_j) * (ref^-1 /
//     nltf) on the 56 tones, 1 elsewhere; VHT pilot_h the R-combined LTFs
//     at the pilots * 1 / (ref * nltf); HT pilot_h the sum over streams of
//     h at the pilots;
//   * HT/VHT with one stream (``refine``): the SISO refinement of
//     ops/ofdm.refine_chanest_siso: the L-LTF estimate scaled by
//     sqrt(52/56) and rotated onto the HT/VHT estimate, kept (weight 2)
//     where its coherence passes coh_min; the three (Q)BPSK SIG symbols
//     (L-SIG, then HT-SIG1/2 or VHT-SIG-A1/2, QBPSK where the format's
//     order has it: its 48 data tones only) as decision-directed
//     observations of the running mean, each gated by its own coherence
//     and the L-LTF's; the VHT-SIG-B symbol against the updated mean on
//     the 56 tones when sigb_start >= 0; then the weighted mean projected
//     onto the <=32-tap delay subspace (the 56x56 projector).
//
// Arithmetic, that of the twin in float32 and in its order:
//   * a DFT applies the twin's float32 matrices in float64, summing n =
//     0..63 in order, and rounds to float32 once, as ops/cplx._cmatmul
//     does; a product of two floats is exact in a double, so the fused
//     multiply-adds leave the same partial sums as a multiply and an add;
//   * every elementwise step keeps the twin's order of operations; the
//     build passes --fmad=false, so nothing is contracted; divisions and
//     square roots are IEEE-rounded (_rn intrinsics, no fast math);
//   * the sign decisions are sign(v) + (v == 0) (0 maps to +1), the gates
//     the strict coh > coh_min in float32;
//   * where the twin's order cannot be known, the kernel fixes its own:
//     the 64-tone sums (PyTorch's reduction tree) are a warp butterfly then
//     the two warps' sum, and the projection (a cuBLAS float32 product) is
//     a sequential float32 multiply-add over the 56 tones.  Refined
//     estimates may differ from the twin's there in the last bits; the L
//     and P-matrix estimates have no such sum and are bit-equal but for a
//     float64 DFT sum that cuBLAS takes in another order and that lands
//     within its rounding of a float32 rounding boundary.
//
// Bound.  A row and antenna reads at most 8 windows of 64 complex samples
// (4 KB) and writes 64 to 128 complex estimates; the work is at most 8
// DFTs of 64 x 64 complex products in float64 (131 K double multiply-adds)
// and a 56 x 56 complex projection (12.5 K float multiply-adds).  At
// (B, nrx) = (4096, 1) that is 17 MB and 5.4e8 double multiply-adds, 0.005
// ms of memory and 0.032 ms of the H100's 33.5e12 float64 operations a
// second (a multiply-add counted as two): the float64 DFTs bound a large
// bucket; nothing bounds a bucket of the daemon (1-2 rows) but the launch.
//
// Design: one block of 64 threads per (row, antenna), thread k owns tone k
// (grid (B, nrx): the kernel adapts to the bucket through its grid alone).
// The windows a branch needs are staged in shared memory by one coalesced
// load each; a DFT tone reads its window from shared memory and the
// matrices from a constant table (L1-resident, 59 KB) the wrapper builds
// once per device; a 64-tone sum is a butterfly in each warp and one
// exchange through shared memory, so all 64 threads hold the same sum.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTones = 64;
constexpr int kActive = 56;           // tones of the HT/VHT-LTF (no DC)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNlLtf = 448;           // first HT/VHT-LTF's GI: L-LTF, L-SIG,
                                      // 2 SIG symbols, HT/VHT-STF
constexpr int kFmtL = 0, kFmtVht = 2;  // spec.params.Fmt

// Window slots in shared memory: the two L-LTF repeats, up to two
// HT/VHT-LTFs, the three SIG symbols, VHT-SIG-B.
constexpr int kSlotLltf = 0, kSlotNl = 2, kSlotSig = 4, kSlotSigb = 7;
constexpr int kSlots = 8;

// Offsets (floats) into the constant table of ops/ofdm._chanest_table.
constexpr int kDftC = 0;          // (64 n, 64 k) float32 DFT matrix, cos
constexpr int kDftS = 4096;       // ... and sin
constexpr int kProjRe = 8192;     // (56, 56) delay-subspace projector
constexpr int kProjIm = 11328;
constexpr int kLInv = 14464;      // 1 / L-LTF reference, 0 off its 52 tones
constexpr int kNlInv = 14528;     // 1 / HT/VHT-LTF reference, 0 off its 56
constexpr int kDataL = 14592;     // 1 at the 48 legacy data tones
constexpr int kActPos = 14656;    // a tone's index among the 56, or -1
constexpr int kPilot = 14720;     // the 4 pilot tones
constexpr int kPLtf = 14724;      // (4, 4) P matrix: streams x LTFs
constexpr int kRLtf = 14740;      // the R row (pilot tones)
constexpr int kPilotRef = 14744;  // HT/VHT-LTF reference at the pilots
constexpr int kTableSize = 14748;
static_assert(kPilotRef + 4 == kTableSize, "the table ends at the pilots");

struct Cx {
  float re, im;
};

// a * conj(o) (CF.mul_conj) and a * o (CF.__mul__), in the twin's order.
__device__ __forceinline__ Cx mul_conj(Cx a, Cx o) {
  return {a.re * o.re + a.im * o.im, a.im * o.re - a.re * o.im};
}
__device__ __forceinline__ Cx mul(Cx a, Cx o) {
  return {a.re * o.re - a.im * o.im, a.re * o.im + a.im * o.re};
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.sign(v) + (v == 0): -1, +1, 0 -> +1 (NaN -> 0, as torch.sign).
__device__ __forceinline__ float sign0(float v) {
  return ((v > 0.0f ? 1.0f : 0.0f) - (v < 0.0f ? 1.0f : 0.0f)) +
         (v == 0.0f ? 1.0f : 0.0f);
}

// Tone k of the fftshifted DFT of one staged window.
__device__ __forceinline__ Cx dft_tone(const float* wr, const float* wi,
                                       const float* __restrict__ tab, int k) {
  double a = 0.0, b = 0.0, c = 0.0, d = 0.0;
#pragma unroll 8
  for (int n = 0; n < kTones; ++n) {
    const double x = wr[n], y = wi[n];
    const double cs = __ldg(tab + kDftC + n * kTones + k);
    const double sn = __ldg(tab + kDftS + n * kTones + k);
    a = __fma_rn(x, cs, a);
    b = __fma_rn(y, sn, b);
    c = __fma_rn(x, sn, c);
    d = __fma_rn(y, cs, d);
  }
  return {__double2float_rn(__dsub_rn(a, b)),
          __double2float_rn(__dadd_rn(c, d))};
}

// The sums over the 64 tones of (x, y, z, w), in every thread.
__device__ __forceinline__ float4 tone_sum4(float4 v, float4* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x = v.x + __shfl_xor_sync(kFull, v.x, o);
    v.y = v.y + __shfl_xor_sync(kFull, v.y, o);
    v.z = v.z + __shfl_xor_sync(kFull, v.z, o);
    v.w = v.w + __shfl_xor_sync(kFull, v.w, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const float4 s = make_float4(red[0].x + red[1].x, red[0].y + red[1].y,
                               red[0].z + red[1].z, red[0].w + red[1].w);
  __syncthreads();                 // red is free for the next sum
  return s;
}

// refine_chanest_siso's gated_obs at tone k: the observation rotated by the
// unit of its masked correlation with ref, and its coherence gate (0 / 1).
__device__ __forceinline__ Cx gated_obs(Cx obs, Cx ref, float m, float coh_min,
                                        float4* red, float& gate) {
  const Cx p = mul_conj(ref, obs);
  const float4 s = tone_sum4(
      make_float4(p.re * m, p.im * m, (obs.re * obs.re + obs.im * obs.im) * m,
                  (ref.re * ref.re + ref.im * ref.im) * m),
      red);
  const float mag = __fsqrt_rn(s.x * s.x + s.y * s.y);
  const float coh =
      __fdiv_rn(mag, __fsqrt_rn(clamp_min(s.z * s.w, 1e-12f)));
  const float a = clamp_min(mag, 1e-12f);
  gate = coh > coh_min ? 1.0f : 0.0f;
  return mul(obs, {__fdiv_rn(s.x, a), __fdiv_rn(s.y, a)});
}

__global__ void __launch_bounds__(kTones)
payload_chanest_kernel(const float* __restrict__ xr,  // (B, nrx, n)
                       const float* __restrict__ xi,
                       const float* __restrict__ tab,
                       float* __restrict__ h_re,      // (B, nrx, nss, 64)
                       float* __restrict__ h_im,
                       float* __restrict__ p_re,      // (B, nrx, 4)
                       float* __restrict__ p_im, int n, int fmt, int nltf,
                       int nss, int refine, int sigb_start, float gain,
                       float coh_min) {
  __shared__ float s_wr[kSlots][kTones], s_wi[kSlots][kTones];
  __shared__ float s_ar[kActive], s_ai[kActive];
  __shared__ float4 s_red[2];
  const int k = threadIdx.x;
  const size_t rr = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const float* wr = xr + rr * static_cast<size_t>(n);
  const float* wi = xi + rr * static_cast<size_t>(n);
  const bool legacy = fmt == kFmtL;
  const bool sigb = refine && sigb_start >= 0;

  // stage the windows this branch reads
  for (int w = 0; w < kSlots; ++w) {
    int start = -1;
    if (w < kSlotNl) {
      if (legacy || refine) start = 64 * w;
    } else if (w < kSlotSig) {
      if (!legacy && w - kSlotNl < nltf)
        start = kNlLtf + 80 * (w - kSlotNl) + 16;
    } else if (w < kSlotSigb) {
      if (refine) start = 128 + 80 * (w - kSlotSig) + 16;
    } else if (sigb) {
      start = sigb_start + 16;
    }
    if (start >= 0) {
      s_wr[w][k] = wr[start + k];
      s_wi[w][k] = wi[start + k];
    }
  }
  __syncthreads();

  const float l_inv = tab[kLInv + k], nl_inv = tab[kNlInv + k];
  const bool l_nz = l_inv != 0.0f, nl_nz = nl_inv != 0.0f;
  int pilot = -1;                  // this tone's pilot index
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (static_cast<int>(tab[kPilot + j]) == k) pilot = j;
  float* hr = h_re + rr * nss * kTones + k;
  float* hi = h_im + rr * nss * kTones + k;

  // the L-LTF estimate (legacy_chanest)
  Cx hl = {1.0f, 0.0f};
  if (legacy || refine) {
    const Cx l1 = dft_tone(s_wr[kSlotLltf], s_wi[kSlotLltf], tab, k);
    const Cx l2 = dft_tone(s_wr[kSlotLltf + 1], s_wi[kSlotLltf + 1], tab, k);
    const float c = 0.5f * l_inv;
    if (l_nz) hl = {(l1.re + l2.re) * c, (l1.im + l2.im) * c};
  }
  if (legacy) {
    hr[0] = hl.re;
    hi[0] = hl.im;
    if (pilot >= 0) {
      p_re[rr * 4 + pilot] = hl.re;
      p_im[rr * 4 + pilot] = hl.im;
    }
    return;
  }

  // the P-matrix estimate of each stream (nl_chanest)
  // (fixed trip counts keep g and hs in registers)
  Cx g[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (j < nltf)
      g[j] = dft_tone(s_wr[kSlotNl + j], s_wi[kSlotNl + j], tab, k);
  const float c_nl = nl_inv / static_cast<float>(nltf);
  Cx hs[2] = {{1.0f, 0.0f}, {1.0f, 0.0f}};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s >= nss) break;
    const float p0 = tab[kPLtf + 4 * s];
    Cx comb = {g[0].re * p0, g[0].im * p0};
    if (nltf > 1) {
      const float p1 = tab[kPLtf + 4 * s + 1];
      comb = {comb.re + g[1].re * p1, comb.im + g[1].im * p1};
    }
    if (nl_nz) hs[s] = {comb.re * c_nl, comb.im * c_nl};
  }

  if (!refine) {
    hr[0] = hs[0].re;
    hi[0] = hs[0].im;
    if (nss > 1) {
      hr[kTones] = hs[1].re;
      hi[kTones] = hs[1].im;
    }
    if (pilot >= 0) {
      Cx ph;
      if (fmt == kFmtVht) {         // the R-combined LTFs
        const float r0 = tab[kRLtf];
        ph = {g[0].re * r0, g[0].im * r0};
        if (nltf > 1) {
          const float r1 = tab[kRLtf + 1];
          ph = {ph.re + g[1].re * r1, ph.im + g[1].im * r1};
        }
        const float c =
            __fdiv_rn(1.0f, tab[kPilotRef + pilot] * static_cast<float>(nltf));
        ph = {ph.re * c, ph.im * c};
      } else {                      // HT: summed over the streams
        ph = hs[0];
        if (nss > 1) ph = {ph.re + hs[1].re, ph.im + hs[1].im};
      }
      p_re[rr * 4 + pilot] = ph.re;
      p_im[rr * 4 + pilot] = ph.im;
    }
    return;
  }

  // the SISO refinement (refine_chanest_siso), one stream
  const Cx hn = hs[0];
  const float nzl = l_nz ? 1.0f : 0.0f, nznl = nl_nz ? 1.0f : 0.0f;
  hl = {hl.re * gain, hl.im * gain};
  float g_l;
  const Cx hlr = gated_obs(hl, hn, nzl, coh_min, s_red, g_l);
  const float w_l = 2.0f * nzl * g_l;
  float num_re = w_l * hlr.re + hn.re;
  float num_im = w_l * hlr.im + hn.im;
  float den = w_l + 1.0f;
  Cx run = {__fdiv_rn(num_re, den), __fdiv_rn(num_im, den)};
  const float dmask = tab[kDataL + k];
  for (int i = 0; i < 3; ++i) {
    // VHT: BPSK, BPSK, QBPSK; HT: BPSK, QBPSK, QBPSK
    const bool qb = fmt == kFmtVht ? i == 2 : i >= 1;
    const Cx gs = dft_tone(s_wr[kSlotSig + i], s_wi[kSlotSig + i], tab, k);
    const Cx eq = mul_conj(gs, run);
    Cx obs;
    float m;
    if (qb) {                       // ideal = j*s, s = +-1
      const float s = sign0(eq.im);
      obs = {gs.im * s, -gs.re * s};
      m = dmask;
    } else {                        // ideal = s (pilots too)
      const float s = sign0(eq.re);
      obs = {gs.re * s, gs.im * s};
      m = nzl;
    }
    float g_i;
    const Cx o = gated_obs(obs, run, m, coh_min, s_red, g_i);
    const float w_i = m * (g_l * g_i);
    num_re = num_re + w_i * o.re;
    num_im = num_im + w_i * o.im;
    den = den + w_i;
  }
  if (sigb) {                       // VHT-SIG-B: the HT/VHT layout
    run = {__fdiv_rn(num_re, den), __fdiv_rn(num_im, den)};
    const Cx gs = dft_tone(s_wr[kSlotSigb], s_wi[kSlotSigb], tab, k);
    const float s = sign0(mul_conj(gs, run).re);
    float g_i;
    const Cx o = gated_obs({gs.re * s, gs.im * s}, run, nznl, coh_min, s_red,
                           g_i);
    const float w_i = nznl * g_i;
    num_re = num_re + w_i * o.re;
    num_im = num_im + w_i * o.im;
    den = den + w_i;
  }
  Cx hc = {__fdiv_rn(num_re, den), __fdiv_rn(num_im, den)};

  // the delay-subspace projection of the 56 active tones
  const int act = static_cast<int>(tab[kActPos + k]);
  if (act >= 0) {
    s_ar[act] = hc.re;
    s_ai[act] = hc.im;
  }
  __syncthreads();
  if (act >= 0) {
    const float* pr = tab + kProjRe + act * kActive;
    const float* pi = tab + kProjIm + act * kActive;
    float rr1 = 0.0f, rr2 = 0.0f, ri1 = 0.0f, ri2 = 0.0f;
    for (int j = 0; j < kActive; ++j) {
      const float ar = s_ar[j], ai = s_ai[j];
      const float cr = __ldg(pr + j), ci = __ldg(pi + j);
      rr1 = __fmaf_rn(ar, cr, rr1);
      rr2 = __fmaf_rn(ai, ci, rr2);
      ri1 = __fmaf_rn(ar, ci, ri1);
      ri2 = __fmaf_rn(ai, cr, ri2);
    }
    hc = {rr1 - rr2, ri1 + ri2};
  }
  hr[0] = hc.re;
  hi[0] = hc.im;
  if (pilot >= 0) {
    p_re[rr * 4 + pilot] = hc.re;
    p_im[rr * 4 + pilot] = hc.im;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments outside what the kernel takes.
// xr, xi: (batch, nrx, n) float32 windows; tab: the kTableSize floats of
// ops/ofdm._chanest_table; h_re, h_im: (batch, nrx, nss, 64); p_re, p_im:
// (batch, nrx, 4); fmt: 0 L, 1 HT, 2 VHT; nltf, nss in {1, 2} (L: nss 1);
// refine: the SISO refinement (HT/VHT, nss 1); sigb_start: the VHT-SIG-B
// symbol's GI, or -1.
int gr80211_payload_chanest(const void* xr, const void* xi, const void* tab,
                            void* h_re, void* h_im, void* p_re, void* p_im,
                            int n, int batch, int nrx, int fmt, int nltf,
                            int nss, int refine, int sigb_start, float gain,
                            float coh_min, void* stream) {
  if (batch <= 0 || nrx <= 0) return 0;
  const bool legacy = fmt == kFmtL;
  if (fmt < 0 || fmt > kFmtVht || nrx > 65535 || nss < 1 || nss > 2 ||
      (legacy && (nss != 1 || refine)) ||
      (!legacy && (nltf < 1 || nltf > 2 || nss > nltf)) ||
      (refine && nss != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int need = legacy ? 128 : kNlLtf + 80 * nltf;
  if (refine && sigb_start >= 0 && sigb_start + 80 > need)
    need = sigb_start + 80;
  if (n < need) return static_cast<int>(cudaErrorInvalidValue);
  payload_chanest_kernel<<<dim3(batch, nrx), kTones, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(tab), static_cast<float*>(h_re),
      static_cast<float*>(h_im), static_cast<float*>(p_re),
      static_cast<float*>(p_im), n, fmt, nltf, nss, refine, sigb_start, gain,
      coh_min);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
