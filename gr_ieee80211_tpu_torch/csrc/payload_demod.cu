// K8 payload_demod: the payload demodulation of one receive bucket in one
// launch, hand-written for Hopper (sm_90a): the 64-point DFT of every data
// symbol and antenna, the pilot phase, the equalizer (SISO division, MRC or
// the two-stream ZF), the piecewise-linear LLR demap and the deinterleave /
// deparse into coded order.  Plain C interface, loaded with ctypes
// (ops/cuda_lib.py) and wrapped in gr_ieee80211_tpu_torch/ops/ofdm.py
// (``payload_demod``), which also holds its plain PyTorch twin
// (``payload_demod_ref``).
//
// K8 replaces no Pallas kernel: the JAX package computes this stage with
// jnp operations that XLA fuses into a few programs.  The port ran it as
// eager torch operations, ~40-60 launches of a few rows each (float64 DFT
// matmuls and casts, gathers, the pilot sum, the division or ZF solve, the
// demap ladder, a cat and a permutation gather) plus one upload of the
// pilot matrix a call.  The card idled while the host issued them; here
// the whole stage is one launch and reads its constants from one table
// the wrapper builds once per device.
//
// What it computes, for row b and data symbol m (xs: the derotated window,
// t = 0 at the first L-LTF repeat; symbol m's FFT window starts at
// data_start + 16 + 80 m):
//   * the fftshifted grid of every antenna's window (ops/cplx.dft64);
//   * the pilot phase: the unit phasor of sum over antennas r and the 4
//     pilots j of rx[r][j] * conj(exp[r][j]), exp the pilot channel
//     pilot_h[r][j] times symbol m's polarity (HT with two streams: the sum
//     over the streams of h[r][s] at the pilot times stream s's polarity);
//   * the equalized data tones of the phase-corrected grids: one antenna
//     and one stream, y / h (ops/cplx.CF.__truediv__); two antennas and one
//     stream, MRC through the real Gram diagonal; two streams, ZF through
//     the normal equations (ops/ofdm.zf_equalize);
//   * the LLRs of ops/ofdm.llr_demap, BPSK to 256-QAM, each written
//     straight to its coded position: the deinterleave / deparse
//     permutation repeats every symbol, so one per-symbol table of coded
//     positions serves every symbol count.
//
// Arithmetic, that of the twin in float32 and in its order:
//   * a DFT applies the twin's float32 matrices in float64, summing n =
//     0..63 in order, and rounds to float32 once, as ops/cplx._cmatmul
//     does (and K7); products of two floats are exact in a double, so the
//     fused multiply-adds leave the same partial sums as a multiply and an
//     add;
//   * every elementwise step keeps the twin's order of operations; the
//     build passes --fmad=false, so nothing is contracted; divisions and
//     square roots are IEEE-rounded (_rn intrinsics, no fast math);
//   * the pilot sum, whose order the twin leaves to PyTorch's reduction
//     (a sum over the antenna and pilot axes), takes the order PyTorch's
//     CUDA reduction took on the H100 at every bucket shape measured
//     (2.11, batch 1-4096, 1-40 symbols, one and two antennas): for each
//     pilot the antennas' terms, then (p0 + p2) + (p1 + p3).  The CPU's
//     reduction takes another order (each antenna's pilots in turn), so
//     there the phasor may differ from the twin's in its last bit.  The
//     sums over the two antennas and the two streams of the equalizer
//     have one addition each, so no order is left open there.
//
// Bound.  A row reads nrx windows of 64 complex samples a symbol and
// writes ncbps LLRs; the work is the DFTs, 64 x 64 complex products a
// window in float64 (16 K double multiply-adds); the equalizer and demap
// add ~100 float operations a tone.  At (B, nrx, nsym) = (4096, 1, 17)
// that is 1.1e9 double multiply-adds, 0.068 ms of the H100's 33.5e12
// float64 operations a second (a multiply-add counted as two; 0.081 ms
// with the equalizer's), against 36 MB read and 87 MB written, 0.037 ms
// at 3.35 TB/s: the float64 DFTs bound a large bucket; nothing bounds a
// bucket of the daemon (1-2 rows) but the launch.
//
// Design.  Persistent blocks of 256 threads (four groups of 64, thread k
// of a group owns tone k), at most two a multiprocessor, walk over the
// work items (row, tile of up to kTile symbols).  A block converts the DFT
// matrices to double in shared memory once (64 KB), so the inner loop
// reads them there and not from L1; for each item it stages the tile's
// windows as doubles in shared memory (one coalesced load each), and
// each group computes up to four windows at once at its tone (two matrix
// loads feed sixteen multiply-adds), writing the grids to shared memory.
// After one barrier every thread reads its symbol's pilots there, takes
// the pilot sum in the order above, and equalizes, demaps and
// scatters its tone.  The per-tone equalizer terms (the division's |h|^2,
// MRC's inverse Gram, ZF's Gram matrix and inverse determinant) depend on
// the row alone and are computed once an item.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTones = 64;
constexpr int kThreads = 256;         // four groups of 64 tones
constexpr int kGroups = kThreads / kTones;
constexpr int kTile = 16;             // symbols an item, at most
constexpr int kMaxRx = 2;
constexpr int kChunk = 4;             // windows a thread's DFT computes at once
constexpr int kFmtL = 0, kFmtHt = 1, kFmtVht = 2;  // spec.params.Fmt
constexpr int kPilotPeriod = 508;     // 4 rotations x 127 polarities

// Offsets (floats) into the constant table of ops/ofdm._demod_table; the
// pilot and permutation tables follow at offsets the wrapper passes.
constexpr int kDftC = 0;              // (64 n, 64 k) float32 DFT matrix, cos
constexpr int kDftS = 4096;           // ... and sin
constexpr int kDataPosL = 8192;       // a tone's index among the 48, or -1
constexpr int kDataPosNl = 8256;      // ... among the 52 HT/VHT data tones
constexpr int kPilotIdx = 8320;       // the 4 pilot tones
constexpr int kHeadSize = 8324;

// Dynamic shared memory: the matrices, the tile's windows, its grids.
constexpr int kSmemBytes = 2 * kTones * kTones * 8 +
                           kTile * kMaxRx * kTones * 16 +
                           kTile * kMaxRx * kTones * 8;

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
__device__ __forceinline__ Cx add(Cx a, Cx o) {
  return {a.re + o.re, a.im + o.im};
}
__device__ __forceinline__ Cx sub(Cx a, Cx o) {
  return {a.re - o.re, a.im - o.im};
}
__device__ __forceinline__ Cx scale(Cx a, float s) {
  return {a.re * s, a.im * s};
}
// conj(a) * o as the twin writes it: h.conj() * y.
__device__ __forceinline__ Cx conj_mul(Cx a, Cx o) {
  return mul({a.re, -a.im}, o);
}
__device__ __forceinline__ float abs2(Cx a) {
  return a.re * a.re + a.im * a.im;
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// Tone k of the fftshifted DFT of C staged windows w[0..C-1] (doubles, re
// and im interleaved), with the matrices in shared memory.
template <int C>
__device__ __forceinline__ void dft_tones(const double* s_c, const double* s_s,
                                          const double2* s_x, const int* w,
                                          int k, float2* s_g) {
  double a[C], b[C], c[C], d[C];
#pragma unroll
  for (int i = 0; i < C; ++i) a[i] = b[i] = c[i] = d[i] = 0.0;
#pragma unroll 4
  for (int n = 0; n < kTones; ++n) {
    const double cs = s_c[n * kTones + k], sn = s_s[n * kTones + k];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const double2 x = s_x[w[i] * kTones + n];
      a[i] = __fma_rn(x.x, cs, a[i]);
      b[i] = __fma_rn(x.y, sn, b[i]);
      c[i] = __fma_rn(x.x, sn, c[i]);
      d[i] = __fma_rn(x.y, cs, d[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i)
    s_g[w[i] * kTones + k] =
        make_float2(__double2float_rn(__dsub_rn(a[i], b[i])),
                    __double2float_rn(__dadd_rn(c[i], d[i])));
}

__global__ void __launch_bounds__(kThreads, 2)
payload_demod_kernel(const float* __restrict__ xr,   // (B, nrx, n)
                     const float* __restrict__ xi,
                     const float* __restrict__ h_re,  // (B, nrx, nss, 64)
                     const float* __restrict__ h_im,
                     const float* __restrict__ p_re,  // (B, nrx, 4)
                     const float* __restrict__ p_im,
                     const float* __restrict__ tab,
                     float* __restrict__ out,         // (B, nsym * ncbps)
                     int n, int batch, int nrx, int nss, int fmt, int nbpscs,
                     int nsym, int data_start, int pil_at, int perm_at,
                     float kmod, int tile_len, int ntiles) {
  extern __shared__ double smem[];
  double* s_c = smem;
  double* s_s = s_c + kTones * kTones;
  double2* s_x = reinterpret_cast<double2*>(s_s + kTones * kTones);
  float2* s_g = reinterpret_cast<float2*>(s_x + kTile * kMaxRx * kTones);

  const int t = threadIdx.x, k = t & (kTones - 1), grp = t / kTones;
  for (int i = t; i < kTones * kTones; i += kThreads) {
    s_c[i] = tab[kDftC + i];
    s_s[i] = tab[kDftS + i];
  }

  const bool legacy = fmt == kFmtL;
  const bool ht2 = fmt == kFmtHt && nss == 2;
  const int nsd = legacy ? 48 : 52;
  const int ncbpss = nsd * nbpscs, ncbps = ncbpss * nss;
  const int dpos = static_cast<int>(tab[(legacy ? kDataPosL : kDataPosNl) + k]);
  int pidx[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) pidx[j] = static_cast<int>(tab[kPilotIdx + j]);
  const float* pil = tab + pil_at;       // (508, 1 or 2 rows, 4)
  const float* perm = tab + perm_at;     // (nss, ncbpss) coded positions
  const int prow = ht2 ? 2 : 1;
  const int nitems = batch * ntiles;

  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int b = item / ntiles, m0 = (item % ntiles) * tile_len;
    const int ts = min(tile_len, nsym - m0), nw = ts * nrx;

    // stage the tile's windows (w = symbol * nrx + antenna)
    for (int i = t; i < nw * kTones; i += kThreads) {
      const int w = i / kTones, s = i % kTones;
      const size_t src = (static_cast<size_t>(b) * nrx + w % nrx) * n +
                         data_start + 16 + 80 * (m0 + w / nrx) + s;
      s_x[i] = make_double2(xr[src], xi[src]);
    }
    __syncthreads();

    // the DFTs: group grp takes windows grp, grp + 4, ..., four at once
    for (int w0 = grp; w0 < nw; w0 += kGroups * kChunk) {
      int w[kChunk];
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        w[i] = w0 + kGroups * i;
        if (w[i] < nw) cnt = i + 1;
      }
      switch (cnt) {
        case 4: dft_tones<4>(s_c, s_s, s_x, w, k, s_g); break;
        case 3: dft_tones<3>(s_c, s_s, s_x, w, k, s_g); break;
        case 2: dft_tones<2>(s_c, s_s, s_x, w, k, s_g); break;
        default: dft_tones<1>(s_c, s_s, s_x, w, k, s_g); break;
      }
    }
    __syncthreads();
    if (dpos < 0) continue;             // no data tone: nothing to write

    // this row's channel at the tone, and the equalizer's per-tone terms
    // (fixed trip counts keep hk, y and eq in registers)
    Cx hk[kMaxRx][2];
#pragma unroll
    for (int r = 0; r < kMaxRx; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        hk[r][s] = {0.0f, 0.0f};
        if (r < nrx && s < nss) {
          const size_t at =
              ((static_cast<size_t>(b) * nrx + r) * nss + s) * kTones + k;
          hk[r][s] = {h_re[at], h_im[at]};
        }
      }
    float d_siso = 0.0f, g00 = 0.0f, g11 = 0.0f, inv = 0.0f;
    Cx g01 = {0.0f, 0.0f};
    if (nss == 1 && nrx == 1) {         // CF.__truediv__'s guarded |h|^2
      const float d = abs2(hk[0][0]);
      d_siso = d > 1e-24f ? d : 1e-24f;
    } else {
      g00 = abs2(hk[0][0]);
      if (nrx > 1) g00 = g00 + abs2(hk[1][0]);
      if (nss == 1) {
        inv = __fdiv_rn(1.0f, clamp_min(g00, 1e-20f));
      } else {
        g11 = abs2(hk[0][1]);
        g01 = conj_mul(hk[0][0], hk[0][1]);
        if (nrx > 1) {
          g11 = g11 + abs2(hk[1][1]);
          g01 = add(g01, conj_mul(hk[1][0], hk[1][1]));
        }
        const float det = g00 * g11 - abs2(g01);
        inv = __fdiv_rn(1.0f, fabsf(det) > 1e-20f ? det : 1e-20f);
      }
    }
    const float* prow_h = h_re + static_cast<size_t>(b) * nrx * nss * kTones;
    const float* prow_hi = h_im + static_cast<size_t>(b) * nrx * nss * kTones;
    const float* prow_pr = p_re + static_cast<size_t>(b) * nrx * 4;
    const float* prow_pi = p_im + static_cast<size_t>(b) * nrx * 4;

    for (int s = grp; s < ts; s += kGroups) {
      const int m = m0 + s;
      const float* pol = pil + (m % kPilotPeriod) * prow * 4;
      // the pilot phase: each pilot's terms over the antennas, then the
      // pilots as (p0 + p2) + (p1 + p3)
      Cx pj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < kMaxRx; ++r) {
          if (r >= nrx) break;
          const float2 g = s_g[(s * nrx + r) * kTones + pidx[j]];
          Cx e;
          if (ht2) {                    // both streams' pilots, summed
            const int at = r * 2 * kTones + pidx[j];
            e = add(scale({prow_h[at], prow_hi[at]}, pol[j]),
                    scale({prow_h[at + kTones], prow_hi[at + kTones]},
                          pol[4 + j]));
          } else {
            e = scale({prow_pr[r * 4 + j], prow_pi[r * 4 + j]}, pol[j]);
          }
          const Cx term = mul_conj({g.x, g.y}, e);
          pj[j] = r == 0 ? term : add(pj[j], term);
        }
      }
      const Cx acc = add(add(pj[0], pj[2]), add(pj[1], pj[3]));
      const float a = clamp_min(__fsqrt_rn(abs2(acc)), 1e-12f);
      const Cx phc = {__fdiv_rn(acc.re, a), -__fdiv_rn(acc.im, a)};

      Cx y[kMaxRx];
#pragma unroll
      for (int r = 0; r < kMaxRx; ++r) {
        y[r] = {0.0f, 0.0f};
        if (r < nrx) {
          const float2 g = s_g[(s * nrx + r) * kTones + k];
          y[r] = mul({g.x, g.y}, phc);
        }
      }
      Cx eq[2];
      if (nss == 1 && nrx == 1) {
        const Cx h = hk[0][0];
        eq[0] = {__fdiv_rn(y[0].re * h.re + y[0].im * h.im, d_siso),
                 __fdiv_rn(y[0].im * h.re - y[0].re * h.im, d_siso)};
        eq[1] = eq[0];
      } else {
        Cx r0 = conj_mul(hk[0][0], y[0]);
        if (nrx > 1) r0 = add(r0, conj_mul(hk[1][0], y[1]));
        if (nss == 1) {
          eq[0] = scale(r0, inv);
          eq[1] = eq[0];
        } else {
          Cx r1 = conj_mul(hk[0][1], y[0]);
          if (nrx > 1) r1 = add(r1, conj_mul(hk[1][1], y[1]));
          const Cx e0 = sub(scale(r0, g11), mul(r1, g01));
          const Cx e1 = sub(scale(r1, g00), mul(r0, {g01.re, -g01.im}));
          eq[0] = scale(e0, inv);
          eq[1] = scale(e1, inv);
        }
      }

      // the demap ladder, each LLR to its coded position
      float* o = out + (static_cast<size_t>(b) * nsym + m) * ncbps;
      const int half = nbpscs / 2;
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        if (st >= nss) break;
        const float* pp = perm + st * ncbpss + dpos * nbpscs;
        float cr = eq[st].re * kmod, ci = eq[st].im * kmod;
        o[static_cast<int>(pp[0])] = cr;
        if (nbpscs == 1) continue;
        o[static_cast<int>(pp[half])] = ci;
        for (int q = 1; q < half; ++q) {
          const float lev = static_cast<float>(1 << (half - q));
          cr = lev - fabsf(cr);
          ci = lev - fabsf(ci);
          o[static_cast<int>(pp[q])] = cr;
          o[static_cast<int>(pp[half + q])] = ci;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments outside what the kernel takes.
// xr, xi: (batch, nrx, n) float32 windows; h_re, h_im: (batch, nrx, nss,
// 64); p_re, p_im: (batch, nrx, 4); tab: ops/ofdm._demod_table, with this
// config's pilot polarities at pil_at ((508, 1 or 2, 4): two rows for HT
// with two streams) and its coded positions at perm_at ((nss, ncbpss));
// out: (batch, nsym * ncbps) float32; fmt: 0 L, 1 HT, 2 VHT; nrx, nss in
// {1, 2} (L: nss 1); nbpscs in {1, 2, 4, 6, 8}; kmod: the constellation's
// float32 normalisation.
int gr80211_payload_demod(const void* xr, const void* xi, const void* h_re,
                          const void* h_im, const void* p_re, const void* p_im,
                          const void* tab, void* out, int n, int batch,
                          int nrx, int nss, int fmt, int nbpscs, int nsym,
                          int data_start, int pil_at, int perm_at, float kmod,
                          void* stream) {
  if (batch <= 0 || nsym <= 0) return 0;
  if (fmt < kFmtL || fmt > kFmtVht || nrx < 1 || nrx > kMaxRx || nss < 1 ||
      nss > 2 || (fmt == kFmtL && nss != 1) ||
      (nbpscs != 1 && nbpscs != 2 && nbpscs != 4 && nbpscs != 6 &&
       nbpscs != 8) ||
      data_start < 0 || pil_at < kHeadSize || perm_at < kHeadSize ||
      static_cast<long long>(n) < static_cast<long long>(data_start) + 80LL * nsym)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (nsym + kTile - 1) / kTile;
  const int tile_len = (nsym + ntiles - 1) / ntiles;
  const long long items = static_cast<long long>(batch) * ntiles;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(payload_demod_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = items < 2LL * sms ? items : 2LL * sms;
  payload_demod_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(h_re), static_cast<const float*>(h_im),
      static_cast<const float*>(p_re), static_cast<const float*>(p_im),
      static_cast<const float*>(tab), static_cast<float*>(out), n, batch, nrx,
      nss, fmt, nbpscs, nsym, data_start, pil_at, perm_at, kmod, tile_len,
      ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
