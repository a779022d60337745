// A CUDA kernel source on the CPU, for tests: one OS thread per CUDA
// thread, the blocks of a launch one after another, a barrier for
// __syncthreads and a pair of barriers around each warp shuffle.  Enough
// for kernels whose threads reach every barrier and shuffle together (a
// `return` taken by a whole block); the test (tests/_cuda_cpu.py)
// rewrites each
//     name<<<grid, block, smem, stream>>>(args);
// into emu_launch(grid, block, smem, stream, [&] { name(args); });
// and each `extern __shared__ T name[];` into a pointer to
// emu_dynamic_smem, and compiles with g++ -std=c++20 -ffp-contract=off,
// so float and double operations round as the card's _rn instructions do.
// The emulated card has kEmuSms multiprocessors, so a kernel that sizes
// its grid by them walks several work items a block.
#pragma once
#include <algorithm>
#include <barrier>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) double2 {
  double x, y;
};
inline double2 make_double2(double a, double b) { return {a, b}; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr int kEmuSms = 2;
inline int cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = kEmuSms;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
alignas(16) inline unsigned char emu_dynamic_smem[1 << 18];

template <class T>
inline T __ldg(const T* p) { return *p; }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __double2float_rn(double d) { return static_cast<float>(d); }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dadd_rn(double a, double b) { return a + b; }

inline std::barrier<>* g_bar;
inline float g_shfl[1024];

inline void __syncthreads() { g_bar->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int t = static_cast<int>(threadIdx.x);
  g_shfl[t] = v;
  g_bar->arrive_and_wait();
  const float r = g_shfl[(t & ~31) | ((t & 31) ^ o)];
  g_bar->arrive_and_wait();
  return r;
}

template <class F>
void emu_launch(dim3 grid, int block, int smem, cudaStream_t, F f) {
  assert(smem <= static_cast<int>(sizeof emu_dynamic_smem));
  gridDim = grid;
  blockDim = dim3(block);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(block);
      g_bar = &bar;
      std::vector<std::thread> ts;
      for (int t = 0; t < block; ++t)
        ts.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          f();
        });
      for (auto& th : ts) th.join();
    }
}
