// A CPU emulation of the CUDA calls karpenter_tpu_torch/csrc/lp_ascend.cu
// makes, so that its device code compiles as C++20 and runs without a
// card (tests/test_torch_ascent_emu.py): a std::thread a CUDA thread, a
// std::barrier a block for __syncthreads, a std::barrier and a buffer a
// warp for __syncwarp, shuffles and ballots (every lane of a warp must
// take part, as on the card), std::atomic_ref for the atomics, and the
// float intrinsics as IEEE single-precision operations (build with
// -ffp-contract=off). The threads of a block run its code in any
// interleaving between barriers, so a missing barrier can show here too.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>
#include <array>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(a, b)
#define __align__(n)
#define __restrict__
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
inline thread_local std::barrier<>* g_block_bar;
inline thread_local std::barrier<>** g_warp_bar;
inline thread_local uint64_t (*g_xbuf)[32];
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
template <class T> inline uint64_t to_bits(T v) { uint64_t b = 0; std::memcpy(&b, &v, sizeof(T)); return b; }
template <class T> inline T from_bits(uint64_t b) { T v; std::memcpy(&v, &b, sizeof(T)); return v; }
template <class T> inline T shfl_src(T v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_xbuf[w][l] = to_bits(v);
  __syncwarp();
  T out = from_bits<T>(g_xbuf[w][src & 31]);
  __syncwarp();
  return out;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return shfl_src(v, src); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) { return shfl_src(v, (threadIdx.x % 32) ^ m); }
template <class T> inline T __shfl_down_sync(unsigned, T v, int d) {
  int l = threadIdx.x % 32; return shfl_src(v, l + d < 32 ? l + d : l);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_xbuf[w][l] = pred ? 1 : 0;
  __syncwarp();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (g_xbuf[w][i] ? 1u : 0u) << i;
  __syncwarp();
  return b;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_add(v); }
inline unsigned atomicOr(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_or(v); }
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p); unsigned o = a.load();
  while (o < v && !a.compare_exchange_weak(o, v)) {}
  return o;
}
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
using std::isfinite; using std::isnan; using std::min; using std::max;
typedef int cudaStream_t; typedef int cudaError_t;
enum { cudaErrorInvalidValue = 1, cudaSuccess = 0 };
