// A CPU emulation of the CUDA calls karpenter_tpu_torch/csrc/lp_ascend.cu,
// pack_common.cuh, pack_split.cu and shard_xchg.cuh make, so that their
// device code compiles as C++20 and runs without a card
// (tests/test_torch_ascent_emu.py, tests/test_torch_xchg_emu.py): a
// std::thread a CUDA thread, a
// barrier a block for __syncthreads, a barrier and a buffer a warp for
// __syncwarp (EmuBarrier: it sleeps on a futex and never spins, since
// the emulation runs hundreds of threads on a few cores), shuffles and ballots (every lane of a warp must
// take part, as on the card), std::atomic_ref for the atomics, and the
// float intrinsics as IEEE single-precision operations (build with
// -ffp-contract=off). The threads of a block run its code in any
// interleaving between barriers, so a missing barrier can show here too.
#pragma once
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>
#include <array>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __align__(n)
#define __restrict__
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
struct EmuBarrier {
  explicit EmuBarrier(int n) : n(n) {}
  void arrive_and_wait() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      count.store(0, std::memory_order_relaxed);
      gen.store(g + 1, std::memory_order_release);
      syscall(SYS_futex, reinterpret_cast<int*>(&gen), FUTEX_WAKE_PRIVATE, INT_MAX, nullptr,
              nullptr, 0);
    } else {
      while (gen.load(std::memory_order_acquire) == g)
        syscall(SYS_futex, reinterpret_cast<int*>(&gen), FUTEX_WAIT_PRIVATE, g, nullptr,
                nullptr, 0);
    }
  }
  std::atomic<int> count{0}, gen{0};
  int n;
};
inline thread_local EmuBarrier* g_block_bar;
inline thread_local EmuBarrier** g_warp_bar;
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
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
using std::isfinite; using std::isnan; using std::min; using std::max;
// the packing kernels' calls (pack_common.cuh)
template <class T> inline T warp_fold(T v, T (*f)(T, T)) {
  const int w = threadIdx.x / 32;
  g_xbuf[w][threadIdx.x % 32] = to_bits(v);
  __syncwarp();
  T acc = from_bits<T>(g_xbuf[w][0]);
  for (int i = 1; i < 32; ++i) acc = f(acc, from_bits<T>(g_xbuf[w][i]));
  __syncwarp();
  return acc;
}
inline int __reduce_min_sync(unsigned, int v) { return warp_fold<int>(v, [](int a, int b) { return b < a ? b : a; }); }
inline unsigned __reduce_min_sync(unsigned, unsigned v) { return warp_fold<unsigned>(v, [](unsigned a, unsigned b) { return b < a ? b : a; }); }
inline int __reduce_max_sync(unsigned, int v) { return warp_fold<int>(v, [](int a, int b) { return b > a ? b : a; }); }
inline unsigned __reduce_max_sync(unsigned, unsigned v) { return warp_fold<unsigned>(v, [](unsigned a, unsigned b) { return b > a ? b : a; }); }
inline unsigned __reduce_add_sync(unsigned, unsigned v) { return warp_fold<unsigned>(v, [](unsigned a, unsigned b) { return a + b; }); }
template <class T> inline T __shfl_up_sync(unsigned, T v, int d) {
  int l = threadIdx.x % 32; return shfl_src(v, l >= d ? l - d : l);
}
inline thread_local int* g_block_or;
inline int __syncthreads_or(int pred) {
  if (pred) std::atomic_ref<int>(*g_block_or).fetch_or(1);
  __syncthreads();
  const int out = std::atomic_ref<int>(*g_block_or).load();
  __syncthreads();
  if (threadIdx.x == 0) std::atomic_ref<int>(*g_block_or).store(0);
  __syncthreads();
  return out;
}
inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> a(*p); int o = a.load();
  while (v < o && !a.compare_exchange_weak(o, v)) {}
  return o;
}
inline unsigned atomicMin(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p); unsigned o = a.load();
  while (v < o && !a.compare_exchange_weak(o, v)) {}
  return o;
}
inline unsigned long long atomicMin(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long> a(*p); unsigned long long o = a.load();
  while (v < o && !a.compare_exchange_weak(o, v)) {}
  return o;
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p); int o = a.load();
  while (o < v && !a.compare_exchange_weak(o, v)) {}
  return o;
}
inline int atomicOr(int* p, int v) { return std::atomic_ref<int>(*p).fetch_or(v); }
inline float atomicAdd(float* p, float v) {
  std::atomic_ref<float> a(*p); float o = a.load();
  while (!a.compare_exchange_weak(o, o + v)) {}
  return o;
}
inline unsigned __fns(unsigned mask, unsigned base, int offset) {
  int n = 0;
  for (unsigned b = base; b < 32; ++b)
    if ((mask >> b) & 1u) { if (++n == offset) return b; }
  return 0xffffffffu;
}
inline float __fdividef(float a, float b) { return a / b; }
inline long long clock64() { return 0; }
[[noreturn]] inline void __trap() { abort(); }
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return uint4{x, y, z, w}; }
template <class T> inline T __ldcg(const T* p) { return *p; }
typedef int cudaStream_t; typedef int cudaError_t;
enum { cudaErrorInvalidValue = 1, cudaSuccess = 0 };
