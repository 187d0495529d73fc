// Device code shared by the packing kernels B1 (pack_split.cu) and B3
// (pack_wavefront.cu): the capacity of a row for a group, the
// order-preserving (value, index) keys of the arg-reductions, the
// block-wide scan of the prefix fill, and the reservation and conflict
// lookups on a kernel's argument struct (both name the fields alike).
// Both kernels run blocks of kThreads threads; block_scan needs exactly
// 32 warps.
//
// Float arithmetic uses explicit round-to-nearest intrinsics in the
// JAX order of operations, so nothing depends on FMA contraction (the
// build also passes -fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 16;
constexpr float kBig = 3.4e38f;
constexpr float kCapMax = 2.0e9f;
constexpr int kIntBig = 2147483647;

// min_r floor((alloc - used + 1e-4) / req), unrequested resources
// never bind, clipped to [0, CAP_MAX], as int
__device__ __forceinline__ int capacity(const float* alloc, const float* used,
                                        const float* req, int R) {
  float k = kBig;
  for (int r = 0; r < R; ++r) {
    float rq = req[r];
    if (rq > 0.0f) {
      float head = __fadd_rn(__fsub_rn(alloc[r], used[r]), 1e-4f);
      float v = floorf(__fdiv_rn(head, rq));
      k = fminf(k, v);
    }
  }
  k = fminf(fmaxf(k, 0.0f), kCapMax);
  return (int)k;
}

// order-preserving map of a float onto uint32 (for min reductions);
// -0 and +0 map to one key, as they compare equal
__device__ __forceinline__ uint32_t float_key(float f) {
  if (f == 0.0f) f = 0.0f;
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long pack_key(uint32_t v, int idx) {
  return ((unsigned long long)v << 32) | (uint32_t)idx;
}

// block-wide inclusive scan of one int64 per thread; `warp_tot` is a
// shared array of kWarps entries. Returns the inclusive prefix and
// writes the block total to *total (shared).
__device__ long long block_scan(long long v, long long* warp_tot, long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_tot[lane] = w;  // inclusive over warps
    if (lane == 31) *total = w;
  }
  __syncthreads();
  long long off = warp > 0 ? warp_tot[warp - 1] : 0;
  long long out = x + off;
  __syncthreads();  // warp_tot is reused by the next call
  return out;
}

// reservation slot of config c (K: no reservation)
template <class A>
__device__ __forceinline__ int slot_of(const A& a, int c) {
  int s = a.cfg_rsv[c];
  return s >= 0 ? s : a.K;
}

template <class A>
__device__ __forceinline__ float cap_ext(const A& a, int s) {
  return s < a.K ? a.rsv_cap[s] : kBig;
}

// any(assign[n, h] > 0 for h with conflict[g, h])
template <class A>
__device__ __forceinline__ bool blocked(const A& a, int n, int g) {
  const uint8_t* crow = a.conflict + (size_t)g * a.G;
  const int32_t* arow = a.assign + (size_t)n * a.G;
  for (int h = 0; h < a.G; ++h)
    if (crow[h] && arow[h] > 0) return true;
  return false;
}

}  // namespace
