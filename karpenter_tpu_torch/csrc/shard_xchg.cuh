// The exchange of the split kernels (B8): the config axis of a solve is
// split over S shards, one block (B3: one block a lane) per shard, and
// the blocks of one exchange group combine their partial reductions over
// configs through here. Used by pack_split.cu (split B1),
// pack_wavefront.cu (split B3) and lp_ascend.cu (split B5); the split B2
// (pack_flat.cu) reads the shards' masks and needs no exchange.
//
// Replaces the collectives GSPMD inserts into the JAX package's jitted
// kernels when their config axis is sharded (karpenter_tpu/solver/
// pack.py:1817-1893, lp_device.py:430-452): every reduction over
// configs is taken on each shard's columns, then combined across the
// shards — maxima, minima and ORs as they are, arg-reductions as packed
// (value, GLOBAL column) keys under the lowest-index rule, sums in shard
// order (`shard_sum_ordered`).
//
// One exchange: the block writes its partial to its slot, fences, and
// arrives on the group's counter; one thread spins on the counter until
// all S shards have arrived at this exchange, fences, and the block then
// reads the S slots (through L2: `__ldcg`, never a stale L1 line) and
// combines them in shard order. Every shard runs the same sequence of
// exchanges (their control flow reads only replicated state), so the
// n-th exchange of a block waits for count >= n * S. The slots are
// double-buffered by the exchange's parity: a shard can write parity p
// again only at exchange n + 2, after every shard arrived at n + 1, which
// each did only after reading exchange n's slots.
//
// The memory scope is a template parameter: device scope for the shards
// of one card (all this repository launches today); a launch over several
// cards needs system scope or peer memory (ROADMAP item 10).
//
// Requires co-residency of the group's blocks (they wait on each other):
// the launches are cooperative. A wait longer than kXchgTimeoutNs traps,
// so a broken exchange ends the launch with an error instead of
// spinning forever.

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// An unsplit kernel: one block holds every column, nothing to exchange.
struct NoSplit {
  static constexpr bool kSplit = false;
  // global column of the block's first column: a constant, so that the
  // unsplit kernels carry no split state
  static constexpr int c0 = 0;
};

template <cuda::thread_scope Scope>
struct Split {
  static constexpr bool kSplit = true;
  unsigned long long* slots;  // [2][S][words] this group's slots
  unsigned* arrive;           // this group's arrival counter, 0 at launch
  int s, S, words;            // this shard, the group's shards, slot width
  int c0;                     // global column of the block's first column
  unsigned gen;               // exchanges this block made so far
};
using DeviceSplit = Split<cuda::thread_scope_device>;

constexpr unsigned long long kXchgTimeoutNs = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <cuda::thread_scope Scope>
__device__ __forceinline__ void xfence() {
  if constexpr (Scope == cuda::thread_scope_system) __threadfence_system();
  else __threadfence();
}

template <class X>
__device__ __forceinline__ unsigned long long* xslot(const X& x, int par, int sh) {
  return x.slots + ((size_t)par * x.S + sh) * x.words;
}

// this block's slot for the next exchange
template <class X>
__device__ __forceinline__ unsigned long long* xmine(const X& x) {
  return xslot(x, x.gen & 1, x.s);
}

// shard sh's slot of the exchange just published
template <class X>
__device__ __forceinline__ const unsigned long long* xtheirs(const X& x, int sh) {
  return xslot(x, (x.gen - 1) & 1, sh);
}

// All threads: publish this block's slot and wait for every shard's.
template <cuda::thread_scope Scope>
__device__ void xpublish(Split<Scope>& x) {
  __syncthreads();
  if (threadIdx.x == 0) {
    xfence<Scope>();
    cuda::atomic_ref<unsigned, Scope> count(*x.arrive);
    count.fetch_add(1u, cuda::memory_order_relaxed);
    const unsigned target = (x.gen + 1u) * (unsigned)x.S;
    const unsigned long long t0 = global_ns();
    while (count.load(cuda::memory_order_relaxed) < target) {
      if (global_ns() - t0 > kXchgTimeoutNs) __trap();
    }
    xfence<Scope>();
  }
  __syncthreads();
  ++x.gen;
}

// ---- scalar exchanges: thread 0's value in, the combined value to all

template <class X, class Comb>
__device__ unsigned long long xscalar(X& x, unsigned long long v, Comb comb) {
  __shared__ unsigned long long s_out;
  if (threadIdx.x == 0) xmine(x)[0] = v;
  xpublish(x);
  if (threadIdx.x == 0) {
    unsigned long long acc = __ldcg(xtheirs(x, 0));
    for (int sh = 1; sh < x.S; ++sh) acc = comb(acc, __ldcg(xtheirs(x, sh)));
    s_out = acc;
  }
  __syncthreads();
  const unsigned long long out = s_out;
  __syncthreads();  // s_out is rewritten by the next exchange
  return out;
}

template <class X>
__device__ int shard_min_int(X& x, int v) {
  return (int)(long long)xscalar(x, (unsigned long long)(long long)v,
                                  [](unsigned long long a, unsigned long long b) {
                                    return (long long)b < (long long)a ? b : a;
                                  });
}

template <class X>
__device__ int shard_sum_int(X& x, int v) {
  return (int)(long long)xscalar(x, (unsigned long long)(long long)v,
                                  [](unsigned long long a, unsigned long long b) {
                                    return (unsigned long long)((long long)a + (long long)b);
                                  });
}

template <class X>
__device__ uint32_t shard_min_u32(X& x, uint32_t v) {
  return (uint32_t)xscalar(x, (unsigned long long)v,
                           [](unsigned long long a, unsigned long long b) { return b < a ? b : a; });
}

template <class X>
__device__ float shard_max_f32(X& x, float v) {
  return __uint_as_float((uint32_t)xscalar(
      x, (unsigned long long)__float_as_uint(v), [](unsigned long long a, unsigned long long b) {
        return (unsigned long long)__float_as_uint(
            fmaxf(__uint_as_float((uint32_t)a), __uint_as_float((uint32_t)b)));
      }));
}

// Partial sums combined in shard order: ((p0 + p1) + p2) + ...
template <class X>
__device__ float shard_sum_f32(X& x, float v) {
  return __uint_as_float((uint32_t)xscalar(
      x, (unsigned long long)__float_as_uint(v), [](unsigned long long a, unsigned long long b) {
        return (unsigned long long)__float_as_uint(
            __fadd_rn(__uint_as_float((uint32_t)a), __uint_as_float((uint32_t)b)));
      }));
}

// The smallest of n (key, payload) pairs, keys packed (value, GLOBAL
// column) as pack_key in pack_common.cuh: thread 0's keys[i] and
// payloads[i] in, the winners out in the same arrays (all threads).
template <class X, int n>
__device__ void shard_min_keys(X& x, unsigned long long (&keys)[n],
                               unsigned long long (&pay)[n]) {
  __shared__ unsigned long long s_k[n], s_p[n];
  if (threadIdx.x == 0) {
    unsigned long long* m = xmine(x);
    for (int i = 0; i < n; ++i) {
      m[2 * i] = keys[i];
      m[2 * i + 1] = pay[i];
    }
  }
  xpublish(x);
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      unsigned long long k = ~0ull, p = 0;
      for (int sh = 0; sh < x.S; ++sh) {
        const unsigned long long* t = xtheirs(x, sh);
        const unsigned long long kk = __ldcg(t + 2 * i);
        if (kk < k) {
          k = kk;
          p = __ldcg(t + 2 * i + 1);
        }
      }
      s_k[i] = k;
      s_p[i] = p;
    }
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    keys[i] = s_k[i];
    pay[i] = s_p[i];
  }
  __syncthreads();
}

// ---- vector exchanges: n elements (n <= x.words), `put(i)` this
// shard's partial of element i as a 64-bit word; `comb(i, get)` then
// combines element i, `get(sh)` reading shard sh's word. Strided over
// the block's threads on both sides.
template <class X, class Put, class Comb>
__device__ void shard_vec(X& x, int n, Put put, Comb comb) {
  __syncthreads();  // the partials may come from other threads' writes
  unsigned long long* m = xmine(x);
  for (int i = threadIdx.x; i < n; i += blockDim.x) m[i] = put(i);
  xpublish(x);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    comb(i, [&](int sh) { return __ldcg(xtheirs(x, sh) + i); });
  }
  __syncthreads();
}

// out[i] = ((p_0[i] + p_1[i]) + p_2[i]) + ..., the shards' partial sums
// in shard order (in place: `v` holds this shard's partials, then the
// totals)
template <class X>
__device__ void shard_sum_ordered(X& x, float* v, int n) {
  shard_vec(
      x, n, [&](int i) { return (unsigned long long)__float_as_uint(v[i]); },
      [&](int i, auto get) {
        float acc = __uint_as_float((uint32_t)get(0));
        for (int sh = 1; sh < x.S; ++sh) acc = __fadd_rn(acc, __uint_as_float((uint32_t)get(sh)));
        v[i] = acc;
      });
}

}  // namespace
