// Device code shared by the packing kernels B1 (pack_split.cu), B3
// (pack_wavefront.cu) and B7 (pack_dense.cu): the capacity of a row for
// a group, the order-preserving (value, index) keys of the
// arg-reductions, the block-wide scan of the prefix fill, the
// reservation and conflict lookups on a kernel's argument struct (the
// kernels name the fields alike), and the two phases of a group step
// that B1 and B7 run alike, the prefix fill (`prefix_fill`) and the
// bulk open (`bulk_open`). The kernels run blocks of kThreads threads;
// block_scan needs exactly 32 warps.
//
// Float arithmetic uses explicit round-to-nearest intrinsics in the
// JAX order of operations, so nothing depends on FMA contraction (the
// build also passes -fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "shard_xchg.cuh"

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


// The prefix fill of one group with demand r > 0 over rows [0, nscan)
// in index order: take[n] = clip(r - sum_{m<n} kcap[m], 0, kcap[n]),
// exact in 64 bits and clamped at r (equal to the JAX kernels'
// saturating uint32 scan). The block scans chunk by chunk and stops at
// the chunk where the demand is met. Returns the end of the rows whose
// take was written (later rows take 0) and, in *placed, the pods the
// fill placed. All threads of the block call it.
__device__ int prefix_fill(const int32_t* kcap, int32_t* take, int nscan,
                           long long r, long long* placed) {
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_total;
  __shared__ long long s_carry;
  __shared__ int s_scan_end;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_carry = 0;
    s_scan_end = nscan;
  }
  __syncthreads();
  for (int base = 0; base < nscan; base += kThreads) {
    const int n = base + tid;
    long long kc = 0;
    if (n < nscan) kc = min((long long)kcap[n], r);
    long long incl = block_scan(kc, s_warp, &s_total);
    long long prefix = s_carry + incl - kc;
    if (prefix > r) prefix = r;
    if (n < nscan) take[n] = (int)min(r - prefix, kc);
    __syncthreads();
    if (tid == 0) {
      s_carry += s_total;
      if (s_carry >= r) s_scan_end = min(base + kThreads, nscan);
    }
    __syncthreads();
    if (s_carry >= r) break;
  }
  const int end = s_scan_end;
  *placed = min(s_carry, r);
  __syncthreads();  // the statics are rewritten by the next call
  return end;
}

// (kopen, reservation slot) of a column, packed as the payload of its
// pick key (a split kernel reads c*'s values through the exchange)
__device__ __forceinline__ unsigned long long open_payload(int kopen, int slot) {
  return ((unsigned long long)(uint32_t)kopen << 32) | (uint32_t)slot;
}

// One group's bulk open (the JAX kernels' open_cond / open_round loop):
// while pods remain, a row is free and some config of the group fits a
// fresh node of its pool under its reservation budget, take the lowest
// pool among those configs, then the column c* (cost: least price per
// pod; ffd: a reserved column cheaper than every uncapped one by
// capacity, else the most capacity), and open q rows at once, q - 1
// with m* pods and the last with the rest. Row n of the node axis keeps
// its mask at mask[(n - row0) * C] and its usage at used[(n - row0) *
// R] (B1: the fresh block after row0 = B bound rows; B7: the whole
// axis, row0 = 0) and its assignment at a.assign[n * G]; `active`, when
// not null, marks the opened rows. *remaining and *node_count are the
// caller's shared state. All threads of the block call it. Split (X):
// the lowest pool, the uncapped minimum price and the pick keys are
// exchanged with the other shards, and c*'s open capacity and slot come
// with its key; the opened rows' usage and assignment are this shard's
// replica, their masks its columns.
template <class A, class X>
__device__ void bulk_open(const A& a, X& x, int g, const uint8_t* row, const float* req,
                          int N, int row0, uint8_t* mask, float* used,
                          uint8_t* active, int* remaining, int* node_count) {
  __shared__ float s_oh[kMaxR];
  __shared__ int s_go, s_pool, s_any;
  __shared__ unsigned long long s_key0, s_key1, s_key2;
  __shared__ uint32_t s_minu;
  __shared__ int s_cstar, s_mstar, s_q, s_remlast, s_slot, s_lo, s_capped;
  __shared__ unsigned long long s_pay0, s_pay1, s_pay2;
  const int tid = threadIdx.x;
  const int C = a.C, R = a.R, G = a.G;
  const int gcap = a.group_cap ? a.group_cap[g] : kIntBig;

  // configs a fresh node of their pool holds one pod of the group on,
  // after the pool's overhead (pseudo-configs, pool -1, never)
  for (int c = tid; c < C; c += kThreads) {
    int p = a.cfg_pool[c];
    uint8_t ok = row[c] && p >= 0;
    if (ok) {
      const float* oh = a.pool_overhead + (size_t)p * R;
      const float* al = a.cfg_alloc + (size_t)c * R;
      for (int q = 0; q < R; ++q)
        if (!(oh[q] <= __fsub_rn(al[q], req[q]))) { ok = 0; break; }
    }
    a.fits[c] = ok;
  }
  __syncthreads();
  while (true) {
    if (tid == 0) {
      s_any = 0;
      s_pool = kIntBig;
    }
    __syncthreads();
    // which configs can still open, and the lowest pool among them
    int my_pool = kIntBig;
    int my_any = 0;
    for (int c = tid; c < C; c += kThreads) {
      if (!a.fits[c]) continue;
      int s = slot_of(a, c);
      if (a.rsv_used[s] < cap_ext(a, s)) {
        my_any = 1;
        my_pool = min(my_pool, a.cfg_pool[c]);
      }
    }
    if (my_any) {
      atomicOr(&s_any, 1);
      atomicMin(&s_pool, my_pool);
    }
    __syncthreads();
    if constexpr (X::kSplit) {
      // pools are >= 0: a pool below kIntBig means some shard can open
      const int pool = shard_min_int(x, s_any ? s_pool : kIntBig);
      if (tid == 0) {
        s_pool = pool;
        s_any = pool < kIntBig;
      }
      __syncthreads();
    }
    if (tid == 0) s_go = (*remaining > 0 && *node_count < N && s_any) ? 1 : 0;
    __syncthreads();
    if (!s_go) break;
    const int pool = s_pool;
    if (tid < R) s_oh[tid] = a.pool_overhead[(size_t)pool * R + tid];
    if (tid == 0) {
      s_key0 = ~0ull;
      s_key1 = ~0ull;
      s_key2 = ~0ull;
      s_minu = float_key(kBig);
    }
    __syncthreads();
    // open capacity per config in the chosen pool; cost mode reduces
    // argmin price-per-pod, ffd mode the cheapest uncapped price first
    unsigned long long k0 = ~0ull;
    uint32_t mu = float_key(kBig);
    for (int c = tid; c < C; c += kThreads) {
      int kf = 0;
      if (a.fits[c] && a.cfg_pool[c] == pool) {
        int s = slot_of(a, c);
        if (a.rsv_used[s] < cap_ext(a, s))
          kf = capacity(a.cfg_alloc + (size_t)c * R, s_oh, req, R);
      }
      a.kopen[c] = kf;
      if (a.cost) {
        float ppp = kf >= 1 ? __fdiv_rn(a.cfg_price[c], (float)max(kf, 1)) : kBig;
        unsigned long long key = pack_key(float_key(ppp), x.c0 + c);
        if (key < k0) k0 = key;
      } else if (kf >= 1 && a.cfg_rsv[c] < 0) {
        uint32_t pk = float_key(a.cfg_price[c]);
        if (pk < mu) mu = pk;
      }
    }
    if (a.cost) {
      if (k0 != ~0ull) atomicMin(&s_key0, k0);
    } else {
      atomicMin(&s_minu, mu);
    }
    __syncthreads();
    if constexpr (X::kSplit) {
      if (a.cost) {
        unsigned long long k[1] = {s_key0}, p[1] = {0};
        if (tid == 0 && k[0] != ~0ull) {
          const int c = (int)(k[0] & 0xffffffffull) - x.c0;
          p[0] = open_payload(a.kopen[c], slot_of(a, c));
        }
        shard_min_keys(x, k, p);
        if (tid == 0) {
          s_key0 = k[0];
          s_pay0 = p[0];
        }
      } else {
        const uint32_t m = shard_min_u32(x, s_minu);
        if (tid == 0) s_minu = m;
      }
      __syncthreads();
    }
    if (!a.cost) {
      // reserved columns cheaper than every uncapped one win by
      // capacity; else the column with the most capacity
      unsigned long long k1 = ~0ull, k2 = ~0ull;
      const float min_uncapped = key_float(s_minu);
      for (int c = tid; c < C; c += kThreads) {
        int kf = a.kopen[c];
        unsigned long long key2 = pack_key((uint32_t)(kIntBig - kf), x.c0 + c);
        if (key2 < k2) k2 = key2;
        if (kf >= 1 && a.cfg_rsv[c] >= 0 && a.cfg_price[c] < min_uncapped) {
          unsigned long long key1 = pack_key((uint32_t)(kIntBig - kf), x.c0 + c);
          if (key1 < k1) k1 = key1;
        }
      }
      if (k1 != ~0ull) atomicMin(&s_key1, k1);
      atomicMin(&s_key2, k2);
      __syncthreads();
      if constexpr (X::kSplit) {
        unsigned long long k[2] = {s_key1, s_key2}, p[2] = {0, 0};
        if (tid == 0) {
          for (int i = 0; i < 2; ++i) {
            if (k[i] == ~0ull) continue;
            const int c = (int)(k[i] & 0xffffffffull) - x.c0;
            p[i] = open_payload(a.kopen[c], slot_of(a, c));
          }
        }
        shard_min_keys(x, k, p);
        if (tid == 0) {
          s_key1 = k[0];
          s_key2 = k[1];
          s_pay1 = p[0];
          s_pay2 = p[1];
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      int cs;
      if (a.cost) cs = (int)(s_key0 & 0xffffffffull);
      else cs = (int)(((s_key1 != ~0ull) ? s_key1 : s_key2) & 0xffffffffull);
      int rem = *remaining;
      int nc = *node_count;
      // split: c*'s capacity and slot came with its key
      unsigned long long pay = 0;
      if constexpr (X::kSplit) pay = a.cost ? s_pay0 : (s_key1 != ~0ull ? s_pay1 : s_pay2);
      int ms;
      if constexpr (X::kSplit) ms = max((int)(pay >> 32), 1);
      else ms = max(a.kopen[cs], 1);
      if (a.group_cap) ms = min(max(gcap, 1), ms);
      int slot;
      if constexpr (X::kSplit) slot = (int)(pay & 0xffffffffull);
      else slot = slot_of(a, cs);
      float cap_left = fminf(__fsub_rn(cap_ext(a, slot), a.rsv_used[slot]), kCapMax);
      int q = min((rem - 1) / ms + 1, N - nc);
      q = min(q, (int)fmaxf(cap_left, 0.0f));
      q = max(q, 1);
      int rl = min(max(rem - (q - 1) * ms, 1), ms);
      s_cstar = cs;
      s_mstar = ms;
      s_q = q;
      s_remlast = rl;
      s_slot = slot;
      s_lo = nc - row0;
      if constexpr (X::kSplit) s_capped = slot < a.K;
      else s_capped = a.cfg_rsv[cs] >= 0;
    }
    __syncthreads();
    // write the q new rows: full ones, then the partial last one
    {
      const int lo = s_lo, q = s_q, ms = s_mstar, rl = s_remlast, cs = s_cstar;
      const int capped_star = s_capped;
      for (int i = tid; i < q * C; i += kThreads) {
        int f = lo + i / C;
        int c = i % C;
        int thr = (f == lo + q - 1) ? rl : ms;
        int kf = a.kopen[c];
        uint8_t m = (a.cfg_rsv[c] < 0 && kf >= 1 && kf >= thr) ? 1 : 0;
        if (capped_star && x.c0 + c == cs) m = 1;
        mask[(size_t)f * C + c] = m;
      }
      for (int i = tid; i < q; i += kThreads) {
        int f = lo + i;
        int fill = (i == q - 1) ? rl : ms;
        float ff = (float)fill;
        for (int x = 0; x < R; ++x)
          used[(size_t)f * R + x] = __fadd_rn(s_oh[x], __fmul_rn(ff, req[x]));
        a.assign[(size_t)(row0 + f) * G + g] += fill;
        if (active) active[row0 + f] = 1;
      }
    }
    __syncthreads();
    if (tid == 0) {
      *node_count += s_q;
      *remaining -= (s_q - 1) * s_mstar + s_remlast;
      a.rsv_used[s_slot] = __fadd_rn(a.rsv_used[s_slot], (float)s_q);
    }
    __syncthreads();
  }
}

}  // namespace
