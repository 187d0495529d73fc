// Device code shared by the packing kernels B1 (pack_split.cu), B3
// (pack_wavefront.cu) and B7 (pack_dense.cu), and by their lane (B6)
// and split (B8) instantiations: the capacity of a row for a group, the
// order-preserving (value, index) keys of the arg-reductions, the
// block-wide scan, the reservation and conflict lookups on a kernel's
// argument struct (the kernels name the fields alike), and the phases of
// a group step:
//   - `stage_tables`: the config-axis tables copied once a launch into
//     the block's dynamic shared memory (cp.async), so that every step
//     and every open reads them there and not from L2;
//   - `sweep_take` (B1's step, B3's plan): each thread owns a run of
//     consecutive rows, sweeps their capacities (a fresh row's candidate
//     configs are its mask words ANDed with the group's compat bits,
//     capacity taken only for the set bits), then one block scan of the
//     threads' clamped sums gives every take in index order;
//   - `apply_take`: a take's usage and assignment, a fresh row's mask
//     narrowed word by word;
//   - `open_loop` (B1, B3 and B7 alike, rows written through a sink):
//     the bulk open, three or four block barriers an open, every block
//     reduction a warp reduction first;
//   - `prefix_fill`: B7's chunked scan over its byte-mask rows.
// A fresh row keeps its mask as words_pad(C) 32-bit words; the byte
// masks the outputs carry are written from them at the end of a launch.
// The kernels run blocks of kThreads threads; block_scan needs exactly
// 32 warps.
//
// Float arithmetic uses explicit round-to-nearest intrinsics in the
// JAX order of operations, so nothing depends on FMA contraction (the
// build also passes -fmad=false).

#pragma once

#include <cuda_pipeline.h>
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

// Phase clocks, in a build with -DKARPENTER_PHASE_CLOCKS only: block 0's
// thread 0 charges the clock64() cycles since its last mark to a phase
// slot of g_phase_clk, after a block barrier (so a phase ends when its
// slowest thread does); the last slot counts steps or rounds. spread()
// adds the largest and the sum over block 0's threads of a per-thread
// value (a phase's cycles from now(), candidate configs, rows) to two
// slots, its own time charged to no phase. Without the macro they
// compile to nothing. Every thread of the block calls begin() once,
// then mark() and spread() at the same points.
constexpr int kClockSlots = 32;
// slots of the spreads: the sweep's cycles, candidate configs and exact
// capacities, then the takes applied (cycles, rows), largest and sum
constexpr int kSpreadSlot = 16;
#ifdef KARPENTER_PHASE_CLOCKS
__device__ unsigned long long g_phase_clk[kClockSlots];
struct PhaseClock {
  long long t = 0;
  bool on = false;
  __device__ void begin() {
    on = blockIdx.x == 0 && threadIdx.x == 0;
    t = clock64();
  }
  __device__ void mark(int slot) {
    __syncthreads();
    if (on) {
      const long long t1 = clock64();
      g_phase_clk[slot] += (unsigned long long)(t1 - t);
      t = t1;
    }
  }
  __device__ void count() {
    if (on) g_phase_clk[kClockSlots - 1] += 1;
  }
  __device__ long long now() const { return clock64(); }
  __device__ void spread(int slot_max, int slot_sum, unsigned v) {
    __shared__ unsigned s_max, s_sum;
    if (threadIdx.x == 0) s_max = s_sum = 0u;
    __syncthreads();
    const unsigned m = __reduce_max_sync(0xffffffffu, v), sum = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(&s_max, m);
      atomicAdd(&s_sum, sum);
    }
    __syncthreads();
    if (on) {
      g_phase_clk[slot_max] += s_max;
      g_phase_clk[slot_sum] += s_sum;
    }
    __syncthreads();
    if (on) t = clock64();
  }
};
#else
struct PhaseClock {
  __device__ void begin() {}
  __device__ void mark(int) {}
  __device__ void count() {}
  __device__ long long now() const { return 0; }
  __device__ void spread(int, int, unsigned) {}
};
#endif

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

// ---------------------------------------------------------------- tables
//
// The config-axis tables of a packing block live in dynamic shared
// memory, copied there once a launch (cp.async): cfg_alloc [C, R],
// pool_overhead [P1, R], cfg_price, cfg_pool, cfg_rsv [C], rsv_cap [K],
// the reservation use rsv_used [K+1] and a group's spend [K+1], the
// open capacities kopen [C] and fit flags fits [C], the capped columns
// (cfg_rsv >= 0) as words_pad(C) words, and the groups' tables: demand
// [G], request [G, R] and compatibility rows as bits [G, words_pad(C)],
// so that a group step reads nothing of its group from global memory.
// Each segment starts on 16 bytes. The wrappers compute the same byte
// count (solver/pack_split.py `table_smem_bytes`), set it as the
// launch's dynamic shared memory and raise when it exceeds the card's
// 232,448 bytes a block.

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int words_of(int n) { return (n + 31) >> 5; }
// a row's config words, padded to a multiple of 4 for 16-byte loads
__host__ __device__ constexpr int words_pad(int C) { return (words_of(C) + 3) & ~3; }

struct TableLayout {
  int alloc, oh, price, pool, rsv, rsv_cap, rsv_used, spend, kopen, fits, capped, gcount, greq,
      gbits, end;
};

__host__ __device__ inline TableLayout table_layout(int C, int R, int P1, int K, int G) {
  TableLayout l;
  int o = 0;
  l.alloc = o; o += align16(4 * C * R);
  l.oh = o; o += align16(4 * P1 * R);
  l.price = o; o += align16(4 * C);
  l.pool = o; o += align16(4 * C);
  l.rsv = o; o += align16(4 * C);
  l.rsv_cap = o; o += align16(4 * K);
  l.rsv_used = o; o += align16(4 * (K + 1));
  l.spend = o; o += align16(4 * (K + 1));
  l.kopen = o; o += align16(4 * C);
  l.fits = o; o += align16(C);
  l.capped = o; o += 4 * words_pad(C);
  l.gcount = o; o += align16(4 * G);
  l.greq = o; o += align16(4 * G * R);
  l.gbits = o; o += 4 * G * words_pad(C);
  l.end = o;
  return l;
}

// Shared-memory views a packing block works on besides its Args.
struct Smem {
  float* spend;      // [K+1] the current group's reservation use
  uint32_t* capped;  // [words_pad(C)] cfg_rsv >= 0
  int32_t* gcount;   // [G] the groups' demand
  float* greq;       // [G, R] their requests
  uint32_t* gbits;   // [G, words_pad(C)] their compat rows as bits
};

template <class T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  for (int i = threadIdx.x; i < n; i += kThreads) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// All threads: copy a's tables into `smem` and point a's table fields
// (cfg_alloc, pool_overhead, cfg_price, cfg_pool, cfg_rsv, rsv_cap,
// rsv_used, kopen, fits) at the copies; rsv_used and spend start at 0.
// The compat rows become bits, a word a thread (32 independent byte
// loads in flight).
template <class A>
__device__ Smem stage_tables(A& a, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, R = a.R, K = a.K, G = a.G, nw = words_pad(C);
  const TableLayout l = table_layout(C, R, a.P1, K, G);
  float* alloc = (float*)(smem + l.alloc);
  float* oh = (float*)(smem + l.oh);
  float* price = (float*)(smem + l.price);
  int32_t* pool = (int32_t*)(smem + l.pool);
  int32_t* rsv = (int32_t*)(smem + l.rsv);
  float* cap = (float*)(smem + l.rsv_cap);
  copy_async(alloc, a.cfg_alloc, C * R);
  copy_async(oh, a.pool_overhead, a.P1 * R);
  copy_async(price, a.cfg_price, C);
  copy_async(pool, a.cfg_pool, C);
  copy_async(rsv, a.cfg_rsv, C);
  copy_async(cap, a.rsv_cap, K);
  Smem sm;
  sm.gcount = (int32_t*)(smem + l.gcount);
  sm.greq = (float*)(smem + l.greq);
  copy_async(sm.gcount, a.group_count, G);
  copy_async(sm.greq, a.group_req, G * R);
  __pipeline_commit();
  sm.spend = (float*)(smem + l.spend);
  sm.capped = (uint32_t*)(smem + l.capped);
  sm.gbits = (uint32_t*)(smem + l.gbits);
  for (int i = tid; i < G * nw; i += kThreads) {
    const int g = i / nw, c0 = (i % nw) * 32;
    const uint8_t* row = a.compat + (size_t)g * C;
    uint32_t bits = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (c0 + b < C && row[c0 + b]) bits |= 1u << b;
    sm.gbits[i] = bits;
  }
  float* used = (float*)(smem + l.rsv_used);
  for (int s = tid; s <= K; s += kThreads) {
    used[s] = 0.0f;
    sm.spend[s] = 0.0f;
  }
  for (int wd = warp; wd < words_pad(C); wd += kWarps) {
    const int c = wd * 32 + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, c < C && a.cfg_rsv[c] >= 0);
    if (lane == 0) sm.capped[wd] = bits;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  a.cfg_alloc = alloc;
  a.pool_overhead = oh;
  a.cfg_price = price;
  a.cfg_pool = pool;
  a.cfg_rsv = rsv;
  a.rsv_cap = cap;
  a.rsv_used = used;
  a.kopen = (int32_t*)(smem + l.kopen);
  a.fits = (uint8_t*)(smem + l.fits);
  return sm;
}

// ---------------------------------------------------------------- rows
//
// A fresh row keeps its config mask as kWordsPad(C) words (bit i of
// word w: column 32w + i) and its usage as R floats. Its capacity for a
// group is taken only over the set bits of mask & compat, from the
// tables in shared memory, with the row's usage in registers.

// R floats (a row's usage, a group's request): the first four in
// registers, one 16-byte load when R is 4, the rest read through the
// pointer (R <= kMaxR)
struct Row4 {
  float u[4];
  const float* p;
};

__device__ __forceinline__ Row4 load4(const float* p, int R) {
  Row4 v;
  v.p = p;
  if (R == 4 && ((uintptr_t)p & 15) == 0) {
    const float4 x = *(const float4*)p;
    v.u[0] = x.x, v.u[1] = x.y, v.u[2] = x.z, v.u[3] = x.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v.u[r] = r < R ? p[r] : 0.0f;
  }
  return v;
}

// `capacity` of a config (its alloc row in shared memory) on a row's
// usage and a group's request in registers: the same terms in the same
// order
__device__ __forceinline__ int capacity_use(const float* alloc, const Row4& use, const Row4& req,
                                            int R) {
  const Row4 al = load4(alloc, R);
  float k = kBig;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r < R) {
      const float rq = req.u[r];
      if (rq > 0.0f) {
        const float head = __fadd_rn(__fsub_rn(al.u[r], use.u[r]), 1e-4f);
        k = fminf(k, floorf(__fdiv_rn(head, rq)));
      }
    }
  }
  for (int r = 4; r < R; ++r) {
    const float rq = req.p[r];
    if (rq > 0.0f) {
      const float head = __fadd_rn(__fsub_rn(alloc[r], use.p[r]), 1e-4f);
      k = fminf(k, floorf(__fdiv_rn(head, rq)));
    }
  }
  k = fminf(fmaxf(k, 0.0f), kCapMax);
  return (int)k;
}

// Whether a config's capacity is provably at most M (0 <= M < 2^22)
// without the exact division: some requested resource's quotient,
// taken approximately (__fdividef, within 2 ulp for divisors in
// [2^-126, 2^126]), is below (M + 1)(1 - 2^-20). Then the exact
// quotient is below (M + 1)(1 - 2^-21), its round-to-nearest below
// M + 1 and its floor at most M; the capacity, a clipped minimum over
// the resources, is at most M too. When this cannot be shown the
// caller takes the exact capacity, so no result depends on the test.
__device__ __forceinline__ bool capacity_below(const float* alloc, const Row4& use,
                                               const Row4& req, int R, int M) {
  if (R > 4 || M >= (1 << 22)) return false;
  const Row4 al = load4(alloc, R);
  const float thr = __fmul_rn((float)(M + 1), 0.99999904632568359375f);  // 1 - 2^-20
  bool below = false;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float rq = req.u[r];
    if (r < R && rq >= 1e-30f && rq <= 1e30f) {
      const float head = __fadd_rn(__fsub_rn(al.u[r], use.u[r]), 1e-4f);
      below |= __fdividef(head, rq) < thr;
    }
  }
  return below;
}

// four mask words of a row (16-byte aligned)
__device__ __forceinline__ uint4 load_words(const uint32_t* w) { return *(const uint4*)w; }

// A row's partial maxima over the candidates of one mask word (word wd:
// columns 32 wd ..): whether the word holds a pinned (capped) config, the
// largest capacity >= 1 over its compatible configs and over its
// compatible pinned ones, folded into the running values.
template <class A>
__device__ __forceinline__ void word_max(const A& a, const Smem& sm, const uint32_t* rowbits,
                                         int wd, uint32_t m, const Row4& ru, const Row4& rq,
                                         unsigned& any_pin, int& max_ok, int& max_pin,
                                         unsigned& n_cand, unsigned& n_exact) {
  const int R = a.R;
  const uint32_t capped = sm.capped[wd];
  any_pin |= (m & capped) != 0u;
  uint32_t cand = m & rowbits[wd];
  while (cand) {
    const int b = __ffs(cand) - 1;
    cand &= cand - 1;
    const int c = wd * 32 + b;
    const bool pinned = (capped >> b) & 1u;
    ++n_cand;
    // a capacity counts only above the maximum it could raise (max_pin
    // <= max_ok: a pinned config raises both or neither)
    if (capacity_below(a.cfg_alloc + c * R, ru, rq, R, pinned ? max_pin : max_ok)) continue;
    ++n_exact;
    const int k = capacity_use(a.cfg_alloc + c * R, ru, rq, R);
    if (k < 1) continue;
    max_ok = max(max_ok, k);
    if (pinned) max_pin = max(max_pin, k);
  }
}

// One fresh row's partial maxima for a group (word_max over its words),
// by one thread.
template <class A>
__device__ void row_max(const A& a, const Smem& sm, const uint32_t* rowbits,
                        const uint32_t* words, const float* used, const float* req,
                        unsigned& any_pin, int& max_ok, int& max_pin, unsigned& n_cand,
                        unsigned& n_exact) {
  const int R = a.R, nw = words_pad(a.C);
  const Row4 ru = load4(used, R), rq = load4(req, R);
  any_pin = 0;
  max_ok = 0;
  max_pin = 0;
  uint4 next = load_words(words);
  for (int wd = 0; wd < nw; wd += 4) {
    const uint4 cur = next;
    if (wd + 4 < nw) next = load_words(words + wd + 4);
    const uint32_t m[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word_max(a, sm, rowbits, wd + j, m[j], ru, rq, any_pin, max_ok, max_pin, n_cand, n_exact);
  }
}

// Of one mask word's compatible configs, those that still hold a take
// of t > 0 pods on the row's usage before the take.
template <class A>
__device__ __forceinline__ uint32_t word_keep(const A& a, const uint32_t* rowbits, int wd,
                                              uint32_t m, const Row4& ru, const Row4& rq, int t) {
  const int R = a.R;
  uint32_t cand = m & rowbits[wd], keep = 0;
  while (cand) {
    const int b = __ffs(cand) - 1;
    cand &= cand - 1;
    const float* al = a.cfg_alloc + (wd * 32 + b) * R;
    if (capacity_below(al, ru, rq, R, t - 1)) continue;  // cannot hold t
    const int k = capacity_use(al, ru, rq, R);
    if (k >= 1 && k >= t) keep |= 1u << b;
  }
  return keep;
}

// A fresh row that takes t > 0 pods keeps the compatible configs
// (`rowbits`: the group's compat row) that still hold t on its usage
// before the take (pinned rows: their pin held, or the take would be
// 0); every other bit clears.
template <class A>
__device__ void narrow_row(const A& a, const uint32_t* rowbits, uint32_t* words, const Row4& ru,
                           const float* req, int t) {
  const int nw = words_pad(a.C);
  const Row4 rq = load4(req, a.R);
  uint4 next = load_words(words);
  for (int wd = 0; wd < nw; wd += 4) {
    const uint4 cur = next;
    if (wd + 4 < nw) next = load_words(words + wd + 4);
    const uint4 keep = make_uint4(word_keep(a, rowbits, wd, cur.x, ru, rq, t),
                                  word_keep(a, rowbits, wd + 1, cur.y, ru, rq, t),
                                  word_keep(a, rowbits, wd + 2, cur.z, ru, rq, t),
                                  word_keep(a, rowbits, wd + 3, cur.w, ru, rq, t));
    *(uint4*)(words + wd) = keep;
  }
}

// capacity of bound row b for group g: one config each, then the
// liveness, quota, group-cap and conflict clamps
template <class A>
__device__ __forceinline__ int bound_cap(const A& a, int b, int g, const float* req, int gcap) {
  const int R = a.R;
  int kb = capacity(a.bound_alloc + (size_t)b * R, a.bound_used + (size_t)b * R, req, R);
  const bool ok = a.bound_compat[(size_t)g * a.B + b] && a.bound_live[b] && kb >= 1;
  kb = ok ? kb : 0;
  if (a.bound_quota) kb = min(kb, (int)a.bound_quota[(size_t)b * a.G + g]);
  if (a.group_cap) kb = min(kb, max(gcap - a.assign[(size_t)b * a.G + g], 0));
  if (a.conflict && blocked(a, b, g)) kb = 0;
  return kb;
}

// a fresh row's capacity from its (combined) partials, then the
// group-cap and conflict clamps
template <class A>
__device__ __forceinline__ int fresh_cap(const A& a, int n, int g, int gcap, int kf) {
  if (a.group_cap) kf = min(kf, max(gcap - a.assign[(size_t)n * a.G + g], 0));
  if (a.conflict && blocked(a, n, g)) kf = 0;
  return kf;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The capacity sweep and the prefix take of one group step over rows
// [0, nscan): the B bound rows, then the opened fresh rows (B1's step,
// B3's plan). Thread t owns the `per` consecutive rows from t * per: it
// first prefetches their state into L1 (one round trip for all of
// them), sweeps their capacities into kcap (the block's shared memory;
// split: its partials through one vector exchange, then the combined
// capacities), and after one block scan of the threads' clamped sums it
// takes its rows in order, exact in 64 bits and clamped at r (equal to
// the JAX kernels' saturating uint32 scan), calling on_take(n, t) for
// each row with a take t > 0; with `store_takes` the rows' takes (0 for
// none) replace their capacities in kcap, for the caller to apply a
// thread a row. Returns the pods placed (min(sum, r)).
// The rows' mask words are at bits[f * words_pad(C)], their usage at
// a.free_used[f * R]; `rowbits` is the group's compat row as bits. All
// threads call it. The phase clocks charge the sweep, the scan and the
// takes to slots clk0, clk0 + 1 and clk0 + 2.
template <class A, class X, class OnTake>
__device__ long long sweep_take(const A& a, X& x, const Smem& sm, uint32_t* bits,
                                const uint32_t* rowbits, int g, const float* req, int gcap,
                                int nfresh, long long r, int32_t* kcap, bool store_takes,
                                OnTake on_take, PhaseClock& clk, int clk0) {
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_total;
  const int tid = threadIdx.x;
  const int B = a.B, R = a.R, nw = words_pad(a.C);
  const int nscan = B + nfresh;
  const int per = (nscan + kThreads - 1) / kThreads;
  const int lo = min(tid * per, nscan), hi = min(lo + per, nscan);
  for (int n = lo; n < hi; ++n) {
    if (n < B) {
      prefetch_l1(a.bound_used + (size_t)n * R);
      prefetch_l1(a.bound_alloc + (size_t)n * R);
    } else {
      for (int w = 0; w < nw; w += 32) prefetch_l1(bits + (size_t)(n - B) * nw + w);
      prefetch_l1(a.free_used + (size_t)(n - B) * R);
    }
  }
  const long long t_sweep = clk.now();
  unsigned n_cand = 0, n_exact = 0;
  // a fresh row's partials: this shard's (split: the largest capacity
  // over its ok configs, and 1 + the largest over its ok pinned ones when
  // the row holds a pinned config here, 0 otherwise), or its capacity
  // (a row pinned to a capped column takes the group only through it)
  auto fresh = [&](int n, unsigned any_pin, int max_ok, int max_pin) {
    if constexpr (X::kSplit) {
      const uint32_t pin = any_pin ? (uint32_t)(max_pin + 1) : 0u;
      xmine(x)[n - B] = ((unsigned long long)pin << 32) | (uint32_t)max_ok;
    } else {
      kcap[n] = fresh_cap(a, n, g, gcap, any_pin ? max_pin : max_ok);
    }
  };
  for (int n = lo; n < hi; ++n) {
    if (n < B) {
      kcap[n] = bound_cap(a, n, g, req, gcap);
      continue;
    }
    const int f = n - B;
    unsigned any_pin;
    int max_ok, max_pin;
    row_max(a, sm, rowbits, bits + (size_t)f * nw, a.free_used + (size_t)f * R, req, any_pin,
            max_ok, max_pin, n_cand, n_exact);
    fresh(n, any_pin, max_ok, max_pin);
  }
  if constexpr (X::kSplit) {
    // one exchange for every opened row's partials, combined over the
    // shards (maxima: any order)
    xpublish(x);
    for (int n = max(lo, B); n < hi; ++n) {
      const int f = n - B;
      uint32_t pin = 0, ok = 0;
      for (int sh = 0; sh < x.S; ++sh) {
        const unsigned long long v = __ldcg(xtheirs(x, sh) + f);
        pin = max(pin, (uint32_t)(v >> 32));
        ok = max(ok, (uint32_t)(v & 0xffffffffull));
      }
      kcap[n] = fresh_cap(a, n, g, gcap, pin > 0 ? (int)(pin - 1) : (int)ok);
    }
  }
  const unsigned sweep_cycles = (unsigned)(clk.now() - t_sweep);
  clk.mark(clk0);
  clk.spread(kSpreadSlot, kSpreadSlot + 1, sweep_cycles);
  clk.spread(kSpreadSlot + 2, kSpreadSlot + 3, n_cand);
  clk.spread(kSpreadSlot + 4, kSpreadSlot + 5, n_exact);
  long long sum = 0;
  for (int n = lo; n < hi; ++n) sum += min((long long)kcap[n], r);
  long long prefix = block_scan(sum, s_warp, &s_total) - sum;
  clk.mark(clk0 + 1);
  for (int n = lo; n < hi; ++n) {
    const long long kc = min((long long)kcap[n], r);
    const int t = (int)min(r - min(prefix, r), kc);
    prefix += kc;
    if (store_takes) kcap[n] = t;
    if (t > 0) on_take(n, t);
  }
  const long long placed = min(s_total, r);
  __syncthreads();  // s_total is rewritten by the next call
  clk.mark(clk0 + 2);
  return placed;
}

// Apply group g's take t > 0 to row n (bound or fresh): assignment,
// usage, and a fresh row's mask narrowed first, on its usage before the
// take, with the group's compat bits `rowbits`. The row's loads go out
// together; the usage is updated from the values loaded.
template <class A>
__device__ void apply_take(const A& a, const uint32_t* rowbits, uint32_t* bits, int n, int g,
                           const float* req, int t) {
  const int R = a.R, B = a.B;
  int32_t* asg = a.assign + (size_t)n * a.G + g;
  float* used = n < B ? a.bound_used + (size_t)n * R : a.free_used + (size_t)(n - B) * R;
  const int before = *asg;
  const Row4 u = load4(used, R);
  if (n >= B) narrow_row(a, rowbits, bits + (size_t)(n - B) * words_pad(a.C), u, req, t);
  *asg = before + t;
  const float tf = (float)t;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < R) used[q] = __fadd_rn(u.u[q], __fmul_rn(tf, req[q]));
  for (int q = 4; q < R; ++q) used[q] = __fadd_rn(used[q], __fmul_rn(tf, req[q]));
}

// All threads of `nb` blocks (this one is block `b`): the byte masks of
// fresh rows [0, rows) from their words (later rows stay as they are).
__device__ void mask_bytes(const uint32_t* bits, int C, int rows, uint8_t* mask, int b, int nb) {
  const int nw = words_pad(C);
  const long long n = (long long)rows * C;
  for (long long i = (long long)b * kThreads + threadIdx.x; i < n; i += (long long)nb * kThreads) {
    const int f = (int)(i / C), c = (int)(i % C);
    mask[i] = (uint8_t)((bits[(size_t)f * nw + (c >> 5)] >> (c & 31)) & 1u);
  }
}

// ---------------------------------------------------------------- open

// Rows opened by the open loop, q at a time: `open_rows(lo, q, ms, rl,
// cs, capped_star, oh, req)` writes the loop's rows lo .. lo + q - 1
// (counted from the loop's first), q - 1 holding ms pods and the last
// rl; a row's configs are the pool's uncapped columns whose open
// capacity holds its fill, plus c* itself when capped. All threads call
// it.

// which columns of word wd a row filled with `fill` pods keeps
template <class A, class X>
__device__ __forceinline__ bool open_bit(const A& a, const X& x, int c, int fill, int cs,
                                         int capped_star) {
  if (c >= a.C) return false;
  const int kf = a.kopen[c];
  return (a.cfg_rsv[c] < 0 && kf >= 1 && kf >= fill) || (capped_star && x.c0 + c == cs);
}

// B1: the fresh rows from `base` on (mask words, usage, assignment)
struct FreshRows {
  uint32_t* bits;
  int base;  // fresh row of the loop's first opened row
  int g;
  template <class A, class X>
  __device__ void open_rows(const A& a, const X& x, int lo, int q, int ms, int rl, int cs,
                            int capped_star, const float* oh, const float* req) {
    const int lane = threadIdx.x & 31, nw = words_pad(a.C), R = a.R;
    const int f0 = base + lo;
    for (int wd = threadIdx.x >> 5; wd < nw; wd += kWarps) {
      const int c = wd * 32 + lane;
      const uint32_t full = __ballot_sync(0xffffffffu, open_bit(a, x, c, ms, cs, capped_star));
      const uint32_t last = __ballot_sync(0xffffffffu, open_bit(a, x, c, rl, cs, capped_star));
      for (int i = lane; i < q; i += 32)
        bits[(size_t)(f0 + i) * nw + wd] = i == q - 1 ? last : full;
    }
    for (int i = threadIdx.x; i < q; i += kThreads) {
      const float ff = (float)(i == q - 1 ? rl : ms);
      float* used = a.free_used + (size_t)(f0 + i) * R;
      for (int r = 0; r < R; ++r) used[r] = __fadd_rn(oh[r], __fmul_rn(ff, req[r]));
      // a row opened now holds nothing yet
      a.assign[(size_t)(a.B + f0 + i) * a.G + g] = i == q - 1 ? rl : ms;
    }
  }
};

// B7: byte mask rows on one node axis from row `base` on, marked active
struct DenseRows {
  uint8_t* mask;
  float* used;
  uint8_t* active;
  int base;
  int g;
  template <class A, class X>
  __device__ void open_rows(const A& a, const X& x, int lo, int q, int ms, int rl, int cs,
                            int capped_star, const float* oh, const float* req) {
    const int C = a.C, R = a.R, n0 = base + lo;
    for (int i = threadIdx.x; i < q * C; i += kThreads) {
      const int f = i / C, c = i % C;
      mask[(size_t)(n0 + f) * C + c] = open_bit(a, x, c, f == q - 1 ? rl : ms, cs, capped_star);
    }
    for (int i = threadIdx.x; i < q; i += kThreads) {
      const int fill = i == q - 1 ? rl : ms;
      const float ff = (float)fill;
      for (int r = 0; r < R; ++r)
        used[(size_t)(n0 + i) * R + r] = __fadd_rn(oh[r], __fmul_rn(ff, req[r]));
      a.assign[(size_t)(n0 + i) * a.G + g] = fill;  // a row opened now holds nothing yet
      active[n0 + i] = 1;
    }
  }
};

// The loop's scalars, in the caller's shared memory: pods left to
// place, rows opened so far, and whether the node axis ever bound an
// open (B3's `clamped`).
struct OpenState {
  int remaining, nopen, clamped;
};

// One group's open loop (the JAX kernels' open_cond / open_round): while
// pods remain, a row is free (nc + opened < N) and some config of the
// group fits a fresh node of its pool under its reservation budget
// (rsv_used + the group's spend < cap), take the lowest pool among
// those configs, then the column c* (cost: least price per pod; ffd: a
// reserved column cheaper than every uncapped one by capacity, else the
// most capacity), and open q rows at once through `rows`, q - 1 with m*
// pods and the last with the rest; the opens' reservation use goes to
// `spend`. Three block barriers an open in cost mode, four in ffd:
// thread 0 settles an open's scalars and resets the reductions for the
// next one, and the rows are written on the way to the next open's
// first reduction. Every block reduction is a warp reduction first,
// then one shared atomic a warp. Split (X): the lowest pool, the uncapped minimum
// price and the pick keys are exchanged with the other shards, and c*'s
// open capacity and slot come with its key. All threads call it.
// the least of the warp's 32 values (B4 and the open loop)
__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, v, o);
    v = y < v ? y : v;
  }
  return v;
}

template <class A, class X, class Rows>
__device__ void open_loop(const A& a, X& x, const uint32_t* rowbits, const float* req, int gcap,
                          int nc, int N, float* spend, OpenState* st, Rows& rows) {
  __shared__ int s_pool, s_any;
  __shared__ unsigned long long s_key0, s_key1, s_key2;
  __shared__ unsigned long long s_pay0, s_pay1, s_pay2;
  __shared__ uint32_t s_minu;
  __shared__ int s_cstar, s_mstar, s_q, s_remlast, s_lo, s_capped;
  const int tid = threadIdx.x, lane = tid & 31;
  const int C = a.C, R = a.R;

  // configs a fresh node of their pool holds one pod of the group on,
  // after the pool's overhead (pseudo-configs, pool -1, never)
  for (int c = tid; c < C; c += kThreads) {
    const int p = a.cfg_pool[c];
    uint8_t ok = ((rowbits[c >> 5] >> (c & 31)) & 1u) && p >= 0;
    if (ok) {
      const float* oh = a.pool_overhead + (size_t)p * R;
      const float* al = a.cfg_alloc + (size_t)c * R;
      for (int q = 0; q < R; ++q)
        if (!(oh[q] <= __fsub_rn(al[q], req[q]))) { ok = 0; break; }
    }
    a.fits[c] = ok;
  }
  if (tid == 0) {
    s_any = 0;
    s_pool = kIntBig;
    s_key0 = s_key1 = s_key2 = ~0ull;
    s_minu = float_key(kBig);
  }
  __syncthreads();
  while (true) {
    // which configs can still open, and the lowest pool among them
    // (fitting configs have pools >= 0: kIntBig means none)
    int my_pool = kIntBig;
    for (int c = tid; c < C; c += kThreads) {
      if (!a.fits[c]) continue;
      const int s = slot_of(a, c);
      if (__fadd_rn(a.rsv_used[s], spend[s]) < cap_ext(a, s)) my_pool = min(my_pool, a.cfg_pool[c]);
    }
    my_pool = __reduce_min_sync(0xffffffffu, my_pool);
    if (lane == 0 && my_pool < kIntBig) {
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
    const int pool = s_pool;
    const int rem = st->remaining, lo = st->nopen;
    if (!(rem > 0 && s_any && nc + lo < N)) {
      // leaving with demand left and a willing config means the node
      // axis was full: that decision read the node count too
      if (tid == 0 && rem > 0 && s_any) st->clamped = 1;
      break;
    }
    const float* oh = a.pool_overhead + (size_t)pool * R;
    // open capacity per config in the chosen pool; cost mode reduces
    // argmin price-per-pod, ffd mode the cheapest uncapped price first
    unsigned long long k0 = ~0ull;
    uint32_t mu = float_key(kBig);
    for (int c = tid; c < C; c += kThreads) {
      int kf = 0;
      if (a.fits[c] && a.cfg_pool[c] == pool) {
        const int s = slot_of(a, c);
        if (__fadd_rn(a.rsv_used[s], spend[s]) < cap_ext(a, s))
          kf = capacity(a.cfg_alloc + (size_t)c * R, oh, req, R);
      }
      a.kopen[c] = kf;
      if (a.cost) {
        const float ppp = kf >= 1 ? __fdiv_rn(a.cfg_price[c], (float)max(kf, 1)) : kBig;
        const unsigned long long key = pack_key(float_key(ppp), x.c0 + c);
        if (key < k0) k0 = key;
      } else if (kf >= 1 && a.cfg_rsv[c] < 0) {
        const uint32_t pk = float_key(a.cfg_price[c]);
        if (pk < mu) mu = pk;
      }
    }
    if (a.cost) {
      k0 = warp_min_u64(k0);
      if (lane == 0 && k0 != ~0ull) atomicMin(&s_key0, k0);
    } else {
      mu = __reduce_min_sync(0xffffffffu, mu);
      if (lane == 0) atomicMin(&s_minu, mu);
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
        const int kf = a.kopen[c];
        const unsigned long long key2 = pack_key((uint32_t)(kIntBig - kf), x.c0 + c);
        if (key2 < k2) k2 = key2;
        if (kf >= 1 && a.cfg_rsv[c] >= 0 && a.cfg_price[c] < min_uncapped) {
          const unsigned long long key1 = pack_key((uint32_t)(kIntBig - kf), x.c0 + c);
          if (key1 < k1) k1 = key1;
        }
      }
      k1 = warp_min_u64(k1);
      k2 = warp_min_u64(k2);
      if (lane == 0) {
        if (k1 != ~0ull) atomicMin(&s_key1, k1);
        atomicMin(&s_key2, k2);
      }
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
      const float rsv_now = __fadd_rn(a.rsv_used[slot], spend[slot]);
      const float cap_left = fminf(__fsub_rn(cap_ext(a, slot), rsv_now), kCapMax);
      const int axis_left = N - (nc + lo);
      // the min() terms commute: the axis is split off to see whether
      // it ever bound the open (a clamped plan cannot survive an index
      // shift)
      const int q_noaxis = min((rem - 1) / ms + 1, (int)fmaxf(cap_left, 0.0f));
      const int q = max(min(q_noaxis, axis_left), 1);
      if (max(q_noaxis, 1) > axis_left) st->clamped = 1;
      const int rl = min(max(rem - (q - 1) * ms, 1), ms);
      s_cstar = cs;
      s_mstar = ms;
      s_q = q;
      s_remlast = rl;
      s_lo = lo;
      if constexpr (X::kSplit) s_capped = slot < a.K;
      else s_capped = a.cfg_rsv[cs] >= 0;
      // the open's bookkeeping, and the reductions reset for the next
      st->nopen = lo + q;
      st->remaining = rem - ((q - 1) * ms + rl);
      spend[slot] = __fadd_rn(spend[slot], (float)q);
      s_any = 0;
      s_pool = kIntBig;
      s_key0 = s_key1 = s_key2 = ~0ull;
      s_minu = float_key(kBig);
    }
    __syncthreads();
    rows.open_rows(a, x, s_lo, s_q, s_mstar, s_remlast, s_cstar, s_capped, oh, req);
  }
  __syncthreads();  // the statics are rewritten by the next call
}

}  // namespace

#ifdef KARPENTER_PHASE_CLOCKS
// copy the kClockSlots phase clocks to host memory `out` and zero them
extern "C" int phase_clocks_take(unsigned long long* out) {
  static const unsigned long long zero[kClockSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clk, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_clk, zero, sizeof(zero));
  return (int)err;
}
#endif
