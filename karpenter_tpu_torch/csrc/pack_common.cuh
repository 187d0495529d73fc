// Device code shared by the packing kernels B1 (pack_split.cu), B3
// (pack_wavefront.cu) and B7 (pack_dense.cu, B1's step on one axis of
// mask rows), and by their lane (B6) and split (B8) instantiations: the
// capacity of a row for a group, the
// order-preserving (value, index) keys of the arg-reductions, the
// block-wide scan, the reservation and conflict lookups on a kernel's
// argument struct (the kernels name the fields alike), and the phases of
// a group step:
//   - `stage_tables`: the config-axis tables copied once a launch into
//     the block's dynamic shared memory (cp.async), so that every step
//     and every open reads them there and not from L2;
//   - `sweep_take` (B1's and B7's step, B3's plan): each thread owns a run of
//     consecutive rows, sweeps their capacities (a fresh row's candidate
//     configs are its mask words ANDed with the group's compat bits,
//     capacity taken only for the set bits), then one block scan of the
//     threads' clamped sums gives every take in index order;
//   - `apply_take`: a take's usage and assignment, a fresh row's mask
//     narrowed word by word;
//   - `open_loop` (B1, B3 and B7 alike, rows written through a sink):
//     the bulk open, three or four block barriers an open, every block
//     reduction a warp reduction first; a split kernel's opens take one
//     exchange each (`open_loop_split`);
//   - `chunked_take` (`sweep_take_chunked`, B6 sequential's and B7's
//     step at 256 threads): the prefix take walked in chunks of the
//     block's rows and stopped at the chunk that meets the demand.
// A fresh row keeps its mask as words_pad(C) 32-bit words; the byte
// masks the outputs carry are written from them at the end of a launch.
// The kernels run blocks of kThreads threads (a multiple of 32, at most
// 1024). The functions a group step runs take the block size as their
// template argument kT (kThreads unless given): B6's sequential program
// launches B1's body at 256 threads, B7 its own at 256.
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
// the global timer's ns over the same marks (shard_xchg.cuh's xclock):
// with the cycles, the SM clock block 0 ran at
__device__ unsigned long long g_phase_ns;
struct PhaseClock {
  long long t = 0;
  unsigned long long ns = 0;
  bool on = false;
  __device__ void begin() {
    on = blockIdx.x == 0 && threadIdx.x == 0;
    t = clock64();
    ns = xclock();
  }
  __device__ void mark(int slot) {
    __syncthreads();
    if (on) {
      const long long t1 = clock64();
      const unsigned long long ns1 = xclock();
      g_phase_clk[slot] += (unsigned long long)(t1 - t);
      g_phase_ns += ns1 - ns;
      t = t1;
      ns = ns1;
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

// block-wide inclusive scan of one int64 per thread over kT threads;
// `warp_tot` is a shared array of kT / 32 entries. Returns the inclusive
// prefix and writes the block total to *total (shared).
template <int kT = kThreads>
__device__ long long block_scan(long long v, long long* warp_tot, long long* total) {
  constexpr int kW = kT / 32;
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
    long long w = lane < kW ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kW) warp_tot[lane] = w;  // inclusive over warps
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


// The prefix take of one group with demand r > 0 over rows [0, nscan)
// in index order, walked in chunks of kT rows (a thread a row) and
// stopped after the chunk where the demand is met: row n's take is
// clip(r - sum_{m<n} c_m, 0, c_n), c_m = min(cap(m), r), exact in 64
// bits and clamped at r (equal to the JAX kernels' saturating uint32
// scan), handed to take(n, t) (t = 0 for none) by the row's thread.
// cap(n) is called for rows below nscan alone; mark(k) after each
// chunk's capacities (k = 0), its scan (1) and its takes (2). Returns
// the end of the rows whose take was handed over (later rows take 0)
// and, in *placed, the pods placed (min(sum, r)). All threads of the
// block call it. The carry is in a register of every thread.
template <int kT, class Cap, class Take, class Mark>
__device__ int chunked_take(int nscan, long long r, Cap cap, Take take, Mark mark,
                            long long* placed) {
  __shared__ long long s_warp[kT / 32];
  __shared__ long long s_total;
  long long carry = 0;  // the same on every thread: the chunks' totals so far
  int end = 0;
  while (end < nscan) {
    const int n = end + (int)threadIdx.x;
    const long long c = n < nscan ? min((long long)cap(n), r) : 0;
    mark(0);
    const long long prefix = carry + block_scan<kT>(c, s_warp, &s_total) - c;
    mark(1);
    if (n < nscan) take(n, (int)min(r - min(prefix, r), c));
    // s_total is rewritten only after the next scan's first barrier
    carry += s_total;
    end = min(end + kT, nscan);
    mark(2);
    if (carry >= r) break;
  }
  *placed = min(carry, r);
  // the takes are read by other threads; s_warp and s_total are
  // rewritten by the next call
  __syncthreads();
  return end;
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
// count (solver/pack_split.py `table_smem_bytes`) and set it as the
// launch's dynamic shared memory.
//
// Past the card's budget (224,256 bytes a block) a launch is spilled:
// the wrapper's `table_placement` walks the segments in a fixed order of
// priority and keeps each in shared memory while the budget holds it;
// the rest go to global memory. A spilled read-only table (cfg_alloc,
// pool_overhead, cfg_price, cfg_pool, cfg_rsv, rsv_cap, the demand and
// the requests) is read where its input lies; a spilled mutable or
// derived one (the reservation use, spend, kopen, fits, the capped
// words, the compat bits, the pool segments, B3's filled-row bits) gets
// its place in the block's own slice of a scratch buffer. A split
// kernel's open loop keeps each pool's least pick key, least uncapped
// price and flag in static arrays of kXPools entries when all shared; a
// placed layout holds them as one more segment (`pool_bytes`), and the
// wrappers place a split launch of more pools so, with every segment in
// shared memory when it fits. The placed layout is a second
// instantiation of each kernel (template argument kSpilled), so an
// all-shared launch runs code with no placement in it.

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int words_of(int n) { return (n + 31) >> 5; }
// a row's config words, padded to a multiple of 4 for 16-byte loads
__host__ __device__ constexpr int words_pad(int C) { return (words_of(C) + 3) & ~3; }

struct TableLayout {
  int alloc, oh, price, pool, rsv, rsv_cap, rsv_used, spend, kopen, fits, capped, gcount, greq,
      gbits, end;
};

// a placed split kernel's pool segment: each pool's least pick key (8
// bytes), then its least uncapped price and its flag (4 each), on 16
// bytes each
__host__ __device__ constexpr int pool_bytes(int P1) {
  return align16(8 * P1) + 2 * align16(4 * P1);
}

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

// The segments of a spilled launch's placement, in the order the wrapper
// passes their offsets (pack_split.py `SEGMENTS`): the tables, the pool
// segments, then B3's (wave_layout in pack_wavefront.cu).
enum Seg {
  SG_ALLOC, SG_OH, SG_PRICE, SG_POOL, SG_RSV, SG_RSV_CAP, SG_RSV_USED, SG_SPEND, SG_KOPEN,
  SG_FITS, SG_CAPPED, SG_GCOUNT, SG_GREQ, SG_GBITS, SG_POOLS, SG_LANES,
  SG_CONF, SG_DONE, SG_UOFF, SG_MCONF, SG_ACCEPT, SG_OFFSET, SG_TOUCH, SG_COUNT
};

// A spilled launch's placement: a segment's offset >= 0 is its byte
// offset in the block's dynamic shared memory, < 0 the complement of its
// byte offset in the block's scratch slice (a spilled read-only table
// ignores it: it is read in place). Block b's slice starts at scratch +
// b * block_bytes (b = blockIdx.x: a lane, a plan lane, a shard, or a
// shard's plan lane, every block its own).
struct Placement {
  int off[SG_COUNT];
  unsigned char* scratch;
  long long block_bytes;
};

// int32 scalars of a wavefront plan lane (LaneField in pack_wavefront.cu)
constexpr int kWaveLaneFields = 8;

// The bytes of segment s (each on 16 bytes; the pool segments only in a
// split kernel's block, B3's only with W > 0).
__host__ __device__ inline long long seg_bytes(int s, int C, int R, int P1, int K, int G,
                                               bool pools, int W, int N) {
  const int nw = words_pad(C), ww = words_of(W);
  switch (s) {
    case SG_ALLOC: return align16(4 * C * R);
    case SG_OH: return align16(4 * P1 * R);
    case SG_PRICE: case SG_POOL: case SG_RSV: case SG_KOPEN: return align16(4 * C);
    case SG_RSV_CAP: return align16(4 * K);
    case SG_RSV_USED: case SG_SPEND: return align16(4 * (K + 1));
    case SG_FITS: return align16(C);
    case SG_CAPPED: return 4LL * nw;
    case SG_GCOUNT: return align16(4 * G);
    case SG_GREQ: return align16(4 * G * R);
    case SG_GBITS: return 4LL * G * nw;
    case SG_POOLS: return pools ? pool_bytes(P1) : 0;
    case SG_LANES: return W ? align16(4 * W * kWaveLaneFields) : 0;
    case SG_CONF: return W ? align16(4 * W * ww) : 0;
    case SG_DONE: return W ? align16(4 * words_of(G)) : 0;
    case SG_UOFF: return W ? align16(4 * (W + 1)) : 0;
    case SG_MCONF: return W ? align16(4 * ww) : 0;
    case SG_ACCEPT: case SG_OFFSET: return W ? align16(4 * W) : 0;
    case SG_TOUCH: return W ? align16(4 * words_of(N)) : 0;
  }
  return 0;
}

// read-only tables: a spilled one is read where its input lies
__host__ __device__ constexpr bool seg_is_input(int s) {
  return s == SG_ALLOC || s == SG_OH || s == SG_PRICE || s == SG_POOL || s == SG_RSV ||
         s == SG_RSV_CAP || s == SG_GCOUNT || s == SG_GREQ;
}

// B3's round bookkeeping, which every placement keeps in shared memory
__host__ __device__ constexpr bool seg_is_pinned(int s) { return s >= SG_LANES && s < SG_TOUCH; }

// A spilled launch's placement from the wrapper's SG_COUNT offsets.
static inline Placement make_placement(const int* offsets, unsigned char* scratch,
                                       long long block_bytes) {
  Placement p{};
  if (offsets)
    for (int i = 0; i < SG_COUNT; ++i) p.off[i] = offsets[i];
  p.scratch = scratch;
  p.block_bytes = block_bytes;
  return p;
}

// 0 when every segment of `p` lies inside the `smem` bytes of shared
// memory or its block's scratch slice, on 16 bytes, and B3's bookkeeping
// in shared memory; else cudaErrorInvalidValue.
static inline int check_placement(const Placement& p, int C, int R, int P1, int K, int G,
                                  bool pools, int W, int N, long long smem) {
  if (!p.scratch || p.block_bytes < 0) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < SG_COUNT; ++s) {
    const long long n = seg_bytes(s, C, R, P1, K, G, pools, W, N), o = p.off[s];
    if (o >= 0 ? (o % 16 != 0 || o + n > smem)
               : (seg_is_pinned(s) && n > 0) ||
                     (!seg_is_input(s) && (~o % 16 != 0 || ~o + n > p.block_bytes)))
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Shared-memory views a packing block works on besides its Args.
struct Smem {
  float* spend;            // [K+1] the current group's reservation use
  uint32_t* capped;        // [words_pad(C)] cfg_rsv >= 0
  const int32_t* gcount;   // [G] the groups' demand
  const float* greq;       // [G, R] their requests
  uint32_t* gbits;         // [G, words_pad(C)] their compat rows as bits
  // a split kernel's open loop: each pool's least pick key, least
  // uncapped price (float_key) and whether some column of it can open
  // (`pool_bytes`: the three arrays in a row)
  unsigned char* pools;
};

template <int kT = kThreads, class T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  for (int i = threadIdx.x; i < n; i += kT) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// The compat rows as bits, a word a thread (32 independent byte loads in
// flight), the capped columns' words, and rsv_used and spend zeroed.
template <int kT = kThreads, class A>
__device__ __forceinline__ void stage_derived(const A& a, const Smem& sm, float* used) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, K = a.K, G = a.G, nw = words_pad(C);
  for (int i = tid; i < G * nw; i += kT) {
    const int g = i / nw, c0 = (i % nw) * 32;
    const uint8_t* row = a.compat + (size_t)g * C;
    uint32_t bits = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (c0 + b < C && row[c0 + b]) bits |= 1u << b;
    sm.gbits[i] = bits;
  }
  for (int s = tid; s <= K; s += kT) {
    used[s] = 0.0f;
    sm.spend[s] = 0.0f;
  }
  for (int wd = warp; wd < words_pad(C); wd += kT / 32) {
    const int c = wd * 32 + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, c < C && a.cfg_rsv[c] >= 0);
    if (lane == 0) sm.capped[wd] = bits;
  }
}

// All threads: copy a's tables into `smem` and point a's table fields
// (cfg_alloc, pool_overhead, cfg_price, cfg_pool, cfg_rsv, rsv_cap,
// rsv_used, kopen, fits) at the copies; rsv_used and spend start at 0.
template <int kT = kThreads, class A>
__device__ Smem stage_tables(A& a, unsigned char* smem) {
  const int C = a.C, R = a.R, K = a.K, G = a.G;
  const TableLayout l = table_layout(C, R, a.P1, K, G);
  float* alloc = (float*)(smem + l.alloc);
  float* oh = (float*)(smem + l.oh);
  float* price = (float*)(smem + l.price);
  int32_t* pool = (int32_t*)(smem + l.pool);
  int32_t* rsv = (int32_t*)(smem + l.rsv);
  float* cap = (float*)(smem + l.rsv_cap);
  copy_async<kT>(alloc, a.cfg_alloc, C * R);
  copy_async<kT>(oh, a.pool_overhead, a.P1 * R);
  copy_async<kT>(price, a.cfg_price, C);
  copy_async<kT>(pool, a.cfg_pool, C);
  copy_async<kT>(rsv, a.cfg_rsv, C);
  copy_async<kT>(cap, a.rsv_cap, K);
  Smem sm;
  int32_t* gcount = (int32_t*)(smem + l.gcount);
  float* greq = (float*)(smem + l.greq);
  copy_async<kT>(gcount, a.group_count, G);
  copy_async<kT>(greq, a.group_req, G * R);
  __pipeline_commit();
  sm.gcount = gcount;
  sm.greq = greq;
  sm.spend = (float*)(smem + l.spend);
  sm.capped = (uint32_t*)(smem + l.capped);
  sm.gbits = (uint32_t*)(smem + l.gbits);
  sm.pools = nullptr;  // a split kernel's pool entries are static arrays
  float* used = (float*)(smem + l.rsv_used);
  stage_derived<kT>(a, sm, used);
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

// A segment of a spilled launch: in shared memory, or in this block's
// scratch slice.
__device__ __forceinline__ unsigned char* seg_at(const Placement& p, int s, unsigned char* smem) {
  const int o = p.off[s];
  return o >= 0 ? smem + o : p.scratch + (size_t)blockIdx.x * p.block_bytes + ~o;
}

// A read-only table of a spilled launch: copied into shared memory when
// the placement keeps it there (the field then points at the copy after
// the staging's barrier), else read where its input lies.
template <int kT = kThreads, class T>
__device__ __forceinline__ const T* seg_input(const Placement& p, int s, unsigned char* smem,
                                              const T* input, int n) {
  if (p.off[s] < 0) return input;
  T* dst = (T*)(smem + p.off[s]);
  copy_async<kT>(dst, input, n);
  return dst;
}

// stage_tables for a spilled launch: every segment where `p` puts it.
template <int kT = kThreads, class A>
__device__ Smem stage_tables_placed(A& a, unsigned char* smem, const Placement& p) {
  const int C = a.C, R = a.R, K = a.K, G = a.G;
  const float* alloc = seg_input<kT>(p, SG_ALLOC, smem, a.cfg_alloc, C * R);
  const float* oh = seg_input<kT>(p, SG_OH, smem, a.pool_overhead, a.P1 * R);
  const float* price = seg_input<kT>(p, SG_PRICE, smem, a.cfg_price, C);
  const int32_t* pool = seg_input<kT>(p, SG_POOL, smem, a.cfg_pool, C);
  const int32_t* rsv = seg_input<kT>(p, SG_RSV, smem, a.cfg_rsv, C);
  const float* cap = seg_input<kT>(p, SG_RSV_CAP, smem, a.rsv_cap, K);
  Smem sm;
  sm.gcount = seg_input<kT>(p, SG_GCOUNT, smem, a.group_count, G);
  sm.greq = seg_input<kT>(p, SG_GREQ, smem, a.group_req, G * R);
  __pipeline_commit();
  sm.spend = (float*)seg_at(p, SG_SPEND, smem);
  sm.capped = (uint32_t*)seg_at(p, SG_CAPPED, smem);
  sm.gbits = (uint32_t*)seg_at(p, SG_GBITS, smem);
  sm.pools = seg_at(p, SG_POOLS, smem);
  float* used = (float*)seg_at(p, SG_RSV_USED, smem);
  stage_derived<kT>(a, sm, used);
  __pipeline_wait_prior(0);
  __syncthreads();
  a.cfg_alloc = alloc;
  a.pool_overhead = oh;
  a.cfg_price = price;
  a.cfg_pool = pool;
  a.cfg_rsv = rsv;
  a.rsv_cap = cap;
  a.rsv_used = used;
  a.kopen = (int32_t*)seg_at(p, SG_KOPEN, smem);
  a.fits = (uint8_t*)seg_at(p, SG_FITS, smem);
  return sm;
}

// A kernel's staging: the all-shared layout, or (kSpilled) `p`'s.
template <bool kSpilled, int kT = kThreads, class A>
__device__ __forceinline__ Smem stage(A& a, unsigned char* smem, const Placement& p) {
  if constexpr (kSpilled) return stage_tables_placed<kT>(a, smem, p);
  else return stage_tables<kT>(a, smem);
}

// ---------------------------------------------------------------- rows
//
// A fresh row keeps its config mask as kWordsPad(C) words (bit i of
// word w: column 32w + i) and its usage as R floats. Its capacity for a
// group is taken only over the set bits of mask & compat, from the
// tables in shared memory, with the row's usage in registers.

// Whether a kernel's rows are B7's (pack_dense.cu): every row carries a
// per-row quota, `quota[n, g]` (the JAX `pack`'s), and most rows are
// existing or planned nodes that hold one config over up to thousands
// of columns: the sweep takes such a row's capacity from its config
// alone (`row_cfg`, as B1 takes a bound row's), and the sweep and the
// narrowing step over four zero words at a time. B1's fresh rows have
// none of it; its instantiations leave it out and keep their code.
template <class A>
constexpr bool kDenseRows = false;

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
    if constexpr (kDenseRows<A>)
      if ((cur.x | cur.y | cur.z | cur.w) == 0u) continue;  // no config, no pin
    const uint32_t m[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word_max(a, sm, rowbits, wd + j, m[j], ru, rq, any_pin, max_ok, max_pin, n_cand, n_exact);
  }
}

// A fresh row's partial maxima (row_max); B7's rows that hold one
// config (`row_cfg[n]` >= 0: an existing or planned node, one-hot for
// good, since a take keeps the config that holds it) from that config
// alone, as row_max finds them for a one-bit mask.
template <class A>
__device__ __forceinline__ void fresh_max(const A& a, const Smem& sm, const uint32_t* rowbits,
                                          int n, const uint32_t* words, const float* used,
                                          const float* req, unsigned& any_pin, int& max_ok,
                                          int& max_pin, unsigned& n_cand, unsigned& n_exact) {
  if constexpr (kDenseRows<A>) {
    const int c = n < a.E ? a.row_cfg[n] : -1;
    if (c >= 0) {
      const uint32_t bit = 1u << (c & 31);
      any_pin = (sm.capped[c >> 5] & bit) != 0u;
      max_ok = max_pin = 0;
      if (rowbits[c >> 5] & bit) {
        ++n_cand;
        ++n_exact;
        const int k = capacity_use(a.cfg_alloc + c * a.R, load4(used, a.R), load4(req, a.R), a.R);
        if (k >= 1) {
          max_ok = k;
          max_pin = any_pin ? k : 0;
        }
      }
      return;
    }
  }
  row_max(a, sm, rowbits, words, used, req, any_pin, max_ok, max_pin, n_cand, n_exact);
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
    if constexpr (kDenseRows<A>)
      if ((cur.x | cur.y | cur.z | cur.w) == 0u) continue;  // the words stay zero
    const uint4 keep = make_uint4(word_keep(a, rowbits, wd, cur.x, ru, rq, t),
                                  word_keep(a, rowbits, wd + 1, cur.y, ru, rq, t),
                                  word_keep(a, rowbits, wd + 2, cur.z, ru, rq, t),
                                  word_keep(a, rowbits, wd + 3, cur.w, ru, rq, t));
    *(uint4*)(words + wd) = keep;
  }
}

// `blocked` with group g's conflict row as bits (`cbits`, words_of(G)
// words): only the conflicting groups' assignments are read
template <class A>
__device__ __forceinline__ bool blocked_bits(const A& a, int n, const uint32_t* cbits) {
  const int32_t* arow = a.assign + (size_t)n * a.G;
  for (int w = 0; w < words_of(a.G); ++w)
    for (uint32_t m = cbits[w]; m; m &= m - 1)
      if (arow[w * 32 + __ffs(m) - 1] > 0) return true;
  return false;
}

// capacity of bound row b for group g: one config each, then the
// liveness, quota, group-cap and conflict clamps (with `cbits`, the
// group's conflict row as bits: read only for a row that could take)
template <class A>
__device__ __forceinline__ int bound_cap(const A& a, int b, int g, const float* req, int gcap,
                                         const uint32_t* cbits = nullptr) {
  const int R = a.R;
  int kb = capacity(a.bound_alloc + (size_t)b * R, a.bound_used + (size_t)b * R, req, R);
  const bool ok = a.bound_compat[(size_t)g * a.B + b] && a.bound_live[b] && kb >= 1;
  kb = ok ? kb : 0;
  if (a.bound_quota) kb = min(kb, (int)a.bound_quota[(size_t)b * a.G + g]);
  if (a.group_cap) kb = min(kb, max(gcap - a.assign[(size_t)b * a.G + g], 0));
  if (cbits) {
    if (kb > 0 && blocked_bits(a, b, cbits)) kb = 0;
  } else if (a.conflict && blocked(a, b, g)) {
    kb = 0;
  }
  return kb;
}

// a fresh row's capacity from its (combined) partials, then the quota
// (kDenseRows), group-cap and conflict clamps (`cbits` as bound_cap's)
template <class A>
__device__ __forceinline__ int fresh_cap(const A& a, int n, int g, int gcap, int kf,
                                         const uint32_t* cbits = nullptr) {
  if constexpr (kDenseRows<A>)
    if (a.quota) kf = min(kf, (int)a.quota[(size_t)n * a.G + g]);
  if (a.group_cap) kf = min(kf, max(gcap - a.assign[(size_t)n * a.G + g], 0));
  if (cbits) {
    if (kf > 0 && blocked_bits(a, n, cbits)) kf = 0;
  } else if (a.conflict && blocked(a, n, g)) {
    kf = 0;
  }
  return kf;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// The capacity sweep and the prefix take of one group step over rows
// [0, nscan): the B bound rows, then the opened fresh rows (B1's step,
// B3's plan). Thread t owns the `per` consecutive rows from t * per: it
// first prefetches their state into L1 (one round trip for all of
// them), sweeps their capacities into kcap (split: it sends its rows'
// partials and polls the other shards' for the same rows, then writes
// the combined capacities), and after one block scan of the threads'
// clamped sums it takes its rows in order, exact in 64 bits and clamped
// at r (equal to the JAX kernels' saturating uint32 scan), calling
// on_take(n, t) for each row with a take t > 0; with `store_takes` the
// rows' takes (0 for none) replace their capacities in kcap, for the
// caller to apply a thread a row. Returns the pods placed (min(sum, r)).
// The rows' mask words are at bits[f * words_pad(C)], their usage at
// a.free_used[f * R]; `rowbits` is the group's compat row as bits. All
// threads call it. The phase clocks charge the sweep, the scan and the
// takes to slots clk0, clk0 + 1 and clk0 + 2.
template <int kT = kThreads, class A, class X, class OnTake>
__device__ long long sweep_take(const A& a, X& x, const Smem& sm, uint32_t* bits,
                                const uint32_t* rowbits, int g, const float* req, int gcap,
                                int nfresh, long long r, int32_t* kcap, bool store_takes,
                                OnTake on_take, PhaseClock& clk, int clk0) {
  __shared__ long long s_warp[kT / 32];
  __shared__ long long s_total;
  const int tid = threadIdx.x;
  const int B = a.B, R = a.R, nw = words_pad(a.C);
  const int nscan = B + nfresh;
  const int per = (nscan + kT - 1) / kT;
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
      // two words a row, each partial below 2^31 (capacities <= kCapMax)
      xput(x, 2 * (n - B), any_pin ? (uint32_t)(max_pin + 1) : 0u);
      xput(x, 2 * (n - B) + 1, (uint32_t)max_ok);
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
    fresh_max(a, sm, rowbits, n, bits + (size_t)f * nw, a.free_used + (size_t)f * R, req,
              any_pin, max_ok, max_pin, n_cand, n_exact);
    fresh(n, any_pin, max_ok, max_pin);
  }
  if constexpr (X::kSplit) {
    // one exchange for every opened row's partials, point to point: the
    // thread that sent its rows' words polls the S shards' words of the
    // same rows (the split of rows over threads is the same on every
    // shard: nscan is replicated and kT fixed) and combines them
    // (maxima: any order); no block barrier around the wait. The
    // exchange's invariant holds: block_scan's barriers below come
    // between these reads and the next exchange's writes. No opened row,
    // no exchange (on every shard alike).
    if (nscan > B) {
      XTimer xt(tid == 0);
      for (int n = max(lo, B); n < hi; ++n) {
        uint32_t pin = 0, ok = 0;
        xeach<2>(x, 2 * (n - B), [&](int, const uint32_t* d) {
          pin = max(pin, d[0]);
          ok = max(ok, d[1]);
        });
        kcap[n] = fresh_cap(a, n, g, gcap, pin > 0 ? (int)(pin - 1) : (int)ok);
      }
      xt.stop(XK_ROWS, 0);
      xdone(x);
    }
  }
  const unsigned sweep_cycles = (unsigned)(clk.now() - t_sweep);
  clk.mark(clk0);
  clk.spread(kSpreadSlot, kSpreadSlot + 1, sweep_cycles);
  clk.spread(kSpreadSlot + 2, kSpreadSlot + 3, n_cand);
  clk.spread(kSpreadSlot + 4, kSpreadSlot + 5, n_exact);
  long long sum = 0;
  for (int n = lo; n < hi; ++n) sum += min((long long)kcap[n], r);
  long long prefix = block_scan<kT>(sum, s_warp, &s_total) - sum;
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

// B6 sequential's step at a block of kT < kThreads threads: the capacity
// sweep and the prefix take of sweep_take, walked in chunks of kT rows in
// index order and stopped after the chunk where the demand is met
// (`chunked_take`). In the consolidation lanes the
// demand is mostly met early in the rows (PERF.md §6), so most of the
// rows' capacities are never needed. Rows [0, *end) have their takes (0
// for none) in kcap; later rows are not written, and the caller applies
// takes below *end alone. Returns the pods placed (min(sum, r)).
// Unsplit kernels only. All threads call it. The phase clocks charge
// each chunk's sweep, scan and takes to slots clk0, clk0 + 1 and clk0 + 2.
template <int kT, class A>
__device__ long long sweep_take_chunked(const A& a, const Smem& sm, uint32_t* bits,
                                        const uint32_t* rowbits, int g, const float* req,
                                        int gcap, int nfresh, long long r, int32_t* kcap,
                                        PhaseClock& clk, int clk0, int* end_out) {
  // the group's conflict row as bits (G <= 32 kConfWords): a row's
  // conflict test then reads the conflicting groups' assignments alone
  constexpr int kConfWords = 64;
  __shared__ uint32_t s_conf[kConfWords];
  const int tid = threadIdx.x;
  const int B = a.B, R = a.R, nw = words_pad(a.C);
  const uint32_t* cbits = nullptr;
  if (a.conflict && a.G <= 32 * kConfWords) {
    const int lane = tid & 31;
    const uint8_t* crow = a.conflict + (size_t)g * a.G;
    for (int w = tid >> 5; w < words_of(a.G); w += kT / 32) {
      const int h = w * 32 + lane;
      const uint32_t m = __ballot_sync(0xffffffffu, h < a.G && crow[h]);
      if (lane == 0) s_conf[w] = m;
    }
    __syncthreads();
    cbits = s_conf;
  }
  unsigned n_cand = 0, n_exact = 0, sweep_cycles = 0;
  auto cap = [&](int n) {
    const long long t0 = clk.now();
    int kc;
    if (n < B) {
      kc = bound_cap(a, n, g, req, gcap, cbits);
    } else {
      unsigned any_pin;
      int max_ok, max_pin;
      fresh_max(a, sm, rowbits, n, bits + (size_t)(n - B) * nw,
                a.free_used + (size_t)(n - B) * R, req, any_pin, max_ok, max_pin, n_cand,
                n_exact);
      kc = fresh_cap(a, n, g, gcap, any_pin ? max_pin : max_ok, cbits);
    }
    sweep_cycles += (unsigned)(clk.now() - t0);
    return kc;
  };
  long long placed;
  // s_conf is rewritten by the next call after chunked_take's last barrier
  *end_out = chunked_take<kT>(
      B + nfresh, r, cap, [&](int n, int t) { kcap[n] = t; },
      [&](int k) { clk.mark(clk0 + k); }, &placed);
  clk.spread(kSpreadSlot, kSpreadSlot + 1, sweep_cycles);
  clk.spread(kSpreadSlot + 2, kSpreadSlot + 3, n_cand);
  clk.spread(kSpreadSlot + 4, kSpreadSlot + 5, n_exact);
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

// All threads of `nb` blocks of kT (this one is block `b`): the byte
// masks of fresh rows [0, rows) from their words (later rows stay as
// they are).
template <int kT = kThreads>
__device__ void mask_bytes(const uint32_t* bits, int C, int rows, uint8_t* mask, int b, int nb) {
  const int nw = words_pad(C);
  const long long n = (long long)rows * C;
  for (long long i = (long long)b * kT + threadIdx.x; i < n; i += (long long)nb * kT) {
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

// B1 and B7: the fresh rows from `base` on (mask words, usage, assignment)
struct FreshRows {
  uint32_t* bits;
  int base;  // fresh row of the loop's first opened row
  int g;
  template <int kT = kThreads, class A, class X>
  __device__ void open_rows(const A& a, const X& x, int lo, int q, int ms, int rl, int cs,
                            int capped_star, const float* oh, const float* req) {
    const int lane = threadIdx.x & 31, nw = words_pad(a.C), R = a.R;
    const int f0 = base + lo;
    for (int wd = threadIdx.x >> 5; wd < nw; wd += kT / 32) {
      const int c = wd * 32 + lane;
      const uint32_t full = __ballot_sync(0xffffffffu, open_bit(a, x, c, ms, cs, capped_star));
      const uint32_t last = __ballot_sync(0xffffffffu, open_bit(a, x, c, rl, cs, capped_star));
      for (int i = lane; i < q; i += 32)
        bits[(size_t)(f0 + i) * nw + wd] = i == q - 1 ? last : full;
    }
    for (int i = threadIdx.x; i < q; i += kT) {
      const float ff = (float)(i == q - 1 ? rl : ms);
      float* used = a.free_used + (size_t)(f0 + i) * R;
      for (int r = 0; r < R; ++r) used[r] = __fadd_rn(oh[r], __fmul_rn(ff, req[r]));
      // a row opened now holds nothing yet
      a.assign[(size_t)(a.B + f0 + i) * a.G + g] = i == q - 1 ? rl : ms;
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
// then one shared atomic a warp. A split kernel takes `open_loop_split`
// instead. All threads call it.
// the least of the warp's 32 values (B4 and the open loop)
__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, v, o);
    v = y < v ? y : v;
  }
  return v;
}

template <int kT = kThreads, class A, class X, class Rows>
__device__ void open_loop_whole(const A& a, X& x, const uint32_t* rowbits, const float* req,
                                int gcap, int nc, int N, float* spend, OpenState* st,
                                Rows& rows) {
  __shared__ int s_pool, s_any;
  __shared__ unsigned long long s_key0, s_key1, s_key2;
  __shared__ uint32_t s_minu;
  __shared__ int s_cstar, s_mstar, s_q, s_remlast, s_lo, s_capped;
  const int tid = threadIdx.x, lane = tid & 31;
  const int C = a.C, R = a.R;

  // configs a fresh node of their pool holds one pod of the group on,
  // after the pool's overhead (pseudo-configs, pool -1, never)
  for (int c = tid; c < C; c += kT) {
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
    for (int c = tid; c < C; c += kT) {
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
    for (int c = tid; c < C; c += kT) {
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
    if (!a.cost) {
      // reserved columns cheaper than every uncapped one win by
      // capacity; else the column with the most capacity
      unsigned long long k1 = ~0ull, k2 = ~0ull;
      const float min_uncapped = key_float(s_minu);
      for (int c = tid; c < C; c += kT) {
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
    }
    if (tid == 0) {
      int cs;
      if (a.cost) cs = (int)(s_key0 & 0xffffffffull);
      else cs = (int)(((s_key1 != ~0ull) ? s_key1 : s_key2) & 0xffffffffull);
      int ms = max(a.kopen[cs], 1);
      if (a.group_cap) ms = min(max(gcap, 1), ms);
      const int slot = slot_of(a, cs);
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
      s_capped = a.cfg_rsv[cs] >= 0;
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
    rows.template open_rows<kT>(a, x, s_lo, s_q, s_mstar, s_remlast, s_cstar, s_capped, oh, req);
  }
  __syncthreads();  // the statics are rewritten by the next call
}

// The pools a split kernel's open loop keeps in static shared memory in
// the all-shared layout (P1 <= kXPools; past it the wrappers take a
// placed layout, whose pool segment is sized by P1).
constexpr int kXPools = 64;

// One group's open loop in a split kernel: open_loop_whole's decisions,
// one exchange an open. One pass over the shard's columns gives every
// column's open capacity on a fresh node of its own pool (0 when it does
// not fit or its reservation is spent; a column is live in its pool when
// that is >= 1) and, for every pool p, whether some column can open and
// the shard's least pick key under "p is chosen": cost, price per pod;
// ffd, the most capacity (key2), with the shard's least uncapped price
// of p. One exchange of those P1 entries (four words each: key, global
// column, cost: the column's open capacity / ffd: the least uncapped
// price, and slot with the pool's flag) follows, and every shard takes
// the lowest pool that can open and that pool's least key. ffd with
// reserved columns (K > 0, replicated) needs a second exchange, for
// key1, whose filter needs the least uncapped price over every shard.
// So an open costs one exchange (two in ffd with reservations); the loop
// ends without one when no pod is left, the common case after an open.
//
// Exactness. open_loop_whole's keys run over every column, a column
// outside the chosen pool keyed as one of capacity 0 (cost: kBig, ffd:
// kIntBig - 0), ties to the lowest global column. So pool p's least key
// on a shard is the least of its live columns' keys and the "zero" key
// of the shard's first column that is not live in p: column 0 unless
// column 0 is live in p (every thread takes column 0's capacity itself),
// else the first column live elsewhere or nowhere. When the chosen pool's
// fitting configs all have zero open capacity, the zero key wins as it
// does there, with capacity 0 and its column's slot. After the choice
// a.kopen holds 0 outside the chosen pool, as open_bit reads it. The
// pass takes the capacities of every pool's openable columns, at most C
// an open, the bound of open_loop_whole's loop over C.
//
// The pools' entries (pkey, pool p's least key on this shard; pminu,
// ffd: its least uncapped price; pany, some column of p can open) are
// static arrays of kXPools entries in the all-shared layout, and the
// block's pool segment (`pools`, sized by P1 like the exchange slots'
// 4 P1 words) in a placed one (kPlaced), which the wrappers take past
// kXPools pools: so the loop takes any number of pools. They are the
// block's own: written in the pass, read after its barrier and reset
// before the open's last barrier, as the exchange's invariant requires
// of any state a later exchange's writes depend on.
template <bool kPlaced, int kT = kThreads, class A, class X, class Rows>
__device__ void open_loop_split(const A& a, X& x, unsigned char* pools, const uint32_t* rowbits,
                                const float* req, int gcap, int nc, int N, float* spend,
                                OpenState* st, Rows& rows) {
  unsigned long long* s_pkey;  // pool p's least key on this shard
  uint32_t* s_pminu;           // ffd: its least uncapped price (float_key)
  int* s_pany;                 // some column of p can open
  if constexpr (kPlaced) {
    s_pkey = (unsigned long long*)pools;
    s_pminu = (uint32_t*)(pools + align16(8 * a.P1));
    s_pany = (int*)(pools + align16(8 * a.P1) + align16(4 * a.P1));
  } else {
    __shared__ unsigned long long pkey[kXPools];
    __shared__ uint32_t pminu[kXPools];
    __shared__ int pany[kXPools];
    s_pkey = pkey;
    s_pminu = pminu;
    s_pany = pany;
  }
  __shared__ int s_zcol;                          // the first column not live in lp0's pool
  __shared__ unsigned long long s_key1;
  __shared__ int s_cstar, s_mstar, s_q, s_remlast, s_lo, s_capped, s_pool;
  const int tid = threadIdx.x, lane = tid & 31;
  const int C = a.C, R = a.R, P1 = a.P1;
  const uint32_t kZero = a.cost ? float_key(kBig) : (uint32_t)kIntBig;

  // configs a fresh node of their pool holds one pod of the group on,
  // after the pool's overhead (pseudo-configs, pool -1, never)
  for (int c = tid; c < C; c += kT) {
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
  for (int p = tid; p < P1; p += kT) {
    s_pkey[p] = ~0ull;
    s_pminu[p] = float_key(kBig);
    s_pany[p] = 0;
  }
  if (tid == 0) {
    s_zcol = kIntBig;
    s_key1 = ~0ull;
  }
  __syncthreads();
  // a column's open capacity on a fresh node of its pool, -1 when it
  // cannot open
  auto open_cap = [&](int c) -> int {
    if (!a.fits[c]) return -1;
    const int s = slot_of(a, c);
    if (!(__fadd_rn(a.rsv_used[s], spend[s]) < cap_ext(a, s))) return -1;
    return capacity(a.cfg_alloc + (size_t)c * R, a.pool_overhead + (size_t)a.cfg_pool[c] * R,
                    req, R);
  };
  while (true) {
    const int rem = st->remaining, lo = st->nopen;
    if (rem <= 0) break;  // replicated: every shard leaves alike
    // the last open's rows read kopen: a barrier before it is rewritten
    // (only when demand is left after an open, the rare case)
    if (lo > 0) __syncthreads();
    // ---- the pass: capacities, and each pool's least key on this shard
    const int lp0 = open_cap(0) >= 1 ? a.cfg_pool[0] : -1;
    int my_zc = kIntBig;
    for (int c = tid; c < C; c += kT) {
      const int kf = open_cap(c);
      const int p = a.cfg_pool[c];
      a.kopen[c] = max(kf, 0);
      if (kf >= 0) s_pany[p] = 1;
      if ((kf >= 1 ? p : -1) != lp0) my_zc = min(my_zc, c);
      if (kf >= 1) {
        const uint32_t v = a.cost ? float_key(__fdiv_rn(a.cfg_price[c], (float)kf))
                                  : (uint32_t)(kIntBig - kf);
        atomicMin(&s_pkey[p], pack_key(v, x.c0 + c));
        if (!a.cost && a.cfg_rsv[c] < 0) atomicMin(&s_pminu[p], float_key(a.cfg_price[c]));
      }
    }
    my_zc = __reduce_min_sync(0xffffffffu, my_zc);
    if (lane == 0 && my_zc < kIntBig) atomicMin(&s_zcol, my_zc);
    __syncthreads();
    // ---- this shard's entry of each pool (a pool other than lp0's has
    // column 0 as its zero column; lp0's has s_zcol, or none when every
    // column is live in it)
    for (int p = tid; p < P1; p += kT) {
      const int zc = p == lp0 ? s_zcol : 0;
      unsigned long long key = s_pkey[p];
      if (zc < kIntBig) key = min(key, pack_key(kZero, x.c0 + zc));
      const int col = (int)(key & 0xffffffffull) - x.c0;
      const bool live = a.kopen[col] >= 1 && a.cfg_pool[col] == p;
      xput(x, 4 * p, (uint32_t)(key >> 32));
      xput(x, 4 * p + 1, (uint32_t)key);
      xput(x, 4 * p + 2, a.cost ? (uint32_t)(live ? a.kopen[col] : 0) : s_pminu[p]);
      xput(x, 4 * p + 3, (uint32_t)slot_of(a, col) | (s_pany[p] ? 0x80000000u : 0u));
    }
    // ---- the exchange: the lowest pool some shard can open, its least
    // key over the shards with that shard's payload, and (ffd) the least
    // uncapped price; the entries staged a chunk of pools at a time
    XTimer xt(tid == 0);
    const int per = max(1, kStageWords / (4 * x.S));
    int pool = kIntBig, rounds = 0;
    unsigned long long key = ~0ull;
    uint32_t pay = 0, slot = 0, minu = float_key(kBig);
    for (int p0 = 0; p0 < P1 && pool == kIntBig; p0 += per) {
      const int m = min(per, P1 - p0);
      const uint32_t* e = xstage(x, 4 * p0, 4 * m);
      ++rounds;
      for (int p = 0; p < m && pool == kIntBig; ++p) {
        bool any = false;
        for (int sh = 0; sh < x.S; ++sh) any |= (e[sh * 4 * m + 4 * p + 3] >> 31) != 0u;
        if (!any) continue;
        pool = p0 + p;
        for (int sh = 0; sh < x.S; ++sh) {
          const uint32_t* w = e + sh * 4 * m + 4 * p;
          const unsigned long long k = ((unsigned long long)w[0] << 32) | w[1];
          if (k < key) {
            key = k;
            pay = w[2];
            slot = w[3] & 0x7fffffffu;
          }
          if (!a.cost) minu = min(minu, w[2]);
        }
      }
    }
    xdone(x);
    xt.stop(XK_OPEN, rounds);
    if (!(pool < kIntBig && nc + lo < N)) {
      // leaving with demand left and a willing config means the node
      // axis was full: that decision read the node count too
      if (tid == 0 && pool < kIntBig) st->clamped = 1;
      break;
    }
    // open capacities of the chosen pool only (this thread's columns)
    for (int c = tid; c < C; c += kT)
      if (a.cfg_pool[c] != pool) a.kopen[c] = 0;
    // ---- ffd with reserved columns: reserved columns cheaper than every
    // uncapped one win by capacity (key1), over every shard
    unsigned long long k1 = ~0ull;
    uint32_t slot1 = 0;
    if (!a.cost && a.K > 0) {
      XTimer xt1(tid == 0);
      const float min_uncapped = key_float(minu);
      unsigned long long mine = ~0ull;
      for (int c = tid; c < C; c += kT) {
        const int kf = a.kopen[c];
        if (kf >= 1 && a.cfg_rsv[c] >= 0 && a.cfg_price[c] < min_uncapped)
          mine = min(mine, pack_key((uint32_t)(kIntBig - kf), x.c0 + c));
      }
      mine = warp_min_u64(mine);
      if (lane == 0 && mine != ~0ull) atomicMin(&s_key1, mine);
      __syncthreads();
      if (tid == 0) {
        const unsigned long long k = s_key1;
        xput(x, 0, (uint32_t)(k >> 32));
        xput(x, 1, (uint32_t)k);
        xput(x, 2, k != ~0ull ? (uint32_t)slot_of(a, (int)(k & 0xffffffffull) - x.c0) : 0u);
      }
      const uint32_t* e = xstage(x, 0, 3);
      for (int sh = 0; sh < x.S; ++sh) {
        const unsigned long long k = ((unsigned long long)e[3 * sh] << 32) | e[3 * sh + 1];
        if (k < k1) {
          k1 = k;
          slot1 = e[3 * sh + 2];
        }
      }
      xdone(x);
      xt1.stop(XK_KEY1, 2);
    }
    if (tid == 0) {
      // c*, its open capacity and its slot: from key1 when some reserved
      // column won, else from the pool's key (ffd: its capacity is
      // kIntBig less the key's value)
      const bool use1 = k1 != ~0ull;
      const unsigned long long kk = use1 ? k1 : key;
      const int cs = (int)(kk & 0xffffffffull);
      const int kcs = a.cost ? (int)pay : kIntBig - (int)(uint32_t)(kk >> 32);
      const int cslot = use1 ? (int)slot1 : (int)slot;
      int ms = max(kcs, 1);
      if (a.group_cap) ms = min(max(gcap, 1), ms);
      const float rsv_now = __fadd_rn(a.rsv_used[cslot], spend[cslot]);
      const float cap_left = fminf(__fsub_rn(cap_ext(a, cslot), rsv_now), kCapMax);
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
      s_pool = pool;
      s_capped = cslot < a.K;
      // the open's bookkeeping, and the reductions reset for the next
      st->nopen = lo + q;
      st->remaining = rem - ((q - 1) * ms + rl);
      spend[cslot] = __fadd_rn(spend[cslot], (float)q);
      s_zcol = kIntBig;
      s_key1 = ~0ull;
      XTimer(true).stop(XK_OPENS, 0);
    }
    for (int p = tid; p < P1; p += kT) {
      s_pkey[p] = ~0ull;
      s_pminu[p] = float_key(kBig);
      s_pany[p] = 0;
    }
    __syncthreads();
    const float* oh = a.pool_overhead + (size_t)s_pool * R;
    rows.template open_rows<kT>(a, x, s_lo, s_q, s_mstar, s_remlast, s_cstar, s_capped, oh, req);
  }
  __syncthreads();  // the statics are rewritten by the next call
}

// One group's open loop: open_loop_whole, or open_loop_split in a split
// kernel (kPlaced: its pool entries in `pools`). All threads call it.
template <bool kPlaced, int kT = kThreads, class A, class X, class Rows>
__device__ void open_loop(const A& a, X& x, unsigned char* pools, const uint32_t* rowbits,
                          const float* req, int gcap, int nc, int N, float* spend, OpenState* st,
                          Rows& rows) {
  if constexpr (X::kSplit)
    open_loop_split<kPlaced, kT>(a, x, pools, rowbits, req, gcap, nc, N, spend, st, rows);
  else open_loop_whole<kT>(a, x, rowbits, req, gcap, nc, N, spend, st, rows);
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

// copy the global timer's ns over the marks to host memory `out` and
// zero it
extern "C" int phase_ns_take(unsigned long long* out) {
  static const unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_ns, &zero, sizeof(zero));
  return (int)err;
}
#endif
