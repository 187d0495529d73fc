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
// order (`shard_sum_f32`, `shard_sum_ordered`).
//
// One exchange: flags in the data. Every slot element is one 64-bit word
// holding a 32-bit datum in its low half and the exchange's tag (the
// block's exchange count + 1) in its high half, written with one aligned
// 64-bit store, which is single-copy atomic on sm_90: a reader that sees
// the tag it waits for sees the datum written with it. So there is no
// arrival counter and no fence on either side: each shard stores its
// words, and the readers poll the S shards' words (through L2, relaxed
// loads at the group's scope) until each carries the tag, a reader's
// loads all issued before the first is checked. A 64-bit value (a pick
// key) goes as two words. Every shard runs the same sequence of
// exchanges (their control flow reads only replicated state), so the
// n-th exchange of every block waits for tag n + 1.
//
// Slot reuse. The slots are double-buffered by the exchange's parity, and
// every caller keeps this invariant: a block passes a __syncthreads
// between its last read of exchange n and its first write of exchange
// n + 1, and every exchange reads at least one word of each of the S
// shards. A shard therefore writes parity p again (exchange n + 2) only
// after it read some word of every shard's exchange n + 1, which each
// shard wrote only after all its threads had finished reading exchange
// n. An exchange with nothing to send (no rows, an empty vector) is
// skipped by every shard alike and counts as none. A reader that finds a
// tag AHEAD of the one it waits for traps (a slot overwritten before it
// was read shows as a failure, never as a wrong value); a wait longer
// than kXchgTimeoutNs traps too, so a broken exchange ends the launch
// with an error instead of spinning forever. The slots start zeroed (tag
// 0, behind every exchange).
//
// The memory scope is a template parameter: device scope for the shards
// of one card (all this repository launches today); a launch over several
// cards needs system scope over peer memory (ROADMAP item 10), where the
// same protocol needs no fence either.
//
// Requires co-residency of the group's blocks (they wait on each other):
// the launches are cooperative.
//
// The calls that only a card can make go through a few named functions
// (xstore, xload, xclock, xtrap, xpause, xshared, xarrive, xacquire), defined
// here unless KARPENTER_XCHG_HOST is set: a CPU emulation
// (tests/cuda_emu/xchg_host.h) defines them instead.

#pragma once

#ifndef KARPENTER_XCHG_HOST
#include <cuda/atomic>
#include <cuda_runtime.h>
#endif
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
  static constexpr cuda::thread_scope kScope = Scope;
  unsigned long long* slots;  // [2][S][words] this group's flagged words, zeroed
  int s, S, words;            // this shard, the group's shards, slot width
  int c0;                     // global column of the block's first column
  unsigned gen;               // exchanges this block made so far
  unsigned nsh;               // results handed out through shared memory so far
};
using DeviceSplit = Split<cuda::thread_scope_device>;

constexpr unsigned long long kXchgTimeoutNs = 20ull * 1000 * 1000 * 1000;
constexpr unsigned kXchgPauseNs = 64;

#ifndef KARPENTER_XCHG_HOST
// one flagged word, stored with one 64-bit store at the group's scope
template <cuda::thread_scope Scope>
__device__ __forceinline__ void xstore(unsigned long long* p, unsigned long long v) {
  if constexpr (Scope == cuda::thread_scope_system)
    asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
  else
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <cuda::thread_scope Scope>
__device__ __forceinline__ unsigned long long xload(const unsigned long long* p) {
  unsigned long long v;
  if constexpr (Scope == cuda::thread_scope_system)
    asm volatile("ld.relaxed.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long xclock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void xtrap() { __trap(); }

// a poll's pause between two loads of word `p`, last seen holding `v`:
// it keeps a block's waiting threads from flooding L2 with loads that
// slow the shards still working
__device__ __forceinline__ void xpause(const unsigned long long*, unsigned long long) {
  __nanosleep(kXchgPauseNs);
}

// the block's shared variable of type T number `id`
template <class T, int id>
__device__ __forceinline__ T& xshared() {
  __shared__ T v;
  return v;
}

// a shard barrier's arrival (release) and its counter's value (acquire)
template <cuda::thread_scope Scope>
__device__ __forceinline__ void xarrive(unsigned* p) {
  if constexpr (Scope == cuda::thread_scope_system)
    asm volatile("red.release.sys.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
  else
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

template <cuda::thread_scope Scope>
__device__ __forceinline__ unsigned xacquire(const unsigned* p) {
  unsigned v;
  if constexpr (Scope == cuda::thread_scope_system)
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
#endif

// The exchange census of a phase-clock build (-DKARPENTER_PHASE_CLOCKS):
// block 0's thread 0 (shard 0, lane 0) adds, for each kind of exchange,
// the exchanges it made, the clock64() cycles it spent in them (its wait
// for the slowest shard included) and the block barriers they took, to
// g_xchg_census[3 * kind ..]; split B3's grid or shard barriers count
// as a kind of their own, and the opens the open loop made as another.
// pack_split.py's XCHG_KINDS names the kinds.
enum XKind {
  XK_ROWS,     // a step's opened rows' partial maxima (sweep_take)
  XK_OPEN,     // one exchange an open: every pool's fold (open_loop_split)
  XK_KEY1,     // ffd with reserved columns: the reserved pick key
  XK_CONF,     // split B3: a round's conflict words
  XK_BARRIER,  // split B3: the init and round barriers
  XK_OPENS,    // the opens made (not an exchange: the census's unit)
  XK_KINDS
};
#ifdef KARPENTER_PHASE_CLOCKS
__device__ unsigned long long g_xchg_census[3 * XK_KINDS];
struct XTimer {
  long long t0 = 0;
  bool on;
  __device__ explicit XTimer(bool who) : on(who && blockIdx.x == 0) {
    if (on) t0 = clock64();
  }
  __device__ void stop(int kind, int barriers) {
    if (on) {
      g_xchg_census[3 * kind] += 1;
      g_xchg_census[3 * kind + 1] += (unsigned long long)(clock64() - t0);
      g_xchg_census[3 * kind + 2] += (unsigned long long)barriers;
    }
  }
};
#else
struct XTimer {
  __device__ explicit XTimer(bool) {}
  __device__ void stop(int, int) {}
};
#endif

// ---- the words

template <class X>
__device__ __forceinline__ unsigned long long* xslot(const X& x, int par, int sh) {
  return x.slots + ((size_t)par * x.S + sh) * x.words;
}

__device__ __forceinline__ unsigned long long xword(unsigned tag, uint32_t datum) {
  return ((unsigned long long)tag << 32) | datum;
}

// The datum of word `p`, whose first load gave `v`, once the word
// carries `tag`: polls while it carries an earlier tag, traps on a later
// one or after kXchgTimeoutNs.
template <class X>
__device__ __noinline__ uint32_t xwait(const unsigned long long* p, unsigned long long v,
                                       unsigned tag) {
  const unsigned long long t0 = xclock();
  while (true) {
    const int ahead = (int)((unsigned)(v >> 32) - tag);
    if (ahead == 0) return (uint32_t)v;
    if (ahead > 0 || xclock() - t0 > kXchgTimeoutNs) xtrap();
    xpause(p, v);
    v = xload<X::kScope>(p);
  }
}

template <class X>
__device__ __forceinline__ uint32_t xready(const unsigned long long* p, unsigned long long v,
                                           unsigned tag) {
  return (unsigned)(v >> 32) == tag ? (uint32_t)v : xwait<X>(p, v, tag);
}

// The k words from `off` of each shard's slot of the exchange in flight,
// `f(sh, d)` called with their data d[k] in shard order; loads go out
// eight at a time, all before the first is checked.
template <int k, class X, class F>
__device__ __forceinline__ void xeach(const X& x, int off, F f) {
  constexpr int kBatch = 8 / k;
  const int par = x.gen & 1;
  const unsigned tag = x.gen + 1;
  for (int b = 0; b < x.S; b += kBatch) {
    unsigned long long v[kBatch][k];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (b + j < x.S) {
        const unsigned long long* p = xslot(x, par, b + j) + off;
#pragma unroll
        for (int i = 0; i < k; ++i) v[j][i] = xload<X::kScope>(p + i);
      }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (b + j < x.S) {
        const unsigned long long* p = xslot(x, par, b + j) + off;
        uint32_t d[k];
#pragma unroll
        for (int i = 0; i < k; ++i) d[i] = xready<X>(p + i, v[j][i], tag);
        f(b + j, d);
      }
  }
}

// this block's word `i` of the exchange in flight
template <class X>
__device__ __forceinline__ void xput(const X& x, int i, uint32_t datum) {
  xstore<X::kScope>(xslot(x, x.gen & 1, x.s) + i, xword(x.gen + 1, datum));
}

// ---- scalar exchanges: thread 0's value in, the combined value to all.
// Lane sh of warp 0 polls shard sh's word, the warp folds the S data in
// shard order with shuffles (`comb(acc, next)`), and one shared word and
// one block barrier hand the result to the block.
template <class X, class Comb>
__device__ uint32_t xscalar(X& x, uint32_t v, Comb comb) {
  uint32_t(&out)[2] = xshared<uint32_t[2], 0>();
  const int par = x.gen & 1, spar = x.nsh & 1;
  const unsigned tag = x.gen + 1;
  if (threadIdx.x == 0) xput(x, 0, v);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t acc = 0;
    for (int b = 0; b < x.S; b += 32) {
      const int sh = b + lane;
      uint32_t mine = 0;
      if (sh < x.S) {
        const unsigned long long* p = xslot(x, par, sh);
        mine = xready<X>(p, xload<X::kScope>(p), tag);
      }
      for (int j = 0; j < 32 && b + j < x.S; ++j) {
        const uint32_t y = __shfl_sync(0xffffffffu, mine, j);
        acc = b + j == 0 ? y : comb(acc, y);
      }
    }
    if (lane == 0) out[spar] = acc;
  }
  __syncthreads();  // also the barrier between this read and the next write
  ++x.gen;
  ++x.nsh;
  return out[spar];
}

template <class X>
__device__ int shard_sum_int(X& x, int v) {
  return (int)xscalar(x, (uint32_t)v, [](uint32_t a, uint32_t b) { return a + b; });
}

template <class X>
__device__ float shard_max_f32(X& x, float v) {
  return __uint_as_float(xscalar(x, __float_as_uint(v), [](uint32_t a, uint32_t b) {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }));
}

// Partial sums combined in shard order: ((p0 + p1) + p2) + ...
template <class X>
__device__ float shard_sum_f32(X& x, float v) {
  return __uint_as_float(xscalar(x, __float_as_uint(v), [](uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }));
}

// ---- vector exchanges: n 32-bit elements (n <= x.words), `put(i)` this
// shard's partial of element i; `comb(i, get)` then combines element i,
// `get(sh)` giving shard sh's datum. Strided over the block's threads on
// both sides; a thread polls the S shards' words of its element before
// it combines them (the first eight kept in registers).
template <class X, class Put, class Comb>
__device__ void shard_vec(X& x, int n, Put put, Comb comb) {
  if (n <= 0) return;  // nothing to send: every shard skips alike
  __syncthreads();     // the partials may come from other threads' writes
  for (int i = threadIdx.x; i < n; i += blockDim.x) xput(x, i, (uint32_t)put(i));
  const int par = x.gen & 1;
  const unsigned tag = x.gen + 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t first[8];
    xeach<1>(x, i, [&](int sh, const uint32_t* d) {
      if (sh < 8) first[sh] = d[0];
    });
    comb(i, [&](int sh) -> uint32_t {
      if (sh < 8) return first[sh];
      const unsigned long long* p = xslot(x, par, sh) + i;
      return xready<X>(p, xload<X::kScope>(p), tag);
    });
  }
  __syncthreads();  // the results are read by other threads; the next write
  ++x.gen;
}

// out[i] = ((p_0[i] + p_1[i]) + p_2[i]) + ..., the shards' partial sums
// in shard order (in place: `v` holds this shard's partials, then the
// totals)
template <class X>
__device__ void shard_sum_ordered(X& x, float* v, int n) {
  shard_vec(
      x, n, [&](int i) { return __float_as_uint(v[i]); },
      [&](int i, auto get) {
        float acc = __uint_as_float(get(0));
        for (int sh = 1; sh < x.S; ++sh) acc = __fadd_rn(acc, __uint_as_float(get(sh)));
        v[i] = acc;
      });
}

// ---- staged exchanges: each shard has written its words of the
// exchange in flight (xput, after a block barrier if other threads
// computed them); xstage copies words [lo, lo + m) of every shard into
// the block's shared buffer, shard sh's word lo + j at [sh * m + j]
// (S * m <= kStageWords), one thread a word, and after one block barrier
// every thread reads them there. Several stage rounds may read one
// exchange; xdone() ends it.
constexpr int kStageWords = 512;

template <class X>
__device__ const uint32_t* xstage(X& x, int lo, int m) {
  uint32_t(&buf)[2][kStageWords] = xshared<uint32_t[2][kStageWords], 1>();
  uint32_t* out = buf[x.nsh & 1];
  const int par = x.gen & 1;
  const unsigned tag = x.gen + 1;
  for (int t = threadIdx.x; t < x.S * m; t += blockDim.x) {
    const unsigned long long* p = xslot(x, par, t / m) + lo + t % m;
    out[t] = xready<X>(p, xload<X::kScope>(p), tag);
  }
  __syncthreads();  // also the barrier between this read and the next write
  ++x.nsh;
  return out;
}

template <class X>
__device__ __forceinline__ void xdone(X& x) {
  ++x.gen;
}

// ---- split B3's barrier per shard: joins the `n` blocks of one shard
// (its lanes) through a generation-counted counter in global memory,
// arriving with a release and waiting with an acquire. The counter
// starts at 0; the g-th barrier waits for g * n arrivals.
template <cuda::thread_scope Scope>
struct ShardBarrier {
  unsigned* count;
  unsigned n;
  unsigned gen;
  __device__ void operator()() {
    __syncthreads();
    ++gen;
    if (threadIdx.x == 0) {
      xarrive<Scope>(count);
      const unsigned target = gen * n;
      if ((int)(xacquire<Scope>(count) - target) < 0) {
        const unsigned long long t0 = xclock();
        while ((int)(xacquire<Scope>(count) - target) < 0)
          if (xclock() - t0 > kXchgTimeoutNs) xtrap();
      }
    }
    __syncthreads();
  }
};

}  // namespace

#ifdef KARPENTER_PHASE_CLOCKS
// copy the exchange census (3 * XK_KINDS counters) to host memory `out`
// and zero it
extern "C" int xchg_census_take(unsigned long long* out) {
  static const unsigned long long zero[3 * XK_KINDS] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_xchg_census, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_xchg_census, zero, sizeof(zero));
  return (int)err;
}
#endif
