// B3: the wavefront packing kernel — B1's function (grouped first-fit-
// decreasing over a split node axis) in rounds.
//
// Replaces karpenter_tpu/solver/pack.py:786 `pack_split_wavefront`.
// Plain version: karpenter_tpu_torch/solver/pack_split.py::
// pack_split_wavefront_ref, which this kernel matches byte for byte;
// its outputs equal B1's by the JAX package's contract.
//
// A round plans the next W uncommitted groups (one lane each) against
// the same pre-round state, accepts the longest prefix of lanes whose
// plans commute with the accepted lanes before them, and commits the
// accepted plans. It also returns `steps` (rounds run) and
// `widths[G]` (groups committed per round).
//
// What bounds it. Like B1, a dependent chain: each round reads the
// state the last one wrote, and a round's plan is one B1 group step.
// One cooperative launch per solve, a grid of W blocks of 1024 threads
// (block w plans lane w), three grid barriers a round. At 50k pods x
// 500 types (98 rounds, ~1.7 groups committed a round) a round takes
// ~37 us against a byte bound of 0.00045 ms for the whole launch
// (PERF.md §6). Block 0's phase clocks give the plan ~32% of a round
// (its sweep ~16%, its open ~11%), the wait at the first barrier ~25%
// (the slowest of the W plans), the other two barriers ~16%, the accept
// ~10%, the commit ~7% and the conflicts ~6%.
//
// The design:
//   1. plan — block w runs B1's group step for candidate cand[w] on the
//      pre-round state (pack_common.cuh: the tables, the groups' data
//      and the rows' capacities in shared memory, the sweep over mask
//      words, one scan for the takes); the opens go to the lane's own
//      slot-relative scratch (o_bits, o_used, o_fill) with its
//      reservation use in `spend` and whether the node axis bound an
//      open (`clamped`); the rows its take fills are kept as bits
//      (`touched`). The narrowed masks of those rows are not kept: the
//      lane alone writes them if it is accepted, so the commit narrows
//      them from the still-unchanged row;
//   2. conflicts — block j tests every earlier lane i in one pass: the
//      units (lane i's filled-row words, then its config words) are
//      spread over the block, and a hit sets bit i of the lane's
//      conflict words: does i fill a row j depends on, or open a row
//      with a config j could use;
//   3. accept and commit — every block loads the lanes' conflict words
//      next to their scalars and runs the greedy acceptance scan in
//      shared memory; each block keeps its own copy of the round's
//      scalars (node count, round count, reservation use, committed
//      groups as bits) and brings it up to date from the accepted
//      lanes; block 0 writes the outputs' tallies; each accepted block
//      writes its own rows, a thread a filled row. The accepted lanes
//      write disjoint rows, so no atomics are needed and every f32 add
//      has one nonzero addend. Opened rows land at offset - B + slot
//      directly (the JAX kernel's roll never wraps for an accepted
//      lane).
// A round's candidates come from a ballot and popcount rank over the
// committed bits, 32 words a pass; no thread walks the groups. Measured
// and not kept: one thread-block cluster with the cluster barrier in
// place of the grid at W = 16 (slower), each block's own copy of the
// row state in shared memory (slower).
// Rejected lanes' planning is work the algorithm chooses, not work the
// inputs need: B3's bound is B1's on the same inputs.
//
// Exactness as in B1 (pack_common.cuh): index-tie-broken
// arg-reductions with order-independent atomicMin on packed keys, f32
// intrinsics in the JAX order, -fmad=false, clipping before int casts.
//
// B6, wavefront route: the same rounds over a lane axis
// (karpenter_tpu/solver/pack.py:1227 `pack_probe_lanes_flat` with
// wavefront W > 1), each lane a probe of the consolidation search with
// its own demand and retained bound rows, and a round count of its own
// (the JAX kernel's vmapped while_loop stops changing a lane's state once
// its condition is false). Plain version:
// pack_split.py::pack_probe_lanes_wavefront_ref. A lane is one block of
// 1024 threads (`lane_wavefront_body`), so a dispatch's lanes (64 on the
// consolidation path) are on the card at once, and its barriers are block
// barriers. A round's plans are made one after another in lane order,
// and each is tested against the accepted plans before it as soon as it
// is made: the acceptance scan keeps the longest prefix that passes, so
// the first plan that fails ends the round, and a lane plans its
// accepted groups plus at most one a round where B3's grid plans W. What
// bounds it: each plan is one of B1's group steps (its sweep, scan and
// open loop, ~7 block barriers besides the opens), in a chain; the lane
// with the most groups sets the dispatch's time. The earlier design, a
// thread-block cluster of W blocks a lane (B3's body, the cluster barrier
// for the grid's), ran its lanes in waves of 7 clusters and planned W
// groups a round (PERF.md §6).
//
// B8, split B3 (karpenter_tpu/solver/pack.py:1817-1893 with the
// wavefront): `pack_wavefront_sharded_kernel`, S x W blocks, block
// s * W + w planning lane w on shard s's columns with shard s's replica.
// Lane w's S blocks exchange (shard_xchg.cuh) the plan's rows' partial
// maxima and one exchange an open; the lanes' conflict words cross the
// shards as flagged words read in the accept; the round's three barriers
// join one shard's W blocks. Plain version:
// pack_shard.py::pack_split_wavefront_sharded_ref.

#include <cooperative_groups.h>

#include "pack_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxW = 256;

// per-lane scalars of a plan, kLaneFields int32 each
enum LaneField {
  kCand, kValid, kSpill, kNOpen, kCappedSpend, kClamped, kUnschedAdd, kLast, kLaneFields
};
static_assert(kLaneFields == kWaveLaneFields, "the placement sizes B3's lane scalars");

struct Args {
  const uint8_t* compat;        // [G, C]
  const float* group_req;       // [G, R]
  const int32_t* group_count;   // [G]
  const float* cfg_alloc;       // [C, R]
  const int32_t* cfg_pool;      // [C]
  const float* pool_overhead;   // [P1, R]
  const uint8_t* bound_compat;  // [G, B]
  const float* bound_alloc;     // [B, R]
  const float* bound_used0;     // [B, R]
  const int32_t* bound_slot;    // [B]
  const uint8_t* bound_live;    // [B]
  const float* cfg_price;       // [C]
  const int16_t* bound_quota;   // [B, G] or null
  const int32_t* cfg_rsv;       // [C]
  const float* rsv_cap;         // [K]
  const int32_t* group_cap;     // [G] or null
  const uint8_t* conflict;      // [G, G] or null
  int32_t* assign;              // [B+F, G], zeroed
  uint8_t* free_mask;           // [F, C], zeroed
  int32_t* node_count;          // scalar
  int32_t* unsched;             // [G], zeroed
  int32_t* steps;               // scalar
  int32_t* widths;              // [G]
  // shared state
  float* free_used;             // [F, R]
  float* bound_used;            // [B, R]
  uint32_t* free_bits;          // [F, words_pad(C)]: the fresh masks
  // per-lane scratch
  int32_t* kcap;                // [W, B+F]
  int32_t* take;                // [W, B+F] (rows in `touched` only)
  uint32_t* touched;            // [W, words_of(B+F)]: rows the lane's take fills
  float* spend;                 // [W, K+1]
  uint32_t* o_bits;             // [W, F, words_pad(C)]: the lane's opened rows
  float* o_used;                // [W, F, R]
  int32_t* o_fill;              // [W, F]
  uint32_t* o_union;            // [W, words_pad(C)]: their configs
  int32_t* lane;                // [W, kLaneFields]
  uint32_t* conf;               // [W, words_of(W)]: bit i of lane j's words: i meets j
  // in the block's shared memory (stage_tables)
  float* rsv_used;              // [K+1]
  int32_t* kopen;               // [C]
  uint8_t* fits;                // [C]
  int G, C, R, B, F, K, P1, cost, W;
};

// B3's shared memory after the tables (table_layout): the W lanes'
// scalars and conflict words, the committed groups as bits, the
// conflict pass's unit offsets, this lane's conflict words, the
// acceptance scan's verdicts and offsets, and the rows this lane's take
// fills, as bits (published to `touched` after the take)
struct WaveLayout {
  int lanes, conf, done, uoff, mconf, accept, offset, touch, end;
};

__host__ __device__ inline WaveLayout wave_layout(int C, int R, int P1, int K, int W, int G,
                                                  int N) {
  WaveLayout l;
  int o = table_layout(C, R, P1, K, G).end;
  l.lanes = o; o += align16(4 * W * kLaneFields);
  l.conf = o; o += align16(4 * W * words_of(W));
  l.done = o; o += align16(4 * words_of(G));
  l.uoff = o; o += align16(4 * (W + 1));
  l.mconf = o; o += align16(4 * words_of(W));
  l.accept = o; o += align16(4 * W);
  l.offset = o; o += align16(4 * W);
  l.touch = o; o += align16(4 * words_of(N));
  l.end = o;
  return l;
}

// B3: a plan's opened rows, slot-relative in the lane's scratch, with
// their configs' union
struct PlanRows {
  uint32_t* o_bits;
  float* o_used;
  int32_t* o_fill;
  uint32_t* o_union;
  template <int kT = kThreads, class A, class X>
  __device__ void open_rows(const A& a, const X& x, int lo, int q, int ms, int rl, int cs,
                            int capped_star, const float* oh, const float* req) {
    const int lane = threadIdx.x & 31, nw = words_pad(a.C), R = a.R;
    for (int wd = threadIdx.x >> 5; wd < nw; wd += kT / 32) {
      const int c = wd * 32 + lane;
      const uint32_t full = __ballot_sync(0xffffffffu, open_bit(a, x, c, ms, cs, capped_star));
      const uint32_t last = __ballot_sync(0xffffffffu, open_bit(a, x, c, rl, cs, capped_star));
      for (int i = lane; i < q; i += 32)
        o_bits[(size_t)(lo + i) * nw + wd] = i == q - 1 ? last : full;
      if (lane == 0) o_union[wd] |= last | (q > 1 ? full : 0u);
    }
    for (int i = threadIdx.x; i < q; i += kT) {
      const int fill = i == q - 1 ? rl : ms;
      const float ff = (float)fill;
      for (int r = 0; r < R; ++r)
        o_used[(size_t)(lo + i) * R + r] = __fadd_rn(oh[r], __fmul_rn(ff, req[r]));
      o_fill[lo + i] = fill;
    }
  }
};

// One solve's rounds, run by the W blocks that `barrier` joins; block
// w plans lane w. B3 joins the whole cooperative grid, split B3 (X = DeviceSplit) the W blocks of one shard, `a` holding
// shard s's columns and replica, `x` lane w's exchange group and
// `xconf` [2][W][S][words_of(W)] the lanes' conflict words as flagged
// words (null unsplit). Each block keeps
// its own copy of the round's scalars (node count, round count,
// reservation use, committed groups) in shared memory and brings it up
// to date from the accepted lanes alike.
// A barrier of the rounds, timed in the census when the body is split.
template <class X, class Barrier>
__device__ __forceinline__ void xbarrier(const X&, Barrier& barrier) {
  if constexpr (X::kSplit) {
    XTimer xt(threadIdx.x == 0);
    barrier();
    xt.stop(XK_BARRIER, 0);
  } else {
    barrier();
  }
}

template <bool kSpilled, class X, class Barrier>
__device__ __forceinline__ void wavefront_body(Args a, const int w, X& x, Barrier barrier,
                                               unsigned char* smem, const Placement& p,
                                               unsigned long long* xconf = nullptr) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.G, C = a.C, R = a.R, B = a.B, F = a.F, K = a.K, W = a.W;
  const int N = B + F;
  const int nw = words_pad(C), NW = words_of(N), WW = words_of(W), GW = words_of(G);

  __shared__ OpenState s_open;
  __shared__ int s_go, s_nc, s_steps, s_cand, s_last, s_nacc, s_shift;
  PhaseClock clk;
  clk.begin();

  const Smem sm = stage<kSpilled>(a, smem, p);
  WaveLayout wl;
  if constexpr (kSpilled) {
    // the round's bookkeeping stays in shared memory; the filled rows'
    // bits where the placement puts them
    wl = WaveLayout{p.off[SG_LANES], p.off[SG_CONF], p.off[SG_DONE], p.off[SG_UOFF],
                    p.off[SG_MCONF], p.off[SG_ACCEPT], p.off[SG_OFFSET], 0, 0};
  } else {
    wl = wave_layout(C, R, a.P1, K, W, G, N);
  }
  int32_t* s_lanes = (int32_t*)(smem + wl.lanes);
  uint32_t* s_conf = (uint32_t*)(smem + wl.conf);
  uint32_t* s_done = (uint32_t*)(smem + wl.done);
  int32_t* s_uoff = (int32_t*)(smem + wl.uoff);
  uint32_t* s_mconf = (uint32_t*)(smem + wl.mconf);
  int32_t* s_accept = (int32_t*)(smem + wl.accept);
  int32_t* s_offset = (int32_t*)(smem + wl.offset);
  uint32_t* s_touch;
  if constexpr (kSpilled) s_touch = (uint32_t*)seg_at(p, SG_TOUCH, smem);
  else s_touch = (uint32_t*)(smem + wl.touch);

  int32_t* kcap = a.kcap + (size_t)w * N;
  int32_t* take = a.take + (size_t)w * N;
  uint32_t* touched = a.touched + (size_t)w * NW;
  float* spend = a.spend + (size_t)w * (K + 1);
  uint32_t* o_bits = a.o_bits + (size_t)w * F * nw;
  float* o_used = a.o_used + (size_t)w * F * R;
  int32_t* o_fill = a.o_fill + (size_t)w * F;
  uint32_t* o_union = a.o_union + (size_t)w * nw;
  int32_t* mine = a.lane + (size_t)w * kLaneFields;

  // ---- state init: the shared state grid-stride, each block's copy
  // of the scalars (reservation use of bound rows: integer-valued float
  // adds, exact in any order; groups without demand committed)
  {
    const int gt = w * kThreads + tid;
    const int gs = W * kThreads;
    for (int i = gt; i < B * R; i += gs) a.bound_used[i] = a.bound_used0[i];
    for (int i = gt; i < F * R; i += gs) a.free_used[i] = 0.0f;
    for (int i = gt; i < F * nw; i += gs) a.free_bits[i] = 0u;
    for (int g = gt; g < G; g += gs) a.widths[g] = 0;
    for (int b = tid; b < B; b += kThreads) {
      const int s = a.bound_slot[b];
      if (a.bound_live[b] && s < K) atomicAdd(&a.rsv_used[s], 1.0f);
    }
    for (int wd = warp; wd < GW; wd += kWarps) {
      const int g = wd * 32 + lane;
      const unsigned d = __ballot_sync(0xffffffffu, g >= G || a.group_count[g] <= 0);
      if (lane == 0) s_done[wd] = d;
    }
    if (tid == 0) {
      s_nc = B;
      s_steps = 0;
    }
  }
  xbarrier(x, barrier);
  clk.mark(0);

  while (true) {
    // ---- round start: this lane's candidate, the w-th uncommitted
    // group in index order (a ballot and popcount rank over the
    // committed bits, 32 words a pass)
    if (warp == 0) {
      int seen = 0, cand = G;
      for (int base = 0; base < GW; base += 32) {
        const uint32_t undone = base + lane < GW ? ~s_done[base + lane] : 0u;
        const int cnt = __popc(undone);
        int incl = cnt;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        const int total = __shfl_sync(0xffffffffu, incl, 31);
        const int need = w - seen;
        if (cand == G && need < total) {
          const unsigned who = __ballot_sync(0xffffffffu, incl > need && incl - cnt <= need);
          const int src = __ffs(who) - 1;
          int c = 0;
          if (lane == src) c = (base + lane) * 32 + (int)__fns(undone, 0, need - (incl - cnt) + 1);
          cand = __shfl_sync(0xffffffffu, c, src);
        }
        seen += total;
      }
      if (lane == 0) {
        s_cand = cand;
        s_go = seen > 0 && s_steps < G;
      }
    }
    __syncthreads();
    if (!s_go) break;
    clk.mark(1);
    clk.count();
    const int nc = s_nc;
    const int round = s_steps;
    const int g = s_cand;
    const bool valid = g < G;
    const float* req = sm.greq + (size_t)(valid ? g : 0) * R;
    const uint32_t* rowbits = sm.gbits + (size_t)(valid ? g : 0) * nw;

    // ================================================== 1. plan
    if (valid) {
      for (int s = tid; s <= K; s += kThreads) sm.spend[s] = 0.0f;
      for (int wd = tid; wd < nw; wd += kThreads) o_union[wd] = 0u;
      for (int wd = tid; wd < words_of(nc); wd += kThreads) s_touch[wd] = 0u;
      if (tid == 0) s_last = -1;
      __syncthreads();
      const int remaining0 = sm.gcount[g];
      const int gcap = a.group_cap ? a.group_cap[g] : kIntBig;

      // ---- capacities and the prefix take over rows [0, nc); the
      // rows it fills are kept for the commit and the conflict test
      int my_last = -1;
      const long long placed = sweep_take(
          a, x, sm, a.free_bits, rowbits, g, req, gcap, nc - B, (long long)remaining0, kcap,
          false, [&](int n, int t) {
            take[n] = t;
            atomicOr(&s_touch[n >> 5], 1u << (n & 31));
            my_last = n;
          },
          clk, 2);
      // sweep_take ended on a barrier: the filled rows' bits are whole
      for (int wd = tid; wd < words_of(nc); wd += kThreads) touched[wd] = s_touch[wd];
      my_last = __reduce_max_sync(0xffffffffu, my_last);
      if (lane == 0 && my_last >= 0) atomicMax(&s_last, my_last);
      const int remaining = remaining0 - (int)placed;
      if (tid == 0) s_open = OpenState{remaining, 0, 0};

      // ---- the open loop, slot-relative
      if (remaining > 0) {
        PlanRows rows{o_bits, o_used, o_fill, o_union};
        open_loop<kSpilled>(a, x, sm.pools, rowbits, req, gcap, nc, N, sm.spend, &s_open, rows);
      }
      clk.mark(5);
      int my_capped = 0;
      for (int s = tid; s <= K; s += kThreads) {
        spend[s] = sm.spend[s];
        my_capped |= s < K && sm.spend[s] > 0.0f;
      }
      my_capped = __syncthreads_or(my_capped);
      if (tid == 0) {
        mine[kCand] = g;
        mine[kValid] = 1;
        mine[kSpill] = remaining > 0;
        mine[kNOpen] = s_open.nopen;
        mine[kCappedSpend] = my_capped;
        mine[kClamped] = s_open.clamped;
        mine[kUnschedAdd] = max(s_open.remaining, 0);
        mine[kLast] = s_last;
      }
    } else if (tid == 0) {
      mine[kCand] = G;
      mine[kValid] = 0;
    }
    clk.mark(6);
    xbarrier(x, barrier);
    clk.mark(7);

    // ================================================== 2. conflicts
    // lane i (< w) meets lane w when a row i fills is one w depends on
    // (capacity > 0 and, unless w spills, at or before w's last fill),
    // or a row i opens admits a config compatible with w. One pass: the
    // units (lane i's filled-row words, then its config words) spread
    // over the block, each hit ORed into this lane's conflict words.
    for (int i = tid; i < W * kLaneFields; i += kThreads) s_lanes[i] = __ldcg(a.lane + i);
    for (int i = tid; i < WW; i += kThreads) s_mconf[i] = 0u;
    if constexpr (X::kSplit)
      for (int i = tid; i < W * WW; i += kThreads) s_conf[i] = 0u;
    __syncthreads();
    if (tid == 0) {
      int o = 0;
      for (int i = 0; i < W; ++i) {
        s_uoff[i] = o;
        const int32_t* li = s_lanes + i * kLaneFields;
        if (li[kValid]) o += (li[kLast] >= 0 ? (li[kLast] >> 5) + 1 : 0) + nw;
      }
      s_uoff[W] = o;
    }
    __syncthreads();
    if (valid) {
      const int spill = s_lanes[w * kLaneFields + kSpill];
      const int last = s_lanes[w * kLaneFields + kLast];
      for (int u = tid; u < s_uoff[w]; u += kThreads) {
        // the lane of unit u: the last i < w whose units start at or before it
        int lo = 0, hi = w;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_uoff[mid] <= u) lo = mid;
          else hi = mid;
        }
        const int i = lo, k = u - s_uoff[i];
        const int last_i = s_lanes[i * kLaneFields + kLast];
        const int nwi = last_i >= 0 ? (last_i >> 5) + 1 : 0;
        bool hit = false;
        if (k < nwi) {
          uint32_t t = __ldcg(a.touched + (size_t)i * NW + k);
          while (t && !hit) {
            const int n = k * 32 + __ffs(t) - 1;
            t &= t - 1;
            hit = kcap[n] > 0 && (spill || n <= last);
          }
        } else {
          hit = (__ldcg(a.o_union + (size_t)i * nw + (k - nwi)) & rowbits[k - nwi]) != 0u;
        }
        if (hit) atomicOr(&s_mconf[i >> 5], 1u << (i & 31));
      }
      __syncthreads();
      if constexpr (X::kSplit) {
        // the config part of each test is this shard's: its words go out
        // as flagged words tagged by the round, and every block ORs the
        // S shards' words of every lane in its accept, after the barrier
        // (no exchange of their own). Reuse: a block writes the round
        // r + 2 words of its parity only after its accept of round r + 1
        // read every shard's round r + 1 words, which each shard wrote
        // after its barrier 3 of round r, after all its accepts of round
        // r had read theirs.
        unsigned long long* mine = xconf + (((size_t)(round & 1) * W + w) * x.S + x.s) * WW;
        for (int i = tid; i < WW; i += kThreads)
          xstore<X::kScope>(mine + i, xword((unsigned)round + 1, s_mconf[i]));
      } else {
        for (int i = tid; i < WW; i += kThreads) a.conf[(size_t)w * WW + i] = s_mconf[i];
      }
    }
    clk.mark(8);
    xbarrier(x, barrier);
    clk.mark(9);

    // ================================================== 3. accept
    // every block: the lanes' conflict words into shared memory, the
    // greedy prefix scan there, and the round's scalars brought up to
    // date in each block's copy
    if constexpr (X::kSplit) {
      // every valid lane's conflict words, ORed over the S shards
      XTimer xt(tid == 0);
      const unsigned long long* all = xconf + (size_t)(round & 1) * W * x.S * WW;
      for (int t = tid; t < W * x.S * WW; t += kThreads) {
        const int j = t / (x.S * WW);
        if (!s_lanes[j * kLaneFields + kValid]) continue;
        const uint32_t v = xready<X>(all + t, xload<X::kScope>(all + t), (unsigned)round + 1);
        if (v) atomicOr(&s_conf[j * WW + t % WW], v);
      }
      xt.stop(XK_CONF, 0);
    } else {
      for (int i = tid; i < W * WW; i += kThreads) s_conf[i] = __ldcg(a.conf + i);
    }
    __syncthreads();
    if (tid == 0) {
      int shift = 0, nacc = 0, acc_capped = 0, stopped = 0;
      for (int j = 0; j < W; ++j) {
        const int32_t* lj = s_lanes + j * kLaneFields;
        int accept = !stopped && lj[kValid];
        for (int k = 0; accept && k < WW; ++k)
          if (s_conf[j * WW + k]) accept = 0;
        if (accept && lj[kSpill])
          accept = !acc_capped &&
                   (shift == 0 || (!lj[kClamped] && (long long)nc + shift + lj[kNOpen] <= N));
        s_accept[j] = accept;
        s_offset[j] = nc + shift;
        if (accept) {
          acc_capped |= lj[kCappedSpend];
          shift += lj[kNOpen];
          ++nacc;
        } else {
          stopped = 1;
        }
      }
      s_nacc = nacc;
      s_shift = shift;
    }
    __syncthreads();
    const int nacc = s_nacc;
    for (int s = tid; s <= K; s += kThreads) {
      float tot = 0.0f;
      for (int j = 0; j < nacc; ++j)
        tot = __fadd_rn(tot, __ldcg(a.spend + (size_t)j * (K + 1) + s));
      a.rsv_used[s] = __fadd_rn(a.rsv_used[s], tot);
    }
    for (int j = tid; j < nacc; j += kThreads) {
      const int32_t* lj = s_lanes + j * kLaneFields;
      const int cj = lj[kCand];
      atomicOr(&s_done[cj >> 5], 1u << (cj & 31));
      if (w == 0) a.unsched[cj] = lj[kUnschedAdd];  // a group commits once
    }
    if (tid == 0) {
      if (w == 0) a.widths[s_steps] = nacc;
      s_steps += 1;
      s_nc = nc + s_shift;
    }
    clk.mark(10);

    // ================================================== commit
    // an accepted lane writes its rows: the filled ones (a thread a
    // row; narrowed on the row as the round found it) and the opened
    // ones at their place on the node axis. The accepted lanes write
    // disjoint rows, so no atomics are needed and every f32 add has one
    // nonzero addend.
    const long long t_apply = clk.now();
    unsigned applied = 0;
    if (valid && s_accept[w]) {
      const int last = s_lanes[w * kLaneFields + kLast];
      for (int n = tid; n <= last; n += kThreads)
        if ((s_touch[n >> 5] >> (n & 31)) & 1u) {
          apply_take(a, rowbits, a.free_bits, n, g, req, take[n]);
          ++applied;
        }
      const int lo = s_offset[w] - B;
      const int n_open = s_lanes[w * kLaneFields + kNOpen];
      for (int i = tid; i < n_open * nw; i += kThreads)
        a.free_bits[(size_t)lo * nw + i] |= o_bits[i];
      for (int i = tid; i < n_open; i += kThreads) {
        float* used = a.free_used + (size_t)(lo + i) * R;
        for (int r = 0; r < R; ++r) used[r] = __fadd_rn(used[r], o_used[(size_t)i * R + r]);
        a.assign[(size_t)(B + lo + i) * G + g] = o_fill[i];  // opened this round
      }
    }
    const unsigned apply_cycles = (unsigned)(clk.now() - t_apply);
    clk.mark(11);
    clk.spread(kSpreadSlot + 6, kSpreadSlot + 7, apply_cycles);
    clk.spread(kSpreadSlot + 8, kSpreadSlot + 9, applied);
    xbarrier(x, barrier);
    clk.mark(12);
  }
  if (w == 0 && tid == 0) {
    *a.node_count = s_nc;
    *a.steps = s_steps;
  }
  mask_bytes(a.free_bits, C, s_nc - B, a.free_mask, w, W);
}

// lane l's slice of every per-lane array: its demand and live rows,
// its outputs, its state and its plan scratch
__device__ __forceinline__ Args lane_view(Args a, int l) {
  const size_t L = (size_t)l;
  const size_t N = (size_t)a.B + a.F;
  const size_t W = (size_t)a.W;
  const size_t nw = (size_t)words_pad(a.C);
  a.group_count += L * a.G;
  a.bound_live += L * a.B;
  a.assign += L * N * a.G;
  a.free_mask += L * a.F * a.C;
  a.node_count += L;
  a.unsched += L * a.G;
  a.steps += L;
  a.widths += L * a.G;
  a.free_used += L * a.F * a.R;
  a.bound_used += L * a.B * a.R;
  a.free_bits += L * a.F * nw;
  a.kcap += L * W * N;
  a.take += L * W * N;
  a.touched += L * W * words_of((int)N);
  a.spend += L * W * (a.K + 1);
  a.o_bits += L * W * a.F * nw;
  a.o_used += L * W * a.F * a.R;
  a.o_fill += L * W * a.F;
  a.o_union += L * W * nw;
  a.lane += L * W * kLaneFields;
  a.conf += L * W * words_of(a.W);
  return a;
}

// B6 wavefront: one lane's rounds in one block (the lane is the block's
// index). A round's candidates are planned one after another in lane
// order against the round's state, each as B3's block w plans lane w,
// and each plan is tested against the accepted plans before it as soon
// as it is made: the acceptance scan takes the longest prefix of lanes
// that pass, so the first plan that fails ends the round's planning (the
// plans after it would be rejected whatever they held). The accepted
// plans are committed as B3 commits them. Outputs as the cluster of W
// blocks gave them: the same rounds, widths and rows. Block barriers
// only; each plan lane's scratch is the lane's slice of B3's arrays.
template <bool kSpilled>
__device__ void lane_wavefront_body(Args a, unsigned char* smem, const Placement& p) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.G, C = a.C, R = a.R, B = a.B, F = a.F, K = a.K, W = a.W;
  const int N = B + F;
  const int nw = words_pad(C), NW = words_of(N), GW = words_of(G);

  __shared__ OpenState s_open;
  __shared__ int s_go, s_nc, s_steps, s_last, s_nacc, s_shift;
  PhaseClock clk;
  clk.begin();
  NoSplit x;

  const Smem sm = stage<kSpilled>(a, smem, p);
  WaveLayout wl;
  if constexpr (kSpilled) {
    wl = WaveLayout{p.off[SG_LANES], p.off[SG_CONF], p.off[SG_DONE], p.off[SG_UOFF],
                    p.off[SG_MCONF], p.off[SG_ACCEPT], p.off[SG_OFFSET], 0, 0};
  } else {
    wl = wave_layout(C, R, a.P1, K, W, G, N);
  }
  int32_t* s_lanes = (int32_t*)(smem + wl.lanes);
  uint32_t* s_done = (uint32_t*)(smem + wl.done);
  int32_t* s_uoff = (int32_t*)(smem + wl.uoff);
  int32_t* s_offset = (int32_t*)(smem + wl.offset);
  uint32_t* s_touch;
  if constexpr (kSpilled) s_touch = (uint32_t*)seg_at(p, SG_TOUCH, smem);
  else s_touch = (uint32_t*)(smem + wl.touch);

  // ---- state init (reservation use of bound rows: integer-valued
  // float adds, exact in any order; groups without demand committed)
  for (int i = tid; i < B * R; i += kThreads) a.bound_used[i] = a.bound_used0[i];
  for (int i = tid; i < F * R; i += kThreads) a.free_used[i] = 0.0f;
  for (int i = tid; i < F * nw; i += kThreads) a.free_bits[i] = 0u;
  for (int g = tid; g < G; g += kThreads) a.widths[g] = 0;
  for (int b = tid; b < B; b += kThreads) {
    const int s = a.bound_slot[b];
    if (a.bound_live[b] && s < K) atomicAdd(&a.rsv_used[s], 1.0f);
  }
  for (int wd = warp; wd < GW; wd += kWarps) {
    const int g = wd * 32 + lane;
    const unsigned d = __ballot_sync(0xffffffffu, g >= G || a.group_count[g] <= 0);
    if (lane == 0) s_done[wd] = d;
  }
  if (tid == 0) {
    s_nc = B;
    s_steps = 0;
  }
  __syncthreads();
  clk.mark(0);

  while (true) {
    // ---- round start: the candidates, the first W uncommitted groups in
    // index order (G past the last), from a popcount rank over the
    // committed bits, 32 words a pass
    if (warp == 0) {
      int seen = 0;
      for (int base = 0; base < GW; base += 32) {
        uint32_t undone = base + lane < GW ? ~s_done[base + lane] : 0u;
        const int cnt = __popc(undone);
        int incl = cnt;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        for (int rank = seen + incl - cnt; undone && rank < W; ++rank) {
          s_lanes[rank * kLaneFields + kCand] = (base + lane) * 32 + __ffs(undone) - 1;
          undone &= undone - 1;
        }
        seen += __shfl_sync(0xffffffffu, incl, 31);
      }
      for (int j = seen + lane; j < W; j += 32) s_lanes[j * kLaneFields + kCand] = G;
      if (lane == 0) {
        s_go = seen > 0 && s_steps < G;
        s_uoff[0] = 0;
      }
    }
    __syncthreads();
    if (!s_go) break;
    clk.mark(1);
    clk.count();
    const int nc = s_nc;

    // ================================================== plans, in lane order
    int nacc = 0, shift = 0, acc_capped = 0;
    for (int j = 0; j < W; ++j) {
      int32_t* mine = s_lanes + j * kLaneFields;
      const int g = mine[kCand];
      if (g >= G) break;  // no candidate: rejected, and so every later lane
      const float* req = sm.greq + (size_t)g * R;
      const uint32_t* rowbits = sm.gbits + (size_t)g * nw;
      int32_t* kcap = a.kcap + (size_t)j * N;
      int32_t* take = a.take + (size_t)j * N;
      uint32_t* touched = a.touched + (size_t)j * NW;
      uint32_t* o_union = a.o_union + (size_t)j * nw;

      // ---- 1. plan: B3's, on the round's state
      for (int s = tid; s <= K; s += kThreads) sm.spend[s] = 0.0f;
      for (int wd = tid; wd < nw; wd += kThreads) o_union[wd] = 0u;
      for (int wd = tid; wd < words_of(nc); wd += kThreads) s_touch[wd] = 0u;
      if (tid == 0) s_last = -1;
      __syncthreads();
      const int remaining0 = sm.gcount[g];
      const int gcap = a.group_cap ? a.group_cap[g] : kIntBig;
      int my_last = -1;
      const long long placed = sweep_take(
          a, x, sm, a.free_bits, rowbits, g, req, gcap, nc - B, (long long)remaining0, kcap,
          false, [&](int n, int t) {
            take[n] = t;
            atomicOr(&s_touch[n >> 5], 1u << (n & 31));
            my_last = n;
          },
          clk, 2);
      // sweep_take ended on a barrier: the filled rows' bits are whole
      for (int wd = tid; wd < words_of(nc); wd += kThreads) touched[wd] = s_touch[wd];
      my_last = __reduce_max_sync(0xffffffffu, my_last);
      if (lane == 0 && my_last >= 0) atomicMax(&s_last, my_last);
      const int remaining = remaining0 - (int)placed;
      if (tid == 0) s_open = OpenState{remaining, 0, 0};
      if (remaining > 0) {
        PlanRows rows{a.o_bits + (size_t)j * F * nw, a.o_used + (size_t)j * F * R,
                      a.o_fill + (size_t)j * F, o_union};
        open_loop<kSpilled>(a, x, sm.pools, rowbits, req, gcap, nc, N, sm.spend, &s_open, rows);
      }
      clk.mark(5);
      int my_capped = 0;
      float* spend = a.spend + (size_t)j * (K + 1);
      for (int s = tid; s <= K; s += kThreads) {
        spend[s] = sm.spend[s];
        my_capped |= s < K && sm.spend[s] > 0.0f;
      }
      my_capped = __syncthreads_or(my_capped);
      const int spill = remaining > 0;
      const int last = s_last;
      const int nopen = s_open.nopen, clamped = s_open.clamped;
      if (tid == 0) {
        mine[kValid] = 1;
        mine[kSpill] = spill;
        mine[kNOpen] = nopen;
        mine[kCappedSpend] = my_capped;
        mine[kClamped] = clamped;
        mine[kUnschedAdd] = max(s_open.remaining, 0);
        mine[kLast] = last;
      }
      clk.mark(6);

      // ---- 2. conflicts with the accepted lanes i < j: a row i fills
      // that j depends on (capacity > 0 and, unless j spills, at or
      // before j's last fill), or a row i opens that admits a config
      // compatible with j; the units (lane i's filled-row words, then its
      // config words) spread over the block
      bool hit = false;
      const int units = s_uoff[j];
      for (int u = tid; u < units && !hit; u += kThreads) {
        int lo = 0, hi = j;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_uoff[mid] <= u) lo = mid;
          else hi = mid;
        }
        const int i = lo, k = u - s_uoff[i];
        const int last_i = s_lanes[i * kLaneFields + kLast];
        const int nwi = last_i >= 0 ? (last_i >> 5) + 1 : 0;
        if (k < nwi) {
          uint32_t t = a.touched[(size_t)i * NW + k];
          while (t && !hit) {
            const int n = k * 32 + __ffs(t) - 1;
            t &= t - 1;
            hit = kcap[n] > 0 && (spill || n <= last);
          }
        } else {
          hit = (a.o_union[(size_t)i * nw + (k - nwi)] & rowbits[k - nwi]) != 0u;
        }
      }
      const int conflicted = __syncthreads_or(hit);
      clk.mark(8);

      // ---- 3. the acceptance scan's step for lane j
      int accept = !conflicted;
      if (accept && spill)
        accept = !acc_capped && (shift == 0 || (!clamped && (long long)nc + shift + nopen <= N));
      if (!accept) break;
      if (tid == 0) {
        s_offset[j] = nc + shift;
        s_uoff[j + 1] = units + (last >= 0 ? (last >> 5) + 1 : 0) + nw;
      }
      acc_capped |= my_capped;
      shift += nopen;
      ++nacc;
      clk.mark(10);
    }
    __syncthreads();  // the accepted lanes' offsets and scalars are whole

    // ---- the round's tallies, as B3's accept brings them up to date
    for (int s = tid; s <= K; s += kThreads) {
      float tot = 0.0f;
      for (int j = 0; j < nacc; ++j) tot = __fadd_rn(tot, a.spend[(size_t)j * (K + 1) + s]);
      a.rsv_used[s] = __fadd_rn(a.rsv_used[s], tot);
    }
    for (int j = tid; j < nacc; j += kThreads) {
      const int32_t* lj = s_lanes + j * kLaneFields;
      const int cj = lj[kCand];
      atomicOr(&s_done[cj >> 5], 1u << (cj & 31));
      a.unsched[cj] = lj[kUnschedAdd];  // a group commits once
    }
    if (tid == 0) {
      a.widths[s_steps] = nacc;
      s_steps += 1;
      s_nc = nc + shift;
    }

    // ================================================== commit
    // the accepted lanes' rows: the filled ones (narrowed on the row as
    // the round found it) and the opened ones at their place on the node
    // axis. The accepted lanes write disjoint rows, so no barrier between
    // lanes and no atomics; every f32 add has one nonzero addend.
    for (int j = 0; j < nacc; ++j) {
      const int32_t* lj = s_lanes + j * kLaneFields;
      const int g = lj[kCand], last = lj[kLast], n_open = lj[kNOpen];
      const float* req = sm.greq + (size_t)g * R;
      const uint32_t* rowbits = sm.gbits + (size_t)g * nw;
      const uint32_t* touched = a.touched + (size_t)j * NW;
      const int32_t* take = a.take + (size_t)j * N;
      for (int n = tid; n <= last; n += kThreads)
        if ((touched[n >> 5] >> (n & 31)) & 1u) apply_take(a, rowbits, a.free_bits, n, g, req, take[n]);
      const int lo = s_offset[j] - B;
      const uint32_t* o_bits = a.o_bits + (size_t)j * F * nw;
      const float* o_used = a.o_used + (size_t)j * F * R;
      const int32_t* o_fill = a.o_fill + (size_t)j * F;
      for (int i = tid; i < n_open * nw; i += kThreads)
        a.free_bits[(size_t)lo * nw + i] |= o_bits[i];
      for (int i = tid; i < n_open; i += kThreads) {
        float* used = a.free_used + (size_t)(lo + i) * R;
        for (int r = 0; r < R; ++r) used[r] = __fadd_rn(used[r], o_used[(size_t)i * R + r]);
        a.assign[(size_t)(B + lo + i) * G + g] = o_fill[i];  // opened this round
      }
    }
    __syncthreads();
    clk.mark(11);
  }
  if (tid == 0) {
    *a.node_count = s_nc;
    *a.steps = s_steps;
  }
  mask_bytes(a.free_bits, C, s_nc - B, a.free_mask, 0, 1);
}

struct GridBarrier {
  __device__ void operator()() const { cg::this_grid().sync(); }
};
using DeviceShardBarrier = ShardBarrier<cuda::thread_scope_device>;

template <bool kSpilled>
__global__ void __launch_bounds__(kThreads, 1) pack_wavefront_kernel(Args a, Placement p) {
  extern __shared__ __align__(16) unsigned char smem[];
  NoSplit x;
  wavefront_body<kSpilled>(a, blockIdx.x, x, GridBarrier{}, smem, p);
}

// B6 wavefront: a block a lane (lane_wavefront_body).
template <bool kSpilled>
__global__ void __launch_bounds__(kThreads, 1) pack_probe_wavefront_kernel(Args lanes,
                                                                           Placement p) {
  extern __shared__ __align__(16) unsigned char smem[];
  lane_wavefront_body<kSpilled>(lane_view(lanes, blockIdx.x), smem, p);
}

// n block barriers of kThreads threads in a row: the cost of one
// barrier on its own, which bounds from below a lane's chain of
// barriers (chip_smoke.py times it)
__global__ void __launch_bounds__(kThreads, 1) wave_barrier_probe_kernel(int n, int* sink) {
  int v = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    v ^= i;
  }
  if (v == -1) *sink = v;
}

// per-shard pointers of a split solve's config-axis arrays
struct ShardTable {
  const uint8_t* const* compat;    // [G, Cs] each
  const float* const* cfg_alloc;   // [Cs, R]
  const int32_t* const* cfg_pool;  // [Cs]
  const float* const* cfg_price;   // [Cs]
  const int32_t* const* cfg_rsv;   // [Cs]
  uint8_t* const* free_mask;       // [F, Cs] out
};

// Split B3: block s * W + w plans lane w on shard s; every replicated
// output, state and plan array carries a leading shard axis (the
// shard-local bit rows too: every shard has Cs columns); lane w's
// exchange group has its own slots.
//
// The round's barriers join the W blocks of one shard, not the S x W
// of the grid. They order only what a shard's own blocks write and
// read: the state (usage, assignment, mask words), the plan scratch
// (kcap, take, o_bits, o_used, o_fill), `lane`, `conf`, `touched`,
// `o_union` and `spend` all carry the shard axis (below; the conflict
// words cross shards as flagged words, `xconf`); rsv_used, the
// committed groups and the round's scalars live in each block's shared
// memory; the init and the final mask_bytes stride over the shard's W
// blocks and its own arrays. Shards meet only in their lanes' exchanges
// (shard_xchg.cuh), which carry their own order. A shard's barrier is a
// counter in global memory (`ShardBarrier`: release on arrival, acquire
// on the wait; measured faster than the grid barrier at S = 2, 4 and 8,
// PERF.md §6); the launch stays cooperative for co-residency.
template <bool kSpilled>
__global__ void __launch_bounds__(kThreads, 1) pack_wavefront_sharded_kernel(
    Args base, ShardTable t, unsigned long long* slots, unsigned long long* xconf,
    unsigned* bars, int S, int words, Placement p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x / base.W;
  const int w = blockIdx.x % base.W;
  Args a = base;
  const size_t N = (size_t)a.B + a.F;
  const size_t W = (size_t)a.W;
  const size_t nw = (size_t)words_pad(a.C);
  a.assign += s * N * a.G;
  a.node_count += s;
  a.unsched += s * a.G;
  a.steps += s;
  a.widths += s * a.G;
  a.free_used += s * a.F * a.R;
  a.bound_used += s * a.B * a.R;
  a.free_bits += s * a.F * nw;
  a.kcap += s * W * N;
  a.take += s * W * N;
  a.touched += s * W * words_of((int)N);
  a.spend += s * W * (a.K + 1);
  a.o_bits += s * W * a.F * nw;
  a.o_used += s * W * a.F * a.R;
  a.o_fill += s * W * a.F;
  a.o_union += s * W * nw;
  a.lane += s * W * kLaneFields;
  a.conf += s * W * words_of(a.W);
  a.compat = t.compat[s];
  a.cfg_alloc = t.cfg_alloc[s];
  a.cfg_pool = t.cfg_pool[s];
  a.cfg_price = t.cfg_price[s];
  a.cfg_rsv = t.cfg_rsv[s];
  a.free_mask = t.free_mask[s];
  DeviceSplit x{slots + (size_t)w * 2 * S * words, s, S, words, s * a.C, 0u, 0u};
  wavefront_body<kSpilled>(a, w, x, DeviceShardBarrier{bars + s, (unsigned)a.W, 0u}, smem, p,
                         xconf);
}

// The dynamic shared memory a block takes: `smem` bytes, at least the
// layout's when the launch is all shared (a split one of at most kXPools
// pools), else what the placement puts there (`placed`, checked by
// check_placement); the launch is refused above the card's limit.
static int set_smem(const void* kernel, int smem, int C, int R, int P1, int K, int W, int G,
                    int N, bool pools, const Placement* placed) {
  if (placed ? check_placement(*placed, C, R, P1, K, G, pools, W, N, smem)
             : smem < wave_layout(C, R, P1, K, W, G, N).end || (pools && P1 > kXPools))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// L lanes, a block each. *lanes_at_once receives the blocks of the
// launch the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the multiprocessors); when it is 0 the launch is not made and
// cudaErrorInvalidConfiguration is returned.
template <bool kSpilled>
static int launch_lanes(const Args& a, const Placement& p, int L, int smem, int* lanes_at_once,
                        cudaStream_t stream) {
  *lanes_at_once = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pack_probe_wavefront_kernel<kSpilled>, kThreads, (size_t)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *lanes_at_once = per_sm * sms;
  if (*lanes_at_once < 1) return (int)cudaErrorInvalidConfiguration;
  pack_probe_wavefront_kernel<kSpilled><<<L, kThreads, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The wavefront scratch, in this order: free_used, bound_used,
// free_bits (state), kcap, take, touched, spend, o_bits, o_used,
// o_fill, o_union, lane, conf (per lane), shapes as in Args. `smem`:
// the dynamic shared memory of a block (wave_layout); `placement`: null
// for an all-shared launch, else SG_COUNT segment offsets
// (table_placement) with `tables` holding block_bytes a block. One
// cooperative grid, the grid barrier between phases (one thread-block
// cluster with the cluster barrier measured slower at W = 16: PERF.md
// §6).
extern "C" int pack_wavefront_launch(
    const uint8_t* compat, const float* group_req, const int32_t* group_count,
    const float* cfg_alloc, const int32_t* cfg_pool, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* bound_live, const float* cfg_price,
    const int16_t* bound_quota, const int32_t* cfg_rsv, const float* rsv_cap,
    const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, uint8_t* free_mask, int32_t* node_count, int32_t* unsched,
    int32_t* steps, int32_t* widths,
    float* free_used, float* bound_used, uint32_t* free_bits,
    int32_t* kcap, int32_t* take, uint32_t* touched, float* spend,
    uint32_t* o_bits, float* o_used, int32_t* o_fill, uint32_t* o_union,
    int32_t* lane, uint32_t* conf,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int W, int smem,
    const int* placement, unsigned char* tables, long long block_bytes, cudaStream_t stream) {
  if (R > kMaxR || W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  Placement p = make_placement(placement, tables, block_bytes);
  const void* kernel = placement ? (const void*)pack_wavefront_kernel<true>
                                 : (const void*)pack_wavefront_kernel<false>;
  int serr = set_smem(kernel, smem, C, R, P1, K, W, G, B + F, false, placement ? &p : nullptr);
  if (serr) return serr;
  Args a{compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, cfg_price,
         bound_quota, cfg_rsv, rsv_cap, group_cap, conflict,
         assign, free_mask, node_count, unsched, steps, widths,
         free_used, bound_used, free_bits,
         kcap, take, touched, spend, o_bits, o_used, o_fill, o_union, lane, conf,
         nullptr, nullptr, nullptr,
         G, C, R, B, F, K, P1, cost, W};
  void* params[] = {&a, &p};
  // all W blocks must be resident at once for the grid barrier; the
  // runtime refuses the launch otherwise
  cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(W), dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// B6 wavefront: L lanes, a block each (launch_lanes). group_count is
// [L, G] and bound_live [L, B]; every output, state and scratch array
// carries a leading lane axis of L (the scratch's W plan lanes a lane;
// `lane` and `conf` are not used). A spilled placement's scratch holds
// block_bytes a lane.
extern "C" int pack_probe_wavefront_launch(
    const uint8_t* compat, const float* group_req, const int32_t* lane_counts,
    const float* cfg_alloc, const int32_t* cfg_pool, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* lane_live, const float* cfg_price,
    const int32_t* cfg_rsv, const float* rsv_cap, const uint8_t* conflict,
    int32_t* assign, uint8_t* free_mask, int32_t* node_count, int32_t* unsched,
    int32_t* steps, int32_t* widths,
    float* free_used, float* bound_used, uint32_t* free_bits,
    int32_t* kcap, int32_t* take, uint32_t* touched, float* spend,
    uint32_t* o_bits, float* o_used, int32_t* o_fill, uint32_t* o_union,
    int32_t* lane, uint32_t* conf,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int W, int L, int smem,
    const int* placement, unsigned char* tables, long long block_bytes, int* lanes_at_once,
    cudaStream_t stream) {
  *lanes_at_once = 0;
  if (R > kMaxR || W < 1 || W > kMaxW || L < 1) return (int)cudaErrorInvalidValue;
  Placement p = make_placement(placement, tables, block_bytes);
  const void* kernel = placement ? (const void*)pack_probe_wavefront_kernel<true>
                                 : (const void*)pack_probe_wavefront_kernel<false>;
  int serr = set_smem(kernel, smem, C, R, P1, K, W, G, B + F, false, placement ? &p : nullptr);
  if (serr) return serr;
  Args a{compat, group_req, lane_counts, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, lane_live, cfg_price,
         nullptr, cfg_rsv, rsv_cap, nullptr, conflict,
         assign, free_mask, node_count, unsched, steps, widths,
         free_used, bound_used, free_bits,
         kcap, take, touched, spend, o_bits, o_used, o_fill, o_union, lane, conf,
         nullptr, nullptr, nullptr,
         G, C, R, B, F, K, P1, cost, W};
  return placement ? launch_lanes<true>(a, p, L, smem, lanes_at_once, stream)
                   : launch_lanes<false>(a, p, L, smem, lanes_at_once, stream);
}

extern "C" int wave_barrier_probe_launch(int n, int* sink, cudaStream_t stream) {
  wave_barrier_probe_kernel<<<1, kThreads, 0, stream>>>(n, sink);
  return (int)cudaGetLastError();
}

// Split B3 over S shards of C columns each, W lanes: the six tables hold
// S device pointers each (compat, cfg_alloc, cfg_pool, cfg_price,
// cfg_rsv, free_mask); assign [S, B+F, G], node_count, steps [S],
// unsched, widths [S, G] and the state and plan scratch carry a leading
// shard axis; slots [W, 2, S, words] (zeroed; words >= max(2F,
// 4 P1, words_of(W)) and >= 4) are the lanes' exchange groups, xconf
// [2, W, S, words_of(W)] (zeroed) their conflict words and bars [S]
// (zeroed) the shards' barrier counters; any P1. `placement`, `tables`,
// `block_bytes` as pack_wavefront_launch's (a block a shard's plan
// lane). *per_sm and *sms receive the
// occupancy the card reports; when per_sm * sms < S * W the launch is
// not made (cudaErrorCooperativeLaunchTooLarge) and the caller raises
// with the numbers.
extern "C" int pack_wavefront_sharded_launch(
    const uint8_t* const* compat, const float* const* cfg_alloc,
    const int32_t* const* cfg_pool, const float* const* cfg_price,
    const int32_t* const* cfg_rsv, uint8_t* const* free_mask,
    const float* group_req, const int32_t* group_count, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* bound_live, const int16_t* bound_quota,
    const float* rsv_cap, const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, int32_t* node_count, int32_t* unsched, int32_t* steps,
    int32_t* widths,
    float* free_used, float* bound_used, uint32_t* free_bits,
    int32_t* kcap, int32_t* take, uint32_t* touched, float* spend,
    uint32_t* o_bits, float* o_used, int32_t* o_fill, uint32_t* o_union,
    int32_t* lane, uint32_t* conf,
    unsigned long long* slots, unsigned long long* xconf, unsigned* bars,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int W, int S, int words,
    int smem, const int* placement, unsigned char* tables, long long block_bytes, int* per_sm,
    int* sms, cudaStream_t stream) {
  *per_sm = 0;
  *sms = 0;
  if (R > kMaxR || W < 1 || W > kMaxW || S < 2 || words < 2 * F || words < 4 * P1 ||
      words < words_of(W) || words < 4)
    return (int)cudaErrorInvalidValue;
  Placement p = make_placement(placement, tables, block_bytes);
  const void* kernel = placement ? (const void*)pack_wavefront_sharded_kernel<true>
                                 : (const void*)pack_wavefront_sharded_kernel<false>;
  int serr = set_smem(kernel, smem, C, R, P1, K, W, G, B + F, true, placement ? &p : nullptr);
  if (serr) return serr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, (size_t)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if ((long long)*per_sm * *sms < (long long)S * W) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args a{nullptr, group_req, group_count, nullptr, nullptr, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, nullptr,
         bound_quota, nullptr, rsv_cap, group_cap, conflict,
         assign, nullptr, node_count, unsched, steps, widths,
         free_used, bound_used, free_bits,
         kcap, take, touched, spend, o_bits, o_used, o_fill, o_union, lane, conf,
         nullptr, nullptr, nullptr,
         G, C, R, B, F, K, P1, cost, W};
  ShardTable t{compat, cfg_alloc, cfg_pool, cfg_price, cfg_rsv, free_mask};
  void* params[] = {&a, &t, &slots, &xconf, &bars, &S, &words, &p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(S * W), dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
