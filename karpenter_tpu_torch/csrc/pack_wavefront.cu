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
// its own demand and retained bound rows. A cooperative grid cannot
// hold W blocks per lane for tens of lanes (132 co-resident blocks of
// 1024 threads on an H100), so each lane is one thread-block cluster of
// W blocks: the cluster barrier replaces the grid barrier, the lane is
// the cluster's index, and the block's rank in it is the plan lane.
// Clusters are scheduled whole, so lanes run in waves of the clusters
// that fit at once, and a lane's round count is its own (the JAX
// kernel's vmapped while_loop stops changing a lane's state once its
// condition is false). Plain version:
// pack_split.py::pack_probe_lanes_wavefront_ref.

#include <cooperative_groups.h>

#include "pack_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxW = 256;

// per-lane scalars of a plan, kLaneFields int32 each
enum LaneField {
  kCand, kValid, kSpill, kNOpen, kCappedSpend, kClamped, kUnschedAdd, kLast, kLaneFields
};

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
  template <class A, class X>
  __device__ void open_rows(const A& a, const X& x, int lo, int q, int ms, int rl, int cs,
                            int capped_star, const float* oh, const float* req) {
    const int lane = threadIdx.x & 31, nw = words_pad(a.C), R = a.R;
    for (int wd = threadIdx.x >> 5; wd < nw; wd += kWarps) {
      const int c = wd * 32 + lane;
      const uint32_t full = __ballot_sync(0xffffffffu, open_bit(a, x, c, ms, cs, capped_star));
      const uint32_t last = __ballot_sync(0xffffffffu, open_bit(a, x, c, rl, cs, capped_star));
      for (int i = lane; i < q; i += 32)
        o_bits[(size_t)(lo + i) * nw + wd] = i == q - 1 ? last : full;
      if (lane == 0) o_union[wd] |= last | (q > 1 ? full : 0u);
    }
    for (int i = threadIdx.x; i < q; i += kThreads) {
      const int fill = i == q - 1 ? rl : ms;
      const float ff = (float)fill;
      for (int r = 0; r < R; ++r)
        o_used[(size_t)(lo + i) * R + r] = __fadd_rn(oh[r], __fmul_rn(ff, req[r]));
      o_fill[lo + i] = fill;
    }
  }
};

// One solve's rounds, run by the W blocks that `barrier` joins; block
// w plans lane w. B3 joins the whole cooperative grid, B6 one cluster;
// split B3 (X = DeviceSplit) joins S x W blocks, `a` holding shard s's
// columns and replica and `x` lane w's exchange group. Each block keeps
// its own copy of the round's scalars (node count, round count,
// reservation use, committed groups) in shared memory and brings it up
// to date from the accepted lanes alike.
template <class X, class Barrier>
__device__ __forceinline__ void wavefront_body(Args a, const int w, X& x, Barrier barrier,
                                               unsigned char* smem) {
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

  const Smem sm = stage_tables(a, smem);
  const WaveLayout wl = wave_layout(C, R, a.P1, K, W, G, N);
  int32_t* s_lanes = (int32_t*)(smem + wl.lanes);
  uint32_t* s_conf = (uint32_t*)(smem + wl.conf);
  uint32_t* s_done = (uint32_t*)(smem + wl.done);
  int32_t* s_uoff = (int32_t*)(smem + wl.uoff);
  uint32_t* s_mconf = (uint32_t*)(smem + wl.mconf);
  int32_t* s_accept = (int32_t*)(smem + wl.accept);
  int32_t* s_offset = (int32_t*)(smem + wl.offset);
  uint32_t* s_touch = (uint32_t*)(smem + wl.touch);

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
  barrier();
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
        open_loop(a, x, rowbits, req, gcap, nc, N, sm.spend, &s_open, rows);
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
    barrier();
    clk.mark(7);

    // ================================================== 2. conflicts
    // lane i (< w) meets lane w when a row i fills is one w depends on
    // (capacity > 0 and, unless w spills, at or before w's last fill),
    // or a row i opens admits a config compatible with w. One pass: the
    // units (lane i's filled-row words, then its config words) spread
    // over the block, each hit ORed into this lane's conflict words.
    for (int i = tid; i < W * kLaneFields; i += kThreads) s_lanes[i] = __ldcg(a.lane + i);
    for (int i = tid; i < WW; i += kThreads) s_mconf[i] = 0u;
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
        // the config part of each test is this shard's: OR over shards
        shard_vec(
            x, WW, [&](int i) { return (unsigned long long)s_mconf[i]; },
            [&](int i, auto get) {
              unsigned long long hit = 0;
              for (int sh = 0; sh < x.S; ++sh) hit |= get(sh);
              a.conf[(size_t)w * WW + i] = (uint32_t)hit;
            });
      } else {
        for (int i = tid; i < WW; i += kThreads) a.conf[(size_t)w * WW + i] = s_mconf[i];
      }
    }
    clk.mark(8);
    barrier();
    clk.mark(9);

    // ================================================== 3. accept
    // every block: the lanes' conflict words into shared memory, the
    // greedy prefix scan there, and the round's scalars brought up to
    // date in each block's copy
    for (int i = tid; i < W * WW; i += kThreads) s_conf[i] = __ldcg(a.conf + i);
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
    barrier();
    clk.mark(12);
  }
  if (w == 0 && tid == 0) {
    *a.node_count = s_nc;
    *a.steps = s_steps;
  }
  mask_bytes(a.free_bits, C, s_nc - B, a.free_mask, w, W);
}

struct GridBarrier {
  __device__ void operator()() const { cg::this_grid().sync(); }
};

// The lanes' state lives in global memory: as the grid barrier does for
// B3, each block fences its writes device-wide before the barrier.
struct ClusterBarrier {
  __device__ void operator()() const {
    __threadfence();
    cg::this_cluster().sync();
  }
};

__global__ void __launch_bounds__(kThreads, 1) pack_wavefront_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  NoSplit x;
  wavefront_body(a, blockIdx.x, x, GridBarrier{}, smem);
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

// B6 wavefront: one cluster of W blocks per lane; the lane is the
// cluster's index and the block's rank in it is the plan lane.
__global__ void __launch_bounds__(kThreads, 1) pack_probe_wavefront_kernel(Args lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  NoSplit x;
  wavefront_body(lane_view(lanes, blockIdx.x / lanes.W), (int)cg::this_cluster().block_rank(), x,
                 ClusterBarrier{}, smem);
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
// exchange group has its own slots and counter.
__global__ void __launch_bounds__(kThreads, 1) pack_wavefront_sharded_kernel(
    Args base, ShardTable t, unsigned long long* slots, unsigned* arrive, int S, int words) {
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
  DeviceSplit x{slots + (size_t)w * 2 * S * words, arrive + w, s, S, words, s * a.C, 0u};
  wavefront_body(a, w, x, GridBarrier{}, smem);
}

// The dynamic shared memory a block takes: `smem` bytes, at least the
// layout's; the launch is refused above the card's limit.
static int set_smem(const void* kernel, int smem, int C, int R, int P1, int K, int W, int G,
                    int N) {
  if (smem < wave_layout(C, R, P1, K, W, G, N).end) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// L lanes, one thread-block cluster of W blocks each (grid W * L), the
// cluster barrier between phases. *max_clusters receives
// cudaOccupancyMaxActiveClusters for the launch; when it is 0 the
// launch is not made and cudaErrorInvalidConfiguration is returned. A
// cluster of more than 8 blocks needs the non-portable size, which the
// H100 allows up to 16.
static int launch_clusters(const Args& a, int W, int L, int smem, int* max_clusters,
                           cudaStream_t stream) {
  *max_clusters = 0;
  cudaError_t err = cudaFuncSetAttribute(
      pack_probe_wavefront_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)W;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(W * L));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // clusters run whole and barrier only among themselves, so lanes run
  // in waves of the clusters that fit at once; none fitting is an
  // error, not a reason to narrow the width
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)pack_probe_wavefront_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *max_clusters = n;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, pack_probe_wavefront_kernel, a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The wavefront scratch, in this order: free_used, bound_used,
// free_bits (state), kcap, take, touched, spend, o_bits, o_used,
// o_fill, o_union, lane, conf (per lane), shapes as in Args. `smem`:
// the dynamic shared memory of a block (wave_layout). One cooperative
// grid, the grid barrier between phases (one thread-block cluster with
// the cluster barrier measured slower at W = 16: PERF.md §6).
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
    cudaStream_t stream) {
  if (R > kMaxR || W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  int serr = set_smem((const void*)pack_wavefront_kernel, smem, C, R, P1, K, W, G, B + F);
  if (serr) return serr;
  Args a{compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, cfg_price,
         bound_quota, cfg_rsv, rsv_cap, group_cap, conflict,
         assign, free_mask, node_count, unsched, steps, widths,
         free_used, bound_used, free_bits,
         kcap, take, touched, spend, o_bits, o_used, o_fill, o_union, lane, conf,
         nullptr, nullptr, nullptr,
         G, C, R, B, F, K, P1, cost, W};
  void* params[] = {&a};
  // all W blocks must be resident at once for the grid barrier; the
  // runtime refuses the launch otherwise
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)pack_wavefront_kernel, dim3(W), dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// B6 wavefront: L lanes, each one thread-block cluster of W blocks
// (launch_clusters). group_count is [L, G] and bound_live [L, B]; every
// output, state and scratch array carries a leading lane axis of L.
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
    int* max_clusters, cudaStream_t stream) {
  *max_clusters = 0;
  if (R > kMaxR || W < 1 || W > kMaxW || L < 1) return (int)cudaErrorInvalidValue;
  int serr = set_smem((const void*)pack_probe_wavefront_kernel, smem, C, R, P1, K, W, G, B + F);
  if (serr) return serr;
  Args a{compat, group_req, lane_counts, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, lane_live, cfg_price,
         nullptr, cfg_rsv, rsv_cap, nullptr, conflict,
         assign, free_mask, node_count, unsched, steps, widths,
         free_used, bound_used, free_bits,
         kcap, take, touched, spend, o_bits, o_used, o_fill, o_union, lane, conf,
         nullptr, nullptr, nullptr,
         G, C, R, B, F, K, P1, cost, W};
  return launch_clusters(a, W, L, smem, max_clusters, stream);
}

// Split B3 over S shards of C columns each, W lanes: the six tables hold
// S device pointers each (compat, cfg_alloc, cfg_pool, cfg_price,
// cfg_rsv, free_mask); assign [S, B+F, G], node_count, steps [S],
// unsched, widths [S, G] and the state and plan scratch carry a leading
// shard axis; slots [W, 2, S, words] (words >= max(F, words_of(W)) and
// >= 4) and arrive [W] (zeroed) are the lanes' exchange groups. *per_sm
// and *sms receive the occupancy the card reports; when per_sm * sms <
// S * W the launch is not made (cudaErrorCooperativeLaunchTooLarge) and
// the caller raises with the numbers.
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
    unsigned long long* slots, unsigned* arrive,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int W, int S, int words,
    int smem, int* per_sm, int* sms, cudaStream_t stream) {
  *per_sm = 0;
  *sms = 0;
  if (R > kMaxR || W < 1 || W > kMaxW || S < 2 || words < F || words < words_of(W) ||
      words < 4)
    return (int)cudaErrorInvalidValue;
  int serr = set_smem((const void*)pack_wavefront_sharded_kernel, smem, C, R, P1, K, W, G, B + F);
  if (serr) return serr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, (const void*)pack_wavefront_sharded_kernel, kThreads, (size_t)smem);
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
  void* params[] = {&a, &t, &slots, &arrive, &S, &words};
  err = cudaLaunchCooperativeKernel((const void*)pack_wavefront_sharded_kernel, dim3(S * W),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
