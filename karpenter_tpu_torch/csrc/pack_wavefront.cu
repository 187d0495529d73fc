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
// The work per round is small (at 50k pods x 500 types: ~1.5k rows x
// Cp = 224 configs x R = 4), so bytes and operations are far below what
// the chain of rounds costs in latency. The design shortens the chain
// instead: one cooperative launch per solve (never one per round), a
// grid of W blocks of 1024 threads, block w planning lane w, with the
// state in global memory (it stays in L2) and three grid barriers a
// round:
//   1. plan — block w runs B1's group step for candidate cand[w] on
//      the pre-round state: bound-row and opened-fresh-row capacities,
//      the prefix take, and the open loop, whose opens go to the lane's
//      own slot-relative scratch (o_mask, o_used, o_fill) with its
//      reservation use in `spend` and whether the node axis bound an
//      open (`clamped`). The narrowed masks of rows the lane fills are
//      not kept: the lane alone writes those rows if it is accepted,
//      so the commit narrows them from the still-unchanged row;
//   2. conflicts — block j tests each earlier lane i: does i fill a row
//      j depends on, or open a row with a config j could use; one
//      byte of a W x W matrix per pair, computed in parallel;
//   3. accept and commit — one thread per block walks the W-long
//      acceptance scan over scalars (shift, accepted reservation use,
//      stop flag, offsets); block 0 commits the round's scalars (node
//      count, reservation use, unschedulable counts, done flags,
//      widths, steps); each accepted block writes its own rows. The
//      accepted lanes write disjoint rows, so no atomics are needed
//      and every f32 add has one nonzero addend. Opened rows land at
//      offset - B + slot directly (the JAX kernel's roll never wraps
//      for an accepted lane).
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
  kCand, kValid, kSpill, kNOpen, kCappedSpend, kClamped, kUnschedAdd,
  kScanEnd, kLast, kLaneFields
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
  float* rsv_used;              // [K+1]
  uint8_t* done;                // [G]
  // per-lane scratch
  int32_t* kcap;                // [W, B+F]
  int32_t* take;                // [W, B+F]
  uint8_t* fits;                // [W, C]
  int32_t* kopen;               // [W, C]
  float* spend;                 // [W, K+1]
  uint8_t* o_mask;              // [W, F, C]
  float* o_used;                // [W, F, R]
  int32_t* o_fill;              // [W, F]
  uint8_t* o_union;             // [W, C]
  int32_t* lane;                // [W, kLaneFields]
  uint8_t* conf;                // [W, W]: lane i's plan meets lane j's
  int G, C, R, B, F, K, P1, cost, W;
};

// One solve's rounds, run by the W blocks that `barrier` joins; block
// w plans lane w. B3 joins the whole cooperative grid, B6 one cluster;
// split B3 (X = DeviceSplit) joins S x W blocks, `a` holding shard s's
// columns and replica and `x` lane w's exchange group.
template <class X, class Barrier>
__device__ __forceinline__ void wavefront_body(const Args& a, const int w, X& x, Barrier barrier) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.G, C = a.C, R = a.R, B = a.B, F = a.F, K = a.K, W = a.W;
  const int N = B + F;

  __shared__ float s_req[kMaxR];
  __shared__ float s_oh[kMaxR];
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_total;
  __shared__ long long s_carry;
  __shared__ int s_go, s_nc, s_steps, s_cand;
  __shared__ int s_remaining, s_scan_end, s_last, s_spill, s_nopen, s_clamped;
  __shared__ int s_pool, s_any;
  __shared__ unsigned long long s_key0, s_key1, s_key2;
  __shared__ uint32_t s_minu;
  __shared__ int s_cstar, s_mstar, s_q, s_remlast, s_slot, s_capped;
  __shared__ unsigned long long s_pay0, s_pay1, s_pay2;
  __shared__ int s_hit[kMaxW];
  __shared__ int s_accept[kMaxW];
  __shared__ int s_offset[kMaxW];
  __shared__ int s_nacc, s_shift;

  int32_t* kcap = a.kcap + (size_t)w * N;
  int32_t* take = a.take + (size_t)w * N;
  uint8_t* fits = a.fits + (size_t)w * C;
  int32_t* kopen = a.kopen + (size_t)w * C;
  float* spend = a.spend + (size_t)w * (K + 1);
  uint8_t* o_mask = a.o_mask + (size_t)w * F * C;
  float* o_used = a.o_used + (size_t)w * F * R;
  int32_t* o_fill = a.o_fill + (size_t)w * F;
  uint8_t* o_union = a.o_union + (size_t)w * C;
  int32_t* mine = a.lane + (size_t)w * kLaneFields;

  // ---- state init, grid-stride
  {
    const int gt = w * kThreads + tid;
    const int gs = W * kThreads;
    for (int i = gt; i < B * R; i += gs) a.bound_used[i] = a.bound_used0[i];
    for (int i = gt; i < F * R; i += gs) a.free_used[i] = 0.0f;
    for (int g = gt; g < G; g += gs) {
      a.done[g] = a.group_count[g] <= 0 ? 1 : 0;
      a.widths[g] = 0;
    }
    if (w == 0 && tid == 0) {
      for (int s = 0; s <= K; ++s) a.rsv_used[s] = 0.0f;
      for (int b = 0; b < B; ++b) {
        int s = a.bound_slot[b];
        if (a.bound_live[b] && s < K) a.rsv_used[s] = __fadd_rn(a.rsv_used[s], 1.0f);
      }
      *a.node_count = B;
      *a.steps = 0;
    }
  }
  barrier();

  while (true) {
    // ---- round start: the state's scalars and this lane's candidate,
    // the w-th uncommitted group in index order
    if (tid == 0) {
      int rank = 0, cand = G, any = 0;
      for (int g = 0; g < G; ++g) {
        if (a.done[g]) continue;
        any = 1;
        if (rank == w) {
          cand = g;
          break;
        }
        ++rank;
      }
      s_nc = *a.node_count;
      s_steps = *a.steps;
      s_go = any && s_steps < G;
      s_cand = cand;
    }
    __syncthreads();
    if (!s_go) break;
    const int nc = s_nc;
    const int g = s_cand;
    const bool valid = g < G;
    const uint8_t* row = a.compat + (size_t)(valid ? g : 0) * C;

    // ================================================== 1. plan
    if (valid) {
      if (tid == 0) s_remaining = a.group_count[g];
      if (tid < R) s_req[tid] = a.group_req[(size_t)g * R + tid];
      for (int s = tid; s <= K; s += kThreads) spend[s] = 0.0f;
      for (int c = tid; c < C; c += kThreads) o_union[c] = 0;
      __syncthreads();
      const int remaining0 = s_remaining;
      const int gcap = a.group_cap ? a.group_cap[g] : kIntBig;
      const int nfresh = nc - B;

      // ---- bound-row capacity, thread per row
      for (int b = tid; b < B; b += kThreads) {
        int kb = capacity(a.bound_alloc + (size_t)b * R, a.bound_used + (size_t)b * R, s_req, R);
        bool ok = a.bound_compat[(size_t)g * B + b] && a.bound_live[b] && kb >= 1;
        kb = ok ? kb : 0;
        if (a.bound_quota) kb = min(kb, (int)a.bound_quota[(size_t)b * G + g]);
        if (a.group_cap) kb = min(kb, max(gcap - a.assign[(size_t)b * G + g], 0));
        if (a.conflict && blocked(a, b, g)) kb = 0;
        kcap[b] = kb;
      }
      // ---- fresh-row capacity, warp per opened row
      for (int f = warp; f < nfresh; f += kWarps) {
        const uint8_t* mrow = a.free_mask + (size_t)f * C;
        const float* used = a.free_used + (size_t)f * R;
        unsigned any_pin = 0, any_pin_ok = 0;
        int max_ok = 0, max_pin = 0;
        for (int c = lane; c < C; c += 32) {
          if (!mrow[c]) continue;
          bool capped = a.cfg_rsv[c] >= 0;
          any_pin |= capped;
          if (!row[c]) continue;
          int k = capacity(a.cfg_alloc + (size_t)c * R, used, s_req, R);
          if (k < 1) continue;
          max_ok = max(max_ok, k);
          if (capped) {
            any_pin_ok = 1;
            max_pin = max(max_pin, k);
          }
        }
        any_pin = __reduce_or_sync(0xffffffffu, any_pin);
        any_pin_ok = __reduce_or_sync(0xffffffffu, any_pin_ok);
        max_ok = __reduce_max_sync(0xffffffffu, max_ok);
        max_pin = __reduce_max_sync(0xffffffffu, max_pin);
        if (lane == 0) {
          if constexpr (X::kSplit) {
            const uint32_t pin = any_pin ? (uint32_t)(max_pin + 1) : 0u;
            xmine(x)[f] = ((unsigned long long)pin << 32) | (uint32_t)max_ok;
          } else {
            int kf = any_pin ? (any_pin_ok ? max_pin : 0) : max_ok;
            if (a.group_cap) kf = min(kf, max(gcap - a.assign[(size_t)(B + f) * G + g], 0));
            if (a.conflict && blocked(a, B + f, g)) kf = 0;
            kcap[B + f] = kf;
          }
        }
      }
      if constexpr (X::kSplit) {
        // the opened rows' partials, combined over the lane's shards
        xpublish(x);
        for (int f = tid; f < nfresh; f += kThreads) {
          uint32_t pin = 0, ok = 0;
          for (int sh = 0; sh < x.S; ++sh) {
            const unsigned long long v = __ldcg(xtheirs(x, sh) + f);
            pin = max(pin, (uint32_t)(v >> 32));
            ok = max(ok, (uint32_t)(v & 0xffffffffull));
          }
          int kf = pin > 0 ? (int)(pin - 1) : (int)ok;
          if (a.group_cap) kf = min(kf, max(gcap - a.assign[(size_t)(B + f) * G + g], 0));
          if (a.conflict && blocked(a, B + f, g)) kf = 0;
          kcap[B + f] = kf;
        }
      }
      if (tid == 0) {
        s_carry = 0;
        s_scan_end = B + nfresh;
        s_last = -1;
      }
      __syncthreads();

      // ---- prefix take over rows [0, nc) in index order; the last
      // row it fills is kept for the lane's dependence rows
      const long long r = (long long)remaining0;
      for (int base = 0; base < nc; base += kThreads) {
        const int n = base + tid;
        long long kc = 0;
        if (n < nc) kc = min((long long)kcap[n], r);
        long long incl = block_scan(kc, s_warp, &s_total);
        long long prefix = s_carry + incl - kc;
        if (prefix > r) prefix = r;
        if (n < nc) {
          int t = (int)min(r - prefix, kc);
          take[n] = t;
          if (t > 0) atomicMax(&s_last, n);
        }
        __syncthreads();
        if (tid == 0) {
          s_carry += s_total;
          if (s_carry >= r) s_scan_end = min(base + kThreads, nc);
        }
        __syncthreads();
        if (s_carry >= r) break;
      }
      if (tid == 0) {
        s_remaining = remaining0 - (int)min(s_carry, r);
        s_spill = s_remaining > 0;
        s_nopen = 0;
        s_clamped = 0;
      }
      __syncthreads();

      // ---- the open loop, slot-relative
      if (s_remaining > 0) {
        for (int c = tid; c < C; c += kThreads) {
          int p = a.cfg_pool[c];
          uint8_t ok = row[c] && p >= 0;
          if (ok) {
            const float* oh = a.pool_overhead + (size_t)p * R;
            const float* al = a.cfg_alloc + (size_t)c * R;
            for (int q = 0; q < R; ++q)
              if (!(oh[q] <= __fsub_rn(al[q], s_req[q]))) { ok = 0; break; }
          }
          fits[c] = ok;
        }
        __syncthreads();
        while (true) {
          if (tid == 0) {
            s_any = 0;
            s_pool = kIntBig;
          }
          __syncthreads();
          // configs that can still open with this lane's reservation
          // use on top of the round's, and their lowest pool
          int my_pool = kIntBig;
          int my_any = 0;
          for (int c = tid; c < C; c += kThreads) {
            if (!fits[c]) continue;
            int s = slot_of(a, c);
            if (__fadd_rn(a.rsv_used[s], spend[s]) < cap_ext(a, s)) {
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
            const int pool = shard_min_int(x, s_any ? s_pool : kIntBig);
            if (tid == 0) {
              s_pool = pool;
              s_any = pool < kIntBig;
            }
            __syncthreads();
          }
          if (!(s_remaining > 0 && s_any && nc + s_nopen < N)) {
            // leaving with demand left and a willing config means the
            // node axis was full: that decision read node_count too
            if (tid == 0 && s_remaining > 0 && s_any) s_clamped = 1;
            break;
          }
          const int pool = s_pool;
          if (tid < R) s_oh[tid] = a.pool_overhead[(size_t)pool * R + tid];
          if (tid == 0) {
            s_key0 = ~0ull;
            s_key1 = ~0ull;
            s_key2 = ~0ull;
            s_minu = float_key(kBig);
          }
          __syncthreads();
          unsigned long long k0 = ~0ull;
          uint32_t mu = float_key(kBig);
          for (int c = tid; c < C; c += kThreads) {
            int kf = 0;
            if (fits[c] && a.cfg_pool[c] == pool) {
              int s = slot_of(a, c);
              if (__fadd_rn(a.rsv_used[s], spend[s]) < cap_ext(a, s))
                kf = capacity(a.cfg_alloc + (size_t)c * R, s_oh, s_req, R);
            }
            kopen[c] = kf;
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
              unsigned long long k[1] = {s_key0}, pay[1] = {0};
              if (tid == 0 && k[0] != ~0ull) {
                const int c = (int)(k[0] & 0xffffffffull) - x.c0;
                pay[0] = open_payload(kopen[c], slot_of(a, c));
              }
              shard_min_keys(x, k, pay);
              if (tid == 0) {
                s_key0 = k[0];
                s_pay0 = pay[0];
              }
            } else {
              const uint32_t m = shard_min_u32(x, s_minu);
              if (tid == 0) s_minu = m;
            }
            __syncthreads();
          }
          if (!a.cost) {
            unsigned long long k1 = ~0ull, k2 = ~0ull;
            const float min_uncapped = key_float(s_minu);
            for (int c = tid; c < C; c += kThreads) {
              int kf = kopen[c];
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
              unsigned long long k[2] = {s_key1, s_key2}, pay[2] = {0, 0};
              if (tid == 0) {
                for (int i = 0; i < 2; ++i) {
                  if (k[i] == ~0ull) continue;
                  const int c = (int)(k[i] & 0xffffffffull) - x.c0;
                  pay[i] = open_payload(kopen[c], slot_of(a, c));
                }
              }
              shard_min_keys(x, k, pay);
              if (tid == 0) {
                s_key1 = k[0];
                s_key2 = k[1];
                s_pay1 = pay[0];
                s_pay2 = pay[1];
              }
              __syncthreads();
            }
          }
          if (tid == 0) {
            int cs;
            if (a.cost) cs = (int)(s_key0 & 0xffffffffull);
            else cs = (int)(((s_key1 != ~0ull) ? s_key1 : s_key2) & 0xffffffffull);
            int rem = s_remaining;
            // split: c*'s capacity and slot came with its key
            unsigned long long pay = 0;
            if constexpr (X::kSplit) pay = a.cost ? s_pay0 : (s_key1 != ~0ull ? s_pay1 : s_pay2);
            int ms;
            if constexpr (X::kSplit) ms = max((int)(pay >> 32), 1);
            else ms = max(kopen[cs], 1);
            if (a.group_cap) ms = min(max(gcap, 1), ms);
            int slot;
            if constexpr (X::kSplit) slot = (int)(pay & 0xffffffffull);
            else slot = slot_of(a, cs);
            float rsv_now = __fadd_rn(a.rsv_used[slot], spend[slot]);
            float cap_left = fminf(__fsub_rn(cap_ext(a, slot), rsv_now), kCapMax);
            int axis_left = N - (nc + s_nopen);
            // the min() terms commute: the axis is split off to see
            // whether it ever bound the open (a clamped plan cannot
            // survive an index shift)
            int q_noaxis = min((rem - 1) / ms + 1, (int)fmaxf(cap_left, 0.0f));
            int q = max(min(q_noaxis, axis_left), 1);
            if (max(q_noaxis, 1) > axis_left) s_clamped = 1;
            s_cstar = cs;
            s_mstar = ms;
            s_q = q;
            s_remlast = min(max(rem - (q - 1) * ms, 1), ms);
            s_slot = slot;
            if constexpr (X::kSplit) s_capped = slot < a.K;
            else s_capped = a.cfg_rsv[cs] >= 0;
          }
          __syncthreads();
          // the q new rows at slots n_open.., full ones then the last
          {
            const int lo = s_nopen, q = s_q, ms = s_mstar, rl = s_remlast, cs = s_cstar;
            const int capped_star = s_capped;
            for (int c = tid; c < C; c += kThreads) {
              int kf = kopen[c];
              bool base = a.cfg_rsv[c] < 0 && kf >= 1;
              bool full = (base && kf >= ms) || (capped_star && x.c0 + c == cs);
              bool last = (base && kf >= rl) || (capped_star && x.c0 + c == cs);
              for (int i = 0; i < q - 1; ++i) o_mask[(size_t)(lo + i) * C + c] = full;
              o_mask[(size_t)(lo + q - 1) * C + c] = last;
              if ((q > 1 && full) || last) o_union[c] = 1;
            }
            for (int i = tid; i < q; i += kThreads) {
              int fill = (i == q - 1) ? rl : ms;
              float ff = (float)fill;
              for (int x = 0; x < R; ++x)
                o_used[(size_t)(lo + i) * R + x] = __fadd_rn(s_oh[x], __fmul_rn(ff, s_req[x]));
              o_fill[lo + i] = fill;
            }
          }
          __syncthreads();
          if (tid == 0) {
            s_nopen += s_q;
            s_remaining -= (s_q - 1) * s_mstar + s_remlast;
            spend[s_slot] = __fadd_rn(spend[s_slot], (float)s_q);
          }
          __syncthreads();
        }
      }
      int my_capped = 0;
      for (int s = tid; s < K; s += kThreads) my_capped |= spend[s] > 0.0f;
      my_capped = __syncthreads_or(my_capped);
      if (tid == 0) {
        mine[kCand] = g;
        mine[kValid] = 1;
        mine[kSpill] = s_spill;
        mine[kNOpen] = s_nopen;
        mine[kCappedSpend] = my_capped;
        mine[kClamped] = s_clamped;
        mine[kUnschedAdd] = max(s_remaining, 0);
        mine[kScanEnd] = s_scan_end;
        mine[kLast] = s_last;
      }
    } else if (tid == 0) {
      mine[kCand] = G;
      mine[kValid] = 0;
    }
    barrier();

    // ================================================== 2. conflicts
    // lane i (< w) meets lane w when a row i fills is one w depends on
    // (capacity > 0 and, unless w spills, at or before w's last fill),
    // or a row i opens admits a config compatible with w
    if (valid) {
      const int spill = mine[kSpill];
      const int last = mine[kLast];
      for (int i = 0; i < w; ++i) {
        const int32_t* li = a.lane + (size_t)i * kLaneFields;
        int hit = 0;
        if (li[kValid]) {
          const int32_t* take_i = a.take + (size_t)i * N;
          const int end_i = li[kScanEnd];
          for (int n = tid; n < end_i; n += kThreads)
            if (take_i[n] > 0 && kcap[n] > 0 && (spill || n <= last)) hit = 1;
          const uint8_t* ou = a.o_union + (size_t)i * C;
          for (int c = tid; c < C; c += kThreads)
            if (ou[c] && row[c]) hit = 1;
        }
        hit = __syncthreads_or(hit);
        if constexpr (X::kSplit) {
          if (tid == 0) s_hit[i] = hit;
        } else {
          if (tid == 0) a.conf[(size_t)i * W + w] = (uint8_t)hit;
        }
      }
      if constexpr (X::kSplit) {
        // the config part of each test is this shard's: OR over shards
        __syncthreads();
        shard_vec(
            x, w, [&](int i) { return (unsigned long long)s_hit[i]; },
            [&](int i, auto get) {
              unsigned long long hit = 0;
              for (int sh = 0; sh < x.S; ++sh) hit |= get(sh);
              a.conf[(size_t)i * W + w] = (uint8_t)(hit != 0);
            });
      }
    }
    barrier();

    // ================================================== 3. accept
    // the greedy prefix scan, redundantly in every block
    if (tid == 0) {
      int shift = 0, nacc = 0, acc_capped = 0, stopped = 0;
      for (int j = 0; j < W; ++j) {
        const int32_t* lj = a.lane + (size_t)j * kLaneFields;
        int accept = !stopped && lj[kValid];
        for (int i = 0; accept && i < j; ++i)
          if (a.conf[(size_t)i * W + j]) accept = 0;
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
    if (w == 0) {
      // the round's scalars; no block reads them before the next round
      for (int s = tid; s <= K; s += kThreads) {
        float tot = 0.0f;
        for (int j = 0; j < nacc; ++j) tot = __fadd_rn(tot, a.spend[(size_t)j * (K + 1) + s]);
        a.rsv_used[s] = __fadd_rn(a.rsv_used[s], tot);
      }
      for (int j = tid; j < nacc; j += kThreads) {
        const int32_t* lj = a.lane + (size_t)j * kLaneFields;
        a.unsched[lj[kCand]] += lj[kUnschedAdd];
        a.done[lj[kCand]] = 1;
      }
      if (tid == 0) {
        *a.node_count = nc + s_shift;
        a.widths[s_steps] = nacc;
        *a.steps = s_steps + 1;
      }
    }

    // ================================================== commit
    if (s_accept[w]) {
      const int end = mine[kScanEnd];
      for (int b = tid; b < min(B, end); b += kThreads) {
        int t = take[b];
        if (t <= 0) continue;
        a.assign[(size_t)b * G + g] += t;
        float tf = (float)t;
        float* used = a.bound_used + (size_t)b * R;
        for (int q = 0; q < R; ++q) used[q] = __fadd_rn(used[q], __fmul_rn(tf, s_req[q]));
      }
      for (int f = warp; f < end - B; f += kWarps) {
        int t = take[B + f];
        if (t <= 0) continue;  // warp-uniform
        uint8_t* mrow = a.free_mask + (size_t)f * C;
        float* used = a.free_used + (size_t)f * R;
        // a filled row keeps the configs that still hold its take,
        // judged on the row as the round found it
        for (int c = lane; c < C; c += 32) {
          uint8_t keep = 0;
          if (mrow[c] && row[c]) {
            int k = capacity(a.cfg_alloc + (size_t)c * R, used, s_req, R);
            keep = (k >= 1 && k >= t) ? 1 : 0;
          }
          mrow[c] = keep;
        }
        __syncwarp();
        if (lane == 0) a.assign[(size_t)(B + f) * G + g] += t;
        float tf = (float)t;
        if (lane < R) used[lane] = __fadd_rn(used[lane], __fmul_rn(tf, s_req[lane]));
      }
      // opened rows at their place on the node axis
      const int lo = s_offset[w] - B;
      const int n_open = mine[kNOpen];
      for (long long i = tid; i < (long long)n_open * C; i += kThreads) {
        const int f = (int)(i / C);
        const int c = (int)(i % C);
        a.free_mask[(size_t)(lo + f) * C + c] |= o_mask[(size_t)f * C + c];
      }
      for (int i = tid; i < n_open; i += kThreads) {
        float* used = a.free_used + (size_t)(lo + i) * R;
        for (int x = 0; x < R; ++x) used[x] = __fadd_rn(used[x], o_used[(size_t)i * R + x]);
        a.assign[(size_t)(B + lo + i) * G + g] += o_fill[i];
      }
    }
    barrier();
  }
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
  NoSplit x;
  wavefront_body(a, blockIdx.x, x, GridBarrier{});
}

// lane l's slice of every per-lane array: its demand and live rows,
// its outputs, its state and its plan scratch
__device__ __forceinline__ Args lane_view(Args a, int l) {
  const size_t L = (size_t)l;
  const size_t N = (size_t)a.B + a.F;
  const size_t W = (size_t)a.W;
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
  a.rsv_used += L * (a.K + 1);
  a.done += L * a.G;
  a.kcap += L * W * N;
  a.take += L * W * N;
  a.fits += L * W * a.C;
  a.kopen += L * W * a.C;
  a.spend += L * W * (a.K + 1);
  a.o_mask += L * W * a.F * a.C;
  a.o_used += L * W * a.F * a.R;
  a.o_fill += L * W * a.F;
  a.o_union += L * W * a.C;
  a.lane += L * W * kLaneFields;
  a.conf += L * W * W;
  return a;
}

// B6 wavefront: one cluster of W blocks per lane; the lane is the
// cluster's index and the block's rank in it is the plan lane.
__global__ void __launch_bounds__(kThreads, 1) pack_probe_wavefront_kernel(Args lanes) {
  const Args a = lane_view(lanes, blockIdx.x / lanes.W);
  NoSplit x;
  wavefront_body(a, (int)cg::this_cluster().block_rank(), x, ClusterBarrier{});
}

// per-shard pointers of a split solve's config-axis arrays
struct ShardTable {
  const uint8_t* const* compat;    // [G, Cs] each
  const float* const* cfg_alloc;   // [Cs, R]
  const int32_t* const* cfg_pool;  // [Cs]
  const float* const* cfg_price;   // [Cs]
  const int32_t* const* cfg_rsv;   // [Cs]
  uint8_t* const* free_mask;       // [F, Cs] out
  uint8_t* const* fits;            // [W, Cs] scratch
  int32_t* const* kopen;           // [W, Cs]
  uint8_t* const* o_mask;          // [W, F, Cs]
  uint8_t* const* o_union;         // [W, Cs]
};

// Split B3: block s * W + w plans lane w on shard s; every replicated
// output, state and plan array carries a leading shard axis; lane w's
// exchange group has its own slots and counter.
__global__ void __launch_bounds__(kThreads, 1) pack_wavefront_sharded_kernel(
    Args base, ShardTable t, unsigned long long* slots, unsigned* arrive, int S, int words) {
  const int s = blockIdx.x / base.W;
  const int w = blockIdx.x % base.W;
  Args a = base;
  const size_t N = (size_t)a.B + a.F;
  const size_t W = (size_t)a.W;
  a.assign += s * N * a.G;
  a.node_count += s;
  a.unsched += s * a.G;
  a.steps += s;
  a.widths += s * a.G;
  a.free_used += s * a.F * a.R;
  a.bound_used += s * a.B * a.R;
  a.rsv_used += s * (a.K + 1);
  a.done += s * a.G;
  a.kcap += s * W * N;
  a.take += s * W * N;
  a.spend += s * W * (a.K + 1);
  a.o_used += s * W * a.F * a.R;
  a.o_fill += s * W * a.F;
  a.lane += s * W * kLaneFields;
  a.conf += s * W * W;
  a.compat = t.compat[s];
  a.cfg_alloc = t.cfg_alloc[s];
  a.cfg_pool = t.cfg_pool[s];
  a.cfg_price = t.cfg_price[s];
  a.cfg_rsv = t.cfg_rsv[s];
  a.free_mask = t.free_mask[s];
  a.fits = t.fits[s];
  a.kopen = t.kopen[s];
  a.o_mask = t.o_mask[s];
  a.o_union = t.o_union[s];
  DeviceSplit x{slots + (size_t)w * 2 * S * words, arrive + w, s, S, words, s * a.C, 0u};
  wavefront_body(a, w, x, GridBarrier{});
}

}  // namespace

extern "C" int pack_wavefront_launch(
    const uint8_t* compat, const float* group_req, const int32_t* group_count,
    const float* cfg_alloc, const int32_t* cfg_pool, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* bound_live, const float* cfg_price,
    const int16_t* bound_quota, const int32_t* cfg_rsv, const float* rsv_cap,
    const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, uint8_t* free_mask, int32_t* node_count, int32_t* unsched,
    int32_t* steps, int32_t* widths,
    float* free_used, float* bound_used, float* rsv_used, uint8_t* done,
    int32_t* kcap, int32_t* take, uint8_t* fits, int32_t* kopen, float* spend,
    uint8_t* o_mask, float* o_used, int32_t* o_fill, uint8_t* o_union,
    int32_t* lane, uint8_t* conf,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int W,
    cudaStream_t stream) {
  if (R > kMaxR || W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  Args a{compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, cfg_price,
         bound_quota, cfg_rsv, rsv_cap, group_cap, conflict,
         assign, free_mask, node_count, unsched, steps, widths,
         free_used, bound_used, rsv_used, done,
         kcap, take, fits, kopen, spend, o_mask, o_used, o_fill, o_union, lane, conf,
         G, C, R, B, F, K, P1, cost, W};
  void* params[] = {&a};
  // all W blocks must be resident at once for the grid barrier; the
  // runtime refuses the launch otherwise
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)pack_wavefront_kernel, dim3(W), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// B6 wavefront: L lanes, each one thread-block cluster of W blocks
// (grid W*L). group_count is [L, G] and bound_live [L, B]; every output,
// state and scratch array carries a leading lane axis of L.
// *max_clusters receives cudaOccupancyMaxActiveClusters for this launch;
// when it is 0 the launch is not made and cudaErrorInvalidConfiguration
// is returned. A cluster of more than 8 blocks needs the non-portable
// size, which the H100 allows up to 16.
extern "C" int pack_probe_wavefront_launch(
    const uint8_t* compat, const float* group_req, const int32_t* lane_counts,
    const float* cfg_alloc, const int32_t* cfg_pool, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* lane_live, const float* cfg_price,
    const int32_t* cfg_rsv, const float* rsv_cap, const uint8_t* conflict,
    int32_t* assign, uint8_t* free_mask, int32_t* node_count, int32_t* unsched,
    int32_t* steps, int32_t* widths,
    float* free_used, float* bound_used, float* rsv_used, uint8_t* done,
    int32_t* kcap, int32_t* take, uint8_t* fits, int32_t* kopen, float* spend,
    uint8_t* o_mask, float* o_used, int32_t* o_fill, uint8_t* o_union,
    int32_t* lane, uint8_t* conf,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int W, int L,
    int* max_clusters, cudaStream_t stream) {
  *max_clusters = 0;
  if (R > kMaxR || W < 1 || W > kMaxW || L < 1) return (int)cudaErrorInvalidValue;
  Args a{compat, group_req, lane_counts, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, lane_live, cfg_price,
         nullptr, cfg_rsv, rsv_cap, nullptr, conflict,
         assign, free_mask, node_count, unsched, steps, widths,
         free_used, bound_used, rsv_used, done,
         kcap, take, fits, kopen, spend, o_mask, o_used, o_fill, o_union, lane, conf,
         G, C, R, B, F, K, P1, cost, W};
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
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // clusters run whole and barrier only among themselves, so the lanes
  // run in waves of the clusters that fit at once; none fitting is an
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

// Split B3 over S shards of C columns each, W lanes: the ten tables hold
// S device pointers each (compat, cfg_alloc, cfg_pool, cfg_price,
// cfg_rsv, free_mask, fits, kopen, o_mask, o_union); assign [S, B+F, G],
// node_count, steps [S], unsched, widths [S, G] and the state and plan
// scratch carry a leading shard axis; slots [W, 2, S, words] (words >=
// max(F, W) and >= 4) and arrive [W] (zeroed) are the lanes' exchange
// groups. *per_sm and *sms receive the occupancy the card reports; when
// per_sm * sms < S * W the launch is not made (cudaErrorCooperativeLaunch
// TooLarge) and the caller raises with the numbers.
extern "C" int pack_wavefront_sharded_launch(
    const uint8_t* const* compat, const float* const* cfg_alloc,
    const int32_t* const* cfg_pool, const float* const* cfg_price,
    const int32_t* const* cfg_rsv, uint8_t* const* free_mask, uint8_t* const* fits,
    int32_t* const* kopen, uint8_t* const* o_mask, uint8_t* const* o_union,
    const float* group_req, const int32_t* group_count, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* bound_live, const int16_t* bound_quota,
    const float* rsv_cap, const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, int32_t* node_count, int32_t* unsched, int32_t* steps,
    int32_t* widths,
    float* free_used, float* bound_used, float* rsv_used, uint8_t* done,
    int32_t* kcap, int32_t* take, float* spend, float* o_used, int32_t* o_fill,
    int32_t* lane, uint8_t* conf,
    unsigned long long* slots, unsigned* arrive,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int W, int S, int words,
    int* per_sm, int* sms, cudaStream_t stream) {
  *per_sm = 0;
  *sms = 0;
  if (R > kMaxR || W < 1 || W > kMaxW || S < 2 || words < F || words < W || words < 4)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, (const void*)pack_wavefront_sharded_kernel, kThreads, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if ((long long)*per_sm * *sms < (long long)S * W) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args a{nullptr, group_req, group_count, nullptr, nullptr, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, nullptr,
         bound_quota, nullptr, rsv_cap, group_cap, conflict,
         assign, nullptr, node_count, unsched, steps, widths,
         free_used, bound_used, rsv_used, done,
         kcap, take, nullptr, nullptr, spend, nullptr, o_used, o_fill, nullptr, lane, conf,
         G, C, R, B, F, K, P1, cost, W};
  ShardTable t{compat, cfg_alloc, cfg_pool, cfg_price, cfg_rsv, free_mask, fits, kopen,
               o_mask, o_union};
  void* params[] = {&a, &t, &slots, &arrive, &S, &words};
  err = cudaLaunchCooperativeKernel((const void*)pack_wavefront_sharded_kernel, dim3(S * W),
                                    dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
