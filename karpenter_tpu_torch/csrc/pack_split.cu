// B1: grouped first-fit-decreasing packing with a split node axis.
//
// Replaces karpenter_tpu/solver/pack.py::pack_split (with `capacity`
// and `_prefix_take`). Plain version: karpenter_tpu_torch/solver/
// pack_split.py::pack_split_ref, which this kernel matches byte for
// byte.
//
// What bounds it. The group loop is serial: group g+1 reads the node
// state group g wrote, so the Gp steps form one dependent chain. The
// work inside a step is small (at 50k pods x 500 types: B+F ~ 1.5k
// rows x Cp = 224 configs x R = 4 resources), far below what one
// launch per step would cost in launch latency. So the kernel is one
// persistent block of 1024 threads that walks every group in order,
// with the state in global memory (it stays in L2), and
// __syncthreads() between the phases of a step:
//   1. capacity of each bound row (thread per row) and of each opened
//      fresh row (warp per row, lanes over configs, warp reductions);
//   2. the prefix fill: a block-wide chunked scan over rows in index
//      order, exact in 64 bits and clamped at the group's demand
//      (equal to the JAX kernel's saturating uint32 scan), stopping
//      at the chunk where the demand is met;
//   3. the takes applied (usage, assignment, fresh-row mask narrowing);
//   4. the bulk-open loop: block reductions over configs for the pool
//      and the column c*, then the q new rows written in parallel.
// Rows past the opened prefix of the fresh axis hold no configs, so
// their capacity is 0 without being computed. The chain of group steps
// and the one SM it runs on are what bound it; a multi-block
// cooperative grid and shared-memory residency of the masks are later
// work.
//
// The capacity, the reduction keys and the block scan live in
// pack_common.cuh, shared with B3 (pack_wavefront.cu).
//
// Exactness. Every pick is an index-tie-broken arg-reduction: keys are
// packed (ordered value, index) pairs reduced with shared-memory
// atomicMin, so the result does not depend on the order of the
// atomics. Float arithmetic is f32 with explicit round-to-nearest
// intrinsics in the JAX order of operations (no FMA contraction; the
// build also passes -fmad=false). Capacities are clipped to CAP_MAX
// before every float-to-int cast.

#include "pack_common.cuh"

namespace {

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
  float* free_used;             // [F, R] scratch
  float* bound_used;            // [B, R] scratch
  float* rsv_used;              // [K+1] scratch
  int32_t* kcap;                // [B+F] scratch
  int32_t* take;                // [B+F] scratch
  int32_t* kopen;               // [C] scratch
  uint8_t* fits;                // [C] scratch
  int G, C, R, B, F, K, P1, cost;
};

__global__ void __launch_bounds__(kThreads, 1) pack_split_kernel(Args a) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.G, C = a.C, R = a.R, B = a.B, F = a.F, K = a.K;
  const int N = B + F;

  __shared__ float s_req[kMaxR];
  __shared__ float s_oh[kMaxR];
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_total;
  __shared__ long long s_carry;
  __shared__ int s_remaining;
  __shared__ int s_node_count;
  __shared__ int s_scan_end;
  __shared__ int s_go;
  __shared__ int s_pool;
  __shared__ int s_any;
  __shared__ unsigned long long s_key0, s_key1, s_key2;
  __shared__ uint32_t s_minu;
  __shared__ int s_cstar, s_mstar, s_q, s_remlast, s_slot, s_lo, s_capped;

  // ---- state init: usage copies and reservation use of bound rows
  for (int i = tid; i < B * R; i += kThreads) a.bound_used[i] = a.bound_used0[i];
  for (int i = tid; i < F * R; i += kThreads) a.free_used[i] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s <= K; ++s) a.rsv_used[s] = 0.0f;
    for (int b = 0; b < B; ++b) {
      int s = a.bound_slot[b];
      if (a.bound_live[b] && s < K) a.rsv_used[s] = __fadd_rn(a.rsv_used[s], 1.0f);
    }
    s_node_count = B;
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    if (tid == 0) s_remaining = a.group_count[g];
    if (tid < R) s_req[tid] = a.group_req[(size_t)g * R + tid];
    __syncthreads();
    const int remaining0 = s_remaining;
    if (remaining0 <= 0) {
      // no demand: the step leaves the state as it is
      __syncthreads();
      continue;
    }
    const uint8_t* row = a.compat + (size_t)g * C;
    const int gcap = a.group_cap ? a.group_cap[g] : kIntBig;
    const int nfresh = s_node_count - B;  // opened fresh rows

    // ---- 1a. bound-row capacity, thread per row
    for (int b = tid; b < B; b += kThreads) {
      int kb = capacity(a.bound_alloc + (size_t)b * R, a.bound_used + (size_t)b * R, s_req, R);
      bool ok = a.bound_compat[(size_t)g * B + b] && a.bound_live[b] && kb >= 1;
      kb = ok ? kb : 0;
      if (a.bound_quota) kb = min(kb, (int)a.bound_quota[(size_t)b * G + g]);
      if (a.group_cap) kb = min(kb, max(gcap - a.assign[(size_t)b * G + g], 0));
      if (a.conflict && blocked(a, b, g)) kb = 0;
      a.kcap[b] = kb;
    }
    // ---- 1b. fresh-row capacity, warp per opened row
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
        int kf = any_pin ? (any_pin_ok ? max_pin : 0) : max_ok;
        if (a.group_cap) kf = min(kf, max(gcap - a.assign[(size_t)(B + f) * G + g], 0));
        if (a.conflict && blocked(a, B + f, g)) kf = 0;
        a.kcap[B + f] = kf;
      }
    }
    if (tid == 0) {
      s_carry = 0;
      s_scan_end = B + nfresh;
    }
    __syncthreads();

    // ---- 2. prefix fill over rows [0, B + nfresh) in index order
    const long long r = (long long)remaining0;
    const int nscan = B + nfresh;
    for (int base = 0; base < nscan; base += kThreads) {
      const int n = base + tid;
      long long kc = 0;
      if (n < nscan) kc = min((long long)a.kcap[n], r);
      long long incl = block_scan(kc, s_warp, &s_total);
      long long prefix = s_carry + incl - kc;
      if (prefix > r) prefix = r;
      if (n < nscan) a.take[n] = (int)min(r - prefix, kc);
      __syncthreads();
      if (tid == 0) {
        s_carry += s_total;
        if (s_carry >= r) s_scan_end = min(base + kThreads, nscan);
      }
      __syncthreads();
      if (s_carry >= r) break;
    }
    const int scan_end = s_scan_end;

    // ---- 3. apply the takes
    for (int b = tid; b < min(B, scan_end); b += kThreads) {
      int t = a.take[b];
      if (t <= 0) continue;
      a.assign[(size_t)b * G + g] += t;
      float tf = (float)t;
      float* used = a.bound_used + (size_t)b * R;
      for (int q = 0; q < R; ++q) used[q] = __fadd_rn(used[q], __fmul_rn(tf, s_req[q]));
    }
    for (int f = warp; f < scan_end - B; f += kWarps) {
      int t = a.take[B + f];
      if (t <= 0) continue;  // warp-uniform
      uint8_t* mrow = a.free_mask + (size_t)f * C;
      float* used = a.free_used + (size_t)f * R;
      // a touched row keeps the configs that still hold its take
      // (pinned rows: their pin held, or the take would be 0)
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
    if (tid == 0) s_remaining = remaining0 - (int)min(s_carry, r);
    __syncthreads();

    // ---- 4. bulk open on the fresh axis
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
        if (tid == 0)
          s_go = (s_remaining > 0 && s_node_count < N && s_any) ? 1 : 0;
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
        // open capacity per config in the chosen pool; cost mode
        // reduces argmin price-per-pod, ffd mode the cheapest
        // uncapped price first
        unsigned long long k0 = ~0ull;
        uint32_t mu = float_key(kBig);
        for (int c = tid; c < C; c += kThreads) {
          int kf = 0;
          if (a.fits[c] && a.cfg_pool[c] == pool) {
            int s = slot_of(a, c);
            if (a.rsv_used[s] < cap_ext(a, s))
              kf = capacity(a.cfg_alloc + (size_t)c * R, s_oh, s_req, R);
          }
          a.kopen[c] = kf;
          if (a.cost) {
            float ppp = kf >= 1 ? __fdiv_rn(a.cfg_price[c], (float)max(kf, 1)) : kBig;
            unsigned long long key = pack_key(float_key(ppp), c);
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
        if (!a.cost) {
          // reserved columns cheaper than every uncapped one win by
          // capacity; else the column with the most capacity
          unsigned long long k1 = ~0ull, k2 = ~0ull;
          const float min_uncapped = key_float(s_minu);
          for (int c = tid; c < C; c += kThreads) {
            int kf = a.kopen[c];
            unsigned long long key2 = pack_key((uint32_t)(kIntBig - kf), c);
            if (key2 < k2) k2 = key2;
            if (kf >= 1 && a.cfg_rsv[c] >= 0 && a.cfg_price[c] < min_uncapped) {
              unsigned long long key1 = pack_key((uint32_t)(kIntBig - kf), c);
              if (key1 < k1) k1 = key1;
            }
          }
          if (k1 != ~0ull) atomicMin(&s_key1, k1);
          atomicMin(&s_key2, k2);
          __syncthreads();
        }
        if (tid == 0) {
          int cs;
          if (a.cost) cs = (int)(s_key0 & 0xffffffffull);
          else cs = (int)(((s_key1 != ~0ull) ? s_key1 : s_key2) & 0xffffffffull);
          int rem = s_remaining;
          int nc = s_node_count;
          int ms = max(a.kopen[cs], 1);
          if (a.group_cap) ms = min(max(gcap, 1), ms);
          int slot = slot_of(a, cs);
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
          s_lo = nc - B;
          s_capped = a.cfg_rsv[cs] >= 0;
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
            if (capped_star && c == cs) m = 1;
            a.free_mask[(size_t)f * C + c] = m;
          }
          for (int i = tid; i < q; i += kThreads) {
            int f = lo + i;
            int fill = (i == q - 1) ? rl : ms;
            float ff = (float)fill;
            for (int x = 0; x < R; ++x)
              a.free_used[(size_t)f * R + x] = __fadd_rn(s_oh[x], __fmul_rn(ff, s_req[x]));
            a.assign[(size_t)(B + f) * G + g] += fill;
          }
        }
        __syncthreads();
        if (tid == 0) {
          s_node_count += s_q;
          s_remaining -= (s_q - 1) * s_mstar + s_remlast;
          a.rsv_used[s_slot] = __fadd_rn(a.rsv_used[s_slot], (float)s_q);
        }
        __syncthreads();
      }
    }
    if (tid == 0) a.unsched[g] += max(s_remaining, 0);
    __syncthreads();
  }
  if (tid == 0) *a.node_count = s_node_count;
}

}  // namespace

extern "C" int pack_split_launch(
    const uint8_t* compat, const float* group_req, const int32_t* group_count,
    const float* cfg_alloc, const int32_t* cfg_pool, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* bound_live, const float* cfg_price,
    const int16_t* bound_quota, const int32_t* cfg_rsv, const float* rsv_cap,
    const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, uint8_t* free_mask, int32_t* node_count, int32_t* unsched,
    float* free_used, float* bound_used, float* rsv_used, int32_t* kcap,
    int32_t* take, int32_t* kopen, uint8_t* fits,
    int G, int C, int R, int B, int F, int K, int P1, int cost, cudaStream_t stream) {
  if (R > kMaxR) return (int)cudaErrorInvalidValue;
  Args a{compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, cfg_price,
         bound_quota, cfg_rsv, rsv_cap, group_cap, conflict,
         assign, free_mask, node_count, unsched,
         free_used, bound_used, rsv_used, kcap, take, kopen, fits,
         G, C, R, B, F, K, P1, cost};
  pack_split_kernel<<<1, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
