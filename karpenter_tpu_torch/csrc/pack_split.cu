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
// pack_common.cuh, shared with B3 (pack_wavefront.cu); so do the prefix
// fill (phase 2) and the bulk open (phase 4), shared with B7
// (pack_dense.cu).
//
// B6, sequential route: the same kernel over a lane axis
// (karpenter_tpu/solver/pack.py:1227 `pack_probe_lanes_flat` with
// wavefront 0). Lanes share the problem and differ in their demand
// (group_count row l) and retained bound rows (bound_live row l); block
// l runs lane l on its own slices of the outputs and the scratch
// (`lane_view`). B1 is lane 0 of a grid of one block. Plain version:
// pack_split.py::pack_probe_lanes_ref.
//
// Exactness. Every pick is an index-tie-broken arg-reduction: keys are
// packed (ordered value, index) pairs reduced with shared-memory
// atomicMin, so the result does not depend on the order of the
// atomics. Float arithmetic is f32 with explicit round-to-nearest
// intrinsics in the JAX order of operations (no FMA contraction; the
// build also passes -fmad=false). Capacities are clipped to CAP_MAX
// before every float-to-int cast.
//
// B8, split B1 (karpenter_tpu/solver/pack.py:1817-1893, `_run_pack`
// with shards > 1): the same body over a config axis split into S column
// blocks, one cooperative launch of S blocks (`pack_split_sharded_kernel`),
// block s on shard s's columns (a table of per-shard pointers reaches
// them) with its own replica of the replicated state (usage, assignment,
// node count, reservation use, unschedulable counts). The exchange
// points of a group step (shard_xchg.cuh): the opened fresh rows'
// capacities, one vector exchange of per-row partial maxima a step; and
// in the bulk open the lowest pool, the uncapped minimum price (ffd) and
// the pick keys with c*'s capacity and slot. Bound rows carry their
// config as an index and need no exchange; mask narrowing is local. The
// split adds S - 1 shards' worth of redundant replicated work and an
// exchange latency (a device-scope round trip through L2) per exchange
// point to B1's chain of group steps. Plain version:
// pack_shard.py::pack_split_sharded_ref.

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

// lane l's slice of every per-lane array: its demand and live rows,
// its outputs and its scratch (lane 0 is the arrays themselves)
__device__ __forceinline__ Args lane_view(Args a, int l) {
  const size_t L = (size_t)l;
  const size_t N = (size_t)a.B + a.F;
  a.group_count += L * a.G;
  a.bound_live += L * a.B;
  a.assign += L * N * a.G;
  a.free_mask += L * a.F * a.C;
  a.node_count += L;
  a.unsched += L * a.G;
  a.free_used += L * a.F * a.R;
  a.bound_used += L * a.B * a.R;
  a.rsv_used += L * (a.K + 1);
  a.kcap += L * N;
  a.take += L * N;
  a.kopen += L * a.C;
  a.fits += L * a.C;
  return a;
}

// The group loop of one lane (unsplit, X = NoSplit) or of one shard of
// a split solve (X = DeviceSplit: `a` holds the shard's columns and its
// replica).
template <class X>
__device__ __forceinline__ void pack_split_body(const Args& a, X& x) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.G, C = a.C, R = a.R, B = a.B, F = a.F, K = a.K;
  const int N = B + F;

  __shared__ float s_req[kMaxR];
  __shared__ int s_remaining;
  __shared__ int s_node_count;

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
        if constexpr (X::kSplit) {
          // this shard's partial: the largest capacity over its ok
          // configs, and 1 + the largest over its ok pinned ones when
          // the row holds a pinned config here (0 otherwise)
          const uint32_t pin = any_pin ? (uint32_t)(max_pin + 1) : 0u;
          xmine(x)[f] = ((unsigned long long)pin << 32) | (uint32_t)max_ok;
        } else {
          int kf = any_pin ? (any_pin_ok ? max_pin : 0) : max_ok;
          if (a.group_cap) kf = min(kf, max(gcap - a.assign[(size_t)(B + f) * G + g], 0));
          if (a.conflict && blocked(a, B + f, g)) kf = 0;
          a.kcap[B + f] = kf;
        }
      }
    }
    if constexpr (X::kSplit) {
      // one exchange for every opened row's partials, combined over the
      // shards (maxima: any order)
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
        a.kcap[B + f] = kf;
      }
    }

    // ---- 2. prefix fill over rows [0, B + nfresh) in index order
    // (its first barrier orders the capacities before the scan)
    const long long r = (long long)remaining0;
    long long placed;
    const int scan_end = prefix_fill(a.kcap, a.take, B + nfresh, r, &placed);

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
    if (tid == 0) s_remaining = remaining0 - (int)placed;
    __syncthreads();

    // ---- 4. bulk open on the fresh axis
    if (s_remaining > 0)
      bulk_open(a, x, g, row, s_req, N, B, a.free_mask, a.free_used, nullptr,
                &s_remaining, &s_node_count);
    if (tid == 0) a.unsched[g] += max(s_remaining, 0);
    __syncthreads();
  }
  if (tid == 0) *a.node_count = s_node_count;
}

__global__ void __launch_bounds__(kThreads, 1) pack_split_kernel(Args lanes) {
  const Args a = lane_view(lanes, blockIdx.x);
  NoSplit x;
  pack_split_body(a, x);
}

// per-shard pointers of a split solve's config-axis arrays
struct ShardTable {
  const uint8_t* const* compat;   // [G, Cs] each
  const float* const* cfg_alloc;  // [Cs, R]
  const int32_t* const* cfg_pool;  // [Cs]
  const float* const* cfg_price;  // [Cs]
  const int32_t* const* cfg_rsv;  // [Cs]
  uint8_t* const* free_mask;      // [F, Cs] out
  int32_t* const* kopen;          // [Cs] scratch
  uint8_t* const* fits;           // [Cs] scratch
};

// block s: shard s's columns and its replica (the replicated outputs
// and state carry a leading shard axis, as the lane axis of lane_view)
__global__ void __launch_bounds__(kThreads, 1) pack_split_sharded_kernel(
    Args base, ShardTable t, unsigned long long* slots, unsigned* arrive, int S, int words) {
  const int s = blockIdx.x;
  Args a = base;
  const size_t N = (size_t)a.B + a.F;
  a.assign += s * N * a.G;
  a.node_count += s;
  a.unsched += s * a.G;
  a.free_used += s * a.F * a.R;
  a.bound_used += s * a.B * a.R;
  a.rsv_used += s * (a.K + 1);
  a.kcap += s * N;
  a.take += s * N;
  a.compat = t.compat[s];
  a.cfg_alloc = t.cfg_alloc[s];
  a.cfg_pool = t.cfg_pool[s];
  a.cfg_price = t.cfg_price[s];
  a.cfg_rsv = t.cfg_rsv[s];
  a.free_mask = t.free_mask[s];
  a.kopen = t.kopen[s];
  a.fits = t.fits[s];
  DeviceSplit x{slots, arrive, s, S, words, s * a.C, 0u};
  pack_split_body(a, x);
}

}  // namespace

// L lanes, one block each (B1 is L = 1; B6 sequential passes null
// bound_quota and group_cap). group_count is [L, G] and bound_live
// [L, B]; every output and scratch array carries a leading lane axis
// of L.
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
    int G, int C, int R, int B, int F, int K, int P1, int cost, int L,
    cudaStream_t stream) {
  if (R > kMaxR || L < 1) return (int)cudaErrorInvalidValue;
  Args a{compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, cfg_price,
         bound_quota, cfg_rsv, rsv_cap, group_cap, conflict,
         assign, free_mask, node_count, unsched,
         free_used, bound_used, rsv_used, kcap, take, kopen, fits,
         G, C, R, B, F, K, P1, cost};
  pack_split_kernel<<<L, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Split B1 over S shards of C columns each (C is the shard width): the
// eight tables hold S device pointers each (compat, cfg_alloc, cfg_pool,
// cfg_price, cfg_rsv, free_mask, kopen, fits); assign [S, B+F, G],
// node_count [S], unsched [S, G] and the state scratch carry a leading
// shard axis; slots [2, S, words] (words >= F and >= 4) and arrive (one
// counter, zeroed) are the exchange's. One cooperative launch: the S
// blocks must be co-resident, and the launch is refused otherwise.
extern "C" int pack_split_sharded_launch(
    const uint8_t* const* compat, const float* const* cfg_alloc,
    const int32_t* const* cfg_pool, const float* const* cfg_price,
    const int32_t* const* cfg_rsv, uint8_t* const* free_mask, int32_t* const* kopen,
    uint8_t* const* fits,
    const float* group_req, const int32_t* group_count, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* bound_live, const int16_t* bound_quota,
    const float* rsv_cap, const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, int32_t* node_count, int32_t* unsched,
    float* free_used, float* bound_used, float* rsv_used, int32_t* kcap, int32_t* take,
    unsigned long long* slots, unsigned* arrive,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int S, int words,
    cudaStream_t stream) {
  if (R > kMaxR || S < 2 || words < F || words < 4) return (int)cudaErrorInvalidValue;
  Args a{nullptr, group_req, group_count, nullptr, nullptr, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, nullptr,
         bound_quota, nullptr, rsv_cap, group_cap, conflict,
         assign, nullptr, node_count, unsched,
         free_used, bound_used, rsv_used, kcap, take, nullptr, nullptr,
         G, C, R, B, F, K, P1, cost};
  ShardTable t{compat, cfg_alloc, cfg_pool, cfg_price, cfg_rsv, free_mask, kopen, fits};
  void* params[] = {&a, &t, &slots, &arrive, &S, &words};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)pack_split_sharded_kernel, dim3(S), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}
