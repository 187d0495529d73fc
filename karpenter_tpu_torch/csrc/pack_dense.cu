// B7: grouped first-fit-decreasing packing on one dense node axis.
//
// Replaces karpenter_tpu/solver/pack.py::pack (and, with B2's
// pack_flat.cu as its epilogue, pack_flat). Plain version:
// karpenter_tpu_torch/solver/pack_dense.py::pack_ref, which this kernel
// matches byte for byte.
//
// The node axis holds max_nodes rows, each a config mask: the E rows of
// existing_mask first (existing or LP-planned nodes), then the rows the
// kernel opens. B1 (pack_split.cu) computes the same function with the
// one-hot rows split out into a per-row block; here every row is a
// mask row. The group loop is serial (group g+1 reads the state group g
// wrote), so the kernel is B1's shape: one persistent block of 1024
// threads walks every group in order, with the state in global memory
// and __syncthreads() between the phases of a step:
//   1. capacity of each row below node_count, warp per row, lanes over
//      configs (rows at or past node_count hold no config, so their
//      capacity is 0 without being computed), then the quota, group-cap
//      and conflict clamps;
//   2. the prefix fill over rows [0, node_count) in index order
//      (`prefix_fill`, shared with B1);
//   3. touched rows keep the configs that still hold their take, and
//      every row's usage adds take * req (0 * req on untouched rows, as
//      the JAX body adds it to all N rows);
//   4. the bulk open (`bulk_open`, shared with B1) onto rows
//      node_count, node_count + 1, ...
// Set-up debits each reservation once per pre-opened row on one of its
// capped columns (integer-valued float adds, exact in any order).
//
// Exactness: as B1. Every pick is an index-tie-broken arg-reduction over
// packed (value, index) keys; float arithmetic is f32 with explicit
// round-to-nearest intrinsics in the JAX order of operations (the build
// passes -fmad=false); capacities are clipped to CAP_MAX before every
// float-to-int cast. pool_overhead is read only for configs whose pool
// is not -1.

#include "pack_common.cuh"

namespace {

struct Args {
  const uint8_t* compat;         // [G, C]
  const float* group_req;        // [G, R]
  const int32_t* group_count;    // [G]
  const float* cfg_alloc;        // [C, R]
  const int32_t* cfg_pool;       // [C]
  const float* pool_overhead;    // [P1, R]
  const uint8_t* existing_mask;  // [E, C]
  const float* existing_used;    // [E, R]
  const float* cfg_price;        // [C]
  const int16_t* quota;          // [N, G] or null
  const int32_t* cfg_rsv;        // [C]
  const float* rsv_cap;          // [K]
  const int32_t* group_cap;      // [G] or null
  const uint8_t* conflict;       // [G, G] or null
  int32_t* assign;               // [N, G], zeroed
  uint8_t* node_mask;            // [N, C], zeroed
  float* node_used;              // [N, R], zeroed
  uint8_t* node_active;          // [N], zeroed
  int32_t* node_count;           // scalar
  int32_t* unsched;              // [G], zeroed
  int32_t* kcap;                 // [N] scratch
  int32_t* take;                 // [N] scratch
  // in the block's shared memory (stage_tables)
  float* rsv_used;               // [K+1]
  int32_t* kopen;                // [C]
  uint8_t* fits;                 // [C]
  int G, C, R, E, N, K, P1, cost;
};

__global__ void __launch_bounds__(kThreads, 1) pack_dense_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  NoSplit nosplit;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.G, C = a.C, R = a.R, E = a.E, N = a.N, K = a.K;

  __shared__ float s_req[kMaxR];
  __shared__ int s_remaining;
  __shared__ int s_node_count;
  __shared__ OpenState s_open;

  // ---- state init: the tables, the pre-opened rows, and the
  // reservation use of those on a capped column
  const Smem sm = stage_tables(a, smem);
  for (int i = tid; i < E * C; i += kThreads) a.node_mask[i] = a.existing_mask[i];
  for (int i = tid; i < E * R; i += kThreads) a.node_used[i] = a.existing_used[i];
  for (int e = warp; e < E; e += kWarps) {
    unsigned any = 0;
    for (int c = lane; c < C; c += 32) any |= a.existing_mask[(size_t)e * C + c];
    any = __reduce_or_sync(0xffffffffu, any);
    if (lane == 0) a.node_active[e] = any ? 1 : 0;
  }
  if (tid == 0) s_node_count = E;
  __syncthreads();
  for (int i = tid; i < E * C; i += kThreads) {
    int s = a.cfg_rsv[i % C];
    if (s >= 0 && a.existing_mask[i]) atomicAdd(&a.rsv_used[s], 1.0f);
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    if (tid == 0) s_remaining = a.group_count[g];
    if (tid < R) s_req[tid] = a.group_req[(size_t)g * R + tid];
    __syncthreads();
    const int remaining0 = s_remaining;
    if (remaining0 <= 0) {
      // no demand: every take is 0 and no row opens; only the usage
      // update (used + 0 * req) touches the state
      for (int i = tid; i < N * R; i += kThreads)
        a.node_used[i] = __fadd_rn(a.node_used[i], __fmul_rn(0.0f, s_req[i % R]));
      __syncthreads();
      continue;
    }
    const uint8_t* row = a.compat + (size_t)g * C;
    const int gcap = a.group_cap ? a.group_cap[g] : kIntBig;
    const int nrows = s_node_count;

    // ---- 1. row capacity, warp per row below node_count
    for (int n = warp; n < nrows; n += kWarps) {
      const uint8_t* mrow = a.node_mask + (size_t)n * C;
      const float* used = a.node_used + (size_t)n * R;
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
        // a row pinned to a capped column takes the group only through
        // that column
        int k = any_pin ? (any_pin_ok ? max_pin : 0) : max_ok;
        if (a.quota) k = min(k, (int)a.quota[(size_t)n * G + g]);
        if (a.group_cap) k = min(k, max(gcap - a.assign[(size_t)n * G + g], 0));
        if (a.conflict && blocked(a, n, g)) k = 0;
        a.kcap[n] = k;
      }
    }

    // ---- 2. prefix fill over rows [0, node_count) in index order
    // (its first barrier orders the capacities before the scan)
    long long placed;
    const int scan_end = prefix_fill(a.kcap, a.take, nrows, (long long)remaining0, &placed);

    // ---- 3a. touched rows keep the configs that still hold their take
    // (pinned rows: their pin held, or the take would be 0)
    for (int n = warp; n < scan_end; n += kWarps) {
      int t = a.take[n];
      if (t <= 0) continue;  // warp-uniform
      uint8_t* mrow = a.node_mask + (size_t)n * C;
      const float* used = a.node_used + (size_t)n * R;
      for (int c = lane; c < C; c += 32) {
        uint8_t keep = 0;
        if (mrow[c] && row[c]) {
          int k = capacity(a.cfg_alloc + (size_t)c * R, used, s_req, R);
          keep = (k >= 1 && k >= t) ? 1 : 0;
        }
        mrow[c] = keep;
      }
      if (lane == 0) a.assign[(size_t)n * G + g] += t;
    }
    __syncthreads();
    // ---- 3b. every row's usage adds take * req
    for (int i = tid; i < N * R; i += kThreads) {
      const int n = i / R;
      const float tf = n < scan_end ? (float)a.take[n] : 0.0f;
      a.node_used[i] = __fadd_rn(a.node_used[i], __fmul_rn(tf, s_req[i % R]));
    }
    if (tid == 0) s_remaining = remaining0 - (int)placed;
    __syncthreads();

    // ---- 4. bulk open onto the rows past node_count
    int remaining = s_remaining;
    if (remaining > 0) {
      if (tid == 0) s_open = OpenState{remaining, 0, 0};
      DenseRows rows{a.node_mask, a.node_used, a.node_active, nrows, g};
      open_loop(a, nosplit, sm.gbits + (size_t)g * words_pad(C), s_req, gcap, nrows, N, sm.spend,
                &s_open, rows);
      remaining = s_open.remaining;
      // the group's reservation use (integer-valued), for the next
      for (int s = tid; s <= K; s += kThreads) {
        a.rsv_used[s] = __fadd_rn(a.rsv_used[s], sm.spend[s]);
        sm.spend[s] = 0.0f;
      }
      if (tid == 0) s_node_count = nrows + s_open.nopen;
    }
    if (tid == 0) a.unsched[g] += max(remaining, 0);
    __syncthreads();
  }
  if (tid == 0) *a.node_count = s_node_count;
}

}  // namespace

// One block for the whole group loop, its config tables in `smem` bytes
// of dynamic shared memory. The outputs arrive zeroed; quota,
// group_cap and conflict may be null.
extern "C" int pack_dense_launch(
    const uint8_t* compat, const float* group_req, const int32_t* group_count,
    const float* cfg_alloc, const int32_t* cfg_pool, const float* pool_overhead,
    const uint8_t* existing_mask, const float* existing_used, const float* cfg_price,
    const int16_t* quota, const int32_t* cfg_rsv, const float* rsv_cap,
    const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, uint8_t* node_mask, float* node_used, uint8_t* node_active,
    int32_t* node_count, int32_t* unsched, int32_t* kcap, int32_t* take,
    int G, int C, int R, int E, int N, int K, int P1, int cost, int smem,
    cudaStream_t stream) {
  if (R > kMaxR || E > N || smem < table_layout(C, R, P1, K, G).end)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      pack_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  Args a{compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
         existing_mask, existing_used, cfg_price, quota, cfg_rsv, rsv_cap,
         group_cap, conflict,
         assign, node_mask, node_used, node_active, node_count, unsched,
         kcap, take, nullptr, nullptr, nullptr,
         G, C, R, E, N, K, P1, cost};
  pack_dense_kernel<<<1, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
