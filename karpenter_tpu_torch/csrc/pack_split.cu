// B1: grouped first-fit-decreasing packing with a split node axis.
//
// Replaces karpenter_tpu/solver/pack.py::pack_split (with `capacity`
// and `_prefix_take`). Plain version: karpenter_tpu_torch/solver/
// pack_split.py::pack_split_ref, which this kernel matches byte for
// byte.
//
// What bounds it. The group loop is serial: group g+1 reads the node
// state group g wrote, so the steps form one dependent chain, and the
// kernel is one persistent block of 1024 threads that walks every group
// in order. At 50k pods x 500 types (168 steps with demand, ~850 opened
// rows a step on average and 1453 at most, Cp = 224, R = 4) a step
// takes ~3.4k capacity terms and moves a few KB, so the bytes bound the
// launch at 0.00045 ms while the chain takes ~15 us a step (PERF.md
// §6). Inside a step the block is bound by issue and latency on its one
// SM; the phase clocks give the sweep ~43% of a step, the takes ~28%
// and the bulk open ~21%, and the sweep's slowest thread (two rows, ~14
// candidate configs) sets its phase.
//
// What the design does about it (pack_common.cuh):
//   - the config tables and the groups' demand, requests and compat
//     rows (as bits) live in the block's dynamic shared memory: a step
//     reads nothing of its group from global memory, and the tables are
//     read from L2 once a launch;
//   - a fresh row keeps its mask as words_pad(C) 32-bit words; its
//     candidate configs are its words ANDed with the group's bits, and
//     capacity is taken for those alone, an exact division-free
//     pre-test (`capacity_below`) skipping the ones that cannot raise the
//     row's maximum;
//   - each thread owns a run of consecutive rows: it prefetches and
//     sweeps them, one block scan of the threads' sums gives every take
//     in index order (`sweep_take`), and a thread a filled row narrows
//     its mask and adds the take (`apply_take`);
//   - the bulk open (`open_loop`) takes three or four block barriers an
//     open, every block reduction a warp reduction first.
// The byte masks of the output are written from the words at the end of
// the launch. Measured and not kept: the row state resident in shared
// memory (no faster), and whole warps on rows with many candidates
// (slower: a warp then walks its rows one after another).
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
// packed (ordered value, index) pairs reduced within each warp, then
// with shared-memory atomicMin, so the result does not depend on the
// order of the atomics. Float arithmetic is f32 with explicit
// round-to-nearest intrinsics in the JAX order of operations (no FMA
// contraction; the build also passes -fmad=false); the pre-test's
// approximate quotients only decide which capacities need no exact
// division, never a capacity's value. Capacities are clipped to CAP_MAX
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
  uint32_t* free_bits;          // [F, words_pad(C)] scratch: the fresh masks
  int32_t* kcap;                // [B+F] scratch: the rows' capacities, then takes
  // in the block's shared memory (stage_tables)
  float* rsv_used;              // [K+1]
  int32_t* kopen;               // [C]
  uint8_t* fits;                // [C]
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
  a.free_bits += L * a.F * words_pad(a.C);
  a.kcap += L * N;
  return a;
}

// The group loop of one lane (unsplit, X = NoSplit) or of one shard of
// a split solve (X = DeviceSplit: `a` holds the shard's columns and its
// replica), with its config tables in the block's dynamic shared memory.
template <class X>
__device__ __forceinline__ void pack_split_body(Args a, X& x, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int G = a.G, C = a.C, R = a.R, B = a.B, F = a.F, K = a.K;
  const int N = B + F;
  const int nw = words_pad(C);

  __shared__ OpenState s_open;
  __shared__ int s_node_count;
  PhaseClock clk;
  clk.begin();

  // ---- state init: the tables, usage copies, the fresh rows' words,
  // and the reservation use of bound rows (integer-valued float adds,
  // exact in any order)
  const Smem sm = stage_tables(a, smem);
  for (int i = tid; i < B * R; i += kThreads) a.bound_used[i] = a.bound_used0[i];
  for (int i = tid; i < F * R; i += kThreads) a.free_used[i] = 0.0f;
  for (int i = tid; i < F * nw; i += kThreads) a.free_bits[i] = 0u;
  for (int b = tid; b < B; b += kThreads) {
    const int s = a.bound_slot[b];
    if (a.bound_live[b] && s < K) atomicAdd(&a.rsv_used[s], 1.0f);
  }
  if (tid == 0) s_node_count = B;
  __syncthreads();
  clk.mark(0);

  for (int g = 0; g < G; ++g) {
    const int remaining0 = sm.gcount[g];
    if (remaining0 <= 0) continue;  // no demand: the step leaves the state as it is
    const float* req = sm.greq + (size_t)g * R;
    const uint32_t* rowbits = sm.gbits + (size_t)g * nw;
    clk.mark(1);
    clk.count();
    const int gcap = a.group_cap ? a.group_cap[g] : kIntBig;
    const int nc = s_node_count;

    // ---- 1-3. capacities, the prefix fill over rows [0, nc) in index
    // order, and the takes applied, a thread a filled row
    const long long r = (long long)remaining0;
    const long long placed = sweep_take(a, x, sm, a.free_bits, rowbits, g, req, gcap, nc - B, r,
                                        a.kcap, true, [](int, int) {}, clk, 2);
    const long long t_apply = clk.now();
    unsigned applied = 0;
    for (int n = tid; n < nc; n += kThreads)
      if (a.kcap[n] > 0) {
        apply_take(a, rowbits, a.free_bits, n, g, req, a.kcap[n]);
        ++applied;
      }
    const unsigned apply_cycles = (unsigned)(clk.now() - t_apply);
    clk.mark(4);
    clk.spread(kSpreadSlot + 6, kSpreadSlot + 7, apply_cycles);
    clk.spread(kSpreadSlot + 8, kSpreadSlot + 9, applied);

    // ---- 4. bulk open on the fresh axis
    int remaining = remaining0 - (int)placed;
    if (remaining > 0) {
      if (tid == 0) s_open = OpenState{remaining, 0, 0};
      FreshRows rows{a.free_bits, nc - B, g};
      open_loop(a, x, rowbits, req, gcap, nc, N, sm.spend, &s_open, rows);
      remaining = s_open.remaining;
      // the group's reservation use (integer-valued), for the next
      for (int s = tid; s <= K; s += kThreads) {
        a.rsv_used[s] = __fadd_rn(a.rsv_used[s], sm.spend[s]);
        sm.spend[s] = 0.0f;
      }
      if (tid == 0) s_node_count = nc + s_open.nopen;
    }
    if (tid == 0) a.unsched[g] = max(remaining, 0);  // each group's once
    __syncthreads();
    clk.mark(5);
  }
  if (tid == 0) *a.node_count = s_node_count;
  mask_bytes(a.free_bits, C, s_node_count - B, a.free_mask, 0, 1);
}

__global__ void __launch_bounds__(kThreads, 1) pack_split_kernel(Args lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  NoSplit x;
  pack_split_body(lane_view(lanes, blockIdx.x), x, smem);
}

// per-shard pointers of a split solve's config-axis arrays
struct ShardTable {
  const uint8_t* const* compat;   // [G, Cs] each
  const float* const* cfg_alloc;  // [Cs, R]
  const int32_t* const* cfg_pool;  // [Cs]
  const float* const* cfg_price;  // [Cs]
  const int32_t* const* cfg_rsv;  // [Cs]
  uint8_t* const* free_mask;      // [F, Cs] out
};

// block s: shard s's columns and its replica (the replicated outputs
// and state carry a leading shard axis, as the lane axis of lane_view)
__global__ void __launch_bounds__(kThreads, 1) pack_split_sharded_kernel(
    Args base, ShardTable t, unsigned long long* slots, unsigned* arrive, int S, int words) {
  const int s = blockIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  Args a = base;
  const size_t N = (size_t)a.B + a.F;
  a.assign += s * N * a.G;
  a.node_count += s;
  a.unsched += s * a.G;
  a.free_used += s * a.F * a.R;
  a.bound_used += s * a.B * a.R;
  a.free_bits += s * a.F * words_pad(a.C);
  a.kcap += s * N;
  a.compat = t.compat[s];
  a.cfg_alloc = t.cfg_alloc[s];
  a.cfg_pool = t.cfg_pool[s];
  a.cfg_price = t.cfg_price[s];
  a.cfg_rsv = t.cfg_rsv[s];
  a.free_mask = t.free_mask[s];
  DeviceSplit x{slots, arrive, s, S, words, s * a.C, 0u};
  pack_split_body(a, x, smem);
}

}  // namespace

// The dynamic shared memory a block takes: `smem` bytes, at least the
// tables' (table_layout); the launch is refused above the card's limit.
static int set_smem(const void* kernel, int smem, int C, int R, int P1, int K, int G) {
  if (smem < table_layout(C, R, P1, K, G).end) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// L lanes, one block each (B1 is L = 1; B6 sequential passes null
// bound_quota and group_cap). group_count is [L, G] and bound_live
// [L, B]; every output and scratch array carries a leading lane axis
// of L. `smem`: the dynamic shared memory of a block.
extern "C" int pack_split_launch(
    const uint8_t* compat, const float* group_req, const int32_t* group_count,
    const float* cfg_alloc, const int32_t* cfg_pool, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* bound_live, const float* cfg_price,
    const int16_t* bound_quota, const int32_t* cfg_rsv, const float* rsv_cap,
    const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, uint8_t* free_mask, int32_t* node_count, int32_t* unsched,
    float* free_used, float* bound_used, uint32_t* free_bits, int32_t* kcap,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int L, int smem,
    cudaStream_t stream) {
  if (R > kMaxR || L < 1) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)pack_split_kernel, smem, C, R, P1, K, G);
  if (err) return err;
  Args a{compat, group_req, group_count, cfg_alloc, cfg_pool, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, cfg_price,
         bound_quota, cfg_rsv, rsv_cap, group_cap, conflict,
         assign, free_mask, node_count, unsched,
         free_used, bound_used, free_bits, kcap, nullptr, nullptr, nullptr,
         G, C, R, B, F, K, P1, cost};
  pack_split_kernel<<<L, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Split B1 over S shards of C columns each (C is the shard width): the
// six tables hold S device pointers each (compat, cfg_alloc, cfg_pool,
// cfg_price, cfg_rsv, free_mask); assign [S, B+F, G], node_count [S],
// unsched [S, G] and the state scratch (free_bits [S, F,
// words_pad(C)]) carry a leading shard axis; slots [2, S, words]
// (words >= F and >= 4) and arrive (one counter, zeroed) are the
// exchange's. One cooperative launch: the S blocks must be co-resident,
// and the launch is refused otherwise.
extern "C" int pack_split_sharded_launch(
    const uint8_t* const* compat, const float* const* cfg_alloc,
    const int32_t* const* cfg_pool, const float* const* cfg_price,
    const int32_t* const* cfg_rsv, uint8_t* const* free_mask,
    const float* group_req, const int32_t* group_count, const float* pool_overhead,
    const uint8_t* bound_compat, const float* bound_alloc, const float* bound_used0,
    const int32_t* bound_slot, const uint8_t* bound_live, const int16_t* bound_quota,
    const float* rsv_cap, const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, int32_t* node_count, int32_t* unsched,
    float* free_used, float* bound_used, uint32_t* free_bits, int32_t* kcap,
    unsigned long long* slots, unsigned* arrive,
    int G, int C, int R, int B, int F, int K, int P1, int cost, int S, int words, int smem,
    cudaStream_t stream) {
  if (R > kMaxR || S < 2 || words < F || words < 4) return (int)cudaErrorInvalidValue;
  int serr = set_smem((const void*)pack_split_sharded_kernel, smem, C, R, P1, K, G);
  if (serr) return serr;
  Args a{nullptr, group_req, group_count, nullptr, nullptr, pool_overhead,
         bound_compat, bound_alloc, bound_used0, bound_slot, bound_live, nullptr,
         bound_quota, nullptr, rsv_cap, group_cap, conflict,
         assign, nullptr, node_count, unsched,
         free_used, bound_used, free_bits, kcap, nullptr, nullptr, nullptr,
         G, C, R, B, F, K, P1, cost};
  ShardTable t{compat, cfg_alloc, cfg_pool, cfg_price, cfg_rsv, free_mask};
  void* params[] = {&a, &t, &slots, &arrive, &S, &words};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)pack_split_sharded_kernel, dim3(S), dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}
