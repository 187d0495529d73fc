// B7: grouped first-fit-decreasing packing on one dense node axis.
//
// Replaces karpenter_tpu/solver/pack.py::pack and, writing its flat
// buffer in place, pack_flat (:410, the epilogue :430-442). Plain
// versions: karpenter_tpu_torch/solver/pack_dense.py::pack_ref and
// pack_flat_ref, which this kernel matches byte for byte.
//
// The node axis holds max_nodes rows, each a config mask: the E rows of
// existing_mask first (existing or LP-planned nodes), then the rows the
// kernel opens. That is B1's problem (pack_split.cu) with every row a
// mask row: no bound block (B = 0) and the first E fresh rows preloaded.
// So B7 runs B1's group step (pack_common.cuh) on its one axis, one
// persistent block walking every group in order:
//   - a row keeps its mask as words_pad(C) 32-bit words in scratch; the
//     prologue fills the E existing rows' words and usage, marks them
//     active, and debits each reservation once per pre-opened row and
//     capped column (integer-valued float adds, exact in any order);
//   - the sweep and the take: each thread owns a run of rows, its
//     candidates are the mask words ANDed with the group's compat bits,
//     `capacity_below` skips the exact division of a capacity that cannot
//     raise the row's maximum, and one block scan gives the takes
//     (`sweep_take`; at 256 threads `sweep_take_chunked`, which stops at
//     the chunk of rows that meets the demand); `apply_take` narrows a
//     taken row's words and adds its usage, a thread a row;
//   - the open: `open_loop` with B1's fresh-row sink (`FreshRows`);
//   - what B7 has and B1's fresh rows lack is the per-row quota
//     (quota[n, g] on every row), a clamp of `fresh_cap` that only this
//     kernel instantiates (`kDenseRows`); the group cap net of the row's
//     assignment and the conflicts are B1's;
//   - an existing or planned row is mostly one config among up to
//     thousands of columns (one-hot for good: a take keeps the config
//     that holds it). The sweep is bound by the SM's issue of the rows'
//     work, so the prologue records such a row's config (`row_cfg`) and
//     the sweep takes its capacity from that config alone, as B1 takes a
//     bound row's; the sweep and the narrowing step over zero words four
//     at a time (`kDenseRows` in pack_common.cuh).
// At the end the kernel writes the node count, node_active for the rows
// it opened and the masks: `pack`'s [N, C] bytes, a thread a word, or
// `pack_flat`'s C/32 words a row into the flat buffer, whose other
// regions (assign, node_count, unsched) are its outputs in place.
//
// The usage pass. The JAX body adds take * req to every row at every
// step, steps without demand included; on a row that takes nothing that
// is used + 0 * req, which changes the row's bits only where used is
// -0.0 (and 0 * req is +0.0), where used is NaN, or where 0 * req is NaN
// (an infinite or NaN request). Takes and opens make -0.0 only from
// -0.0 inputs, so when the prologue finds no -0.0 or NaN in
// existing_used, pool_overhead or group_req and no infinite request,
// the pass is skipped; otherwise (`zero_pass`) every row that takes
// nothing gets it at every step.
//
// What bounds it: as B1, the chain of group steps. At 50k pods x 500
// types a launch moves ~2 MB, so the bytes bound it at ~0.0006 ms,
// while a step takes 15-26 us on the block's one SM, most of it the
// sweep, bound by the SM's issue of the rows' work; the step's block
// barriers are ~0.2 us of it (the chain floor, PERF.md §6). On
// entry()'s 128 rows a step is ~2.3 us of single-thread latency (a
// row's capacities, a take's update, the open's pick), which a block of
// 256 threads runs with a quarter of the warps at every barrier: the
// wrapper takes 256 threads for a node axis of at most 256 rows, 1024
// above (pack_dense.py `block_threads`).
//
// Exactness: as B1. Every pick is an index-tie-broken arg-reduction over
// packed (value, index) keys; float arithmetic is f32 with explicit
// round-to-nearest intrinsics in the JAX order of operations (the build
// passes -fmad=false); the pre-test's approximate quotients only decide
// which capacities need no exact division; capacities are clipped to
// CAP_MAX before every float-to-int cast; the prefix take is exact in
// 64 bits and clamped at the demand (the JAX saturating uint32 scan).

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
  uint8_t* node_mask;            // [N, C], zeroed; null for pack_flat
  float* free_used;              // [N, R]: node_used, the rows' usage (written whole)
  uint8_t* node_active;          // [N], zeroed; null for pack_flat
  int32_t* node_count;           // scalar
  int32_t* unsched;              // [G], zeroed
  uint32_t* free_bits;           // [N, words_pad(C)] scratch: the rows' masks
  int32_t* kcap;                 // [N] scratch: the rows' capacities, then takes
  int32_t* row_cfg;              // [E] scratch: an existing row's one config, else -1
  uint32_t* flat_words;          // pack_flat: [N, C/32] mask words, zeroed; else null
  // in the block's shared memory (stage_tables)
  float* rsv_used;               // [K+1]
  int32_t* kopen;                // [C]
  uint8_t* fits;                 // [C]
  int G, C, R, E, F, K, P1, cost;  // F: max_nodes, the rows
  // no bound block: the shared step's bound-row branches never run
  static constexpr int B = 0;
  const uint8_t* bound_compat = nullptr;
  const float* bound_alloc = nullptr;
  float* bound_used = nullptr;
  const uint8_t* bound_live = nullptr;
  const int16_t* bound_quota = nullptr;
};

// every row of B7 carries quota[n, g] (fresh_cap); most existing rows
// hold one config among many words (fresh_max, row_max, narrow_row)
template <>
constexpr bool kDenseRows<Args> = true;

// whether used + 0 * req can differ from used in its bits for this
// usage (v: -0.0 or NaN) or, with `request`, this request (v infinite
// or NaN)
__device__ __forceinline__ bool zero_add_visible(float v, bool request) {
  const uint32_t u = __float_as_uint(v);
  return u == 0x80000000u || (u & 0x7fffffffu) > 0x7f800000u ||
         (request && (u & 0x7fffffffu) == 0x7f800000u);
}

// used + 0 * req on every row that takes nothing this step (rows at or
// past `end`, or below it with a take of 0 in kcap); all threads
template <int kT>
__device__ void zero_adds(const Args& a, const float* req, const int32_t* kcap, int end) {
  const int R = a.R;
  for (int i = threadIdx.x; i < a.F * R; i += kT) {
    const int n = i / R;
    if (n < end && kcap[n] > 0) continue;
    a.free_used[i] = __fadd_rn(a.free_used[i], __fmul_rn(0.0f, req[i - n * R]));
  }
}

// The byte masks of rows [0, rows) from their words, a thread a word:
// two 16-byte stores where the word's 32 columns are whole and aligned
// (C a multiple of 16), else byte by byte.
template <int kT>
__device__ void dense_mask_bytes(const uint32_t* bits, int C, int rows, uint8_t* mask) {
  const int nw = words_pad(C), wr = words_of(C);
  for (int i = threadIdx.x; i < rows * wr; i += kT) {
    const int n = i / wr, wd = i - n * wr, c0 = wd * 32;
    const uint32_t w = bits[(size_t)n * nw + wd];
    uint8_t* out = mask + (size_t)n * C + c0;
    if ((C & 15) == 0 && c0 + 32 <= C) {
      uint32_t q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t b = w >> (4 * j);  // four columns, a byte each
        q[j] = (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
      }
      ((uint4*)out)[0] = make_uint4(q[0], q[1], q[2], q[3]);
      ((uint4*)out)[1] = make_uint4(q[4], q[5], q[6], q[7]);
    } else {
      for (int b = 0; b < 32 && c0 + b < C; ++b) out[b] = (uint8_t)((w >> b) & 1u);
    }
  }
}

// The group loop on a block of kT threads (256: `sweep_take_chunked`;
// 1024: `sweep_take`), its tables in the block's dynamic shared
// memory (kSpilled: where the placement `p` puts them).
template <bool kSpilled, int kT>
__global__ void __launch_bounds__(kT, 1) pack_dense_kernel(Args a, Placement p) {
  extern __shared__ __align__(16) unsigned char smem[];
  NoSplit x;
  const int tid = threadIdx.x;
  const int G = a.G, C = a.C, R = a.R, E = a.E, N = a.F, K = a.K;
  const int nw = words_pad(C);

  __shared__ OpenState s_open;
  __shared__ int s_node_count;
  PhaseClock clk;
  clk.begin();

  // ---- state init: the tables; the rows' words (the E existing rows'
  // from their byte masks, the rest empty), node_active of the existing
  // rows and the reservation use of their capped columns; the rows'
  // usage; whether the usage pass can show (zero_pass)
  const Smem sm = stage<kSpilled, kT>(a, smem, p);
  for (int i = tid; i < N * nw; i += kT) {
    const int n = i / nw, wd = i - n * nw, c0 = wd * 32;
    uint32_t bits = 0;
    if (n < E) {
      const uint8_t* row = a.existing_mask + (size_t)n * C;
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (c0 + b < C && row[c0 + b]) bits |= 1u << b;
      // every thread that stores here stores 1
      if (bits && a.node_active) a.node_active[n] = 1;
      for (uint32_t m = bits & sm.capped[wd]; m; m &= m - 1)
        atomicAdd(&a.rsv_used[a.cfg_rsv[c0 + __ffs(m) - 1]], 1.0f);
    }
    a.free_bits[i] = bits;
  }
  bool odd = false;
  for (int i = tid; i < N * R; i += kT) {
    const float u = i < E * R ? a.existing_used[i] : 0.0f;
    odd |= zero_add_visible(u, false);
    a.free_used[i] = u;
  }
  for (int i = tid; i < a.P1 * R; i += kT) odd |= zero_add_visible(a.pool_overhead[i], false);
  for (int i = tid; i < G * R; i += kT) odd |= zero_add_visible(sm.greq[i], true);
  if (tid == 0) s_node_count = E;
  const bool zero_pass = __syncthreads_or(odd);
  // an existing row's config when it holds exactly one (its words are
  // written: the barrier above)
  for (int e = tid; e < E; e += kT) {
    const uint32_t* w = a.free_bits + (size_t)e * nw;
    int c = -1, ones = 0;
    for (int wd = 0; wd < nw; ++wd)
      if (w[wd]) {
        ones += __popc(w[wd]);
        c = wd * 32 + __ffs(w[wd]) - 1;
      }
    a.row_cfg[e] = ones == 1 ? c : -1;
  }
  __syncthreads();
  clk.mark(0);

  for (int g = 0; g < G; ++g) {
    const int remaining0 = sm.gcount[g];
    const float* req = sm.greq + (size_t)g * R;
    if (remaining0 <= 0) {
      // no demand: no take and no open, only the usage pass
      if (zero_pass) {
        zero_adds<kT>(a, req, a.kcap, 0);
        __syncthreads();
      }
      continue;
    }
    const uint32_t* rowbits = sm.gbits + (size_t)g * nw;
    clk.mark(1);
    clk.count();
    const int gcap = a.group_cap ? a.group_cap[g] : kIntBig;
    const int nc = s_node_count;

    // ---- 1-3. capacities, the prefix fill over rows [0, nc) in index
    // order, the takes applied a thread a filled row, and the usage pass
    const long long r = (long long)remaining0;
    long long placed;
    int end = nc;
    if constexpr (kT < kThreads)
      placed = sweep_take_chunked<kT>(a, sm, a.free_bits, rowbits, g, req, gcap, nc, r, a.kcap,
                                      clk, 2, &end);
    else
      placed = sweep_take<kT>(a, x, sm, a.free_bits, rowbits, g, req, gcap, nc, r, a.kcap,
                              true, [](int, int) {}, clk, 2);
    const long long t_apply = clk.now();
    unsigned applied = 0;
    for (int n = tid; n < end; n += kT)
      if (a.kcap[n] > 0) {
        apply_take(a, rowbits, a.free_bits, n, g, req, a.kcap[n]);
        ++applied;
      }
    if (zero_pass) zero_adds<kT>(a, req, a.kcap, end);
    const unsigned apply_cycles = (unsigned)(clk.now() - t_apply);
    clk.mark(4);
    clk.spread(kSpreadSlot + 6, kSpreadSlot + 7, apply_cycles);
    clk.spread(kSpreadSlot + 8, kSpreadSlot + 9, applied);

    // ---- 4. bulk open onto the rows past nc
    int remaining = remaining0 - (int)placed;
    if (remaining > 0) {
      if (tid == 0) s_open = OpenState{remaining, 0, 0};
      FreshRows rows{a.free_bits, nc, g};
      open_loop<kSpilled, kT>(a, x, sm.pools, rowbits, req, gcap, nc, N, sm.spend, &s_open,
                              rows);
      remaining = s_open.remaining;
      // the group's reservation use (integer-valued), for the next
      for (int s = tid; s <= K; s += kT) {
        a.rsv_used[s] = __fadd_rn(a.rsv_used[s], sm.spend[s]);
        sm.spend[s] = 0.0f;
      }
      if (tid == 0) s_node_count = nc + s_open.nopen;
    }
    if (tid == 0) a.unsched[g] = max(remaining, 0);  // each group's once
    __syncthreads();
    clk.mark(5);
  }

  // ---- the outputs: the node count, the opened rows active, the masks
  // of rows [0, node_count) (later rows stay zero)
  const int nc = s_node_count;
  if (tid == 0) *a.node_count = nc;
  if (a.node_active)
    for (int n = E + tid; n < nc; n += kT) a.node_active[n] = 1;
  if (a.node_mask) dense_mask_bytes<kT>(a.free_bits, C, nc, a.node_mask);
  if (a.flat_words) {
    const int W = C / 32;
    for (int i = tid; i < nc * W; i += kT) {
      const int n = i / W;
      a.flat_words[i] = a.free_bits[(size_t)n * nw + (i - n * W)];
    }
  }
  clk.mark(6);
}

// the instantiation of a launch: placed or not, and its block size
template <int kT>
const void* dense_kernel(bool placed) {
  return placed ? (const void*)pack_dense_kernel<true, kT>
                : (const void*)pack_dense_kernel<false, kT>;
}

// n block barriers of kT threads in a row: the cost of one barrier on
// its own, which bounds a launch's chain of steps from below
// (chip_smoke.py times it)
template <int kT>
__global__ void __launch_bounds__(kT, 1) pack_dense_barrier_probe_kernel(int n, int* sink) {
  int v = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    v ^= i;
  }
  if (v == -1) *sink = v;
}

}  // namespace

// One block of `threads` (256 or 1024) for the whole group loop,
// its config tables in `smem` bytes of dynamic shared memory
// (`placement`: null for an all-shared launch, else SG_COUNT segment
// offsets with `tables` holding block_bytes). assign, node_active, unsched and flat_words arrive zeroed;
// node_mask (zeroed), node_active and flat_words may be null (pack_flat
// passes flat_words and no byte outputs; pack the byte outputs and no
// flat_words); quota, group_cap and conflict may be null. flat_words
// needs C a multiple of 32.
extern "C" int pack_dense_launch(
    const uint8_t* compat, const float* group_req, const int32_t* group_count,
    const float* cfg_alloc, const int32_t* cfg_pool, const float* pool_overhead,
    const uint8_t* existing_mask, const float* existing_used, const float* cfg_price,
    const int16_t* quota, const int32_t* cfg_rsv, const float* rsv_cap,
    const int32_t* group_cap, const uint8_t* conflict,
    int32_t* assign, uint8_t* node_mask, float* node_used, uint8_t* node_active,
    int32_t* node_count, int32_t* unsched, uint32_t* free_bits, int32_t* kcap,
    int32_t* row_cfg, uint32_t* flat_words,
    int G, int C, int R, int E, int N, int K, int P1, int cost, int smem, int threads,
    const int* placement, unsigned char* tables, long long block_bytes, cudaStream_t stream) {
  if (R > kMaxR || E > N || (flat_words && C % 32)) return (int)cudaErrorInvalidValue;
  Placement p = make_placement(placement, tables, block_bytes);
  if (placement ? check_placement(p, C, R, P1, K, G, false, 0, 0, smem)
                : smem < table_layout(C, R, P1, K, G).end)
    return (int)cudaErrorInvalidValue;
  const bool placed = placement != nullptr;
  const void* kernel = threads == kThreads ? dense_kernel<kThreads>(placed)
                       : threads == 256    ? dense_kernel<256>(placed)
                                           : nullptr;
  if (!kernel) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  Args a{};
  a.compat = compat, a.group_req = group_req, a.group_count = group_count;
  a.cfg_alloc = cfg_alloc, a.cfg_pool = cfg_pool, a.pool_overhead = pool_overhead;
  a.existing_mask = existing_mask, a.existing_used = existing_used, a.cfg_price = cfg_price;
  a.quota = quota, a.cfg_rsv = cfg_rsv, a.rsv_cap = rsv_cap, a.group_cap = group_cap;
  a.conflict = conflict;
  a.assign = assign, a.node_mask = node_mask, a.free_used = node_used;
  a.node_active = node_active, a.node_count = node_count, a.unsched = unsched;
  a.free_bits = free_bits, a.kcap = kcap, a.row_cfg = row_cfg, a.flat_words = flat_words;
  a.G = G, a.C = C, a.R = R, a.E = E, a.F = N, a.K = K, a.P1 = P1, a.cost = cost;
  void* params[] = {&a, &p};
  const cudaError_t lerr =
      cudaLaunchKernel(kernel, dim3(1), dim3(threads), params, (size_t)smem, stream);
  if (lerr != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)lerr;
  }
  return (int)cudaGetLastError();
}

extern "C" int pack_dense_barrier_probe_launch(int n, int threads, int* sink,
                                               cudaStream_t stream) {
  if (threads == kThreads) pack_dense_barrier_probe_kernel<kThreads><<<1, kThreads, 0, stream>>>(n, sink);
  else if (threads == 256) pack_dense_barrier_probe_kernel<256><<<1, 256, 0, stream>>>(n, sink);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
