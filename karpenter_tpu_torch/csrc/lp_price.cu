// B4: the column-generation pricing kernel of the cost objective.
//
// Replaces karpenter_tpu/solver/lp_plan.py::_price_kernel (a jitted
// while_loop). Plain version: karpenter_tpu_torch/solver/lp_plan.py::
// price_kernel_ref, which this kernel matches bit for bit.
//
// What it computes, per config c: the greedy fill q[c] of the
// multi-dimensional knapsack. Each round every group gets
//   k_g = min_r (req>0 ? floor((resid+1e-4)/max(req,1e-9)) : 2e9),
// capped at count_g - q_g; the group with the highest density
// (lam_g / max_r req_g,r/alloc_c,r among positive duals and compatible
// groups) among those with k_g >= 1 wins, the lowest index on a tie;
// if its density is not positive the config stops, else q_best += k
// and resid -= k * req_best. At most G rounds. value[c] is
// sum_g q[c,g] * lam_g, summed in a fixed order: the order in which the
// JAX package's XLA program sums it on the CPU, which the plain version
// follows too, so all three agree bit for bit.
//
// What bounds it: the rounds. Each config's fill is a serial chain of
// up to G dependent rounds; the bytes (G*C compat bytes, the small
// vectors, q out) and the arithmetic are far below what the chain costs
// (0.0000732 ms of bytes against ~0.027 ms a call before this design on
// an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6). A chain was a
// prologue (its densities, G x R IEEE divisions), a few rounds of ~2.7-4.8k
// cycles (three block barriers and a block argmax each) and a value sum
// of ~23k cycles by one thread. So:
//   - the prologue stays spread over the block (a group a thread, one
//     pass), the groups' requests, duals and demand staged into shared
//     memory;
//   - then one warp runs the rounds with no block barrier: lane l owns
//     the groups l, l + 32, ... (their densities and fills are read and
//     written by that lane only), the residual is in shared memory,
//     updated by R lanes after the winner's take;
//   - while every request is finite and >= 0 and every dual and the
//     config's allocatable finite (`monotone`), a group's k never rises
//     (the residual only falls, and so does count - q): a group that
//     cannot take a pod never can again. So each lane keeps its groups
//     of positive density in (-density, index) order and walks them with
//     a pointer that never goes back: its candidate is the first that can
//     take a pod, most rounds one test; k >= 1 is decided without the
//     division (`quot_ge1`: the division runs only within an ulp of the
//     boundary); only the winner's full k is computed, its R terms by R
//     lanes at once and their least by one reduction;
//   - the argmax is two hardware warp reductions (the least ordered
//     -density, then the least index holding it): the same winner as a
//     min over packed (value, index) keys;
//   - otherwise (a negative or non-finite request, a non-finite dual or
//     allocatable) every round takes every group's exact k, as before;
//     the plain version is the judge of both;
//   - the value's windows are summed a lane a window, each from its
//     first term, in XLA's order.
// A warp a config for the prologue too was slower (its G x R divisions
// 8x less parallel).
// Layouts (`PriceLayout`, chosen by the wrapper, lp_plan.price_layout):
// the groups' requests, duals and demand staged in shared memory with
// the densities, the fills and each lane's walk order (kPriceStaged,
// G (4R + 16) + 4 * 32 ceil(G/32) bytes); past the budget, the requests,
// duals and demand read where their inputs lie (the kernel's <false>
// instantiation), with the walk order (kPriceWalk) or without it
// (kPriceFull: every round a full argmax, 8 G bytes, as many groups as
// before this design); the value's windows reuse the densities' place. What is left is the rounds: ~3.3-12k cycles a
// round on an NVIDIA H100 80GB HBM3 at 700 W, most of it the lanes'
// scans (PERF.md §6).
// Phase clocks (-DKARPENTER_PHASE_CLOCKS, `PriceClock`): every config's
// prologue, rounds and value sum, its rounds, the least and most cycles
// a round took, a round's parts, and the configs on the monotone path.
//
// Exactness: f32 with explicit round-to-nearest intrinsics in the JAX
// order of operations, -fmad=false in the build; the pick is the
// lowest-index argmax, independent of reduction order.

#include "pack_common.cuh"

namespace {

constexpr int kPriceThreads = 256;  // a config a block

// Phase clocks, in a build with -DKARPENTER_PHASE_CLOCKS only: each
// config's chain (its block's thread 0) adds the clock64() cycles of its
// density prologue, its rounds and its value sum to slots 0, 1 and 2 of
// g_phase_clk, its rounds to slot 3, and raises slot 4 to the most rounds
// of a config and slot 5 to the most cycles of a round's chain (its
// rounds' cycles over its rounds) and slot 6 lowers ~ the least, slot 7
// counts the configs on the monotone path, slots 8-11 the rounds' parts
// (the scan, the winner, the take, the update) and slot 31 all;
// g_phase_ns sums the global timer's ns over the same spans (with the
// cycles, the SM clock the chains ran at).
struct PriceClock {
#ifdef KARPENTER_PHASE_CLOCKS
  long long t = 0, t_rounds = 0;
  unsigned long long ns = 0;
  bool on = false;
  __device__ void begin(bool lead) {
    on = lead;
    t = clock64();
    ns = xclock();
  }
  __device__ void mark(int slot) {
    if (!on) return;
    const long long t1 = clock64();
    const unsigned long long ns1 = xclock();
    atomicAdd(&g_phase_clk[slot], (unsigned long long)(t1 - t));
    atomicAdd(&g_phase_ns, ns1 - ns);
    if (slot == 1) t_rounds = t1 - t;
    t = t1;
    ns = ns1;
  }
  // a part of a round (slot 8 + part: the scan, the winner, the take,
  // the residual's update), timed from the last part's end
  long long t_part = 0;
  __device__ void part(int k) {
    if (!on) return;
    const long long t1 = clock64();
    if (k >= 0) atomicAdd(&g_phase_clk[8 + k], (unsigned long long)(t1 - t_part));
    t_part = t1;
  }
  // entries a lane's walk tested (slot 12: lane 0's; slot 13: the most
  // of any lane in a round, summed over rounds)
  __device__ void walk(unsigned mine, unsigned most) {
    if (!on) return;
    atomicAdd(&g_phase_clk[12], (unsigned long long)mine);
    atomicAdd(&g_phase_clk[13], (unsigned long long)most);
  }
  __device__ void rounds(int n, bool monotone) {
    if (!on) return;
    if (monotone) atomicAdd(&g_phase_clk[7], 1ull);
    atomicAdd(&g_phase_clk[3], (unsigned long long)n);
    atomicMax(&g_phase_clk[4], (unsigned long long)n);
    atomicAdd(&g_phase_clk[kClockSlots - 1], 1ull);
    if (n > 0) {
      const unsigned long long per = (unsigned long long)(t_rounds / n);
      atomicMax(&g_phase_clk[5], per);
      atomicMax(&g_phase_clk[6], ~per);
    }
  }
#else
  __device__ void begin(bool) {}
  __device__ void mark(int) {}
  __device__ void part(int) {}
  __device__ void walk(unsigned, unsigned) {}
  __device__ void rounds(int, bool) {}
#endif
};

// k_g: the pods of group g that fit the residual, capped at its demand
// left (as the JAX body computes it, before the k >= 1 test)
__device__ __forceinline__ float fit_count(const float* resid, const float* req, int R,
                                           int left) {
  float k = __int_as_float(0x7f800000);  // +inf, the identity of the JAX min
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float rq = req[r];
    float v = 2.0e9f;
    if (rq > 0.0f) v = floorf(__fdiv_rn(__fadd_rn(resid[r], 1e-4f), fmaxf(rq, 1e-9f)));
    k = fminf(k, v);
  }
  return fminf(k, (float)left);
}

// RN(a / b) >= 1 for a finite b > 0, without the division unless a lies
// just below b: a >= b gives a quotient >= 1; a below RN(b (1 - 2^-23))
// <= b (1 - 2^-23)(1 + 2^-24) gives a / b < 1 - 2^-24, which rounds below
// 1 (the midpoint 1 - 2^-25 rounds to 1); between the two, the division
// decides.
__device__ __forceinline__ bool quot_ge1(float a, float b) {
  if (a >= b) return true;
  if (a < __fmul_rn(b, 0.99999988079071044921875f)) return false;
  return __fdiv_rn(a, b) >= 1.0f;
}

// B4's layouts (see the header)
enum PriceLayout { kPriceStaged = 0, kPriceWalk = 1, kPriceFull = 2 };

// the dynamic shared memory of a block in layout `layout`
__host__ __device__ inline size_t price_smem(int G, int R, int layout) {
  const size_t nwin = (size_t)(G + 31) / 32;
  const size_t staged = layout == kPriceStaged ? (size_t)G * (R + 2) : 0;
  const size_t ord = layout == kPriceFull ? 0 : nwin * 32;
  return 4 * (staged + 2 * (size_t)G + ord);
}

// One config a block: every thread stages (kStaged) the groups'
// requests, duals and demand and takes the densities (a group a thread),
// then warp 0 alone runs the rounds and the value sum. Shared memory:
// (kStaged) requests [G, R], duals [G], demand [G]; densities [G] (then
// read by their owner lane only; after the rounds, the value's two
// window buffers [ceil(G/32)] each), fills [G] (read and written by their
// owner lane), and (`walk`) each lane's groups in order [ceil(G/32), 32].
template <bool kStaged>
__global__ void __launch_bounds__(kPriceThreads) lp_price_kernel(
    const float* __restrict__ lam, const uint8_t* __restrict__ compat,
    const float* __restrict__ group_req, const float* __restrict__ eff_alloc,
    const int32_t* __restrict__ count, int32_t* __restrict__ q_out,
    float* __restrict__ value, int G, int C, int R, int walk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float resid[kMaxR];  // the residual: thread r < R writes it
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = blockIdx.x;
  const int nwin = (G + 31) / 32;
  float* st_req = (float*)smem;                              // kStaged: [G, R]
  float* st_lam = st_req + (size_t)G * R;                    // kStaged: [G]
  int32_t* st_count = (int32_t*)(st_lam + G);                // kStaged: [G]
  float* density = kStaged ? (float*)(st_count + G) : (float*)smem;  // [G]
  int32_t* q = (int32_t*)(density + G);                      // [G]
  int32_t* ord = q + G;                      // walk: [nwin, 32], lane l's column its groups
  float* win_a = density;                    // after the rounds: [nwin]
  float* win_b = density + nwin;             // [nwin] (2 nwin <= G where G > 32)
  const float* s_req = kStaged ? st_req : group_req;
  const float* s_lam = kStaged ? st_lam : lam;
  const int32_t* s_count = kStaged ? st_count : count;
  const float* alloc = eff_alloc + (size_t)c * R;
  PriceClock clk;
  clk.begin(tid == 0);

  // ---- the prologue, a group a thread in one pass: its request, dual
  // and demand staged into shared memory (kStaged), its density, and
  // whether every request is finite and >= 0 and every dual and this
  // config's allocatable finite
  int bad = 0;
  if (tid < R) {
    const float x = alloc[tid];
    resid[tid] = x;
    bad |= !(x >= -3.4028234663852886e38f && x <= 3.4028234663852886e38f);
  }
  for (int g = tid; g < G; g += kPriceThreads) {
    const bool ok = compat[(size_t)g * C + c];
    const float l = lam[g];
    if (kStaged) {
      st_lam[g] = l;
      st_count[g] = count[g];
    }
    bad |= !(l >= -3.4028234663852886e38f && l <= 3.4028234663852886e38f);
    float frac = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float x = group_req[(size_t)g * R + r];
      if (kStaged) st_req[(size_t)g * R + r] = x;
      bad |= !(x >= 0.0f && x <= 3.4028234663852886e38f);
      const float f = x > 0.0f ? __fdiv_rn(x, fmaxf(alloc[r], 1e-9f)) : 0.0f;
      frac = fmaxf(frac, f);
    }
    density[g] = (l > 0.0f && ok && frac > 0.0f) ? __fdiv_rn(l, frac) : -1.0f;
    q[g] = 0;
  }
  bad = __syncthreads_or(bad);
  clk.mark(0);
  if (tid >= 32) return;  // warp 0 alone from here: no block barrier below

  const bool monotone = !bad && walk;
  // monotone: lane l's groups l, l + 32, ... that can win (a positive
  // density, a pod to place), in (-density, index) order, in column l of
  // `ord` (an insertion sort, a few entries a lane); a pointer walks them
  // and never goes back: a group that cannot take a pod never can again
  int n_ord = 0, head = 0;
  if (monotone) {
    for (int g = lane; g < G; g += 32) {
      if (!(density[g] > 0.0f && s_count[g] >= 1)) continue;
      const uint32_t v = float_key(-density[g]);
      int i = n_ord++;
      for (; i > 0; --i) {  // groups come in index order: a tie stays behind
        const int h = ord[(i - 1) * 32 + lane];
        if (float_key(-density[h]) <= v) break;
        ord[i * 32 + lane] = h;
      }
      ord[i * 32 + lane] = g;
    }
  }
  int round = 0;
  for (; round < G; ++round) {
    clk.part(-1);
    // ---- this lane's candidate: the least (-density, index) among its
    // groups that can take a pod
    uint32_t best_v = 0xffffffffu;
    int best_g = kIntBig;
    if (monotone) {
      // the residual plus 1e-4, the first four resources in registers
      const Row4 rs = load4(resid, R);
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = __fadd_rn(rs.u[r], 1e-4f);
#ifdef KARPENTER_PHASE_CLOCKS
      const int head0 = head;
#endif
      for (; head < n_ord; ++head) {
        const int g = ord[head * 32 + lane];
        const float* req = s_req + (size_t)g * R;
        const Row4 rq = load4(req, R);  // one 16-byte load at R = 4
        bool ok = s_count[g] - q[g] >= 1;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < R && rq.u[r] > 0.0f) ok &= quot_ge1(a[r], fmaxf(rq.u[r], 1e-9f));
        for (int r = 4; r < R && ok; ++r)
          if (req[r] > 0.0f) ok = quot_ge1(__fadd_rn(resid[r], 1e-4f), fmaxf(req[r], 1e-9f));
        if (ok) {  // the lane's best; the pointer stays on it
          best_v = float_key(-density[g]);
          best_g = g;
          break;
        }
      }
#ifdef KARPENTER_PHASE_CLOCKS
      const unsigned tested = (unsigned)(head - head0 + (head < n_ord));
      clk.walk(tested, __reduce_max_sync(0xffffffffu, tested));
#endif
    } else {
      for (int g = lane; g < G; g += 32) {
        const float k = fit_count(resid, s_req + (size_t)g * R, R, s_count[g] - q[g]);
        const float cand = k >= 1.0f ? density[g] : -1.0f;
        const uint32_t v = float_key(-cand);
        if (v < best_v) {
          best_v = v;
          best_g = g;
        }
      }
    }
    clk.part(0);
    // ---- the warp's winner: the least value, then the least index
    const uint32_t wv = __reduce_min_sync(0xffffffffu, best_v);
    const int best = __reduce_min_sync(0xffffffffu, best_v == wv ? best_g : kIntBig);
    clk.part(1);
    if (best >= G) break;  // monotone: no group can take a pod
    const float best_val = -key_float(wv);
    if (!(best_val > 0.0f)) break;  // uniform: every lane holds the warp's winner
    // the take is the winner's k (`fit_count`'s terms, a lane a resource,
    // their least by one reduction: fminf's order does not change it, no
    // term is NaN, and a winner's k is at least 1), then capped at its
    // demand left
    const float* breq = s_req + (size_t)best * R;
    float term = __int_as_float(0x7f800000);  // +inf, the identity of the JAX min
    for (int r = lane; r < R; r += 32) {
      const float rq = breq[r];
      float v = 2.0e9f;
      if (rq > 0.0f) v = floorf(__fdiv_rn(__fadd_rn(resid[r], 1e-4f), fmaxf(rq, 1e-9f)));
      term = fminf(term, v);
    }
    const int left = s_count[best] - q[best];
    const float take =
        fminf(key_float(__reduce_min_sync(0xffffffffu, float_key(term))), (float)left);
    if (lane == (best & 31)) q[best] += (int32_t)take;  // every lane is past its reads
    clk.part(2);
    if (lane < R) resid[lane] = __fsub_rn(resid[lane], __fmul_rn(take, breq[lane]));
    __syncwarp();
    clk.part(3);
  }
  clk.mark(1);

  // ---- q out, and value = sum_g q * lam in the order of the JAX
  // package's XLA program on the CPU (lp_plan.row_value): up to 32 groups
  // one fused multiply-add chain; beyond, the rounded products in windows
  // of 32 (half the zero padding in front), each window summed from its
  // first term by a lane of its own, the window sums reduced the same way
  // until at most 32 are left, then in order
  int32_t* qrow = q_out + (size_t)c * G;
  for (int g = lane; g < G; g += 32) qrow[g] = q[g];
  __syncwarp();  // every lane's fills are in shared memory
  float s = 0.0f;
  if (G <= 32) {
    if (lane == 0)
      for (int g = 0; g < G; ++g) s = __fmaf_rn((float)q[g], s_lam[g], s);
  } else {
    int n = G;
    const float* in = nullptr;  // the first level reads the products
    float* out = win_a;
    while (n > 32) {
      const int nw = (n + 31) / 32;
      const int front = (nw * 32 - n) / 2;
      for (int j = lane; j < nw; j += 32) {
        float w = 0.0f;
        for (int i = 0; i < 32; ++i) {
          const int idx = 32 * j + i - front;
          float x = 0.0f;
          if (idx >= 0 && idx < n) x = in ? in[idx] : __fmul_rn((float)q[idx], s_lam[idx]);
          w = __fadd_rn(w, x);
        }
        out[j] = w;
      }
      __syncwarp();
      n = nw;
      in = out;
      out = out == win_a ? win_b : win_a;
    }
    if (lane == 0)
      for (int j = 0; j < n; ++j) s = __fadd_rn(s, in[j]);
  }
  if (lane == 0) {
    value[c] = s;
    clk.mark(2);
    clk.rounds(round, monotone);
  }
}

}  // namespace

// `layout`: a PriceLayout (lp_plan.price_layout); refused when its
// dynamic shared memory is past the card's 232,448 bytes a block less
// the kernel's static 1 KB.
extern "C" int lp_price_launch(const float* lam, const uint8_t* compat,
                               const float* group_req, const float* eff_alloc,
                               const int32_t* count, int32_t* q, float* value,
                               int G, int C, int R, int layout, cudaStream_t stream) {
  if (R > kMaxR || R < 1 || G < 1 || C < 1 || layout < kPriceStaged || layout > kPriceFull)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = price_smem(G, R, layout);
  if (shmem > 232448 - 1024) return (int)cudaErrorInvalidValue;
  const bool staged = layout == kPriceStaged;
  const void* kernel = staged ? (const void*)lp_price_kernel<true>
                              : (const void*)lp_price_kernel<false>;
  if (shmem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  if (staged)
    lp_price_kernel<true><<<C, kPriceThreads, shmem, stream>>>(
        lam, compat, group_req, eff_alloc, count, q, value, G, C, R, 1);
  else
    lp_price_kernel<false><<<C, kPriceThreads, shmem, stream>>>(
        lam, compat, group_req, eff_alloc, count, q, value, G, C, R, layout == kPriceWalk);
  return (int)cudaGetLastError();
}
