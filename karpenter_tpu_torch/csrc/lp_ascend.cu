// B5: the dual ascent of the cost objective's config-level LP.
//
// Replaces karpenter_tpu/solver/lp_device.py::_ascend (a jitted
// fori_loop whose step gradient came from jax.grad). Plain version:
// karpenter_tpu_torch/solver/lp_device.py::ascend_ref, which this
// kernel matches bit for bit.
//
// Each of the n_iters iterations takes the supergradient of the dual
// bound
//   bound_w(lam) = dot(lam/theta, count_w) - dot(mu, budget),
//   mm[c,r] = max_g (compat[g,c] ? ratio[g,r] : 0),
//   ratio[g,r] = (req>0 & count>0) ? lam_g / req[g,r] : 0,
//   vh0[c] = min_r (valid ? mm*alloc : inf), vh = finite(vh0) ? vh0 : 0,
//   theta = max(max_c z, eps), z[c] = (uncapped & price>0) ? vh/max(price,eps) : 0,
//   mu[k] = max_c (onehot[k,c] ? max(vh/theta - price, 0) : 0),
// written out by hand with JAX's tie rules (a max or min reduction
// splits its cotangent evenly over every element equal to the result,
// padding and masked zeros included; maximum gives each side half at
// an exact tie; where(isfinite) passes the cotangent only where vh0 is
// finite), steps along the normalized supergradient with
// eta = 0.5/sqrt(1+t) scaled by max(max(lam), 1e-9) (one multiply-add,
// as XLA contracts it), projects onto lam >= 0 and keeps the best
// iterate. Every sum is taken in the order the JAX package's XLA
// program takes it on the CPU (lp_device.py: xla_sum, xla_dot,
// fma_chain): up to 32 terms in order (a product fused into a multiply-
// add chain), beyond that in windows of 32 after XLA's padding, the
// window sums reduced the same way; the bound's dot as XLA's vector
// loop (lp_device.dot_plan).
//
// What bounds it: the iterations. They form one dependent chain of
// small steps (at 50k pods x 500 types: Gp=194 groups, Cp=243 configs,
// R=4, Kp=64), so the design is one persistent block for the whole
// ascent (512 threads: at 1024 the 64-register cap spilled; no phase
// has much more than 512 independent items), with every table and every
// per-iteration array in the block's dynamic shared memory, loaded once
// a launch, and eight phases an iteration between block barriers, each
// spread over the block:
//   - the column maxima over groups and their tie counts are taken once
//     for each distinct compat column (`ulist`: configs whose columns
//     are equal share them), a few lanes a column over its compatible
//     groups' bits, merged by shuffles; the masked zeros enter as the
//     count of incompatible rows;
//   - theta's, mu's and lam's maxima and every tie count are order-free
//     (shuffles, ballots, shared-memory atomics on counts and on the
//     bits of non-negative floats);
//   - an ordered sum keeps XLA's windows but skips the terms that are
//     exactly +-0 (a sum started at +0 is unchanged by them): the terms
//     of dtheta_b and of the [G, R] d ratio sums are set bits of window
//     masks, built by scatter (d ratio's nonzero terms are the tied
//     groups of each column maximum), and a lane a row walks its
//     windows' bits in index order; a term that is NaN or +-inf is kept;
//   - the dense sums (dtheta_a, the norm) take a lane a window; the
//     serial chains (the dot's eight lanes over lam / theta, computed by
//     the whole block a phase before, and mu . budget) run on two warps
//     side by side, their operands loaded eight at a time ahead of the
//     multiply-adds; an array's address is computed where it is used
//     (`Ctx`), which kept the kernel clear of register spills.
// A shape whose arrays exceed the shared memory runs the same code with
// the arrays that do not fit in global scratch (`Layout`, chosen by the
// wrapper from the bytes: lp_device.ascent_layout).
//
// B8, split B5 (lp_device.py:430-452, the ascent under
// KARPENTER_LP_SHARDS): the same code over the config axis split into S
// column blocks, one cooperative launch of S blocks
// (`lp_ascend_sharded_kernel`), each with its own replica of lam and the
// per-group state. Per iteration the shards exchange (shard_xchg.cuh):
// theta's maximum, mu's [Kp] maxima and their tie counts, theta's tie
// count, and the partial sums over configs — dtheta_b and the [Gp, R]
// d ratio — combined in shard order. Plain version:
// lp_device.py::ascend_sharded_ref.
//
// Exactness: f32 with explicit round-to-nearest intrinsics in the
// plain version's order of operations, -fmad=false in the build (the
// multiply-adds are explicit __fmaf_rn).

#include "pack_common.cuh"

namespace {

constexpr int kAscThreads = 512;
constexpr int kAscWarps = kAscThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;
constexpr float kInf = __builtin_huge_valf();
// the widest group and config axes (16-bit group indices and tie
// counts; two levels of windows for an ordered sum)
constexpr int kMaxAxis = 2048;
constexpr int kMaxSlots = 32767;
// phase-clock slot of the block barriers (PhaseClock in pack_common.cuh)
constexpr int kBarrierSlot = 30;

#ifdef KARPENTER_PHASE_CLOCKS
__device__ __forceinline__ unsigned& bar_count() {
  __shared__ unsigned n;
  return n;
}
#endif

// The regions inside a phase that a phase-clock build also times, on
// the thread that runs each (lane 0 of the warp a chain runs on, else
// thread 0), into slots kRegionSlot + region (pack_split.REGIONS).
enum Region {
  R_COLMAX, R_VH0, R_EXCESS, R_DTHETA_A, R_DOT, R_MU_BUDGET, R_MU_TIES, R_DTHETA_B,
  R_DVH_QX, R_DRATIO, R_GRAD, R_NORM, R_UPDATE, R_ZERO, R_REGIONS
};
constexpr int kRegionSlot = 16;

#ifdef KARPENTER_PHASE_CLOCKS
__device__ __forceinline__ unsigned long long* region_acc() {
  __shared__ unsigned long long acc[R_REGIONS];
  return acc;
}
struct RegionTimer {
  long long t0 = 0;
  bool on;
  __device__ explicit RegionTimer(bool who) : on(who && blockIdx.x == 0) {
    if (on) t0 = clock64();
  }
  __device__ void stop(int region) {
    if (on) region_acc()[region] += (unsigned long long)(clock64() - t0);
  }
};
#else
struct RegionTimer {
  __device__ explicit RegionTimer(bool) {}
  __device__ void stop(int) {}
};
#endif

// a block barrier, counted in a phase-clock build
__device__ __forceinline__ void bar() {
  __syncthreads();
#ifdef KARPENTER_PHASE_CLOCKS
  if (threadIdx.x == 0) ++bar_count();
#endif
}

struct Args {
  const float* lam0;        // [Gp]
  const float* count;       // [Gp]
  const float* count_w;     // [Gp]
  const uint8_t* compat;    // [Gp, Cp]
  const float* req;         // [Gp, R]
  const float* alloc;       // [Cp, R]
  const float* price;       // [Cp]
  const uint8_t* valid;     // [Cp, R]
  const uint8_t* onehot;    // [Kp, Cp], at most one slot a config
  const float* budget;      // [Kp]
  const uint8_t* uncapped;  // [Cp]
  float* best;              // scalar out
  float* best_lam;          // [Gp] out
  int32_t* last_up;         // scalar out
  int G, C, R, K, n_iters;
};

// ---- the block's arrays: each in dynamic shared memory or in global
// scratch, in this order of priority (lp_device.ascent_layout computes
// the same bytes and places them)
enum Arr {
  A_LAM,      // f32 [G] the iterate
  A_RATIO,    // f32 [G, R]
  A_MM,       // f32 [C, R] column maxima, by distinct column (first nu rows)
  A_TINFO,    // u32 [C, R] first tied compatible group | compatible ties << 16
  A_QX,       // f32 [C, R] dmm / ties
  A_UIDX,     // u32 [C] the distinct column of a config
  A_CFLAG,    // u32 [C] valid bits 0-15, uncapped bit 16, slot + 1 from bit 17
  A_ALLOC,    // f32 [C, R]
  A_PRICE,    // f32 [C]
  A_VH0,      // f32 [C]
  A_Z,        // f32 [C]
  A_EXCESS,   // f32 [C]
  A_DX,       // f32 [C] d vh from the excess
  A_TB,       // f32 [C] dtheta_b's terms (its first factors, C <= 32)
  A_TY,       // f32 [C] dtheta_b's second factors (C <= 32)
  A_GRAD,     // f32 [G]
  A_DRATIO,   // f32 [G, R]
  A_REQ,      // f32 [G, R]
  A_CNT,      // f32 [G]
  A_CW,       // f32 [G]
  A_BEST,     // f32 [G] the best iterate
  A_NCOMP,    // u32 [C] compatible groups of a distinct column
  A_MU,       // u32 [K] bits of mu (non-negative)
  A_NM,       // u32 [K] mu's tie counts
  A_KSIZE,    // u32 [K] configs of a slot
  A_BUDGET,   // f32 [K]
  A_TBMASK,   // u32 [nwin(C)] dtheta_b's nonzero terms
  A_ULIST,    // u32 [C] the configs whose columns are distinct
  A_COLBITS,  // u32 [C, Gw] compat columns as bit words over groups
  A_MASKS,    // u32 [G, R, nwin(C)] d ratio's nonzero terms
  A_COUNT
};

struct Layout {
  long long off[A_COUNT];  // >= 0: shared-memory byte offset; < 0: ~byte offset in scratch
};

__host__ __device__ __forceinline__ int win_count(int n) { return n > 32 ? (n + 31) / 32 : 1; }
__host__ __device__ __forceinline__ int win_front(int n) {
  return n > 32 ? (win_count(n) * 32 - n) / 2 : 0;
}

__host__ __forceinline__ long long arr_bytes(int i, int G, int C, int R, int K) {
  const long long g = G, c = C, r = R, k = K;
  const long long nw = win_count(C), gw = (G + 31) / 32;
  switch (i) {
    case A_LAM: case A_GRAD: case A_CNT: case A_CW: case A_BEST: return 4 * g;
    case A_RATIO: case A_DRATIO: case A_REQ: return 4 * g * r;
    case A_MM: case A_TINFO: case A_QX: case A_ALLOC: return 4 * c * r;
    case A_UIDX: case A_CFLAG: case A_PRICE: case A_VH0: case A_Z: case A_EXCESS:
    case A_DX: case A_TB: case A_TY: case A_NCOMP: case A_ULIST: return 4 * c;
    case A_MU: case A_NM: case A_KSIZE: case A_BUDGET: return 4 * k;
    case A_TBMASK: return 4 * nw;
    case A_COLBITS: return 4 * c * gw;
    case A_MASKS: return 4 * g * r * nw;
  }
  return 0;
}

// the arrays of one block: each address computed where it is used from
// the layout (a kernel parameter) and the two bases, so that no array's
// pointer holds a register across the ascent
struct Ctx {
  const Layout& L;
  unsigned char* smem;
  unsigned char* scratch;
  template <class T>
  __device__ __forceinline__ T* at(int i) const {
    const long long o = L.off[i];
    return reinterpret_cast<T*>(o >= 0 ? smem + o : scratch + ~o);
  }
  __device__ float* lam() const { return at<float>(A_LAM); }
  __device__ float* ratio() const { return at<float>(A_RATIO); }
  __device__ float* mm() const { return at<float>(A_MM); }
  __device__ unsigned* tinfo() const { return at<unsigned>(A_TINFO); }
  __device__ float* qx() const { return at<float>(A_QX); }
  __device__ unsigned* uidx() const { return at<unsigned>(A_UIDX); }
  __device__ unsigned* cflag() const { return at<unsigned>(A_CFLAG); }
  __device__ float* alloc() const { return at<float>(A_ALLOC); }
  __device__ float* price() const { return at<float>(A_PRICE); }
  __device__ float* vh0() const { return at<float>(A_VH0); }
  __device__ float* z() const { return at<float>(A_Z); }
  __device__ float* excess() const { return at<float>(A_EXCESS); }
  __device__ float* dx() const { return at<float>(A_DX); }
  __device__ float* tb() const { return at<float>(A_TB); }
  __device__ float* ty() const { return at<float>(A_TY); }
  __device__ float* grad() const { return at<float>(A_GRAD); }
  __device__ float* dratio() const { return at<float>(A_DRATIO); }
  __device__ float* req() const { return at<float>(A_REQ); }
  __device__ float* cnt() const { return at<float>(A_CNT); }
  __device__ float* cw() const { return at<float>(A_CW); }
  __device__ float* best() const { return at<float>(A_BEST); }
  __device__ unsigned* ncomp() const { return at<unsigned>(A_NCOMP); }
  __device__ unsigned* mu() const { return at<unsigned>(A_MU); }
  __device__ unsigned* nm() const { return at<unsigned>(A_NM); }
  __device__ unsigned* ksize() const { return at<unsigned>(A_KSIZE); }
  __device__ float* budget() const { return at<float>(A_BUDGET); }
  __device__ unsigned* tbmask() const { return at<unsigned>(A_TBMASK); }
  __device__ unsigned* ulist() const { return at<unsigned>(A_ULIST); }
  __device__ unsigned* colbits() const { return at<unsigned>(A_COLBITS); }
  __device__ unsigned* masks() const { return at<unsigned>(A_MASKS); }
};

// the scalars of an iteration, shared by the block
struct Scalars {
  float red[kAscWarps];   // per-warp maxima (z, then lam)
  float theta0, t1, t2, dtheta_a;
  unsigned nz, nu;
};

// a / b rounded to nearest, as __fdiv_rn: a zero dividend over a nonzero,
// non-NaN divisor is the zero of the signs' product without the
// division, whose check sends a zero dividend to its slow path (most of
// the supergradient's quotients have one)
__device__ __forceinline__ float div_rn(float a, float b) {
  if (a == 0.0f && b != 0.0f && !isnan(b))
    return __uint_as_float((__float_as_uint(a) ^ __float_as_uint(b)) & 0x80000000u);
  return __fdiv_rn(a, b);
}

__device__ __forceinline__ float tie_weight(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

__device__ __forceinline__ float pden_of(float p) { return p > kEps ? p : kEps; }

__device__ __forceinline__ float vh_of(float v0) { return isfinite(v0) ? v0 : 0.0f; }

__device__ __forceinline__ int slot_of_flag(unsigned f) { return (int)(f >> 17) - 1; }

__device__ __forceinline__ float warp_max_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ---- ordered sums, by one warp (every lane returns the sum)

// the value of window w of a warp's window sums: lane w & 31 holds
// windows w (< 32) and w + 32 in lo and hi
__device__ __forceinline__ float win_get(float lo, float hi, int w) {
  const float a = __shfl_sync(kFull, lo, w & 31);
  const float b = __shfl_sync(kFull, hi, w & 31);
  return w < 32 ? a : b;
}

// sum of nw window sums (lane w & 31: lo, hi) in XLA's order: up to 32
// in order from +0, beyond in windows of 32 after XLA's padding
__device__ float win_total(float lo, float hi, int nw) {
  float tot = 0.0f;
  if (nw <= 32) {
    for (int w = 0; w < nw; ++w) tot = __fadd_rn(tot, __shfl_sync(kFull, lo, w));
    return tot;
  }
  const int nw2 = win_count(nw), front2 = win_front(nw);
  for (int W = 0; W < nw2; ++W) {
    float s = 0.0f;
    for (int i = 0; i < 32; ++i) {
      const int p = W * 32 + i - front2;
      const float v = win_get(lo, hi, p < 0 ? 0 : (p < nw ? p : nw - 1));
      if (p >= 0 && p < nw) s = __fadd_rn(s, v);
    }
    tot = __fadd_rn(tot, s);
  }
  return tot;
}

// sum_{i<n} x(i) * y(i) in XLA's order (lp_device.xla_sum(x, y)): up to
// 32 terms one multiply-add chain in order, beyond the products rounded
// and summed in windows, a lane a window, the operands of a window
// loaded ahead of its adds
template <class FX, class FY>
__device__ float warp_sum_prod(FX xf, FY yf, int n) {
  const int lane = threadIdx.x & 31;
  if (n <= 32) {
    const float xv = lane < n ? xf(lane) : 0.0f, yv = lane < n ? yf(lane) : 0.0f;
    float s = 0.0f;
    for (int i = 0; i < n; ++i)
      s = __fmaf_rn(__shfl_sync(kFull, xv, i), __shfl_sync(kFull, yv, i), s);
    return s;
  }
  const int nw = win_count(n), front = win_front(n);
  float lo = 0.0f, hi = 0.0f;
  for (int w = lane; w < nw; w += 32) {
    float s = 0.0f;
    for (int i0 = 0; i0 < 32; i0 += 8) {
      float t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = w * 32 + i0 + i - front;
        const int pc = p < 0 ? 0 : (p < n ? p : n - 1);
        const float v = __fmul_rn(xf(pc), yf(pc));
        t[i] = (p >= 0 && p < n) ? v : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s = __fadd_rn(s, t[i]);
    }
    if (w < 32) lo = s; else hi = s;
  }
  return win_total(lo, hi, nw);
}

// the same sum with its zero terms skipped: `mask` holds, for each
// window, the bits of the terms that are not exactly +-0 (a product
// that is NaN or +-inf, or that a multiply-add would not add exactly,
// is set); `x` the rounded products (n > 32) or the first factors and
// `y` the second factors (n <= 32, the multiply-add chain)
__device__ float warp_sum_masked(const unsigned* mask, const float* x, const float* y, int n) {
  const int lane = threadIdx.x & 31;
  if (n <= 32) {
    unsigned m = mask[0];
    float s = 0.0f;
    while (m) {
      const int i = __ffs(m) - 1;
      m &= m - 1;
      s = __fmaf_rn(x[i], y[i], s);
    }
    return s;
  }
  const int nw = win_count(n), front = win_front(n);
  float lo = 0.0f, hi = 0.0f;
  for (int w = lane; w < nw; w += 32) {
    unsigned m = mask[w];
    float s = 0.0f;
    while (m) {
      const int i = __ffs(m) - 1;
      m &= m - 1;
      s = __fadd_rn(s, x[w * 32 + i - front]);
    }
    if (w < 32) lo = s; else hi = s;
  }
  return win_total(lo, hi, nw);
}

// acc + sum of af(idx(q)) * bf(idx(q)) for q in [0, n), one multiply-add
// after another in q's order, the operands of eight terms loaded before
// their multiply-adds
template <class FA, class FB, class FI>
__device__ __forceinline__ float fma_run(FA af, FB bf, FI idx, int n, float acc) {
  int q0 = 0;
  for (; q0 + 8 <= n; q0 += 8) {
    float x[8], y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = idx(q0 + j);
      x[j] = af(i);
      y[j] = bf(i);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fmaf_rn(x[j], y[j], acc);
  }
  for (; q0 < n; ++q0) {
    const int i = idx(q0);
    acc = __fmaf_rn(af(i), bf(i), acc);
  }
  return acc;
}

// dot(a, b) as XLA's CPU program takes lam_s @ count_w (lp_device.xla_dot
// and dot_plan): `initial` is the bound at lam0, compiled apart from the
// loop's. Scalar below DOT_SCALAR_BELOW terms; otherwise a vector loop of
// 8 lanes interleaved ic times (lanes 0-7 of the warp), its lanes added
// in halves, an epilogue of evf lanes started from that sum, then the
// last terms one by one. Every lane returns it.
template <class FA, class FB>
__device__ float xla_dot_warp(FA af, FB bf, int n, bool initial) {
  const int lane = threadIdx.x & 31;
  auto ident = [](int q) { return q; };
  if (n < (initial ? 50 : 0)) return fma_run(af, bf, ident, n, 0.0f);
  auto bit_floor4 = [](int v) { v = v < 1 ? 1 : (v > 4 ? 4 : v); return v >= 4 ? 4 : (v >= 2 ? 2 : 1); };
  const int big = bit_floor4(n / 8), small = bit_floor4(n / 16);
  const int ic = (n % (8 * big) == n % (8 * small)) ? big : small;
  const int iters = n / (8 * ic);
  const int rem = n - iters * 8 * ic;
  int evf = 0, eiters = 0, best = 0;
  for (int vf = 8; vf >= 2; vf >>= 1) {
    if (rem >= vf) {
      const int cost = rem / vf + rem % vf;
      if (evf == 0 || cost <= best) {
        best = cost;
        evf = vf;
        eiters = rem / vf;
      }
    }
  }
  const bool unrolled = iters <= (initial ? 14 : 7);
  float acc = 0.0f;
  if (lane < 8) {
    if (unrolled) {
      // one chain: the first part over the iterations in order, each
      // later part over iterations 1, 0, 2, 3, ...
      acc = lane == 0 ? 0.0f : -0.0f;
      for (int u = 0; u < ic; ++u) {
        const bool swap = u > 0 && iters >= 2;
        acc = fma_run(af, bf, [&](int k) {
          const int it = swap && k < 2 ? 1 - k : k;
          return 8 * (it * ic + u) + lane;
        }, iters, acc);
      }
    } else {
      for (int u = 0; u < ic; ++u) {
        const float part = fma_run(af, bf, [&](int it) { return 8 * (it * ic + u) + lane; },
                                   iters, (lane == 0 && u == 0) ? 0.0f : -0.0f);
        acc = u == 0 ? part : __fadd_rn(acc, part);
      }
    }
  }
  for (int h = 4; h >= 1; h >>= 1) {
    const float o = __shfl_down_sync(kFull, acc, h);
    if (lane < h) acc = __fadd_rn(acc, o);
  }
  float s = __shfl_sync(kFull, acc, 0);
  int pos = iters * 8 * ic;
  if (evf) {
    float e = lane == 0 ? s : -0.0f;
    if (lane < evf) e = fma_run(af, bf, [&](int k) { return pos + k * evf + lane; }, eiters, e);
    for (int h = evf / 2; h >= 1; h >>= 1) {
      const float o = __shfl_down_sync(kFull, e, h);
      if (lane < h) e = __fadd_rn(e, o);
    }
    s = __shfl_sync(kFull, e, 0);
    pos += eiters * evf;
  }
  return fma_run(af, bf, [&](int q) { return pos + q; }, n - pos, s);
}

// ---- the ascent

template <class X>
struct Ascent {
  const Args& a;
  const Ctx t;
  Scalars& s;
  X& x;
  PhaseClock& clk;
  const int tid, lane, warp;
  const int G, C, R, K, Gw, nwc, frontc;

  __device__ Ascent(const Args& a_, const Ctx t_, Scalars& s_, X& x_, PhaseClock& clk_)
      : a(a_), t(t_), s(s_), x(x_), clk(clk_), tid(threadIdx.x), lane(threadIdx.x & 31),
        warp(threadIdx.x >> 5), G(a_.G), C(a_.C), R(a_.R), K(a_.K), Gw((a_.G + 31) / 32),
        nwc(win_count(a_.C)), frontc(win_front(a_.C)) {}

  __device__ float mm_of(int c, int r) const { return t.mm()[t.uidx()[c] * R + r]; }

  // the bound of the last forward pass: its two dots' difference
  __device__ float bound() const { return __fsub_rn(s.t1, s.t2); }

  __device__ float v_of(int c, int r, unsigned f) const {
    return (f >> r) & 1u ? __fmul_rn(mm_of(c, r), t.alloc()[c * R + r]) : kInf;
  }

  // the tables into the block's arrays, the distinct compat columns
  __device__ void load() {
    for (int k = tid; k < K; k += kAscThreads) {
      t.ksize()[k] = 0u;
      t.budget()[k] = a.budget[k];
    }
    if (tid == 0) s.nu = 0u;
    for (int i = tid; i < G * R; i += kAscThreads) t.req()[i] = a.req[i];
    for (int g = tid; g < G; g += kAscThreads) {
      t.cnt()[g] = a.count[g];
      t.cw()[g] = a.count_w[g];
      t.lam()[g] = a.lam0[g];
      t.best()[g] = a.lam0[g];
    }
    for (int i = tid; i < C * R; i += kAscThreads) t.alloc()[i] = a.alloc[i];
    for (int i = tid; i < C * Gw; i += kAscThreads) {
      const int c = i / Gw, w = i % Gw;
      unsigned bits = 0u;
      for (int b = 0; b < 32 && 32 * w + b < G; ++b)
        bits |= (a.compat[(size_t)(32 * w + b) * C + c] ? 1u : 0u) << b;
      t.colbits()[c * Gw + w] = bits;
    }
    for (int c = tid; c < C; c += kAscThreads) {
      unsigned f = 0u;
      for (int r = 0; r < R; ++r) f |= (a.valid[c * R + r] ? 1u : 0u) << r;
      if (a.uncapped[c]) f |= 1u << 16;
      int slot = -1;
      for (int k = 0; k < K && slot < 0; ++k)
        if (a.onehot[(size_t)k * C + c]) slot = k;
      f |= (unsigned)(slot + 1) << 17;
      t.cflag()[c] = f;
      t.price()[c] = a.price[c];
    }
    bar();
    // a config's column is distinct unless an earlier one equals it
    for (int c = tid; c < C; c += kAscThreads) {
      const unsigned* mine = t.colbits() + c * Gw;
      int rep = c;
      for (int o = 0; o < c && rep == c; ++o) {
        const unsigned* other = t.colbits() + o * Gw;
        bool same = true;
        for (int w = 0; w < Gw && same; ++w) same = other[w] == mine[w];
        if (same) rep = o;
      }
      t.uidx()[c] = (unsigned)rep;
      if (rep == c) {
        const unsigned u = atomicAdd(&s.nu, 1u);
        unsigned n = 0u;
        for (int w = 0; w < Gw; ++w) n += __popc(mine[w]);
        t.ulist()[u] = (unsigned)c;
        t.ncomp()[u] = n;
        t.tinfo()[c] = u;  // column -> distinct index, until the maxima overwrite it
      }
      const int k = slot_of_flag(t.cflag()[c]);
      if (k >= 0) atomicAdd(&t.ksize()[k], 1u);
    }
    bar();
    for (int c = tid; c < C; c += kAscThreads) t.uidx()[c] = t.tinfo()[t.uidx()[c]];
    bar();
  }

  // ratio[g, :] from lam[g]; the accumulators of a forward pass zeroed
  __device__ void ratio_of(int g) {
    const float lg = t.lam()[g];
    const bool live = t.cnt()[g] > 0.0f;
    for (int r = 0; r < R; ++r) {
      const float rq = t.req()[g * R + r];
      t.ratio()[g * R + r] = (rq > 0.0f && live) ? div_rn(lg, rq) : 0.0f;
    }
  }

  __device__ void zero_accumulators() {
    for (int k = tid; k < K; k += kAscThreads) {
      t.mu()[k] = 0u;
      t.nm()[k] = 0u;
    }
    for (int i = tid; i < G * R * nwc; i += kAscThreads) t.masks()[i] = 0u;
    for (int i = tid; i < nwc; i += kAscThreads) t.tbmask()[i] = 0u;
    if (tid == 0) s.nz = 0u;
  }

  // ---- the forward pass: bound_w(lam)'s two dots into s.t1 and s.t2
  __device__ void forward(bool initial) {
    const int nu = (int)s.nu;
    // column maxima over groups and their ties, for each distinct column
    // (a few lanes a column, each over a run of groups, merged by shuffles)
    {
      RegionTimer rt(tid == 0);
      int items = nu * R;
      int nch = 1, lg = 0;  // lanes a column, a power of two, and its log
      while (nch < 32 && items * nch * 2 <= kAscThreads) {
        nch <<= 1;
        ++lg;
      }
      const int gs = (G + nch - 1) >> lg;
      const int total = items * nch;
      for (int base = warp * 32; base < total; base += kAscThreads) {
        const int it = base + lane;
        const int ch = it & (nch - 1);
        float m = -kInf;
        int n = 0, first = 0xffff;
        int u = 0, r = 0;
        if (it < total) {
          u = (it >> lg) / R;
          r = (it >> lg) - u * R;
          const int col = (int)t.ulist()[u];
          const int g0 = ch * gs, g1 = min(G, g0 + gs);
          for (int w = g0 >> 5; w < Gw && 32 * w < g1; ++w) {
            unsigned bits = t.colbits()[col * Gw + w];
            const int lo = g0 - 32 * w, hi = g1 - 32 * w;
            if (lo > 0) bits &= ~0u << lo;
            if (hi < 32) bits &= (1u << hi) - 1u;
            while (bits) {
              const int g = 32 * w + __ffs(bits) - 1;
              bits &= bits - 1;
              const float v = t.ratio()[g * R + r];
              if (v > m) {
                m = v;
                n = 1;
                first = g;
              } else if (v == m) {
                ++n;
              }
            }
          }
        }
        for (int o = 1; o < nch; o <<= 1) {
          const float m2 = __shfl_xor_sync(kFull, m, o);
          const int n2 = __shfl_xor_sync(kFull, n, o);
          const int f2 = __shfl_xor_sync(kFull, first, o);
          if (m2 > m) {
            m = m2;
            n = n2;
            first = f2;
          } else if (m2 == m) {
            n += n2;
            first = min(first, f2);
          }
        }
        if (it < total && ch == 0) {
          // the incompatible rows are masked zeros
          const int nnc = G - (int)t.ncomp()[u];
          const float mm = nnc > 0 ? fmaxf(m, 0.0f) : m;
          const unsigned cties = m == mm ? (unsigned)n : 0u;
          t.mm()[u * R + r] = mm;
          t.tinfo()[u * R + r] = (cties << 16) | (unsigned)(first & 0xffff);
        }
      }
      rt.stop(R_COLMAX);
    }
    bar();
    clk.mark(2);
    // vh0 and z by config; theta0's per-warp maxima
    RegionTimer rt_vh0(tid == 0);
    float zmax = -kInf;
    for (int c = tid; c < C; c += kAscThreads) {
      const unsigned f = t.cflag()[c];
      float v0 = kInf;
      for (int r = 0; r < R; ++r) v0 = fminf(v0, v_of(c, r, f));
      t.vh0()[c] = v0;
      const float p = t.price()[c];
      const float zc = ((f >> 16) & 1u) && p > 0.0f ? div_rn(vh_of(v0), pden_of(p)) : 0.0f;
      t.z()[c] = zc;
      zmax = fmaxf(zmax, zc);
    }
    zmax = warp_max_f(zmax);
    if (lane == 0) s.red[warp] = zmax;
    rt_vh0.stop(R_VH0);
    bar();
    clk.mark(3);
    // theta; excess and mu's maxima; theta's ties; lam / theta (into
    // grad's array, free until the supergradient) for the bound's dot;
    // dtheta_a, which needs only theta and lam
    float theta0 = warp_max_f(lane < kAscWarps ? s.red[lane] : -kInf);
    if constexpr (X::kSplit) theta0 = shard_max_f32(x, theta0);
    if (tid == 0) s.theta0 = theta0;
    const float theta = theta0 > kEps ? theta0 : kEps;
    RegionTimer rt_ex(tid == 0);
    for (int g = tid; g < G; g += kAscThreads) t.grad()[g] = div_rn(t.lam()[g], theta);
    for (int base = warp * 32; base < C; base += kAscThreads) {
      const int c = base + lane;
      bool tie = false;
      if (c < C) {
        const float xe = __fsub_rn(div_rn(vh_of(t.vh0()[c]), theta), t.price()[c]);
        const float ex = xe > 0.0f ? xe : 0.0f;
        t.excess()[c] = ex;
        const int k = slot_of_flag(t.cflag()[c]);
        if (k >= 0) atomicMax(&t.mu()[k], __float_as_uint(ex));
        tie = t.z()[c] == theta0;
      }
      const unsigned b = __ballot_sync(kFull, tie);
      if (lane == 0 && b) atomicAdd(&s.nz, (unsigned)__popc(b));
    }
    rt_ex.stop(R_EXCESS);
    if (warp == kAscWarps - 2) {
      RegionTimer rt(lane == 0);
      const float inv_t2 = div_rn(1.0f, __fmul_rn(theta, theta));
      const float d = warp_sum_prod([&](int g) { return __fmul_rn(t.cw()[g], inv_t2); },
                                    [&](int g) { return t.lam()[g]; }, G);
      if (lane == 0) s.dtheta_a = -d;
      rt.stop(R_DTHETA_A);
    }
    bar();
    clk.mark(4);
    if constexpr (X::kSplit) {
      shard_vec(
          x, K, [&](int k) { return (unsigned long long)t.mu()[k]; },
          [&](int k, auto get) {
            float m = __uint_as_float((uint32_t)get(0));
            for (int sh = 1; sh < x.S; ++sh) m = fmaxf(m, __uint_as_float((uint32_t)get(sh)));
            t.mu()[k] = __float_as_uint(m);
          });
      const unsigned nz = (unsigned)shard_sum_int(x, (int)s.nz);
      if (tid == 0) s.nz = nz;
    }
    // mu's ties among the slots' configs; the bound's two dots, a warp
    // each, their operands loaded ahead of the multiply-adds
    RegionTimer rt_ties(tid == 0);
    for (int c = tid; c < C; c += kAscThreads) {
      const int k = slot_of_flag(t.cflag()[c]);
      if (k >= 0 && t.excess()[c] == __uint_as_float(t.mu()[k])) atomicAdd(&t.nm()[k], 1u);
    }
    rt_ties.stop(R_MU_TIES);
    if (warp == kAscWarps - 2) {
      RegionTimer rt(lane == 0);
      const float t1 = xla_dot_warp([&](int g) { return t.grad()[g]; },
                                    [&](int g) { return t.cw()[g]; }, G, initial);
      if (lane == 0) s.t1 = t1;
      rt.stop(R_DOT);
    } else if (warp == kAscWarps - 1 && lane == 0) {
      RegionTimer rt(true);
      const unsigned* mu = t.mu();
      const float* budget = t.budget();
      s.t2 = fma_run([&](int k) { return __uint_as_float(mu[k]); },
                     [&](int k) { return budget[k]; }, [](int k) { return k; }, K, 0.0f);
      rt.stop(R_MU_BUDGET);
    }
    bar();
    clk.mark(5);
  }

  // ---- the supergradient of the forward pass just taken, into t.grad()
  __device__ void supergradient() {
    const float theta0 = s.theta0;
    const float theta = theta0 > kEps ? theta0 : kEps;
    const float inv_t2 = div_rn(1.0f, __fmul_rn(theta, theta));
    if constexpr (X::kSplit) {
      shard_vec(
          x, K,
          [&](int k) {
            const unsigned zeros =
                t.mu()[k] == 0u ? (unsigned)C - t.ksize()[k] : 0u;  // the masked zeros
            return (unsigned long long)(t.nm()[k] + zeros);
          },
          [&](int k, auto get) {
            unsigned long long n = 0;
            for (int sh = 0; sh < x.S; ++sh) n += get(sh);
            t.nm()[k] = (unsigned)n;
          });
    }
    // d excess and dtheta_b's terms, by config
    for (int c = tid; c < C; c += kAscThreads) {
      const unsigned f = t.cflag()[c];
      const int k = slot_of_flag(f);
      float dexcess = 0.0f;
      if (k >= 0) {
        const float mk = __uint_as_float(t.mu()[k]);
        unsigned n = t.nm()[k];
        if constexpr (!X::kSplit) n += mk == 0.0f ? (unsigned)C - t.ksize()[k] : 0u;
        const float q = div_rn(-t.budget()[k], (float)n);
        dexcess = __fmul_rn(t.excess()[c] == mk ? 1.0f : 0.0f, q);
      }
      const float vh = vh_of(t.vh0()[c]);
      const float xe = __fsub_rn(div_rn(vh, theta), t.price()[c]);
      const float dx = __fmul_rn(dexcess, tie_weight(xe, 0.0f));
      t.dx()[c] = dx;
      const float xt = __fmul_rn(dx, inv_t2);
      bool nonzero;
      if (C <= 32) {
        t.tb()[c] = xt;
        t.ty()[c] = vh;
        nonzero = !((xt == 0.0f || vh == 0.0f) && isfinite(xt) && isfinite(vh));
      } else {
        const float term = __fmul_rn(xt, vh);
        t.tb()[c] = term;
        nonzero = term != 0.0f;
      }
      if (nonzero) {
        const int pos = c + frontc;
        atomicOr(&t.tbmask()[pos >> 5], 1u << (pos & 31));
      }
    }
    bar();
    clk.mark(7);
    // dtheta_b (each warp), theta's share; then by config dvh, and by
    // (config, resource) dmm / ties and the scatter of d ratio's terms
    RegionTimer rt_db(tid == 0);
    float dtheta_b = warp_sum_masked(t.tbmask(), t.tb(), t.ty(), C);
    rt_db.stop(R_DTHETA_B);
    if constexpr (X::kSplit) dtheta_b = shard_sum_f32(x, dtheta_b);
    const float dtheta = __fadd_rn(s.dtheta_a, -dtheta_b);
    const float qtheta = div_rn(__fmul_rn(dtheta, tie_weight(theta0, kEps)), (float)s.nz);
    RegionTimer rt_qx(tid == 0);
    for (int c = tid; c < C; c += kAscThreads) {
      const unsigned f = t.cflag()[c];
      const float dvh_a = div_rn(t.dx()[c], theta);
      const float p = t.price()[c];
      const float dz = __fmul_rn(t.z()[c] == theta0 ? 1.0f : 0.0f, qtheta);
      const float dvh_b = ((f >> 16) & 1u) && p > 0.0f ? div_rn(dz, pden_of(p)) : 0.0f;
      const float dvh = __fadd_rn(dvh_a, dvh_b);
      const float v0 = t.vh0()[c];
      const float dvh0 = isfinite(v0) ? dvh : 0.0f;
      int nv = 0;
      for (int r = 0; r < R; ++r) nv += v_of(c, r, f) == v0;
      const float qv = div_rn(dvh0, (float)nv);
      const int u = (int)t.uidx()[c];
      const int col = (int)t.ulist()[u];
      const int nnc = G - (int)t.ncomp()[u];
      const int pos = c + frontc;
      const unsigned bit = 1u << (pos & 31);
      for (int r = 0; r < R; ++r) {
        const int i = c * R + r;
        const bool valid = (f >> r) & 1u;
        const float dv = __fmul_rn(v_of(c, r, f) == v0 ? 1.0f : 0.0f, qv);
        const float dmm = valid ? __fmul_rn(dv, t.alloc()[i]) : 0.0f;
        const float mm = t.mm()[u * R + r];
        const unsigned ti = t.tinfo()[u * R + r];
        const unsigned cties = ti >> 16;
        const unsigned ties = cties + (mm == 0.0f ? (unsigned)nnc : 0u);
        const float q = div_rn(dmm, (float)ties);
        t.qx()[i] = q;
        if (q == 0.0f) continue;  // every term 1*q or 0*q is +-0
        unsigned* mrow = t.masks() + (size_t)r * nwc + (pos >> 5);
        if (isfinite(q) && cties == 1u) {
          atomicOr(mrow + (size_t)(ti & 0xffffu) * R * nwc, bit);
        } else if (!isfinite(q) || cties > 1u) {
          // a non-finite q gives every compatible group a NaN or inf term
          for (int w = 0; w < Gw; ++w) {
            unsigned bits = t.colbits()[col * Gw + w];
            while (bits) {
              const int g = 32 * w + __ffs(bits) - 1;
              bits &= bits - 1;
              if (!isfinite(q) || t.ratio()[g * R + r] == mm)
                atomicOr(mrow + (size_t)g * R * nwc, bit);
            }
          }
        }
      }
    }
    rt_qx.stop(R_DVH_QX);
    bar();
    clk.mark(8);
    // d ratio[g, r]: its windows' set terms in order, the window sums in
    // XLA's order (a lane a row); then the gradient by group
    const int rs = R <= 1 ? 0 : (R <= 2 ? 1 : (R <= 4 ? 2 : (R <= 8 ? 3 : 4)));
    const int Rp = 1 << rs;  // lanes a group: a power of two
    const int nrows = G * Rp;
    RegionTimer rt_rows(tid == 0);
    for (int base = warp * 32; base < nrows; base += kAscThreads) {
      const int it = base + lane;
      const int g = it >> rs, r = it & (Rp - 1);
      float dr = 0.0f;
      if (it < nrows && r < R) {
        const float rt = t.ratio()[g * R + r];
        const unsigned* mrow = t.masks() + ((size_t)g * R + r) * nwc;
        // a window's set terms in order, four at a time: their operands
        // loaded before their adds (a row that ties a shared column's
        // maximum has a term for every config of that column)
        auto win_sum = [&](int w) {
          unsigned m = mrow[w];
          float sw = 0.0f;
          while (m) {
            int c[4];
            float term[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              c[j] = m ? 32 * w + __ffs(m) - 1 - frontc : -1;
              m &= m - 1;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int cj = c[j] < 0 ? c[0] : c[j];
              term[j] = __fmul_rn(rt == mm_of(cj, r) ? 1.0f : 0.0f, t.qx()[cj * R + r]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c[j] >= 0) sw = __fadd_rn(sw, term[j]);
          }
          return sw;
        };
        if (nwc <= 32) {
          for (int w0 = 0; w0 < nwc; w0 += 8) {
            unsigned any = 0u;
#pragma unroll
            for (int j = 0; j < 8; ++j) any |= mrow[w0 + j < nwc ? w0 + j : nwc - 1];
            if (!any) continue;  // eight empty windows add +0 each
            for (int w = w0; w < w0 + 8 && w < nwc; ++w) dr = __fadd_rn(dr, win_sum(w));
          }
        } else {
          const int nw2 = win_count(nwc), front2 = win_front(nwc);
          for (int W = 0; W < nw2; ++W) {
            float sw2 = 0.0f;
            for (int i = 0; i < 32; ++i) {
              const int w = W * 32 + i - front2;
              if (w >= 0 && w < nwc) sw2 = __fadd_rn(sw2, win_sum(w));
            }
            dr = __fadd_rn(dr, sw2);
          }
        }
      }
      if (base == warp * 32) rt_rows.stop(R_DRATIO);
      if constexpr (X::kSplit) {
        if (it < nrows && r < R) t.dratio()[g * R + r] = dr;
      } else {
        // the group's lanes are adjacent: its gradient from their sums,
        // the quotients taken before their in-order sum
        RegionTimer rt(tid == 0);
        const int g0 = g < G ? g : G - 1;
        const bool live = t.cnt()[g0] > 0.0f;
        float qv[kMaxR];
#pragma unroll
        for (int rr = 0; rr < kMaxR; ++rr) {
          if (rr < R) {
            const float v = __shfl_sync(kFull, dr, (lane & ~(Rp - 1)) + rr);
            const float rq = t.req()[g0 * R + rr];
            qv[rr] = (rq > 0.0f && live) ? div_rn(v, rq) : 0.0f;
          }
        }
        float acc = 0.0f;
#pragma unroll
        for (int rr = 0; rr < kMaxR; ++rr)
          if (rr < R) acc = __fadd_rn(acc, qv[rr]);
        if (it < nrows && r == 0) t.grad()[g] = __fadd_rn(div_rn(t.cw()[g], theta), acc);
        if (base == warp * 32) rt.stop(R_GRAD);
      }
    }
    if constexpr (X::kSplit) {
      shard_sum_ordered(x, t.dratio(), G * R);
      for (int g = tid; g < G; g += kAscThreads) {
        const bool live = t.cnt()[g] > 0.0f;
        float acc = 0.0f;
        for (int r = 0; r < R; ++r) {
          const float rq = t.req()[g * R + r];
          acc = __fadd_rn(acc, (rq > 0.0f && live) ? div_rn(t.dratio()[g * R + r], rq) : 0.0f);
        }
        t.grad()[g] = __fadd_rn(div_rn(t.cw()[g], theta), acc);
      }
    }
    // lam's per-warp maxima, for the step's scale
    float lmax = -kInf;
    for (int g = tid; g < G; g += kAscThreads) lmax = fmaxf(lmax, t.lam()[g]);
    lmax = warp_max_f(lmax);
    if (lane == 0) s.red[warp] = lmax;
    bar();
    clk.mark(9);
  }

  // ---- the step of iteration `it` from the gradient; the next ratio
  __device__ void step(int it) {
    const float lmax = warp_max_f(lane < kAscWarps ? s.red[lane] : -kInf);
    const float scale = lmax > 1e-9f ? lmax : 1e-9f;
    const float eta = div_rn(0.5f, __fsqrt_rn(__fadd_rn(1.0f, (float)it)));
    if (warp * 32 < G) {
      // the norm, by each warp that updates groups
      RegionTimer rt(tid == 0);
      const float n2 = warp_sum_prod([&](int g) { return t.grad()[g]; },
                                     [&](int g) { return t.grad()[g]; }, G);
      rt.stop(R_NORM);
      RegionTimer rt_up(tid == 0);
      const float nrm = __fsqrt_rn(n2);
      const float den = nrm > kEps ? nrm : kEps;
      for (int g = tid; g < G; g += kAscThreads) {
        const float gn = div_rn(t.grad()[g], den);
        const float y = __fmaf_rn(__fmul_rn(eta, gn), scale, t.lam()[g]);
        t.lam()[g] = y > 0.0f ? y : 0.0f;
        ratio_of(g);
      }
      rt_up.stop(R_UPDATE);
    }
    RegionTimer rt_zero(tid == 0);
    zero_accumulators();
    rt_zero.stop(R_ZERO);
    bar();
    clk.mark(1);
  }

  __device__ void run() {
    load();
    clk.mark(0);
    for (int g = tid; g < G; g += kAscThreads) ratio_of(g);
    zero_accumulators();
    bar();
    clk.mark(1);
    forward(true);
    float best = bound();
    int last = -1;
    for (int it = 0; it < a.n_iters; ++it) {
      supergradient();
      step(it);
      forward(false);
      const float b = bound();
      if (b > best) {  // uniform: every thread reads the same bound
        best = b;
        last = it;
        for (int g = tid; g < G; g += kAscThreads) t.best()[g] = t.lam()[g];
      }
      clk.mark(6);
      clk.count();
    }
    bar();
    for (int g = tid; g < G; g += kAscThreads) a.best_lam[g] = t.best()[g];
    if (tid == 0) {
      *a.best = best;
      *a.last_up = last;
    }
  }
};

template <class X>
__device__ void ascend_body(const Args& a, const Layout& L, unsigned char* scratch, X& x) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ Scalars s;
  PhaseClock clk;
#ifdef KARPENTER_PHASE_CLOCKS
  if (threadIdx.x == 0) bar_count() = 0u;
  if (threadIdx.x < R_REGIONS) region_acc()[threadIdx.x] = 0ull;
#endif
  clk.begin();
  const Ctx t{L, dsmem, scratch};
  Ascent<X> asc(a, t, s, x, clk);
  asc.run();
#ifdef KARPENTER_PHASE_CLOCKS
  __syncthreads();
  if (clk.on) {
    g_phase_clk[kBarrierSlot] += bar_count();
    for (int i = 0; i < R_REGIONS; ++i) g_phase_clk[kRegionSlot + i] += region_acc()[i];
  }
#endif
}

__global__ void __launch_bounds__(kAscThreads, 1)
    lp_ascend_kernel(const __grid_constant__ Args a, const __grid_constant__ Layout L,
                     unsigned char* scratch) {
  NoSplit x;
  ascend_body(a, L, scratch, x);
}

// per-shard pointers of the split ascent's config-axis inputs
struct AscShards {
  const uint8_t* const* compat;    // [Gp, Cs] each
  const float* const* alloc;       // [Cs, R]
  const float* const* price;       // [Cs]
  const uint8_t* const* valid;     // [Cs, R]
  const uint8_t* const* onehot;    // [Kp, Cs]
  const uint8_t* const* uncapped;  // [Cs]
};

// block s: shard s's columns and its replica of lam and the per-group
// state (leading shard axis on best, best_lam, last_up and the scratch)
__global__ void __launch_bounds__(kAscThreads, 1) lp_ascend_sharded_kernel(
    const __grid_constant__ Args base, AscShards t, const __grid_constant__ Layout L,
    unsigned char* scratch, long long scratch_bytes,
    unsigned long long* slots, unsigned* arrive, int S, int words) {
  const int sh = blockIdx.x;
  Args a = base;
  a.best += sh;
  a.best_lam += (size_t)sh * a.G;
  a.last_up += sh;
  a.compat = t.compat[sh];
  a.alloc = t.alloc[sh];
  a.price = t.price[sh];
  a.valid = t.valid[sh];
  a.onehot = t.onehot[sh];
  a.uncapped = t.uncapped[sh];
  DeviceSplit x{slots, arrive, sh, S, words, sh * a.C, 0u};
  ascend_body(a, L, scratch + (size_t)sh * scratch_bytes, x);
}

// n block barriers of kAscThreads threads in a row: the cost of one
// barrier on its own, which bounds from below an ascent's chain of
// barriers (chip_smoke.py times it)
__global__ void __launch_bounds__(kAscThreads, 1) lp_barrier_probe_kernel(int n, int* sink) {
  int v = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    v ^= i;
  }
  if (v == -1) *sink = v;
}

int check_sizes(int G, int C, int R, int K, int n_iters) {
  if (R < 1 || R > kMaxR || G < 1 || C < 1 || K < 1 || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  if (G > kMaxAxis || C > kMaxAxis || K > kMaxSlots) return (int)cudaErrorInvalidValue;
  return 0;
}

// every array of `L` inside the shared memory or the scratch it claims
int check_layout(const Layout& L, int G, int C, int R, int K, long long smem,
                 long long scratch) {
  for (int i = 0; i < A_COUNT; ++i) {
    const long long n = arr_bytes(i, G, C, R, K), o = L.off[i];
    if (o >= 0 ? (o % 16 != 0 || o + n > smem) : (~o % 16 != 0 || ~o + n > scratch))
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int lp_ascend_launch(
    const float* lam0, const float* count, const float* count_w, const uint8_t* compat,
    const float* req, const float* alloc, const float* price, const uint8_t* valid,
    const uint8_t* onehot, const float* budget, const uint8_t* uncapped, float* best,
    float* best_lam, int32_t* last_up, const long long* layout, int smem_bytes,
    unsigned char* scratch, long long scratch_bytes, int G, int C, int R, int K,
    int n_iters, cudaStream_t stream) {
  if (int e = check_sizes(G, C, R, K, n_iters)) return e;
  Layout L;
  for (int i = 0; i < A_COUNT; ++i) L.off[i] = layout[i];
  if (int e = check_layout(L, G, C, R, K, smem_bytes, scratch_bytes)) return e;
  Args a{lam0, count, count_w, compat, req, alloc, price, valid, onehot, budget, uncapped,
         best, best_lam, last_up, G, C, R, K, n_iters};
  cudaError_t err = cudaFuncSetAttribute(
      lp_ascend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  lp_ascend_kernel<<<1, kAscThreads, smem_bytes, stream>>>(a, L, scratch);
  return (int)cudaGetLastError();
}

// Split B5 over S shards of C configs each: the six config-axis tables
// hold S device pointers each (compat, alloc, price, valid, onehot,
// uncapped); best, best_lam and last_up carry a leading shard axis; each
// block takes `scratch_bytes` of `scratch` for the arrays `layout`
// places there; slots [2, S, words] (words >= max(Kp, Gp * R, 4)) and
// arrive (zeroed) are the exchange's. One cooperative launch of S blocks.
extern "C" int lp_ascend_sharded_launch(
    const uint8_t* const* compat, const float* const* alloc, const float* const* price,
    const uint8_t* const* valid, const uint8_t* const* onehot,
    const uint8_t* const* uncapped, const float* lam0, const float* count,
    const float* count_w, const float* req, const float* budget, float* best,
    float* best_lam, int32_t* last_up, const long long* layout, int smem_bytes,
    unsigned char* scratch, long long scratch_bytes, unsigned long long* slots,
    unsigned* arrive, int G, int C, int R, int K, int n_iters, int S, int words,
    cudaStream_t stream) {
  if (int e = check_sizes(G, C, R, K, n_iters)) return e;
  if (S < 2 || words < 4 || words < K || words < G * R) return (int)cudaErrorInvalidValue;
  Layout L;
  for (int i = 0; i < A_COUNT; ++i) L.off[i] = layout[i];
  if (int e = check_layout(L, G, C, R, K, smem_bytes, scratch_bytes)) return e;
  Args a{lam0, count, count_w, nullptr, req, nullptr, nullptr, nullptr, nullptr, budget,
         nullptr, best, best_lam, last_up, G, C, R, K, n_iters};
  AscShards t{compat, alloc, price, valid, onehot, uncapped};
  cudaError_t err = cudaFuncSetAttribute(
      lp_ascend_sharded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a, &t, &L, &scratch, &scratch_bytes, &slots, &arrive, &S, &words};
  err = cudaLaunchCooperativeKernel((const void*)lp_ascend_sharded_kernel, dim3(S),
                                    dim3(kAscThreads), params, smem_bytes, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int lp_barrier_probe_launch(int n, int* sink, cudaStream_t stream) {
  lp_barrier_probe_kernel<<<1, kAscThreads, 0, stream>>>(n, sink);
  return (int)cudaGetLastError();
}
