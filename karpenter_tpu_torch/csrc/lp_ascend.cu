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
// add chain), beyond that in windows of 32 after XLA's padding; the dot
// of the bound as eight multiply-add lanes folded in halves.
//
// What bounds it: the iterations. They form one dependent chain, and
// the work of one is small (at 50k pods x 500 types: Gp=194 groups,
// Cp=243 configs, R=4: a few hundred thousand element operations over
// a 47 KB compat matrix), so the design is one persistent block of
// 1024 threads for the whole ascent, phases separated by
// __syncthreads(), the state in global memory (it stays in L2).
//
// B8, split B5 (lp_device.py:430-452, the ascent under
// KARPENTER_LP_SHARDS): the same code over the config axis split into S
// column blocks, one cooperative launch of S blocks
// (`lp_ascend_sharded_kernel`), each with its own replica of lam and the
// per-group state. Per iteration the shards exchange (shard_xchg.cuh):
// theta's maximum, mu's [Kp] maxima and their tie counts, theta's tie
// count, and the partial sums over configs — dtheta's and the [Gp, R]
// d ratio — combined in shard order. Plain version:
// lp_device.py::ascend_sharded_ref.
//
// Exactness: f32 with explicit round-to-nearest intrinsics in the
// plain version's order of operations, -fmad=false in the build (the
// multiply-adds are explicit __fmaf_rn).

#include "pack_common.cuh"

namespace {

constexpr int kAscThreads = 1024;
constexpr int kAscWarps = kAscThreads / 32;
constexpr float kEps = 1e-12f;
constexpr float kInf = __builtin_huge_valf();
// window sums a warp keeps: XLA's order for sums of up to 2048 terms
constexpr int kMaxWin = 64;
constexpr int kMaxTerms = 32 * kMaxWin;

struct Args {
  const float* lam0;        // [Gp]
  const float* count;       // [Gp]
  const float* count_w;     // [Gp]
  const uint8_t* compat;    // [Gp, Cp]
  const float* req;         // [Gp, R]
  const float* alloc;       // [Cp, R]
  const float* price;       // [Cp]
  const uint8_t* valid;     // [Cp, R]
  const uint8_t* onehot;    // [Kp, Cp]
  const float* budget;      // [Kp]
  const uint8_t* uncapped;  // [Cp]
  float* best;              // scalar out
  float* best_lam;          // [Gp] out
  int32_t* last_up;         // scalar out
  float* lam;               // [Gp] scratch
  float* grad;              // [Gp]
  float* ratio;             // [Gp, R]
  float* dratio;            // [Gp, R]
  float* mm;                // [Cp, R]
  float* qx;                // [Cp, R] ties of mm, then dmm / ties
  float* vh0;               // [Cp]
  float* dvh;               // [Cp]
  float* excess;            // [Cp]
  float* z;                 // [Cp]
  float* mu;                // [Kp]
  float* qmu;               // [Kp]
  int G, C, R, K, n_iters;
};

struct WarpBuf {
  float a[kMaxWin];
  float b[kMaxWin];
};

// sum_{i<n} term(i) in XLA's CPU order (lp_device.xla_sum), by one
// warp; every lane returns it. Up to 32 terms in order from +0; beyond,
// window w sums positions 32w - front .. 32w - front + 31 in order (out
// of range: +0), and the window sums are reduced the same way.
template <class F>
__device__ float xla_sum_warp(F term, int n, WarpBuf& wb) {
  const int lane = threadIdx.x & 31;
  float out = 0.0f;
  if (n <= 32) {
    if (lane == 0)
      for (int i = 0; i < n; ++i) out = __fadd_rn(out, term(i));
    return __shfl_sync(0xffffffffu, out, 0);
  }
  int m = (n + 31) / 32;
  int front = (m * 32 - n) / 2;
  for (int w = lane; w < m; w += 32) {
    float s = 0.0f;
    for (int i = 0; i < 32; ++i) {
      const int p = w * 32 + i - front;
      s = __fadd_rn(s, (p >= 0 && p < n) ? term(p) : 0.0f);
    }
    wb.a[w] = s;
  }
  __syncwarp();
  float* src = wb.a;
  float* dst = wb.b;
  while (m > 32) {
    const int m2 = (m + 31) / 32;
    const int fr = (m2 * 32 - m) / 2;
    for (int w = lane; w < m2; w += 32) {
      float s = 0.0f;
      for (int i = 0; i < 32; ++i) {
        const int p = w * 32 + i - fr;
        s = __fadd_rn(s, (p >= 0 && p < m) ? src[p] : 0.0f);
      }
      dst[w] = s;
    }
    __syncwarp();
    float* t = src;
    src = dst;
    dst = t;
    m = m2;
  }
  if (lane == 0)
    for (int i = 0; i < m; ++i) out = __fadd_rn(out, src[i]);
  __syncwarp();  // the buffers are reused by the next call
  return __shfl_sync(0xffffffffu, out, 0);
}

// sum_{i<n} x(i) * y(i) in XLA's order: up to 32 terms one multiply-add
// chain in order, beyond the products rounded and summed as above
template <class FX, class FY>
__device__ float xla_sum_prod_warp(FX xf, FY yf, int n, WarpBuf& wb) {
  if (n <= 32) {
    const int lane = threadIdx.x & 31;
    float out = 0.0f;
    if (lane == 0)
      for (int i = 0; i < n; ++i) out = __fmaf_rn(xf(i), yf(i), out);
    return __shfl_sync(0xffffffffu, out, 0);
  }
  return xla_sum_warp([&](int i) { return __fmul_rn(xf(i), yf(i)); }, n, wb);
}

// dot(a, b) as XLA's CPU program takes lam_s @ count_w (lp_device.xla_dot):
// eight lanes of multiply-adds over the first 8 * (n / 8) terms, folded in
// halves, then the rest as multiply-adds in order; every lane returns it
template <class FA, class FB>
__device__ float xla_dot_warp(FA af, FB bf, int n) {
  const int lane = threadIdx.x & 31;
  const int main = (n / 8) * 8;
  float acc = 0.0f;
  if (lane < 8)
    for (int t = lane; t < main; t += 8) acc = __fmaf_rn(af(t), bf(t), acc);
  // lanes i and i + 4, then i and i + 2, then 0 and 1
  for (int h = 4; h >= 1; h >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, acc, h);
    if (lane < h) acc = __fadd_rn(acc, o);
  }
  if (lane == 0)
    for (int i = main; i < n; ++i) acc = __fmaf_rn(af(i), bf(i), acc);
  return __shfl_sync(0xffffffffu, acc, 0);
}

// dot(a, b) as one multiply-add chain in order (lp_device.fma_chain)
template <class FA, class FB>
__device__ float fma_chain_warp(FA af, FB bf, int n) {
  float acc = 0.0f;
  if ((threadIdx.x & 31) == 0)
    for (int i = 0; i < n; ++i) acc = __fmaf_rn(af(i), bf(i), acc);
  return __shfl_sync(0xffffffffu, acc, 0);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block-wide max of one float per thread (order-independent)
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = red[0];
  for (int w = 1; w < kAscWarps; ++w) out = fmaxf(out, red[w]);
  __syncthreads();
  return out;
}

__device__ int block_sum_int(int v, int* red) {
  v = warp_sum_int(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int out = 0;
  for (int w = 0; w < kAscWarps; ++w) out += red[w];
  __syncthreads();
  return out;
}

struct Shared {
  float red[kAscWarps];
  int ired[kAscWarps];
  float theta0, theta, b, dtheta_a, dtheta_b, scale, den;
  WarpBuf wb[kAscWarps];
};

__device__ __forceinline__ float tie_weight(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

__device__ __forceinline__ float v_of(const Args& a, int c, int r) {
  const int i = c * a.R + r;
  return a.valid[i] ? __fmul_rn(a.mm[i], a.alloc[i]) : kInf;
}

__device__ __forceinline__ float pden_of(float p) { return p > kEps ? p : kEps; }

__device__ __forceinline__ float vh_of(float v0) { return isfinite(v0) ? v0 : 0.0f; }

// bound_w(lam) into s.b, with the intermediates the supergradient reads
template <class X>
__device__ void forward(const Args& a, Shared& s, X& x) {
  const int tid = threadIdx.x;
  const int G = a.G, C = a.C, R = a.R;
  for (int i = tid; i < G * R; i += kAscThreads) {
    const int g = i / R;
    const float rq = a.req[i];
    const bool rmask = rq > 0.0f && a.count[g] > 0.0f;
    a.ratio[i] = rmask ? __fdiv_rn(a.lam[g], rq) : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < C * R; i += kAscThreads) {
    const int c = i / R, r = i % R;
    float m = -kInf;
    for (int g = 0; g < G; ++g) {
      const float xv = a.compat[(size_t)g * C + c] ? a.ratio[g * R + r] : 0.0f;
      m = fmaxf(m, xv);
    }
    int ties = 0;
    for (int g = 0; g < G; ++g) {
      const float xv = a.compat[(size_t)g * C + c] ? a.ratio[g * R + r] : 0.0f;
      ties += xv == m;
    }
    a.mm[i] = m;
    a.qx[i] = (float)ties;
  }
  __syncthreads();
  float zmax = -kInf;
  for (int c = tid; c < C; c += kAscThreads) {
    float v0 = kInf;
    for (int r = 0; r < R; ++r) v0 = fminf(v0, v_of(a, c, r));
    a.vh0[c] = v0;
    const float vh = vh_of(v0);
    const float p = a.price[c];
    const float zc = (a.uncapped[c] && p > 0.0f) ? __fdiv_rn(vh, pden_of(p)) : 0.0f;
    a.z[c] = zc;
    zmax = fmaxf(zmax, zc);
  }
  float theta0 = block_max(zmax, s.red);
  if constexpr (X::kSplit) theta0 = shard_max_f32(x, theta0);
  const float theta = theta0 > kEps ? theta0 : kEps;
  for (int c = tid; c < C; c += kAscThreads) {
    const float xe = __fsub_rn(__fdiv_rn(vh_of(a.vh0[c]), theta), a.price[c]);
    a.excess[c] = xe > 0.0f ? xe : 0.0f;
  }
  __syncthreads();
  for (int k = tid; k < a.K; k += kAscThreads) {
    float m = -kInf;
    for (int c = 0; c < C; ++c) m = fmaxf(m, a.onehot[(size_t)k * C + c] ? a.excess[c] : 0.0f);
    a.mu[k] = m;
  }
  if constexpr (X::kSplit) {
    shard_vec(
        x, a.K, [&](int k) { return (unsigned long long)__float_as_uint(a.mu[k]); },
        [&](int k, auto get) {
          float m = __uint_as_float((uint32_t)get(0));
          for (int sh = 1; sh < x.S; ++sh) m = fmaxf(m, __uint_as_float((uint32_t)get(sh)));
          a.mu[k] = m;
        });
  }
  __syncthreads();
  if (tid < 32) {
    const float t1 = xla_dot_warp([&](int g) { return __fdiv_rn(a.lam[g], theta); },
                                  [&](int g) { return a.count_w[g]; }, G);
    const float t2 = fma_chain_warp([&](int k) { return a.mu[k]; },
                                    [&](int k) { return a.budget[k]; }, a.K);
    if (tid == 0) {
      s.b = __fsub_rn(t1, t2);
      s.theta0 = theta0;
      s.theta = theta;
    }
  }
  __syncthreads();
}

// d bound_w / d lam into a.grad, from the state `forward` left
template <class X>
__device__ void supergradient(const Args& a, Shared& s, X& x) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int G = a.G, C = a.C, R = a.R, K = a.K;
  const float theta = s.theta, theta0 = s.theta0;
  const float inv_t2 = __fdiv_rn(1.0f, __fmul_rn(theta, theta));
  // lam_s = lam / theta: d theta gets -sum((count_w * inv_t2) * lam)
  if (warp == 0) {
    const float d = xla_sum_prod_warp([&](int g) { return __fmul_rn(a.count_w[g], inv_t2); },
                                      [&](int g) { return a.lam[g]; }, G, s.wb[0]);
    if (lane == 0) s.dtheta_a = -d;
  }
  // mu = max_c M[k, c], d mu = -budget, split evenly over the ties
  for (int k = tid; k < K; k += kAscThreads) {
    int n = 0;
    for (int c = 0; c < C; ++c)
      n += (a.onehot[(size_t)k * C + c] ? a.excess[c] : 0.0f) == a.mu[k];
    a.qmu[k] = (float)n;
  }
  if constexpr (X::kSplit) {
    shard_vec(
        x, K, [&](int k) { return (unsigned long long)(uint32_t)(int)a.qmu[k]; },
        [&](int k, auto get) {
          long long n = 0;
          for (int sh = 0; sh < x.S; ++sh) n += (long long)get(sh);
          a.qmu[k] = (float)n;
        });
  }
  __syncthreads();
  for (int k = tid; k < K; k += kAscThreads) a.qmu[k] = __fdiv_rn(-a.budget[k], a.qmu[k]);
  __syncthreads();
  // excess = max(vh/theta - price, 0)
  for (int c = tid; c < C; c += kAscThreads) {
    float dexcess = 0.0f;
    for (int k = 0; k < K; ++k) {
      if (a.onehot[(size_t)k * C + c]) {
        const float ind = a.excess[c] == a.mu[k] ? 1.0f : 0.0f;
        dexcess = __fmul_rn(ind, a.qmu[k]);
        break;
      }
    }
    const float vh = vh_of(a.vh0[c]);
    const float xe = __fsub_rn(__fdiv_rn(vh, theta), a.price[c]);
    const float dx = __fmul_rn(dexcess, tie_weight(xe, 0.0f));
    a.dvh[c] = dx;  // the theta term below reads dx; dvh_a follows
  }
  __syncthreads();
  // vh / theta: d theta gets -sum((dx * inv_t2) * vh) over configs
  if (warp == 0) {
    const float d = xla_sum_prod_warp([&](int c) { return __fmul_rn(a.dvh[c], inv_t2); },
                                      [&](int c) { return vh_of(a.vh0[c]); }, C, s.wb[0]);
    if (lane == 0) s.dtheta_b = d;
  }
  int nz = 0;
  for (int c = tid; c < C; c += kAscThreads) nz += a.z[c] == theta0;
  nz = block_sum_int(nz, s.ired);  // syncs: s.dtheta_b is visible after it
  float dtheta_b = s.dtheta_b;
  if constexpr (X::kSplit) {
    dtheta_b = shard_sum_f32(x, dtheta_b);
    nz = shard_sum_int(x, nz);
  }
  const float dtheta = __fadd_rn(s.dtheta_a, -dtheta_b);
  const float qtheta = __fdiv_rn(__fmul_rn(dtheta, tie_weight(theta0, kEps)), (float)nz);
  // theta0 = max_c z; vh = where(finite, vh0, 0); vh0 = min_r v
  for (int c = tid; c < C; c += kAscThreads) {
    const float dvh_a = __fdiv_rn(a.dvh[c], theta);
    const float p = a.price[c];
    const float dz = __fmul_rn(a.z[c] == theta0 ? 1.0f : 0.0f, qtheta);
    const float dvh_b = (a.uncapped[c] && p > 0.0f) ? __fdiv_rn(dz, pden_of(p)) : 0.0f;
    const float dvh = __fadd_rn(dvh_a, dvh_b);
    const float v0 = a.vh0[c];
    const float dvh0 = isfinite(v0) ? dvh : 0.0f;
    int nv = 0;
    for (int r = 0; r < R; ++r) nv += v_of(a, c, r) == v0;
    const float qv = __fdiv_rn(dvh0, (float)nv);
    for (int r = 0; r < R; ++r) {
      const int i = c * R + r;
      const float dv = __fmul_rn(v_of(a, c, r) == v0 ? 1.0f : 0.0f, qv);
      const float dmm = a.valid[i] ? __fmul_rn(dv, a.alloc[i]) : 0.0f;
      a.qx[i] = __fdiv_rn(dmm, a.qx[i]);  // the ties of mm, counted by forward
    }
  }
  __syncthreads();
  // mm = max_g X; X = where(compat, ratio, 0): d ratio[g, r] sums over c
  for (int row = warp; row < G * R; row += kAscWarps) {
    const int g = row / R, r = row % R;
    const float rt = a.ratio[row];
    const uint8_t* crow = a.compat + (size_t)g * C;
    const float d = xla_sum_warp(
        [&](int c) {
          const int i = c * R + r;
          return (crow[c] && rt == a.mm[i]) ? a.qx[i] : 0.0f;
        },
        C, s.wb[warp]);
    if (lane == 0) a.dratio[row] = d;
  }
  if constexpr (X::kSplit) shard_sum_ordered(x, a.dratio, G * R);
  __syncthreads();
  // ratio = where(mask, lam / req, 0): sum over r, plus the lam_s term
  for (int g = tid; g < G; g += kAscThreads) {
    const bool live = a.count[g] > 0.0f;
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float rq = a.req[g * R + r];
      acc = __fadd_rn(acc, (rq > 0.0f && live) ? __fdiv_rn(a.dratio[g * R + r], rq) : 0.0f);
    }
    a.grad[g] = __fadd_rn(__fdiv_rn(a.count_w[g], theta), acc);
  }
  __syncthreads();
}

template <class X>
__device__ void ascend_body(const Args& a, X& x) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int G = a.G;
  for (int g = tid; g < G; g += kAscThreads) {
    a.lam[g] = a.lam0[g];
    a.best_lam[g] = a.lam0[g];
  }
  __syncthreads();
  forward(a, s, x);
  float best = s.b;
  int last = -1;
  for (int t = 0; t < a.n_iters; ++t) {
    supergradient(a, s, x);
    if (tid < 32) {
      const float n2 = xla_sum_prod_warp([&](int g) { return a.grad[g]; },
                                         [&](int g) { return a.grad[g]; }, G, s.wb[0]);
      if (tid == 0) {
        const float nrm = __fsqrt_rn(n2);
        s.den = nrm > kEps ? nrm : kEps;
      }
    }
    float lmax = -kInf;
    for (int g = tid; g < G; g += kAscThreads) lmax = fmaxf(lmax, a.lam[g]);
    lmax = block_max(lmax, s.red);  // syncs: s.den is visible after it
    const float scale = lmax > 1e-9f ? lmax : 1e-9f;
    const float eta = __fdiv_rn(0.5f, __fsqrt_rn(__fadd_rn(1.0f, (float)t)));
    const float den = s.den;
    for (int g = tid; g < G; g += kAscThreads) {
      const float gn = __fdiv_rn(a.grad[g], den);
      const float y = __fmaf_rn(__fmul_rn(eta, gn), scale, a.lam[g]);
      a.lam[g] = y > 0.0f ? y : 0.0f;
    }
    __syncthreads();
    forward(a, s, x);
    if (s.b > best) {  // uniform: every thread reads the same s.b
      best = s.b;
      last = t;
      for (int g = tid; g < G; g += kAscThreads) a.best_lam[g] = a.lam[g];
    }
  }
  if (tid == 0) {
    *a.best = best;
    *a.last_up = last;
  }
}

__global__ void __launch_bounds__(kAscThreads, 1) lp_ascend_kernel(Args a) {
  NoSplit x;
  ascend_body(a, x);
}

// per-shard pointers of the split ascent's config-axis arrays
struct AscShards {
  const uint8_t* const* compat;    // [Gp, Cs] each
  const float* const* alloc;       // [Cs, R]
  const float* const* price;       // [Cs]
  const uint8_t* const* valid;     // [Cs, R]
  const uint8_t* const* onehot;    // [Kp, Cs]
  const uint8_t* const* uncapped;  // [Cs]
  float* const* mm;                // [Cs, R] scratch
  float* const* qx;                // [Cs, R]
  float* const* vh0;               // [Cs]
  float* const* dvh;               // [Cs]
  float* const* excess;            // [Cs]
  float* const* z;                 // [Cs]
};

// block s: shard s's columns and its replica of lam and the per-group
// state (leading shard axis on best, best_lam, last_up and the scratch)
__global__ void __launch_bounds__(kAscThreads, 1) lp_ascend_sharded_kernel(
    Args base, AscShards t, unsigned long long* slots, unsigned* arrive, int S, int words) {
  const int sh = blockIdx.x;
  Args a = base;
  const size_t G = (size_t)a.G, GR = (size_t)a.G * a.R, K = (size_t)a.K;
  a.best += sh;
  a.best_lam += sh * G;
  a.last_up += sh;
  a.lam += sh * G;
  a.grad += sh * G;
  a.ratio += sh * GR;
  a.dratio += sh * GR;
  a.mu += sh * K;
  a.qmu += sh * K;
  a.compat = t.compat[sh];
  a.alloc = t.alloc[sh];
  a.price = t.price[sh];
  a.valid = t.valid[sh];
  a.onehot = t.onehot[sh];
  a.uncapped = t.uncapped[sh];
  a.mm = t.mm[sh];
  a.qx = t.qx[sh];
  a.vh0 = t.vh0[sh];
  a.dvh = t.dvh[sh];
  a.excess = t.excess[sh];
  a.z = t.z[sh];
  DeviceSplit x{slots, arrive, sh, S, words, sh * a.C, 0u};
  ascend_body(a, x);
}

int check_sizes(int G, int C, int R, int K, int n_iters) {
  if (R < 1 || R > kMaxR || G < 1 || C < 1 || K < 1 || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  // the windowed sums keep kMaxWin window sums a warp
  if (G > kMaxTerms || C > kMaxTerms) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int lp_ascend_launch(
    const float* lam0, const float* count, const float* count_w, const uint8_t* compat,
    const float* req, const float* alloc, const float* price, const uint8_t* valid,
    const uint8_t* onehot, const float* budget, const uint8_t* uncapped, float* best,
    float* best_lam, int32_t* last_up, float* lam, float* grad, float* ratio, float* dratio,
    float* mm, float* qx, float* vh0, float* dvh, float* excess, float* z, float* mu,
    float* qmu, int G, int C, int R, int K, int n_iters, cudaStream_t stream) {
  if (int e = check_sizes(G, C, R, K, n_iters)) return e;
  Args a{lam0, count, count_w, compat, req, alloc, price, valid, onehot, budget, uncapped,
         best, best_lam, last_up, lam, grad, ratio, dratio, mm, qx, vh0, dvh, excess, z,
         mu, qmu, G, C, R, K, n_iters};
  lp_ascend_kernel<<<1, kAscThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Split B5 over S shards of C configs each: the twelve tables hold S
// device pointers each (compat, alloc, price, valid, onehot, uncapped
// and the per-config scratch mm, qx, vh0, dvh, excess, z); best,
// best_lam, last_up and the per-group scratch carry a leading shard
// axis; slots [2, S, words] (words >= max(Kp, Gp * R, 4)) and arrive
// (zeroed) are the exchange's. One cooperative launch of S blocks.
extern "C" int lp_ascend_sharded_launch(
    const uint8_t* const* compat, const float* const* alloc, const float* const* price,
    const uint8_t* const* valid, const uint8_t* const* onehot,
    const uint8_t* const* uncapped, float* const* mm, float* const* qx,
    float* const* vh0, float* const* dvh, float* const* excess, float* const* z,
    const float* lam0, const float* count, const float* count_w, const float* req,
    const float* budget, float* best, float* best_lam, int32_t* last_up, float* lam,
    float* grad, float* ratio, float* dratio, float* mu, float* qmu,
    unsigned long long* slots, unsigned* arrive,
    int G, int C, int R, int K, int n_iters, int S, int words, cudaStream_t stream) {
  if (int e = check_sizes(G, C, R, K, n_iters)) return e;
  if (S < 2 || words < 4 || words < K || words < G * R) return (int)cudaErrorInvalidValue;
  Args a{lam0, count, count_w, nullptr, req, nullptr, nullptr, nullptr, nullptr, budget,
         nullptr, best, best_lam, last_up, lam, grad, ratio, dratio, nullptr, nullptr,
         nullptr, nullptr, nullptr, nullptr, mu, qmu, G, C, R, K, n_iters};
  AscShards t{compat, alloc, price, valid, onehot, uncapped, mm, qx, vh0, dvh, excess, z};
  void* params[] = {&a, &t, &slots, &arrive, &S, &words};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)lp_ascend_sharded_kernel, dim3(S), dim3(kAscThreads), params, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
