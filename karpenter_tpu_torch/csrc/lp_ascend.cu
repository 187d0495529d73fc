// B5: the dual ascent of the cost objective's config-level LP.
//
// Replaces karpenter_tpu/solver/lp_device.py::_ascend (a jitted
// fori_loop whose step gradient came from jax.grad). Plain version:
// karpenter_tpu_torch/solver/lp_device.py::ascend_ref, which this
// kernel matches bit for bit.
//
// Each of the n_iters iterations takes the supergradient of the dual
// bound
//   bound_w(lam) = tree(lam/theta * count_w) - tree(mu * budget),
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
// eta = 0.5/sqrt(1+t) scaled by max(max(lam), 1e-9), projects onto
// lam >= 0 and keeps the best iterate. The sums are fixed-order trees
// (adjacent pairs, zero-padded to a power of two of at least 32
// elements), as in the plain version.
//
// What bounds it: the iterations. They form one dependent chain, and
// the work of one is small (at 50k pods x 500 types: Gp=194 groups,
// Cp=243 configs, R=4: a few hundred thousand element operations over
// a 47 KB compat matrix), so the design is one persistent block of
// 1024 threads for the whole ascent, phases separated by
// __syncthreads(), the state in global memory (it stays in L2). A
// cooperative grid is later work.
//
// Exactness: f32 with explicit round-to-nearest intrinsics in the
// plain version's order of operations, -fmad=false in the build.

#include "pack_common.cuh"

namespace {

constexpr int kAscThreads = 1024;
constexpr int kAscWarps = kAscThreads / 32;
constexpr float kEps = 1e-12f;
constexpr float kInf = __builtin_huge_valf();

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

// Fixed-order tree sum of elem(0..n-1), zero-padded to tree_width(n),
// by one warp: lane l folds its contiguous block of width/32 elements
// with a binary counter (exactly the adjacent-pair tree over the
// block), then the lanes combine by butterfly. Every lane returns the
// sum.
template <class F>
__device__ float warp_tree(F elem, int n) {
  int width = 32;
  while (width < n) width *= 2;
  const int per = width / 32;
  const int lane = threadIdx.x & 31;
  float stack[24];
  int top = 0;
  for (int i = 0; i < per; ++i) {
    const int idx = lane * per + i;
    float x = idx < n ? elem(idx) : 0.0f;
    int j = i, lvl = 0;
    while (j & 1) {
      x = __fadd_rn(stack[lvl], x);
      j >>= 1;
      ++lvl;
    }
    stack[lvl] = x;
    top = lvl;
  }
  float v = stack[top];
  for (int o = 1; o < 32; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
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
  float theta0, theta, b, dtheta_a, qtheta, scale, den;
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
__device__ void forward(const Args& a, Shared& s) {
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
      const float x = a.compat[(size_t)g * C + c] ? a.ratio[g * R + r] : 0.0f;
      m = fmaxf(m, x);
    }
    int ties = 0;
    for (int g = 0; g < G; ++g) {
      const float x = a.compat[(size_t)g * C + c] ? a.ratio[g * R + r] : 0.0f;
      ties += x == m;
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
  const float theta0 = block_max(zmax, s.red);
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
  __syncthreads();
  if (tid < 32) {
    const float t1 = warp_tree(
        [&](int g) { return __fmul_rn(__fdiv_rn(a.lam[g], theta), a.count_w[g]); }, G);
    const float t2 = warp_tree([&](int k) { return __fmul_rn(a.mu[k], a.budget[k]); }, a.K);
    if (tid == 0) {
      s.b = __fsub_rn(t1, t2);
      s.theta0 = theta0;
      s.theta = theta;
    }
  }
  __syncthreads();
}

// d bound_w / d lam into a.grad, from the state `forward` left
__device__ void supergradient(const Args& a, Shared& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int G = a.G, C = a.C, R = a.R, K = a.K;
  const float theta = s.theta, theta0 = s.theta0;
  const float inv_t2 = __fdiv_rn(1.0f, __fmul_rn(theta, theta));
  // lam_s = lam / theta
  if (warp == 0) {
    const float d = warp_tree(
        [&](int g) { return __fmul_rn(__fmul_rn(-a.count_w[g], a.lam[g]), inv_t2); }, G);
    if (lane == 0) s.dtheta_a = d;
  }
  // mu = max_c M[k, c], d mu = -budget
  for (int k = tid; k < K; k += kAscThreads) {
    int n = 0;
    for (int c = 0; c < C; ++c)
      n += (a.onehot[(size_t)k * C + c] ? a.excess[c] : 0.0f) == a.mu[k];
    a.qmu[k] = __fdiv_rn(-a.budget[k], (float)n);
  }
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
  if (warp == 0) {
    const float dtheta_b = warp_tree(
        [&](int c) { return __fmul_rn(__fmul_rn(-a.dvh[c], vh_of(a.vh0[c])), inv_t2); }, C);
    if (lane == 0) {
      const float dtheta = __fadd_rn(s.dtheta_a, dtheta_b);
      s.qtheta = __fmul_rn(dtheta, tie_weight(theta0, kEps));  // dtheta0, divided below
    }
  }
  int nz = 0;
  for (int c = tid; c < C; c += kAscThreads) nz += a.z[c] == theta0;
  nz = block_sum_int(nz, s.ired);  // syncs: s.qtheta is visible after it
  const float qtheta = __fdiv_rn(s.qtheta, (float)nz);
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
    const float d = warp_tree(
        [&](int c) {
          const int i = c * R + r;
          const float ind = rt == a.mm[i] ? 1.0f : 0.0f;
          return crow[c] ? __fmul_rn(ind, a.qx[i]) : 0.0f;
        },
        C);
    if (lane == 0) a.dratio[row] = d;
  }
  __syncthreads();
  // ratio = where(mask, lam / req, 0): sum over r, plus the lam_s term
  for (int g = tid; g < G; g += kAscThreads) {
    float stack[8];
    int top = 0;
    const bool live = a.count[g] > 0.0f;
    for (int r = 0; r < 32; ++r) {
      float x = 0.0f;
      if (r < R) {
        const float rq = a.req[g * R + r];
        x = (rq > 0.0f && live) ? __fdiv_rn(a.dratio[g * R + r], rq) : 0.0f;
      }
      int j = r, lvl = 0;
      while (j & 1) {
        x = __fadd_rn(stack[lvl], x);
        j >>= 1;
        ++lvl;
      }
      stack[lvl] = x;
      top = lvl;
    }
    a.grad[g] = __fadd_rn(__fdiv_rn(a.count_w[g], theta), stack[top]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kAscThreads, 1) lp_ascend_kernel(Args a) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int G = a.G;
  for (int g = tid; g < G; g += kAscThreads) {
    a.lam[g] = a.lam0[g];
    a.best_lam[g] = a.lam0[g];
  }
  __syncthreads();
  forward(a, s);
  float best = s.b;
  int last = -1;
  for (int t = 0; t < a.n_iters; ++t) {
    supergradient(a, s);
    if (tid < 32) {
      const float n2 = warp_tree([&](int g) { return __fmul_rn(a.grad[g], a.grad[g]); }, G);
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
      const float y = __fadd_rn(a.lam[g], __fmul_rn(__fmul_rn(eta, gn), scale));
      a.lam[g] = y > 0.0f ? y : 0.0f;
    }
    __syncthreads();
    forward(a, s);
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

}  // namespace

extern "C" int lp_ascend_launch(
    const float* lam0, const float* count, const float* count_w, const uint8_t* compat,
    const float* req, const float* alloc, const float* price, const uint8_t* valid,
    const uint8_t* onehot, const float* budget, const uint8_t* uncapped, float* best,
    float* best_lam, int32_t* last_up, float* lam, float* grad, float* ratio, float* dratio,
    float* mm, float* qx, float* vh0, float* dvh, float* excess, float* z, float* mu,
    float* qmu, int G, int C, int R, int K, int n_iters, cudaStream_t stream) {
  if (R < 1 || R > kMaxR || G < 1 || C < 1 || K < 1 || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  // the warp trees keep a binary counter of 24 levels: 2^23 elements a lane
  if ((long long)G > (1ll << 28) || (long long)C > (1ll << 28) || (long long)K > (1ll << 28))
    return (int)cudaErrorInvalidValue;
  Args a{lam0, count, count_w, compat, req, alloc, price, valid, onehot, budget, uncapped,
         best, best_lam, last_up, lam, grad, ratio, dratio, mm, qx, vh0, dvh, excess, z,
         mu, qmu, G, C, R, K, n_iters};
  lp_ascend_kernel<<<1, kAscThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
