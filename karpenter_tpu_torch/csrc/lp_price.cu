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
// up to G dependent rounds, each a block-wide argmax over the groups;
// the bytes (G*C compat bytes, the small vectors, q out) and the
// arithmetic (G*R divisions per round) are far below what the chain
// costs. So the design is one block per config (at 50k pods x 500
// types, 243 padded configs fill the 132 SMs), threads over groups
// with the densities, the counts taken so far and the residual in
// shared memory, and one block-wide argmax per round on packed
// (value, index) keys reduced with warp shuffles.
//
// Exactness: f32 with explicit round-to-nearest intrinsics in the JAX
// order of operations, -fmad=false in the build; the argmax is a min
// over packed (-value, index) keys, independent of reduction order.

#include "pack_common.cuh"

namespace {

constexpr int kPriceThreads = 256;
constexpr int kPriceWarps = kPriceThreads / 32;

// k_g: the pods of group g that fit the residual, capped at its demand
// left (as the JAX body computes it, before the k >= 1 test)
__device__ __forceinline__ float fit_count(const float* resid, const float* req,
                                           int R, int left) {
  float k = __int_as_float(0x7f800000);  // +inf, the identity of the JAX min
  for (int r = 0; r < R; ++r) {
    float rq = req[r];
    float v = 2.0e9f;
    if (rq > 0.0f) v = floorf(__fdiv_rn(__fadd_rn(resid[r], 1e-4f), fmaxf(rq, 1e-9f)));
    k = fminf(k, v);
  }
  return fminf(k, (float)left);
}

__global__ void __launch_bounds__(kPriceThreads) lp_price_kernel(
    const float* __restrict__ lam, const uint8_t* __restrict__ compat,
    const float* __restrict__ group_req, const float* __restrict__ eff_alloc,
    const int32_t* __restrict__ count, int32_t* __restrict__ q_out,
    float* __restrict__ value, int G, int C, int R) {
  extern __shared__ unsigned char smem[];
  float* density = reinterpret_cast<float*>(smem);         // [G]
  int32_t* q = reinterpret_cast<int32_t*>(density + G);     // [G]
  float* wins = reinterpret_cast<float*>(q + G);            // [ceil(G/32)]
  __shared__ float resid[kMaxR];
  __shared__ unsigned long long warp_key[kPriceWarps];
  __shared__ unsigned long long best_key;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* alloc = eff_alloc + (size_t)c * R;

  if (tid < R) resid[tid] = alloc[tid];
  for (int g = tid; g < G; g += kPriceThreads) {
    const float* req = group_req + (size_t)g * R;
    float frac = 0.0f;
    for (int r = 0; r < R; ++r) {
      float f = req[r] > 0.0f ? __fdiv_rn(req[r], fmaxf(alloc[r], 1e-9f)) : 0.0f;
      frac = fmaxf(frac, f);
    }
    float l = lam[g];
    density[g] = (l > 0.0f && compat[(size_t)g * C + c] && frac > 0.0f)
                     ? __fdiv_rn(l, frac) : -1.0f;
    q[g] = 0;
  }
  __syncthreads();

  for (int round = 0; round < G; ++round) {
    // argmax of the candidates, lowest index on a tie: min over
    // (-value, index) keys
    unsigned long long key = ~0ull;
    for (int g = tid; g < G; g += kPriceThreads) {
      float k = fit_count(resid, group_req + (size_t)g * R, R, count[g] - q[g]);
      float cand = k >= 1.0f ? density[g] : -1.0f;
      unsigned long long kk = pack_key(float_key(-cand), g);
      key = kk < key ? kk : key;
    }
    key = warp_min_u64(key);
    if (lane == 0) warp_key[warp] = key;
    __syncthreads();
    if (warp == 0) {
      unsigned long long k2 = lane < kPriceWarps ? warp_key[lane] : ~0ull;
      k2 = warp_min_u64(k2);
      if (lane == 0) best_key = k2;
    }
    __syncthreads();
    const int best = (int)(uint32_t)(best_key & 0xffffffffull);
    const float best_val = -key_float((uint32_t)(best_key >> 32));
    if (!(best_val > 0.0f)) break;  // uniform: every thread read best_key
    const float* breq = group_req + (size_t)best * R;
    // the take is the winner's k, recomputed from the same state
    const float take = fit_count(resid, breq, R, count[best] - q[best]);
    __syncthreads();  // every thread has read resid and q[best]
    if (tid == 0) q[best] += (int32_t)take;
    if (tid < R) resid[tid] = __fsub_rn(resid[tid], __fmul_rn(take, breq[tid]));
    __syncthreads();
  }

  // q out, and value = sum_g q * lam in the order of the JAX package's
  // XLA program on the CPU (lp_plan.row_value): up to 32 groups one
  // fused multiply-add chain; beyond, the rounded products in windows
  // of 32 (half the zero padding in front), the window sums reduced
  // the same way until at most 32 are left, then in order. One thread:
  // G adds are nothing beside the rounds.
  int32_t* qrow = q_out + (size_t)c * G;
  for (int g = tid; g < G; g += kPriceThreads) qrow[g] = q[g];
  if (tid == 0) {
    float s = 0.0f;
    if (G <= 32) {
      for (int g = 0; g < G; ++g) s = __fmaf_rn((float)q[g], lam[g], s);
    } else {
      int n = G;
      bool products = true;
      while (n > 32) {
        const int nwin = (n + 31) / 32;
        const int front = (nwin * 32 - n) / 2;
        // window j reads indices >= 32j - 15 > j for j >= 1, so the
        // sums can overwrite the level in place
        for (int j = 0; j < nwin; ++j) {
          float w = 0.0f;
          for (int i = 0; i < 32; ++i) {
            const int idx = 32 * j + i - front;
            float x = 0.0f;
            if (idx >= 0 && idx < n) x = products ? __fmul_rn((float)q[idx], lam[idx]) : wins[idx];
            w = __fadd_rn(w, x);
          }
          wins[j] = w;
        }
        n = nwin;
        products = false;
      }
      for (int j = 0; j < n; ++j) s = __fadd_rn(s, wins[j]);
    }
    value[c] = s;
  }
}

}  // namespace

extern "C" int lp_price_launch(const float* lam, const uint8_t* compat,
                               const float* group_req, const float* eff_alloc,
                               const int32_t* count, int32_t* q, float* value,
                               int G, int C, int R, cudaStream_t stream) {
  if (R > kMaxR || G < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)G * 8 + (size_t)((G + 31) / 32) * 4;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lp_price_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  lp_price_kernel<<<C, kPriceThreads, shmem, stream>>>(
      lam, compat, group_req, eff_alloc, count, q, value, G, C, R);
  return (int)cudaGetLastError();
}
