// B2: the flat output epilogue of the provisioning solve.
//
// Replaces the epilogue of karpenter_tpu/solver/pack.py::pack_split_flat
// (the bit-pack and concatenate after the kernel). Plain version:
// karpenter_tpu_torch/solver/pack_split.py::pack_flat_words_ref.
//
// Output, as 32-bit words (the caller reads them as uint32):
//   [0, N*G)            assign, row-major
//   [N*G, N*G + F*W)    free_mask packed: bit i of word w of row f is
//                       column 32w+i (W = C / 32)
//   N*G + F*W           node_count
//   then G words        unsched
//   then G words, 1     widths and steps, on the wavefront route only
//                       (B3's stats, after every sequential field)
//
// What bounds it: bytes. It reads N*G*4 + F*C + 4 + G*4 bytes (plus
// G*4 + 4 for the wavefront stats) and writes N*G*4 + F*C/8 + 4 + G*4
// (plus the same G*4 + 4); one thread per output word, so a thread
// either packs 32 mask bytes (two 16-byte loads) or copies one word,
// with neighbouring threads on neighbouring words. One kernel serves
// both routes.
//
// The lane epilogue of B6 (karpenter_tpu/solver/pack.py:1292-1307,
// `pack_probe_lanes_flat`) is the same kernel over a lane axis: every
// input carries a leading lane axis of L and the output is [L, row],
// one row per lane in the layout above; one thread per output word
// across all lanes. With L = 1 it is B2. Plain version:
// pack_split.py::pack_flat_lanes_ref.
//
// B8, split B2 (`pack_flat_sharded_kernel`): the same buffer from a
// split solve — the replicated outputs from replica 0, the fresh rows'
// masks from the S shards' [F, Cs] blocks (a table of per-shard
// pointers). A mask word can straddle shards (at 50k x 500, S = 4 and 8
// give 56 and 28 columns a shard), so each bit is read from the shard
// that owns its global column; one thread per output word, as above.
// Plain version: pack_shard.py::pack_flat_words_sharded_ref.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pack_flat_kernel(const int32_t* __restrict__ assign,
                                 const uint8_t* __restrict__ free_mask,
                                 const int32_t* __restrict__ node_count,
                                 const int32_t* __restrict__ unsched,
                                 const int32_t* __restrict__ widths,
                                 const int32_t* __restrict__ steps,
                                 int32_t* __restrict__ out,
                                 long long n_assign, long long n_words, int G, int L) {
  const long long n_seq = n_assign + n_words + 1 + G;
  const long long n_row = n_seq + (widths ? G + 1 : 0);
  const long long total = n_row * L;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long l = i / n_row;
    const long long j = i - l * n_row;
    if (j < n_assign) {
      out[i] = assign[l * n_assign + j];
    } else if (j < n_assign + n_words) {
      const long long w = l * n_words + (j - n_assign);
      // a word's 32 mask bytes are contiguous: row f, columns 32w'..
      const uint4* src = reinterpret_cast<const uint4*>(free_mask + w * 32);
      uint4 lo = src[0], hi = src[1];
      const uint32_t parts[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t word = 0;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if ((parts[p] >> (8 * b)) & 0xffu) word |= 1u << (4 * p + b);
        }
      }
      out[i] = (int32_t)word;
    } else if (j == n_assign + n_words) {
      out[i] = node_count[l];
    } else if (j < n_seq) {
      out[i] = unsched[l * G + (j - n_assign - n_words - 1)];
    } else if (j < n_seq + G) {
      out[i] = widths[l * G + (j - n_seq)];
    } else {
      out[i] = steps[l];
    }
  }
}

int launch(const int32_t* assign, const uint8_t* free_mask, const int32_t* node_count,
           const int32_t* unsched, const int32_t* widths, const int32_t* steps,
           int32_t* out, int N, int G, int F, int C, int L, cudaStream_t stream) {
  if (C % 32 || L < 1 || (widths == nullptr) != (steps == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_assign = (long long)N * G;
  const long long n_words = (long long)F * (C / 32);
  const long long total = (n_assign + n_words + 1 + G + (widths ? G + 1 : 0)) * L;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  pack_flat_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      assign, free_mask, node_count, unsched, widths, steps, out, n_assign, n_words, G, L);
  return (int)cudaGetLastError();
}

__global__ void pack_flat_sharded_kernel(const int32_t* __restrict__ assign,
                                         const uint8_t* const* __restrict__ masks,
                                         const int32_t* __restrict__ node_count,
                                         const int32_t* __restrict__ unsched,
                                         const int32_t* __restrict__ widths,
                                         const int32_t* __restrict__ steps,
                                         int32_t* __restrict__ out,
                                         long long n_assign, int F, int Cs, int S, int G) {
  const int Cp = Cs * S;
  const long long n_words = (long long)F * (Cp / 32);
  const long long n_seq = n_assign + n_words + 1 + G;
  const long long n_row = n_seq + (widths ? G + 1 : 0);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_row;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < n_assign) {
      out[i] = assign[i];
    } else if (i < n_assign + n_words) {
      const long long w = i - n_assign;
      const int f = (int)(w / (Cp / 32));
      const int c0 = (int)(w % (Cp / 32)) * 32;
      uint32_t word = 0;
      for (int b = 0; b < 32; ++b) {
        const int c = c0 + b;
        if (masks[c / Cs][(size_t)f * Cs + (c % Cs)]) word |= 1u << b;
      }
      out[i] = (int32_t)word;
    } else if (i == n_assign + n_words) {
      out[i] = node_count[0];
    } else if (i < n_seq) {
      out[i] = unsched[i - n_assign - n_words - 1];
    } else if (i < n_seq + G) {
      out[i] = widths[i - n_seq];
    } else {
      out[i] = steps[0];
    }
  }
}

}  // namespace

// Split B2: assign [S, N, G], node_count [S], unsched [S, G] (widths
// [S, G] and steps [S] on the wavefront route) are replicas, of which
// replica 0 is read; masks is a device table of S pointers to [F, Cs]
// blocks; out is one row of pack_flat_launch's layout.
extern "C" int pack_flat_sharded_launch(const int32_t* assign, const uint8_t* const* masks,
                                        const int32_t* node_count, const int32_t* unsched,
                                        const int32_t* widths, const int32_t* steps,
                                        int32_t* out, int N, int G, int F, int Cs, int S,
                                        cudaStream_t stream) {
  if ((Cs * S) % 32 || S < 1 || (widths == nullptr) != (steps == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_assign = (long long)N * G;
  const long long total =
      n_assign + (long long)F * (Cs * S / 32) + 1 + G + (widths ? G + 1 : 0);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  pack_flat_sharded_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      assign, masks, node_count, unsched, widths, steps, out, n_assign, F, Cs, S, G);
  return (int)cudaGetLastError();
}

// inputs [L, N, G], [L, F, C], [L], [L, G] (and [L, G], [L] on the
// wavefront route; both null on the sequential route), output
// [L, row]; B2 is L = 1
extern "C" int pack_flat_launch(const int32_t* assign, const uint8_t* free_mask,
                                const int32_t* node_count, const int32_t* unsched,
                                const int32_t* widths, const int32_t* steps,
                                int32_t* out, int N, int G, int F, int C, int L,
                                cudaStream_t stream) {
  return launch(assign, free_mask, node_count, unsched, widths, steps, out, N, G, F, C, L,
                stream);
}
