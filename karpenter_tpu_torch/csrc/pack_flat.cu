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
// with neighbouring threads on neighbouring words, its lane found by a
// 32-bit division while the loop's indices stay below 2^31. One kernel
// serves both routes.
//
// The lane epilogue of B6 (karpenter_tpu/solver/pack.py:1292-1307,
// `pack_probe_lanes_flat`) is the same kernel over a lane axis: every
// input carries a leading lane axis of L and the output is [L, row],
// one row per lane in the layout above; one thread per output word
// across all lanes. With L = 1 it is B2. Plain version:
// pack_split.py::pack_flat_lanes_ref. This full copy stays for B7's
// epilogue (every node row is a mask row, solver/pack_dense.py), for
// B6's wavefront program (written in place, that kernel, at its 64
// registers a thread, spilled more and ran longer than the copy costs,
// PERF.md §6) and for the standalone `pack_flat_words` /
// `pack_flat_lanes`.
//
// The flat routes write in place (`pack_flat_masks_kernel`). At 50k x
// 500 most of the full copy's bytes are the N x G assignment, which the
// packing kernel has just written: it read that block and wrote it
// again, 4 bytes a thread, with a 64-bit division a word to find the
// lane. The flat routes (pack_split.py `pack_split_flat`,
// `pack_probe_lanes_flat`) now hand the packing kernel (B1, B3 or B6's
// sequential program) the regions of one zeroed flat buffer as its
// assign, node_count and unsched (and B3's widths and steps) outputs,
// with the mask bytes [L, F, C] behind the rows, so that the epilogue
// packs only the L x F x C / 32 mask words: a thread a word, its 32
// bytes in two 16-byte loads, in 32-bit index math, on a grid of a few
// blocks an SM. Its bound is the mask bytes read and the words written.
// Plain version: pack_split.py::pack_flat_masks_ref. Measured on the
// card and not kept: a warp a word with one ballot (a lane a byte), as
// split B2 reads its straddling words; slower on both the first 50k x
// 500 request and the consolidation chunk's lanes (PERF.md §6).
//
// B8, split B2 (`pack_flat_sharded_kernel`): the same buffer from a
// split solve — the replicated outputs from replica 0, the fresh rows'
// masks from the S shards' [F, Cs] blocks, one [S, F, Cs] buffer. A mask
// word can straddle shards (at 50k x 500, S = 4 and 8 give 56 and 28
// columns a shard), so each bit is read from the shard that owns its
// global column: a warp a mask word, a lane a column, one ballot; the
// copies one thread an output word, as above. Bound by bytes as B2; the
// design it replaces (32 dependent byte loads a word through a per-call
// device table of shard pointers, the table copied from pageable host
// memory on every call) took 0.043-0.088 ms a call against 0.006 ms for
// its kernel alone on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
// Plain version:
// pack_shard.py::pack_flat_words_sharded_ref.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// I: the index type, int when every index the grid-stride loop forms
// stays below 2^31 (`flat_index_int`: a 32-bit division a word to find
// its lane), else long long. A mask word's byte offset (32 a word) is
// taken in 64 bits either way.
template <class I>
__global__ void pack_flat_kernel(const int32_t* __restrict__ assign,
                                 const uint8_t* __restrict__ free_mask,
                                 const int32_t* __restrict__ node_count,
                                 const int32_t* __restrict__ unsched,
                                 const int32_t* __restrict__ widths,
                                 const int32_t* __restrict__ steps,
                                 int32_t* __restrict__ out,
                                 I n_assign, I n_words, int G, int L) {
  const I n_seq = n_assign + n_words + 1 + G;
  const I n_row = n_seq + (widths ? G + 1 : 0);
  const I total = n_row * L;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (I)gridDim.x * blockDim.x) {
    const I l = i / n_row;
    const I j = i - l * n_row;
    if (j < n_assign) {
      out[i] = assign[l * n_assign + j];
    } else if (j < n_assign + n_words) {
      const I w = l * n_words + (j - n_assign);
      // a word's 32 mask bytes are contiguous: row f, columns 32w'..
      const uint4* src = reinterpret_cast<const uint4*>(free_mask + (size_t)w * 32);
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

// Split B2: one thread an output word for the copies (assign, the
// tallies and stats), and one warp a mask word: lane b reads the byte of
// global column 32 w + b from the shard that owns it (masks [S, F, Cs],
// one buffer: no pointer table) and a ballot makes the word. The
// virtual index space puts the 32 n_words mask lanes first, so a warp is
// whole on them (their end is a multiple of 32), then the copies.
__global__ void pack_flat_sharded_kernel(const int32_t* __restrict__ assign,
                                         const uint8_t* __restrict__ masks,
                                         const int32_t* __restrict__ node_count,
                                         const int32_t* __restrict__ unsched,
                                         const int32_t* __restrict__ widths,
                                         const int32_t* __restrict__ steps,
                                         int32_t* __restrict__ out,
                                         long long n_assign, int F, int Cs, int S, int G) {
  const int Cp = Cs * S, wpr = Cp / 32;  // mask words a row
  const long long n_words = (long long)F * wpr;
  const long long n_seq = n_assign + n_words + 1 + G;
  const long long n_row = n_seq + (widths ? G + 1 : 0);
  const long long n_mask = 32 * n_words;  // the mask words' lanes
  const long long total = n_mask + (n_row - n_words);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total; v += stride) {
    if (v < n_mask) {
      // a whole warp: word v / 32, lane v % 32
      const long long w = v >> 5;
      const int b = (int)(v & 31);
      const int f = (int)(w / wpr);
      const int c = (int)(w % wpr) * 32 + b;
      const int s = c / Cs;
      const uint8_t byte = masks[((size_t)s * F + f) * Cs + (c - s * Cs)];
      const uint32_t word = __ballot_sync(0xffffffffu, byte != 0);
      if (b == 0) out[n_assign + w] = (int32_t)word;
    } else {
      long long i = v - n_mask;  // the copies, in output order past the mask words
      if (i >= n_assign) i += n_words;
      if (i < n_assign) {
        out[i] = assign[i];
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
}

// The flat routes' epilogue: mask word w (of L x F x C / 32, lane l =
// w / wpl) of the [L, F, C] mask bytes `free_mask` into out[l * row +
// off + w - l * wpl], wpl = F * C / 32 words a lane: a thread a word,
// its 32 bytes in two 16-byte loads. 32-bit index math: the wrapper
// keeps L x F x C below 2^31.
__global__ void pack_flat_masks_kernel(const uint8_t* __restrict__ free_mask,
                                       int32_t* __restrict__ out, int n_words, int wpl, int row,
                                       int off) {
  const int stride = gridDim.x * blockDim.x;
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < n_words; w += stride) {
    const uint4* src = reinterpret_cast<const uint4*>(free_mask) + 2 * w;
    const uint4 lo = src[0], hi = src[1];
    const uint32_t parts[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t word = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((parts[p] >> (8 * b)) & 0xffu) word |= 1u << (4 * p + b);
      }
    }
    const int l = w / wpl;
    out[l * row + off + (w - l * wpl)] = (int32_t)word;
  }
}

// The full copy's grid: a thread an output word, at most 65535 blocks
// of kFlatBlock threads striding over the rest.
constexpr int kFlatBlock = 256;

inline long long flat_blocks(long long total) {
  return std::min(std::max((total + kFlatBlock - 1) / kFlatBlock, 1LL), 65535LL);
}

// Whether the full copy of `total` output words indexes in 32 bits: the
// largest index its grid-stride loop forms (the last word's plus the
// grid's stride) stays below 2^31.
inline bool flat_index_int(long long total) {
  return total - 1 + flat_blocks(total) * kFlatBlock < (1LL << 31);
}

int launch(const int32_t* assign, const uint8_t* free_mask, const int32_t* node_count,
           const int32_t* unsched, const int32_t* widths, const int32_t* steps,
           int32_t* out, int N, int G, int F, int C, int L, cudaStream_t stream) {
  if (C % 32 || L < 1 || (widths == nullptr) != (steps == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_assign = (long long)N * G;
  const long long n_words = (long long)F * (C / 32);
  const long long total = (n_assign + n_words + 1 + G + (widths ? G + 1 : 0)) * L;
  const unsigned blocks = (unsigned)flat_blocks(total);
  if (flat_index_int(total))
    pack_flat_kernel<int><<<blocks, kFlatBlock, 0, stream>>>(
        assign, free_mask, node_count, unsched, widths, steps, out, (int)n_assign,
        (int)n_words, G, L);
  else
    pack_flat_kernel<long long><<<blocks, kFlatBlock, 0, stream>>>(
        assign, free_mask, node_count, unsched, widths, steps, out, n_assign, n_words, G, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Split B2: assign [S, N, G], node_count [S], unsched [S, G] (widths
// [S, G] and steps [S] on the wavefront route) are replicas, of which
// replica 0 is read; masks is one [S, F, Cs] buffer; out is one row of
// pack_flat_launch's layout.
extern "C" int pack_flat_sharded_launch(const int32_t* assign, const uint8_t* masks,
                                        const int32_t* node_count, const int32_t* unsched,
                                        const int32_t* widths, const int32_t* steps,
                                        int32_t* out, int N, int G, int F, int Cs, int S,
                                        cudaStream_t stream) {
  if ((Cs * S) % 32 || S < 1 || (widths == nullptr) != (steps == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_assign = (long long)N * G;
  const long long n_words = (long long)F * (Cs * S / 32);
  // a warp a mask word, a thread every other word
  const long long total = 32 * n_words + n_assign + 1 + G + (widths ? G + 1 : 0);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  pack_flat_sharded_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      assign, masks, node_count, unsched, widths, steps, out, n_assign, F, Cs, S, G);
  return (int)cudaGetLastError();
}

// The flat routes' epilogue: masks [L, F, C] bytes (16-byte aligned)
// into the mask words of the rows of out [L, row] from word `off` of
// each (C a multiple of 32, L F C < 2^31, row < 2^31 / L). The grid is
// a few blocks an SM (132 on an H100), striding over the rest.
extern "C" int pack_flat_masks_launch(const uint8_t* free_mask, int32_t* out, int F, int C,
                                      int L, int row, int off, cudaStream_t stream) {
  if (C % 32 || L < 1 || F < 0 || off < 0 || row < off ||
      (long long)L * F * C >= (1LL << 31) || (long long)L * row >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int wpl = F * (C / 32), n_words = L * wpl;
  if (n_words == 0) return 0;
  const int threads = 256;
  const int blocks = std::min((n_words + threads - 1) / threads, 4 * 132);
  pack_flat_masks_kernel<<<blocks, threads, 0, stream>>>(free_mask, out, n_words, wpl, row, off);
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
