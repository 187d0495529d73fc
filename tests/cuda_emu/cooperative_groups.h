// Stand-in for cooperative_groups.h in the CPU emulation of
// pack_wavefront.cu and lp_ascend.cu (tests/test_torch_wave_emu.py,
// tests/test_torch_lanes_emu.py, tests/test_torch_ascent_emu.py). The
// packing harnesses pass a kernel body its own barrier, so the grid is
// never synchronized here. B5's wide layout runs one cluster of blocks
// (std::threads of one process, blockIdx.x the block's rank): its harness
// sets each block's dynamic shared memory in g_cluster_smem and the
// barrier over every thread of the cluster in g_cluster_bar; a block's
// shared address maps to another block's at the same offset from its
// dynamic shared memory.
#pragma once
#include "cuda_emu.h"
namespace cooperative_groups {
inline unsigned char* g_cluster_smem[64];
inline EmuBarrier* g_cluster_bar;
struct grid_group {
  void sync() const { abort(); }
};
struct cluster_group {
  void sync() const {
    if (!g_cluster_bar) abort();
    g_cluster_bar->arrive_and_wait();
  }
  unsigned block_rank() const { return blockIdx.x; }
  template <class T>
  T* map_shared_rank(T* p, int r) const {
    const unsigned char* base = g_cluster_smem[blockIdx.x];
    return reinterpret_cast<T*>(g_cluster_smem[r] + (reinterpret_cast<unsigned char*>(p) - base));
  }
};
inline grid_group this_grid() { return {}; }
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
