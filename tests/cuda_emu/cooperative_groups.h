// Stand-in for cooperative_groups.h in the CPU emulation of
// pack_wavefront.cu (tests/test_torch_wave_emu.py): the harness passes
// the kernel body its own barrier, so the grid and cluster groups are
// never synchronized here.
#pragma once
namespace cooperative_groups {
struct grid_group {
  void sync() const { abort(); }
};
struct cluster_group {
  void sync() const { abort(); }
  unsigned block_rank() const { return 0; }
};
inline grid_group this_grid() { return {}; }
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
