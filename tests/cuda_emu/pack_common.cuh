// Stand-in for karpenter_tpu_torch/csrc/pack_common.cuh in the CPU
// emulation of lp_ascend.cu (tests/test_torch_ascent_emu.py): what the
// kernel takes from it (kMaxR, a PhaseClock that times nothing) and the
// split kernels' exchange, shard_xchg_emu.h, which the test writes from
// csrc/shard_xchg.cuh with its device-only calls replaced.
#pragma once
#include "cuda_emu.h"
namespace {
constexpr int kMaxR = 16;
struct PhaseClock {
  bool on = false;
  void begin() {}
  void mark(int) {}
  void count() {}
};
}  // namespace
#include "shard_xchg_emu.h"
