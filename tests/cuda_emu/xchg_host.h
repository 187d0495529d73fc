// The named device functions of karpenter_tpu_torch/csrc/shard_xchg.cuh,
// for the CPU emulation (tests/test_torch_ascent_emu.py,
// tests/test_torch_xchg_emu.py): included before the header, which then
// compiles unchanged. A flagged word is a std::atomic_ref store and load
// (relaxed; a store wakes the readers sleeping on its tag), the shard
// barrier's arrival a release add and its wait an
// acquire load, the global timer the steady clock, a trap abort(), and a
// block's shared variable one static a block (blockIdx.x < 64), a
// poll's pause a futex wait on the word's tag (Linux). The
// memory model is the host's (x86: stronger than the card's); only the
// card holds the weak ordering (chip_smoke.py, tests/test_torch_cuda.py).
#pragma once
#define KARPENTER_XCHG_HOST
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <chrono>
#include <climits>
#include <cstdlib>
#include <ctime>
#include <thread>
#include "cuda_emu.h"

namespace cuda {
enum thread_scope { thread_scope_block, thread_scope_device, thread_scope_system };
}  // namespace cuda

// the tag's half of a flagged word (little-endian: the high 32 bits)
inline int* xtag_word(const unsigned long long* p) {
  return reinterpret_cast<int*>(const_cast<unsigned long long*>(p)) + 1;
}

template <cuda::thread_scope>
inline void xstore(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long>(*p).store(v, std::memory_order_relaxed);
  syscall(SYS_futex, xtag_word(p), FUTEX_WAKE, INT_MAX, nullptr, nullptr, 0);
}

template <cuda::thread_scope>
inline unsigned long long xload(const unsigned long long* p) {
  return std::atomic_ref<unsigned long long>(*const_cast<unsigned long long*>(p))
      .load(std::memory_order_relaxed);
}

// the clock of a wait: a waiting thread also yields, so that the
// threads it waits for run
inline unsigned long long xclock() {
  std::this_thread::yield();
  return (unsigned long long)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

[[noreturn]] inline void xtrap() { abort(); }

// a waiting reader sleeps on the word's tag (a futex, which also works
// across the processes of the split B1 harness) until a writer wakes it
// or 200 us pass, so that the emulation's waits take no CPU from the
// threads they wait for
inline void xpause(const unsigned long long* p, unsigned long long v) {
  timespec ts{0, 200000};
  syscall(SYS_futex, xtag_word(p), FUTEX_WAIT, (int)(v >> 32), &ts, nullptr, 0);
}

template <class T, int id>
inline T& xshared() {
  static T v[64];
  return v[blockIdx.x];
}

template <cuda::thread_scope>
inline void xarrive(unsigned* p) {
  std::atomic_ref<unsigned>(*p).fetch_add(1u, std::memory_order_release);
}

template <cuda::thread_scope>
inline unsigned xacquire(const unsigned* p) {
  return std::atomic_ref<unsigned>(*const_cast<unsigned*>(p)).load(std::memory_order_acquire);
}
