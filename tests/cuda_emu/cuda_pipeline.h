// Stand-in for cuda_pipeline.h in the CPU emulation: an asynchronous
// copy is a plain one.
#pragma once
#include <cstring>
#include "cuda_emu.h"
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) { std::memcpy(dst, src, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
