// Stand-in for the CUDA runtime header in the CPU emulation
// (cuda_emu.h); the device code's includes find it first.
#pragma once
#include "cuda_emu.h"
