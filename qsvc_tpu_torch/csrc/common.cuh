// Helpers shared by K1 (me_refine.cu) and K2-K4 (mc.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// where lax.dynamic_slice starts a win-long slice of a size-long axis
__device__ __forceinline__ int slice_start(int s, int size, int win) {
  return clampi(s < 0 ? s + size : s, 0, size - win);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
