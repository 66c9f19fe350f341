// Shared device helpers of the svs_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace svs {

// Dead-lane / cleared-lane marker: exactly -2^24 (KEY_DEAD in
// svs_tpu/ops/pallas_extract.py), strictly below every live key.
constexpr float kKeyDead = -16777216.0f;

// Warp-wide max of one float per lane; every lane gets the result.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Atomic float max through the sign-split integer order: non-negative
// floats order like signed ints, negative ones like reversed unsigned ints.
// Order-independent, so the result is deterministic.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

}  // namespace svs
