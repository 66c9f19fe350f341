// Shared device helpers of the svs_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace svs {

// Dead-lane / cleared-lane marker: exactly -2^24 (KEY_DEAD in
// svs_tpu/ops/pallas_extract.py), strictly below every live key.
constexpr float kKeyDead = -16777216.0f;

// The v2 packed key of score s at lane (0..511) of its 512-lane subtile:
// floor((s + KEY_BIAS) * KEY_QSCALE) * 512 + lane (_emit_keys).  Every step
// is rounded as written, so nvcc contracts nothing and a key on a grid edge
// never moves.
__device__ __forceinline__ float v2_key(float s, int lane) {
  return __fadd_rn(
      __fmul_rn(floorf(__fmul_rn(__fadd_rn(s, 1.0625f), 8192.0f)), 512.0f),
      (float)lane);
}

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
