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

// The v3 (guarded) packed key of score s at lane (0..1023) of its 1024-lane
// subtile: floor((clip(s, -3, 3) + KEY_BIAS) * GUARD_QSCALE) * 1024 + lane
// (_guard_emit), every step rounded as written.
__device__ __forceinline__ float v3_key(float s, int lane) {
  const float c = fminf(fmaxf(s, -3.0f), 3.0f);
  return __fadd_rn(
      __fmul_rn(floorf(__fmul_rn(__fadd_rn(c, 1.0625f), 4096.0f)), 1024.0f),
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

// A signed int that orders like the float it encodes (a < b as floats iff
// order_key(a) < order_key(b)), with -0.0 and +0.0 one key, as == has
// them; NaN is not handled.  Lets a warp reduce floats with one
// __reduce_max_sync (redux.sync) instead of five shuffles.
constexpr int kNegInfKey = -2139095041;  // order_key(-INFINITY)

__device__ __forceinline__ int order_key(float v) {
  int b = __float_as_int(v);
  b = (b == -2147483647 - 1) ? 0 : b;  // -0.0 sorts as +0.0
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The float of an order_key (a zero comes back as +0.0).
__device__ __forceinline__ float order_key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// --- A per-warp ring of shared-memory stages fed by 1-D bulk copies (TMA).
// One mbarrier per stage, initialised for one arrival (lane 0's
// expect_tx); the copy's bytes complete the phase.  No tensor map: the
// source and the size must be 16-byte aligned.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One plain arrival on `bar` (a consumer releasing a stage).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// After the inits, before any copy or wait uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: expect `bytes` on `bar`, then copy them global -> shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Spin until the phase of `bar` with this parity has completed.  A phase
// that never completes (a fault in the ring's bookkeeping) traps after
// 2^30 polls, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Blocks of a persistent launch: as many as fit on the current device at
// once (the kernel's occupancy at `smem` dynamic bytes), and no more than
// `want`.  The first launch on a device raises the kernel's dynamic
// shared-memory limit and asks for its occupancy; `cache` (one per
// kernel) keeps the answer for the later ones.
struct FitCache {
  int dev = -1;
  long long fit = 0;
};

template <typename Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                                     long long want, FitCache* cache,
                                     unsigned* blocks) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (cache->dev != dev) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    if (rc == cudaSuccess) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem);
    }
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache->fit = (long long)sms * per_sm;
    cache->dev = dev;
  }
  *blocks = (unsigned)(want < cache->fit ? want : cache->fit);
  return cudaSuccess;
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
