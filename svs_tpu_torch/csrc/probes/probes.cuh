// The benchmark probes' kernels (svs_tpu_torch/probes): the port of the
// Pallas probe bodies of benchmarks/tpu_int8_opt.py (P9), tpu_bf16_opt.py
// (P8), tpu_select11.py (P7), tpu_select10.py (P6), tpu_select9.py (P5)
// and tpu_select8.py (P4).  They build into a library of their own
// (svs_tpu_torch.probes.common.library), never into the production one.
//
// Every probe but the deferred emit is an instance of the production v3
// core (../fused3.cuh, fused3_mma_kernel) under a Variant: the same TMA
// ring, the same wgmma product, the same 1024-doc x QT-query blocks.  What a
// variant switches is the emit (v3dq, a floor with no keys, or the
// generalised keyed emit of KeyedVariant: subtile width, list length, key
// grid, clip, guard, padding, the "hier" fold; v3's keys among them),
// the docs of an output tile (kBlockN) and the k-span of one run of
// asynchronous wgmma (kGroup, the TPU's contraction chunk).  Each file
// instantiates a few of them, so that the nvcc runs of the library's build
// share the work.
#pragma once

#include "fused3.cuh"

namespace svs {
namespace probes {

using fused3::kEmitBlockMax;
using fused3::kEmitFirstSums;
using fused3::kEmitSelect;
using fused3::Variant;

// The v3 emit as a keyed one: the top 4 keys per 1024-doc subtile at 2^12,
// the guard after the block's keys; without the clip (P9, P8) or with it
// (P7's same-step kernel, as production).
template <bool CLIP, int BLOCK_N, int GROUP>
using V3Keys = fused3::KeyedVariant<1024, 4, 12, CLIP, true, 0, false, BLOCK_N, GROUP>;

// The stages of one wgmma run for a contraction chunk of `chunk` elements
// of `elem` bytes (128-byte stages).
inline int chunk_group(int chunk, int elem) {
  return chunk * elem / fused3::kSliceBytes;
}

// A variant on the production kernels' query tile for b: 16, 32 or 64
// rows (fused3::query_tile), so every probe runs the tiles of the kernel it
// is compared with.
template <bool kInt8, class V>
cudaError_t launch_tile(const void* q, const float* qs, const void* docs,
                        const float* rs, int b, int n, int d, int n_valid,
                        float* out, cudaStream_t st) {
  switch (fused3::query_tile(b)) {
    case 16:
      return fused3::launch_mma_tile<kInt8, 16, 3, V>(
          q, qs, docs, rs, b, n, d, n_valid, out, nullptr, st);
    case 32:
      return fused3::launch_mma_tile<kInt8, 32, 3, V>(
          q, qs, docs, rs, b, n, d, n_valid, out, nullptr, st);
    default:
      return fused3::launch_mma_tile<kInt8, 64, 3, V>(
          q, qs, docs, rs, b, n, d, n_valid, out, nullptr, st);
  }
}

// The entry points of the instance files (variant: 0 = mm, 1 = v3, 2 =
// v3dq).  int8_opt.cu and bf16_opt.cu are each compiled once per
// instance, the parameter given as a -D flag (PROBE_GROUP, PROBE_BLOCK_N:
// svs_tpu_torch.probes.common.DEFINES), so that the nvcc runs of the
// library's build share the work; each unit defines one instance.
// int8: GROUP 1 = contraction chunk 128, 2 = chunk 256.
template <int GROUP>
cudaError_t int8_opt(int variant, const void* q, const float* qs,
                     const void* docs, const float* rs, int b, int n, int d,
                     int n_valid, float* out, cudaStream_t st);
// bf16 at an output block of BLOCK_N docs, chunk 128 or 256 columns.
template <int BLOCK_N>
cudaError_t bf16_opt(int variant, int chunk, const void* q, const void* docs,
                     int b, int n, int d, int n_valid, float* out,
                     cudaStream_t st);
cudaError_t select11_same_step(const void* q, const void* docs, int b, int n,
                               int d, int n_valid, float* out,
                               cudaStream_t st);
cudaError_t select11_floor(int block_n, const void* q, const void* docs, int b,
                           int n, int d, float* out, cudaStream_t st);
cudaError_t select11_deferred(const void* q, const void* docs, int b, int n,
                              int d, int n_valid, float* out, cudaStream_t st);
// The keyed emits (KeyedVariant), bf16 at the scripts' contraction chunk of
// 128 columns (2 stages a wgmma run) and 8192-doc blocks.  P5's v2 (top-8
// per 512 docs at 2^13, no guard), which is also P4's "current":
cudaError_t select9_v2(const void* q, const void* docs, int b, int n, int d,
                       int n_valid, float* out, cudaStream_t st);
// P4's other keyed emits: 1 = hier, 2 = h6g128, 3 = h8g256, 4 = h8g1024.
cudaError_t select8_emit(int emit, const void* q, const void* docs, int b,
                         int n, int d, int n_valid, float* out,
                         cudaStream_t st);
// P6's guarded prototypes: top-h (2 or 3) per 512 docs at 2^13, the score
// clipped, the guard after the block's keys.
cudaError_t select10_guarded(int h, const void* q, const void* docs, int b,
                             int n, int d, int n_valid, float* out,
                             cudaStream_t st);

}  // namespace probes
}  // namespace svs
