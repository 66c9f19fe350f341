// The benchmark probes' kernels (svs_tpu_torch/probes): the port of the
// Pallas probe bodies of benchmarks/tpu_int8_opt.py (P9), tpu_bf16_opt.py
// (P8) and tpu_select11.py (P7).  They build into a library of their own
// (svs_tpu_torch.probes.common.library), never into the production one.
//
// Every probe but the deferred emit is an instance of the production v3
// core (../fused3.cuh, fused3_mma_kernel) under a Variant: the same TMA
// ring, the same wgmma product, the same 1024-doc x QT-query blocks.  What a
// variant switches is the emit (the v3 keys with or without the clip, v3dq,
// or a floor with no keys), the docs of an output tile (kBlockN) and the
// k-span of one run of asynchronous wgmma (kGroup, the TPU's contraction
// chunk).  Each file instantiates a few of them, so that the nvcc runs of
// the library's build share the work.
#pragma once

#include "fused3.cuh"

namespace svs {
namespace probes {

using fused3::kEmitBlockMax;
using fused3::kEmitFirstSums;
using fused3::kEmitSelect;
using fused3::Variant;

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

}  // namespace probes
}  // namespace svs
