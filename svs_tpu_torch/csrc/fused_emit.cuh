// The shared tiling and emit of the fused scoring kernels (fused_int8.cu,
// fused_float.cu): one CUDA block owns 1024 docs x QT queries, stages
// 64-byte slices of its doc rows in shared memory, and ends with one of
// three emits over the f32 scores its threads hold in registers:
//
//   mode 1  v1  (_fused_kernel / _fused_int8_kernel):   top-8 values + f32
//               indices per 512-doc subtile, ties to the highest index
//   mode 2  v2  (_fused2_kernel / _fused2_int8_kernel): top-8 packed keys
//               floor((s + KEY_BIAS) * KEY_QSCALE) * 512 + lane (_emit_keys)
//   mode 3  v3  (_fused3_kernel / _fused3_int8_kernel): top-4 packed keys
//               floor((clip(s,-3,3) + KEY_BIAS) * GUARD_QSCALE) * 1024 +
//               lane per 1024-doc subtile, plus one guard lane per
//               8192-doc block (_guard_emit)
//
// Outputs use the TPU kernels' exact layouts (svs_tpu/ops/pallas_extract.py),
// so the plain-torch finishes consume them unchanged.  Every step of the key
// arithmetic is written as __fmul_rn/__fadd_rn/floorf in the reference's
// order, so nvcc contracts nothing and a key on a grid edge never moves.
#pragma once

#include "svs_common.cuh"

#include <math.h>

namespace svs {
namespace fused {

constexpr int kBlockDocs = 1024;  // docs per CUDA block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDocsPerThread = kBlockDocs / kThreads;  // 4
constexpr int kChunk = 64;                  // row bytes per shared-memory stage
constexpr int kChunkWords = kChunk / 4;     // 16
constexpr int kRowWords = kChunkWords + 4;  // 20 words = 80-byte padded rows
constexpr int kFusedBlockN = 8192;          // FUSED_BLOCK_N
constexpr int kGuardOutLanes = 128;         // _GUARD_OUT_LANES
constexpr int kGuardKeys = 32;              // GUARD_KEYS

template <int MODE>
struct Emit;
template <>
struct Emit<1> {  // v1: FUSED_SUBTILE x EXTRACT_H
  static constexpr int kSub = 512, kH = 8;
};
template <>
struct Emit<2> {  // v2: FUSED_SUBTILE x EXTRACT_H
  static constexpr int kSub = 512, kH = 8;
};
template <>
struct Emit<3> {  // v3: GUARD_SUBTILE x GUARD_H
  static constexpr int kSub = 1024, kH = 4;
};

// Output columns per query row of each mode, for n docs.
__host__ __device__ constexpr int out_columns(int mode, int n) {
  return mode == 3 ? (n / kFusedBlockN) * kGuardOutLanes : (n / 512) * 8;
}

// Bytes of the doc-row staging buffer (the emit reuses it for the scores).
constexpr size_t kStageBytes = (size_t)kBlockDocs * kRowWords * sizeof(int);

// Stage the 64-byte slice at byte offset byte0 of each of the block's 1024
// doc rows (row_bytes apart in device memory) into sdocs: 4 threads per
// row, 16 bytes each, so a warp reads 8 rows' slices in full.  The 80-byte
// padded rows make the emit-side 16-byte reads of one row per thread
// conflict-free.
__device__ __forceinline__ void stage_docs(const char* __restrict__ docs,
                                           size_t row_bytes, int doc0,
                                           size_t byte0, int* sdocs,
                                           int tid) {
#pragma unroll
  for (int it = 0; it < kBlockDocs * (kChunk / 16) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int row = i >> 2, part = i & 3;
    const int4 v = __ldg(reinterpret_cast<const int4*>(
                             docs + (size_t)(doc0 + row) * row_bytes + byte0) +
                         part);
    reinterpret_cast<int4*>(sdocs + row * kRowWords)[part] = v;
  }
}

// The emit.  s[i][m] is the f32 score of query q0 + i and doc
// doc0 + tid + m * kThreads.  sc is shared memory of QT * 1024 floats that
// no thread reads any more (the caller synchronised after its product).
template <int QT, int MODE>
__device__ __forceinline__ void emit(const float (&s)[QT][kDocsPerThread],
                                     float* sc, int tid, int q0, int doc0,
                                     int b, int n_valid, int out_cols,
                                     float* __restrict__ out0,
                                     float* __restrict__ out1) {
  // Part 1: key every score (or mask it, v1) into shared memory.
#pragma unroll
  for (int m = 0; m < kDocsPerThread; ++m) {
    const int local = tid + m * kThreads;
    const int row = doc0 + local;
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      float v;
      if (MODE == 1) {
        // gidx < nv, both exact in f32 below 2^24 (fused_supported)
        v = row < n_valid ? s[i][m] : -INFINITY;
      } else if (MODE == 2) {
        // floor((s + KEY_BIAS) * KEY_QSCALE) * 512 + lane   (_emit_keys)
        const int lane = local & 511;
        const int live = min(max(n_valid - (row - lane), 0), 512);
        v = lane < live ? v2_key(s[i][m], lane) : kKeyDead;
      } else {
        // floor((clip(s, -3, 3) + KEY_BIAS) * GUARD_QSCALE) * 1024 + lane
        const int lane = local;
        const int live = min(max(n_valid - doc0, 0), 1024);
        const float c = fminf(fmaxf(s[i][m], -3.0f), 3.0f);
        const float key = __fadd_rn(
            __fmul_rn(floorf(__fmul_rn(__fadd_rn(c, 1.0625f), 4096.0f)),
                      1024.0f),
            (float)lane);
        v = lane < live ? key : kKeyDead;
      }
      sc[i * kBlockDocs + local] = v;
    }
  }
  __syncthreads();

  // Part 2: one warp per (query, subtile), H rounds of max-and-clear.
  constexpr int kSub = Emit<MODE>::kSub;
  constexpr int kH = Emit<MODE>::kH;
  constexpr int kE = kSub / 32;
  constexpr int kNSub = kBlockDocs / kSub;
  const int warp = tid >> 5, lane = tid & 31;
  for (int p = warp; p < QT * kNSub; p += kWarps) {
    const int i = p / kNSub, sub = p % kNSub;
    const int qrow = q0 + i;
    if (qrow >= b) continue;  // warp-uniform
    const float* src = sc + i * kBlockDocs + sub * kSub;
    const int sub_row0 = doc0 + sub * kSub;
    float v[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = src[lane + 32 * e];
    if (MODE == 1) {
      const size_t col0 =
          (size_t)qrow * out_cols + (size_t)(sub_row0 / kSub) * kH;
      for (int h = 0; h < kH; ++h) {
        float mv = v[0];
#pragma unroll
        for (int e = 1; e < kE; ++e) mv = fmaxf(mv, v[e]);
        mv = warp_max(mv);
        // index of (one of) the max elements: the highest position wins
        int mi = -1;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (v[e] == mv) mi = max(mi, sub_row0 + lane + 32 * e);
        }
        mi = warp_max_int(mi);
        if (lane == 0) {
          out0[col0 + h] = mv;
          out1[col0 + h] = (float)mi;
        }
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (sub_row0 + lane + 32 * e == mi) v[e] = -INFINITY;
        }
      }
    } else {
      size_t col0;
      if (MODE == 2) {
        col0 = (size_t)qrow * out_cols + (size_t)(sub_row0 / kSub) * kH;
      } else {
        col0 = (size_t)qrow * out_cols +
               (size_t)(doc0 / kFusedBlockN) * kGuardOutLanes +
               (size_t)((doc0 % kFusedBlockN) / kSub) * kH;
      }
      float mv = kKeyDead;
      for (int h = 0; h < kH; ++h) {
        mv = v[0];
#pragma unroll
        for (int e = 1; e < kE; ++e) mv = fmaxf(mv, v[e]);
        mv = warp_max(mv);
        if (lane == 0) out0[col0 + h] = mv;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (v[e] == mv) v[e] = kKeyDead;
        }
      }
      if (MODE == 3 && lane == 0) {
        // guard lane: running max of the subtile tails of this 8192 block;
        // the wrapper pre-fills the output with KEY_DEAD
        atomic_max_float(out0 + (size_t)qrow * out_cols +
                             (size_t)(doc0 / kFusedBlockN) * kGuardOutLanes +
                             kGuardKeys,
                         mv);
      }
    }
  }
}

}  // namespace fused
}  // namespace svs
