// Fused int8 scoring + per-subtile selection: the three int8 prescore
// kernels of the retrieval main path, as one matmul core with three emits.
//
// Replaces (svs_tpu/ops/pallas_extract.py):
//   mode 3  _fused3_int8_kernel (guarded v3):  top-4 keys per 1024-doc
//           subtile + one guard lane per 8192-doc block  (wrapper :1245)
//   mode 2  _fused2_int8_kernel (keyed v2):    top-8 keys per 512-doc
//           subtile                                       (wrapper :733)
//   mode 1  _fused_int8_kernel (v1):           top-8 values + f32 indices
//           per 512-doc subtile, ties to the highest index (wrapper :449)
// Outputs use the TPU kernels' exact layouts, so the plain-torch finishes
// in svs_tpu_torch/ops/pallas_extract.py consume them unchanged.
//
// What bounds it on an H100: at B = 256 over 1M x 1536 the product is
// ~0.8 T int8 ops against a 1.56 GB corpus read (about 500 ops per byte),
// so large batches are compute-bound and small ones (B = 8: ~16 ops per
// byte) are bound by the corpus read.  This first version multiplies with
// __dp4a on the CUDA cores (exact int32 sums, so every order gives the
// same bits); the tensor cores (mma/wgmma on s8) and TMA are later work.
//
// Design.  The TPU kernel holds a [B, 8192] accumulator in VMEM over a
// sequential grid of dim chunks.  Here one CUDA block owns 1024 docs (one
// v3 subtile, two v1/v2 subtiles) x QT queries; the dim loop runs inside
// the block, staging 64-byte slices of the 1024 doc rows in shared memory
// (80-byte padded rows: conflict-free 16-byte reads).  Each thread keeps a
// QT x 4 int32 accumulator in registers.  The emit writes scores or keys
// to shared memory (reusing the staging buffer) and each warp extracts
// one (query, subtile) pair by iterated warp-wide max-and-clear.  Query
// tiles vary fastest over the grid, so blocks reading the same docs run
// together and share them through L2.  v3's guard lane is a max over the
// 8 subtiles of a block that live in different CUDA blocks: the wrapper
// pre-fills the output with KEY_DEAD and each subtile folds its tail in
// with an atomic float max (order-independent, so deterministic).
//
// Key arithmetic is bit-identical to the reference: every product and sum
// is written as __fmul_rn/__fadd_rn in the reference's order, because
// nvcc would otherwise fuse (acc * rs * qs) + KEY_BIAS into one FMA and
// move keys that sit on a grid edge.

#include "svs_common.cuh"

#include <math.h>

namespace {

constexpr int kBlockDocs = 1024;   // docs per CUDA block
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

template <int QT, int MODE>
__global__ void __launch_bounds__(kThreads)
    fused_int8_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ qs,
                      const int8_t* __restrict__ docs,
                      const float* __restrict__ rs, int b, int d,
                      int n_valid, int out_cols, float* __restrict__ out0,
                      float* __restrict__ out1) {
  extern __shared__ int4 smem[];
  int* sdocs = reinterpret_cast<int*>(smem);       // [kBlockDocs][kRowWords]
  int* sq = sdocs + kBlockDocs * kRowWords;        // [QT][kChunkWords]
  float* sc = reinterpret_cast<float*>(smem);      // [QT][kBlockDocs], after the product

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int doc0 = blockIdx.y * kBlockDocs;

  int acc[QT][kDocsPerThread];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
#pragma unroll
    for (int m = 0; m < kDocsPerThread; ++m) acc[i][m] = 0;
  }

  for (int k0 = 0; k0 < d; k0 += kChunk) {
#pragma unroll
    for (int it = 0; it < kBlockDocs * (kChunk / 16) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int row = i >> 2, part = i & 3;
      const int4 v = __ldg(
          reinterpret_cast<const int4*>(docs + (size_t)(doc0 + row) * d + k0) +
          part);
      reinterpret_cast<int4*>(sdocs + row * kRowWords)[part] = v;
    }
    if (tid < QT * (kChunk / 16)) {
      const int row = tid >> 2, part = tid & 3;
      int4 v = make_int4(0, 0, 0, 0);
      if (q0 + row < b) {
        v = __ldg(
            reinterpret_cast<const int4*>(q + (size_t)(q0 + row) * d + k0) +
            part);
      }
      reinterpret_cast<int4*>(sq + row * kChunkWords)[part] = v;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kChunkWords; w += 4) {
      int4 dv[kDocsPerThread];
#pragma unroll
      for (int m = 0; m < kDocsPerThread; ++m) {
        dv[m] = *reinterpret_cast<const int4*>(
            sdocs + (tid + m * kThreads) * kRowWords + w);
      }
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const int4 qv = *reinterpret_cast<const int4*>(sq + i * kChunkWords + w);
#pragma unroll
        for (int m = 0; m < kDocsPerThread; ++m) {
          acc[i][m] = __dp4a(qv.x, dv[m].x, acc[i][m]);
          acc[i][m] = __dp4a(qv.y, dv[m].y, acc[i][m]);
          acc[i][m] = __dp4a(qv.z, dv[m].z, acc[i][m]);
          acc[i][m] = __dp4a(qv.w, dv[m].w, acc[i][m]);
        }
      }
    }
    __syncthreads();
  }

  // Emit, part 1: rescale and key every score into shared memory.
#pragma unroll
  for (int m = 0; m < kDocsPerThread; ++m) {
    const int local = tid + m * kThreads;
    const int row = doc0 + local;
    const float r = rs[row];
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float qscale = (q0 + i < b) ? qs[q0 + i] : 0.0f;
      // acc.astype(f32) * rs * qs, each product rounded on its own
      const float s =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[i][m]), r), qscale);
      float v;
      if (MODE == 1) {
        v = row < n_valid ? s : -INFINITY;
      } else if (MODE == 2) {
        // floor((s + KEY_BIAS) * KEY_QSCALE) * 512 + lane   (_emit_keys)
        const int lane = local & 511;
        const int live = min(max(n_valid - (row - lane), 0), 512);
        const float key = __fadd_rn(
            __fmul_rn(floorf(__fmul_rn(__fadd_rn(s, 1.0625f), 8192.0f)),
                      512.0f),
            (float)lane);
        v = lane < live ? key : svs::kKeyDead;
      } else {
        // floor((clip(s, -3, 3) + KEY_BIAS) * GUARD_QSCALE) * 1024 + lane
        const int lane = local;
        const int live = min(max(n_valid - doc0, 0), 1024);
        const float c = fminf(fmaxf(s, -3.0f), 3.0f);
        const float key = __fadd_rn(
            __fmul_rn(floorf(__fmul_rn(__fadd_rn(c, 1.0625f), 4096.0f)),
                      1024.0f),
            (float)lane);
        v = lane < live ? key : svs::kKeyDead;
      }
      sc[i * kBlockDocs + local] = v;
    }
  }
  __syncthreads();

  // Emit, part 2: one warp per (query, subtile), H rounds of max-and-clear.
  constexpr int kSub = Emit<MODE>::kSub;
  constexpr int kH = Emit<MODE>::kH;
  constexpr int kE = kSub / 32;
  constexpr int kNSub = kBlockDocs / kSub;
  const int warp = tid >> 5, lane = tid & 31;
  for (int p = warp; p < QT * kNSub; p += kWarps) {
    const int i = p / kNSub, s = p % kNSub;
    const int qrow = q0 + i;
    if (qrow >= b) continue;  // warp-uniform
    const float* src = sc + i * kBlockDocs + s * kSub;
    const int sub_row0 = doc0 + s * kSub;
    float v[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = src[lane + 32 * e];
    if (MODE == 1) {
      const size_t col0 = (size_t)qrow * out_cols + (size_t)(sub_row0 / kSub) * kH;
      for (int h = 0; h < kH; ++h) {
        float mv = v[0];
#pragma unroll
        for (int e = 1; e < kE; ++e) mv = fmaxf(mv, v[e]);
        mv = svs::warp_max(mv);
        // index of (one of) the max elements: the highest position wins
        int mi = -1;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (v[e] == mv) mi = max(mi, sub_row0 + lane + 32 * e);
        }
        mi = svs::warp_max_int(mi);
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
      float mv = svs::kKeyDead;
      for (int h = 0; h < kH; ++h) {
        mv = v[0];
#pragma unroll
        for (int e = 1; e < kE; ++e) mv = fmaxf(mv, v[e]);
        mv = svs::warp_max(mv);
        if (lane == 0) out0[col0 + h] = mv;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (v[e] == mv) v[e] = svs::kKeyDead;
        }
      }
      if (MODE == 3 && lane == 0) {
        // guard lane: running max of the subtile tails of this 8192 block
        svs::atomic_max_float(
            out0 + (size_t)qrow * out_cols +
                (size_t)(doc0 / kFusedBlockN) * kGuardOutLanes + kGuardKeys,
            mv);
      }
    }
  }
}

template <int QT, int MODE>
cudaError_t launch(const int8_t* q, const float* qs, const int8_t* docs,
                   const float* rs, int b, int n, int d, int n_valid,
                   int out_cols, float* out0, float* out1,
                   cudaStream_t stream) {
  static_assert(QT * kBlockDocs <= kBlockDocs * kRowWords,
                "score tile must fit the staging buffer it reuses");
  const size_t smem =
      (size_t)kBlockDocs * kRowWords * sizeof(int) + (size_t)QT * kChunk;
  cudaError_t err = cudaFuncSetAttribute(
      fused_int8_kernel<QT, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, n / kBlockDocs);
  fused_int8_kernel<QT, MODE><<<grid, kThreads, smem, stream>>>(
      q, qs, docs, rs, b, d, n_valid, out_cols, out0, out1);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const int8_t* q, const float* qs, const int8_t* docs,
                        const float* rs, int b, int n, int d, int n_valid,
                        int out_cols, float* out0, float* out1,
                        cudaStream_t stream) {
  if (b <= 8) {
    return launch<8, MODE>(q, qs, docs, rs, b, n, d, n_valid, out_cols, out0,
                           out1, stream);
  }
  return launch<16, MODE>(q, qs, docs, rs, b, n, d, n_valid, out_cols, out0,
                          out1, stream);
}

}  // namespace

// mode 1 (v1): out0 = values, out1 = indices as f32, both [b, (n/512)*8].
// mode 2 (v2): out0 = keys [b, (n/512)*8]; out1 unused.
// mode 3 (v3): out0 = key tiles [b, (n/8192)*128], PRE-FILLED with
//              KEY_DEAD by the caller; out1 unused.
// Requires n % 8192 == 0, d % 64 == 0, 0 < b, 16-byte aligned q/docs.
extern "C" int svs_fused_int8(int mode, const void* q, const void* qs,
                              const void* docs, const void* rs, int b, int n,
                              int d, int n_valid, void* out0, void* out1,
                              void* stream) {
  if (b <= 0 || n <= 0 || n % kFusedBlockN != 0 || d <= 0 || d % kChunk != 0 ||
      n / kBlockDocs > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int8_t* q8 = static_cast<const int8_t*>(q);
  const float* qsf = static_cast<const float*>(qs);
  const int8_t* d8 = static_cast<const int8_t*>(docs);
  const float* rsf = static_cast<const float*>(rs);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 1:
      return (int)launch_mode<1>(q8, qsf, d8, rsf, b, n, d, n_valid,
                                 (n / 512) * 8, o0, o1, st);
    case 2:
      return (int)launch_mode<2>(q8, qsf, d8, rsf, b, n, d, n_valid,
                                 (n / 512) * 8, o0, o1, st);
    case 3:
      return (int)launch_mode<3>(q8, qsf, d8, rsf, b, n, d, n_valid,
                                 (n / kFusedBlockN) * kGuardOutLanes, o0, o1,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
