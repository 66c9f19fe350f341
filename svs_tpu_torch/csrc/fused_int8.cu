// Fused int8 scoring + per-subtile selection: the three int8 prescore
// kernels of the retrieval main path.
//
// Replaces (svs_tpu/ops/pallas_extract.py):
//   mode 3  _fused3_int8_kernel (guarded v3, :1160; wrapper :1245): top-4
//           keys per 1024-doc subtile + one guard lane per 8192-doc block.
//           The engine's rung for 16 <= B <= 256 when C <= 1024.
//   mode 2  _fused2_int8_kernel (keyed v2, :685; wrapper :746): top-8 keys
//           per 512-doc subtile.  The engine's rung when v3 does not take
//           the batch (B < 16, or C past GUARD_MAX_C after a widen).
//   mode 1  _fused_int8_kernel (v1, :399):  top-8 values + f32 indices per
//           512-doc subtile, ties to the highest index
//
// Mode 3 (fused3.cuh).  What bounds it on one H100 SXM (published peaks at
// 700 W: 3.35 TB/s, 1,979 int8 TOP/s dense): over the 1,015,808 x 1536
// pack it reads 1.56 GB, 0.467 ms; the product is 2 * B * N * d ops,
// 0.05 / 0.20 / 0.80 T at B = 16 / 64 / 256, 0.03 / 0.10 / 0.40 ms.  So
// the corpus read bounds it at every batch v3 takes.  Design:
// - the tensor cores: wgmma m64nQTk32 s8 x s8 -> s32, four warpgroups of
//   one m64 tile of docs each and the query tile as N, both operands
//   K-major as they lie in memory, read by the tensor cores straight from
//   the 128-byte-swizzled stages through shared-memory descriptors.  The
//   int32 sum is exact in any order, so the kernel is bit-identical to its
//   plain version;
// - a query tile of up to 64 (16 / 32 / 64 by batch): at B <= 64 each doc
//   is read from memory once per batch; past 64 the query tiles run
//   fastest over the grid, so the tiles of one doc block run together and
//   share its read through the 50 MB L2;
// - a 3-stage ring of 128-byte column slices (256 doc rows + the query
//   tile, 40 KB at QT = 64) filled by 2-D TMA tile loads from a producer
//   warp, so loads stay in flight while 16 consumer warps multiply and
//   emit (16, not 8: the emit between chunks, not the tensor cores, is
//   what holds a block back at B = 256);
// - each block walks its 1024-doc subtile in 4 chunks of 256 docs (64
//   queries x 1024 docs of accumulators would be every register of the
//   SM) and merges the per-chunk top-4 (fused_emit.cuh: why that is exact).
// The emit rescales each sum as acc * rs * qs, two separately rounded
// products as the reference writes them (__fmul_rn: nvcc would otherwise
// fuse one with the key's + KEY_BIAS into an FMA and move keys that sit on
// a grid edge).  The guard lane is a max over the 8 subtiles of a block,
// which live in different CUDA blocks: the wrapper pre-fills the output
// with KEY_DEAD and each subtile folds its tail in with an atomic float max
// (order-independent, so deterministic).
//
// Mode 2 at 9 <= B <= 256 runs on the same core and bound as mode 3 (the
// product and the read are the same; only the emit differs): 4 chunks of
// 256 docs per block, and per 512-doc subtile the top-8 distinct v2 keys
// merged over its 2 chunks (select_chunk, H = 8, no guard lane).  Its
// emit does more selection than v3's, 8 rounds on a subtile's first chunk
// where v3 does 4 on its first of four, and the rescale is the same two
// rounded products.
//
// Mode 1, and mode 2 at B <= 8, keep the first core (fused_emit.cuh): one
// block owns 1024 docs x QT = 8 (mode 1 past 8: 16) queries, stages
// 64-byte slices of its doc rows in shared memory and multiplies with
// __dp4a on the CUDA cores.  At B <= 8 it reads the pack once, at 59% of
// the byte bound.

#include "fused3.cuh"
#include "fused_emit.cuh"

namespace {

using namespace svs::fused;

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
    stage_docs(reinterpret_cast<const char*>(docs), (size_t)d, doc0,
               (size_t)k0, sdocs, tid);
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

  // acc.astype(f32) * rs * qs, each product rounded on its own
  float s[QT][kDocsPerThread];
#pragma unroll
  for (int m = 0; m < kDocsPerThread; ++m) {
    const float r = rs[doc0 + tid + m * kThreads];
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float qscale = (q0 + i < b) ? qs[q0 + i] : 0.0f;
      s[i][m] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][m]), r), qscale);
    }
  }
  emit<QT, MODE>(s, sc, tid, q0, doc0, b, n_valid, out_cols, out0, out1);
}

template <int QT, int MODE>
cudaError_t launch(const int8_t* q, const float* qs, const int8_t* docs,
                   const float* rs, int b, int n, int d, int n_valid,
                   float* out0, float* out1, cudaStream_t stream) {
  static_assert(QT * kBlockDocs * sizeof(float) <= kStageBytes,
                "score tile must fit the staging buffer it reuses");
  const size_t smem = kStageBytes + (size_t)QT * kChunk;
  cudaError_t err = cudaFuncSetAttribute(
      fused_int8_kernel<QT, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, n / kBlockDocs);
  fused_int8_kernel<QT, MODE><<<grid, kThreads, smem, stream>>>(
      q, qs, docs, rs, b, d, n_valid, out_columns(MODE, n), out0, out1);
  return cudaGetLastError();
}

cudaError_t launch_v1(const int8_t* q, const float* qs, const int8_t* docs,
                      const float* rs, int b, int n, int d, int n_valid,
                      float* out0, float* out1, cudaStream_t stream) {
  if (b <= 8) {
    return launch<8, 1>(q, qs, docs, rs, b, n, d, n_valid, out0, out1, stream);
  }
  return launch<16, 1>(q, qs, docs, rs, b, n, d, n_valid, out0, out1, stream);
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
      return (int)launch_v1(q8, qsf, d8, rsf, b, n, d, n_valid, o0, o1, st);
    case 2:
      if (b <= 8) {
        return (int)launch<8, 2>(q8, qsf, d8, rsf, b, n, d, n_valid, o0, o1,
                                 st);
      }
      return (int)svs::fused3::launch_mma<true, 2>(q8, qsf, d8, rsf, b, n, d,
                                                   n_valid, o0, st);
    case 3:
      return (int)svs::fused3::launch_mma<true, 3>(q8, qsf, d8, rsf, b, n, d,
                                                   n_valid, o0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
