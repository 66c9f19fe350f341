// Fused float scoring + per-subtile selection: the bf16/f32 prescore kernels
// of the retrieval ladder, on the tiling and emits of the int8 kernels.
//
// Replaces (svs_tpu/ops/pallas_extract.py):
//   mode 3  _fused3_kernel (guarded v3, :1111; wrapper _fused3_extract :1216)
//   mode 2  _fused2_kernel (keyed v2,   :611;  wrapper _fused2_extract :657)
//   mode 1  _fused_kernel  (v1,         :270;  wrapper _fused_extract  :322)
// The TPU kernels accumulate an f32 dot of bf16 x bf16 or f32 x f32
// operands (HIGHEST precision for f32) and emit straight from that
// accumulator, with no rescale; the emits (fused_emit.cuh) are the int8
// kernels' own.  The wrapper casts the queries to the docs' dtype first
// (round to nearest even), as the reference does.
//
// The product is true f32 accumulation: every bf16 and f32 element is
// widened to f32 (exact) and multiplied-and-added with fmaf on the CUDA
// cores.  No TF32 and no tensor-core pass, so an f32 corpus keeps the f32
// error term of the engine's prescore bound (1e-4), and a bf16 product is
// exact before its rounded add.  The sum runs in another order than the
// reference's, so on random data a score may differ in its last ulp; on
// inputs whose partial sums are all exact f32 numbers the result is
// bit-identical whatever the order.
//
// What bounds it on an H100 (1M x 1536): the corpus read is 3.1 GB in bf16
// and 6.2 GB in f32 (0.93 / 1.86 ms at 3.35 TB/s); the product is
// 2 * B * 1M * 1536 FLOP, 3.1e10 at B = 8 and 2.0e11 at B = 64, against
// 67 TFLOP/s of f32 on the CUDA cores (3.0 ms at B = 64).  So B = 8 is
// bound by the read and B = 64 by the FFMA rate; bf16 on the tensor cores
// (mma.sync / wgmma) would lift the latter and is later work.
//
// Design: as fused_int8.cu.  One block owns 1024 docs x QT queries and
// stages 64-byte slices of its doc rows (16 f32 or 32 bf16 elements) in
// shared memory; the query slice is staged once per block as f32.  Each
// thread widens its 4 docs' 16-byte words to f32 and keeps a QT x 4 f32
// accumulator in registers.

#include "fused_emit.cuh"

namespace {

using namespace svs::fused;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord4 = 4;  // elements per 16 bytes
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static void unpack(const int4& w,
                                                float (&f)[kPerWord4]) {
    f[0] = __int_as_float(w.x);
    f[1] = __int_as_float(w.y);
    f[2] = __int_as_float(w.z);
    f[3] = __int_as_float(w.w);
  }
};

// bf16 travels as its 16 raw bits; widening to f32 is a 16-bit shift.
template <>
struct Elem<uint16_t> {
  static constexpr int kPerWord4 = 8;
  __device__ __forceinline__ static float to_float(uint16_t x) {
    return __uint_as_float((unsigned)x << 16);
  }
  __device__ __forceinline__ static void half_pair(int word, float& lo,
                                                   float& hi) {
    lo = __uint_as_float((unsigned)word << 16);  // element at the lower address
    hi = __uint_as_float((unsigned)word & 0xffff0000u);
  }
  __device__ __forceinline__ static void unpack(const int4& w,
                                                float (&f)[kPerWord4]) {
    half_pair(w.x, f[0], f[1]);
    half_pair(w.y, f[2], f[3]);
    half_pair(w.z, f[4], f[5]);
    half_pair(w.w, f[6], f[7]);
  }
};

template <typename T, int QT, int MODE>
__global__ void __launch_bounds__(kThreads)
    fused_float_kernel(const T* __restrict__ q, const T* __restrict__ docs,
                       int b, int d, int n_valid, int out_cols,
                       float* __restrict__ out0, float* __restrict__ out1) {
  constexpr int kE = Elem<T>::kPerWord4;
  constexpr int kChunkElems = kChunk / sizeof(T);  // 16 (f32) or 32 (bf16)
  extern __shared__ int4 smem[];
  int* sdocs = reinterpret_cast<int*>(smem);       // [kBlockDocs][kRowWords]
  float* sq = reinterpret_cast<float*>(sdocs + kBlockDocs * kRowWords);  // [QT][kChunkElems]
  float* sc = reinterpret_cast<float*>(smem);      // [QT][kBlockDocs], after the product

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int doc0 = blockIdx.y * kBlockDocs;

  float acc[QT][kDocsPerThread];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
#pragma unroll
    for (int m = 0; m < kDocsPerThread; ++m) acc[i][m] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kChunkElems) {
    stage_docs(reinterpret_cast<const char*>(docs), (size_t)d * sizeof(T),
               doc0, (size_t)k0 * sizeof(T), sdocs, tid);
    for (int i = tid; i < QT * kChunkElems; i += kThreads) {
      const int r = i / kChunkElems, c = i % kChunkElems;
      sq[i] = (q0 + r < b) ? Elem<T>::to_float(q[(size_t)(q0 + r) * d + k0 + c])
                           : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kChunkWords; w += 4) {
      float df[kDocsPerThread][kE];
#pragma unroll
      for (int m = 0; m < kDocsPerThread; ++m) {
        Elem<T>::unpack(*reinterpret_cast<const int4*>(
                            sdocs + (tid + m * kThreads) * kRowWords + w),
                        df[m]);
      }
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const float* qp = sq + i * kChunkElems + (w / 4) * kE;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float qv = qp[e];
#pragma unroll
          for (int m = 0; m < kDocsPerThread; ++m) {
            acc[i][m] = fmaf(qv, df[m][e], acc[i][m]);
          }
        }
      }
    }
    __syncthreads();
  }
  emit<QT, MODE>(acc, sc, tid, q0, doc0, b, n_valid, out_cols, out0, out1);
}

template <typename T, int QT, int MODE>
cudaError_t launch(const T* q, const T* docs, int b, int n, int d,
                   int n_valid, float* out0, float* out1,
                   cudaStream_t stream) {
  static_assert(QT * kBlockDocs * sizeof(float) <= kStageBytes,
                "score tile must fit the staging buffer it reuses");
  const size_t smem =
      kStageBytes + (size_t)QT * (kChunk / sizeof(T)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_float_kernel<T, QT, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, n / kBlockDocs);
  fused_float_kernel<T, QT, MODE><<<grid, kThreads, smem, stream>>>(
      q, docs, b, d, n_valid, out_columns(MODE, n), out0, out1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(int mode, const void* q, const void* docs, int b,
                        int n, int d, int n_valid, float* out0, float* out1,
                        cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* dt = static_cast<const T*>(docs);
  if (d % (kChunk / (int)sizeof(T)) != 0) return cudaErrorInvalidValue;
  const bool small = b <= 8;
  switch (mode) {
    case 1:
      return small ? launch<T, 8, 1>(qt, dt, b, n, d, n_valid, out0, out1, st)
                   : launch<T, 16, 1>(qt, dt, b, n, d, n_valid, out0, out1, st);
    case 2:
      return small ? launch<T, 8, 2>(qt, dt, b, n, d, n_valid, out0, out1, st)
                   : launch<T, 16, 2>(qt, dt, b, n, d, n_valid, out0, out1, st);
    case 3:
      return small ? launch<T, 8, 3>(qt, dt, b, n, d, n_valid, out0, out1, st)
                   : launch<T, 16, 3>(qt, dt, b, n, d, n_valid, out0, out1, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = f32, 1 = bf16 (raw bits); q and docs both in that dtype.
// mode 1 (v1): out0 = values, out1 = indices as f32, both [b, (n/512)*8].
// mode 2 (v2): out0 = keys [b, (n/512)*8]; out1 unused.
// mode 3 (v3): out0 = key tiles [b, (n/8192)*128], PRE-FILLED with
//              KEY_DEAD by the caller; out1 unused.
// Requires n % 8192 == 0, d a multiple of 64 bytes' worth of elements,
// 0 < b, 16-byte aligned docs.
extern "C" int svs_fused_float(int mode, int dtype, const void* q,
                               const void* docs, int b, int n, int d,
                               int n_valid, void* out0, void* out1,
                               void* stream) {
  if (b <= 0 || n <= 0 || n % kFusedBlockN != 0 || d <= 0 ||
      n / kBlockDocs > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_type<float>(mode, q, docs, b, n, d, n_valid, o0, o1,
                                     st);
    case 1:
      return (int)launch_type<uint16_t>(mode, q, docs, b, n, d, n_valid, o0,
                                        o1, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
