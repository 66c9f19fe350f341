// Fused float scoring + per-subtile selection: the bf16/f32 prescore kernels
// of the retrieval ladder.
//
// Replaces (svs_tpu/ops/pallas_extract.py):
//   mode 3  _fused3_kernel (guarded v3, :1111; wrapper _fused3_extract :1216)
//   mode 2  _fused2_kernel (keyed v2,   :611;  wrapper _fused2_extract :657)
//   mode 1  _fused_kernel  (v1,         :270;  wrapper _fused_extract  :322)
// The TPU kernels accumulate an f32 dot of bf16 x bf16 or f32 x f32
// operands (HIGHEST precision for f32) and emit straight from that
// accumulator, with no rescale; the emits are the int8 kernels'.  The
// wrapper casts the queries to the docs' dtype first (round to nearest
// even), as the reference does.
//
// Mode 3 (fused3.cuh; the int8 mode 3's ring, tiles and chunked emit, see
// fused_int8.cu).  What bounds it on one H100 SXM (published peaks at
// 700 W: 3.35 TB/s, 989 bf16 TFLOP/s on the tensor cores, 67 f32 TFLOP/s
// on the CUDA cores), over the 1,015,808 x 1536 pack at B = 16 / 64 / 256:
// - bf16 reads 3.12 GB, 0.931 ms; its 2 * B * N * d FLOP take 0.05 / 0.20 /
//   0.81 ms on the tensor cores: bound by the read at every batch;
// - f32 reads 6.24 GB, 1.86 ms; its FLOP take 0.75 / 2.98 / 11.9 ms on the
//   CUDA cores: bound by the read at B = 16, by the FFMA rate from B = 32.
// Design:
// - bf16 on the tensor cores: wgmma m64nQTk16 bf16 x bf16 -> f32, docs as
//   A and queries as B, both K-major as stored, from the swizzled stages.
// - f32 stays true f32 on the CUDA cores (no TF32, no split-precision
//   emulation: the engine's 1e-4 term of prescore_eps assumes true f32
//   dots): each thread holds a register block of QT/8 queries x 8 docs and
//   reads both operands from the swizzled tiles as 16-byte words, 8 + QT/8
//   words (broadcast to the lanes that share them) per 32 * QT/8 fmaf, so
//   the FFMA pipe and not shared memory is the limit.  Each dot is one
//   fmaf chain in column order.
//
// The bf16 accumulation.  A bf16 x bf16 product is exact in f32.  fmaf
// rounds each add to nearest; the tensor cores, as measured on NVIDIA's
// earlier generations, align a k16 step's addends to the largest and
// truncate what falls off, so each of its 17 addends (the 16 products and
// the running sum) may lose up to one unit in the 24th bit of the largest,
// 2^-23 M.  So the kernel sums each 128-byte slice (64 of the d columns)
// from zero on the tensor cores, 4 k16 steps, and adds that partial to the
// f32 total with one round-to-nearest add.  Every addend in a slice s is at
// most |q_s| |d_s| (Cauchy-Schwarz over its columns), so the slice loses
// at most 68 * 2^-23 |q_s| |d_s|, and over the slices at most 68 * 2^-23
// |q| |d| (Cauchy-Schwarz over the slices): 8.1e-6 for unit rows (whose
// bf16 rounding keeps |q|, |d| <= 1 + 2^-8), plus d / 64 = 24 rounded adds
// of a total below 1, 24 * 2^-25 = 0.7e-6.  That is inside the 3e-5
// accumulation cushion of the engine's bf16 prescore_eps (engine/index.py,
// prescore_eps), and a true f32 dot has an error of the same order, so
// the bound holds against both.  On inputs whose partial sums are all
// exact f32 numbers (the smoke's lattice data) every order gives the same
// bits.
//
// Mode 2 at 9 <= B <= 256 runs on the same core as mode 3, bf16 on wgmma
// with the same slice-wise accumulation (so the same error bound), f32 on
// the FFMA register block; only the emit differs (see fused_int8.cu).
//
// Mode 1, and mode 2 at B <= 8, keep the first core (fused_emit.cuh): one
// block owns 1024 docs x QT = 8 (mode 1 past 8: 16) queries and stages
// 64-byte slices of its doc rows; each thread widens its 4 docs' 16-byte
// words to f32 and keeps a QT x 4 f32 accumulator, fmaf on the CUDA cores.

#include "fused3.cuh"
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

// Mode 3, or mode 2 past B = 8, on the core of fused3.cuh.
template <typename T, int MODE>
cudaError_t launch_core(const void* q, const void* docs, int b, int n, int d,
                        int n_valid, float* out, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    return svs::fused3::launch_f32<MODE>(static_cast<const float*>(q),
                                         static_cast<const float*>(docs), b, n,
                                         d, n_valid, out, st);
  } else {
    return svs::fused3::launch_mma<false, MODE>(q, nullptr, docs, nullptr, b,
                                                n, d, n_valid, out, st);
  }
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
                   : launch_core<T, 2>(q, docs, b, n, d, n_valid, out0, st);
    case 3:
      return launch_core<T, 3>(q, docs, b, n, d, n_valid, out0, st);
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
// 0 < b, 16-byte aligned q and docs.
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
