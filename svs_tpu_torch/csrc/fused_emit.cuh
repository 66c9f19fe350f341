// The emits of the fused scoring kernels (fused_int8.cu, fused_float.cu).
//
// The first core (modes 1 and 2 for B <= 8): one CUDA block owns 1024 docs
// x QT = 8 queries, stages 64-byte slices of its doc rows in shared memory,
// and ends with emit() over the f32 scores its threads hold:
//
//   mode 1  v1  (_fused_kernel / _fused_int8_kernel):   top-8 values + f32
//               indices per 512-doc subtile, ties to the highest index
//               (also the v1 rung for 9 <= B <= 256, QT = 16)
//   mode 2  v2  (_fused2_kernel / _fused2_int8_kernel): top-8 packed keys
//               floor((s + KEY_BIAS) * KEY_QSCALE) * 512 + lane (_emit_keys)
//
// The core of fused3.cuh (mode 3 at every batch, mode 2 for 9 <= B <= 256)
// ends with select_chunk() below.  Mode 3, v3 (_fused3_kernel /
// _fused3_int8_kernel, _guard_emit): per 1024-doc subtile the top-4 packed
// keys floor((clip(s,-3,3) + KEY_BIAS) * GUARD_QSCALE) * 1024 + lane, and
// per 8192-doc block one guard lane, the max of its 8 subtile tails.  Mode
// 2, v2: per 512-doc subtile the top-8 v2 keys, no guard.  A block of that
// core walks its 1024 docs in 4 chunks of 256 (64 queries x 1024 docs of
// f32 accumulators would be all of an SM's registers), so the top-H of a
// subtile (H = 4 over 4 chunks, or H = 8 over 2) is merged chunk by chunk.
// That is exact for any H: the reference's H rounds of
// max-then-clear-every-equal emit the H largest DISTINCT keys of the
// subtile (then KEY_DEAD, the floor of every key, once they run out), and
// the H largest distinct values of a union are the H largest distinct
// values of the union of its parts' top-H lists.  Keys collide only past
// 2^24 (v3: clipped raw-op scores above ~2.94; v2: scores above ~2.94,
// unclipped), where key + lane rounds to even; the merge keeps one copy of
// each value, as clear-every-equal does.  (It takes every live key to be
// above KEY_DEAD, as every score above -5.06 keys: a v2 subtile whose
// live keys all lay below it would emit one of them in the reference and
// KEY_DEAD here.  Unit rows score within [-1, 1].)
//
// Outputs use the TPU kernels' exact layouts (svs_tpu/ops/pallas_extract.py),
// so the plain-torch finishes consume them unchanged.  Every step of the key
// arithmetic is written as __fmul_rn/__fadd_rn/floorf in the reference's
// order (svs::v2_key, svs::v3_key), so nvcc contracts nothing and a key on
// a grid edge never moves.
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
      } else {
        // floor((s + KEY_BIAS) * KEY_QSCALE) * 512 + lane   (_emit_keys)
        const int lane = local & 511;
        const int live = min(max(n_valid - (row - lane), 0), 512);
        v = lane < live ? v2_key(s[i][m], lane) : kKeyDead;
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
      const size_t col0 =
          (size_t)qrow * out_cols + (size_t)(sub_row0 / kSub) * kH;
      for (int h = 0; h < kH; ++h) {
        float mv = v[0];
#pragma unroll
        for (int e = 1; e < kE; ++e) mv = fmaxf(mv, v[e]);
        mv = warp_max(mv);
        if (lane == 0) out0[col0 + h] = mv;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (v[e] == mv) v[e] = kKeyDead;
        }
      }
    }
  }
}

// --- the chunked emit of fused3.cuh (v3, and v2 for B > 8) ------------------

constexpr int kV3H = 4;           // GUARD_H
constexpr int kV3SubDocs = 1024;  // GUARD_SUBTILE
constexpr int kV2H = 8;           // EXTRACT_H
constexpr int kV2SubDocs = 512;   // FUSED_SUBTILE

// The warp-wide max of one float per lane, through the order-preserving
// int (one redux.sync).
__device__ __forceinline__ float warp_max_redux(float v) {
  return order_key_value(__reduce_max_sync(0xffffffffu, order_key(v)));
}

// Drop the head of a descending list of H keys.
template <int H>
__device__ __forceinline__ void pop_head(float (&l)[H]) {
#pragma unroll
  for (int h = 0; h + 1 < H; ++h) l[h] = l[h + 1];
  l[H - 1] = kKeyDead;
}

// One warp, one query row: the top-H distinct keys of a chunk of kDocs keys
// (sc, contiguous), merged with the running top-H of the subtile's earlier
// chunks (run, shared memory; not read for the first chunk).  The last
// chunk of the subtile writes its H keys to out (16-byte aligned) and,
// with kGuard (v3), folds its tail into the block's guard lane with an
// atomic max (order-independent, so deterministic; the wrapper pre-fills
// the output with KEY_DEAD); the others leave the merged list in run.
//
// Only keys above the running H-th can enter the merged list (one equal to
// it is a copy or the H-th itself), so the chunk's rounds stop at the
// first max that is not above it: after the first chunk of random data,
// most v3 chunks end after one round.
template <int kDocs, int H, bool kGuard>
__device__ __forceinline__ void select_chunk(const float* sc, float* run,
                                             bool first, bool last, int lane,
                                             float* out, float* guard) {
  constexpr int kE = kDocs / 32;
  float r[H];
#pragma unroll
  for (int h = 0; h < H; ++h) r[h] = first ? kKeyDead : run[h];
  float v[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) v[e] = sc[lane + 32 * e];
  // max-then-clear-every-equal, as _guard_emit / _emit_keys: the chunk's
  // top-H distinct keys above r[H - 1], then KEY_DEAD
  float top[H];
  bool done = false;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    top[h] = kKeyDead;
    if (!done) {  // warp-uniform
      float m = v[0];
#pragma unroll
      for (int e = 1; e < kE; ++e) m = fmaxf(m, v[e]);
      m = warp_max_redux(m);
      done = m <= r[H - 1];
      if (!done) {
        top[h] = m;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (v[e] == m) v[e] = kKeyDead;
        }
      }
    }
  }
  // merge two descending distinct lists, one copy of each value
  float merged[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float x = fmaxf(r[0], top[0]);
    merged[h] = x;
    const bool from_r = r[0] == x, from_top = top[0] == x;
    if (from_r) pop_head(r);
    if (from_top) pop_head(top);
  }
  __syncwarp();  // every lane has read run before lane 0 rewrites it
  if (lane != 0) return;
  if (last) {
#pragma unroll
    for (int h = 0; h < H; h += 4) {
      reinterpret_cast<float4*>(out)[h / 4] =
          make_float4(merged[h], merged[h + 1], merged[h + 2], merged[h + 3]);
    }
    if constexpr (kGuard) atomic_max_float(guard, merged[H - 1]);
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h) run[h] = merged[h];
  }
}

}  // namespace fused
}  // namespace svs
