// The emits of the fused scoring kernels (fused_int8.cu, fused_float.cu).
//
// The first core (mode 2, v2, at B <= 8 only): one CUDA block owns 1024
// docs x QT = 8 queries, stages 64-byte slices of its doc rows in shared
// memory, and ends with emit() over the f32 scores its threads hold: per
// 512-doc subtile the top-8 packed keys floor((s + KEY_BIAS) * KEY_QSCALE)
// * 512 + lane (_fused2_kernel / _fused2_int8_kernel, _emit_keys).
//
// The core of fused3.cuh (every other mode and batch) ends with a chunked
// emit below.  A block of that core walks its 1024 docs in 4 chunks of 256
// (64 queries x 1024 docs of f32 accumulators would be all of an SM's
// registers), so the top-H of a subtile is merged chunk by chunk:
// - mode 3, v3 (_fused3_kernel / _fused3_int8_kernel, _guard_emit):
//   select_chunk, per 1024-doc subtile the top-4 packed keys
//   floor((clip(s,-3,3) + KEY_BIAS) * GUARD_QSCALE) * 1024 + lane over 4
//   chunks, and per 8192-doc block one guard lane, the max of its 8 subtile
//   tails;
// - mode 2, v2 at 9 <= B <= 256: select_chunk, per 512-doc subtile the
//   top-8 v2 keys over 2 chunks, no guard;
// - mode 1, v1 (_fused_kernel / _fused_int8_kernel) at every batch:
//   select_chunk_v1, per 512-doc subtile the top-8 f32 values and their
//   rows (as f32) over 2 chunks.
// The keyed merge is exact for any H: the reference's H rounds of
// max-then-clear-every-equal emit the H largest DISTINCT keys of the
// subtile (then KEY_DEAD, the floor of every key, once they run out), and
// the H largest distinct values of a union are the H largest distinct
// values of the union of its parts' top-H lists.  Keys collide only past
// 2^24 (v3: clipped raw-op scores above ~2.94; v2: scores above ~2.94,
// unclipped), where key + lane rounds to even; the merge keeps one copy of
// each value, as clear-every-equal does.  (It takes every live key to be
// above KEY_DEAD, as every score above -5.06 keys: a v2 subtile whose
// live keys all lay below it would emit one of them in the reference and
// KEY_DEAD here.  Unit rows score within [-1, 1].)  The v1 merge is exact
// for the same reason under a total order; select_chunk_v1 says which.
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

// The v2 emit of the first core.  s[i][m] is the f32 score of query q0 + i
// and doc doc0 + tid + m * kThreads.  sc is shared memory of QT * 1024
// floats that no thread reads any more (the caller synchronised after its
// product).
template <int QT>
__device__ __forceinline__ void emit(const float (&s)[QT][kDocsPerThread],
                                     float* sc, int tid, int q0, int doc0,
                                     int b, int n_valid, int out_cols,
                                     float* __restrict__ out) {
  constexpr int kSub = 512, kH = 8;  // FUSED_SUBTILE x EXTRACT_H
  // Part 1: key every score into shared memory:
  // floor((s + KEY_BIAS) * KEY_QSCALE) * 512 + lane   (_emit_keys)
#pragma unroll
  for (int m = 0; m < kDocsPerThread; ++m) {
    const int local = tid + m * kThreads;
    const int row = doc0 + local;
    const int lane = local & (kSub - 1);
    const int live = min(max(n_valid - (row - lane), 0), kSub);
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      sc[i * kBlockDocs + local] = lane < live ? v2_key(s[i][m], lane) : kKeyDead;
    }
  }
  __syncthreads();

  // Part 2: one warp per (query, subtile), H rounds of max-and-clear.
  constexpr int kE = kSub / 32;
  constexpr int kNSub = kBlockDocs / kSub;
  const int warp = tid >> 5, lane = tid & 31;
  for (int p = warp; p < QT * kNSub; p += kWarps) {
    const int i = p / kNSub, sub = p % kNSub;
    const int qrow = q0 + i;
    if (qrow >= b) continue;  // warp-uniform
    const float* src = sc + i * kBlockDocs + sub * kSub;
    float v[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = src[lane + 32 * e];
    const size_t col0 =
        (size_t)qrow * out_cols + (size_t)((doc0 + sub * kSub) / kSub) * kH;
    for (int h = 0; h < kH; ++h) {
      float mv = v[0];
#pragma unroll
      for (int e = 1; e < kE; ++e) mv = fmaxf(mv, v[e]);
      mv = warp_max(mv);
      if (lane == 0) out[col0 + h] = mv;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        if (v[e] == mv) v[e] = kKeyDead;
      }
    }
  }
}

// --- the chunked emits of fused3.cuh -----------------------------------------

constexpr int kV3H = 4;           // GUARD_H
constexpr int kV3SubDocs = 1024;  // GUARD_SUBTILE
constexpr int kV2H = 8;           // EXTRACT_H
constexpr int kV2SubDocs = 512;   // FUSED_SUBTILE
constexpr int kV1H = 8;           // EXTRACT_H
constexpr int kV1SubDocs = 512;   // FUSED_SUBTILE

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
// chunk of the subtile writes its H keys to out (16-byte aligned when H is
// a multiple of 4) and,
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
    if constexpr (H % 4 == 0) {
#pragma unroll
      for (int h = 0; h < H; h += 4) {
        reinterpret_cast<float4*>(out)[h / 4] =
            make_float4(merged[h], merged[h + 1], merged[h + 2], merged[h + 3]);
      }
    } else {  // the probes' H of 2, 3 and 6 (any alignment)
#pragma unroll
      for (int h = 0; h < H; ++h) out[h] = merged[h];
    }
    if constexpr (kGuard) atomic_max_float(guard, merged[H - 1]);
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h) run[h] = merged[h];
  }
}

// Drop the head of a descending (value, row) list of H entries.
template <int H>
__device__ __forceinline__ void pop_head(float (&v)[H], int (&r)[H]) {
#pragma unroll
  for (int h = 0; h + 1 < H; ++h) {
    v[h] = v[h + 1];
    r[h] = r[h + 1];
  }
  v[H - 1] = -INFINITY;
}

// v1, one warp, one query row: the top-H (value, row) of a chunk of kDocs
// f32 scores (sc, contiguous, -inf past the live lanes; chunk doc p is row
// row0 + p), merged with the running top-H of the subtile's first chunk
// (run: H values, then H rows as int bits; not read for the first chunk).
// The last chunk writes the H values to out_v and their rows, as f32, to
// out_r (both 16-byte aligned); the others leave the merged list in run.
//
// The reference's emit (_fused_int8_kernel) takes, H times, the max, the
// highest row holding it, and clears only that row: the top-H of the
// subtile under the order (value descending, row descending).  The top-H
// of a union under a total order are the top-H of the union of its parts'
// top-H lists, so the chunk-by-chunk merge is exact, given that:
// - ties: within a chunk the highest row wins; every row of the second
//   chunk is above every row of the first, so on equal values the chunk's
//   entry ranks before the running one.  A chunk entry therefore enters
//   the list iff its value is >= the running H-th, and the rounds stop at
//   the first max strictly below it (rows are distinct: no copies);
// - the -inf tail: a subtile with fewer than H live rows emits -inf, and
//   beside each -inf the reference names the highest row among ALL -inf
//   entries, cleared ones included: the subtile's last row (it is past
//   n_valid), in every -inf slot.  So the rounds stop at the first -inf
//   max, and the last chunk names last_row beside every -inf it writes.
// The values travel as order keys (svs::order_key: -0.0 as +0.0, as ==
// has them), so a round is two redux.sync: the max, then the highest
// position holding it.  The scores of the fused kernels are never -0.0:
// each sum starts from +0.0 and is rescaled by positive scales.
template <int kDocs, int H>
__device__ __forceinline__ void select_chunk_v1(const float* sc, float* run,
                                                bool first, bool last,
                                                int row0, int last_row,
                                                int lane, float* out_v,
                                                float* out_r) {
  constexpr int kE = kDocs / 32;
  const int* run_r = reinterpret_cast<const int*>(run + H);
  float rv[H];
  int rr[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    rv[h] = first ? -INFINITY : run[h];
    rr[h] = first ? 0 : run_r[h];
  }
  int v[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) v[e] = order_key(sc[lane + 32 * e]);
  // entries at or above the running H-th enter; a first chunk takes all
  const int floor_key = order_key(rv[H - 1]);
  float tv[H];
  int tr[H];
  bool done = false;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    tv[h] = -INFINITY;
    tr[h] = 0;
    if (!done) {  // warp-uniform
      int m = v[0];
#pragma unroll
      for (int e = 1; e < kE; ++e) m = max(m, v[e]);
      m = __reduce_max_sync(0xffffffffu, m);
      done = m < floor_key || m == kNegInfKey;
      if (!done) {
        int p = -1;  // the lane's highest position holding m
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (v[e] == m) p = lane + 32 * e;
        }
        p = __reduce_max_sync(0xffffffffu, p);
        tv[h] = order_key_value(m);
        tr[h] = row0 + p;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (lane + 32 * e == p) v[e] = kNegInfKey;
        }
      }
    }
  }
  // merge two descending lists, on equal values the chunk's entry first
  // (a first chunk's list is the merged one)
  float mv[H];
  int mr[H];
  if (first) {  // warp-uniform
#pragma unroll
    for (int h = 0; h < H; ++h) {
      mv[h] = tv[h];
      mr[h] = tr[h];
    }
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool from_chunk = tv[0] >= rv[0];
      mv[h] = from_chunk ? tv[0] : rv[0];
      mr[h] = from_chunk ? tr[0] : rr[0];
      if (from_chunk) {
        pop_head(tv, tr);
      } else {
        pop_head(rv, rr);
      }
    }
  }
  __syncwarp();  // every lane has read run before lane 0 rewrites it
  if (lane != 0) return;
  if (last) {
    float rows[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      rows[h] = (float)(mv[h] == -INFINITY ? last_row : mr[h]);
    }
#pragma unroll
    for (int h = 0; h < H; h += 4) {
      reinterpret_cast<float4*>(out_v)[h / 4] =
          make_float4(mv[h], mv[h + 1], mv[h + 2], mv[h + 3]);
      reinterpret_cast<float4*>(out_r)[h / 4] =
          make_float4(rows[h], rows[h + 1], rows[h + 2], rows[h + 3]);
    }
  } else {
    int* run_w = reinterpret_cast<int*>(run + H);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      run[h] = mv[h];
      run_w[h] = mr[h];
    }
  }
}

}  // namespace fused
}  // namespace svs
