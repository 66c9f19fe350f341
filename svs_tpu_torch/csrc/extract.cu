// Two-pass extraction: the top-8 of every 1024-lane subtile of a
// precomputed [B, N] f32 score matrix, as values and f32 global indices.
//
// Replaces _extract_kernel (svs_tpu/ops/pallas_extract.py:113, called by
// _extract at :141), which serves batches above FUSED_MAX_BATCH = 256 on
// every precision (extract_topk, score_topk_extract_packed and
// quant.score_topk_int8_extract_packed) and the exact pairwise pass.  Per
// round: the subtile max, the HIGHEST index among the lanes equal to it,
// then that one lane cleared to -inf.  A subtile that is all -inf (a
// NEG_INF padding row, or columns past n_valid) therefore emits -inf with
// the subtile's highest index on every round, exactly as the reference
// does.  A max of zero is emitted as +0.0, whatever the signs of the
// zeros it ties (the plain version makes the same canonical zero).
//
// What bounds it on an H100: it reads the B x N f32 scores once (2.08 GB
// at B = 512 over 1,015,808 docs: 0.62 ms at 3.35 TB/s; 117 MB for a
// [256, 114,688] pair block: 35 us) and writes B x N/64 floats.  Design:
// - a persistent grid (the blocks that fit the card at once); each warp
//   walks the subtiles w, w + stride, ... of the flattened [B, N/1024];
// - each warp owns a ring of kStages 4 KB stages in shared memory, each
//   filled by one 1-D bulk copy (TMA) that completes on the stage's
//   mbarrier, so the next kStages - 1 subtiles are loading while the warp
//   selects in the current one;
// - cheap rounds: lane L reads its 32 values as 16-byte vectors (columns
//   128e + 4L + j, e < 8) and caches the (max, highest column among its
//   equals) of each group of 8 (e = 2g, 2g + 1), and the best of those.  A
//   round is two redux.sync over the lanes' cached pairs (the max as an
//   order_key, then the highest column at that max); only the lane that
//   owns the winner marks it cleared (a bit in a register) and rescans
//   that one group from shared memory.  The first round whose max is -inf
//   ends the subtile: every later round of the reference is (-inf,
//   highest column).

#include "svs_common.cuh"

#include <math.h>

namespace {

constexpr int kSub = 1024;  // SUBTILE
constexpr int kH = 8;       // EXTRACT_H
constexpr int kWarps = 8, kStages = 2;  // the ring: warps per block, stages
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = kSub / 256;  // per lane: 8 values (two float4) each
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kStageBytes = kSub * sizeof(float);
constexpr size_t kSmem =
    (size_t)kWarps * kStages * (kStageBytes + sizeof(uint64_t));

// Keep the right operand (the higher columns) on a tie.
__device__ __forceinline__ void take_right(float& v, int& i, float rv,
                                           int ri) {
  if (rv >= v) {
    v = rv;
    i = ri;
  }
}

// The (max, highest column among its equals) of one group of a lane: the 8
// values of float4s a (columns col0 + 0..3) and c (col0 + 128..131), slots
// in `dead` (bit 4*(e&1) + j) reading as -inf.
template <bool kDead>
__device__ __forceinline__ void best8(const float4& a, const float4& c,
                                      uint32_t dead, int col0, float& bv,
                                      int& bi) {
  float x[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  if (kDead) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (dead & (1u << s)) x[s] = -INFINITY;
    }
  }
  float v01 = x[0], v23 = x[2], v45 = x[4], v67 = x[6];
  int i01 = 0, i23 = 2, i45 = 128, i67 = 130;
  take_right(v01, i01, x[1], 1);
  take_right(v23, i23, x[3], 3);
  take_right(v45, i45, x[5], 129);
  take_right(v67, i67, x[7], 131);
  take_right(v01, i01, v23, i23);
  take_right(v45, i45, v67, i67);
  take_right(v01, i01, v45, i45);
  bv = v01;
  bi = col0 + i01;
}

// The best of the lane's group pairs (groups ascend in column).
__device__ __forceinline__ void lane_best(const float* gv, const int* gi,
                                          float& lv, int& li) {
  float v0 = gv[0], v2 = gv[2];
  int i0 = gi[0], i2 = gi[2];
  take_right(v0, i0, gv[1], gi[1]);
  take_right(v2, i2, gv[3], gi[3]);
  take_right(v0, i0, v2, i2);
  lv = v0;
  li = i0;
}

__global__ void __launch_bounds__(kThreads)
    extract_kernel(const float* __restrict__ scores, long long total, int t,
                   float* __restrict__ vals, float* __restrict__ idx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ring = reinterpret_cast<float*>(smem) + (size_t)warp * kStages * kSub;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
                      smem + (size_t)kWarps * kStages * kStageBytes) +
                  warp * kStages;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  if (first >= total) return;  // warp-uniform; no block-wide sync follows
  const int count = (int)((total - first + stride - 1) / stride);
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) svs::mbar_init(bar + s);
    svs::mbar_init_fence();
    for (int s = 0; s < kStages && s < count; ++s) {
      svs::bulk_load(ring + s * kSub, scores + (first + s * stride) * kSub,
                     kStageBytes, bar + s);
    }
  }
  __syncwarp();

#pragma unroll 1
  for (int u = 0; u < count; ++u) {
    const long long w = first + u * stride;
    const int st = u % kStages;
    svs::mbar_wait(bar + st, (uint32_t)((u / kStages) & 1));
    const float4* t4 = reinterpret_cast<const float4*>(ring + st * kSub);
    const int base = (int)(w % t) * kSub;  // column of the subtile's lane 0
    const int col = base + 4 * lane;
    float gv[kGroups];
    int gi[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      best8<false>(t4[64 * g + lane], t4[64 * g + 32 + lane], 0u,
                   col + 256 * g, gv[g], gi[g]);
    }
    float lv;
    int li;
    lane_best(gv, gi, lv, li);
    uint32_t dead = 0;
    // the answer of every round past the last finite max
    float my_v = -INFINITY;
    int my_i = base + kSub - 1;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int lk = svs::order_key(lv);
      const int mk = __reduce_max_sync(kFull, lk);
      if (mk == svs::kNegInfKey) break;  // warp-uniform
      const int mi = __reduce_max_sync(kFull, lk == mk ? li : -1);
      if (lane == h) {
        my_v = svs::order_key_value(mk);
        my_i = mi;
      }
      if (h + 1 < kH && li == mi) {  // the one lane that owns the winner
        const int rel = mi - base;
        const int e = rel >> 7, g = e >> 1;
        dead |= 1u << (4 * e + (rel & 3));
        float nv;
        int ni;
        best8<true>(t4[64 * g + lane], t4[64 * g + 32 + lane],
                    dead >> (8 * g), col + 256 * g, nv, ni);
#pragma unroll
        for (int gg = 0; gg < kGroups; ++gg) {
          gv[gg] = gg == g ? nv : gv[gg];
          gi[gg] = gg == g ? ni : gi[gg];
        }
        lane_best(gv, gi, lv, li);
      }
    }
    if (lane < kH) {
      vals[w * kH + lane] = my_v;
      idx[w * kH + lane] = (float)my_i;
    }
    __syncwarp();  // the rescans are done: the stage is free
    if (lane == 0 && u + kStages < count) {
      svs::bulk_load(ring + st * kSub,
                     scores + (w + kStages * stride) * kSub, kStageBytes,
                     bar + st);
    }
  }
}

}  // namespace

// scores [b, n] f32, 16-byte aligned (n % 1024 == 0, n < 2^24) ->
// vals, idx [b, (n/1024)*8].
extern "C" int svs_extract(const void* scores, int b, int n, void* vals,
                           void* idx, void* stream) {
  if (b <= 0 || n <= 0 || n % kSub != 0 || n >= (1 << 24) ||
      reinterpret_cast<uintptr_t>(scores) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)b * (n / kSub);
  static svs::FitCache fit;
  unsigned blocks = 0;
  const cudaError_t rc = svs::persistent_blocks(
      extract_kernel, kThreads, kSmem, (total + kWarps - 1) / kWarps, &fit,
      &blocks);
  if (rc != cudaSuccess) return (int)rc;
  extract_kernel<<<blocks, kThreads, kSmem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), total, n / kSub,
      static_cast<float*>(vals), static_cast<float*>(idx));
  return (int)cudaGetLastError();
}
