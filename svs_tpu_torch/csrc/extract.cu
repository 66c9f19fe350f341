// Two-pass extraction: the top-8 of every 1024-lane subtile of a
// precomputed [B, N] f32 score matrix, as values and f32 global indices.
//
// Replaces _extract_kernel (svs_tpu/ops/pallas_extract.py:113, called by
// _extract at :141), which serves batches above FUSED_MAX_BATCH = 256 on
// every precision (extract_topk, score_topk_extract_packed and
// quant.score_topk_int8_extract_packed).  Per round: the subtile max, the
// HIGHEST index among the lanes equal to it, then that one lane cleared to
// -inf.  A subtile that is all -inf (a NEG_INF padding row, or columns past
// n_valid) therefore emits -inf with the subtile's highest index on every
// round, exactly as the reference does.
//
// What bounds it on an H100: it reads the B x N f32 scores once (2.08 GB
// at B = 512 over 1,015,808 docs: 0.62 ms at 3.35 TB/s) and writes
// B x N/128 floats; eight rounds of warp shuffles per 1024 scores keep it
// near the read.  Design: one warp per (query row, subtile), 32 scores per
// lane loaded as 32 coalesced 128-byte rows; every round is a warp-wide
// shuffle max of values, then of candidate indices, all in registers.
// Lane h keeps round h's winner so the 8 results leave as one store.

#include "svs_common.cuh"

#include <math.h>

namespace {

constexpr int kSub = 1024;  // SUBTILE
constexpr int kH = 8;       // EXTRACT_H
constexpr int kPer = kSub / 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    extract_kernel(const float* __restrict__ scores, int b, int n,
                   float* __restrict__ vals, float* __restrict__ idx) {
  const int t = n / kSub;
  const long long w =
      (long long)blockIdx.x * kWarps + (long long)(threadIdx.x >> 5);
  if (w >= (long long)b * t) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int row = (int)(w / t), s = (int)(w % t);
  const float* src = scores + (size_t)row * n + (size_t)s * kSub;
  float v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = src[lane + 32 * e];
  const int base = s * kSub;
  float my_v = 0.0f, my_i = 0.0f;
#pragma unroll 1
  for (int h = 0; h < kH; ++h) {
    float mv = v[0];
#pragma unroll
    for (int e = 1; e < kPer; ++e) mv = fmaxf(mv, v[e]);
    mv = svs::warp_max(mv);
    int mi = -1;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (v[e] == mv) mi = base + lane + 32 * e;  // e ascends: the last is the highest
    }
    mi = svs::warp_max_int(mi);
    if (lane == h) {
      my_v = mv;
      my_i = (float)mi;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (base + lane + 32 * e == mi) v[e] = -INFINITY;
    }
  }
  if (lane < kH) {
    const size_t o = (size_t)row * t * kH + (size_t)s * kH + lane;
    vals[o] = my_v;
    idx[o] = my_i;
  }
}

}  // namespace

// scores [b, n] f32 (n % 1024 == 0, n < 2^24) -> vals, idx [b, (n/1024)*8].
extern "C" int svs_extract(const void* scores, int b, int n, void* vals,
                           void* idx, void* stream) {
  if (b <= 0 || n <= 0 || n % kSub != 0 || n >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long warps = (long long)b * (n / kSub);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  extract_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), b, n, static_cast<float*>(vals),
      static_cast<float*>(idx));
  return (int)cudaGetLastError();
}
