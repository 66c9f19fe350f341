// Pass-2 key reduction: the top-h2 of every 128-lane group of packed keys.
//
// Replaces _make_reduce_kernel(h2) (svs_tpu/ops/pallas_extract.py:772,
// called by _reduce_keys at :803), which the v2 finish runs on every call
// and the v3 finish runs at GUARD_STAGE_MIN_BLOCKS blocks and above.  For
// each group the low 7 lane bits of each level-1 key are replaced by the
// key's position in the group: k2 = floor(k / 128) * 128 + pos (exact:
// /128 and *128 are exponent shifts, the sum stays below 2^24), then h2
// rounds of max-and-clear (clear value -2^24) emit the group's winners.
//
// What bounds it on an H100: it reads B x L1 f32 keys and writes
// B x (L1/128) x h2 — a few MB at the main path's shapes — so it is a
// latency-bound pass of one launch.  Design: one warp per (query row,
// group) holding 4 keys per lane; each round is a warp-wide shuffle max
// plus a compare-and-clear, all in registers.  The arithmetic is written
// as __fmul_rn/__fadd_rn/floorf so nothing is contracted.

#include "svs_common.cuh"

#include <math.h>

namespace {

constexpr int kGroup = 128;  // REDUCE_GROUP
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    reduce_keys_kernel(const float* __restrict__ keys, int b, int l1, int h2,
                       float* __restrict__ out) {
  const int groups = l1 / kGroup;
  const long long w =
      (long long)blockIdx.x * kWarps + (long long)(threadIdx.x >> 5);
  if (w >= (long long)b * groups) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int row = (int)(w / groups), g = (int)(w % groups);
  const float* src = keys + (size_t)row * l1 + (size_t)g * kGroup;
  float v[kGroup / 32];
#pragma unroll
  for (int e = 0; e < kGroup / 32; ++e) {
    const int pos = lane + 32 * e;
    v[e] = __fadd_rn(__fmul_rn(floorf(__fmul_rn(src[pos], 0.0078125f)), 128.0f),
                     (float)pos);
  }
  float* dst = out + (size_t)row * groups * h2 + (size_t)g * h2;
  for (int h = 0; h < h2; ++h) {
    float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    m = svs::warp_max(m);
    if (lane == 0) dst[h] = m;
#pragma unroll
    for (int e = 0; e < kGroup / 32; ++e) {
      if (v[e] == m) v[e] = svs::kKeyDead;
    }
  }
}

}  // namespace

// keys [b, l1] f32 (l1 % 128 == 0) -> out [b, (l1 / 128) * h2] f32.
extern "C" int svs_reduce_keys(const void* keys, int b, int l1, int h2,
                               void* out, void* stream) {
  if (b <= 0 || l1 <= 0 || l1 % kGroup != 0 || h2 <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long warps = (long long)b * (l1 / kGroup);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  reduce_keys_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), b, l1, h2, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
