// Keyed extraction over a precomputed pair-score block: per 512-lane subtile
// of a [R, N] f32 score matrix, the top-8 v2 packed keys
// floor((s + KEY_BIAS) * KEY_QSCALE) * 512 + lane; per 4096-column block,
// output lanes [0, 64) hold the 8 subtiles' descending keys and lanes
// [64, 128) hold KEY_DEAD.
//
// Replaces _pair_keys_kernel (svs_tpu/ops/pallas_extract.py:1605, called by
// pairwise_keys_extract at :1653), which the keyed pairwise candidate pass
// runs once per 256-row block of the corpus.  Each round takes the subtile
// max and clears EVERY key equal to it to KEY_DEAD, as the reference does
// (keys differ in their lane bits, so that is one key unless a score past
// the key horizon collides).  Dead entries arrive pre-masked to PAIR_MASKED
// (-2.0, finite), so every lane is live and no n_valid mask is applied.
//
// What bounds it on an H100: it reads the R x N f32 scores once (117 MB for
// a [256, 114,688] block: 35 us at 3.35 TB/s) and writes R x N/32 floats.
// Design: one warp per (row, subtile), as extract.cu; each lane loads its 16
// scores as four coalesced 16-byte reads, keys them in registers, and every
// round is a warp-wide shuffle max.  Lane h keeps round h's winner, lanes
// 8-15 carry the subtile's share of the dead lanes, so the tile leaves in
// one store per warp.

#include "svs_common.cuh"

namespace {

constexpr int kSub = 512;      // FUSED_SUBTILE
constexpr int kH = 8;          // EXTRACT_H
constexpr int kNSub = 8;       // PAIR_NSUB
constexpr int kBlockN = 4096;  // PAIR_BLOCK_N
constexpr int kKeys = 64;      // PAIR_KEYS
constexpr int kOutLanes = 128; // _PAIR_OUT_LANES
constexpr int kPer = kSub / 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    pair_keys_kernel(const float* __restrict__ scores, int r, int n,
                     float* __restrict__ out) {
  const int t = n / kSub;
  const long long w =
      (long long)blockIdx.x * kWarps + (long long)(threadIdx.x >> 5);
  if (w >= (long long)r * t) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int row = (int)(w / t), s = (int)(w % t);
  const float4* src = reinterpret_cast<const float4*>(
      scores + (size_t)row * n + (size_t)s * kSub);
  float v[kPer];
#pragma unroll
  for (int e = 0; e < kPer / 4; ++e) {
    const float4 x = __ldg(src + lane + 32 * e);
    const int c = 4 * lane + 128 * e;  // lane of x.x within the subtile
    v[4 * e + 0] = svs::v2_key(x.x, c + 0);
    v[4 * e + 1] = svs::v2_key(x.y, c + 1);
    v[4 * e + 2] = svs::v2_key(x.z, c + 2);
    v[4 * e + 3] = svs::v2_key(x.w, c + 3);
  }
  float mine = svs::kKeyDead;
#pragma unroll 1
  for (int h = 0; h < kH; ++h) {
    float mv = v[0];
#pragma unroll
    for (int e = 1; e < kPer; ++e) mv = fmaxf(mv, v[e]);
    mv = svs::warp_max(mv);
    if (lane == h) mine = mv;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (v[e] == mv) v[e] = svs::kKeyDead;
    }
  }
  const int blk = s / kNSub, sub = s % kNSub;
  float* o = out + (size_t)row * (n / kBlockN) * kOutLanes +
             (size_t)blk * kOutLanes;
  if (lane < kH) {
    o[sub * kH + lane] = mine;
  } else if (lane < 2 * kH) {
    o[kKeys + sub * kH + (lane - kH)] = svs::kKeyDead;
  }
}

}  // namespace

// scores [r, n] f32, 16-byte aligned (n % 4096 == 0, r > 0) ->
// out [r, (n/4096)*128] f32.
extern "C" int svs_pair_keys(const void* scores, int r, int n, void* out,
                             void* stream) {
  if (r <= 0 || n <= 0 || n % kBlockN != 0 ||
      reinterpret_cast<uintptr_t>(scores) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long warps = (long long)r * (n / kSub);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  pair_keys_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), r, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
