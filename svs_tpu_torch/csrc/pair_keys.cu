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
// Design, as extract.cu:
// - a persistent grid; each warp walks the subtiles w, w + stride, ... of
//   the flattened [R, N/512].  A walk by whole 4096-column blocks (for one
//   512-byte store per output tile) would give a [256, 114,688] block
//   7,168 units for some 6,000 resident warps: a last lap mostly idle;
// - each warp owns a ring of kStages 2 KB stages in shared memory, each
//   filled by one 1-D bulk copy (TMA) completing on the stage's mbarrier;
//   the warp moves its subtile into registers and refills the stage at
//   once, so the next kStages subtiles load while it selects;
// - cheap rounds: lane L keys subtile lanes L + 32m (svs::v2_key, as the
//   fused v2 emit does) into registers as order_keys (ints that order like
//   the float keys) and caches, for each half of them, the max and the
//   next key below it.  A round is one redux.sync over the lanes' maxima;
//   a lane whose max equals the round's clears every key equal to it (the
//   reference's rule) by promoting the half's next key, and rescans that
//   half only when it is taken twice.  The keys never change: a cleared
//   key is any key at or above its half's current max.  Interleaved lanes
//   put the top subtile lanes of a flat subtile in different lanes;
// - a subtile of PAIR_MASKED scores only (the lower triangle: half of a
//   block's columns on average) skips the keying: its rounds take subtile
//   lanes 511, 510, ... of one key level.
// Lane h keeps round h's key; lanes 8-15 write the subtile's share of the
// dead lanes.

#include "svs_common.cuh"

namespace {

constexpr int kSub = 512;       // FUSED_SUBTILE
constexpr int kH = 8;           // EXTRACT_H
constexpr int kNSub = 8;        // PAIR_NSUB
constexpr int kBlockN = 4096;   // PAIR_BLOCK_N
constexpr int kKeys = 64;       // PAIR_KEYS
constexpr int kOutLanes = 128;  // _PAIR_OUT_LANES
constexpr float kPairMasked = -2.0f;  // PAIR_MASKED
constexpr int kWarps = 8, kStages = 2;  // the ring: warps per block, stages
constexpr int kThreads = kWarps * 32;
constexpr int kPer = kSub / 32;  // keys per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kStageBytes = kSub * sizeof(float);
constexpr size_t kSmem =
    (size_t)kWarps * kStages * (kStageBytes + sizeof(uint64_t));

__device__ __forceinline__ int max8(const int* k) {
  return max(max(max(k[0], k[1]), max(k[2], k[3])),
             max(max(k[4], k[5]), max(k[6], k[7])));
}

// The largest of the 8 keys below `top`, or `dead` if that is larger: what
// the half holds once every key from `top` up has been cleared to dead.
__device__ __forceinline__ int below8(const int* k, int top, int dead) {
  int b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) b[s] = k[s] < top ? k[s] : dead;
  return max(max8(b), dead);
}

// One half of a lane's keys: its max and the next key below it (floored
// at dead).  `next` is exact while `fresh`: a round that takes
// `top` clears every key from `top` up to dead, so it promotes `next`; a
// second such round rescans the half below the key it takes.
struct Half {
  int top, next;
  bool fresh;
};

__device__ __forceinline__ Half half_of(const int* k, int dead) {
  const int top = max8(k);
  return {top, below8(k, top, dead), true};
}

__device__ __forceinline__ void take(Half& h, const int* k, int dead) {
  if (h.fresh) {
    h.top = h.next;
    h.fresh = false;
  } else {
    h.top = below8(k, h.top, dead);
    h.next = below8(k, h.top, dead);
    h.fresh = true;
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_keys_kernel(const float* __restrict__ scores, long long total,
                     float* __restrict__ out) {
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
    const long long w = first + u * stride;  // subtile w of the flat [R, N/512]
    const int st = u % kStages;
    svs::mbar_wait(bar + st, (uint32_t)((u / kStages) & 1));
    // lane L holds subtile lanes L + 32m (m < 16), as order_keys: the top
    // lanes of a fully masked subtile, which win its rounds, lie in
    // different lanes
    const float* tile = ring + st * kSub;
    float x[kPer];
    bool masked = true;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      x[m] = tile[32 * m + lane];
      masked = masked & (x[m] == kPairMasked);
    }
    __syncwarp();  // every lane holds its scores: the stage is free
    if (lane == 0 && u + kStages < count) {
      svs::bulk_load(ring + st * kSub,
                     scores + (w + kStages * stride) * kSub, kStageBytes,
                     bar + st);
    }
    const int dead = svs::order_key(svs::kKeyDead);
    int mine = dead;
    if (__all_sync(kFull, masked)) {
      // all PAIR_MASKED (the keyed pass's lower triangle): one level, so
      // round h takes the key of subtile lane 511 - h
      mine = svs::order_key(svs::v2_key(kPairMasked, kSub - 1 - lane));
    } else {
      int k[kPer];
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        k[m] = svs::order_key(svs::v2_key(x[m], 32 * m + lane));
      }
      Half lo = half_of(k, dead), hi = half_of(k + 8, dead);
      int lk = max(lo.top, hi.top);
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const int mk = __reduce_max_sync(kFull, lk);
        if (lane == h) mine = mk;
        if (h + 1 < kH && lk == mk) {  // the lane(s) holding the max
          if (lo.top == mk) take(lo, k, dead);
          if (hi.top == mk) take(hi, k + 8, dead);
          lk = max(lo.top, hi.top);
        }
      }
    }
    // lanes 0-7 the subtile's keys, lanes 8-15 its share of the dead lanes
    const long long blk = w / kNSub;
    const int sub = (int)(w % kNSub);
    float* o = out + blk * kOutLanes;
    if (lane < kH) {
      o[sub * kH + lane] = svs::order_key_value(mine);
    } else if (lane < 2 * kH) {
      o[kKeys + sub * kH + (lane - kH)] = svs::kKeyDead;
    }
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
  const long long total = (long long)r * (n / kSub);
  static svs::FitCache fit;
  unsigned blocks = 0;
  const cudaError_t rc = svs::persistent_blocks(
      pair_keys_kernel, kThreads, kSmem, (total + kWarps - 1) / kWarps, &fit,
      &blocks);
  if (rc != cudaSuccess) return (int)rc;
  pair_keys_kernel<<<blocks, kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), total, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
