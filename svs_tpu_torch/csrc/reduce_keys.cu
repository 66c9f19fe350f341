// Staged finish of the keyed (v2) and guarded (v3) prescore paths in one
// launch: pass 2, the top-C merge in lax.top_k order, and the decode.
//
// Replaces _make_reduce_kernel(h2) (svs_tpu/ops/pallas_extract.py:772,
// called by _reduce_keys at :803) together with the XLA ops the reference
// chains around it: lax.top_k, the gather of level-1 keys, the decode and
// the per-row coverage terms of _fused2_finish (:851) and of the staged
// branch of _fused3_finish (:1354).  The result is bit for bit that of
// those functions (svs_tpu_torch.ops.pallas_extract._staged_finish_plain).
//
// Input: one row of level-1 keys per query.  v2: the [B, nb*128] keys of
// _fused2_extract*, zero-padded to a multiple of 2048 lanes.  v3: lanes
// 0..31 of every 128-lane block tile of _fused3_extract* (the block's
// keys; lane 32 is its guard lane), KEY_DEAD-padded to a multiple of 2048.
//
// What bounds it on an H100: it reads B x L1 f32 keys once and writes
// B x C values and rows, so bytes bound it below a microsecond; what
// costs is the serial work per row (h2 rounds of max-and-clear per
// 128-lane group, then a selection among groups * h2 keys).  Design: one
// block of 1024 threads per query row, everything in registers and
// shared memory, one launch per batch in place of about twenty.
// 1. Pass 2: one warp per 128-lane group, 4 keys a lane, each re-keyed
//    floor(k / 128) * 128 + pos (__fmul_rn/__fadd_rn, nothing contracted)
//    and held as an order key (svs::order_key), so a round of
//    max-and-clear is one __reduce_max_sync.  Where every key of the
//    group lies in [-2^24, 2^24) (always, for keys of real scores) the
//    re-keyed values are distinct and a round clears exactly its max, so
//    each lane pops a sorted list of its 4; otherwise every entry equal
//    to the max is cleared to -2^24, as the reference does.  The
//    [groups * h2] winners go to shared memory.  The same pass folds the
//    per-row terms: v2's level-1 tails and domain guard, v3's saturation
//    key, and the bits all winners share.
// 2. Top-C in lax.top_k order (value descending, equal values by
//    ascending column): each winner becomes a composite (order key << cb
//    | 2^cb - 1 - column, cb = 16 bits of column up to 65,536 winners,
//    else 32), all distinct, so a radix select of 8-bit digits
//    (warp-aggregated shared-memory histograms, from the first byte in
//    which two winners differ) finds the C-th composite exactly; the C
//    keys at or above it are compacted and bitonic-sorted in shared
//    memory (strides below 32 on registers, by shuffles).  Dead
//    -2^24 entries sort like any other value, so a dead-padded row comes
//    out as the reference's.
// 3. Decode per selected key (vals, rows), then the row's flags (v2:
//    bit 0 a hidden tail beats the k-th value less KEY_EPS, bit 1 a live
//    level-1 key outside the key horizon) or bound (v3).
// The winners (m x 4 bytes) and the sort buffer (p2 x 8 bytes, p2 = C
// rounded up to a power of two) live in shared memory while they fit the
// device's opt-in limit (227 KB on an H100: 1M docs need at most 56 KB);
// past it, first the sort buffer and then the winners move to a global
// scratch the caller allocates (svs_staged_finish_scratch), one slice per
// row, so every shape the keyed and guarded paths reach is served.  A
// sort buffer in global memory is sorted in runs that fit shared memory;
// only the steps of a stride of a run or more go over global memory.
// Keys are finite (the emits make them so from finite scores).

#include "svs_common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int kGroup = 128;   // REDUCE_GROUP
constexpr int kPadTo = 2048;  // REDUCE_BLOCK
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;       // lanes per block tile of a v2/v3 emit
constexpr int kGuardKeys = 32;   // GUARD_KEYS
constexpr float kHorizon = 16776704.0f;      // KEY_HORIZON = 2^24 - 512
constexpr float kGuardSatKey = 14942208.0f;  // _GUARD_SAT_KEY
constexpr float kKeyEps = 0.000244140625f;   // KEY_EPS = 2^-12
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct RowState {
  int tail1;    // v2: max order key of the level-1 tails (lanes 7 mod 8)
  int tail2;    // max order key of the pass-2 group tails
  int hi;       // v3: max order key of the level-1 keys (sat_key)
  int guard;    // v3: max order key of the guard lanes
  int bad;      // v2: a level-1 key outside the key horizon
  int min_k1;   // v3: min int level-1 key of the selection
  float v_last; // vals[C - 1]
  unsigned w_and, w_or;  // AND / OR of the winners' order keys
  unsigned count;
  unsigned remaining;
  unsigned long long prefix;
};

// Level-1 key j of the row (the reference's keys1p): v2 keys are the row
// itself, v3 keys lanes 0..31 of each 128-lane tile; past l1, the pad.
__device__ __forceinline__ float level1(const float* row, int j, int l1,
                                        bool v3) {
  if (j >= l1) return v3 ? svs::kKeyDead : 0.0f;
  return v3 ? __ldg(row + (j >> 5) * kTile + (j & (kGuardKeys - 1)))
            : __ldg(row + j);
}

// _key_vals (v2, shift 9) / _guard_key_vals (v3, shift 10): the quantized
// score of a key, int32 truncation then floor division, as written.
__device__ __forceinline__ float key_val(float key, bool v3) {
  const int q = __float2int_rz(key) >> (v3 ? 10 : 9);
  return __fsub_rn(__fdiv_rn((float)q, v3 ? 4096.0f : 8192.0f), 1.0625f);
}

// The sort is the descending bitonic network: at block size k and stride j
// the pair (i, i + j), i & j == 0, goes descending where (i & k) == 0.
// buf holds len elements (a power of two, >= 64) at positions base.. of
// the whole sequence (base a multiple of len), so a run can be sorted
// alone in shared memory.

// One step of stride j < 32 on registers: element i keeps the larger of
// its pair where it is the pair's first and the pair goes descending.
__device__ __forceinline__ void cmp_lane(unsigned long long& v, int i, int j,
                                         bool down) {
  const unsigned long long w = __shfl_xor_sync(kFull, v, j);
  v = ((i & j) == 0) == down ? (v > w ? v : w) : (v < w ? v : w);
}

// The steps of stride 16 down to 1 for block size k (k = 32: the whole
// sort of every 32-element run, k = 2..32), on registers, one element a
// lane, a warp per 32 elements.
__device__ __forceinline__ void warp_sort_run(unsigned long long* buf, int len,
                                              int base, int k, int tid) {
  for (int i = tid; i < len; i += kThreads) {  // len % 32 == 0: whole warps
    unsigned long long v = buf[i];
    if (k <= 32) {
      for (int kk = 2; kk <= k; kk <<= 1) {
        for (int j = kk >> 1; j > 0; j >>= 1) cmp_lane(v, i, j, (i & kk) == 0);
      }
    } else {
      const bool down = ((base + i) & k) == 0;
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) cmp_lane(v, i, j, down);
    }
    buf[i] = v;
  }
}

// One step (k, j), j >= 32, over buf, then a barrier.
__device__ __forceinline__ void sort_step(unsigned long long* buf, int len,
                                          int base, int k, int j, int tid) {
  for (int t = tid; t < len / 2; t += kThreads) {
    const int i = 2 * t - (t & (j - 1));  // the pair's first: bit j of i clear
    const unsigned long long a = buf[i], b = buf[i + j];
    if (((base + i) & k) == 0 ? a < b : a > b) {
      buf[i] = b;
      buf[i + j] = a;
    }
  }
  __syncthreads();
}

// The steps of block size k from stride jtop down to 1: strides of 32 and
// more through memory (a barrier each), those below on registers.
__device__ __forceinline__ void merge_steps(unsigned long long* buf, int len,
                                            int base, int k, int jtop, int tid) {
  for (int j = jtop; j >= 32; j >>= 1) sort_step(buf, len, base, k, j, tid);
  warp_sort_run(buf, len, base, k, tid);
  __syncthreads();
}

// The whole network over buf (block sizes 2 up to len).
__device__ __forceinline__ void sort_all(unsigned long long* buf, int len,
                                         int base, int tid) {
  warp_sort_run(buf, len, base, 32, tid);
  __syncthreads();
  for (int k = 64; k <= len; k <<= 1) merge_steps(buf, len, base, k, k >> 1, tid);
}

// Runs of `run` elements of g [p2] (global memory) through the shared
// buffer s: load, fn(s, base), store.
template <typename Fn>
__device__ __forceinline__ void by_runs(unsigned long long* g, int p2,
                                        unsigned long long* s, int run, int tid,
                                        Fn fn) {
  for (int base = 0; base < p2; base += run) {
    for (int i = tid; i < run; i += kThreads) s[i] = g[base + i];
    __syncthreads();
    fn(base);
    for (int i = tid; i < run; i += kThreads) g[base + i] = s[i];
    __syncthreads();
  }
}

// A winner's composite: its order key above a cb-bit column field that
// descends with the column, so equal keys order by ascending column.
__device__ __forceinline__ unsigned long long composite(int okey, int col,
                                                        int cb) {
  return ((unsigned long long)((unsigned)okey ^ 0x80000000u) << cb) |
         (((1ull << cb) - 1) - (unsigned)col);
}

// x >> s for s up to 64 (a shift by 64 is undefined in C++).
__device__ __forceinline__ unsigned long long shr(unsigned long long x, int s) {
  return s >= 64 ? 0ull : x >> s;
}

// kSortG / kKeysG: the sort buffer / the winners in the global scratch
// (gsort [b, p2], gkeys [b, m]) instead of shared memory; run: the sort
// buffer's elements that shared memory holds (p2 unless kSortG).
template <bool kSortG, bool kKeysG>
__global__ void __launch_bounds__(kThreads, 1)
    staged_finish_kernel(const float* __restrict__ src, int width, int v3i,
                         int c, int h2, int p2, int run,
                         float* __restrict__ vals,
                         int* __restrict__ idx, void* __restrict__ aux,
                         unsigned long long* __restrict__ gsort,
                         int* __restrict__ gkeys) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RowState st;
  __shared__ unsigned hist[256];
  const bool v3 = v3i != 0;
  const int nb = width / kTile;
  const int l1 = v3 ? nb * kGuardKeys : width;
  const int groups = (l1 + kPadTo - 1) / kPadTo * (kPadTo / kGroup);
  const int m = groups * h2;
  const int cb = m > 65536 ? 32 : 16;  // the composite's column field
  const int r = blockIdx.x;
  // the sort buffer; with kSortG, srun holds one run of it at a time
  unsigned long long* srun = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* sbuf = kSortG ? gsort + (size_t)r * p2 : srun;
  int* keys2 = kKeysG ? gkeys + (size_t)r * m
                      : reinterpret_cast<int*>(smem + (size_t)run * 8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = src + (size_t)r * width;
  const int dead_key = svs::order_key(svs::kKeyDead);
  if (tid == 0) {
    st.tail1 = st.tail2 = st.hi = st.guard = INT_MIN;
    st.bad = 0;
    st.w_and = kFull;
    st.w_or = 0;
    st.min_k1 = INT_MAX;
    st.count = 0;
  }
  __syncthreads();

  // 1. pass 2, one warp per group, and the row's level-1 terms
  int tail1 = INT_MIN, tail2 = INT_MIN, hi = INT_MIN, bad = 0;
  unsigned w_and = kFull, w_or = 0;  // of every winner's order key
  for (int g = warp; g < groups; g += kWarps) {
    int o[kGroup / 32];
    bool exact = true;
#pragma unroll
    for (int e = 0; e < kGroup / 32; ++e) {
      const int pos = lane + 32 * e;
      const int j = g * kGroup + pos;
      const float x = level1(row, j, l1, v3);
      if (j < l1) {
        if (v3) {
          hi = max(hi, svs::order_key(x));
        } else {
          if ((j & 7) == 7) tail1 = max(tail1, svs::order_key(x));
          const float live = x == svs::kKeyDead ? 0.0f : x;
          bad |= !(x < kHorizon) || !(live > -kHorizon);
        }
      }
      exact &= x >= svs::kKeyDead && x < 16777216.0f;
      o[e] = svs::order_key(__fadd_rn(
          __fmul_rn(floorf(__fmul_rn(x, 0.0078125f)), 128.0f), (float)pos));
    }
    int mm = INT_MIN;
    if (__all_sync(kFull, exact)) {
      // keys in [-2^24, 2^24): the re-keyed values are exact and distinct
      // (distinct positions) and none is below the clear value, so a round
      // clears exactly its max: each lane pops a sorted list of its 4
#define SVS_CAS(a, b) { const int hi_ = max(a, b); b = min(a, b); a = hi_; }
      SVS_CAS(o[0], o[1]) SVS_CAS(o[2], o[3]) SVS_CAS(o[0], o[2])
      SVS_CAS(o[1], o[3]) SVS_CAS(o[1], o[2])
#undef SVS_CAS
      for (int h = 0; h < h2; ++h) {
        mm = __reduce_max_sync(kFull, o[0]);
        if (o[0] == mm) {  // one lane, or several at the clear value
          keys2[g * h2 + h] = mm;
          o[0] = o[1];
          o[1] = o[2];
          o[2] = o[3];
          o[3] = dead_key;
        }
        w_and &= (unsigned)mm;
        w_or |= (unsigned)mm;
      }
    } else {
      int head = max(max(o[0], o[1]), max(o[2], o[3]));
      for (int h = 0; h < h2; ++h) {
        mm = __reduce_max_sync(kFull, head);
        if (lane == 0) keys2[g * h2 + h] = mm;
        if (head == mm) {
#pragma unroll
          for (int e = 0; e < kGroup / 32; ++e) o[e] = o[e] == mm ? dead_key : o[e];
          head = max(max(o[0], o[1]), max(o[2], o[3]));
        }
        w_and &= (unsigned)mm;
        w_or |= (unsigned)mm;
      }
    }
    tail2 = max(tail2, mm);
  }
  int guard = INT_MIN;
  if (v3) {
    for (int jb = tid; jb < nb; jb += kThreads) {
      guard = max(guard, svs::order_key(__ldg(row + jb * kTile + kGuardKeys)));
    }
  }
  tail1 = __reduce_max_sync(kFull, tail1);
  tail2 = __reduce_max_sync(kFull, tail2);
  hi = __reduce_max_sync(kFull, hi);
  guard = __reduce_max_sync(kFull, guard);
  bad = __any_sync(kFull, bad);
  if (lane == 0) {
    atomicMax(&st.tail1, tail1);
    atomicMax(&st.tail2, tail2);
    atomicMax(&st.hi, hi);
    atomicMax(&st.guard, guard);
    atomicAnd(&st.w_and, w_and);
    atomicOr(&st.w_or, w_or);
    if (bad) st.bad = 1;
  }
  __syncthreads();

  // 2. the C-th largest composite: radix select, 8 bits a pass, from the
  // byte of the highest bit in which two winners' order keys differ (the
  // bytes above it are common to all; the column field always differs)
  const unsigned diff = st.w_and ^ st.w_or;
  const int top_bit = diff ? cb + 31 - __clz(diff) : cb - 1;
  const int first_shift = top_bit / 8 * 8;
  // the common bits above the first digit
  unsigned long long prefix =
      shr((unsigned long long)(st.w_and ^ 0x80000000u) << cb, first_shift + 8);
  unsigned remaining = (unsigned)c;  // the target's rank among keys with that prefix
  for (int shift = first_shift; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < m; base += kThreads) {
      const int i = base + tid;
      int d = -1;
      if (i < m) {
        const unsigned long long key = composite(keys2[i], i, cb);
        if (shr(key, shift + 8) == prefix) d = (int)((key >> shift) & 255);
      }
      if (__any_sync(kFull, d >= 0)) {  // past the first digit, most warps hold none
        const unsigned peers = __match_any_sync(kFull, d);
        if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane L covers digits 255 - 8L down to 248 - 8L
      unsigned cnt[8], sum = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        cnt[t] = hist[255 - 8 * lane - t];
        sum += cnt[t];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned acc = incl - sum;
      // one lane holds the digit where the count passes `remaining`
      bool found = !(acc < remaining && incl >= remaining);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (!found && acc + cnt[t] >= remaining) {
          found = true;
          st.prefix = (prefix << 8) | (unsigned)(255 - 8 * lane - t);
          st.remaining = remaining - acc;
        }
        acc += cnt[t];
      }
    }
    __syncthreads();
    prefix = st.prefix;
    remaining = st.remaining;
  }
  const unsigned long long kth = prefix;

  // the C composites at or above it, compacted, then sorted descending
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + tid;
    unsigned long long key = 0;
    bool take = false;
    if (i < m) {
      key = composite(keys2[i], i, cb);
      take = key >= kth;
    }
    const unsigned mask = __ballot_sync(kFull, take);
    unsigned slot = 0;
    if (lane == 0 && mask) slot = atomicAdd(&st.count, __popc(mask));
    slot = __shfl_sync(kFull, slot, 0);
    if (take) sbuf[slot + __popc(mask & ((1u << lane) - 1u))] = key;
  }
  for (int i = c + tid; i < p2; i += kThreads) sbuf[i] = 0;
  __syncthreads();
  // sorted descending: in shared memory, or with kSortG in runs that fit
  // it, the strides of a run or more over the whole buffer in global memory
  if (!kSortG) {
    sort_all(sbuf, p2, 0, tid);
  } else {
    by_runs(sbuf, p2, srun, run, tid,
            [&](int base) { sort_all(srun, run, base, tid); });
    for (int k = 2 * run; k <= p2; k <<= 1) {
      for (int j = k >> 1; j >= run; j >>= 1) sort_step(sbuf, p2, 0, k, j, tid);
      by_runs(sbuf, p2, srun, run, tid,
              [&](int base) { merge_steps(srun, run, base, k, run >> 1, tid); });
    }
  }

  // 3. decode
  int min_k1 = INT_MAX;
  for (int i = tid; i < c; i += kThreads) {
    const unsigned long long key = sbuf[i];
    const unsigned long long cmask = (1ull << cb) - 1;
    const int col = (int)(cmask - (key & cmask));
    const float k2 =
        svs::order_key_value((int)((unsigned)(key >> cb) ^ 0x80000000u));
    const int k2i = __float2int_rz(k2);
    const int pos = (col / h2) * kGroup + (k2i & (kGroup - 1));
    const int k1i = __float2int_rz(level1(row, pos, l1, v3));
    const float v = key_val(k2, v3);
    int out;
    if (v3) {
      const int jb = pos >> 5, s = (pos & (kGuardKeys - 1)) >> 2;
      out = min(jb * 8192 + s * 1024 + (k1i & 1023), nb * 8192 - 1);
      min_k1 = min(min_k1, k1i);
    } else {
      const int jb = pos >> 7, s = (pos & (kTile - 1)) >> 3;
      out = jb * 8192 + s * 512 + (k1i & 511);
    }
    vals[(size_t)r * c + i] = v;
    idx[(size_t)r * c + i] = out;
    if (i == c - 1) st.v_last = v;
  }
  min_k1 = __reduce_min_sync(kFull, min_k1);
  if (lane == 0) atomicMin(&st.min_k1, min_k1);
  __syncthreads();
  if (tid == 0) {
    if (v3) {
      float bnd = fmaxf(key_val(svs::order_key_value(st.guard), true), st.v_last);
      bnd = fmaxf(bnd, key_val(svs::order_key_value(st.tail2), true));
      if (st.hi >= svs::order_key(kGuardSatKey) ||
          __int2float_rn(st.min_k1) <= svs::kKeyDead) {
        bnd = INFINITY;
      }
      static_cast<float*>(aux)[r] = bnd;
    } else {
      const float thr = __fsub_rn(st.v_last, kKeyEps);
      const bool hidden =
          key_val(svs::order_key_value(st.tail1), false) > thr ||
          key_val(svs::order_key_value(st.tail2), false) > thr;
      static_cast<int*>(aux)[r] = (hidden ? 1 : 0) | (st.bad ? 2 : 0);
    }
  }
}

// Where a call's buffers go: shared memory while they fit, else global
// scratch (the sort buffer first, keeping a run of it in shared memory:
// the radix passes read the winners more often).
struct Plan {
  int p2;            // the sort's size: a power of two, whole warps
  int run;           // the sort's elements in shared memory (p2 unless sort_g)
  long long m;       // winners per row
  bool sort_g, keys_g;
  size_t limit;      // the device's dynamic shared memory per block
  size_t smem;       // dynamic shared memory per block
  size_t scratch;    // global scratch, all rows
};

// The dynamic shared memory a block may take on the current device (its
// opt-in limit less the kernel's static shared memory), asked once per device.
cudaError_t smem_limit(int* dev, size_t* limit) {
  static size_t cached[kMaxDevices];  // 0: not asked yet
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < kMaxDevices && cached[*dev]) {
    *limit = cached[*dev];
    return cudaSuccess;
  }
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, staged_finish_kernel<false, false>);
  if (e != cudaSuccess) return e;
  *limit = (size_t)optin - a.sharedSizeBytes;
  if (*dev < kMaxDevices) cached[*dev] = *limit;
  return cudaSuccess;
}

cudaError_t make_plan(int b, int width, int v3, int c, int h2, int* dev,
                      Plan* p) {
  if (b <= 0 || width <= 0 || width % kTile != 0 || h2 <= 0 || h2 > kGroup) {
    return cudaErrorInvalidValue;
  }
  const long long l1 = v3 ? (long long)(width / kTile) * kGuardKeys : width;
  p->m = (l1 + kPadTo - 1) / kPadTo * (kPadTo / kGroup) * h2;
  if (c <= 0 || c > p->m || p->m > INT_MAX / 2) return cudaErrorInvalidValue;
  p->p2 = 64;
  while (p->p2 < c) p->p2 <<= 1;
  const cudaError_t e = smem_limit(dev, &p->limit);
  if (e != cudaSuccess) return e;
  const size_t sort_b = (size_t)p->p2 * 8, keys_b = (size_t)p->m * 4;
  constexpr size_t kMinRun = 1024;  // the smallest run worth a global sort
  p->keys_g = keys_b + kMinRun * 8 > p->limit && sort_b + keys_b > p->limit;
  p->sort_g = sort_b + (p->keys_g ? 0 : keys_b) > p->limit;
  p->run = p->p2;
  if (p->sort_g) {  // the largest power of two that fits beside the winners
    const size_t room = (p->limit - (p->keys_g ? 0 : keys_b)) / 8;
    p->run = (int)kMinRun;
    while ((size_t)p->run * 2 <= room) p->run <<= 1;
  }
  p->smem = (size_t)p->run * 8 + (p->keys_g ? 0 : keys_b);
  p->scratch = (size_t)b * ((p->sort_g ? sort_b : 0) + (p->keys_g ? keys_b : 0));
  return cudaSuccess;
}

template <bool kSortG, bool kKeysG>
cudaError_t launch(const Plan& p, int dev, const float* src, int b, int width,
                   int v3, int c, int h2, float* vals, int* idx, void* aux,
                   unsigned char* scratch, cudaStream_t stream) {
  // the opt-in attribute is per function and device: set once to the limit
  static bool granted[kMaxDevices];
  if (!(dev < kMaxDevices && granted[dev])) {
    const cudaError_t e = cudaFuncSetAttribute(
        staged_finish_kernel<kSortG, kKeysG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.limit);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) granted[dev] = true;
  }
  unsigned long long* gsort =
      kSortG ? reinterpret_cast<unsigned long long*>(scratch) : nullptr;
  int* gkeys = kKeysG ? reinterpret_cast<int*>(
                            scratch + (kSortG ? (size_t)b * p.p2 * 8 : 0))
                      : nullptr;
  staged_finish_kernel<kSortG, kKeysG><<<(unsigned)b, kThreads, p.smem, stream>>>(
      src, width, v3, c, h2, p.p2, p.run, vals, idx, aux, gsort, gkeys);
  return cudaGetLastError();
}

}  // namespace

// The bytes of global scratch svs_staged_finish needs for this call on
// the current device (0 when its buffers fit in shared memory), or a
// negated cudaError_t.
extern "C" long long svs_staged_finish_scratch(int b, int width, int v3, int c,
                                               int h2) {
  Plan p;
  int dev = 0;
  const cudaError_t e = make_plan(b, width, v3, c, h2, &dev, &p);
  return e != cudaSuccess ? -(long long)e : (long long)p.scratch;
}

// src [b, width] f32 (width % 128 == 0): the v2 keys (v3 = 0) or the v3
// block tiles (v3 = 1).  Writes vals [b, c] f32, idx [b, c] int32 (v2
// doc indices, v3 rows) and aux [b] (v2: int32 flags; v3: f32 bound).
// scratch: svs_staged_finish_scratch's bytes (null when that is 0).
extern "C" int svs_staged_finish(const void* src, int b, int width, int v3,
                                 int c, int h2, void* vals, void* idx,
                                 void* aux, void* scratch, size_t scratch_bytes,
                                 void* stream) {
  Plan p;
  int dev = 0;
  const cudaError_t e = make_plan(b, width, v3, c, h2, &dev, &p);
  if (e != cudaSuccess) return (int)e;
  if (scratch_bytes < p.scratch || (p.scratch && !scratch)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = static_cast<const float*>(src);
  const auto v = static_cast<float*>(vals);
  const auto x = static_cast<int*>(idx);
  const auto w = static_cast<unsigned char*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  const int v3i = v3 ? 1 : 0;
  if (!p.sort_g && !p.keys_g) {
    return (int)launch<false, false>(p, dev, s, b, width, v3i, c, h2, v, x, aux, w, st);
  }
  if (p.sort_g && !p.keys_g) {
    return (int)launch<true, false>(p, dev, s, b, width, v3i, c, h2, v, x, aux, w, st);
  }
  if (!p.sort_g) {
    return (int)launch<false, true>(p, dev, s, b, width, v3i, c, h2, v, x, aux, w, st);
  }
  return (int)launch<true, true>(p, dev, s, b, width, v3i, c, h2, v, x, aux, w, st);
}
