// P7's deferred emit (benchmarks/tpu_select11.py, _deferred_kernel :145,
// call :251) on the H100: the emit of one chunk overlapped with the product
// of the next, through a ping-pong of two consumer warpgroups.
//
// On the TPU the probe keeps two accumulators and emits block j - 1's
// subtile s at block j's contraction step s, so that the VPU's emit runs
// beside the MXU's product.  The v3 core here (fused3.cuh) multiplies a
// chunk with all its consumer warps and then selects with all of them, so
// within a block the product and the emit never overlap.  This kernel
// gives each of two consumer warpgroups an accumulator of its own: while
// one runs wgmma on chunk c + 1, the other writes chunk c's keys and
// selects them.  The products stay in order through a pair of named
// barriers, as CUTLASS's ping-pong schedule orders its warpgroups' math:
// warpgroup c % 2 waits on barrier 4 + c % 2 before chunk c's product and,
// once it has it, arrives on the other one's.
//
// Deferring by chunk and not by 4096-doc block is free: a block's tile is
// the same whichever order its subtiles' keys are selected in.  The tile is
// bit for bit the same-step kernel's (select11_steps.cu, tpu_select11.py
// :417-426): each score is the same run of m64nQTk16 wgmma from zero over 2
// stages (the probe's contraction chunk of 128 columns), added to the f32
// total with one round-to-nearest add, and the selection is exact (the top
// 4 distinct keys of a subtile are the top 4 of the union of any parts'
// top 4).
//
// Geometry.  A block owns one 1024-doc subtile x QT queries, as the v3
// core's, in 8 chunks of 128 docs (not 4 of 256): a warpgroup holds a
// whole chunk's accumulators, 2 m64 tiles x QT queries, and bf16 keeps a
// partial of the same size beside them (at QT = 64, 128 registers a
// thread; 256 docs would need all 255).  The producer warp fills a
// 6-stage ring (a stage: 128 doc rows and the QT query rows of one
// 128-byte column slice) in the chunks' order; warpgroup w takes the
// chunks c = w, w + 2, ... and releases each stage as its wgmma complete.
// Each warpgroup writes its chunk's keys to a key buffer of its own and
// merges their top-4 per query row into a running list of its own (its 4
// warps, 16 rows each, select_chunk); at the end both lists of a row merge
// into the subtile's 4 keys, and their tail goes to the guard lane with an
// atomic max (the wrapper pre-fills KEY_DEAD).
#include "probes.cuh"

namespace svs {
namespace probes {

namespace {

using fused3::kSliceBytes;
using fused::kV3H;
using fused::kV3SubDocs;

constexpr int kPpDocs = 128;                         // docs per chunk
constexpr int kPpChunks = kV3SubDocs / kPpDocs;      // 8
constexpr int kPpStages = 6;
constexpr int kPpWarps = 8;                          // two warpgroups
constexpr int kPpTiles = kPpDocs / 64;               // m64 tiles: 2
constexpr int kPpPitch = kPpDocs + 4;  // query rows 2 apart, 8 banks apart
constexpr int kPpDocStage = kPpDocs * kSliceBytes;   // 16 KB
constexpr int kPpGroup = 2;  // stages per wgmma run: 128 bf16 columns
constexpr int kPpBlockN = 4096;

template <int QT>
__host__ __device__ constexpr int pp_stage_bytes() {
  return kPpDocStage + QT * kSliceBytes;
}

// The ring, both key buffers [2][QT][kPpPitch], both running lists
// [2][QT][4], the mbarriers, and the slack that aligns the ring to 1024.
template <int QT>
struct PpSmem {
  static constexpr int kKeys = kPpStages * pp_stage_bytes<QT>();
  static constexpr int kRun = kKeys + 2 * QT * kPpPitch * 4;
  static constexpr int kBars = kRun + 2 * QT * kV3H * 4;
  static constexpr int kBytes = kBars + 2 * kPpStages * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Named barriers (0 is __syncthreads): both warpgroups; warpgroup w
// alone; warpgroup w's turn to multiply.
constexpr int kBarBoth = 1, kBarGroup = 2, kBarTurn = 4;

template <int QT>
__global__ void __launch_bounds__((kPpWarps + 1) * 32, 1)
    pingpong_kernel(const __grid_constant__ CUtensorMap dmap,
                    const __grid_constant__ CUtensorMap qmap, int b,
                    int d_bytes, int n_valid, int out_cols,
                    float* __restrict__ out) {
  constexpr int R = QT / 2;
  constexpr int MT = kPpTiles;
  using L = PpSmem<QT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* const ring = smem_raw + pad;
  float* const keys = reinterpret_cast<float*>(ring + L::kKeys);
  float* const run = reinterpret_cast<float*>(ring + L::kRun);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + L::kBars);
  uint64_t* const empty = full + kPpStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QT;
  const int doc0 = blockIdx.y * kV3SubDocs;
  const int nslices = d_bytes / kSliceBytes;  // a multiple of kPpGroup
  if (tid == 0) {
    for (int i = 0; i < kPpStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // one warpgroup's warps release a stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kPpWarps) {
    // every slice of the 8 chunks, in the chunks' order (slot c * nslices
    // + k); the first lap passes its empty-waits at once
    if (lane == 0) {
      int slot = 0;
      for (int c = 0; c < kPpChunks; ++c) {
        for (int k = 0; k < nslices; ++k, ++slot) {
          const int st = slot % kPpStages;
          const uint32_t phase = (uint32_t)(slot / kPpStages) & 1u;
          mbar_wait(empty + st, phase ^ 1u);
          unsigned char* stage = ring + st * pp_stage_bytes<QT>();
          fused3::mbar_expect_tx(full + st, pp_stage_bytes<QT>());
          fused3::tma_tile(stage, &dmap, k * (kSliceBytes / 2), doc0 + c * kPpDocs,
                           full + st);
          fused3::tma_tile(stage + kPpDocStage, &qmap, k * (kSliceBytes / 2), q0,
                           full + st);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3;
  const int doc_w = wl * 16 + (lane >> 2);  // + 64 mt + 8 h
  float* const my_keys = keys + wg * QT * kPpPitch;
  float* const my_run = run + wg * QT * kV3H;
  const int live = min(max(n_valid - doc0, 0), kV3SubDocs);

  for (int c = wg; c < kPpChunks; c += 2) {
    // chunk c - 1's product (the other warpgroup's) is done: the slices of
    // every earlier chunk have been filled and read, so this warpgroup's
    // parity waits below cannot lag a lap behind
    if (c > 0) named_sync(kBarTurn + wg, 2 * 128);
    float acc[MT][R];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[mt][i] = 0.0f;
    for (int k = 0; k < nslices; k += kPpGroup) {
      float part[MT][R];
#pragma unroll
      for (int i = 0; i < kPpGroup; ++i) {
        const int slot = c * nslices + k + i;
        const int st = slot % kPpStages;
        mbar_wait(full + st, (uint32_t)(slot / kPpStages) & 1u);
        const uint32_t a0 = smem_u32(ring + st * pp_stage_bytes<QT>());
        const uint32_t b0 = a0 + kPpDocStage;
        if (i > 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fused3::fence_regs(part[mt]);
        }
        fused3::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSliceBytes / 32; ++kk)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            fused3::wgmma_bf16<QT>(
                part[mt], fused3::sw128_desc(a0 + mt * 64 * kSliceBytes + kk * 32),
                fused3::sw128_desc(b0 + kk * 32), (i | kk) != 0);
          }
        fused3::wgmma_commit();
        if (i > 0) {
          fused3::wgmma_wait<1>();  // the slice before has been read
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + (slot - 1) % kPpStages);
        }
      }
      fused3::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (c * nslices + k + kPpGroup - 1) % kPpStages);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fused3::fence_regs(part[mt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[mt][i] = __fadd_rn(acc[mt][i], part[mt][i]);
    }
    // the other warpgroup may multiply chunk c + 1 while this one emits c
    if (c + 1 < kPpChunks) named_arrive(kBarTurn + (wg ^ 1), 2 * 128);

    named_sync(kBarGroup + wg, 128);  // this group's last select has read my_keys
    const int lane0 = c * kPpDocs;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int doc = doc_w + 64 * mt + 8 * h;
        const int l = lane0 + doc;
#pragma unroll
        for (int j = 0; j < QT / 8; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            my_keys[(8 * j + 2 * (lane & 3) + cc) * kPpPitch + doc] =
                l < live ? v3_key(acc[mt][4 * j + 2 * h + cc], l) : kKeyDead;
          }
      }
    named_sync(kBarGroup + wg, 128);
#pragma unroll 1
    for (int q = wl; q < QT && q0 + q < b; q += 4) {
      fused::select_chunk<kPpDocs, kV3H, true>(my_keys + q * kPpPitch,
                                               my_run + q * kV3H, c == wg, false,
                                               lane, nullptr, nullptr);
    }
  }

  // both lists of a row -> the subtile's 4 keys, its tail -> the guard
  named_sync(kBarBoth, kPpWarps * 32);
#pragma unroll 1
  for (int q = warp; q < QT && q0 + q < b; q += kPpWarps) {
    if (lane != 0) continue;
    float r0[kV3H], r1[kV3H], m[kV3H];
#pragma unroll
    for (int h = 0; h < kV3H; ++h) {
      r0[h] = run[q * kV3H + h];
      r1[h] = run[(QT + q) * kV3H + h];
    }
#pragma unroll
    for (int h = 0; h < kV3H; ++h) {
      const float x = fmaxf(r0[0], r1[0]);
      m[h] = x;
      const bool from0 = r0[0] == x, from1 = r1[0] == x;
      if (from0) fused::pop_head(r0);
      if (from1) fused::pop_head(r1);
    }
    float* tile = out + (size_t)(q0 + q) * out_cols + (size_t)(doc0 / kPpBlockN) * 128;
    reinterpret_cast<float4*>(tile + ((doc0 % kPpBlockN) / kV3SubDocs) * kV3H)[0] =
        make_float4(m[0], m[1], m[2], m[3]);
    atomic_max_float(tile + (kPpBlockN / kV3SubDocs) * kV3H, m[kV3H - 1]);
  }
}

template <int QT>
cudaError_t launch_pingpong(const void* q, const void* docs, int b, int n,
                            int d, int n_valid, float* out, cudaStream_t st) {
  CUtensorMap dmap, qmap;
  cudaError_t err = fused3::tile_map(&dmap, docs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     2, n, d, kPpDocs);
  if (err == cudaSuccess) {
    err = fused3::tile_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, d, QT);
  }
  constexpr int smem = PpSmem<QT>::kBytes;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(pingpong_kernel<QT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, n / kV3SubDocs);
  pingpong_kernel<QT><<<grid, (kPpWarps + 1) * 32, smem, st>>>(
      dmap, qmap, b, d * 2, n_valid, (n / kPpBlockN) * 128, out);
  return cudaGetLastError();
}

}  // namespace

cudaError_t select11_deferred(const void* q, const void* docs, int b, int n,
                              int d, int n_valid, float* out, cudaStream_t st) {
  if (n % kPpBlockN != 0 || (d * 2) % (kPpGroup * kSliceBytes) != 0) {
    return cudaErrorInvalidValue;
  }
  switch (fused3::query_tile(b)) {
    case 16:
      return launch_pingpong<16>(q, docs, b, n, d, n_valid, out, st);
    case 32:
      return launch_pingpong<32>(q, docs, b, n, d, n_valid, out, st);
    default:
      return launch_pingpong<64>(q, docs, b, n, d, n_valid, out, st);
  }
}

}  // namespace probes
}  // namespace svs
