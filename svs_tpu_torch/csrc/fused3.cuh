// The core of the fused prescore kernels of fused_int8.cu and fused_float.cu
// (svs_tpu/ops/pallas_extract.py): the guarded v3 ones (mode 3:
// _fused3_int8_kernel, _fused3_kernel) and v1 (mode 1: _fused_int8_kernel,
// _fused_kernel) at every batch, the keyed v2 ones (mode 2:
// _fused2_int8_kernel, _fused2_kernel) at 9 <= B <= 256, each with its
// chunked emit of fused_emit.cuh.  The design and its bounds are in the
// headers of those two files.
//
// One CUDA block owns 1024 docs (one v3 subtile, two v2 subtiles) x a tile
// of QT (16, 32 or 64) queries, query tiles fastest over the grid.  Its
// warps:
// - a producer warp, whose lane 0 streams the block's data through a
//   kStages ring in shared memory: per stage, one 128-byte column slice of
//   256 doc rows and of the QT query rows, each one 2-D TMA tile load
//   (tensor map, 128-byte swizzle) completing on the stage's "full"
//   mbarrier.  It refills a stage once all consumer warps have arrived on
//   its "empty" mbarrier, so the next slices land while the current one is
//   multiplied, also across the emit between chunks;
// - 16 (int8, bf16: fused3_mma_kernel, four warpgroups on wgmma) or 8
//   (f32: fused3_f32_kernel) consumer warps that multiply one chunk of 256
//   docs x QT queries, write the chunk's keys (mode 3: v3 keys, mode 2: v2
//   keys, mode 1: the f32 scores, -inf past the live lanes) to shared
//   memory, and select and merge per query row (select_chunk: the top-4 of
//   a 1024-doc subtile over 4 chunks, or the top-8 of a 512-doc subtile
//   over 2; select_chunk_v1: the top-8 (value, row) of a 512-doc subtile
//   over 2), 4 chunks per block.
// The swizzle puts 16-byte column c of tile row r at c ^ (r % 8): the
// K-major layout wgmma reads through its descriptors, and one in which 8
// consecutive rows at one column fill all 32 banks, so the f32 kernel's
// 16-byte loads read conflict-free.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "fused_emit.cuh"

namespace svs {
namespace fused3 {

using fused::kFusedBlockN;
using fused::kGuardKeys;
using fused::kGuardOutLanes;
using fused::kV3SubDocs;

constexpr int kChunkDocs = 256;                  // docs per accumulator chunk
constexpr int kChunks = kV3SubDocs / kChunkDocs;  // 4
constexpr int kSliceBytes = 128;                  // row bytes per ring stage
constexpr int kStages = 3;
// Consumer warps of the f32 kernel (a 64-register block each); the
// tensor-core kernels' are kMmaWarps below.
constexpr int kFfmaWarps = 8;
constexpr int kDocStageBytes = kChunkDocs * kSliceBytes;  // 32 KB

template <int QT>
__host__ __device__ constexpr int stage_bytes() {
  return kDocStageBytes + QT * kSliceBytes;
}

// The emit of a mode: what a subtile is, its list length H, the words of
// its running list per query row (kRun), its key and dead-lane marker.
template <int MODE>
struct Select;
template <>
struct Select<3> {  // v3: top-4 per 1024-doc subtile, one guard lane a block
  static constexpr int kH = fused::kV3H, kSubDocs = fused::kV3SubDocs;
  static constexpr int kRun = kH;
  __device__ __forceinline__ static float key(float s, int lane) {
    return v3_key(s, lane);
  }
  __device__ __forceinline__ static float dead() { return kKeyDead; }
};
template <>
struct Select<2> {  // v2: top-8 per 512-doc subtile
  static constexpr int kH = fused::kV2H, kSubDocs = fused::kV2SubDocs;
  static constexpr int kRun = kH;
  __device__ __forceinline__ static float key(float s, int lane) {
    return v2_key(s, lane);
  }
  __device__ __forceinline__ static float dead() { return kKeyDead; }
};
template <>
struct Select<1> {  // v1: top-8 values + rows per 512-doc subtile
  static constexpr int kH = fused::kV1H, kSubDocs = fused::kV1SubDocs;
  static constexpr int kRun = 2 * kH;  // values, then rows
  __device__ __forceinline__ static float key(float s, int) { return s; }
  __device__ __forceinline__ static float dead() { return -INFINITY; }
};

// Dynamic shared memory of a block: the ring, the chunk's keys [QT][PITCH]
// f32, the running lists [QT][RUN] (RUN = Select<MODE>::kRun words), the
// mbarriers; plus the slack that aligns the ring to 1024 bytes (the
// 128-byte swizzle's period).  At QT = 64 and RUN = 16 (v1) that is 190 KB
// of the 227 KB a block may have.
template <int QT, int PITCH, int RUN>
struct Smem {
  static constexpr int kKeys = kStages * stage_bytes<QT>();
  static constexpr int kRun = kKeys + QT * PITCH * 4;
  static constexpr int kBars = kRun + QT * RUN * 4;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// --- TMA: 2-D tile loads through a tensor map ----------------------------

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// The box of `map` at element column x, row y -> dst; completes on bar.
// Rows or columns past the tensor's edge arrive as zeros (and count).
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A tensor map of the row-major [rows, cols] matrix at `base` (elements of
// elem_bytes), loaded in boxes of box_rows rows x 128 bytes with the
// 128-byte swizzle.  cuTensorMapEncodeTiled is looked up through the
// runtime, so the library links no libcuda.
inline cudaError_t tile_map(CUtensorMap* map, const void* base,
                            CUtensorMapDataType type, int elem_bytes,
                            int rows, int cols, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (rc != cudaSuccess) return rc;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(kSliceBytes / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --- the block's skeleton --------------------------------------------------

struct Block {
  unsigned char* ring;  // kStages stages, 1024-aligned
  float* keys;          // [QT][PITCH]
  float* run;           // [QT][RUN]
  uint64_t* full;       // [kStages]
  uint64_t* empty;      // [kStages]
};

template <int QT, int PITCH, int RUN>
__device__ __forceinline__ Block block_smem(unsigned char* raw) {
  using L = Smem<QT, PITCH, RUN>;
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  unsigned char* base = raw + pad;
  Block s;
  s.ring = base;
  s.keys = reinterpret_cast<float*>(base + L::kKeys);
  s.run = reinterpret_cast<float*>(base + L::kRun);
  s.full = reinterpret_cast<uint64_t*>(base + L::kBars);
  s.empty = s.full + kStages;
  return s;
}

// Producer (one thread): every slice of the 4 chunks, in the consumers'
// order.  The first lap of the ring passes its empty-waits at once (a
// fresh barrier's "previous" phase counts as complete).
template <int QT>
__device__ __forceinline__ void produce(const Block& s, const CUtensorMap* dmap,
                                        const CUtensorMap* qmap, int doc0,
                                        int q0, int nslices, int slice_elems) {
  int st = 0;
  uint32_t phase = 0;
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    for (int k = 0; k < nslices; ++k) {
      mbar_wait(s.empty + st, phase ^ 1u);
      unsigned char* stage = s.ring + st * stage_bytes<QT>();
      mbar_expect_tx(s.full + st, stage_bytes<QT>());
      tma_tile(stage, dmap, k * slice_elems, doc0 + chunk * kChunkDocs,
               s.full + st);
      tma_tile(stage + kDocStageBytes, qmap, k * slice_elems, q0, s.full + st);
      if (++st == kStages) {
        st = 0;
        phase ^= 1u;
      }
    }
  }
}

// A barrier of the WARPS consumer warps alone (the producer never joins).
template <int WARPS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");
}

// Thread 0: the ring's barriers ("full": the producer's expect_tx, then
// the bytes; "empty": one arrival per consumer warp).
template <int WARPS>
__device__ __forceinline__ void init_ring(const Block& s) {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(s.full + i, 1);
    mbar_init(s.empty + i, WARPS);
  }
  mbar_init_fence();
}

// A consumer warp's walk of the ring: acquire() waits for the next slice
// and returns its stage, release() hands the stage back to the producer.
template <int QT>
struct Ring {
  int st = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ const unsigned char* acquire(const Block& s) {
    mbar_wait(s.full + st, phase);
    return s.ring + st * stage_bytes<QT>();
  }
  __device__ __forceinline__ void release(const Block& s, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(s.empty + st);
    if (++st == kStages) {
      st = 0;
      phase ^= 1u;
    }
  }
};

// A chunk's place in the block: its subtile, the subtile's lanes before
// the chunk, and the subtile's live lanes (clip(n_valid - start, 0, sub)).
template <int MODE>
struct ChunkPos {
  static constexpr int kPer = Select<MODE>::kSubDocs / kChunkDocs;
  int sub, lane0, live;
  __device__ __forceinline__ ChunkPos(int chunk, int doc0, int n_valid)
      : sub(chunk / kPer),
        lane0((chunk % kPer) * kChunkDocs),
        live(min(max(n_valid - doc0 - sub * Select<MODE>::kSubDocs, 0),
                 Select<MODE>::kSubDocs)) {}
  // the key of score s of chunk doc `doc`, or the dead marker past the
  // live lanes (KEY_DEAD; v1: -inf)
  __device__ __forceinline__ float key(float s, int doc) const {
    const int lane = lane0 + doc;
    return lane < live ? Select<MODE>::key(s, lane) : Select<MODE>::dead();
  }
};

// After a chunk's keys are in s.keys: each warp selects the query rows
// warp, warp + WARPS, ... (below b) and merges them into the subtile's
// lists; the subtile's last chunk writes them out (mode 3: 4 keys at the
// subtile's place in its block's 128 lanes, and the guard lane; mode 2: 8
// keys at column (row0 / 512) * 8; mode 1: 8 values there in out and
// their rows there in out1).
template <int MODE, int QT, int PITCH, int WARPS>
__device__ __forceinline__ void select_rows(const Block& s, int chunk,
                                            int warp, int lane, int q0, int b,
                                            int doc0, int out_cols,
                                            float* __restrict__ out,
                                            float* __restrict__ out1) {
  using Sel = Select<MODE>;
  constexpr int kPer = ChunkPos<MODE>::kPer;
  const int sub = chunk / kPer, part = chunk % kPer;
#pragma unroll 1
  for (int q = warp; q < QT && q0 + q < b; q += WARPS) {
    const size_t row = (size_t)(q0 + q) * out_cols;
    const float* keys = s.keys + q * PITCH;
    float* run = s.run + q * Sel::kRun;
    if constexpr (MODE == 3) {
      float* tile = out + row + (size_t)(doc0 / kFusedBlockN) * kGuardOutLanes;
      fused::select_chunk<kChunkDocs, Sel::kH, true>(
          keys, run, part == 0, part == kPer - 1, lane,
          tile + ((doc0 % kFusedBlockN) / kV3SubDocs) * Sel::kH,
          tile + kGuardKeys);
    } else {
      const size_t col = row + (size_t)(doc0 / Sel::kSubDocs + sub) * Sel::kH;
      if constexpr (MODE == 2) {
        fused::select_chunk<kChunkDocs, Sel::kH, false>(
            keys, run, part == 0, part == kPer - 1, lane, out + col, nullptr);
      } else {
        const int sub_row0 = doc0 + sub * Sel::kSubDocs;
        fused::select_chunk_v1<kChunkDocs, Sel::kH>(
            keys, run, part == 0, part == kPer - 1, doc0 + chunk * kChunkDocs,
            sub_row0 + Sel::kSubDocs - 1, lane, out + col, out1 + col);
      }
    }
  }
}

// --- int8 and bf16: tensor cores (wgmma) -----------------------------------

// d (+)= A . B on one warpgroup: A = 64 doc rows, B = N query rows, both
// 32 bytes of K from 128-byte-swizzled shared memory (descriptors).  d is
// the m64nN accumulator, N/2 registers a thread; accumulate = 0 starts it
// from zero.  s8 sums are exact int32; bf16 sums are f32.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t da,
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da,
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t da,
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da,
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle, as TMA writes it: 128-byte rows, 8-row groups 1024 bytes apart
// (the stride byte offset); the start address steps by 32 bytes of K
// inside the swizzle atom (the leading byte offset is unused here).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers in place around the asynchronous wgmma, so
// the compiler moves no read or write of them across it.
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Consumer warps of the tensor-core kernels: kMmaWarps / 4 warpgroups,
// each owning kMmaTiles m64 tiles of the chunk's docs x the QT queries.
// 16 warps (one tile each) rather than 8: the key emit and the selection
// between chunks weigh more in a block's time than the tensor cores do,
// and more warps hide their latencies (at 8 warps the kernel is slower).
constexpr int kMmaWarps = 16;
constexpr int kMmaTiles = kChunkDocs / 64 / (kMmaWarps / 4);

// Key pitch of the tensor-core kernels: query rows 2 apart (the
// accumulator's column pairs) land 8 banks apart, so a warp's key stores
// do not conflict.
constexpr int kMmaPitch = kChunkDocs + 4;

// One block: kInt8 -> int8 docs and queries (s8 wgmma, exact int32 sums,
// rescaled at the emit); else bf16 (bf16 wgmma, f32 sums).  Warpgroup g
// owns docs 64 T g + [0, 64 T) of the chunk as T = kMmaTiles m64 tiles;
// per 128-byte slice it issues 4 k steps x T tiles of m64nQTk32 (bytes),
// reading both operands straight from the swizzled stage, then waits for
// them and releases the stage.  Accumulator register 4j + r of m-tile mt
// holds doc 64 (T g + mt) + 16w + lane/4 + 8(r/2) and query 8j + 2(lane%4)
// + r%2, w the warp in its group.
template <bool kInt8, int QT, int MODE>
__global__ void __launch_bounds__((kMmaWarps + 1) * 32, 1)
    fused3_mma_kernel(const __grid_constant__ CUtensorMap dmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const float* __restrict__ rs,
                      const float* __restrict__ qs, int b, int d_bytes,
                      int n_valid, int out_cols, float* __restrict__ out,
                      float* __restrict__ out1) {
  constexpr int R = QT / 2;  // accumulator registers per m64 tile
  constexpr int MT = kMmaTiles;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  const Block s = block_smem<QT, kMmaPitch, Select<MODE>::kRun>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QT;
  const int doc0 = blockIdx.y * kV3SubDocs;
  const int nslices = (d_bytes + kSliceBytes - 1) / kSliceBytes;
  if (tid == 0) init_ring<kMmaWarps>(s);
  __syncthreads();
  if (warp == kMmaWarps) {
    if (lane == 0) {
      produce<QT>(s, &dmap, &qmap, doc0, q0, nslices,
                  kInt8 ? kSliceBytes : kSliceBytes / 2);
    }
    return;
  }
  const int group = warp >> 2;
  const int doc_w = group * MT * 64 + (warp & 3) * 16 + (lane >> 2);

  Ring<QT> ring;
  Acc acc[MT][R];
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    if constexpr (!kInt8) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[mt][i] = 0.0f;
    }
    for (int k = 0; k < nslices; ++k) {
      const uint32_t stage = smem_u32(ring.acquire(s));
      const uint32_t a0 = stage + group * MT * 64 * kSliceBytes;
      const uint32_t b0 = stage + kDocStageBytes;
      if constexpr (kInt8) {
        // exact int32 sums over the whole chunk (zeroed by its first step)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSliceBytes / 32; ++kk)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            wgmma_s8<QT>(acc[mt],
                         sw128_desc(a0 + mt * 64 * kSliceBytes + kk * 32),
                         sw128_desc(b0 + kk * 32), (k | kk) != 0);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
      } else {
        // the slice's 64 products are summed on the tensor cores from
        // zero, then added to the total with one round-to-nearest add (see
        // fused_float.cu: what this does to the error)
        Acc part[MT][R];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSliceBytes / 32; ++kk)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            wgmma_bf16<QT>(part[mt],
                           sw128_desc(a0 + mt * 64 * kSliceBytes + kk * 32),
                           sw128_desc(b0 + kk * 32), kk != 0);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(part[mt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < R; ++i) acc[mt][i] = __fadd_rn(acc[mt][i], part[mt][i]);
      }
      ring.release(s, lane);
    }

    // keys of the chunk -> shared memory (after every warp's last read of
    // the previous chunk's keys)
    const ChunkPos<MODE> pos(chunk, doc0, n_valid);
    consumers_sync<kMmaWarps>();
    float qscale[QT / 8][2];
    if constexpr (kInt8) {
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = q0 + 8 * j + 2 * (lane & 3) + c;
          qscale[j][c] = q < b ? qs[q] : 0.0f;
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int doc = doc_w + 64 * mt + 8 * h;
        const float r_scale = kInt8 ? rs[doc0 + chunk * kChunkDocs + doc] : 0.0f;
#pragma unroll
        for (int j = 0; j < QT / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const Acc a = acc[mt][4 * j + 2 * h + c];
            float sc;
            if constexpr (kInt8) {
              // acc.astype(f32) * rs * qs, each product rounded on its own
              sc = __fmul_rn(__fmul_rn(__int2float_rn(a), r_scale),
                             qscale[j][c]);
            } else {
              sc = a;
            }
            s.keys[(8 * j + 2 * (lane & 3) + c) * kMmaPitch + doc] =
                pos.key(sc, doc);
          }
      }
    consumers_sync<kMmaWarps>();
    select_rows<MODE, QT, kMmaPitch, kMmaWarps>(s, chunk, warp, lane, q0, b,
                                                doc0, out_cols, out, out1);
  }
}

// --- f32: CUDA cores (true f32 fmaf, no TF32) -----------------------------

// 16 bytes of shared memory at a shared-window address (volatile: it must
// stay after the mbarrier wait that made the stage valid).
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Key pitch of the f32 kernel: query rows 1 apart land 8 banks apart.
constexpr int kFfmaPitch = kChunkDocs + 8;

// One block of f32 docs and queries.  Consumer warp (wq, wd) = (warp / 4,
// warp % 4) owns queries wq * QT/2 + [0, QT/2) x docs wd * 64 + [0, 64) of
// the chunk; lane (lq, ld) = (lane / 8, lane % 8) owns the TQ = QT/8
// queries wq * QT/2 + lq + 4i and the 8 docs wd * 64 + ld + 8j, a TQ x 8
// register block.  Per 4 columns it loads 8 + TQ 16-byte words (lanes that
// share a word get it broadcast) for 32 * TQ fmaf.
template <int QT, int MODE>
__global__ void __launch_bounds__((kFfmaWarps + 1) * 32, 1)
    fused3_f32_kernel(const __grid_constant__ CUtensorMap dmap,
                      const __grid_constant__ CUtensorMap qmap, int b,
                      int d_bytes, int n_valid, int out_cols,
                      float* __restrict__ out, float* __restrict__ out1) {
  constexpr int TQ = QT / 8;
  extern __shared__ unsigned char smem_raw[];
  const Block s = block_smem<QT, kFfmaPitch, Select<MODE>::kRun>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QT;
  const int doc0 = blockIdx.y * kV3SubDocs;
  const int nslices = (d_bytes + kSliceBytes - 1) / kSliceBytes;
  if (tid == 0) init_ring<kFfmaWarps>(s);
  __syncthreads();
  if (warp == kFfmaWarps) {
    if (lane == 0) {
      produce<QT>(s, &dmap, &qmap, doc0, q0, nslices, kSliceBytes / 4);
    }
    return;
  }

  const int wq = warp >> 2, wd = warp & 3, lq = lane >> 3, ld = lane & 7;
  // A tile row's swizzle is its row number mod 8: ld for every doc row of
  // the lane, lq ^ 4 (i & 1) for its query row i (QT / 2 is a multiple of
  // 8), so the row offsets below are immediates.
  const int d_base = (wd * 64 + ld) * kSliceBytes;
  const int q_base = kDocStageBytes + (wq * (QT / 2) + lq) * kSliceBytes;

  Ring<QT> ring;
  float acc[TQ][8];
  for (int chunk = 0; chunk < kChunks; ++chunk) {
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k = 0; k < nslices; ++k) {
      const uint32_t stage = smem_u32(ring.acquire(s));
#pragma unroll
      for (int c = 0; c < kSliceBytes / 16; ++c) {
        const uint32_t dp = stage + d_base + ((c ^ ld) << 4);
        // query row + 4i: its swizzle flips column bit 2 when i is odd
        const uint32_t qp[2] = {stage + q_base + ((c ^ lq) << 4),
                                stage + q_base + ((c ^ 4 ^ lq) << 4)};
        float4 dv[8], qv[TQ];
#pragma unroll
        for (int j = 0; j < 8; ++j) dv[j] = lds128(dp + j * 8 * kSliceBytes);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          qv[i] = lds128(qp[i & 1] + i * 4 * kSliceBytes);
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(qv[i].x, dv[j].x, acc[i][j]);
            acc[i][j] = fmaf(qv[i].y, dv[j].y, acc[i][j]);
            acc[i][j] = fmaf(qv[i].z, dv[j].z, acc[i][j]);
            acc[i][j] = fmaf(qv[i].w, dv[j].w, acc[i][j]);
          }
      }
      ring.release(s, lane);
    }

    const ChunkPos<MODE> pos(chunk, doc0, n_valid);
    consumers_sync<kFfmaWarps>();
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int doc = wd * 64 + ld + 8 * j;
        s.keys[(wq * (QT / 2) + lq + 4 * i) * kFfmaPitch + doc] =
            pos.key(acc[i][j], doc);
      }
    consumers_sync<kFfmaWarps>();
    select_rows<MODE, QT, kFfmaPitch, kFfmaWarps>(s, chunk, warp, lane, q0, b,
                                                  doc0, out_cols, out, out1);
  }
}

// --- host side --------------------------------------------------------------

template <bool kInt8, int QT, int MODE>
inline cudaError_t launch_mma_tile(const void* q, const float* qs,
                                   const void* docs, const float* rs, int b,
                                   int n, int d, int n_valid, float* out,
                                   float* out1, cudaStream_t stream) {
  const int elem = kInt8 ? 1 : 2;
  const CUtensorMapDataType type =
      kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap dmap, qmap;
  cudaError_t err = tile_map(&dmap, docs, type, elem, n, d, kChunkDocs);
  if (err == cudaSuccess) err = tile_map(&qmap, q, type, elem, b, d, QT);
  constexpr int smem = Smem<QT, kMmaPitch, Select<MODE>::kRun>::kBytes;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused3_mma_kernel<kInt8, QT, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, n / kV3SubDocs);
  fused3_mma_kernel<kInt8, QT, MODE>
      <<<grid, (kMmaWarps + 1) * 32, smem, stream>>>(
          dmap, qmap, rs, qs, b, d * elem, n_valid,
          fused::out_columns(MODE, n), out, out1);
  return cudaGetLastError();
}

template <int QT, int MODE>
inline cudaError_t launch_f32_tile(const void* q, const void* docs, int b,
                                   int n, int d, int n_valid, float* out,
                                   float* out1, cudaStream_t stream) {
  CUtensorMap dmap, qmap;
  cudaError_t err = tile_map(&dmap, docs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                             n, d, kChunkDocs);
  if (err == cudaSuccess) {
    err = tile_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, d, QT);
  }
  constexpr int smem = Smem<QT, kFfmaPitch, Select<MODE>::kRun>::kBytes;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused3_f32_kernel<QT, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, n / kV3SubDocs);
  fused3_f32_kernel<QT, MODE><<<grid, (kFfmaWarps + 1) * 32, smem, stream>>>(
      dmap, qmap, b, d * 4, n_valid, fused::out_columns(MODE, n), out, out1);
  return cudaGetLastError();
}

// The query tile: the smallest of 16, 32, 64 that holds the batch, else 64.
inline int query_tile(int b) { return b <= 16 ? 16 : b <= 32 ? 32 : 64; }

// Mode 3 (v3), 2 (v2) or 1 (v1) on int8 (kInt8) or bf16 storage.  Mode 3
// needs out pre-filled with KEY_DEAD; modes 2 and 1 write every column of
// their rows (mode 1: values in out, rows in out1; out1 unused otherwise).
template <bool kInt8, int MODE>
inline cudaError_t launch_mma(const void* q, const float* qs, const void* docs,
                              const float* rs, int b, int n, int d,
                              int n_valid, float* out, float* out1,
                              cudaStream_t stream) {
  switch (query_tile(b)) {
    case 16:
      return launch_mma_tile<kInt8, 16, MODE>(q, qs, docs, rs, b, n, d,
                                              n_valid, out, out1, stream);
    case 32:
      return launch_mma_tile<kInt8, 32, MODE>(q, qs, docs, rs, b, n, d,
                                              n_valid, out, out1, stream);
    default:
      return launch_mma_tile<kInt8, 64, MODE>(q, qs, docs, rs, b, n, d,
                                              n_valid, out, out1, stream);
  }
}

// Mode 3, 2 or 1 on f32 storage, out and out1 as for launch_mma.  (A
// template, so that only the file that launches it compiles the f32
// kernels.)
template <int MODE, typename T>
inline cudaError_t launch_f32(const T* q, const T* docs, int b, int n, int d,
                              int n_valid, float* out, float* out1,
                              cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "f32 storage only");
  switch (query_tile(b)) {
    case 16:
      return launch_f32_tile<16, MODE>(q, docs, b, n, d, n_valid, out, out1,
                                       stream);
    case 32:
      return launch_f32_tile<32, MODE>(q, docs, b, n, d, n_valid, out, out1,
                                       stream);
    default:
      return launch_f32_tile<64, MODE>(q, docs, b, n, d, n_valid, out, out1,
                                       stream);
  }
}

}  // namespace fused3
}  // namespace svs
