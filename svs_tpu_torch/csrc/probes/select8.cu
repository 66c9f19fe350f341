// P4 (benchmarks/tpu_select8.py, make_kernel :120) on the production v3
// core: the keyed v2 kernel's swappable emits at the script's contraction
// chunk of 128 bf16 columns (2 stages per wgmma run), 8192-doc blocks, no
// clip, no guard (its "current" is select9.cu's v2, "matmul" P8's mm128):
// - hier (emit_hier :49): current's keys bit for bit, by a fold of the four
//   128-lane quarters of each 512-doc subtile per pass (KeyedVariant FOLD:
//   one warp holds the subtile's 512 keys of a query row);
// - h6g128 (emit_h6g128 :63): top 6 per 128-doc group at 2^13, lane field
//   128: 24 lanes per 512 docs, 384 a block;
// - h8g256 (emit_h8g256 :77): top 8 per 256-doc group at 2^13, lane field
//   256: 256 lanes a block;
// - h8g1024 (emit_h8g1024 :88): top 8 per 1024 docs at 2^12, lane field
//   1024, then 8 KEY_DEAD lanes: 16 per group, 128 a block.
// Bound: as select9.cu (the corpus read once; the wider tiles add 12 / 8
// bytes per 1024 docs and query).
#include "probes.cuh"

namespace svs {
namespace probes {

namespace {

template <int SUB, int H, int QS_LOG2, int PAD, bool FOLD>
using P4Keys = fused3::KeyedVariant<SUB, H, QS_LOG2, false, false, PAD, FOLD, 8192, 2>;

}  // namespace

cudaError_t select8_emit(int emit, const void* q, const void* docs, int b,
                         int n, int d, int n_valid, float* out,
                         cudaStream_t st) {
  switch (emit) {
    case 1:
      return launch_tile<false, P4Keys<512, 8, 13, 0, true>>(
          q, nullptr, docs, nullptr, b, n, d, n_valid, out, st);
    case 2:
      return launch_tile<false, P4Keys<128, 6, 13, 0, false>>(
          q, nullptr, docs, nullptr, b, n, d, n_valid, out, st);
    case 3:
      return launch_tile<false, P4Keys<256, 8, 13, 0, false>>(
          q, nullptr, docs, nullptr, b, n, d, n_valid, out, st);
    case 4:
      return launch_tile<false, P4Keys<1024, 8, 12, 8, false>>(
          q, nullptr, docs, nullptr, b, n, d, n_valid, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace probes
}  // namespace svs
