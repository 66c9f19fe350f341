// P6 (benchmarks/tpu_select10.py, make_variant's kernel :106 and its emit
// :91) on the production v3 core: the guarded prototypes at subtile 512,
// top H = 2 or 3 keys floor((clip(s, -3, 3) + KEY_BIAS) * 8192) * 512 +
// lane per subtile, the guard (the max of the block's H-th keys) at lane
// 16 H, the rest of each 8192-doc block's 128 lanes KEY_DEAD; the script's
// contraction chunk of 128 bf16 columns (2 stages per wgmma run).  The
// subtile's two 256-doc chunks merge as the production v2 and v3 do
// (select_chunk).
// Bound: the corpus read once (0.94 ms at B = 256 on 1,015,808 x 1536).
#include "probes.cuh"

namespace svs {
namespace probes {

namespace {

template <int H>
using Guarded512 = fused3::KeyedVariant<512, H, 13, true, true, 0, false, 8192, 2>;

}  // namespace

cudaError_t select10_guarded(int h, const void* q, const void* docs, int b,
                             int n, int d, int n_valid, float* out,
                             cudaStream_t st) {
  switch (h) {
    case 2:
      return launch_tile<false, Guarded512<2>>(q, nullptr, docs, nullptr, b, n,
                                               d, n_valid, out, st);
    case 3:
      return launch_tile<false, Guarded512<3>>(q, nullptr, docs, nullptr, b, n,
                                               d, n_valid, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace probes
}  // namespace svs
