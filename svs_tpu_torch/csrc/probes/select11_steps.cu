// P7 (benchmarks/tpu_select11.py) on the production v3 core: the same-step
// emit at block 4096 (_same_step_kernel :105; the clip to [-3, 3], 16 keys
// and the guard at lane 16 per 4096-doc block, every other lane KEY_DEAD:
// the keyed v3 emit, V3Keys) and the matmul-only floor
// (matmul_floor_blocked's kern :332: lane 0 the max score of each 8192- or
// 4096-doc block, the others 0), both at the probe's contraction chunk of
// 128 bf16 columns (2 stages per wgmma run).
#include "probes.cuh"

namespace svs {
namespace probes {

cudaError_t select11_same_step(const void* q, const void* docs, int b, int n,
                               int d, int n_valid, float* out,
                               cudaStream_t st) {
  return launch_tile<false, V3Keys<true, 4096, 2>>(
      q, nullptr, docs, nullptr, b, n, d, n_valid, out, st);
}

cudaError_t select11_floor(int block_n, const void* q, const void* docs, int b,
                           int n, int d, float* out, cudaStream_t st) {
  switch (block_n) {
    case 8192:
      return launch_tile<false, Variant<kEmitBlockMax, true, false, 8192, 2>>(
          q, nullptr, docs, nullptr, b, n, d, n, out, st);
    case 4096:
      return launch_tile<false, Variant<kEmitBlockMax, true, false, 4096, 2>>(
          q, nullptr, docs, nullptr, b, n, d, n, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace probes
}  // namespace svs
