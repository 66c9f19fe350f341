// P5 (benchmarks/tpu_select9.py) on the production v3 core: kern_v2 (:97),
// the keyed v2 emit of the v3 prototype's shootout, also P4's "current"
// (tpu_select8.py emit_current :40): per 512-doc subtile the top 8 keys
// floor((s + KEY_BIAS) * 8192) * 512 + lane, no clip and no guard, 16
// subtiles' 8 keys filling each 8192-doc block's 128 lanes, at the script's
// contraction chunk of 128 bf16 columns (2 stages per wgmma run).  Its
// kern_v3 and kern_mm are P8's v3 and mm128 instances (bf16_opt.cu).
//
// Bound: the corpus read once (3.1 GB bf16 at 1,015,808 x 1536: 0.94 ms at
// 3.35 TB/s); the emit between chunks and the product's own shape (measured
// in PERF.md) keep it above that.
#include "probes.cuh"

namespace svs {
namespace probes {

using V2Keys = fused3::KeyedVariant<512, 8, 13, false, false, 0, false, 8192, 2>;

cudaError_t select9_v2(const void* q, const void* docs, int b, int n, int d,
                       int n_valid, float* out, cudaStream_t st) {
  return launch_tile<false, V2Keys>(q, nullptr, docs, nullptr, b, n, d,
                                    n_valid, out, st);
}

}  // namespace probes
}  // namespace svs
