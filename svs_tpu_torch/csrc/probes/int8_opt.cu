// P9 (benchmarks/tpu_int8_opt.py, make_kern's kern :48): mm, v3 without
// the clip (the keyed v3 emit, V3Keys) and v3dq, at the contraction chunk
// PROBE_GROUP gives (128-byte stages per wgmma run: 1 = chunk 128, the
// production grouping; 2 = chunk 256).  Compiled once per group
// (probes.cuh).
#include "probes.cuh"

#ifndef PROBE_GROUP
#error "int8_opt.cu is compiled with -DPROBE_GROUP=1 or 2"
#endif

namespace svs {
namespace probes {

template <int GROUP>
cudaError_t int8_opt(int variant, const void* q, const float* qs,
                     const void* docs, const float* rs, int b, int n, int d,
                     int n_valid, float* out, cudaStream_t st) {
  switch (variant) {
    case 0:
      return launch_tile<true, Variant<kEmitFirstSums, false, false, 8192, GROUP>>(
          q, qs, docs, rs, b, n, d, n_valid, out, st);
    case 1:
      return launch_tile<true, V3Keys<false, 8192, GROUP>>(
          q, qs, docs, rs, b, n, d, n_valid, out, st);
    case 2:
      return launch_tile<true, Variant<kEmitSelect, false, true, 8192, GROUP>>(
          q, qs, docs, rs, b, n, d, n_valid, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template cudaError_t int8_opt<PROBE_GROUP>(int, const void*, const float*,
                                           const void*, const float*, int,
                                           int, int, int, float*,
                                           cudaStream_t);

}  // namespace probes
}  // namespace svs
