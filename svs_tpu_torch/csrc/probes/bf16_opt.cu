// P8 (benchmarks/tpu_bf16_opt.py, make_kern's kern :42) at the output
// block PROBE_BLOCK_N (8192 or 4096 docs): mm and v3 without the clip (the
// keyed v3 emit, V3Keys), contraction chunk 128 (2 stages of 64 columns
// per wgmma run) or 256 (4 stages).  Compiled once per block (probes.cuh).
#include "probes.cuh"

#ifndef PROBE_BLOCK_N
#error "bf16_opt.cu is compiled with -DPROBE_BLOCK_N=8192 or 4096"
#endif

namespace svs {
namespace probes {

namespace {

template <int BLOCK_N, int GROUP>
cudaError_t bf16_variant(int variant, const void* q, const void* docs, int b,
                         int n, int d, int n_valid, float* out,
                         cudaStream_t st) {
  switch (variant) {
    case 0:
      return launch_tile<false, Variant<kEmitFirstSums, false, false, BLOCK_N, GROUP>>(
          q, nullptr, docs, nullptr, b, n, d, n_valid, out, st);
    case 1:
      return launch_tile<false, V3Keys<false, BLOCK_N, GROUP>>(
          q, nullptr, docs, nullptr, b, n, d, n_valid, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

template <int BLOCK_N>
cudaError_t bf16_opt(int variant, int chunk, const void* q, const void* docs,
                     int b, int n, int d, int n_valid, float* out,
                     cudaStream_t st) {
  switch (chunk_group(chunk, 2)) {
    case 2:
      return bf16_variant<BLOCK_N, 2>(variant, q, docs, b, n, d, n_valid, out, st);
    case 4:
      return bf16_variant<BLOCK_N, 4>(variant, q, docs, b, n, d, n_valid, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template cudaError_t bf16_opt<PROBE_BLOCK_N>(int, int, const void*,
                                             const void*, int, int, int, int,
                                             float*, cudaStream_t);

}  // namespace probes
}  // namespace svs
