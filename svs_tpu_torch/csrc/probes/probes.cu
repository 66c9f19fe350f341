// The C interface of the probes' library (svs_tpu_torch/probes/common.py
// binds it).  Each launcher returns a cudaError_t as int.  Outputs are
// [b, (n / block_n) * lanes] f32 tiles (lanes 128 but for svs_probe_keyed's
// h6g128 and h8g256, 384 and 256); the caller pre-fills them: KEY_DEAD for
// the keyed variants (each subtile's keys are written, a guarded one's
// tail folded into the guard lane with an atomic max, padding and the
// lanes past the guard left), 0 with -inf in lane 0 of every tile for the
// blocked floor, nothing for mm (every lane written).
// Requires 0 < b <= 256, n a multiple of the block, d a multiple of the
// contraction chunk, 16-byte aligned operands.
#include "probes.cuh"

namespace {

bool shape_ok(int b, int n, int d, int block_n) {
  return b > 0 && b <= 256 && n > 0 && n % block_n == 0 && n / 1024 <= 65535 &&
         d > 0;
}

}  // namespace

// P9: variant 0 = mm, 1 = v3, 2 = v3dq (qs then holds qb = KEY_BIAS / qs
// and qq = 4096 * qs, b each); chunk 128 or 256 (int8 columns).
extern "C" int svs_probe_int8(int variant, int chunk, const void* q,
                              const void* qs, const void* docs, const void* rs,
                              int b, int n, int d, int n_valid, void* out,
                              void* stream) {
  if (!shape_ok(b, n, d, 8192) || d % chunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qsf = static_cast<const float*>(qs);
  const float* rsf = static_cast<const float*>(rs);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 128:
      return (int)svs::probes::int8_opt<1>(variant, q, qsf, docs, rsf, b, n, d,
                                           n_valid, o, st);
    case 256:
      return (int)svs::probes::int8_opt<2>(variant, q, qsf, docs, rsf, b, n, d,
                                           n_valid, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// P8: variant 0 = mm, 1 = v3 (no clip); chunk 128 or 256 (bf16 columns);
// block_n 8192 or 4096.
extern "C" int svs_probe_bf16(int variant, int chunk, int block_n,
                              const void* q, const void* docs, int b, int n,
                              int d, int n_valid, void* out, void* stream) {
  if (!shape_ok(b, n, d, block_n == 4096 ? 4096 : 8192) ||
      d % chunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 8192:
      return (int)svs::probes::bf16_opt<8192>(variant, chunk, q, docs, b, n, d,
                                              n_valid, o, st);
    case 4096:
      return (int)svs::probes::bf16_opt<4096>(variant, chunk, q, docs, b, n, d,
                                              n_valid, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// P7: kind 0 = the same-step emit, 1 = the deferred (ping-pong) emit, both
// at block 4096; 2 = the floor at block_n 8192 or 4096.  bf16, d a multiple
// of 128 columns.
extern "C" int svs_probe_select11(int kind, int block_n, const void* q,
                                  const void* docs, int b, int n, int d,
                                  int n_valid, void* out, void* stream) {
  const int blk = kind == 2 ? block_n : 4096;
  if ((blk != 4096 && blk != 8192) || !shape_ok(b, n, d, blk) ||
      d % 128 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return (int)svs::probes::select11_same_step(q, docs, b, n, d, n_valid, o,
                                                  st);
    case 1:
      return (int)svs::probes::select11_deferred(q, docs, b, n, d, n_valid, o,
                                                 st);
    case 2:
      return (int)svs::probes::select11_floor(blk, q, docs, b, n, d, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// P5, P4, P6: the keyed emits at 8192-doc blocks, bf16, d a multiple of 128
// columns.  variant 0 = P5's v2 / P4's current, 1-4 = P4's hier, h6g128,
// h8g256, h8g1024, 5 / 6 = P6's 512-doc guarded prototypes at H = 2 / 3.
extern "C" int svs_probe_keyed(int variant, const void* q, const void* docs,
                               int b, int n, int d, int n_valid, void* out,
                               void* stream) {
  if (!shape_ok(b, n, d, 8192) || d % 128 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return (int)svs::probes::select9_v2(q, docs, b, n, d, n_valid, o, st);
    case 1:
    case 2:
    case 3:
    case 4:
      return (int)svs::probes::select8_emit(variant, q, docs, b, n, d, n_valid,
                                            o, st);
    case 5:
    case 6:
      return (int)svs::probes::select10_guarded(variant - 3, q, docs, b, n, d,
                                                n_valid, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
