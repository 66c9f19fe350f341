"""P9: the int8 guarded v3 shootout of ``benchmarks/tpu_int8_opt.py`` on
the H100 (its kernel body: ``make_kern``'s ``kern`` :48, called at :115).

Over int8 docs ``[N, 1536]`` with row scales and int8 queries with their
scales, each variant sums the exact int32 products of a 8192-doc block
and then emits:

- ``mm``: the matmul-only floor, the first 128 sums of the block as f32;
- ``v3``: the production emit without the clip: per 1024-doc subtile the
  top 4 keys ``floor((f32(acc) * rs * qs + KEY_BIAS) * 4096) * 1024 +
  lane`` at lanes ``s * 4 + h``, the guard (the max of the subtiles' 4th
  keys) at lane 32;
- ``v3dq``: the query scale folded into the key grid, ``floor((f32(acc) *
  rs + qb) * qq) * 1024 + lane`` with ``qb = KEY_BIAS / qs`` and ``qq =
  4096 * qs`` per query.

each at contraction chunk 128 or 256.  The kernel is the production v3
core (``csrc/fused3.cuh``) under a variant (``csrc/probes/int8_opt.cu``):
the chunk is the k-span of one run of asynchronous wgmma, 1 or 2 stages of
128 int8 columns (the int32 sums are exact, so the chunk changes the time
and not the bits).  Lanes the Pallas kernel leaves unwritten (past the
guard) hold ``KEY_DEAD`` here.

    python -m svs_tpu_torch.probes.int8_opt            # on the card
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.topk import int8_dot
from . import common as C

VARIANTS = {"mm": 0, "v3": 1, "v3dq": 2}
CHUNKS = (128, 256)
BLOCK_N = 8192
#: The cases of the script (``tpu_int8_opt.py:188-195``): label, variant,
#: chunk.
CASES = (
    ("mm128", "mm", 128),
    ("mm256", "mm", 256),
    ("v3", "v3", 128),
    ("v3dq", "v3dq", 128),
    ("v3dq256", "v3dq", 256),
    ("v3-256", "v3", 256),
)


def extract_plain(docs, q, qs, qb, qq, rs, n_valid: int, variant: str, chunk: int) -> torch.Tensor:
    """Plain-torch version of the kernel: the exact int32 product, then
    the variant's emit, one torch op per step of the probe (so nothing is
    contracted into a fused multiply-add).  ``chunk`` does not change an
    int32 sum."""
    del chunk
    acc = int8_dot(q, docs)
    if variant == "mm":
        return C.first_sums(acc, BLOCK_N)
    a = acc.to(torch.float32)
    if variant == "v3":
        x = (a * rs[None, :] * qs[:, None] + C.KEY_BIAS) * C.QS3
    elif variant == "v3dq":
        x = (a * rs[None, :] + qb[:, None]) * qq[:, None]
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return C.v3_tiles(C.grid_keys(x), n_valid, BLOCK_N)


def extract(docs, q, qs, qb, qq, rs, n_valid: int, variant: str, chunk: int) -> torch.Tensor:
    """One launch of P9's kernel: tiles ``[B, (N / 8192) * 128]`` f32 from
    int8 ``docs`` ``[N, D]``, row scales ``rs`` ``[N]``, int8 queries ``q``
    ``[B, D]`` and their ``qs``, ``qb``, ``qq`` (each f32 ``[B]``).  The CUDA
    kernel for CUDA tensors, the plain version for CPU ones."""
    if variant not in VARIANTS or chunk not in CHUNKS:
        raise ValueError(f"variant {variant!r}, chunk {chunk}: not a case of the probe")
    if not docs.is_cuda:
        return extract_plain(docs, q, qs, qb, qq, rs, n_valid, variant, chunk)
    n, d = docs.shape
    b = q.shape[0]
    C.check_operand(docs, torch.int8, (n, d), "docs")
    C.check_operand(q, torch.int8, (b, d), "queries")
    C.check_operand(rs, torch.float32, (n,), "row scales")
    if not (0 < b <= 256 and n % BLOCK_N == 0 and d % chunk == 0 and 0 <= n_valid <= n):
        raise ValueError(f"P9 needs 0 < b <= 256, n % {BLOCK_N} == 0, d % chunk == 0; got {b}, {n}, {d}")
    scales = torch.cat([qb, qq]) if variant == "v3dq" else qs
    C.check_operand(scales, torch.float32, (scales.numel(),), "query scales")
    cols = C.tile_cols(n, BLOCK_N)
    if variant == "mm":  # every lane of every row is written
        out = torch.empty((b, cols), dtype=torch.float32, device=docs.device)
    else:  # the keys are written, the guard folded in with an atomic max
        out = torch.full((b, cols), C.KEY_DEAD, dtype=torch.float32, device=docs.device)
    C.launch(
        "svs_probe_int8", f"P9 {variant} chunk {chunk}", docs.device,
        VARIANTS[variant], chunk, q.data_ptr(), scales.data_ptr(), docs.data_ptr(),
        rs.data_ptr(), b, n, d, int(n_valid), out.data_ptr(),
    )
    extract.launches += 1  # type: ignore[attr-defined]
    return out


extract.launches = 0  # type: ignore[attr-defined]


def queries(qf: np.ndarray, device) -> dict:
    """P9's quantised queries as tensors on ``device``: ``q`` int8 [B, D],
    ``qs``, ``qb``, ``qq`` f32 [B]."""
    qz = C.quantize_queries(qf)
    return {
        "q": torch.from_numpy(qz["qi"]).to(device),
        **{k: torch.from_numpy(qz[k]).to(device) for k in ("qs", "qb", "qq")},
    }


def key_lanes(tiles: torch.Tensor) -> torch.Tensor:
    """The lanes a v3 tile of P9 writes: 32 keys and the guard."""
    b = tiles.shape[0]
    return tiles.view(b, -1, C.OUT_LANES)[:, :, : 8 * C.H + 1]


def agreement(docs, rs, qv: dict, n_valid: int) -> float:
    """The share of v3's written key lanes that v3dq reproduces exactly
    (the script prints it; the folded constants round differently)."""
    args = (docs, qv["q"], qv["qs"], qv["qb"], qv["qq"], rs, n_valid)
    a = key_lanes(extract(*args, "v3", 128))
    bq = key_lanes(extract(*args, "v3dq", 128))
    return float((a == bq).double().mean())


def time_cases(docs, rs, qv: dict, n_valid: int, windows: int = 5, launches: int = 20) -> dict:
    """Each case of the script: device time (median and spread; on the
    CPU the plain version's host time)."""
    args = (docs, qv["q"], qv["qs"], qv["qb"], qv["qq"], rs, n_valid)
    return {
        label: C.time_case(lambda v=variant, c=chunk: extract(*args, v, c), windows,
                           launches, host=not docs.is_cuda)
        for label, variant, chunk in CASES
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="P9: the int8 v3 shootout on the H100")
    ap.add_argument("--device", default=None, help="default: the card; cpu: the plain versions")
    ap.add_argument("--docs", type=int, default=C.N, help="a multiple of 8192")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    print("device:", C.device_line(dev), flush=True)
    docs, rs = C.synth_int8(args.docs, C.D, dev)
    qv = queries(C.unit_queries(C.B, C.D), dev)
    n_valid = args.docs - 100
    print(f"v3 vs v3dq key agreement: {agreement(docs, rs, qv, n_valid) * 100:.4f}%", flush=True)
    for label, t in time_cases(docs, rs, qv, n_valid).items():
        print(C.case_line(label, t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
