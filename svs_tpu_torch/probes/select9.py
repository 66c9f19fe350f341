"""P5: the v3 prototype's shootout of ``benchmarks/tpu_select9.py`` on the
H100 (its kernel bodies ``kern_v3`` :56, ``kern_v2`` :97 and ``kern_mm``
:135, called at :161; ``merge_v3`` :176 and ``run_full_v3`` :196).

Over bf16 docs ``[N, 1536]`` and bf16 queries, each variant sums f32
products per contraction chunk of 128 columns over an 8192-doc block, then
emits to the block's 128 lanes:

- ``v3``: per 1024-doc subtile the top 4 keys ``floor((acc + KEY_BIAS) *
  4096) * 1024 + lane`` (no clip), the guard (the max of the 4th keys) at
  lane 32;
- ``v2``: per 512-doc subtile the top 8 keys ``floor((acc + KEY_BIAS) *
  8192) * 512 + lane``, no guard, 16 subtiles filling the 128 lanes;
- ``mm``: the matmul-only floor, the first 128 sums of the block.

``v3`` and ``mm`` compute what P8's ``v3`` and ``mm128`` compute (chunk
128, block 8192), so they launch those instances
(``csrc/probes/bf16_opt.cu``); ``v2`` is the v3 core under a keyed variant
(``csrc/probes/select9.cu``), also P4's ``current``.  :func:`full_v3` is
the kernel and ``merge_v3`` (plain torch).

The queries are bf16, as the script casts them (``tpu_select9.py:245``).

    python -m svs_tpu_torch.probes.select9            # on the card
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import bf16_opt
from . import common as C

BLOCK_N = C.KEYED_BLOCK_N
DIM_CHUNK = C.KEYED_CHUNK
#: ``kern_v2``'s emit (P4's ``current``): top 8 per 512 docs at 2^13.
V2 = C.Keyed(variant=0, sub=512, h=8)
VARIANTS = ("v3", "v2", "mm")
#: Candidates of ``merge_v3`` (``k=400``).
K = 400
#: The cases of the script (``tpu_select9.py:248-253``): label, variant.
CASES = (
    ("mm-floor", "mm"),
    ("v2-extract", "v2"),
    ("v3-extract", "v3"),
    ("v3-full", "full"),
)


def extract_plain(docs, q, n_valid: int, variant: str) -> torch.Tensor:
    """Plain-torch version of the kernels: the chunked f32 sum, then the
    variant's emit."""
    if variant == "v2":
        return V2.plain(docs, q, n_valid)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    return bf16_opt.extract_plain(docs, q, n_valid, variant, DIM_CHUNK, BLOCK_N)


def extract(docs, q, n_valid: int, variant: str) -> torch.Tensor:
    """One launch of P5's ``run``: tiles ``[B, (N / 8192) * 128]`` f32 from
    bf16 ``docs`` ``[N, D]`` and bf16 queries ``q`` ``[B, D]``.  The CUDA
    kernel for CUDA tensors, the plain version for CPU ones."""
    if variant not in VARIANTS:
        raise ValueError(f"{variant!r}: not a variant of the probe")
    if not docs.is_cuda:
        return extract_plain(docs, q, n_valid, variant)
    if variant == "v2":
        out = V2.launch(docs, q, n_valid, "P5 v2")
    else:
        out = bf16_opt.launch(docs, q, n_valid, variant, DIM_CHUNK, BLOCK_N)
    extract.launches += 1  # type: ignore[attr-defined]
    return out


extract.launches = 0  # type: ignore[attr-defined]


def merge_v3(out: torch.Tensor, k: int = K) -> tuple:
    """``merge_v3``: the top ``k`` keys of the v3 tiles, their values and
    rows, and the bound ``max(guard value, weakest value)``."""
    _, vals, rows, guard = C.top_keys(out, k, BLOCK_N)
    return vals, rows, torch.maximum(guard, vals[:, -1])


def full_v3(docs, q, n_valid: int, k: int = K) -> tuple:
    """``run_full_v3``'s work: the v3 kernel, then :func:`merge_v3`."""
    return merge_v3(extract(docs, q, n_valid, "v3"), k)


def time_cases(docs, q, n_valid: int, k: int = K, windows: int = 5, launches: int = 20) -> dict:
    """Each case of the script: device time (median and spread; on the CPU
    the plain versions' host time)."""
    fns = {variant: (lambda v=variant: extract(docs, q, n_valid, v)) for variant in VARIANTS}
    fns["full"] = lambda: full_v3(docs, q, n_valid, k)
    return {label: C.time_case(fns[variant], windows, launches, host=not docs.is_cuda)
            for label, variant in CASES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="P5: the v3 prototype against v2 on the H100")
    ap.add_argument("--device", default=None, help="default: the card; cpu: the plain versions")
    ap.add_argument("--docs", type=int, default=C.N, help="a multiple of 8192")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    print("device:", C.device_line(dev), flush=True)
    docs = C.synth_bf16(args.docs, C.D, dev)
    q = torch.from_numpy(C.unit_queries(C.B, C.D)).to(dev).to(torch.bfloat16)
    k = min(K, (args.docs // BLOCK_N) * 32)
    for label, t in time_cases(docs, q, args.docs - 100, k).items():
        print(C.case_line(f"{label:11}", t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
