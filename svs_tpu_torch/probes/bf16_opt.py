"""P8: the bf16 guarded v3 shootout of ``benchmarks/tpu_bf16_opt.py`` on
the H100 (its kernel body: ``make_kern``'s ``kern`` :42, called at :93).

Over bf16 docs ``[N, 1536]`` and bf16 queries, each variant sums f32
products per contraction chunk and emits:

- ``mm``: the matmul-only floor, the first 128 sums of each block as f32;
- ``v3``: the production emit without the clip: per 1024-doc subtile the
  top 4 keys ``floor((acc + KEY_BIAS) * 4096) * 1024 + lane``, the guard
  after the block's keys (lane 32 at block 8192, 16 at 4096);

at block 8192 or 4096 and chunk 128 or 256.  The kernel is the production
v3 core (``csrc/fused3.cuh``) under a variant (``csrc/probes/bf16_opt.cu``):
the chunk is the k-span of one run of asynchronous wgmma, 2 or 4 stages of
64 bf16 columns, summed from zero on the tensor cores and added to the f32
total with one round-to-nearest add (the TPU's ``acc += dot(chunk)``); the
block changes only the tile the keys and the guard land in.

The queries are bf16, as the port's v3 kernels take them (the script casts
its f32 queries to bf16 before the call, ``tpu_bf16_opt.py:137``).

    python -m svs_tpu_torch.probes.bf16_opt            # on the card
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import common as C

VARIANTS = {"mm": 0, "v3": 1}
CHUNKS = (128, 256)
BLOCKS = (8192, 4096)
#: The cases of the script (``tpu_bf16_opt.py:140-147``): label, variant,
#: chunk, block.
CASES = (
    ("mm128", "mm", 128, 8192),
    ("mm256", "mm", 256, 8192),
    ("v3", "v3", 128, 8192),
    ("v3c256", "v3", 256, 8192),
    ("v3b4096", "v3", 256, 4096),
    ("v3b4096c128", "v3", 128, 4096),
)


def extract_plain(docs, q, n_valid: int, variant: str, chunk: int, block_n: int) -> torch.Tensor:
    """Plain-torch version of the kernel: the probe's chunked f32 sum, then
    its emit, one torch op per step."""
    acc = C.chunked_scores(docs, q, chunk)
    if variant == "mm":
        return C.first_sums(acc, block_n)
    if variant != "v3":
        raise ValueError(f"unknown variant {variant!r}")
    return C.v3_tiles(C.v3_keys(acc, clip=False), n_valid, block_n)


def extract(docs, q, n_valid: int, variant: str, chunk: int, block_n: int) -> torch.Tensor:
    """One launch of P8's kernel: tiles ``[B, (N / block_n) * 128]`` f32
    from bf16 ``docs`` ``[N, D]`` and bf16 queries ``q`` ``[B, D]``.  The
    CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if variant not in VARIANTS or chunk not in CHUNKS or block_n not in BLOCKS:
        raise ValueError(f"{variant!r}, chunk {chunk}, block {block_n}: not a case of the probe")
    if not docs.is_cuda:
        return extract_plain(docs, q, n_valid, variant, chunk, block_n)
    out = launch(docs, q, n_valid, variant, chunk, block_n)
    extract.launches += 1  # type: ignore[attr-defined]
    return out


extract.launches = 0  # type: ignore[attr-defined]


def launch(docs, q, n_valid: int, variant: str, chunk: int, block_n: int) -> torch.Tensor:
    """The launch of P8's kernel behind :func:`extract` (CUDA tensors; no
    count): also P5's ``kern_v3`` / ``kern_mm`` and P4's ``matmul``, which
    compute P8's ``v3`` and ``mm128`` (their wrappers count their own)."""
    n, d = docs.shape
    b = q.shape[0]
    C.check_operand(docs, torch.bfloat16, (n, d), "docs")
    C.check_operand(q, torch.bfloat16, (b, d), "queries")
    if not (0 < b <= 256 and n % block_n == 0 and d % chunk == 0 and 0 <= n_valid <= n):
        raise ValueError(f"P8 needs 0 < b <= 256, n % block == 0, d % chunk == 0; got {b}, {n}, {d}")
    cols = C.tile_cols(n, block_n)
    if variant == "mm":
        out = torch.empty((b, cols), dtype=torch.float32, device=docs.device)
    else:
        out = torch.full((b, cols), C.KEY_DEAD, dtype=torch.float32, device=docs.device)
    C.launch(
        "svs_probe_bf16", f"P8 {variant} chunk {chunk} block {block_n}", docs.device,
        VARIANTS[variant], chunk, block_n, q.data_ptr(), docs.data_ptr(), b, n, d,
        int(n_valid), out.data_ptr(),
    )
    return out


def time_cases(docs, q, n_valid: int, windows: int = 5, launches: int = 20) -> dict:
    """Each case of the script: device time (median and spread; on the
    CPU the plain version's host time)."""
    return {
        label: C.time_case(
            lambda v=variant, c=chunk, k=block: extract(docs, q, n_valid, v, c, k),
            windows, launches, host=not docs.is_cuda,
        )
        for label, variant, chunk, block in CASES
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="P8: the bf16 v3 shootout on the H100")
    ap.add_argument("--device", default=None, help="default: the card; cpu: the plain versions")
    ap.add_argument("--docs", type=int, default=C.N, help="a multiple of 8192")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    print("device:", C.device_line(dev), flush=True)
    docs = C.synth_bf16(args.docs, C.D, dev)
    q = torch.from_numpy(C.unit_queries(C.B, C.D)).to(dev).to(torch.bfloat16)
    for label, t in time_cases(docs, q, args.docs - 100).items():
        print(C.case_line(label, t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
