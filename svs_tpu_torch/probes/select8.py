"""P4: the keyed (v2) kernel's emit-cost shootout of
``benchmarks/tpu_select8.py`` on the H100 (its kernel body: ``make_kernel``'s
``kern`` :120 with the emits :40-107, ``EMIT_META`` :108; called at :179).

Over bf16 docs ``[N, 1536]`` and bf16 queries, the kernel sums f32 products
per contraction chunk of 128 columns over an 8192-doc block, then one of
six emits writes the block's lanes (no clip, no guard; keys
``floor((acc + KEY_BIAS) * qscale) * field + lane``):

- ``current``: per 512-doc subtile 8 rounds of max, then clear every equal
  key, at 2^13, field 512: 128 lanes a block.  P5's ``v2``: one instance
  (``csrc/probes/select9.cu``);
- ``hier``: the same keys by another road: per pass a fold of the
  subtile's four 128-lane quarters by max, a max over the 128, a clear
  over the 512;
- ``h6g128``: 6 per 128-doc group at 2^13, field 128: 384 lanes a block;
- ``h8g256``: 8 per 256-doc group at 2^13, field 256: 256 lanes a block;
- ``h8g1024``: 8 per 1024 docs at 2^12, field 1024, then 8 ``KEY_DEAD``
  lanes: 128 lanes a block;
- ``matmul``: the first 128 sums of the block, P8's ``mm128`` instance.

``hier`` and the group emits are the v3 core under keyed variants
(``csrc/probes/select8.cu``).  The script times ``current`` and
``h8g1024``; :func:`main` times all six.

The queries are bf16, as the port's v3-core kernels take them.  The script
feeds its f32 queries to bf16 docs (``tpu_select8.py:225-226``): a bf16
product on a TPU at default precision; the tests give the JAX probe the
same bf16 queries, so both compute one function.

    python -m svs_tpu_torch.probes.select8            # on the card
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import bf16_opt
from . import common as C
from .select9 import BLOCK_N, DIM_CHUNK, V2

#: The keyed emits (``EMIT_META``): the launcher's variant and the layout.
EMITS = {
    "current": V2,
    "hier": C.Keyed(variant=1, sub=512, h=8, fold=True),
    "h6g128": C.Keyed(variant=2, sub=128, h=6),
    "h8g256": C.Keyed(variant=3, sub=256, h=8),
    "h8g1024": C.Keyed(variant=4, sub=1024, h=8, qs=C.QS3, pad=8),
}
#: Every case of the script, in ``EMIT_META``'s order.
CASES = tuple((name, name) for name in ("matmul", "current", "hier", "h6g128", "h8g256", "h8g1024"))


def out_lanes(emit: str) -> int:
    """Output lanes per 8192-doc block (``run``'s ``out_block``)."""
    return C.OUT_LANES if emit == "matmul" else EMITS[emit].lanes


def extract_plain(docs, q, n_valid: int, emit: str) -> torch.Tensor:
    """Plain-torch version: the chunked f32 sum, then the emit (``hier``
    through :func:`common.fold_keys`)."""
    if emit == "matmul":
        return bf16_opt.extract_plain(docs, q, n_valid, "mm", DIM_CHUNK, BLOCK_N)
    return EMITS[emit].plain(docs, q, n_valid)


def extract(docs, q, n_valid: int, emit: str) -> torch.Tensor:
    """One launch of P4's ``run``: tiles ``[B, (N / 8192) * out_lanes]``
    f32 from bf16 ``docs`` ``[N, D]`` and bf16 queries ``q`` ``[B, D]``.
    The CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if emit != "matmul" and emit not in EMITS:
        raise ValueError(f"{emit!r}: not an emit of the probe")
    if not docs.is_cuda:
        return extract_plain(docs, q, n_valid, emit)
    if emit == "matmul":
        out = bf16_opt.launch(docs, q, n_valid, "mm", DIM_CHUNK, BLOCK_N)
    else:
        out = EMITS[emit].launch(docs, q, n_valid, f"P4 {emit}")
    extract.launches += 1  # type: ignore[attr-defined]
    return out


extract.launches = 0  # type: ignore[attr-defined]


def time_cases(docs, q, n_valid: int, windows: int = 5, launches: int = 20) -> dict:
    """Every emit: device time (median and spread; on the CPU the plain
    versions' host time)."""
    return {
        label: C.time_case(lambda e=emit: extract(docs, q, n_valid, e), windows, launches,
                           host=not docs.is_cuda)
        for label, emit in CASES
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="P4: the keyed kernel's emits on the H100")
    ap.add_argument("--device", default=None, help="default: the card; cpu: the plain versions")
    ap.add_argument("--docs", type=int, default=C.N, help="a multiple of 8192")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    print("device:", C.device_line(dev), flush=True)
    docs = C.synth_bf16(args.docs, C.D, dev)
    q = torch.from_numpy(C.unit_queries(C.B, C.D)).to(dev).to(torch.bfloat16)
    n_valid = args.docs - 100
    a, h = extract(docs, q, n_valid, "current"), extract(docs, q, n_valid, "hier")
    if not C.same_bits(a, h):
        raise AssertionError("hier's keys differ from current's")
    print("keys: hier == current (bitwise) OK", flush=True)
    for label, t in time_cases(docs, q, n_valid).items():
        print(C.case_line(f"{label:8}", t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
