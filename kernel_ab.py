#!/usr/bin/env python3
"""Times the port's two selection kernels, ``_extract`` (``csrc/extract.cu``)
and ``pairwise_keys_extract`` (``csrc/pair_keys.cu``), against the same
kernels built from another tree's ``csrc`` (an earlier commit, unpacked with
``git archive``), on one CUDA device, on the inputs the main paths give them.

Both libraries are built by ``svs_tpu_torch.ops.kernels.load`` and driven
through the port's own wrappers.  Each is first held bit for bit against
the plain PyTorch version, then timed in turns (old, new, new, old, ...)
with ``chip_smoke.time_ms``: device time per launch over a run of launches
between one CUDA event pair.

Shapes: the keyed pass's [256, 114,688] pair block (PAIR_MASKED outside the
strict upper triangle), the exact pass's (-inf there), and the [512,
1,015,808] f32 scores of an int8 pack at B = 512.

    git archive <commit> svs_tpu_torch/csrc | tar -x -C build/ab_old
    python3 kernel_ab.py --old build/ab_old/svs_tpu_torch/csrc

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as S

def launching_from(lib, fn):
    """``fn`` with the port's wrappers launching their kernels from ``lib``."""
    from svs_tpu_torch.ops import kernels

    def run():
        saved, kernels._lib = kernels._lib, lib
        try:
            return fn()
        finally:
            kernels._lib = saved

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="the other tree's svs_tpu_torch/csrc directory")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--turns", type=int, default=4,
                    help="timed windows per build and shape, in turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        S.log("kernel_ab: CUDA is not available; this needs a GPU")
        return 2
    from svs_tpu_torch.ops import kernels
    from svs_tpu_torch.ops import pallas_extract as P
    from svs_tpu_torch.ops.quant import _int8_scores
    from svs_tpu_torch.ops.topk import mask_cols

    card = S.card_line()
    S.log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:
        built = pool.map(kernels.load, (args.old.resolve(), kernels._CSRC))
        libs = dict(zip(("old", "new"), built))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(S.SEED)
    pscores, live = S.pair_block(gen, dev)
    keyed_in = torch.where(live, pscores, P.PAIR_MASKED).contiguous()
    exact_in = torch.where(live, pscores, float("-inf")).contiguous()
    del pscores, live
    docs, scales = S.int8_pack(1_000_000, gen, dev)
    q512 = S.unit_rows_torch(512, S.DIM, gen, dev)
    scores512 = mask_cols(_int8_scores(docs, scales, q512), 1_000_000).contiguous()
    del docs, scales
    torch.cuda.empty_cache()

    def ext_bytes(x):
        return S.nbytes(x) + 2 * x.shape[0] * (x.shape[1] // 1024) * 8 * 4

    cases = [
        ("pair_keys [256, 114688] keyed pair block",
         lambda: (P.pairwise_keys_extract(keyed_in),),
         lambda: (P._pair_keys_plain(keyed_in),),
         S.nbytes(keyed_in) + 256 * (keyed_in.shape[1] // 4096) * 128 * 4),
        ("extract [256, 114688] exact pair block", lambda: P._extract(exact_in),
         lambda: P._extract_plain(exact_in), ext_bytes(exact_in)),
        ("extract [512, 1015808] int8 scores, B=512", lambda: P._extract(scores512),
         lambda: P._extract_plain(scores512), ext_bytes(scores512)),
    ]
    result = {"card": card, "shapes": {}}
    for what, call, plain, nb in cases:
        ref = plain()
        torch.cuda.synchronize()
        fns = {name: launching_from(lib, call) for name, lib in libs.items()}
        for name, fn in fns.items():
            S.check_exact(f"{name} {what}", fn(), ref)
        del ref
        names = list(fns)
        times = {name: [] for name in names}
        for turn in range(args.turns):
            for name in names if turn % 2 == 0 else names[::-1]:
                times[name].append(S.time_ms(fns[name], args.launches))
        bound_ms = S.bound(nb, 0.0, "f32")[0]
        rec = {"bound_ms": bound_ms}
        for name in names:
            med = statistics.median(times[name])
            rec[name] = {"ms": times[name], "median_ms": med,
                         "share_of_bound": bound_ms / med}
            S.log(f"{what}: {name} median {med * 1e3:.2f} us "
                  f"({bound_ms / med:.0%} of the {bound_ms * 1e3:.2f} us bound), "
                  f"windows {[round(t * 1e3, 2) for t in times[name]]} us")
        result["shapes"][what] = rec
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
