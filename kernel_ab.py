#!/usr/bin/env python3
"""Times the port's kernels against the same kernels built from another
tree's ``csrc`` (an earlier commit, unpacked with ``git archive``), on one
CUDA device, on the inputs the main paths give them.

Both libraries are built by ``svs_tpu_torch.ops.kernels.build`` and driven
through the port's own wrappers (the other tree's launchers bound here, by
this tree's signatures and its own pass-2 kernel's).  Each is first held against the plain
PyTorch version (bit for bit; the float v3 kernels on random unit data
within ``chip_smoke.SCORE_TOL`` at a key-grid edge), then timed in turns
(old, new, new, old, ...) with ``chip_smoke.time_ms``: device time per
launch over a run of launches between one CUDA event pair.

Cases (``--only``):
- ``selection``: ``_extract`` (``csrc/extract.cu``) and
  ``pairwise_keys_extract`` (``csrc/pair_keys.cu``) on the keyed pass's
  [256, 114,688] pair block (PAIR_MASKED outside the strict upper
  triangle), the exact pass's (-inf there), and the [512, 1,015,808] f32
  scores of an int8 pack at B = 512;
- ``v3``: the guarded v3 kernels (mode 3 of ``csrc/fused_int8.cu`` and
  ``csrc/fused_float.cu``) on 1M x 1536 packs of random unit rows: int8
  at B = 64 and 256, bf16 and f32 at B = 64;
- ``finish``: the staged finish (#2, ``csrc/reduce_keys.cu``) on the keys
  of random scores over 1M docs at the main paths' shapes (v3 at B = 64
  and 256, C = 400; v2 at B = 8, C = 400 and B = 64, C = 1,600), and at
  the shapes where its buffers pass shared memory (v2 on 8M docs at
  B = 8, C = 16,000; on 33.6M docs at B = 4, C = 1,600 and B = 2,
  C = 20,000), against
  the parent's chain: pass 2 on the other tree's ``svs_reduce_keys``,
  then the torch sort, gather and decode (the plain version's);
  ``torch.topk`` of the level-1 keys at the same C is timed beside them;
- ``v2``: the keyed v2 kernels (mode 2 of the same files) on the same
  packs, int8, bf16 and f32 at B = 8, 16, 64 and 256 (the calls of a
  ``KB`` at C = 1,600; C does not reach the kernel), and at B = 9: 8
  queries and one zero row, the v3 core's cost at B = 8 (the kernel
  sends B <= 8 to the first core).  bf16 and f32 keys
  are held within ``chip_smoke.SCORE_TOL`` of the plain version's scores.

``--only`` may be given more than once.

    git archive <commit> svs_tpu_torch/csrc | tar -x -C build/ab_old
    python3 kernel_ab.py --old build/ab_old/svs_tpu_torch/csrc --only v2 --only v3

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as S


def load_other(csrc):
    """Another tree's kernel library, built from ``csrc``, with each of its
    launchers that this tree also has bound by this tree's signature, and
    the pass-2 kernel of trees before the staged finish, ``svs_reduce_keys``."""
    from svs_tpu_torch.ops import kernels

    vp, i = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(kernels.build(csrc)))
    signatures = {**kernels.SIGNATURES, "svs_reduce_keys": ([vp, i, i, i, vp, vp], i)}
    for name, (argtypes, restype) in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


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


def fused_cases(dev, gen, mode):
    """``(what, call, plain, check, bound)`` of the guarded v3 (``mode`` 3)
    or keyed v2 (2) kernels on 1M x 1536 packs of random unit rows;
    ``check(got, ref)`` raises on a mismatch and returns the error."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P
    from svs_tpu_torch.ops.quant import quantize_rows_int8
    from svs_tpu_torch.ops.topk import scores_matmul

    n_docs = 1_000_000
    docs, scales = S.int8_pack(n_docs, gen, dev)
    n_pad = docs.shape[0]
    if mode == 3:
        name, tag, v3 = "_fused3_extract", "fused3", True
        out_bytes = (n_pad // P.FUSED_BLOCK_N) * 128 * 4
        int8_batches, float_batches = (64, 256), (64,)
    else:
        name, tag, v3 = "_fused2_extract", "fused2", False
        out_bytes = (n_pad // P.FUSED_SUBTILE) * P.EXTRACT_H * 4
        # B=9 (8 queries and one zero row) times the v3 core at B=8: the
        # kernel sends B <= 8 to the first core
        int8_batches = float_batches = (8, 9) + S.V2_BATCHES
    def queries(b):
        rows = S.unit_rows_torch(b, S.DIM, gen, dev)
        if b == 9:
            rows[8] = 0.0
        return rows

    cases = []
    for b in int8_batches:
        q8, qs = quantize_rows_int8(queries(b))
        args = (docs, scales, q8.contiguous(), qs.contiguous(), n_docs)
        cases.append((
            f"{tag} int8 B={b}",
            lambda args=args: (getattr(P, name + "_int8")(*args),),
            lambda args=args: (getattr(P, name + "_int8_plain")(*args),),
            lambda got, ref: S.check_exact(f"{tag} int8", got, ref),
            S.bound(S.nbytes(docs, scales) + b * (S.DIM + 4) + b * out_bytes,
                    2.0 * b * n_pad * S.DIM, "int8"),
        ))
    yield from cases
    del cases, docs, scales
    torch.cuda.empty_cache()
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fdocs = torch.zeros((n_pad, S.DIM), dtype=dt, device=dev)
        S.fill_rows(fdocs, n_docs, lambda r: S.unit_rows_torch(r, S.DIM, gen, dev))
        for b in float_batches:
            q = queries(b).to(dt).contiguous()
            scores = scores_matmul(fdocs, q)

            def check(got, ref, scores=scores, dt_name=dt_name):
                return S.check_keys_close(f"{tag} {dt_name}", got[0], ref[0],
                                          scores, v3=v3)

            yield (
                f"{tag} {dt_name} B={b}",
                lambda fdocs=fdocs, q=q: (getattr(P, name)(fdocs, q, n_docs),),
                lambda fdocs=fdocs, q=q: (getattr(P, name + "_plain")(fdocs, q, n_docs),),
                check,
                S.bound(S.nbytes(fdocs, q) + b * out_bytes,
                        2.0 * b * n_pad * S.DIM, dt_name),
            )
            del q, scores, check
        del fdocs
        torch.cuda.empty_cache()


def old_reduce(keys, h2):
    """Pass 2 alone through the current library's ``svs_reduce_keys`` (the
    parent trees' #2, ``csrc/reduce_keys.cu`` before the staged finish)."""
    import torch

    from svs_tpu_torch.ops import kernels
    from svs_tpu_torch.ops import pallas_extract as P

    b, l1 = keys.shape
    out = torch.empty((b, (l1 // P.REDUCE_GROUP) * h2), dtype=torch.float32,
                      device=keys.device)
    rc = kernels.library().svs_reduce_keys(
        keys.data_ptr(), b, l1, h2, out.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream,
    )
    kernels.check(rc, "reduce_keys kernel")
    return out


def parent_finish(src, v3, c, h2):
    """The parent's finish chain: the plain version with its pass 2 on the
    other tree's kernel (``old_reduce``)."""
    from svs_tpu_torch.ops import pallas_extract as P

    return P._staged_finish_plain(src, v3, c, h2, old_reduce)


def finish_cases(gen):
    """``(what, calls, plain, check, bound, library)`` of the staged finish
    (#2) on keys of random scores, at the main paths' shapes over 1M
    docs and at the three shapes past shared memory: "old" is the
    parent's chain (pass 2 on the other tree's ``svs_reduce_keys``, then
    the torch sort, gather and decode of the plain version), "new" the
    one kernel; ``library`` is ``torch.topk`` of the level-1 keys at the
    same C."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P

    big = 4100 * P.FUSED_BLOCK_N
    for v3, b, c, n_docs in ((True, 64, 400, 1_000_000), (True, 256, 400, 1_000_000),
                             (False, 8, 400, 1_000_000), (False, 64, S.V2_C, 1_000_000),
                             (False, 8, 16_000, 977 * P.FUSED_BLOCK_N),
                             (False, 4, S.V2_C, big), (False, 2, 20_000, big)):
        src = S.finish_input(b, v3, n_docs, gen, "random")
        nb = src.shape[1] // 128
        if v3:
            h2 = P._guard_reduce_h2(nb, c)
            level1 = src.view(b, nb, 128)[:, :, : P.GUARD_KEYS].reshape(b, -1).contiguous()
        else:
            h2 = P._reduce_h2(nb * P.FUSED_BLOCK_N, c)
            level1 = src
        l1 = level1.shape[1]
        yield (
            f"staged finish {'v3' if v3 else 'v2'} keys [{b}, {l1}], h2={h2}, C={c}",
            {
                "old": lambda src=src, v3=v3, c=c, h2=h2: parent_finish(src, v3, c, h2),
                "new": lambda src=src, v3=v3, c=c, h2=h2: P._staged_finish(src, v3, c, h2),
            },
            lambda src=src, v3=v3, c=c, h2=h2: P._staged_finish_plain(src, v3, c, h2),
            lambda got, ref: S.check_exact("staged finish", got, ref),
            S.bound(b * l1 * 4 + b * c * 8, 0.0, "f32"),
            lambda level1=level1, c=c: torch.topk(level1, c, dim=1),
        )


def selection_cases(dev, gen):
    """``(what, call, plain, check, bound)`` of the two selection kernels."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P
    from svs_tpu_torch.ops.quant import _int8_scores
    from svs_tpu_torch.ops.topk import mask_cols

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

    def exact(got, ref):
        return S.check_exact("selection", got, ref)

    yield ("pair_keys [256, 114688] keyed pair block",
           lambda: (P.pairwise_keys_extract(keyed_in),),
           lambda: (P._pair_keys_plain(keyed_in),), exact,
           S.bound(S.nbytes(keyed_in) + 256 * (keyed_in.shape[1] // 4096) * 128 * 4,
                   0.0, "f32"))
    yield ("extract [256, 114688] exact pair block", lambda: P._extract(exact_in),
           lambda: P._extract_plain(exact_in), exact,
           S.bound(ext_bytes(exact_in), 0.0, "f32"))
    yield ("extract [512, 1015808] int8 scores, B=512", lambda: P._extract(scores512),
           lambda: P._extract_plain(scores512), exact,
           S.bound(ext_bytes(scores512), 0.0, "f32"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="the other tree's svs_tpu_torch/csrc directory")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--turns", type=int, default=4,
                    help="timed windows per build and shape, in turns")
    ap.add_argument("--only", choices=("all", "selection", "v3", "v2", "finish"),
                    action="append", help="the cases to run (default: all)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        S.log("kernel_ab: CUDA is not available; this needs a GPU")
        return 2
    from svs_tpu_torch.ops import kernels

    card = S.card_line()
    S.log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:
        old = pool.submit(load_other, args.old.resolve())
        new = pool.submit(kernels.load)
        libs = {"old": old.result(), "new": new.result()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(S.SEED)
    only = set(args.only or ("all",))
    groups = []
    if only & {"all", "selection"}:
        groups.append(selection_cases(dev, gen))
    if only & {"all", "v3"}:
        groups.append(fused_cases(dev, gen, 3))
    if only & {"all", "v2"}:
        groups.append(fused_cases(dev, gen, 2))
    if only & {"all", "finish"}:
        groups.append(finish_cases(gen))
    result = {"card": card, "shapes": {}}
    for cases in groups:
        for what, call, plain, check, (bound_ms, bound_by), *library in cases:
            ref = plain()
            torch.cuda.synchronize()
            calls = call if isinstance(call, dict) else dict.fromkeys(libs, call)
            fns = {name: launching_from(lib, calls[name]) for name, lib in libs.items()}
            errs = {}
            for name, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                errs[name] = check(got, ref)
            del ref, got
            names = list(fns)
            times = {name: [] for name in names}
            for turn in range(args.turns):
                for name in names if turn % 2 == 0 else names[::-1]:
                    times[name].append(S.time_ms(fns[name], args.launches))
            rec = {"bound_ms": bound_ms, "bound_by": bound_by}
            if library:
                rec["library_ms"] = [S.time_ms(library[0], args.launches)
                                     for _ in range(args.turns // 2)]
                S.log(f"{what}: library {[round(t * 1e3, 2) for t in rec['library_ms']]} us")
            for name in names:
                med = statistics.median(times[name]) if times[name] else None
                rec[name] = {"ms": times[name], "median_ms": med,
                             "max_abs_err": errs[name],
                             "share_of_bound": None if med is None else bound_ms / med}
                S.log(f"{what}: {name} max |err| {errs[name]}; median "
                      f"{'-' if med is None else f'{med * 1e3:.2f} us'} "
                      f"(bound {bound_ms * 1e3:.2f} us, {bound_by}), windows "
                      f"{[round(t * 1e3, 2) for t in times[name]]} us")
            result["shapes"][what] = rec
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
