#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``svs_tpu_torch``) on one CUDA device.

Drives the port's retrieval main path once at the size its users run (the
``headline`` preset of ``bench.py``: 1,000,000 docs x 1536 dims, top-100),
with random unit vectors made from a seed:

1. builds the hand-written CUDA kernels from the sources in the checkout;
2. kernel phase: runs each kernel on a synthetic 1M x 1536 int8 pack at
   the shapes the main path gives it, holds its output against its plain
   PyTorch version (bit-identical), and times both;
3. end-to-end phase: writes a 1M-doc SQLite store through the port's
   ``Tx``, opens ``svs_tpu_torch.KB(..., device="cuda")`` and calls
   ``retrieve_batch`` at B=64/n=100, B=8/n=100 and B=8/n=1000, checking
   every result against a brute-force f32 scan on the card and counting
   the kernels' launches in that run (each must be > 0).

Prints the card's name and power limit, a JSON line describing every
kernel, and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result line, on any failure or when CUDA is unavailable.

    python3 chip_smoke.py            # the full run, one card
    python3 chip_smoke.py --docs 786432 --reps 3
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20261016
DIM = 1536
#: Scores closer than this are ties for the id check; also the score
#: tolerance (f32 dots accumulate in another order than the reference scan).
SCORE_TOL = 2e-6
REPLACES = {
    "_fused3_extract_int8": "svs_tpu/ops/pallas_extract.py:1160",
    "_fused2_extract_int8": "svs_tpu/ops/pallas_extract.py:685",
    "_fused_extract_int8": "svs_tpu/ops/pallas_extract.py:399",
    "_reduce_keys": "svs_tpu/ops/pallas_extract.py:772",
}
SOURCES = {
    "_fused3_extract_int8": "svs_tpu_torch/csrc/fused_int8.cu",
    "_fused2_extract_int8": "svs_tpu_torch/csrc/fused_int8.cu",
    "_fused_extract_int8": "svs_tpu_torch/csrc/fused_int8.cu",
    "_reduce_keys": "svs_tpu_torch/csrc/reduce_keys.cu",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def unit_rows_torch(n: int, d: int, gen, device) -> "torch.Tensor":
    import torch

    m = torch.randn((n, d), generator=gen, device=device, dtype=torch.float32)
    return m / torch.linalg.vector_norm(m, dim=1, keepdim=True)


def max_abs_err(a, b) -> float:
    import torch

    same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    diff = (a.double() - b.double()).abs()
    finite = torch.isfinite(diff)
    err = float(diff[finite].max()) if bool(finite.any()) else 0.0
    if not same and err == 0.0:
        err = float("nan")  # differing bits that are not a finite gap
    return err


def kernel_phase(n_docs: int, reps: int) -> dict:
    """Each kernel against its plain version on a synthetic full-size
    pack, at the main path's shapes; returns per-kernel records."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P
    from svs_tpu_torch.ops.quant import quantize_rows_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n_pad = -(-n_docs // 16384) * 16384
    docs = torch.zeros((n_pad, DIM), dtype=torch.int8, device=dev)
    scales = torch.full(
        (n_pad,), float(np.float32(1e-30) / np.float32(127.0)),
        dtype=torch.float32, device=dev,
    )
    for lo in range(0, n_docs, 1 << 17):
        rows = unit_rows_torch(min(1 << 17, n_docs - lo), DIM, gen, dev)
        q8, s = quantize_rows_int8(rows)
        docs[lo : lo + len(rows)] = q8
        scales[lo : lo + len(rows)] = s
    nb = n_pad // P.FUSED_BLOCK_N
    log(f"kernel phase: pack {n_pad} x {DIM} int8 (n_valid {n_docs}, nb {nb})")

    def queries(b: int):
        q8, qs = quantize_rows_int8(unit_rows_torch(b, DIM, gen, dev))
        return q8.contiguous(), qs.contiguous()

    records = {}

    def compare(name, kernel_fn, plain_fn, what):
        got = kernel_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        got_t = got if isinstance(got, tuple) else (got,)
        ref_t = ref if isinstance(ref, tuple) else (ref,)
        errs = []
        for g, r in zip(got_t, ref_t):
            if g.shape != r.shape:
                raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(r.shape)}")
            errs.append(max_abs_err(g, r))
            if not torch.equal(g.view(torch.int32), r.view(torch.int32)):
                bad = int((g.view(torch.int32) != r.view(torch.int32)).sum())
                raise AssertionError(
                    f"{name} ({what}): {bad} of {g.numel()} outputs differ "
                    f"from the plain version (max |err| {errs[-1]})"
                )
        ms = time_ms(kernel_fn, reps)
        plain_ms = time_ms(plain_fn, max(3, reps // 4))
        log(f"  {name} {what}: bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        records.setdefault(name, []).append(
            {"what": what, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}
        )
        return got_t[0]

    # #1 guarded v3 at B = 64, C = 400
    q8, qs = queries(64)
    args = (docs, scales, q8, qs, n_docs)
    out3 = compare(
        "_fused3_extract_int8",
        lambda: P._fused3_extract_int8(*args),
        lambda: P._fused3_extract_int8_plain(*args),
        "B=64 (v3, C=400)",
    )
    # #2 on #1's keys: the staged v3 finish's pass-2 input
    keys3 = out3.view(64, nb, 128)[:, :, : P.GUARD_KEYS].reshape(64, -1)
    l1p = -(-keys3.shape[1] // P.REDUCE_BLOCK) * P.REDUCE_BLOCK
    keys3 = torch.cat(
        [keys3, keys3.new_full((64, l1p - keys3.shape[1]), P.KEY_DEAD)], dim=1
    ).contiguous()
    h2_3 = P._guard_reduce_h2(nb, 400)
    compare(
        "_reduce_keys",
        lambda: P._reduce_keys(keys3, h2_3),
        lambda: P._reduce_keys_plain(keys3, h2_3),
        f"v3 keys [64, {l1p}], h2={h2_3}",
    )
    # #3 keyed v2 at B = 8, k = 400
    q8, qs = queries(8)
    args = (docs, scales, q8, qs, n_docs)
    keys2 = compare(
        "_fused2_extract_int8",
        lambda: P._fused2_extract_int8(*args),
        lambda: P._fused2_extract_int8_plain(*args),
        "B=8 (v2, k=400)",
    )
    l1p = -(-keys2.shape[1] // P.REDUCE_BLOCK) * P.REDUCE_BLOCK
    keys2 = torch.cat(
        [keys2, keys2.new_zeros((8, l1p - keys2.shape[1]))], dim=1
    ).contiguous()
    h2_2 = P._reduce_h2(n_pad, 400)
    compare(
        "_reduce_keys",
        lambda: P._reduce_keys(keys2, h2_2),
        lambda: P._reduce_keys_plain(keys2, h2_2),
        f"v2 keys [8, {l1p}], h2={h2_2}",
    )
    # #4 v1 at B = 8, k = 4000
    compare(
        "_fused_extract_int8",
        lambda: P._fused_extract_int8(*args),
        lambda: P._fused_extract_int8_plain(*args),
        "B=8 (v1, k=4000)",
    )
    del docs, scales
    torch.cuda.empty_cache()
    return records


def write_store(path: Path, n_docs: int) -> np.ndarray:
    """A SQLite store of ``n_docs`` random unit vectors written through the
    port's ``Tx`` (doc ``i`` holds row ``i``); returns the f32 rows."""
    from svs_tpu_torch.store.blob import embedding_to_bytes
    from svs_tpu_torch.store.db import Database

    rng = np.random.default_rng(SEED)
    matrix = np.empty((n_docs, DIM), dtype=np.float32)
    db = Database(path)
    try:
        with db.transaction() as tx:
            for lo in range(0, n_docs, 50_000):
                rows = rng.standard_normal(
                    (min(50_000, n_docs - lo), DIM)
                ).astype(np.float32)
                rows /= np.linalg.norm(rows, axis=1, keepdims=True)
                matrix[lo : lo + len(rows)] = rows
                tx.add_docs_bulk(
                    [f"synthetic document #{lo + i}" for i in range(len(rows))],
                    [embedding_to_bytes(r) for r in rows],
                )
            tx.bump_matrix_version()
    finally:
        db.close()
    return matrix


def check_results(results, qvecs, ref_matrix, n) -> None:
    """Every hit list is the brute-force f32 top-n (reference tie rule):
    ids identical except between scores closer than SCORE_TOL, and every
    score within SCORE_TOL of the true f32 dot."""
    import torch

    from svs_tpu_torch.ops.topk import exact_f32

    q = torch.from_numpy(qvecs).cuda()
    with exact_f32():
        exact = q @ ref_matrix.t()  # [B, N]
    cand_v, cand_i = torch.topk(exact, n + 64, dim=1)
    for b, hits in enumerate(results):
        if len(hits) != n:
            raise AssertionError(f"query {b}: {len(hits)} hits, want {n}")
        rows = np.asarray(
            [int(h["doc"]["text"].rsplit("#", 1)[1]) for h in hits]
        )
        scores = np.asarray([h["score"] for h in hits], dtype=np.float64)
        if not np.isfinite(scores).all():
            raise AssertionError(f"query {b}: non-finite scores")
        true_of_rows = exact[b, torch.from_numpy(rows).cuda()].double().cpu().numpy()
        if np.abs(scores - true_of_rows).max() > SCORE_TOL:
            raise AssertionError(f"query {b}: scores off by {np.abs(scores - true_of_rows).max()}")
        # reference order: descending score, ties to the larger row (emb id)
        cv = cand_v[b].cpu().numpy()
        ci = cand_i[b].cpu().numpy()
        order = np.lexsort((-ci, -cv))[:n]
        ref_rows, ref_scores = ci[order], cv[order].astype(np.float64)
        for j in range(n):
            if rows[j] != ref_rows[j] and abs(true_of_rows[j] - ref_scores[j]) >= SCORE_TOL:
                raise AssertionError(
                    f"query {b} rank {j}: row {rows[j]} (score "
                    f"{true_of_rows[j]:.9f}) where the scan has row "
                    f"{ref_rows[j]} ({ref_scores[j]:.9f})"
                )


def e2e_phase(n_docs: int, reps: int, work: Path) -> dict:
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.ops import pallas_extract as P

    store = work / "store.sqlite"
    t0 = time.perf_counter()
    matrix = write_store(store, n_docs)
    t_write = time.perf_counter() - t0
    log(f"e2e: wrote {n_docs} x {DIM} store in {t_write:.1f} s")
    ref_matrix = torch.from_numpy(matrix).cuda()
    del matrix

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 1)
    kb = svs_tpu_torch.KB(store, embed, device="cuda")
    out = {"store_write_s": t_write, "docs": n_docs}
    try:
        P.reset_launch_counts()
        # B=64 first: the engine's per-n width hint is shared by every
        # batch size, and a widened hint (C > GUARD_MAX_C) would keep the
        # guarded v3 kernel off for the rest of the run
        for label, b, n in (("B64_n100", 64, 100), ("B8_n100", 8, 100), ("B8_n1000", 8, 1000)):
            lat = []
            kb._stats.reset()
            for rep in range(reps):
                v = rng.standard_normal((b, DIM)).astype(np.float32)
                v /= np.linalg.norm(v, axis=1, keepdims=True)
                texts = [f"{label}-{rep}-{i}" for i in range(b)]
                qvec.update(zip(texts, v))
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = kb.retrieve_batch(texts, n)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
                check_results(res, v, ref_matrix, n)
            warm = lat[1:] if len(lat) > 1 else lat
            out[label] = {
                "first_s": lat[0],
                "warm_p50_ms": statistics.median(warm) * 1e3,
                "warm_ms": [x * 1e3 for x in warm],
                # per-phase host-clock p50s over this shape's calls
                "phase_p50_ms": {
                    k: v["p50_s"] * 1e3 for k, v in kb._stats.snapshot().items()
                },
            }
            log(f"e2e {label}: first {lat[0]:.3f} s, warm p50 "
                f"{out[label]['warm_p50_ms']:.2f} ms over {len(warm)}; exact vs scan")
        out["launches"] = P.launch_counts()
        out["widen_retries"] = kb.engine.widen_retries
        out["pack_events"] = dict(kb.engine.pack_events)
    finally:
        kb.close()
        store.unlink(missing_ok=True)
    log(f"e2e launches {out['launches']}, widen retries {out['widen_retries']}")
    missing = [k for k, v in out["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=5, help="retrieve_batch calls per shape")
    ap.add_argument("--kernel-reps", type=int, default=20)
    ap.add_argument("--skip-e2e", action="store_true", help="kernel phase only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this smoke needs a GPU")
        return 2
    try:
        from svs_tpu_torch.ops import kernels
    except ImportError as exc:
        log(f"chip_smoke: the svs_tpu_torch package is not importable here ({exc})")
        return 2
    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke"
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.library()
    log(f"kernels: built in {kernels.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s) -> {kernels.library_path()}")

    records = kernel_phase(args.docs, args.kernel_reps)
    e2e = None
    if not args.skip_e2e:
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        try:
            e2e = e2e_phase(args.docs, args.reps, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    kernels_json = []
    for name, recs in records.items():
        for rec in recs:
            kernels_json.append({
                "name": name,
                "route": "cuda",
                "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": None if e2e is None else e2e["launches"][name],
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "shape": rec["what"],
            })
    if e2e is not None:
        e2e["seconds_total"] = time.perf_counter() - t_start
        print(json.dumps({"e2e": e2e}))
    print(json.dumps({"kernels": kernels_json}))
    print(card)
    if e2e is None:
        log("chip_smoke: kernel phase only (--skip-e2e): no result line")
        return 3
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
