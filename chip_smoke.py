#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``svs_tpu_torch``) on one CUDA device.

Drives the port's retrieval paths once at the size its users run (the
``headline`` preset of ``bench.py``: 1,000,000 docs x 1536 dims, top-100)
and its pairwise paths at the size of the repo's pairwise benchmark
(100,000 docs x 1536, top 10,000 pairs), with random unit vectors made
from a seed:

1. builds the hand-written CUDA kernels from the sources in the checkout
   (one ``nvcc`` per source, in parallel);
2. kernel phase: runs each kernel on synthetic 1M x 1536 packs (int8, bf16,
   f32) at the shapes the main paths give it (the guarded v3 kernels at
   each of ``V3_BATCHES``, the keyed v2 kernels at B=8 and at each of
   ``V2_BATCHES``), holds its output against its plain PyTorch version
   (bit-identical on int8, on lattice data, on scores past 2^24 whose
   keys collide, and on equal keys across the chunk boundaries of the v3
   core's merge; within ``SCORE_TOL`` and one key-grid step at a grid edge
   on random float data), holds the staged finish (#2) to its plain
   version on those kernels' keys and on lattice keys that tie across
   groups and dead-padded rows (and on v2 keys of 8M- and 33.6M-doc
   corpora, where its buffers pass the shared-memory limit and go to
   global scratch), and times the kernel, its plain version, and
   one library call where one computes the same function, each as device
   time per launch over a run of launches between one pair of CUDA
   events; then holds ``_extract`` and ``pairwise_keys_extract`` to their
   plain versions on adversarial inputs at the same shapes (ties, -inf or
   masked rows and subtiles, keys past the key horizon);
3. end-to-end phase: loads the native host library (``native_phase``:
   it must load; its build time, path and the host's thread counts),
   writes a 1M-doc SQLite store through the port's ``Tx`` and drives six
   retrieval paths, each with the launch counts set to 0 just before it
   and read just after (a pack of 64 MB and more uploads in the
   background, so a ``KB``'s first call may take the host route; after it
   the smoke waits for the uploads, ``settle``, and records the first
   call's route, ``pack`` phase and scan, ``first_call``):
   - int8 ``KB`` (``precision='auto'``): ``retrieve_batch`` at B=64/n=100,
     B=8/n=100, B=8/n=1000 and B=512/n=100; then ``load()`` (the
     hydration prewarm), B=64/n=100 again, and one B=64 call unprofiled
     and under ``torch.profiler`` (idle share, kernels in situ); then on a
     second int8 ``KB`` B=256/n=100 (the guarded v3 kernel at its batch
     ceiling);
   - bf16 ``KB``: B=64/n=100, B=8/n=100, B=8/n=1000;
   - f32 ``KB``: the same three shapes;
   - int8 ``KB`` with ``device_rescore='host'`` (no device mirror; the
     candidates rescored on the host): B=64, B=8 and B=256 at n=100;
   - ``rescore=False`` ``KB`` (bf16 storage): B=8/n=100;
   checking every result against a brute-force scan on the card (for
   ``rescore=False``, of the bf16-rounded corpus and queries); the
   ``native`` cell reads which scan packed each rescan and its ``pack``
   phase; then ``cold_start`` (``cold_start_phase``: a ``KB`` from the
   sidecar, its first B=64 call on the host route while the pack uploads,
   ``wait_for_mirror``, warm calls on the device route) and
   ``host_route`` (``host_route_phase``: the measured round-trip floor,
   the forced host route at 1M for B=1, 4 (native two-pass) and 64, where
   ``'auto'`` sends each shape, and a new 10,000-doc store at B=1 with
   ``force``, ``off`` and ``auto``); then the ``filters`` phase (``filters_phase``): the 1M store's docs tagged with
   ``tenant`` and ``shard`` meta, and ``where=`` cells on int8 ``KB``s —
   the pre-filter device and host routes, the post-filter ladder of a
   dict and of an opaque predicate — and an ``AsyncKB`` serving
   concurrent plain and filtered batches, each held against a
   brute-force scan of the matching rows; then the incremental phase;
4. pairwise phase: writes two 100k x 1536 stores (the repo's pairwise
   benchmark: dupe-planted and flat random) and drives
   ``document_top_pairwise_scores(10,000)`` three times on each of five
   paths (int8, bf16 and f32 on the dupe-planted store, ``rescore=False``,
   int8 on the flat store), each result held against a brute-force top-k
   of the pairs on the card; on the int8 keyed and ``rescore=False`` exact
   paths, one more call unprofiled and two under ``torch.profiler``, for
   the device's idle share and the kernels' device time per launch in the
   call; then ``bulk_del_docs`` of 1% of the flat store's docs and
   ``retrieve_batch`` (B=64, n=100) held against a brute-force scan of
   the survivors.

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
#: tolerance (f32 dots accumulate in another order than the reference scan),
#: and the tolerance of a float kernel against its plain version.
SCORE_TOL = 2e-6
#: One H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): the
#: least time a kernel could take is max(bytes / HBM, ops / peak[type]).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
REPLACES = {
    "_fused3_extract_int8": "svs_tpu/ops/pallas_extract.py:1160",
    "_fused2_extract_int8": "svs_tpu/ops/pallas_extract.py:685",
    "_fused_extract_int8": "svs_tpu/ops/pallas_extract.py:399",
    "_staged_finish": "svs_tpu/ops/pallas_extract.py:772",
    "_fused3_extract": "svs_tpu/ops/pallas_extract.py:1111",
    "_fused2_extract": "svs_tpu/ops/pallas_extract.py:611",
    "_fused_extract": "svs_tpu/ops/pallas_extract.py:270",
    "_extract": "svs_tpu/ops/pallas_extract.py:113",
    "pairwise_keys_extract": "svs_tpu/ops/pallas_extract.py:1605",
}
SOURCES = {
    "_fused3_extract_int8": "svs_tpu_torch/csrc/fused_int8.cu",
    "_fused2_extract_int8": "svs_tpu_torch/csrc/fused_int8.cu",
    "_fused_extract_int8": "svs_tpu_torch/csrc/fused_int8.cu",
    "_staged_finish": "svs_tpu_torch/csrc/reduce_keys.cu",
    "_fused3_extract": "svs_tpu_torch/csrc/fused_float.cu",
    "_fused2_extract": "svs_tpu_torch/csrc/fused_float.cu",
    "_fused_extract": "svs_tpu_torch/csrc/fused_float.cu",
    "_extract": "svs_tpu_torch/csrc/extract.cu",
    "pairwise_keys_extract": "svs_tpu_torch/csrc/pair_keys.cu",
}
SHAPES = (("B64_n100", 64, 100), ("B8_n100", 8, 100), ("B8_n1000", 8, 1000))
#: Batches the guarded v3 kernels are held and timed at: where v3 takes over
#: from v2, the headline batch, one that is not a multiple of the 64-query
#: tile, and the batch ceiling of the fused kernels.
V3_BATCHES = (16, 64, 100, 256)
#: Batches the keyed v2 kernels are held and timed at on the v3 core (B=8
#: stays on the first core): where the int8 and bf16 KBs run v2 after the
#: n=100 margin check has widened C to 1,600 (past GUARD_MAX_C), and the
#: smallest batch the new core takes.
V2_BATCHES = (16, 64, 256)
#: The candidate count of those calls (it does not reach the kernel).
V2_C = 1600
#: The repo's pairwise benchmark (benchmarks/tpu_pairwise_kb.py): 100k docs
#: x 1536, the top 10,000 pairs; dupe-planted stores plant 12% of every
#: 20,000-row insert chunk as perturbed copies (cos ~0.94).
#: The incremental phase: docs per append and per delete on the 1M store.
APPEND_DOCS = 10_000
DELETE_DOCS = 1_000
PAIR_DOCS = 100_000
PAIR_K = 10_000
PAIR_CHUNK = 20_000
DUPE_FRAC = 0.12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


#: Cycles per second that ``torch.cuda._sleep`` spins at, rounded up from
#: an H100's top SM clock (1.98 GHz), so a hold is never shorter than asked.
SPIN_HZ = 2.0e9


def time_ms(fn, launches: int) -> float:
    """Device time per call of ``fn``: one CUDA event pair around
    ``launches`` calls, after a warm-up call, divided by the count.  A spin
    kernel queued first (``torch.cuda._sleep``) holds the device while the
    host enqueues the calls, so the window holds them back to back on the
    device and not the host's launch gaps.  ``fn`` must not synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t  # enqueue time of one call
    torch.cuda.synchronize()
    hold_s = min(1.0, 3.0 * launches * host_s + 1e-3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SPIN_HZ))
    t = time.perf_counter()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    enqueue_s = time.perf_counter() - t
    end.synchronize()
    if enqueue_s > hold_s:
        log(f"  time_ms: the host took {enqueue_s * 1e3:.2f} ms to enqueue "
            f"{launches} calls, past the {hold_s * 1e3:.2f} ms hold: the "
            f"window may hold launch gaps")
    return start.elapsed_time(end) / launches


def wall_ms(fn, calls: int) -> float:
    """Median host-clock time of one call of ``fn`` that ends in a device
    sync, after a warm-up call: what a caller that waits for the result
    pays, host syncs inside ``fn`` included."""
    import torch

    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


#: Batches of the v2/v3 crossover data (GUARD_MIN_BATCH = 16 is the TPU's
#: static prior for where v3 takes over).
CROSSOVER_BATCHES = (16, 32)


def crossover(label, v2, v3, make_queries, out) -> None:
    """v2 (kernel + finish, its coverage sync included) against v3 (kernel
    + finish) at C = 400, host clock, at each of CROSSOVER_BATCHES."""
    for b in CROSSOVER_BATCHES:
        q = make_queries(b)
        rec = {"v2_ms": wall_ms(lambda: v2(q), 10), "v3_ms": wall_ms(lambda: v3(q), 10)}
        out[f"{label} B={b}"] = rec
        log(f"  crossover {label} B={b}, C=400 (host clock, kernel + finish): "
            f"v2 {rec['v2_ms']:.4f} ms, v3 {rec['v3_ms']:.4f} ms")


def bound(nbytes: float, ops: float, op_type: str) -> tuple:
    """``(bound_ms, bound_by)``: the least time one H100 could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def unit_rows_torch(n: int, d: int, gen, device) -> "torch.Tensor":
    import torch

    m = torch.randn((n, d), generator=gen, device=device, dtype=torch.float32)
    return m / torch.linalg.vector_norm(m, dim=1, keepdim=True)


def lattice_rows_torch(n: int, d: int, gen, device) -> "torch.Tensor":
    """Entries m * 2^-7, m in [-4, 4]: exact in bf16, and every partial sum
    of a dot at d <= 1536 is an exact f32 number (|sum| <= 24,576 * 2^-14),
    so a kernel and its plain version agree bit for bit in any order."""
    import torch

    m = torch.randint(-4, 5, (n, d), generator=gen, device=device, dtype=torch.int8)
    return m.to(torch.float32) / 128.0


def clip_rows_torch(n: int, d: int, gen, device) -> "torch.Tensor":
    """Entries m * 2^-3, m in [-2, 2], with m in {1, 2} on the row pairs
    4j, 4j + 1.  Every product is a multiple of 2^-6 and every partial sum
    of a dot at d <= 1536 is an exact f32 number (|sum| <= 96), so any
    order gives the same bits.  Two positive rows score >= 24 and clip at
    3.0, where v3 keys pass 2^24 and the key of odd lane 4j + 1 rounds (to
    even) onto that of lane 4j."""
    import torch

    m = torch.randint(-2, 3, (n, d), generator=gen, device=device, dtype=torch.int8)
    pos = torch.randint(1, 3, (n, d), generator=gen, device=device, dtype=torch.int8)
    rows = torch.arange(n, device=device)[:, None] % 4 < 2
    return torch.where(rows, pos, m).to(torch.float32) / 8.0


def chunk_edge_rows_torch(n: int, d: int, gen, device, queries: bool) -> "torch.Tensor":
    """Lattice rows (as ``lattice_rows_torch``) with column 0 set: 1.0 in
    every query row; 3.5 in the doc rows 255 and 256 of every 512, whose
    other entries are 0.  Those docs score exactly 3.5 against every
    query, above every lattice score, and past 2^24 the key of lane 255
    rounds (to even) onto that of lane 256: one key on both sides of a
    256-doc chunk boundary, which the chunked merge must keep once."""
    import torch

    rows = lattice_rows_torch(n, d, gen, device)
    if queries:
        rows[:, 0] = 1.0
        return rows
    rows[:, 0] = 0.0
    edge = torch.arange(n, device=device) % 512
    edge = (edge == 255) | (edge == 256)
    rows[edge] = 0.0
    rows[edge, 0] = 3.5
    return rows


def key_collisions(scores, n_valid: int, v3: bool) -> int:
    """Subtiles of a [B, N] score matrix where two live v3 (or v2) keys are
    equal (the keys computed as the plain version computes them)."""
    import torch

    b, n = scores.shape
    w, qscale = (1024, 4096.0) if v3 else (512, 8192.0)
    lane = torch.arange(w, device=scores.device, dtype=torch.float32)
    s = scores.clamp(-3.0, 3.0) if v3 else scores
    keys = torch.floor((s.view(b, -1, w) + 1.0625) * qscale) * float(w) + lane
    live = (torch.arange(n, device=scores.device) < n_valid).view(1, -1, w)
    keys = torch.where(live, keys, -(2.0**24)).sort(dim=2).values
    same = (keys[:, :, 1:] == keys[:, :, :-1]) & (keys[:, :, 1:] > -(2.0**24))
    return int(same.any(dim=2).sum())


def fill_rows(out, n_rows: int, make) -> None:
    """``out[:n_rows] = make(rows)`` in blocks, cast to ``out``'s dtype."""
    for lo in range(0, n_rows, 1 << 17):
        rows = make(min(1 << 17, n_rows - lo))
        out[lo : lo + len(rows)] = rows.to(out.dtype)


def max_abs_err(a, b) -> float:
    import torch

    same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    diff = (a.double() - b.double()).abs()
    finite = torch.isfinite(diff)
    err = float(diff[finite].max()) if bool(finite.any()) else 0.0
    if not same and err == 0.0:
        err = float("nan")  # differing bits that are not a finite gap
    return err


def neg_zeros(x) -> int:
    import torch

    return int(((x == 0) & torch.signbit(x)).sum())


def check_exact(name, got_t, ref_t) -> float:
    import torch

    errs = []
    for g, r in zip(got_t, ref_t):
        if g.shape != r.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(r.shape)}")
        errs.append(max_abs_err(g, r))
        if not torch.equal(g.view(torch.int32), r.view(torch.int32)):
            bad = int((g.view(torch.int32) != r.view(torch.int32)).sum())
            raise AssertionError(
                f"{name}: {bad} of {g.numel()} outputs differ from the plain "
                f"version (max |err| {errs[-1]})"
            )
    return max(errs)


def check_v1_close(name, got_t, ref_t, scores, n_valid) -> float:
    """v1 on random float data, position by position: the kernel's value
    within SCORE_TOL of the plain one, and the row the kernel names scoring
    (in the plain version) within SCORE_TOL of it.  Returns max |value err|."""
    import torch

    (gv, gi), (rv, _) = got_t, ref_t
    live = torch.arange(scores.shape[1], device=scores.device) < n_valid
    masked = torch.where(live, scores, float("-inf"))
    fin = torch.isfinite(rv)
    if not torch.equal(fin, torch.isfinite(gv)):
        raise AssertionError(f"{name}: -inf slots differ from the plain version")
    at = masked.gather(1, gi.long())
    err = float((gv[fin].double() - rv[fin].double()).abs().max())
    err_at = float((at[fin].double() - gv[fin].double()).abs().max())
    if err > SCORE_TOL or err_at > SCORE_TOL:
        raise AssertionError(f"{name}: values off by {err}, named rows off by {err_at}")
    return err


def check_keys_close(name, got, ref, scores, v3, tol=SCORE_TOL) -> float:
    """Keys on random float data, position by position: within one grid
    step of the plain key, and the kernel's key level within ``tol`` of
    the plain score of the doc it names (so a key moves only at a grid
    edge).  v3's dead lanes must match and its guard lane must be the max
    of its own subtile tails.  Returns the largest gap the keys show: how
    far a plain score lies outside the score interval of the kernel's key
    level for the same doc (0.0 when every level holds its score)."""
    import torch

    dev = got.device
    b = got.shape[0]
    if v3:
        nb = got.shape[1] // 128
        g3, r3 = got.view(b, nb, 128), ref.view(b, nb, 128)
        if not torch.equal(g3[:, :, 33:], r3[:, :, 33:]):
            raise AssertionError(f"{name}: dead lanes differ")
        if not torch.equal(g3[:, :, 32], g3[:, :, 3:32:4].amax(dim=2)):
            raise AssertionError(f"{name}: guard lane is not the max of its tails")
        got, ref = g3[:, :, :32].reshape(b, -1), r3[:, :, :32].reshape(b, -1)
        col = torch.arange(nb * 32, device=dev)
        base = (col // 32) * 8192 + ((col % 32) // 4) * 1024
        w, qscale = 1024, 4096.0
    else:
        col = torch.arange(got.shape[1], device=dev)
        base = (col // 8) * 512
        w, qscale = 512, 8192.0
    dead = got == -(2.0**24)
    if not torch.equal(dead, ref == -(2.0**24)):
        raise AssertionError(f"{name}: dead keys differ")
    gi, ri = got.long(), ref.long()
    lg = torch.div(gi, w, rounding_mode="floor")
    lr = torch.div(ri, w, rounding_mode="floor")
    doc = (base[None, :] + gi - lg * w).clamp(0, scores.shape[1] - 1)
    s = scores.gather(1, doc).double()
    if v3:
        s = s.clamp(-3.0, 3.0)
    x = (s + 1.0625) * qscale
    lo = torch.floor(x - tol * qscale)
    hi = torch.floor(x + tol * qscale)
    ok = ((lg - lr).abs() <= 1) & (lg.double() >= lo) & (lg.double() <= hi)
    # the level's scores are [lg, lg + 1) / qscale - KEY_BIAS
    level = lg.double() / qscale - 1.0625
    gap = torch.clamp(torch.maximum(level - s, s - (level + 1.0 / qscale)), min=0.0)
    need = float(gap[~dead].max()) if bool((~dead).any()) else 0.0
    if not bool(ok[~dead].all()):
        bad = int((~ok & ~dead).sum())
        raise AssertionError(
            f"{name}: {bad} keys outside one grid step at an edge (largest "
            f"score gap {need}, tolerance {tol})"
        )
    return need


def int8_pack(n_docs: int, gen, dev) -> tuple:
    """``(docs int8 [n_pad, DIM], row scales f32 [n_pad])``: ``n_docs``
    random unit rows quantized as the engine packs them, padded to a
    multiple of 16,384 rows with zero rows."""
    import torch

    from svs_tpu_torch.ops.quant import quantize_rows_int8

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
    return docs, scales


def pair_block(gen, dev) -> tuple:
    """``(scores [256, p_pad] f32, live bool [256, p_pad])``: rows 50,000..
    of a 100k x 1536 unit corpus padded as the engine pads it, against the
    whole corpus (f32 products, TF32 off), and the strict upper triangle of
    valid columns that the pairwise passes keep."""
    import torch

    from svs_tpu_torch.ops.topk import exact_f32

    p_pad = -(-PAIR_DOCS // 16384) * 16384
    pdocs = torch.zeros((p_pad, DIM), dtype=torch.float32, device=dev)
    fill_rows(pdocs, PAIR_DOCS, lambda r: unit_rows_torch(r, DIM, gen, dev))
    row0 = PAIR_DOCS // 2
    with exact_f32():
        pscores = pdocs[row0 : row0 + 256] @ pdocs.t()
    del pdocs
    cols = torch.arange(p_pad, device=dev)
    rows = torch.arange(row0, row0 + 256, device=dev)
    live = (cols[None, :] > rows[:, None]) & (cols < PAIR_DOCS)[None, :]
    return pscores, live


def finish_input(b: int, v3: bool, n_docs: int, gen, mode: str):
    """Keys for the staged finish from the plain emit (v3 block tiles or
    v2 keys) of ``[b, n_pad]`` scores: ``random``, N(0, 0.03^2) scores
    (about a unit corpus's spread at d = 1536); ``lattice``, scores on a
    1/16 grid that repeat every 8,192 docs, so every 128-lane group holds
    the same level-2 keys; ``dead``, random scores with 24,676 live docs,
    so the rows hold fewer live keys than C."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P

    n_pad = -(-n_docs // 16384) * 16384
    dev = torch.device("cuda")
    if mode == "lattice":
        s = torch.randint(-4, 5, (b, P.FUSED_BLOCK_N), generator=gen, device=dev)
        s = (s.float() / 16.0).repeat(1, n_pad // P.FUSED_BLOCK_N)
        n_valid = n_docs
    else:
        s = torch.randn((b, n_pad), generator=gen, device=dev) * 0.03
        n_valid = n_docs if mode == "random" else 3 * P.FUSED_BLOCK_N + 100
    return (P._v3_emit if v3 else P._v2_emit)(s, n_valid).contiguous()


def finish_checks(compare, src, v3: bool, c: int, n_docs: int, gen) -> None:
    """#2 on ``src`` (timed against its plain version and ``torch.topk``
    of the level-1 keys at the same C), then on lattice keys that tie
    across groups and on dead-padded rows, each bit-identical."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P

    b, width = src.shape
    nb = width // 128
    if v3:
        h2 = P._guard_reduce_h2(nb, c)
        level1 = src.view(b, nb, 128)[:, :, : P.GUARD_KEYS].reshape(b, -1).contiguous()
    else:
        h2 = P._reduce_h2(nb * P.FUSED_BLOCK_N, c)
        level1 = src
    l1 = level1.shape[1]
    kind = "v3 staged" if v3 else "v2"
    compare(
        "_staged_finish",
        lambda: P._staged_finish(src, v3, c, h2),
        lambda: P._staged_finish_plain(src, v3, c, h2),
        f"{kind} keys [{b}, {l1}], h2={h2}, C={c}",
        bound(b * l1 * 4 + b * c * 8, 0.0, "f32"),
        lambda: torch.topk(level1, c, dim=1),
    )
    for mode in ("lattice", "dead"):
        keys = finish_input(b, v3, n_docs, gen, mode)
        got = P._staged_finish(keys, v3, c, h2)
        torch.cuda.synchronize()
        ref = P._staged_finish_plain(keys, v3, c, h2)
        check_exact(f"_staged_finish {kind} B={b} {mode}", got, ref)
        note = f"{int(ref[2].ne(0).sum())} rows flagged" if not v3 else (
            f"{int(torch.isinf(ref[2]).sum())} rows with an infinite bound")
        log(f"  _staged_finish {kind} [{b}, {l1}] h2={h2} C={c} on {mode} keys "
            f"({note}): bit-identical")
        del keys, got, ref


def kernel_phase(n_docs: int, reps: int, cross: dict) -> dict:
    """Each kernel against its plain version on synthetic full-size packs,
    at the main paths' shapes; returns per-kernel records, and fills
    ``cross`` with the v2/v3 crossover data."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P
    from svs_tpu_torch.ops.quant import _int8_scores, quantize_rows_int8
    from svs_tpu_torch.ops.topk import mask_cols, scores_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    docs, scales = int8_pack(n_docs, gen, dev)
    n_pad = docs.shape[0]
    nb = n_pad // P.FUSED_BLOCK_N
    log(f"kernel phase: pack {n_pad} x {DIM} int8 (n_valid {n_docs}, nb {nb})")

    def queries(b: int):
        q8, qs = quantize_rows_int8(unit_rows_torch(b, DIM, gen, dev))
        return q8.contiguous(), qs.contiguous()

    records = {}

    def record(name, what, err, kernel_fn, plain_fn, bnd, library_fn=None):
        ms = time_ms(kernel_fn, reps)
        plain_ms = time_ms(plain_fn, max(3, reps // 4))
        lib_ms = None if library_fn is None else time_ms(library_fn, reps)
        log(f"  {name} {what}: max |err| {err}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms}, bound {bnd[0]:.4f} ms ({bnd[1]})")
        records.setdefault(name, []).append({
            "what": what, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
        })

    def compare(name, kernel_fn, plain_fn, what, bnd, library_fn=None):
        got = kernel_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        got_t = got if isinstance(got, tuple) else (got,)
        ref_t = ref if isinstance(ref, tuple) else (ref,)
        err = check_exact(f"{name} ({what})", got_t, ref_t)
        record(name, what, err, kernel_fn, plain_fn, bnd, library_fn)
        return got_t[0]

    def fused_int8_bound(b, out_cols):
        return bound(
            nbytes(docs, scales) + b * (DIM + 4) + b * out_cols * 4,
            2.0 * b * n_pad * DIM, "int8",
        )

    # #1 guarded v3 at every batch of V3_BATCHES (C <= 1024: C does not
    # reach the kernel), bit-identical
    outs3 = {}
    for b in V3_BATCHES:
        q8, qs = queries(b)
        args = (docs, scales, q8, qs, n_docs)
        got = compare(
            "_fused3_extract_int8",
            lambda: P._fused3_extract_int8(*args),
            lambda: P._fused3_extract_int8_plain(*args),
            f"B={b} (v3, C=400)",
            fused_int8_bound(b, nb * 128),
        )
        if b in (64, 256):
            outs3[b] = got
        del got
    crossover(
        "int8",
        lambda q: P.fused2_topk_int8(docs, scales, q, n_docs, 400),
        lambda q: P.fused3_candidates_int8(docs, scales, q, n_docs, 400),
        lambda b: unit_rows_torch(b, DIM, gen, dev),
        cross,
    )
    # #3 keyed v2 on the v3 core at V2_BATCHES (and at B=100, a batch that is
    # not a multiple of the 64-query tile, checked only), bit-identical
    for b in V2_BATCHES + (100,):
        q8, qs = queries(b)
        args = (docs, scales, q8, qs, n_docs)
        what = f"B={b} (v2, C={V2_C})"
        if b == 100:
            check_exact(f"_fused2_extract_int8 ({what})",
                        (P._fused2_extract_int8(*args),),
                        (P._fused2_extract_int8_plain(*args),))
            log(f"  _fused2_extract_int8 {what}: bit-identical")
            continue
        got = compare(
            "_fused2_extract_int8",
            lambda: P._fused2_extract_int8(*args),
            lambda: P._fused2_extract_int8_plain(*args),
            what,
            fused_int8_bound(b, n_pad // 64),
        )
        if b == 64:
            keys2_64 = got
        del got
    # #3 keyed v2 at B = 8, k = 400 (the first core)
    q8, qs = queries(8)
    args = (docs, scales, q8, qs, n_docs)
    keys2 = compare(
        "_fused2_extract_int8",
        lambda: P._fused2_extract_int8(*args),
        lambda: P._fused2_extract_int8_plain(*args),
        "B=8 (v2, k=400)",
        fused_int8_bound(8, n_pad // 64),
    )
    # #2, the staged finish, on the keys #1 and #3 gave: v3 at B = 64 and
    # 256 (C = 400), v2 at B = 8 (k = 400) and B = 64 (C = 1,600)
    finish_cases = (
        (outs3[64], True, 400), (outs3[256], True, 400),
        (keys2, False, 400), (keys2_64, False, V2_C),
    )
    for src, v3, c in finish_cases:
        finish_checks(compare, src, v3, c, n_docs, gen)
    del outs3, keys2, keys2_64, finish_cases
    # #2 past the shared-memory limit, on v2 keys of corpora well past 1M
    # docs: 8M docs at C = 16,000 (n = 1,000 after one widen: the sort
    # buffer goes to global scratch), 33.6M docs at C = 1,600 (65,792
    # winners: a 32-bit column field, the winners go to scratch) and at
    # C = 20,000 (both go)
    for b, blocks, c in ((8, 977, 16_000), (4, 4100, V2_C), (2, 4100, 20_000)):
        n_big = blocks * P.FUSED_BLOCK_N
        src = finish_input(b, False, n_big, gen, "random")
        finish_checks(compare, src, False, c, n_big, gen)
        del src
        torch.cuda.empty_cache()
    # #4 v1 at B = 8, k = 4000
    compare(
        "_fused_extract_int8",
        lambda: P._fused_extract_int8(*args),
        lambda: P._fused_extract_int8_plain(*args),
        "B=8 (v1, k=4000)",
        fused_int8_bound(8, 2 * n_pad // 64),
    )
    # #8 on the [512, n_pad] f32 score matrix of the int8 pack at B = 512,
    # as score_topk_int8_extract_packed hands it over; then on the same
    # matrix rounded to a 2^-7 grid (thousands of exact ties)
    q512 = unit_rows_torch(512, DIM, gen, dev)
    scores = mask_cols(_int8_scores(docs, scales, q512), n_docs).contiguous()
    del docs, scales
    torch.cuda.empty_cache()
    out_cols = (n_pad // P.SUBTILE) * P.EXTRACT_H
    ext_bound = bound(nbytes(scores) + 2 * 512 * out_cols * 4, 0.0, "f32")
    compare(
        "_extract",
        lambda: P._extract(scores),
        lambda: P._extract_plain(scores),
        f"scores [512, {n_pad}] (int8 pack, B=512)",
        ext_bound,
        lambda: torch.topk(scores.view(512, -1, P.SUBTILE), P.EXTRACT_H, dim=2),
    )
    # adversarial inputs at the same shape, bit-identical to the plain
    # version: the scores on a 2^-7 grid (ties, and -0.0 beside +0.0)
    neg_inf = float("-inf")
    ties = torch.round(scores * 128.0) / 128.0
    ref = P._extract_plain(ties)
    check_exact("_extract (2^-7 grid ties)", P._extract(ties), ref)
    log(f"  _extract on a 2^-7 grid of the same scores "
        f"({int((ref[0] == 0).sum())} zero maxima, {neg_zeros(ties)} entries "
        f"-0.0): bit-identical")
    del ref
    # four distinct values, so the highest-column rule decides most rounds
    ties = mask_cols(
        torch.randint(1, 5, scores.shape, generator=gen, device=dev,
                      dtype=torch.int32).float() / 4.0,
        n_docs,
    )
    check_exact("_extract (4 distinct values)", P._extract(ties), P._extract_plain(ties))
    log("  _extract on 4 distinct values per subtile: bit-identical")
    del ties
    # whole rows -inf, every third subtile -inf, a row of 244 live entries
    dry = scores
    del scores
    dry[:8] = neg_inf
    dry.view(512, -1, P.SUBTILE)[8:, ::3] = neg_inf
    keep = dry[9, ::4099].clone()
    dry[9] = neg_inf
    dry[9, ::4099] = keep
    check_exact("_extract (-inf rows and subtiles)", P._extract(dry), P._extract_plain(dry))
    log("  _extract with -inf rows and subtiles: bit-identical")
    del dry, keep
    torch.cuda.empty_cache()

    # #5-#7 on bf16 and f32 packs: lattice data bit-identical, v3 on
    # clipped colliding keys bit-identical, then random unit data within
    # tolerance (timed)
    float_cases = tuple(
        ("_fused3_extract", b, "v3, C=400", nb * 128, 1) for b in V3_BATCHES
    ) + tuple(
        ("_fused2_extract", b, f"v2, C={V2_C}", n_pad // 64, 1) for b in V2_BATCHES
    ) + (
        ("_fused2_extract", 8, "v2, k=400", n_pad // 64, 1),
        ("_fused_extract", 8, "v1, k=4000", n_pad // 64, 2),
    )
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fdocs = torch.zeros((n_pad, DIM), dtype=dt, device=dev)
        fill_rows(fdocs, n_docs, lambda r: lattice_rows_torch(r, DIM, gen, dev))
        for name, b, what, cols, outs in float_cases:
            q = lattice_rows_torch(b, DIM, gen, dev).to(dt)
            got = getattr(P, name)(fdocs, q, n_docs)
            torch.cuda.synchronize()
            ref = getattr(P, name + "_plain")(fdocs, q, n_docs)
            got_t = got if isinstance(got, tuple) else (got,)
            ref_t = ref if isinstance(ref, tuple) else (ref,)
            check_exact(f"{name} {dt_name} lattice", got_t, ref_t)
            log(f"  {name} {dt_name} B={b} ({what}) on lattice data: bit-identical")
        # scores past 3.0 (clipped by v3, not by v2): their keys pass 2^24
        # and collide, and the chunked top-4 (v3) and top-8 (v2) merges
        # must keep clear-every-equal
        fill_rows(fdocs, n_docs, lambda r: clip_rows_torch(r, DIM, gen, dev))
        for name, b in (("_fused3_extract", 64), ("_fused3_extract", 256),
                        ("_fused2_extract", 16), ("_fused2_extract", 256)):
            q = clip_rows_torch(b, DIM, gen, dev).to(dt)
            got = getattr(P, name)(fdocs, q, n_docs)
            torch.cuda.synchronize()
            check_exact(f"{name} {dt_name} B={b} past 2^24", (got,),
                        (getattr(P, name + "_plain")(fdocs, q, n_docs),))
            collide = key_collisions(scores_matmul(fdocs, q), n_docs,
                                     v3=name == "_fused3_extract")
            if collide == 0:
                raise AssertionError(f"the {name} input past 2^24 has no colliding keys")
            log(f"  {name} {dt_name} B={b} on scores past 2^24 "
                f"({collide} subtiles with colliding keys): bit-identical")
            del got
        fill_rows(fdocs, n_docs,
                  lambda r: chunk_edge_rows_torch(r, DIM, gen, dev, queries=False))
        q = chunk_edge_rows_torch(64, DIM, gen, dev, queries=True).to(dt)
        for name in ("_fused3_extract", "_fused2_extract"):
            got = getattr(P, name)(fdocs, q, n_docs)
            torch.cuda.synchronize()
            check_exact(f"{name} {dt_name} B=64 chunk edges", (got,),
                        (getattr(P, name + "_plain")(fdocs, q, n_docs),))
            del got
        log(f"  _fused3_extract / _fused2_extract {dt_name} B=64 with equal keys "
            f"across every 256-doc chunk boundary at 255/256: bit-identical")
        torch.cuda.empty_cache()
        fill_rows(fdocs, n_docs, lambda r: unit_rows_torch(r, DIM, gen, dev))
        crossover(
            dt_name,
            lambda q: P.fused2_topk(fdocs, q, n_docs, 400),
            lambda q: P.fused3_candidates(fdocs, q, n_docs, 400),
            lambda b: unit_rows_torch(b, DIM, gen, dev),
            cross,
        )
        for name, b, what, cols, outs in float_cases:
            q = unit_rows_torch(b, DIM, gen, dev).to(dt).contiguous()
            got = getattr(P, name)(fdocs, q, n_docs)
            torch.cuda.synchronize()
            ref = getattr(P, name + "_plain")(fdocs, q, n_docs)
            s = scores_matmul(fdocs, q)
            label = f"{name} {dt_name} B={b}"
            if name == "_fused_extract":
                err = check_v1_close(label, got, ref, s, n_docs)
            else:
                err = check_keys_close(label, got, ref, s, v3=name == "_fused3_extract")
            del s
            bnd = bound(
                nbytes(fdocs, q) + outs * b * cols * 4,
                2.0 * b * n_pad * DIM, dt_name,
            )
            record(
                name, f"{dt_name} B={b} ({what})", err,
                lambda: getattr(P, name)(fdocs, q, n_docs),
                lambda: getattr(P, name + "_plain")(fdocs, q, n_docs),
                bnd,
            )
        del fdocs
        torch.cuda.empty_cache()

    # #9 on a [256, 114,688] block of real pair scores (rows 50,000.. of a
    # 100k x 1536 unit corpus padded as the engine pads it), masked to the
    # strict upper triangle with PAIR_MASKED as the keyed pass masks it;
    # then #8 on the same block masked with -inf, as the exact pass has it
    pscores, live = pair_block(gen, dev)
    p_pad = pscores.shape[1]
    keyed_in = torch.where(live, pscores, P.PAIR_MASKED).contiguous()
    out_cols = (p_pad // P.PAIR_BLOCK_N) * 128
    compare(
        "pairwise_keys_extract",
        lambda: P.pairwise_keys_extract(keyed_in),
        lambda: P._pair_keys_plain(keyed_in),
        f"pair scores [256, {p_pad}] (100k x {DIM} unit corpus)",
        bound(nbytes(keyed_in) + 256 * out_cols * 4, 5.0 * keyed_in.numel(), "f32"),
        lambda: torch.topk(keyed_in.view(256, -1, P.FUSED_SUBTILE), P.EXTRACT_H, dim=2),
    )
    # adversarial inputs at the same shape, bit-identical to the plain
    # version: five distinct scores (equal key levels: the lane decides)
    few = torch.randint(-2, 3, keyed_in.shape, generator=gen, device=dev,
                        dtype=torch.int32).float() / 8.0
    few = torch.where(live, few, P.PAIR_MASKED)
    check_exact("pairwise_keys_extract (5 distinct scores)",
                P.pairwise_keys_extract(few), P._pair_keys_plain(few))
    del few
    # whole rows and every third subtile at PAIR_MASKED
    dry = keyed_in.clone()
    dry[:8] = P.PAIR_MASKED
    dry.view(256, -1, P.FUSED_SUBTILE)[8:, ::3] = P.PAIR_MASKED
    check_exact("pairwise_keys_extract (masked rows and subtiles)",
                P.pairwise_keys_extract(dry), P._pair_keys_plain(dry))
    del dry
    # past the key horizon (s > 2.94): keys of 2^24 and more lose lane
    # bits and collide, so one round clears several entries; half the rows
    # on a 1/16 grid collide more
    far = keyed_in.abs() + 2.95
    far[:128] = torch.round(far[:128] * 16.0) / 16.0
    lane = torch.arange(P.FUSED_SUBTILE, device=dev, dtype=torch.float32)
    keys = torch.floor((far.view(256, -1, P.FUSED_SUBTILE) + P.KEY_BIAS) * P.KEY_QSCALE) * 512.0 + lane
    keys = keys.sort(dim=2).values
    collide = int((keys[:, :, 1:] == keys[:, :, :-1]).any(dim=2).sum())
    del keys
    if collide == 0:
        raise AssertionError("the past-horizon pair block has no colliding keys")
    check_exact("pairwise_keys_extract (past the key horizon)",
                P.pairwise_keys_extract(far), P._pair_keys_plain(far))
    log(f"  pairwise_keys_extract on 5-value, masked and past-horizon blocks "
        f"({collide} subtiles with colliding keys): bit-identical")
    del far
    exact_in = torch.where(live, pscores, float("-inf")).contiguous()
    del keyed_in, pscores
    out_cols = (p_pad // P.SUBTILE) * P.EXTRACT_H
    compare(
        "_extract",
        lambda: P._extract(exact_in),
        lambda: P._extract_plain(exact_in),
        f"pair scores [256, {p_pad}] (exact pairwise block)",
        bound(nbytes(exact_in) + 2 * 256 * out_cols * 4, 0.0, "f32"),
        lambda: torch.topk(exact_in.view(256, -1, P.SUBTILE), P.EXTRACT_H, dim=2),
    )
    ties = torch.round(exact_in * 8.0) / 8.0
    ref = P._extract_plain(ties)
    check_exact("_extract (pair block on a 1/8 grid)", P._extract(ties), ref)
    log(f"  _extract on the pair block rounded to a 1/8 grid "
        f"({int((ref[0] == 0).sum())} zero maxima, {neg_zeros(ties)} entries "
        f"-0.0): bit-identical")
    del exact_in, ties, ref
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


def hits_to_arrays(results) -> tuple:
    """Doc rows (doc ``i`` holds row ``i``) and scores of a hit list."""
    rows = np.asarray(
        [[int(h["doc"]["text"].rsplit("#", 1)[1]) for h in hits] for hits in results]
    )
    scores = np.asarray([[h["score"] for h in hits] for hits in results], dtype=np.float64)
    return rows, scores


def check_results(rows, scores, qvecs, ref_matrix, n, dead=None) -> None:
    """Every result row is the brute-force top-n of ``ref_matrix`` (f32
    dots, TF32 off) over its rows that ``dead`` (bool [N]) does not mark:
    ids identical except between scores closer than SCORE_TOL (the
    reference tie rule, larger row first, orders the scan), and every
    score within SCORE_TOL of the true dot."""
    import torch

    from svs_tpu_torch.ops.topk import exact_f32

    q = torch.from_numpy(np.ascontiguousarray(qvecs, dtype=np.float32)).cuda()
    with exact_f32():
        exact = q @ ref_matrix.t()  # [B, N]
    if dead is not None:
        hit = dead.cpu().numpy()[np.asarray(rows)]
        if hit.any():
            raise AssertionError(f"{int(hit.sum())} hits are deleted rows")
        exact = torch.where(dead[None, :], float("-inf"), exact)
    cand_v, cand_i = torch.topk(exact, n + 64, dim=1)
    for b in range(len(rows)):
        if len(rows[b]) != n:
            raise AssertionError(f"query {b}: {len(rows[b])} hits, want {n}")
        if not np.isfinite(scores[b]).all():
            raise AssertionError(f"query {b}: non-finite scores")
        true_of_rows = exact[b, torch.from_numpy(rows[b]).cuda()].double().cpu().numpy()
        if np.abs(scores[b] - true_of_rows).max() > SCORE_TOL:
            raise AssertionError(f"query {b}: scores off by {np.abs(scores[b] - true_of_rows).max()}")
        cv = cand_v[b].cpu().numpy()
        ci = cand_i[b].cpu().numpy()
        order = np.lexsort((-ci, -cv))[:n]
        ref_rows, ref_scores = ci[order], cv[order].astype(np.float64)
        for j in range(n):
            if rows[b][j] != ref_rows[j] and abs(true_of_rows[j] - ref_scores[j]) >= SCORE_TOL:
                raise AssertionError(
                    f"query {b} rank {j}: row {rows[b][j]} (score "
                    f"{true_of_rows[j]:.9f}) where the scan has row "
                    f"{ref_rows[j]} ({ref_scores[j]:.9f})"
                )


def unit_queries(rng, b: int) -> np.ndarray:
    v = rng.standard_normal((b, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def drive_path(label, expected, fn, out) -> None:
    """One path with the launch counts set to 0 just before it and read
    just after; fails if an expected kernel did not launch."""
    from svs_tpu_torch.ops import pallas_extract as P

    P.reset_launch_counts()
    fn()
    counts = P.launch_counts()
    out["paths"][label] = {"launches": counts}
    for k, v in counts.items():
        out["launches"][k] = out["launches"].get(k, 0) + v
    missing = [k for k in expected if counts[k] <= 0]
    log(f"e2e {label} launches {counts}")
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")


def settle(engine, res: dict, label: str) -> None:
    """After a ``KB``'s first call: ``wait_for_mirror()`` (the deferred
    pack upload and the background f32 mirror), so that the warm calls
    measure the device route with its mirror as before the deferral;
    records the seconds and fails when the wait did not settle or an
    upload failed (``pack_upload_failures``, ``mirror_upload_failures``)."""
    t = time.perf_counter()
    ok = engine.wait_for_mirror(timeout=600)
    res["settle_s"] = time.perf_counter() - t
    stats = engine.dispatch_stats()
    if not ok or stats["pack_upload_failures"] or stats["mirror_upload_failures"]:
        raise AssertionError(f"{label}: the uploads did not settle ({ok}, {stats})")


def first_call(kb, label: str) -> dict:
    """How a ``KB``'s first call went (its ``kb.stats()`` since the last
    reset): the route (``host`` when ``host_search`` answered), its
    ``pack`` phase (s), the scan that packed it (``native_parallel``,
    ``native``, ``stream``; None for a sidecar load or a reuse); then
    :func:`settle` when an upload is in flight."""
    snap = kb._stats.snapshot()
    first = {
        "route": "host" if "host_search" in snap else "device",
        "pack_s": snap["pack"]["last_s"] if "pack" in snap else None,
        "scan": kb.engine.last_scan,
        "scan_split_s": kb.engine.last_scan_split,
        "uploading": kb.engine.pack_uploading or kb.engine.mirror_uploading,
    }
    if first["uploading"]:
        settle(kb.engine, first, label)
    return first


def kb_shapes(kb, shapes, reps, rng, qvec, scan, out, v3=None) -> None:
    """``retrieve_batch`` at each shape, ``reps`` times, each result held
    against the brute-force scan ``scan(queries) -> (scan queries, scan
    matrix)``; records first and warm latencies and the launches of each
    shape's calls.  ``v3`` names the guarded v3 wrapper that must launch
    in every shape of 64 queries or more.  After each shape's first call
    (:func:`first_call`) the KB's background uploads settle."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P

    for label, b, n in shapes:
        lat = []
        kb._stats.reset()
        before = P.launch_counts()
        for rep in range(reps):
            v = unit_queries(rng, b)
            texts = [f"{label}-{rep}-{i}" for i in range(b)]
            qvec.update(zip(texts, v))
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = kb.retrieve_batch(texts, n)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
            check_results(*hits_to_arrays(res), *scan(v), n)
            if rep == 0:
                first = first_call(kb, label)
        warm = lat[1:] if len(lat) > 1 else lat
        launches = {k: v - before[k] for k, v in P.launch_counts().items()}
        if v3 is not None and 64 <= b <= P.FUSED_MAX_BATCH and launches[v3] <= 0:
            raise AssertionError(f"{label}: the guarded v3 kernel ({v3}) did not launch")
        out[label] = {
            "launches": launches,
            "first": first,
            "first_s": lat[0],
            "warm_p50_ms": statistics.median(warm) * 1e3,
            "warm_ms": [x * 1e3 for x in warm],
            # per-phase host-clock p50s over this shape's calls
            "phase_p50_ms": {
                k: v["p50_s"] * 1e3 for k, v in kb._stats.snapshot().items()
            },
            "widen_retries": kb.engine.widen_retries,
        }
        log(f"e2e {label}: first {lat[0]:.3f} s ({first}), warm p50 "
            f"{out[label]['warm_p50_ms']:.2f} ms over {len(warm)}; exact vs scan; "
            f"launches {({k: v for k, v in launches.items() if v})}")


def e2e_phase(n_docs: int, reps: int, work: Path) -> dict:
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.engine.sidecar import sidecar_path_for

    store = work / "store.sqlite"
    native = native_phase()
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
    out = {"store_write_s": t_write, "docs": n_docs, "paths": {}, "launches": {},
           "native": native}
    fused_int8 = ["_fused3_extract_int8", "_fused2_extract_int8", "_fused_extract_int8"]
    fused_float = ["_fused3_extract", "_fused2_extract", "_fused_extract"]
    try:
        def f32_scan(v):
            return v, ref_matrix

        def kb_path(label, expected, shapes, scan, check=None, v3=None,
                    after=None, **options):
            res = out[f"paths_detail_{label}"] = {}

            def run():
                kb = svs_tpu_torch.KB(store, embed, device="cuda", **options)
                try:
                    if check is not None:
                        check(kb)
                    kb_shapes(kb, shapes, reps, rng, qvec, scan, res, v3=v3)
                    if after is not None:
                        after(kb, res)
                    res["pack_events"] = dict(kb.engine.pack_events)
                finally:
                    kb.close()

            drive_path(label, expected, run, out)
            torch.cuda.empty_cache()

        def profile_call(kb, res, label, b, n):
            """One call of ``b`` new queries unprofiled and profiled
            (``device_idle_share``), then once more for its phase times."""
            texts = [f"{label}-{i}" for i in range(b)]
            qvec.update(zip(texts, unit_queries(rng, b)))
            prof = res[label] = device_idle_share(lambda: kb.retrieve_batch(texts, n))
            kb._stats.reset()
            kb.retrieve_batch(texts, n)
            prof["phases_ms"] = {
                k: v["last_s"] * 1e3 for k, v in kb._stats.snapshot().items()
            }
            second = prof["second_profile"]
            log(f"e2e {label}: unprofiled {prof['unprofiled_wall_ms']:.2f} ms "
                f"(then phases {({k: round(v, 2) for k, v in prof['phases_ms'].items()})} "
                f"ms); profiled {second['wall_ms']:.2f} ms, kernels "
                f"{second.get('kernel_ms')} ms in {second.get('kernel_launches')} "
                f"launches (idle share {second['idle_share']})")
            for name, k in second.get("top_kernels", {}).items():
                log(f"  {k['ms']:.3f} ms = {k['launches']} x "
                    f"{k['us_per_launch']:.2f} us  {name}")
            for name, k in second.get("top_host_ops", {}).items():
                log(f"  host {k['self_ms']:.3f} ms self over {k['count']}  {name}")

        def loaded(kb, res):
            """``load()`` (the hydration prewarm), the B=64 shape again
            (``finalize`` p50 before: the shape's first run; after: this
            one), then one B=64 call unprofiled and profiled."""
            t = time.perf_counter()
            kb.load()  # also writes <store>.svsx (1M docs >= SIDECAR_AUTO_MIN_DOCS)
            res["load_s"] = time.perf_counter() - t
            sc = sidecar_path_for(store)
            res["sidecar_gb"] = sc.stat().st_size / 1e9 if sc.exists() else None
            log(f"e2e int8_kb: load() wrote a {res['sidecar_gb']} GB sidecar")
            kb_shapes(kb, (("B64_n100_loaded", 64, 100),), reps, rng, qvec,
                      f32_scan, res)
            before = res["B64_n100"]["phase_p50_ms"]
            after = res["B64_n100_loaded"]["phase_p50_ms"]
            log(f"e2e int8_kb: load() {res['load_s']:.2f} s; B=64, n=100 "
                f"finalize p50 {before['finalize']:.2f} -> "
                f"{after['finalize']:.2f} ms, device_search p50 "
                f"{before['device_search']:.2f} -> {after['device_search']:.2f} ms")
            profile_call(kb, res, "profiled_B64_n100", 64, 100)

        # int8 (precision='auto').  B=64 first: the engine's per-n width
        # hint is shared by every batch size, and a widened hint
        # (C > GUARD_MAX_C) would keep the guarded v3 kernel off for the
        # rest of the run
        kb_path("int8_kb", fused_int8 + ["_staged_finish", "_extract"],
                SHAPES + (("B512_n100", 512, 100),), f32_scan,
                v3="_fused3_extract_int8", after=loaded)
        # v3 at the fused kernels' batch ceiling, on a KB of its own: the
        # int8 KB's n=100 hint has widened past GUARD_MAX_C by now
        kb_path("int8_kb_b256", ["_fused3_extract_int8", "_staged_finish"],
                (("B256_n100", 256, 100),), f32_scan, v3="_fused3_extract_int8",
                after=lambda kb, res: profile_call(kb, res, "profiled_B256_n100",
                                                   256, 100))
        kb_path("bf16_kb", fused_float + ["_staged_finish"], SHAPES, f32_scan,
                v3="_fused3_extract", precision="bf16")
        # f32 storage: the pack is its own rescore mirror
        kb_path("f32_kb", fused_float + ["_staged_finish"], SHAPES, f32_scan,
                v3="_fused3_extract", precision="f32")

        # the host-finalised rescore: no device mirror; the prescored
        # candidates are rescored by one BLAS matvec per query over the
        # pack's host f32 cache (B=64 first: v3 on its first call)
        def no_mirror(kb, res):
            if kb.engine.corpus.dev_rescore is not None:
                raise AssertionError("device_rescore='host' built a device mirror")

        kb_path("host_rescore",
                ["_fused3_extract_int8", "_fused2_extract_int8", "_staged_finish"],
                (("B64_n100", 64, 100), ("B8_n100", 8, 100), ("B256_n100", 256, 100)),
                f32_scan, after=no_mirror, precision="int8", device_rescore="host")

        # rescore=False returns raw prescores ('auto' stores bf16): the scan
        # is of the bf16-rounded corpus and queries (f32 dots, TF32 off)
        ref_bf16 = ref_matrix.to(torch.bfloat16).to(torch.float32)

        def bf16_scan(v):
            vb = torch.from_numpy(v).to(torch.bfloat16).to(torch.float32).numpy()
            return vb, ref_bf16

        def is_bf16(kb):
            assert kb.engine.precision == "bf16", kb.engine.precision

        kb_path("rescore_off_kb", ["_fused_extract"], (("B8_n100", 8, 100),),
                bf16_scan, check=is_bf16, rescore=False)
        del ref_bf16
        # the native phase: every full rescan of the 1M store above
        scans = native["rescans"] = {}
        for label in ("int8_kb", "bf16_kb", "f32_kb", "rescore_off_kb"):
            detail = out[f"paths_detail_{label}"]
            first_shape = next(iter(v for v in detail.values() if isinstance(v, dict) and "first" in v))
            scans[label] = {
                k: first_shape["first"][k] for k in ("pack_s", "scan", "scan_split_s", "route")
            }
            log(f"e2e native: {label} packed by a {scans[label]['scan']} scan, "
                f"pack phase {scans[label]['pack_s']:.2f} s (split "
                f"{scans[label]['scan_split_s']}); its first call on the "
                f"{scans[label]['route']} route")
        native["store_read"] = read_rate(store, 2 << 30)
        log(f"e2e native: read the store's first {native['store_read']['bytes'] / 1e9:.2f} GB "
            f"at {native['store_read']['gb_per_s']:.2f} GB/s (what the scans read from)")
        native["count_star_s"] = count_star_s(store)
        log(f"e2e native: SELECT count(*) over the embeddings took "
            f"{native['count_star_s']:.2f} s (a walk of every leaf page: a rescan "
            f"makes one for its count, and one more across its range counts)")
        cold_start_phase(store, ref_matrix, reps, out)
        host_route_phase(store, ref_matrix, reps, work, out)
        filters_phase(store, ref_matrix, reps, out)
        ref_matrix = incremental_phase(store, ref_matrix, reps, out)
    finally:
        store.unlink(missing_ok=True)
        sidecar_path_for(store).unlink(missing_ok=True)
    del ref_matrix
    torch.cuda.empty_cache()
    pairwise_phase(work, out)
    return out


def native_phase() -> dict:
    """Loads the native host library (``svs_tpu_torch.native``, built with
    ``g++`` from the checkout at first use) and fails when it does not:
    the scans, the fused pack and the host two-pass run on it.  Records
    its build seconds and path, and the host's thread counts (torch's, and
    NumPy's BLAS pools when ``threadpoolctl`` is there)."""
    import os

    import torch

    from svs_tpu_torch import native

    t = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the native host library did not build or load")
    res = {
        "load_s": time.perf_counter() - t,
        "build_s": native.build_seconds,
        "library": str(native.library_path()),
        "torch_threads": torch.get_num_threads(),
        "cpu_count": os.cpu_count(),
    }
    try:
        from threadpoolctl import threadpool_info

        res["blas_threads"] = {
            i.get("internal_api", "?"): i.get("num_threads") for i in threadpool_info()
        }
    except ImportError:
        res["blas_threads"] = "not measured (no threadpoolctl)"
    log(f"e2e native: library built in {res['build_s']:.1f} s (load "
        f"{res['load_s']:.1f} s) -> {res['library']}; torch threads "
        f"{res['torch_threads']}, BLAS {res['blas_threads']}, {res['cpu_count']} CPUs")
    return res


def count_star_s(path: Path) -> float:
    """Seconds of one ``SELECT count(*) FROM embeddings`` on the store (a
    walk of every leaf page of the table)."""
    import sqlite3

    conn = sqlite3.connect(str(path))
    try:
        t = time.perf_counter()
        conn.execute("SELECT count(*) FROM embeddings;").fetchone()
        return time.perf_counter() - t
    finally:
        conn.close()


def read_rate(path: Path, limit: int) -> dict:
    """Seconds and GB/s of one sequential read of the first ``limit`` bytes
    of ``path`` in 64 MB reads, through the page cache as the scans read
    it."""
    t = time.perf_counter()
    done = 0
    with open(path, "rb", buffering=0) as f:
        while done < limit:
            got = f.read(min(64 << 20, limit - done))
            if not got:
                break
            done += len(got)
    dt = time.perf_counter() - t
    return {"bytes": done, "s": dt, "gb_per_s": done / dt / 1e9}


def cold_start_phase(store: Path, ref_matrix, reps: int, out: dict) -> None:
    """A cold open of the 1M int8 store from its sidecar, as every process
    start or reopen of a published store: a ``KB`` with no ``load()``, at
    once one B=64, n=100 call (its route, wall time, and whether the pack
    was still uploading when the route was chosen), then
    ``wait_for_mirror()`` (its seconds), then ``reps`` more calls on the
    device route (warm p50).  Every call is exact against the brute-force
    scan; fails when the first call took the device route while the pack
    uploaded, a later one the host route, an upload failed or the f32
    mirror is not live."""
    import torch

    import svs_tpu_torch

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 7)
    res = out["paths_detail_cold_start"] = {}

    def call(kb, label):
        v = unit_queries(rng, 64)
        texts = [f"{label}-{i}" for i in range(64)]
        qvec.update(zip(texts, v))
        torch.cuda.synchronize()
        t = time.perf_counter()
        hits = kb.retrieve_batch(texts, 100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check_results(*hits_to_arrays(hits), v, ref_matrix, 100)
        return wall

    def run():
        kb = svs_tpu_torch.KB(store, embed, device="cuda")
        try:
            eng = kb.engine
            seen = []
            real = eng.host_route

            def spy(corpus, batch, k=None):
                routed = real(corpus, batch, k=k)
                seen.append({"pack_uploading": not corpus.device_ready, "host": routed})
                return routed

            eng.host_route = spy
            kb._stats.reset()
            res["first_s"] = call(kb, "cold-0")
            snap = kb._stats.snapshot()
            res["first"] = seen[0]
            res["first_host_searches"] = snap.get("host_search", {}).get("count", 0)
            res["first_phases_ms"] = {k: v["last_s"] * 1e3 for k, v in snap.items()}
            res["pack_events"] = dict(eng.pack_events)
            del eng.host_route
            t = time.perf_counter()
            settled = eng.wait_for_mirror(timeout=600)
            res["wait_for_mirror_s"] = time.perf_counter() - t
            host_before = kb.stats().get("host_search", {}).get("count", 0)
            lat = [call(kb, f"cold-{i + 1}") for i in range(reps)]
            res["warm_p50_ms"] = statistics.median(lat) * 1e3
            res["warm_ms"] = [x * 1e3 for x in lat]
            res["dispatch"] = eng.dispatch_stats()
            res["mirror_live"] = eng.corpus.dev_rescore is not None
            host_after = kb.stats().get("host_search", {}).get("count", 0)
            log(f"e2e cold_start: first call {res['first_s']:.3f} s on the "
                f"{'host' if seen[0]['host'] else 'device'} route (pack uploading "
                f"when routed: {seen[0]['pack_uploading']}; phases "
                f"{({k: round(v, 1) for k, v in res['first_phases_ms'].items()})} ms); "
                f"wait_for_mirror {res['wait_for_mirror_s']:.2f} s; warm p50 "
                f"{res['warm_p50_ms']:.2f} ms over {reps} on the device route; "
                f"dispatch {res['dispatch']}; exact vs scan")
            if res["pack_events"].get("sidecar") != 1 or res["pack_events"].get("scan"):
                raise AssertionError(f"cold_start: not a sidecar open: {res['pack_events']}")
            if len(seen) != 1 or not (seen[0]["pack_uploading"] and seen[0]["host"]):
                raise AssertionError(
                    f"cold_start: the first call was not routed to the host while "
                    f"the pack uploaded: {seen}")
            if res["first_host_searches"] != 1:
                raise AssertionError(
                    f"cold_start: host_search counted {res['first_host_searches']} "
                    f"for the first call")
            if not settled or not res["mirror_live"]:
                raise AssertionError("cold_start: the mirror is not live after wait_for_mirror")
            if res["dispatch"]["pack_upload_failures"] or res["dispatch"]["mirror_upload_failures"]:
                raise AssertionError(f"cold_start: an upload failed: {res['dispatch']}")
            if host_after != host_before:
                raise AssertionError("cold_start: a warm call took the host route")
        finally:
            kb.close()

    drive_path("cold_start", ["_staged_finish"], run, out)
    counts = out["paths"]["cold_start"]["launches"]
    if counts["_fused3_extract_int8"] + counts["_fused2_extract_int8"] <= 0:
        raise AssertionError("cold_start: no int8 prescore kernel launched")
    torch.cuda.empty_cache()


#: The small store of the host_route phase: the corpus size at which the
#: reference's README has a host scan win (10,000 docs x 1536).
SMALL_DOCS = 10_000


def host_route_phase(store: Path, ref_matrix, reps: int, work: Path, out: dict) -> None:
    """The host route and its dispatch rule on the card's machine.

    On the 1M int8 store (a ``KB`` from the sidecar, built with
    ``SVS_TPU_HOST_DISPATCH=force``): the measured round-trip floor, where
    ``'auto'`` sends B = 1, 4, 64, 256 at n=100, then the forced host
    route at B=1 and B=4 (the native int8 two-pass, after its int8 rows
    have built) and B=64 (the slab GEMM), first call and warm p50 over
    ``reps`` each.  On a new ``SMALL_DOCS`` x 1536 store: B=1, n=10 with
    ``force`` and with ``off`` (warm p50 each) and what ``auto`` chose.
    Every call exact against a brute-force scan."""
    import os

    import torch

    import svs_tpu_torch

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 8)
    res = out["paths_detail_host_route"] = {}

    def calls(kb, label, b, n, ref, count):
        lat, host = [], 0
        for rep in range(count):
            v = unit_queries(rng, b)
            texts = [f"{label}-{rep}-{i}" for i in range(b)]
            qvec.update(zip(texts, v))
            before = kb.stats().get("host_search", {}).get("count", 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            hits = kb.retrieve_batch(texts, n)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
            host += kb.stats().get("host_search", {}).get("count", 0) - before
            check_results(*hits_to_arrays(hits), v, ref, n)
        return lat, host

    def with_dispatch(value, make):
        prev = os.environ.get("SVS_TPU_HOST_DISPATCH")
        os.environ["SVS_TPU_HOST_DISPATCH"] = value
        try:
            return make()
        finally:
            if prev is None:
                os.environ.pop("SVS_TPU_HOST_DISPATCH")
            else:
                os.environ["SVS_TPU_HOST_DISPATCH"] = prev

    def run_1m():
        kb = with_dispatch("force", lambda: svs_tpu_torch.KB(store, embed, device="cuda"))
        try:
            eng = kb.engine
            if eng.host_dispatch != "force":
                raise AssertionError("SVS_TPU_HOST_DISPATCH=force was not read")
            corpus = kb._ensure_engine_fresh()
            settle(eng, res, "host_route")
            res["rpc_floor_ms"] = eng.device_rpc_floor() * 1e3
            cells = {}
            for label, b in (("B1", 1), ("B4", 4), ("B64", 64)):
                lat, host = calls(kb, f"host1m-{label}", b, 100, ref_matrix, 1)
                first = lat[0]
                if b == 1 and eng._host_i8_thread is not None:
                    t = time.perf_counter()
                    eng._host_i8_thread.join()
                    res["host_i8_build_wait_s"] = time.perf_counter() - t
                lat, host2 = calls(kb, f"host1m-{label}", b, 100, ref_matrix, reps)
                if host + host2 != reps + 1:
                    raise AssertionError(f"host_route {label}: a forced call took the device")
                cells[label] = {
                    "first_s": first,
                    "warm_p50_ms": statistics.median(lat) * 1e3,
                    "warm_ms": [x * 1e3 for x in lat],
                    "two_pass_bw": eng._host_twopass_bw,
                }
                log(f"e2e host_route 1M forced {label}, n=100: first {first:.3f} s, "
                    f"warm p50 {cells[label]['warm_p50_ms']:.2f} ms over {reps}; exact vs scan")
            if eng._host_twopass_bw is None:
                raise AssertionError("host_route: the native two-pass never ran")
            res["forced_1m"] = cells
            # where the rule sends each shape, on the estimates the scans left
            eng.host_dispatch = "auto"
            eng._host_bw_t = time.monotonic()
            res["auto_1m"] = {
                f"B{b}": "host" if eng.host_route(corpus, b, k=100) else "device"
                for b in (1, 4, 64, 256)
            }
            res["host_scan_bw"] = eng._host_scan_bw
            res["host_twopass_bw"] = eng._host_twopass_bw
            log(f"e2e host_route: round-trip floor {res['rpc_floor_ms']:.4f} ms; host "
                f"scan {res['host_scan_bw'] / 1e9:.2f} GB/s, two-pass "
                f"{res['host_twopass_bw'] / 1e9:.2f} GB/s effective; auto at 1M "
                f"(n=100): {res['auto_1m']}")
        finally:
            kb.close()

    def run_small():
        path = work / "small.sqlite"
        ref_small = ref_matrix[:0]
        try:
            from svs_tpu_torch.store.blob import embedding_to_bytes
            from svs_tpu_torch.store.db import Database

            m = unit_queries(np.random.default_rng(SEED + 9), SMALL_DOCS)
            db = Database(path)
            try:
                with db.transaction() as tx:
                    tx.add_docs_bulk(
                        [f"small document #{i}" for i in range(SMALL_DOCS)],
                        [embedding_to_bytes(r) for r in m],
                    )
                    tx.bump_matrix_version()
            finally:
                db.close()
            ref_small = torch.from_numpy(m).cuda()
            small = res["small_10k"] = {}
            for value in ("force", "off", "auto"):
                kb = with_dispatch(
                    value, lambda: svs_tpu_torch.KB(path, embed, device="cuda")
                )
                try:
                    lat0, _ = calls(kb, f"small-{value}-first", 1, 10, ref_small, 1)
                    settle(kb.engine, {}, f"small {value}")
                    lat, host = calls(kb, f"small-{value}", 1, 10, ref_small, reps)
                    small[value] = {
                        "first_s": lat0[0],
                        "warm_p50_ms": statistics.median(lat) * 1e3,
                        "warm_ms": [x * 1e3 for x in lat],
                        "host_calls": host,
                        "rpc_floor_ms": kb.engine.dispatch_stats().get("rpc_floor_ms"),
                    }
                    if value == "force" and host != reps or value == "off" and host:
                        raise AssertionError(f"small {value}: {host} host calls of {reps}")
                    log(f"e2e host_route 10k {value}: B=1, n=10 warm p50 "
                        f"{small[value]['warm_p50_ms']:.3f} ms over {reps}, {host} on the "
                        f"host route; floor {small[value]['rpc_floor_ms']} ms; exact vs scan")
                finally:
                    kb.close()
            small["auto_chose"] = "host" if small["auto"]["host_calls"] else "device"
        finally:
            del ref_small
            path.unlink(missing_ok=True)

    drive_path("host_route", [], run_1m, out)
    drive_path("host_route_small", [], run_small, out)
    torch.cuda.empty_cache()


def filters_phase(store: Path, ref_matrix, reps: int, out: dict) -> None:
    """Metadata filters and ``AsyncKB`` on the 1M int8 store, after the
    six retrieval paths (so the oracle is the store as written).  Tags doc
    ``i`` with ``{"tenant": i % 500, "shard": i % 4}`` through
    ``bulk_query_docs().update_doc_meta`` in one transaction (a meta-only
    write: the next ``KB`` still opens from the sidecar, no scan), then
    drives, each with the launch counts set to 0 just before it and read
    just after, ``reps`` calls at n=100 of:

    - ``filter_prefilter``: ``where={"tenant": 7}`` (2,000 docs), B=64 —
      the pre-filter device route (a subset gather and one f32 product);
    - ``filter_prefilter_host``: the same on ``KB(device_rescore='host')``
      — the pre-filter host route;
    - ``filter_ladder_dict``: ``where={"shard": 1}`` (250,000 docs, past
      the pre-filter gate), B=64 — the post-filter ladder at m=400, 1,600;
    - ``filter_ladder_predicate``: an opaque predicate passing 2%
      (``tenant < 10``), B=8 — the ladder at m=400, 1,600, 6,400, ...;
    - ``async``: an int8 ``AsyncKB`` opened from the sidecar, ``await
      load()``, then ``asyncio.gather`` of four ``retrieve_batch`` (B=64)
      and one with ``where={"tenant": 7}``.

    Every call is held against a brute-force f32 scan on the card of the
    matching rows only (``check_results``) and every hit must pass its
    filter; each cell records its first and warm latencies, phase p50s,
    the ladder's rounds (batch, m) per call and the widen retries, and
    the pre-filter and dict-ladder cells the device's idle share in one
    profiled call."""
    import asyncio

    import torch

    import svs_tpu_torch

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 6)
    n_docs = ref_matrix.shape[0]
    row = torch.arange(n_docs, device=ref_matrix.device)
    res = out["paths_detail_filters"] = {}

    def tag():
        kb = svs_tpu_torch.KB(store, embed, device="cuda")
        try:
            t = time.perf_counter()
            with kb.bulk_query_docs() as q:
                for i in range(n_docs):  # doc i has id i + 1
                    q.update_doc_meta(i + 1, {"tenant": i % 500, "shard": i % 4})
            res["tag_s"] = time.perf_counter() - t
        finally:
            kb.close()
        log(f"e2e filters: tagged {n_docs} docs in {res['tag_s']:.1f} s (one transaction)")

    def tenant_lt_10(doc):
        return doc["meta"]["tenant"] < 10

    cells = {
        # label: (where, the rows it passes, the check of a hit's meta)
        "tenant7": ({"tenant": 7}, row % 500 == 7, lambda m: m["tenant"] == 7),
        "shard1": ({"shard": 1}, row % 4 == 1, lambda m: m["shard"] == 1),
        "tenant_lt_10": (tenant_lt_10, row % 500 < 10, lambda m: m["tenant"] < 10),
    }

    def check(hits, v, name):
        where, match, ok = cells[name] if name else (None, None, None)
        rows, scores = hits_to_arrays(hits)
        check_results(rows, scores, v, ref_matrix, 100,
                      dead=None if match is None else ~match)
        if ok is not None and not all(ok(h["doc"]["meta"]) for q in hits for h in q):
            raise AssertionError(f"{name}: a hit does not pass the filter")

    def cell(kb, label, name, b, profile=False):
        """``reps`` calls of B new queries with the filter ``name``; with
        ``profile``, one more call unprofiled and under ``torch.profiler``
        (``device_idle_share``)."""
        where = cells[name][0]
        rounds = []
        real = kb._search.search_hydrated

        def spy(corpus, vectors, n):
            rounds[-1].append([len(vectors), n])
            return real(corpus, vectors, n)

        kb._search.search_hydrated = spy
        kb._stats.reset()
        widen0 = kb.engine.widen_retries
        lat = []
        try:
            for rep in range(reps):
                v = unit_queries(rng, b)
                texts = [f"{label}-{rep}-{i}" for i in range(b)]
                qvec.update(zip(texts, v))
                rounds.append([])
                torch.cuda.synchronize()
                t = time.perf_counter()
                hits = kb.retrieve_batch(texts, 100, where=where)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
                check(hits, v, name)
                if rep == 0:
                    first = first_call(kb, label)
        finally:
            del kb._search.search_hydrated
        res[label] = {
            "first": first,
            "first_s": lat[0],
            "warm_p50_ms": statistics.median(lat[1:]) * 1e3,
            "warm_ms": [x * 1e3 for x in lat[1:]],
            "phase_p50_ms": {
                k: v["p50_s"] * 1e3 for k, v in kb._stats.snapshot().items()
            },
            "ladder_rounds": rounds,  # per call: [batch, m] of each round
            "widen_retries": kb.engine.widen_retries - widen0,
            "pack_events": dict(kb.engine.pack_events),
        }
        if profile:
            texts = [f"{label}-profiled-{i}" for i in range(b)]
            qvec.update(zip(texts, unit_queries(rng, b)))
            prof = res[label]["profiled_call"] = device_idle_share(
                lambda: kb.retrieve_batch(texts, 100, where=where)
            )
            second = prof["second_profile"]
            log(f"e2e {label}: unprofiled {prof['unprofiled_wall_ms']:.2f} ms; profiled "
                f"{second['wall_ms']:.2f} ms, kernels {second.get('kernel_ms')} ms in "
                f"{second.get('kernel_launches')} launches (idle share {second['idle_share']})")
        log(f"e2e {label}: first {lat[0]:.3f} s ({first}), warm p50 "
            f"{res[label]['warm_p50_ms']:.2f} ms; phases "
            f"{({k: round(v, 2) for k, v in res[label]['phase_p50_ms'].items()})} ms; "
            f"ladder rounds {rounds}; widen retries {res[label]['widen_retries']}; "
            f"exact vs the matching rows' scan")

    def opened_from_sidecar(kb, label):
        ev = kb.engine.pack_events
        if ev["sidecar"] != 1 or ev["scan"] != 0:
            raise AssertionError(f"{label}: pack_events {ev}: the meta write made the sidecar stale")

    def kb_cell(label, name, b, profile=False, **options):
        def run():
            kb = svs_tpu_torch.KB(store, embed, device="cuda", precision="int8", **options)
            try:
                cell(kb, label, name, b, profile)
                opened_from_sidecar(kb, label)
                if options and kb.engine.corpus.dev_rescore is not None:
                    raise AssertionError("device_rescore='host' built a device mirror")
            finally:
                kb.close()

        return run

    def run_async():
        async def go():
            akb = svs_tpu_torch.AsyncKB(store, embed, device="cuda", precision="int8")
            try:
                t = time.perf_counter()
                await akb.load()
                res["async_load_s"] = time.perf_counter() - t
                opened_from_sidecar(akb, "async")
                settled = {}
                await asyncio.get_running_loop().run_in_executor(
                    None, settle, akb.engine, settled, "async"
                )
                res["async_settle_s"] = settled["settle_s"]
                akb._stats.reset()
                lat = []
                for rep in range(reps):
                    names = [None, None, None, None, "tenant7"]
                    vs = [unit_queries(rng, 64) for _ in names]
                    texts = [[f"async-{rep}-{j}-{i}" for i in range(64)] for j in range(5)]
                    for tx, v in zip(texts, vs):
                        qvec.update(zip(tx, v))
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    outs = await asyncio.gather(*(
                        akb.retrieve_batch(tx, 100, where=None if nm is None else cells[nm][0])
                        for tx, nm in zip(texts, names)
                    ))
                    torch.cuda.synchronize()
                    lat.append(time.perf_counter() - t)
                    for hits, v, nm in zip(outs, vs, names):
                        check(hits, v, nm)
                res["async"] = {
                    "load_s": res["async_load_s"],
                    "first_s": lat[0],
                    "warm_p50_ms": statistics.median(lat[1:]) * 1e3,
                    "warm_ms": [x * 1e3 for x in lat[1:]],
                    "phase_p50_ms": {
                        k: v["p50_s"] * 1e3 for k, v in akb._stats.snapshot().items()
                    },
                    "widen_retries": akb.engine.widen_retries,
                }
            finally:
                await akb.close()
            log(f"e2e async: load() {res['async_load_s']:.2f} s; gather of 5 x B=64 "
                f"first {lat[0]:.3f} s, warm p50 {res['async']['warm_p50_ms']:.2f} ms; "
                f"phases {({k: round(v, 2) for k, v in res['async']['phase_p50_ms'].items()})} "
                f"ms; exact vs the scans")

        asyncio.run(go())

    tag()
    int8 = ["_fused3_extract_int8", "_fused2_extract_int8", "_fused_extract_int8"]
    for label, expected, run in (
        # the pre-filter routes run no hand-written kernel: a gather, one
        # f32 product and the final selection
        ("filter_prefilter", [], kb_cell("filter_prefilter", "tenant7", 64, profile=True)),
        ("filter_prefilter_host", [],
         kb_cell("filter_prefilter_host", "tenant7", 64, device_rescore="host")),
        ("filter_ladder_dict", ["_fused2_extract_int8", "_fused_extract_int8", "_staged_finish"],
         kb_cell("filter_ladder_dict", "shard1", 64, profile=True)),
        ("filter_ladder_predicate", [], kb_cell("filter_ladder_predicate", "tenant_lt_10", 8)),
        ("async", ["_fused3_extract_int8", "_staged_finish"], run_async),
    ):
        drive_path(label, expected, run, out)
        if label in ("filter_ladder_predicate", "async"):
            counts = out["paths"][label]["launches"]
            if sum(counts[k] for k in int8) <= 0:
                raise AssertionError(f"{label}: no int8 prescore kernel launched")
        torch.cuda.empty_cache()


def incremental_phase(store: Path, ref_matrix, reps: int, out: dict):
    """Writes to the 1M int8 store on a KB that has packed, each followed
    by ``retrieve_batch`` (B=64, n=100) ``reps`` times and held against a
    brute-force scan of the live rows (no deleted row returned): append
    ``APPEND_DOCS`` random unit docs, append as many again (the pack grows
    past its padding), ``bulk_del_docs`` ``DELETE_DOCS``, then
    ``close(write_sidecar=True)`` and a fresh ``KB`` on the file.  Each
    step must repack as named (``append``, ``append``, ``delete``, then
    ``sidecar`` with no scan and a device mirror), each is driven with the
    launch counts set to 0 just before it and read just after, and its
    first call's ``pack`` phase, first and warm latencies are recorded.
    Returns the reference matrix with the appended rows."""
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.engine.sidecar import sidecar_path_for

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 5)
    dead = torch.zeros(ref_matrix.shape[0], dtype=torch.bool, device=ref_matrix.device)
    n_base = ref_matrix.shape[0]
    kbs = {}
    res = out["paths_detail_incremental"] = {}

    def queries(label, vectors):
        texts = [f"{label}-q{i}" for i in range(len(vectors))]
        qvec.update(zip(texts, vectors))
        return texts

    def step(label, want_events, first_vectors=None, first_rows=None, check=None):
        """``reps`` B=64 calls: the first on ``first_vectors`` (whose hit 0
        must be ``first_rows``) or random queries, the rest random."""
        kb = kbs["kb"]
        before = dict(kb.engine.pack_events)
        lat, pack_ms = [], None
        for rep in range(reps):
            v = first_vectors if rep == 0 and first_vectors is not None else unit_queries(rng, 64)
            texts = queries(f"{label}-{rep}", v)
            kb._stats.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            hits = kb.retrieve_batch(texts, 100)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
            if rep == 0:
                pack_ms = kb._stats.snapshot()["pack"]["last_s"] * 1e3
            rows, scores = hits_to_arrays(hits)
            check_results(rows, scores, v, ref_matrix, 100, dead=dead)
            if rep == 0:
                first = first_call(kb, label)
            if rep == 0 and first_rows is not None and (rows[:, 0] != first_rows).any():
                raise AssertionError(f"{label}: a query equal to a doc did not get it first")
        events = {k: v - before[k] for k, v in kb.engine.pack_events.items()}
        events = {k: v for k, v in events.items() if v and k != "reuse"}
        corpus = kb.engine.corpus
        res[label] = {
            "pack_ms": pack_ms,
            "first": first,
            "first_s": lat[0],
            "warm_p50_ms": statistics.median(lat[1:]) * 1e3,
            "warm_ms": [x * 1e3 for x in lat[1:]],
            "pack_events": events,
            "n_valid": corpus.n_valid,
            "n_padded": corpus.n_padded,
            "device_mirror": corpus.dev_rescore is not None,
        }
        if events != want_events:
            raise AssertionError(f"{label}: pack_events {events}, want {want_events}")
        if check is not None:
            check(corpus)
        log(f"e2e incremental {label}: pack phase {pack_ms:.1f} ms, first "
            f"{lat[0]:.3f} s ({first}), warm p50 {res[label]['warm_p50_ms']:.2f} ms; events "
            f"{events}; n_valid {corpus.n_valid}, n_padded {corpus.n_padded}; "
            f"exact vs the live rows' scan")

    def append(label, first_row):
        nonlocal ref_matrix, dead
        rows = unit_queries(rng, APPEND_DOCS)
        texts = [f"synthetic document #{first_row + i}" for i in range(APPEND_DOCS)]
        qvec.update(zip(texts, rows))
        t = time.perf_counter()
        with kbs["kb"].bulk_add_docs() as add:
            for text in texts:
                add(text)
        res[f"{label}_write_s"] = time.perf_counter() - t
        new = torch.from_numpy(rows).to(ref_matrix.device)
        ref_matrix = torch.cat([ref_matrix, new])
        dead = torch.cat([dead, torch.zeros(APPEND_DOCS, dtype=torch.bool, device=dead.device)])
        pick = rng.choice(APPEND_DOCS, 64, replace=False)
        step(label, {"append": 1}, rows[pick], first_row + pick)

    def run_first():
        kbs["kb"] = svs_tpu_torch.KB(store, embed, device="cuda")
        step("open", {"sidecar": 1})  # the int8 KB's load() left it

    def run_append_1():
        append("append_1", n_base)

    def run_append_2():
        append("append_2", n_base + APPEND_DOCS)
        grown = (n_base + 2 * APPEND_DOCS + 16_383) // 16_384 * 16_384
        if kbs["kb"].engine.corpus.n_padded != grown:
            raise AssertionError(f"the pack did not grow to {grown} rows")

    def run_delete():
        kb = kbs["kb"]
        gone = np.sort(rng.choice(ref_matrix.shape[0], DELETE_DOCS, replace=False))
        with kb.bulk_query_docs() as q:
            docs = [q.query_doc(int(r) + 1) for r in gone]  # doc i has id i + 1
        if any(d["text"] != f"synthetic document #{r}" for d, r in zip(docs, gone)):
            raise AssertionError("a doc id does not hold the row it was written with")
        t = time.perf_counter()
        with kb.bulk_del_docs() as delete:
            for d in docs:
                delete(d["id"])
        res["delete_write_s"] = time.perf_counter() - t
        dead[torch.from_numpy(gone).to(dead.device)] = True
        # the first call asks for the deleted docs themselves
        gone_rows = ref_matrix[torch.from_numpy(gone[:64]).to(dead.device)]
        step("delete", {"delete": 1}, gone_rows.cpu().numpy())
        # the survivor check's id scan again, its pages now cached: the
        # share of the step's pack phase that was the store's page cache
        with kb._require_db().transaction() as tx:
            t = time.perf_counter()
            tx.embedding_ids()
            res["delete_id_scan_again_s"] = time.perf_counter() - t
        log(f"e2e incremental: the id scan again {res['delete_id_scan_again_s']:.2f} s")

    def run_reopen():
        kb = kbs.pop("kb")
        t = time.perf_counter()
        kb.close(write_sidecar=True)
        res["close_write_sidecar_s"] = time.perf_counter() - t
        res["sidecar_gb"] = sidecar_path_for(store).stat().st_size / 1e9
        log(f"e2e incremental: close(write_sidecar=True) {res['close_write_sidecar_s']:.2f} s "
            f"({res['sidecar_gb']:.2f} GB)")
        kbs["kb"] = svs_tpu_torch.KB(store, embed, device="cuda")

        def mirrored(corpus):
            if corpus.dev_rescore is None:
                raise AssertionError("the sidecar load built no device mirror")

        step("reopen", {"sidecar": 1}, check=mirrored)

    try:
        for label, fn in (("incremental_open", run_first),
                          ("incremental_append_1", run_append_1),
                          ("incremental_append_2", run_append_2),
                          ("incremental_delete", run_delete),
                          ("incremental_reopen", run_reopen)):
            drive_path(label, ["_staged_finish"], fn, out)
            counts = out["paths"][label]["launches"]
            if counts["_fused3_extract_int8"] + counts["_fused2_extract_int8"] <= 0:
                raise AssertionError(f"{label}: no int8 prescore kernel launched")
    finally:
        if "kb" in kbs:
            kbs["kb"].close()
    return ref_matrix


def write_pair_store(path: Path, seed: int, dupe_frac: float) -> np.ndarray:
    """A 100k x 1536 store written through the port's ``Tx`` in 20,000-row
    chunks (doc ``i`` holds row ``i``); with ``dupe_frac`` the last
    ``dupe_frac`` of every chunk are perturbed copies of distinct earlier
    rows of the chunk, cos ~ 1/sqrt(1 + 0.35^2), as the repo's pairwise
    benchmark corpus plants them.  Returns the f32 rows."""
    from svs_tpu_torch.store.blob import embedding_to_bytes
    from svs_tpu_torch.store.db import Database

    rng = np.random.default_rng(seed)
    matrix = np.empty((PAIR_DOCS, DIM), dtype=np.float32)
    db = Database(path)
    try:
        with db.transaction() as tx:
            for lo in range(0, PAIR_DOCS, PAIR_CHUNK):
                count = min(PAIR_CHUNK, PAIR_DOCS - lo)
                block = rng.standard_normal((count, DIM)).astype(np.float32)
                block /= np.linalg.norm(block, axis=1, keepdims=True)
                n_dupes = min(int(count * dupe_frac), count // 2)
                if n_dupes:
                    srcs = rng.permutation(count - n_dupes)[:n_dupes]
                    noise = rng.standard_normal((n_dupes, DIM)).astype(np.float32)
                    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
                    dup = block[srcs] + 0.35 * noise
                    dup /= np.linalg.norm(dup, axis=1, keepdims=True)
                    block[count - n_dupes :] = dup
                matrix[lo : lo + count] = block
                tx.add_docs_bulk(
                    [f"synthetic document #{lo + i}" for i in range(count)],
                    [embedding_to_bytes(r) for r in block],
                )
            tx.bump_matrix_version()
    finally:
        db.close()
    return matrix


def pair_oracle(ref, k: int) -> tuple:
    """Exact top-``k`` strict-upper-triangle pairs of ``ref @ ref.T`` on the
    card (f32 products, TF32 off), 2048 rows at a time: ``(vals, rows,
    cols)`` descending."""
    import torch

    from svs_tpu_torch.ops.topk import exact_f32

    n = ref.shape[0]
    dev = ref.device
    best_v = torch.empty(0, device=dev)
    best_i = torch.empty(0, dtype=torch.int64, device=dev)
    cols = torch.arange(n, device=dev)
    with exact_f32():
        for lo in range(0, n, 2048):
            s = ref[lo : lo + 2048] @ ref.t()
            rows = torch.arange(lo, lo + s.shape[0], device=dev)
            s = torch.where(cols[None, :] > rows[:, None], s, float("-inf"))
            v, i = torch.topk(s.view(-1), k)
            best_v, pos = torch.topk(torch.cat([best_v, v]), k)
            best_i = torch.cat([best_i, i + lo * n])[pos]
    return best_v, best_i // n, best_i % n


def check_pairs(results, ref, oracle, k: int) -> None:
    """A pairwise result against the brute-force oracle of ``ref``: k pairs,
    finite scores within SCORE_TOL of the pairs' true dots, the oracle's
    pair at every rank except where the two scores lie within SCORE_TOL,
    and every oracle pair above the k-th score by SCORE_TOL present."""
    import torch

    if len(results) != k:
        raise AssertionError(f"{len(results)} pairs, want {k}")
    idx = np.asarray(
        [[int(d["text"].rsplit("#", 1)[1]) for d in (a, b)] for _, a, b in results]
    )
    idx.sort(axis=1)
    scores = np.asarray([s for s, _, _ in results], dtype=np.float64)
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite pair scores")
    ra = torch.from_numpy(idx[:, 0]).to(ref.device)
    rb = torch.from_numpy(idx[:, 1]).to(ref.device)
    true = (ref[ra].double() * ref[rb].double()).sum(dim=1).cpu().numpy()
    if np.abs(scores - true).max() > SCORE_TOL:
        raise AssertionError(f"pair scores off by {np.abs(scores - true).max()}")
    ov, orow, ocol = (t.cpu().numpy() for t in oracle)
    ov = ov.astype(np.float64)
    differ = (orow != idx[:, 0]) | (ocol != idx[:, 1])
    gap = np.abs(true - ov)
    if np.any(differ & (gap >= SCORE_TOL)):
        j = int(np.nonzero(differ & (gap >= SCORE_TOL))[0][0])
        raise AssertionError(
            f"rank {j}: pair {tuple(idx[j])} ({true[j]:.9f}) where the oracle "
            f"has ({orow[j]}, {ocol[j]}) ({ov[j]:.9f})"
        )
    got = set(map(tuple, idx.tolist()))
    above = ov > ov[-1] + SCORE_TOL
    missing = [p for p in zip(orow[above].tolist(), ocol[above].tolist()) if p not in got]
    if missing:
        raise AssertionError(f"{len(missing)} oracle pairs missing, e.g. {missing[0]}")


def kernel_times(prof) -> dict:
    """``{kernel name: (device ms, launches)}`` of one profiled window."""
    import torch

    by_name: dict = {}
    for e in prof.events():
        # device activities only; a record_function range also shows up on
        # the device timeline, as a user annotation spanning kernels
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            e, "is_user_annotation", False
        ):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


def device_idle_share(fn) -> dict:
    """``fn`` once unprofiled, then in two ``torch.profiler`` windows: each
    wall time, the summed CUDA kernel time and the idle share 1 - kernel /
    wall (None where the profiler saw no device time).  The first window
    of a process also starts the device tracer; the second reports, beside
    its numbers, the twelve largest kernels, each with its launch count and
    device time per launch, and the ten host operations with the most
    self time (host clock, the profiler's own cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out: dict = {"unprofiled_wall_ms": (time.perf_counter() - t) * 1e3}
    for window in ("first_profile", "second_profile"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        try:
            by_name = kernel_times(prof)
        except Exception as exc:  # a measurement, not a check: record why it is missing
            out[window] = {"wall_ms": wall_ms, "idle_share": None, "error": repr(exc)}
            continue
        busy_ms = sum(ms for ms, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        out[window] = {
            "wall_ms": wall_ms,
            "kernel_ms": busy_ms,
            "kernel_launches": sum(n for _, n in by_name.values()),
            "idle_share": None if busy_ms == 0 else 1.0 - busy_ms / wall_ms,
            "top_kernels": {
                name[:80]: {"ms": ms, "launches": n, "us_per_launch": ms * 1e3 / n}
                for name, (ms, n) in top
            },
            "top_host_ops": {
                e.key[:60]: {"self_ms": e.self_cpu_time_total / 1e3, "count": e.count}
                for e in host
            },
        }
    out["first_profile"].pop("top_kernels", None)
    out["first_profile"].pop("top_host_ops", None)
    return out


def delete_then_retrieve(store: Path, ref, reps: int, out: dict) -> None:
    """``bulk_del_docs`` 1% of a pairwise store's docs, then
    ``retrieve_batch`` (B=64, n=100) ``reps`` times, each result held
    against a brute-force scan of the survivors (no deleted row returned)."""
    import torch

    import svs_tpu_torch

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 4)
    gone = np.sort(rng.choice(PAIR_DOCS, PAIR_DOCS // 100, replace=False))
    dead = torch.zeros(PAIR_DOCS, dtype=torch.bool, device=ref.device)
    dead[torch.from_numpy(gone).to(ref.device)] = True
    res = out["paths_detail_delete_then_retrieve"] = {"deleted": len(gone)}

    def run():
        kb = svs_tpu_torch.KB(store, embed, device="cuda")
        try:
            # pack before the deletes (from the sidecar the flat pairwise
            # KB's close left), so that they repack incrementally
            v = unit_queries(rng, 64)
            texts = [f"before-delete-{i}" for i in range(64)]
            qvec.update(zip(texts, v))
            check_results(*hits_to_arrays(kb.retrieve_batch(texts, 100)), v, ref, 100)
            res["before_delete"] = first_call(kb, "delete_then_retrieve")
            with kb.bulk_query_docs() as q:
                ids = {int(d["text"].rsplit("#", 1)[1]): d["id"] for d in q.query_level(0)}
            t = time.perf_counter()
            with kb.bulk_del_docs() as delete:
                for row in gone:
                    delete(ids[int(row)])
            res["delete_s"] = time.perf_counter() - t
            if len(kb) != PAIR_DOCS - len(gone):
                raise AssertionError(f"{len(kb)} docs after the deletes")
            lat = []
            for rep in range(reps):
                v = unit_queries(rng, 64)
                texts = [f"after-delete-{rep}-{i}" for i in range(64)]
                qvec.update(zip(texts, v))
                torch.cuda.synchronize()
                t = time.perf_counter()
                hits = kb.retrieve_batch(texts, 100)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
                check_results(*hits_to_arrays(hits), v, ref, 100, dead=dead)
                if rep == 0:
                    res["first"] = first_call(kb, "delete_then_retrieve")
            res.update({
                "first_s": lat[0],
                "warm_ms": [x * 1e3 for x in lat[1:]],
                "pack_events": dict(kb.engine.pack_events),
            })
            if kb.engine.pack_events["delete"] != 1:
                raise AssertionError(f"no incremental delete: {kb.engine.pack_events}")
        finally:
            kb.close()

    drive_path("delete_then_retrieve", ["_fused_extract_int8"], run, out)
    log(f"e2e delete_then_retrieve: {len(gone)} docs deleted in "
        f"{res['delete_s']:.2f} s; B=64, n=100 first {res['first_s']:.3f} s "
        f"(incremental delete), warm {res['warm_ms']} ms; pack_events "
        f"{res['pack_events']}; exact vs the survivors' scan")


def filtered_pairs(store: Path, ref, out: dict) -> None:
    """Filtered pairwise on the 100k dupe-planted store with an int8 ``KB``:
    tags doc ``i`` with ``{"g": i % 5, "head": i < 20480}`` in one
    transaction, then ``document_top_pairwise_scores(10,000)`` three times
    each with ``where={"head": True}`` (20,480 rows: a 4,096-aligned
    subset, the keyed route), ``where={"g": 0}`` (20,000 rows padded to
    20,224: the exact blocked pass) and the same subset through an opaque
    predicate (which must give the identical list), each with the launch
    counts set to 0 just before it and read just after, held against a
    brute-force top-10,000 of the subset's pairs on the card, every
    document passing the filter."""
    import torch

    import svs_tpu_torch

    async def embed(texts):  # pairwise embeds nothing
        raise AssertionError("the pairwise path does not embed")

    res = out["paths_detail_pairwise_filtered"] = {}
    kb = svs_tpu_torch.KB(store, embed, device="cuda")
    try:
        t = time.perf_counter()
        with kb.bulk_query_docs() as q:
            for i in range(PAIR_DOCS):  # doc i has id i + 1
                q.update_doc_meta(i + 1, {"g": i % 5, "head": i < 20480})
        res["tag_s"] = time.perf_counter() - t
    finally:
        kb.close()
    log(f"e2e pairwise_filtered: tagged {PAIR_DOCS} docs in {res['tag_s']:.1f} s")
    head = torch.arange(20480, device=ref.device)
    g0 = torch.arange(0, PAIR_DOCS, 5, device=ref.device)
    listed = {}

    def g_is_0(doc):
        return doc["meta"]["g"] == 0

    for label, where, rows, ok, expected in (
        ("pairwise_filter_keyed", {"head": True}, head,
         lambda m: m["head"] is True, ["pairwise_keys_extract"]),
        ("pairwise_filter_blocked", {"g": 0}, g0, lambda m: m["g"] == 0, ["_extract"]),
        ("pairwise_filter_predicate", g_is_0, g0, lambda m: m["g"] == 0, ["_extract"]),
    ):
        v, r, c = pair_oracle(ref[rows], PAIR_K)
        oracle = (v, rows[r], rows[c])

        def run():
            kb = svs_tpu_torch.KB(store, embed, device="cuda")
            try:
                lat, widens = [], []
                for _ in range(3):
                    before = kb.engine.widen_retries
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    pairs = kb.document_top_pairwise_scores(PAIR_K, where=where)
                    torch.cuda.synchronize()
                    lat.append(time.perf_counter() - t)
                    widens.append(kb.engine.widen_retries - before)
                    check_pairs(pairs, ref, oracle, PAIR_K)
                    if not all(ok(d["meta"]) for _, a, b in pairs for d in (a, b)):
                        raise AssertionError(f"{label}: a pair does not pass the filter")
                    if len(lat) == 1:
                        settle(kb.engine, {}, label)
                listed[label] = [(s, a["id"], b["id"]) for s, a, b in pairs]
                res[label] = {
                    "first_s": lat[0],
                    "warm_ms": [x * 1e3 for x in lat[1:]],
                    "warm_p50_ms": statistics.median(lat[1:]) * 1e3,
                    "widen_retries_per_call": widens,
                    "phase_p50_ms": {
                        k: v["p50_s"] * 1e3 for k, v in kb._stats.snapshot().items()
                    },
                    "pair_hint": {str(k): v for k, v in kb.engine._pair_hint.items()},
                }
            finally:
                kb.close()

        drive_path(label, expected, run, out)
        log(f"e2e {label}: {int(rows.numel())} rows; first {res[label]['first_s']:.3f} s, "
            f"warm {res[label]['warm_ms']} ms, widens {res[label]['widen_retries_per_call']}; "
            f"phases {({k: round(v, 2) for k, v in res[label]['phase_p50_ms'].items()})} ms; "
            f"exact vs the subset's oracle")
        del oracle, v, r, c
    if listed["pairwise_filter_predicate"] != listed["pairwise_filter_blocked"]:
        raise AssertionError("the predicate and the dict of one subset gave other pairs")


def pairwise_phase(work: Path, out: dict) -> None:
    """``KB.document_top_pairwise_scores(10,000)`` on 100k x 1536 stores,
    3 calls per path, each result held against the brute-force oracle."""
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.engine.sidecar import sidecar_path_for

    async def embed(texts):  # pairwise embeds nothing
        raise AssertionError("the pairwise path does not embed")

    def pair_path(label, expected, store, ref, oracle, profile=False, **options):
        res = out[f"paths_detail_{label}"] = {}

        def run():
            kb = svs_tpu_torch.KB(store, embed, device="cuda", **options)
            try:
                lat, widens = [], []
                for _ in range(3):
                    before = kb.engine.widen_retries
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    pairs = kb.document_top_pairwise_scores(PAIR_K)
                    torch.cuda.synchronize()
                    lat.append(time.perf_counter() - t)
                    widens.append(kb.engine.widen_retries - before)
                    check_pairs(pairs, ref, oracle, PAIR_K)
                    if len(lat) == 1:
                        res["first"] = first_call(kb, label)
                res.update({
                    "precision": kb.engine.precision,
                    "first_s": lat[0],
                    "warm_ms": [x * 1e3 for x in lat[1:]],
                    "warm_p50_ms": statistics.median(lat[1:]) * 1e3,
                    "widen_retries_per_call": widens,
                    "pair_hint": {str(k): v for k, v in kb.engine._pair_hint.items()},
                    "phase_p50_ms": {
                        k: v["p50_s"] * 1e3 for k, v in kb._stats.snapshot().items()
                    },
                })
                if profile:
                    prof = res["profiled_call"] = device_idle_share(
                        lambda: kb.document_top_pairwise_scores(PAIR_K)
                    )
                    first, second = prof["first_profile"], prof["second_profile"]
                    log(f"e2e {label}: unprofiled {prof['unprofiled_wall_ms']:.2f} ms; "
                        f"profiled {first['wall_ms']:.2f} ms (idle share "
                        f"{first['idle_share']}), then {second['wall_ms']:.2f} ms "
                        f"(idle share {second['idle_share']})")
                    for name, k in second.get("top_kernels", {}).items():
                        log(f"  {k['ms']:.3f} ms = {k['launches']} x "
                            f"{k['us_per_launch']:.2f} us  {name}")
            finally:
                kb.close()

        drive_path(label, expected, run, out)
        log(f"e2e {label}: first {res['first_s']:.3f} s, warm {res['warm_ms']} ms, "
            f"widens {res['widen_retries_per_call']}; exact vs the oracle")
        torch.cuda.empty_cache()

    keyed = ["pairwise_keys_extract"]
    for label, seed, frac in (("dupes", SEED + 2, DUPE_FRAC), ("flat", SEED + 3, 0.0)):
        store = work / f"pairs_{label}.sqlite"
        t0 = time.perf_counter()
        matrix = write_pair_store(store, seed, frac)
        out[f"pair_store_write_s_{label}"] = time.perf_counter() - t0
        log(f"e2e: wrote {PAIR_DOCS} x {DIM} {label} store in "
            f"{out[f'pair_store_write_s_{label}']:.1f} s")
        ref = torch.from_numpy(matrix).cuda()
        del matrix
        oracle = pair_oracle(ref, PAIR_K)
        try:
            if label == "flat":
                pair_path("pairwise_int8_flat", keyed, store, ref, oracle)
                delete_then_retrieve(store, ref, 3, out)
                continue
            pair_path("pairwise_int8_dupes", keyed, store, ref, oracle, profile=True)
            pair_path("pairwise_bf16_dupes", keyed, store, ref, oracle, precision="bf16")
            pair_path("pairwise_f32_dupes", keyed, store, ref, oracle, precision="f32")
            filtered_pairs(store, ref, out)
            # rescore=False returns raw bf16 prescores: the oracle is of the
            # bf16-rounded matrix
            ref_bf16 = ref.to(torch.bfloat16).to(torch.float32)
            del oracle
            oracle = pair_oracle(ref_bf16, PAIR_K)
            pair_path("pairwise_rescore_off", ["_extract"], store, ref_bf16, oracle,
                      profile=True, rescore=False)
            del ref_bf16
        finally:
            store.unlink(missing_ok=True)
            sidecar_path_for(store).unlink(missing_ok=True)
            del ref, oracle
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=5, help="calls per shape and path")
    ap.add_argument("--kernel-reps", type=int, default=20,
                    help="launches per timed window of a kernel or library "
                    "call (a plain version takes a quarter, at least 3)")
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

    t0 = time.perf_counter()
    cross: dict = {}
    records = kernel_phase(args.docs, args.kernel_reps, cross)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    e2e = None
    if not args.skip_e2e:
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        log(f"e2e: {shutil.disk_usage(work).free / 1e9:.1f} GB free on the work disk")
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
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "shape": rec["what"],
            })
    if e2e is not None:
        # each profiled call's device time per launch of the port's own
        # kernels, beside the event-timed run of launches on the pair block
        symbols = {"pair_keys_kernel": "pairwise_keys_extract", "extract_kernel": "_extract"}
        for label, detail in e2e.items():
            prof = detail.get("profiled_call", {}) if isinstance(detail, dict) else {}
            tops = prof.get("second_profile", {}).get("top_kernels", {})
            for kname, k in tops.items():
                for sym, rec_name in symbols.items():
                    if f"{sym}(" in kname:
                        ev = [r["ms"] * 1e3 for r in records[rec_name] if "pair" in r["what"]]
                        log(f"{label}: {sym} {k['us_per_launch']:.2f} us per launch in "
                            f"situ ({k['launches']} launches), {ev[0]:.2f} us in the "
                            f"event-timed run of launches")
        e2e["seconds_total"] = time.perf_counter() - t_start
        print(json.dumps({"e2e": e2e}))
    print(json.dumps({"v2_v3_crossover_ms": cross}))
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
