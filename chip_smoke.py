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
   each of ``V3_BATCHES`` and ``V3_SMALL_BATCHES``, the keyed v2 kernels at B=8 and at each of
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
   - f32 ``KB``: the same three shapes (the bf16 and f32 ``KB``s, the
     ``rescore=False`` one, the bf16 mesh and the calibration's bf16 ``KB``
     open from sidecars of their precision, packed from the int8
     sidecar's exact rows by ``write_precision_sidecars``: one measured
     rescan, the int8 ``KB``'s);
   - int8 ``KB`` with ``device_rescore='host'`` (no device mirror; the
     candidates rescored on the host): B=64, B=8 and B=256 at n=100;
   - ``rescore=False`` ``KB`` (bf16 storage): B=8/n=100;
   checking every result against a brute-force scan on the card (for
   ``rescore=False``, of the bf16-rounded corpus and queries); the
   ``native`` cell reads which scan packed each rescan and its ``pack``
   phase; then ``cold_start`` (``cold_start_phase``: a ``KB`` from the
   sidecar, its first B=64 call on the host route while the pack uploads,
   ``wait_for_mirror``, warm calls on the device route) and
   ``host_route`` (``host_route_phase``: the forced host route at 1M for
   B=1, 4 (native two-pass) and 64, then ``'auto'`` at B = 1, 4, 64, 256,
   which must take the device with the pack on the card, and a new
   10,000-doc store at B=1 with ``force``, ``off`` and ``auto``); then the
   ``filters`` phase (``filters_phase``): the 1M store's docs tagged with
   ``tenant`` and ``shard`` meta, and ``where=`` cells on int8 ``KB``s —
   the pre-filter device and host routes, the post-filter ladder of a
   dict and of an opaque predicate — and an ``AsyncKB`` serving
   concurrent plain and filtered batches, each held against a
   brute-force scan of the matching rows; then the mesh and replica
   phases (``mesh_and_replica_phases``: a 2-shard int8 mesh ``KB`` from
   the sidecar and a bf16 one on the one card, a repeated device, at
   B = 8-512 and a ``where=`` batch; then ``KB(replicas=[cuda:0,
   cuda:0])`` at B = 1-256; every answer also set beside a single-device
   ``KB``'s on the same queries); then ``multihost_retrieve``: two
   children of this script (``--multihost-child``) join one mesh across
   processes (``multihost.initialize``, gloo, one shard each on the card),
   open the sidecar as ``mesh_int8`` and run its B = 8, 64, 256 query
   sets, every answer held against the scan, bit for bit against
   ``mesh_int8``'s and against the other child's (NCCL, one card a child,
   where the machine has two cards); then the incremental phase;
   then the serve phase (``serve_phase``): the HTTP server
   (``svs_tpu_torch.serve``) in this process on an ``AsyncKB`` of the 1M
   store, 256 single-query ``/retrieve`` requests at n=100 from 64 client
   threads over keep-alive connections, one 64-query request and a burst
   past the server's outstanding-query bound (429s), every hit exact
   against the live rows' scan, with the micro-batcher's coalescing and
   the kernels' launches asserted; then ``serve_writes_cli_phase``: a
   writable server on a new 10,000-doc store (``/add``, ``/delete``,
   ``/kv``, then exact ``/retrieve``), ``tools.selfcheck`` on it, and
   ``python -m svs_tpu_torch serve --workers 2`` as a subprocess from a
   copy of the package with nothing built (both workers answer, one
   kernel build between them, SIGTERM exits 0);
4. pairwise phase: writes two 100k x 1536 stores (the repo's pairwise
   benchmark: dupe-planted and flat random) and drives
   ``document_top_pairwise_scores(10,000)`` twice on each of five
   paths (int8, bf16 and f32 on the dupe-planted store, ``rescore=False``,
   int8 on the flat store), each result held against a brute-force top-k
   of the pairs on the card (and, on the dupe-planted store, ``/pairwise``
   at n=10,000 through the HTTP server and ``tools.find_near_duplicates``:
   ``serve_pairwise``); on the int8 keyed and ``rescore=False`` exact
   paths, one more call unprofiled and one under ``torch.profiler``, for
   the device's idle share and the kernels' device time per launch in the
   call; on the dupe-planted store also the mesh's pairwise ring, its
   post-filtered ``where=`` call and a ``mesh_2d(2, 2)`` bf16 retrieval
   (``mesh_pairwise``), and the ring across two processes
   (``multihost_pairwise``, held against the oracle and bit for bit
   against ``mesh_pairwise``'s first call); then ``bulk_del_docs`` of 1% of the flat store's docs and
   ``retrieve_batch`` (B=64, n=100) held against a brute-force scan of
   the survivors;
5. the phases of the dispatch calibration, the trace export and the
   embedding providers: ``calibration`` (``calibration_phase``, after the
   filters phase: probing on with a fresh cache, int8 and bf16 ``KB``s on
   the 1M store at B = 1-256, the winners against the kernel phase's
   crossover, the first engine sticky, a new ``KB`` following the
   persisted winners), ``trace`` (``trace_phase``: ``SVS_TPU_PROFILE_DIR``
   writes ``torch.profiler`` traces of five B=64 calls, each trace file
   holding the port's kernels and each call's naming #2 and #1/#3),
   ``providers`` (``providers_phase``: 4,000-doc stores through the
   openai and ollama factories against a loopback stub, reopened with no
   function), ``local`` (``local_phase``: a BERT encoder at
   ``BAAI/bge-small-en-v1.5``'s widths, 4 of its 12 layers, on the card,
   120,000 docs embedded and searched, against the port's own f32 run on
   the CPU),
   ``local_xlmr`` (``local_xlmr_phase``: an XLM-RoBERTa at
   ``BAAI/bge-m3``'s widths, 2 of its 24 layers, with a synthetic
   250,002-piece Unigram ``tokenizer.json``, 17,000 multilingual docs at
   ``max_length`` 512 embedded in bf16 and searched, 4 texts against the
   port's f32 run on the CPU, a reopen with no function),
   ``local_bigbird`` (``local_bigbird_phase``: a block-sparse BigBird at
   ``google/bigbird-roberta-base``'s widths, 2 of its 12 layers, with a
   synthetic 50,358-piece Unigram ``tokenizer.json`` in BigBird's layout,
   17,000 docs of 8-1,000 words at ``max_length`` 1,024 embedded in bf16
   and searched, f32 on the card against the CPU at 512 and 4,096 tokens
   (2 layers), a reopen with no function), ``local_mistral``
   (``local_mistral_phase``: a Mistral at
   ``intfloat/e5-mistral-7b-instruct``'s widths and depth, 7.11B
   parameters written as a sharded bf16 Flax checkpoint and held in f32 on
   the card, a synthetic 32,000-piece BPE ``tokenizer.json`` in Llama-2's
   layout, 17,000 passages at ``max_length`` 128 embedded in bf16 and
   searched at d = 4,096, f32 on the card against the CPU on a 2-layer
   cut, the stored bf16 rows against the card's f32 run, a reopen with no
   function on the 2-layer cut's store; then #3, #2 and #4 on the store's
   own int8 pack against their plain versions) and ``local_families``
   (``local_families_phase``: RoBERTa, DistilBERT, ELECTRA and
   RoBERTa-PreLayerNorm at published widths cut to 2 layers, ALBERT at
   ``albert-base-v2``'s widths and depth, Llama-2 and Gemma at
   ``Llama-2-7b-hf``'s and ``gemma-2b``'s widths cut to 2 layers, 64
   texts each in f32 and bf16 against the CPU).  Every other
   phase runs with ``SVS_TPU_AUTOCALIB=0`` and a calibration cache of the
   run's own, so no probe adds launches to it.

Prints the card's name and power limit, a JSON line describing every
kernel, and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result line, on any failure or when CUDA is unavailable.

    python3 chip_smoke.py            # the full run, one card
    python3 chip_smoke.py --docs 786432 --reps 3
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np

SEED = 20261016
DIM = 1536
#: Scores closer than this are ties for the id check; also the score
#: tolerance (f32 dots accumulate in another order than the reference scan),
#: and the tolerance of a float kernel against its plain version.
SCORE_TOL = 2e-6
#: Launches per timed window of a kernel or library call (``--kernel-reps``).
KERNEL_REPS = 20
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
#: Batches below the static prior's floor that calibration may now send to
#: v3: a short query tile (16 rows) holding 1, 4 or 8 queries.
V3_SMALL_BATCHES = (1, 4, 8)
#: Batches the keyed v2 kernels are held and timed at on the v3 core (B=8
#: stays on the first core): where the int8 and bf16 KBs run v2 after the
#: n=100 margin check has widened C to 1,600 (past GUARD_MAX_C), and the
#: smallest batch the new core takes.
V2_BATCHES = (16, 64, 256)
#: The candidate count of those calls (it does not reach the kernel).
V2_C = 1600
#: Batches the v1 kernels are held and timed at (all on the v3 core):
#: B = 1 and 8, the n = 1,000 calls below v3's floor; 16, the smallest
#: 16-query tile filled; 64 and 256, the 32- and 64-query tiles after a
#: widen past v2; 100, a batch that is not a multiple of the tile.
V1_BATCHES = (1, 8, 16, 64, 100, 256)


def v1_edges(n_valid: int) -> tuple:
    """Live counts below ``n_valid`` that end 3 and 300 docs into a 512-doc
    subtile: in its first 256-doc chunk and in its second, so that the v1
    kernel's chunked merge meets the -inf tail in each (every later
    subtile is wholly padded)."""
    m = n_valid // 512 - 1
    return (512 * m + 3, 512 * m + 300)

#: The repo's pairwise benchmark (benchmarks/tpu_pairwise_kb.py): 100k docs
#: x 1536, the top 10,000 pairs; dupe-planted stores plant 12% of every
#: 20,000-row insert chunk as perturbed copies (cos ~0.94).
#: The incremental phase: docs per append and per delete on the 1M store.
APPEND_DOCS = 10_000
DELETE_DOCS = 1_000
PAIR_DOCS = 100_000
PAIR_K = 10_000
#: Calls of each pairwise path (the first, then the warm ones).
PAIR_CALLS = 2
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
#: static prior for where v3 takes over): the calibration phase's batches.
CROSSOVER_BATCHES = (1, 4, 8, 16, 32, 64, 128, 256)


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


def int8_pack(n_docs: int, gen, dev, dim: int = DIM) -> tuple:
    """``(docs int8 [n_pad, dim], row scales f32 [n_pad])``: ``n_docs``
    random unit rows quantized as the engine packs them, padded to a
    multiple of 16,384 rows with zero rows."""
    import torch

    from svs_tpu_torch.ops.quant import quantize_rows_int8

    n_pad = -(-n_docs // 16384) * 16384
    docs = torch.zeros((n_pad, dim), dtype=torch.int8, device=dev)
    scales = torch.full(
        (n_pad,), float(np.float32(1e-30) / np.float32(127.0)),
        dtype=torch.float32, device=dev,
    )
    for lo in range(0, n_docs, 1 << 17):
        rows = unit_rows_torch(min(1 << 17, n_docs - lo), dim, gen, dev)
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


def kernel_recorder(records: dict, reps: int) -> tuple:
    """``(record, compare)`` into ``records`` (``{name: [record, ...]}``):
    ``record`` times a kernel over ``reps`` launches, its plain version
    over a quarter as many (at least 3) and a library call, beside the
    bound; ``compare`` first holds the kernel's outputs bit-identical to
    the plain version's, then records, and returns the first output."""
    import torch

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

    return record, compare


def pack_kernel_checks(label: str, docs, scales, qv, n_valid: int, c: int, out: dict) -> None:
    """The int8 retrieval kernels on a store's own device pack (``docs``
    int8 [n_pad, d], row ``scales``) for the query vectors ``qv`` (f32 [B,
    d], as the provider gave them), quantized as the engine quantizes them,
    each against its plain version and outside any path's launch count:
    the keyed v2 prescore (#3) and v1 (#4, at B and at 8 of the queries,
    and checked only with the live rows ending in the first and in the
    second chunk of a subtile) bit-identical, the staged finish (#2) at
    ``c`` candidates on #3's keys bit-identical (then on lattice and
    dead-padded keys, :func:`finish_checks`); their times go to
    ``out["kernel_records"]``, for the ``kernels`` line."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P
    from svs_tpu_torch.ops.quant import quantize_rows_int8

    _, compare = kernel_recorder(out.setdefault("kernel_records", {}), KERNEL_REPS)
    n_pad, d = docs.shape
    q8, qs = quantize_rows_int8(P._pad_rows(qv, 0.0))
    args = (docs, scales, q8.contiguous(), qs.contiguous(), n_valid)
    b = q8.shape[0]

    def int8_bound(out_cols):
        return bound(nbytes(docs, scales) + b * (d + 4) + b * out_cols * 4,
                     2.0 * b * n_pad * d, "int8")

    where = f"on {label}'s pack [{n_pad}, {d}]"
    keys = compare("_fused2_extract_int8", lambda: P._fused2_extract_int8(*args),
                   lambda: P._fused2_extract_int8_plain(*args), f"B={b} (v2) {where}",
                   int8_bound(n_pad // 64))
    gen = torch.Generator(device=docs.device)
    gen.manual_seed(SEED + 131)
    finish_checks(compare, keys, False, c, n_valid, gen)
    compare("_fused_extract_int8", lambda: P._fused_extract_int8(*args),
            lambda: P._fused_extract_int8_plain(*args), f"B={b} (v1) {where}",
            int8_bound(2 * n_pad // 64))
    for edge in v1_edges(n_valid):
        check_exact(f"_fused_extract_int8 (B={b}, n_valid={edge}) {where}",
                    P._fused_extract_int8(*args[:-1], edge),
                    P._fused_extract_int8_plain(*args[:-1], edge))
    log(f"  _fused_extract_int8 B={b} {where} with n_valid {v1_edges(n_valid)}: "
        f"bit-identical")
    b = 8
    args = (docs, scales, q8[:b].contiguous(), qs[:b].contiguous(), n_valid)
    compare("_fused_extract_int8", lambda: P._fused_extract_int8(*args),
            lambda: P._fused_extract_int8_plain(*args), f"B={b} (v1) {where}",
            int8_bound(2 * n_pad // 64))


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

    records: dict = {}
    record, compare = kernel_recorder(records, reps)

    def fused_int8_bound(b, out_cols):
        return bound(
            nbytes(docs, scales) + b * (DIM + 4) + b * out_cols * 4,
            2.0 * b * n_pad * DIM, "int8",
        )

    # #1 guarded v3 at every batch of V3_BATCHES (C <= 1024: C does not
    # reach the kernel), bit-identical
    outs3 = {}
    for b in V3_SMALL_BATCHES + V3_BATCHES:
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
    # #4 v1 at V1_BATCHES, k = 4000 (C does not reach the kernel),
    # bit-identical; then, checked only, with the live rows ending in the
    # first and in the second chunk of a subtile
    for b in V1_BATCHES:
        q8, qs = queries(b)
        args = (docs, scales, q8, qs, n_docs)
        compare(
            "_fused_extract_int8",
            lambda: P._fused_extract_int8(*args),
            lambda: P._fused_extract_int8_plain(*args),
            f"B={b} (v1, k=4000)",
            fused_int8_bound(b, 2 * n_pad // 64),
        )
    for b in (8, 64):
        q8, qs = queries(b)
        for n_valid in v1_edges(n_docs):
            args = (docs, scales, q8, qs, n_valid)
            check_exact(f"_fused_extract_int8 (B={b}, n_valid={n_valid})",
                        P._fused_extract_int8(*args),
                        P._fused_extract_int8_plain(*args))
        log(f"  _fused_extract_int8 B={b} with n_valid {v1_edges(n_docs)}: "
            f"bit-identical")
    del args
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

    # #5-#7 on bf16 and f32 packs: lattice data bit-identical (v1 also
    # with the live rows ending in either chunk of a subtile), v3 on
    # clipped colliding keys bit-identical, then random unit data within
    # tolerance (timed)
    float_cases = tuple(
        ("_fused3_extract", b, "v3, C=400", nb * 128, 1)
        for b in V3_SMALL_BATCHES + V3_BATCHES
    ) + tuple(
        ("_fused2_extract", b, f"v2, C={V2_C}", n_pad // 64, 1) for b in V2_BATCHES
    ) + (
        ("_fused2_extract", 8, "v2, k=400", n_pad // 64, 1),
    ) + tuple(
        ("_fused_extract", b, "v1, k=4000", n_pad // 64, 2) for b in V1_BATCHES
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
        q = lattice_rows_torch(64, DIM, gen, dev).to(dt)
        for n_valid in v1_edges(n_docs):
            check_exact(f"_fused_extract {dt_name} lattice n_valid={n_valid}",
                        P._fused_extract(fdocs, q, n_valid),
                        P._fused_extract_plain(fdocs, q, n_valid))
        log(f"  _fused_extract {dt_name} B=64 on lattice data with n_valid "
            f"{v1_edges(n_docs)}: bit-identical")
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


def write_store(path: Path, n_docs: int, device: str = "cuda"):
    """A SQLite store of ``n_docs`` random unit vectors written through the
    port's ``Tx`` (doc ``i`` holds row ``i``), the rows made on ``device``
    from the seed, 50,000 at a time (the host only writes them); returns
    the f32 rows, a tensor on ``device``."""
    import torch

    from svs_tpu_torch.store.blob import embedding_to_bytes
    from svs_tpu_torch.store.db import Database

    gen = torch.Generator(device=device).manual_seed(SEED)
    matrix = torch.empty((n_docs, DIM), dtype=torch.float32, device=device)
    db = Database(path)
    try:
        with db.transaction() as tx:
            for lo in range(0, n_docs, 50_000):
                rows = matrix[lo : lo + 50_000]
                torch.randn(rows.shape, generator=gen, out=rows)
                rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
                tx.add_docs_bulk(
                    [f"synthetic document #{lo + i}" for i in range(len(rows))],
                    [embedding_to_bytes(r) for r in rows.cpu().numpy()],
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
    t = time.perf_counter()
    fn()
    seconds = time.perf_counter() - t
    counts = P.launch_counts()
    out["paths"][label] = {"launches": counts, "seconds": seconds}
    for k, v in counts.items():
        out["launches"][k] = out["launches"].get(k, 0) + v
    missing = [k for k in expected if counts[k] <= 0]
    log(f"e2e {label} launches {counts} ({seconds:.1f} s)")
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


#: The precisions whose ``KB``s on the 1M store open from a sidecar of
#: their own (:func:`write_precision_sidecars`) instead of a rescan.
SIDECAR_PRECISIONS = ("bf16", "f32")


def precision_store(store: Path, precision: str) -> Path:
    """``store`` under ``precision``'s name: the hard link beside it (the
    same SQLite file) that :func:`write_precision_sidecars` makes, whose own
    sidecar (``sidecar_path_for``) holds that precision's pack."""
    return store.with_name(f"{store.stem}.{precision}{store.suffix}")


def write_precision_sidecars(store: Path) -> dict:
    """The store's bf16 and f32 sidecars, packed from the exact f32 rows of
    its live int8 sidecar (scan order, with the ids in the order the scan
    read them) by the port's ``pack_host`` and written by
    ``save_sidecar_arrays`` as the sidecar of the store's hard link under
    that precision's name (:func:`precision_store`): the bytes a rescan
    would pack (the same seeded row permutation, padding and fingerprint),
    so a bf16 or f32 ``KB`` on the link opens from its file in a fraction
    of a second where a rescan of the 1M store takes 23-30 s.  Returns the
    seconds of each."""
    from svs_tpu_torch.engine.packing import DIM_MULTIPLE, LARGE_ROW_MULTIPLE, pack_host
    from svs_tpu_torch.engine.sidecar import load_sidecar, save_sidecar_arrays, sidecar_path_for

    loaded = load_sidecar(sidecar_path_for(store))
    if loaded is None or loaded[3]["precision"] != "int8":
        raise AssertionError("write_precision_sidecars: no int8 sidecar of the store")
    _, _, emb_ids, header = loaded
    cache, perm = header["_f32_cache"], header.get("_f32_row_map")
    scan_ids = np.empty_like(emb_ids)
    if perm is None:
        scan_ids[:] = emb_ids
    else:
        scan_ids[perm] = emb_ids
    seconds = {}
    for precision in SIDECAR_PRECISIONS:
        t = time.perf_counter()
        data, _, ids, rows, row_map, n, d = pack_host(
            cache, scan_ids, precision, row_multiple=LARGE_ROW_MULTIPLE, dim_multiple=DIM_MULTIPLE)
        if not np.array_equal(ids, emb_ids) or data.shape[0] != header["n_padded"]:
            raise AssertionError(f"write_precision_sidecars: {precision} packs otherwise")
        exact = precision != "f32"  # an f32 pack is its own exact rows
        linked = precision_store(store, precision)
        os.link(store, linked)
        save_sidecar_arrays(
            sidecar_path_for(linked), n_valid=n, dim=d, precision=precision,
            matrix_version=header["matrix_version"], fingerprint=header["fingerprint"],
            emb_ids=ids, row_scales=None, data=data, f32_cache=rows if exact else None,
            f32_row_map=row_map if exact else None)
        seconds[precision] = time.perf_counter() - t
    return seconds


def e2e_phase(n_docs: int, reps: int, work: Path, cross: dict) -> dict:
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.engine.sidecar import sidecar_path_for

    store = work / "store.sqlite"
    native = native_phase()
    t0 = time.perf_counter()
    ref_matrix = write_store(store, n_docs)
    t_write = time.perf_counter() - t0
    log(f"e2e: wrote {n_docs} x {DIM} store in {t_write:.1f} s")

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
                    after=None, path=store, **options):
            res = out[f"paths_detail_{label}"] = {}

            def run():
                # a KB of another precision opens the store under its own
                # name, from that name's sidecar (its first call packs from it)
                kb = svs_tpu_torch.KB(path, embed, device="cuda", **options)
                try:
                    if check is not None:
                        check(kb)
                    kb_shapes(kb, shapes, reps, rng, qvec, scan, res, v3=v3)
                    if after is not None:
                        after(kb, res)
                    res["pack_events"] = dict(kb.engine.pack_events)
                finally:
                    kb.close()
                if path != store and res["pack_events"]["sidecar"] != 1:
                    raise AssertionError(f"{label}: not opened from its sidecar: {res['pack_events']}")

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
            window = prof["profile"]
            log(f"e2e {label}: unprofiled {prof['unprofiled_wall_ms']:.2f} ms "
                f"(then phases {({k: round(v, 2) for k, v in prof['phases_ms'].items()})} "
                f"ms); profiled {window['wall_ms']:.2f} ms, kernels "
                f"{window.get('kernel_ms')} ms in {window.get('kernel_launches')} "
                f"launches (idle share {window['idle_share']})")
            for name, k in window.get("top_kernels", {}).items():
                log(f"  {k['ms']:.3f} ms = {k['launches']} x "
                    f"{k['us_per_launch']:.2f} us  {name}")
            for name, k in window.get("top_host_ops", {}).items():
                log(f"  host {k['total_ms']:.3f} ms in all over {k['count']}  {name}")

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
        # one measured rescan (int8_kb's) is enough: the bf16 and f32 KBs
        # open from sidecars of their own, packed from the int8 sidecar's
        # exact rows (23-30 s a rescan saved, five times)
        t = time.perf_counter()
        native["precision_sidecars_s"] = write_precision_sidecars(store)
        log(f"e2e: bf16 and f32 sidecars packed from the int8 sidecar's f32 rows in "
            f"{time.perf_counter() - t:.1f} s ({native['precision_sidecars_s']})")
        bf16_solo: dict = {}
        kb_path("bf16_kb", fused_float + ["_staged_finish"], SHAPES, f32_scan,
                v3="_fused3_extract", precision="bf16",
                path=precision_store(store, "bf16"),
                after=lambda kb, res: mesh_bf16_solo(kb, qvec, ref_matrix, bf16_solo, res))
        # f32 storage: the pack is its own rescore mirror
        kb_path("f32_kb", fused_float + ["_staged_finish"], SHAPES, f32_scan,
                v3="_fused3_extract", precision="f32",
                path=precision_store(store, "f32"))

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
                bf16_scan, check=is_bf16, path=precision_store(store, "bf16"), rescore=False)
        del ref_bf16
        # the native phase: the full rescan of the 1M store above
        scans = native["rescans"] = {}
        for label in ("int8_kb",):
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
        mesh_answers = mesh_and_replica_phases(store, ref_matrix, bf16_solo, out)
        multihost_retrieve(store, ref_matrix, mesh_answers, work, out)
        del mesh_answers
        calibration_phase(store, ref_matrix, work, cross, out)
        trace_phase(store, ref_matrix, work, out)
        ref_matrix, dead = incremental_phase(store, ref_matrix, reps, out)
        serve_phase(store, ref_matrix, dead, out)
        del dead
        serve_writes_cli_phase(work, out)
    finally:
        store.unlink(missing_ok=True)
        sidecar_path_for(store).unlink(missing_ok=True)
        for precision in SIDECAR_PRECISIONS:
            precision_store(store, precision).unlink(missing_ok=True)
            sidecar_path_for(precision_store(store, precision)).unlink(missing_ok=True)
    del ref_matrix
    torch.cuda.empty_cache()
    pairwise_phase(work, out)
    providers_phase(work, out)
    local_phase(work, out)
    local_xlmr_phase(work, out)
    local_bigbird_phase(work, out)
    families = local_mistral_phase(work, out)
    local_families_phase(work, out, families)
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

            def spy(corpus):
                routed = real(corpus)
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
    ``SVS_TPU_HOST_DISPATCH=force``), once the pack has landed: the forced
    host route at B=1 and B=4 (the native int8 two-pass, after its int8
    rows have built: counted by wrapping ``_host_two_pass``) and B=64 (the
    slab GEMM), first call and warm p50 over ``reps`` each; then the same
    ``KB`` under ``'auto'`` at B = 1, 4, 64, 256 (n=100), which must take
    the device every time.  On a new ``SMALL_DOCS`` x 1536 store: B=1,
    n=10 with ``force``, ``off`` and ``auto`` (warm p50 each; ``auto``
    must take the device).  Every call exact against a brute-force scan."""
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
            two_pass = []
            real = eng._host_two_pass

            def counted(*args):
                got = real(*args)
                two_pass.append(got is not None)
                return got

            eng._host_two_pass = counted
            cells = {}
            for label, b in (("B1", 1), ("B4", 4), ("B64", 64)):
                lat, host = calls(kb, f"host1m-{label}", b, 100, ref_matrix, 1)
                first = lat[0]
                if b == 1 and eng._host_i8_thread is not None:
                    t = time.perf_counter()
                    eng._host_i8_thread.join()
                    res["host_i8_build_wait_s"] = time.perf_counter() - t
                before = len(two_pass), sum(two_pass)
                lat, host2 = calls(kb, f"host1m-{label}", b, 100, ref_matrix, reps)
                if host + host2 != reps + 1:
                    raise AssertionError(f"host_route {label}: a forced call took the device")
                cells[label] = {
                    "first_s": first,
                    "warm_p50_ms": statistics.median(lat) * 1e3,
                    "warm_ms": [x * 1e3 for x in lat],
                    "two_pass_answers": sum(two_pass) - before[1],
                }
                log(f"e2e host_route 1M forced {label}, n=100: first {first:.3f} s, "
                    f"warm p50 {cells[label]['warm_p50_ms']:.2f} ms over {reps}, "
                    f"{cells[label]['two_pass_answers']} answered by the native "
                    f"two-pass; exact vs scan")
            del eng._host_two_pass
            if cells["B1"]["two_pass_answers"] != reps or cells["B4"]["two_pass_answers"] != reps:
                raise AssertionError(f"host_route: the native two-pass did not answer "
                                     f"every warm B<=4 call: {cells}")
            res["forced_1m"] = cells
            # auto, with the pack on the card: the device at every shape
            eng.host_dispatch = "auto"
            auto = res["auto_1m"] = {}
            for b in (1, 4, 64, 256):
                if eng.host_route(corpus):
                    raise AssertionError(f"host_route: auto chose the host at B={b}")
                _, host = calls(kb, f"auto1m-B{b}", b, 100, ref_matrix, 1)
                auto[f"B{b}"] = "host" if host else "device"
            if any(v != "device" for v in auto.values()):
                raise AssertionError(f"host_route: auto took the host route: {auto}")
            log(f"e2e host_route: auto at 1M (n=100), pack on the card: {auto}; exact vs scan")
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
                    }
                    if value == "force" and host != reps or value != "force" and host:
                        raise AssertionError(f"small {value}: {host} host calls of {reps}")
                    log(f"e2e host_route 10k {value}: B=1, n=10 warm p50 "
                        f"{small[value]['warm_p50_ms']:.3f} ms over {reps}, {host} on the "
                        f"host route; exact vs scan")
                finally:
                    kb.close()
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
            window = prof["profile"]
            log(f"e2e {label}: unprofiled {prof['unprofiled_wall_ms']:.2f} ms; profiled "
                f"{window['wall_ms']:.2f} ms, kernels {window.get('kernel_ms')} ms in "
                f"{window.get('kernel_launches')} launches (idle share {window['idle_share']})")
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


#: The single-host mesh and replica phases: 2 shards (or replicas) of the
#: 1M store on the one card (a repeated device), ``MESH_REPS`` calls a shape.
MESH_SHARDS = 2
MESH_REPS = 2
MESH_SHAPES = (("B8_n100", 8, 100), ("B64_n100", 64, 100), ("B256_n100", 256, 100),
               ("B512_n100", 512, 100))
#: Pairs of the mesh's filtered pairwise call: at 10,000 the post-filter
#: walks global prefixes of 640,000 pairs and more (126 s on the card in
#: a rehearsal); at 1,000 four ring passes (prefixes 5,000, 20,000
#: twice, 80,000: 11 s).  Fewer pairs take more passes, not fewer (250:
#: five, 17 s): a prefix inside the 12,000 planted dupes fails the
#: margin until it passes them, and a fifth of them are head pairs.
MESH_WHERE_K = 1000
REPLICA_SHAPES = (("B1_n100", 1, 100), ("B7_n100", 7, 100), ("B64_n100", 64, 100),
                  ("B256_n100", 256, 100), ("B8_n1000", 8, 1000))
#: The prescore kernel of a replica slice's first try (C = 4n, the width
#: hint cleared), which every replica of a split batch must launch.
REPLICA_FIRST_KERNEL = {"B7_n100": "_fused2_extract_int8", "B64_n100": "_fused3_extract_int8",
                        "B256_n100": "_fused3_extract_int8", "B8_n1000": "_fused_extract_int8"}


def mesh_kb_label(kb) -> str:
    eng = kb.engine
    if getattr(eng, "mesh", None) is not None:
        return f"mesh {eng.precision}"
    if hasattr(eng, "devices"):
        return "replicas"
    return f"single device {eng.precision}"


def run_mesh_shape(kb, query_sets, label, n, ref_matrix, answers, stats,
                   where=None, match=None) -> None:
    """One call of each query set in ``query_sets`` (texts ``texts_of(label,
    rep, b)``), the width hint cleared first; each result exact against
    the scan and kept in ``answers[(label, rep)]``."""
    import torch

    from svs_tpu_torch.ops import pallas_extract as P

    kb.engine._cand_hint.clear()
    before = P.launch_counts()
    widen0 = kb.engine.widen_retries
    lat = []
    for rep, v in enumerate(query_sets):
        torch.cuda.synchronize()
        t = time.perf_counter()
        hits = kb.retrieve_batch(texts_of(label, rep, len(v)), n, where=where)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        rows, scores = hits_to_arrays(hits)
        check_results(rows, scores, v, ref_matrix, n,
                      dead=None if match is None else ~match)
        answers[(label, rep)] = (rows, scores)
    stats[label] = {
        "first_s": lat[0],
        "warm_ms": [x * 1e3 for x in lat[1:]],
        "warm_p50_ms": statistics.median(lat[1:]) * 1e3 if len(lat) > 1 else None,
        "launches": {k: v - before[k] for k, v in P.launch_counts().items() if v - before[k]},
        "widen_retries": kb.engine.widen_retries - widen0,
    }
    p50 = stats[label]["warm_p50_ms"]
    log(f"e2e {mesh_kb_label(kb)} {label}: first {lat[0]:.3f} s, warm "
        f"{stats[label]['warm_ms']} ms (p50 {p50} over {len(lat) - 1}), widens "
        f"{stats[label]['widen_retries']}, launches {stats[label]['launches']}; exact vs scan")


def mesh_bf16_queries() -> dict:
    """The bf16 mesh's query sets (``MESH_SHAPES[:2]``, ``MESH_REPS`` sets
    a shape), the same for the e2e phase's single-device bf16 ``KB``
    (``bf16_kb``) and for the bf16 mesh, whose answers are set beside it."""
    rng = np.random.default_rng(SEED + 10)
    return {"bf16_" + label: [unit_queries(rng, b) for _ in range(MESH_REPS)]
            for label, b, _ in MESH_SHAPES[:2]}


def mesh_bf16_solo(kb, qvec: dict, ref_matrix, answers: dict, res: dict) -> None:
    """The bf16 mesh's queries on a single-device bf16 ``KB`` (in the e2e
    phase, before the mesh phase: one rescan less): its answers go into
    ``answers``, for the mesh's to be compared with."""
    queries = mesh_bf16_queries()
    for label, vs in queries.items():
        for rep, v in enumerate(vs):
            qvec.update(zip(texts_of(label, rep, len(v)), v))
    stats = res["mesh_bf16_queries"] = {}
    for label, _, n in MESH_SHAPES[:2]:
        run_mesh_shape(kb, queries["bf16_" + label], "bf16_" + label, n, ref_matrix,
                       answers, stats)


def mesh_queries() -> dict:
    """The query sets of the mesh and replica phases (``MESH_REPS`` a
    shape, then one ``where=`` set), made from the seed: the same in the
    multihost phase's children."""
    rng = np.random.default_rng(SEED + 9)
    queries = {}
    for label, b, _ in MESH_SHAPES + tuple(("rep_" + s[0],) + s[1:] for s in REPLICA_SHAPES):
        queries[label] = [unit_queries(rng, b) for _ in range(MESH_REPS)]
    queries["where_B64"] = [unit_queries(rng, 64)]
    return queries


def mesh_and_replica_phases(store: Path, ref_matrix, bf16_solo: dict, out: dict) -> dict:
    """``KB(mesh=...)`` and ``KB(replicas=...)`` on the 1M store, after the
    filters phase (its meta tags) and before the incremental phase (the
    sidecar's 1,015,808 rows = 31 x 32,768 load on a 2-shard mesh), all on
    the one card: a mesh or replica list that repeats ``cuda:0``.  Each
    path runs with the launch counts set to 0 just before it and read just
    after (``drive_path``); every answer is held against a brute-force f32
    scan on the card (``check_results``) and against a single-device
    ``KB`` of the same precision on the same queries (bit-identical or
    not, reported):

    - ``mesh_solo``: the single-device int8 ``KB`` from the sidecar,
      ``MESH_REPS`` calls of every shape below and one of each replica
      slice alone (the launches a replica's slice takes on one device);
    - ``mesh_int8``: ``KB(mesh=default_mesh(devices=[cuda:0] * 2))`` from
      the sidecar (asserted: no rescan), ``MESH_SHAPES`` with the width
      hint cleared before each (so each first tries C = 400), one
      ``where={"tenant": 7}`` batch (the mesh subset route), the sharded
      mirror asserted as two blocks of 507,904 rows, and one B=64 call
      unprofiled and under ``torch.profiler`` (idle share);
    - ``mesh_bf16``: a bf16 mesh ``KB`` (from the bf16 sidecar) at B=8 and B=64, on
      the queries that the e2e phase's single-device bf16 ``KB`` answered
      into ``bf16_solo`` (``mesh_bf16_solo``);
    - ``replicas``: ``KB(replicas=[cuda:0, cuda:0])`` from the sidecar at
      ``REPLICA_SHAPES``; the clone's arrays asserted distinct tensors
      equal to the primary's; at each split shape one more call with the
      slices run one after another, each engine's launches counted alone,
      asserted to split into one slice a replica and every replica to
      launch its slice's first kernel; the counts set beside the single
      device's at the slices.

    Records warm p50s, first calls, the pack seconds and each path's peak
    device memory.  Returns ``mesh_int8``'s answers, ``{(label, rep):
    (rows, scores)}``, for the multihost phase."""
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.ops import pallas_extract as P
    from svs_tpu_torch.parallel import default_mesh
    from svs_tpu_torch.parallel.mesh import ShardedArray

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    res = out["paths_detail_mesh"] = {}
    rep_res = out["paths_detail_replicas"] = {}
    tenant7 = torch.arange(ref_matrix.shape[0], device=ref_matrix.device) % 500 == 7
    queries = mesh_queries()
    mesh_int8_answers: dict = {}
    bf16_queries = mesh_bf16_queries()
    for label, vs in (*queries.items(), *bf16_queries.items()):
        for rep, v in enumerate(vs):
            qvec.update(zip(texts_of(label, rep, len(v)), v))
    solo_answers: dict = {}

    def run_shape(kb, label, n, answers, stats, where=None, match=None, reps=MESH_REPS):
        run_mesh_shape(kb, queries[label][:reps], label, n, ref_matrix, answers, stats,
                       where=where, match=match)

    def same_as_solo(answers, stats, labels, solo=solo_answers):
        """Bit-identical to the single-device KB's answers on the same
        queries (every call of each shape; recorded, never asserted: both
        are exact)."""
        for label in labels:
            ident = [
                np.array_equal(answers[key][0], solo[key][0])
                and np.array_equal(answers[key][1], solo[key][1])
                for key in answers
                if key[0] == label
            ]
            stats[label]["bit_identical_to_single_device"] = bool(ident) and all(ident)

    def opened(kb, label, stats):
        t = time.perf_counter()
        kb.retrieve_batch(texts_of("rep_B1_n100", 0, 1), 1)  # packs (may answer from the host)
        stats["open_s"] = time.perf_counter() - t
        stats["pack_s"] = kb._stats.snapshot().get("pack", {}).get("last_s")
        settle(kb.engine, stats, label)
        stats["pack_events"] = dict(kb.engine.pack_events)

    def run_solo():
        stats = res["solo"] = {}
        kb = svs_tpu_torch.KB(store, embed, device="cuda", precision="int8")
        try:
            opened(kb, "mesh_solo", stats)
            for label, _, n in MESH_SHAPES:
                run_shape(kb, label, n, solo_answers, stats)
            run_shape(kb, "where_B64", 100, solo_answers, stats, where={"tenant": 7},
                      match=tenant7)
            for label, _, n in REPLICA_SHAPES:
                run_shape(kb, "rep_" + label, n, solo_answers, stats)
            # each replica's slice alone: the launches one device takes
            halves = rep_res["single_device_slices"] = {}
            for label, b, n in REPLICA_SHAPES:
                if b < 2:
                    continue
                sums: dict = {}
                for i, part in enumerate(np.array_split(queries["rep_" + label][0], MESH_SHARDS)):
                    key = f"slice_{label}_{i}"
                    queries[key] = [part]
                    qvec.update(zip(texts_of(key, 0, len(part)), part))
                    run_shape(kb, key, n, {}, stats)
                    for k, v in stats[key]["launches"].items():
                        sums[k] = sums.get(k, 0) + v
                halves[label] = sums
        finally:
            kb.close(write_sidecar=False)

    def run_mesh_int8():
        stats = res["int8"] = {}
        torch.cuda.reset_peak_memory_stats()
        mesh = default_mesh(devices=["cuda:0"] * MESH_SHARDS)
        kb = svs_tpu_torch.KB(store, embed, mesh=mesh, precision="int8")
        try:
            opened(kb, "mesh_int8", stats)
            ev = stats["pack_events"]
            if ev["sidecar"] != 1 or ev["scan"] != 0:
                raise AssertionError(f"mesh_int8: pack_events {ev}: the mesh did not load the sidecar")
            corpus = kb.engine.corpus
            mirror = corpus.dev_rescore[0] if corpus.dev_rescore is not None else None
            if not isinstance(mirror, ShardedArray) or [
                int(b.shape[0]) for b in mirror.row_blocks()
            ] != [corpus.n_padded // MESH_SHARDS] * MESH_SHARDS:
                raise AssertionError(f"mesh_int8: the sharded mirror is {mirror}")
            stats["mirror_rows"] = [int(b.shape[0]) for b in mirror.row_blocks()]
            answers = mesh_int8_answers
            for label, _, n in MESH_SHAPES:
                run_shape(kb, label, n, answers, stats)
            run_shape(kb, "where_B64", 100, answers, stats, where={"tenant": 7}, match=tenant7)
            same_as_solo(answers, stats, [s[0] for s in MESH_SHAPES] + ["where_B64"])
            if stats["where_B64"]["launches"]:
                raise AssertionError("mesh where=: the subset route launched a prescore kernel")
            texts = texts_of("B64_n100", 0, 64)
            prof = stats["profiled_B64_n100"] = device_idle_share(
                lambda: kb.retrieve_batch(texts, 100)
            )
            window = prof["profile"]
            log(f"e2e mesh int8: profiled B=64 {window['wall_ms']:.2f} ms, kernels "
                f"{window.get('kernel_ms')} ms in {window.get('kernel_launches')} launches "
                f"(idle share {window['idle_share']}; unprofiled "
                f"{prof['unprofiled_wall_ms']:.2f} ms)")
            for name, k in window.get("top_kernels", {}).items():
                log(f"  {k['ms']:.3f} ms = {k['launches']} x {k['us_per_launch']:.2f} us  {name}")
        finally:
            kb.close(write_sidecar=False)
        stats["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        log(f"e2e mesh int8: open {stats['open_s']:.2f} s (pack {stats['pack_s']}), mirror "
            f"blocks {stats['mirror_rows']}, bit-identical to one device "
            f"{ {k: v['bit_identical_to_single_device'] for k, v in stats.items() if isinstance(v, dict) and 'bit_identical_to_single_device' in v} }; "
            f"peak {stats['peak_mb']:.0f} MB")

    def run_mesh_bf16():
        stats = res["bf16"] = {}
        torch.cuda.reset_peak_memory_stats()
        kb = svs_tpu_torch.KB(precision_store(store, "bf16"), embed, precision="bf16",
                              mesh=default_mesh(devices=["cuda:0"] * MESH_SHARDS))
        try:
            opened(kb, "mesh_bf16", stats)
            answers: dict = {}
            for label, _, n in MESH_SHAPES[:2]:
                run_mesh_shape(kb, bf16_queries["bf16_" + label], "bf16_" + label, n,
                               ref_matrix, answers, stats)
            same_as_solo(answers, stats, ["bf16_" + s[0] for s in MESH_SHAPES[:2]],
                         solo=bf16_solo)
            stats["pack_events"] = dict(kb.engine.pack_events)
        finally:
            kb.close(write_sidecar=False)
        stats["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        log(f"e2e mesh bf16: open {stats['open_s']:.2f} s ({stats['pack_events']}); bit-identical to one "
            f"bf16 device {[stats[k]['bit_identical_to_single_device'] for k in bf16_queries]}; "
            f"peak {stats['peak_mb']:.0f} MB")

    def per_replica(kb, label, n):
        """One more call of the shape's first queries, every engine's width
        hint cleared and the slices run one after another (a lock around
        each), so that each engine's launches are its own: the batch must
        split into one slice a replica, and every replica must launch its
        slice's first kernel."""
        eng = kb.engine
        engines = [eng, *eng._secondaries]
        v = queries["rep_" + label][0]
        plan = eng._plan(eng.corpus, v)
        if [e for e, _, _ in plan] != engines[: min(len(v), MESH_SHARDS)]:
            raise AssertionError(f"replicas {label}: the plan runs on {len(plan)} replica(s)")
        for e in engines:
            e._cand_hint.clear()
        lock = threading.Lock()
        counts = [dict() for _ in engines]

        def serial(plan, fn):
            def counted(e, c, q):
                with lock:
                    before = P.launch_counts()
                    try:
                        return fn(e, c, q)
                    finally:
                        mine = counts[engines.index(e)]
                        for k, x in P.launch_counts().items():
                            if x - before[k]:
                                mine[k] = mine.get(k, 0) + x - before[k]
            return type(eng)._run(eng, plan, counted)

        eng._run = serial
        try:
            hits = kb.retrieve_batch(texts_of("rep_" + label, 0, len(v)), n)
        finally:
            del eng._run
        rows, scores = hits_to_arrays(hits)
        check_results(rows, scores, v, ref_matrix, n)
        first = REPLICA_FIRST_KERNEL[label]
        for i, mine in enumerate(counts[: len(plan)]):
            if mine.get(first, 0) < 1:
                raise AssertionError(f"replicas {label}: replica {i} launched {mine}, "
                                     f"not its slice's {first}")
        log(f"  replicas {label}: per replica, slices run one after another: {counts}")
        return counts

    def run_replicas():
        stats = rep_res["int8"] = {}
        torch.cuda.reset_peak_memory_stats()
        kb = svs_tpu_torch.KB(store, embed, replicas=["cuda:0"] * MESH_SHARDS, precision="int8")
        try:
            opened(kb, "replicas", stats)
            answers: dict = {}
            for label, b, n in REPLICA_SHAPES:
                run_shape(kb, "rep_" + label, n, answers, stats)
                got = stats["rep_" + label]["launches"]
                one = rep_res["single_device_slices"].get(label)
                if one is not None:
                    stats["rep_" + label]["per_replica"] = per_replica(kb, label, n)
                    log(f"  replicas {label}: launches {got}; the single device on the "
                        f"{MESH_SHARDS} slices {one} (a batch widens as a whole, a slice alone "
                        f"on its own)")
            same_as_solo(answers, stats, ["rep_" + s[0] for s in REPLICA_SHAPES])
            # the clone's mirrors follow the primary's background upload on
            # the first call after it: checked after the shapes
            corpus = kb.engine.corpus
            (clone,) = corpus.replica_clones
            for name, a, b in (("data", clone.data, corpus.data),
                               ("row_scales", clone.row_scales, corpus.row_scales),
                               ("mirror", clone.dev_rescore[0], corpus.dev_rescore[0]),
                               ("emb", clone.dev_emb, corpus.dev_emb)):
                if a.data_ptr() == b.data_ptr() or not torch.equal(a, b):
                    raise AssertionError(f"replicas: the clone's {name} is not a distinct equal copy")
        finally:
            kb.close(write_sidecar=False)
        stats["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        log(f"e2e replicas: open {stats['open_s']:.2f} s; bit-identical to one device "
            f"{ {k: v['bit_identical_to_single_device'] for k, v in stats.items() if isinstance(v, dict) and 'bit_identical_to_single_device' in v} }; "
            f"peak {stats['peak_mb']:.0f} MB")

    int8 = ["_fused3_extract_int8", "_fused2_extract_int8", "_staged_finish"]
    for label, expected, run in (
        ("mesh_solo", int8, run_solo),
        ("mesh_int8", ["_fused3_extract_int8", "_fused2_extract_int8", "_staged_finish",
                       "_extract"], run_mesh_int8),
        ("mesh_bf16", ["_fused3_extract", "_fused2_extract"], run_mesh_bf16),
        ("replicas", int8 + ["_fused_extract_int8"], run_replicas),
    ):
        drive_path(label, expected, run, out)
        torch.cuda.empty_cache()
    return mesh_int8_answers


def texts_of(label: str, rep: int, b: int) -> list:
    return [f"mesh-{label}-{rep}-{i}" for i in range(b)]


def mesh_pairwise(store: Path, ref, oracle, out: dict) -> None:
    """The mesh's pairwise ring and its dim-sharded retrieval on the 100k
    dupe-planted store (after ``filtered_pairs`` tagged it), each path with
    the launch counts set to 0 just before it and read just after:

    - ``mesh_pairwise``: ``document_top_pairwise_scores(10,000)`` twice on
      an int8 ``KB(mesh=default_mesh(devices=[cuda:0] * 2))`` (the ring on
      the pack dequantized to bf16 per shard), held against the
      brute-force top 10,000 pairs; then the top ``MESH_WHERE_K`` pairs
      with ``where={"head": True}`` (no subset corpus on a mesh: the
      exact global pair prefix, post-filtered and widened 4x), held
      against the subset's oracle;
    - ``mesh_2d``: a bf16 ``KB(mesh=mesh_2d(2, 2, devices=[cuda:0] * 4))``
      at B=8, n=100 (each row block's partial dots over two dim blocks,
      summed), held against a brute-force scan.

    Records the calls' seconds, the ring's widths, widens and peak device
    memory.  Returns the first call's pairs, ``(doc rows [k, 2], scores)``,
    for the multihost phase."""
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.parallel import default_mesh, mesh_2d
    from svs_tpu_torch.parallel import pairwise_sharded

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    res = out["paths_detail_mesh_pairwise"] = {}
    head = torch.arange(20480, device=ref.device)
    v, r, c = pair_oracle(ref[head], MESH_WHERE_K)
    head_oracle = (v, head[r], head[c])
    widths = []
    real_pass = pairwise_sharded._ring_pass

    def ring_pass(docs, n_valid, k, per_row_k, mesh, data_axis):
        widths[-1].append([k, per_row_k])
        return real_pass(docs, n_valid, k, per_row_k, mesh, data_axis)

    first_pairs = []

    def run_ring():
        torch.cuda.reset_peak_memory_stats()
        kb = svs_tpu_torch.KB(store, embed, precision="int8",
                              mesh=default_mesh(devices=["cuda:0"] * MESH_SHARDS))
        pairwise_sharded._ring_pass = ring_pass
        try:
            lat, widens = [], []
            for where in (None, None, {"head": True}):
                widths.append([])
                before = kb.engine.widen_retries
                torch.cuda.synchronize()
                t = time.perf_counter()
                k = PAIR_K if where is None else MESH_WHERE_K
                pairs = kb.document_top_pairwise_scores(k, where=where)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
                widens.append(kb.engine.widen_retries - before)
                check_pairs(pairs, ref, oracle if where is None else head_oracle, k)
                if not first_pairs:
                    first_pairs.append(pair_arrays(pairs))
                if where is not None:
                    if not all(d["meta"]["head"] is True for _, a, b in pairs for d in (a, b)):
                        raise AssertionError("mesh where=: a pair does not pass the filter")
            res.update({
                "first_s": lat[0],
                "warm_ms": [lat[1] * 1e3],
                "where_head_s": lat[2],
                "widen_retries_per_call": widens,
                "ring_k_and_widths_per_call": widths,
                "pack_events": dict(kb.engine.pack_events),
                "phase_p50_ms": {k: v["p50_s"] * 1e3 for k, v in kb._stats.snapshot().items()},
                "peak_mb": torch.cuda.max_memory_allocated() / 1e6,
            })
        finally:
            pairwise_sharded._ring_pass = real_pass
            kb.close(write_sidecar=False)
        log(f"e2e mesh_pairwise: first {lat[0]:.3f} s, warm {lat[1] * 1e3:.1f} ms, where="
            f"head {lat[2]:.3f} s; widens {widens}; ring (k, width) per call {widths}; "
            f"peak {res['peak_mb']:.0f} MB; exact vs the oracles")

    def run_2d():
        stats = res["mesh_2d"] = {}
        rng = np.random.default_rng(SEED + 10)
        kb = svs_tpu_torch.KB(store, embed, precision="bf16",
                              mesh=mesh_2d(2, 2, devices=["cuda:0"] * 4))
        try:
            lat = []
            for rep in range(MESH_REPS):
                v8 = unit_queries(rng, 8)
                texts = [f"mesh2d-{rep}-{i}" for i in range(8)]
                qvec.update(zip(texts, v8))
                torch.cuda.synchronize()
                t = time.perf_counter()
                hits = kb.retrieve_batch(texts, 100)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
                check_results(*hits_to_arrays(hits), v8, ref, 100)
            if kb.engine.model_axis != "model" or kb.engine.corpus.dev_rescore is not None:
                raise AssertionError("mesh_2d: not a dim-sharded engine with the host rescore")
            stats.update({"first_s": lat[0], "warm_ms": [x * 1e3 for x in lat[1:]],
                          "pack_events": dict(kb.engine.pack_events)})
        finally:
            kb.close(write_sidecar=False)
        log(f"e2e mesh_2d: bf16 2 x 2, B=8 n=100 first {lat[0]:.3f} s, warm "
            f"{stats['warm_ms']} ms; exact vs scan")

    drive_path("mesh_pairwise", ["_extract"], run_ring, out)
    torch.cuda.empty_cache()
    drive_path("mesh_2d", ["_extract"], run_2d, out)
    torch.cuda.empty_cache()
    return first_pairs[0]


MULTIHOST_PROCESSES = 2
#: The multihost children's retrieval shapes: ``mesh_int8``'s first three,
#: each a first call and ``MESH_REPS - 1`` warm calls on its query sets.
MULTIHOST_SHAPES = MESH_SHAPES[:3]
#: Seconds a multihost child may run, and its group's collective timeout.
MULTIHOST_CHILD_S = 300
MULTIHOST_GROUP_S = 120


def multihost_child(args) -> int:
    """One process of the multihost phase (``--multihost-child``): joins a
    ``MULTIHOST_PROCESSES``-process mesh (``multihost.initialize``, one
    shard a process on ``--mh-device``), sets the launch counts to 0, then
    ``retrieve``: an int8 ``KB`` from the 1M store's sidecar, the open call
    and ``wait_for_mirror`` as ``mesh_int8``, then ``MULTIHOST_SHAPES``
    on ``mesh_int8``'s query sets (the width hint cleared before each); or
    ``pairs``: ``document_top_pairwise_scores(PAIR_K)`` twice on an int8
    ``KB`` of the 100k dupe-planted store.  Writes its answers
    (``rank<i>.npz``) and its numbers (``rank<i>.json``: latencies, open
    seconds, peak device memory, launches, the exchanges' count, bytes and
    seconds) under ``--mh-work``; the parent checks them."""
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.ops import pallas_extract as P
    from svs_tpu_torch.parallel import multihost

    dev = torch.device(args.mh_device)
    mesh = multihost.initialize(
        coordinator=args.mh_coordinator, num_processes=MULTIHOST_PROCESSES,
        process_id=args.mh_rank, devices=[dev], backend=args.mh_backend,
        timeout=MULTIHOST_GROUP_S,
    )
    link = mesh.link
    work = Path(args.mh_work)
    rec = {"rank": args.mh_rank, "backend": link.backend, "shards": int(mesh.devices.size),
           "local_shards": len(mesh.local_devices()), "shapes": {}}
    arrays = {}
    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    def exchanges():
        return link.calls, link.bytes, link.seconds

    def per_call(before, calls):
        return {k: (a - b) / calls for k, a, b in zip(("calls", "bytes", "seconds"),
                                                       exchanges(), before)}

    torch.empty(0, device=dev)  # the device's allocator up before its stats are reset
    torch.cuda.reset_peak_memory_stats(dev)
    P.reset_launch_counts()
    t = time.perf_counter()
    kb = svs_tpu_torch.KB(args.mh_store, embed, mesh=mesh, precision="int8")
    try:
        if args.mh_task == "retrieve":
            for label, vs in mesh_queries().items():
                for rep, v in enumerate(vs):
                    qvec.update(zip(texts_of(label, rep, len(v)), v))
            kb.retrieve_batch(texts_of("rep_B1_n100", 0, 1), 1)  # packs, as mesh_int8's open
            settle(kb.engine, rec, f"multihost child {args.mh_rank}")
            rec["open_s"] = time.perf_counter() - t
            rec["mirror"] = kb.engine.corpus.dev_rescore is not None
            calls = [(label, [(texts_of(label, rep, b), n) for rep in range(MESH_REPS)])
                     for label, b, n in MULTIHOST_SHAPES]
        else:
            calls = [("pairs", [None, None])]
        for label, batches in calls:
            kb.engine._cand_hint.clear()
            lat = []
            before = exchanges()
            for rep, call in enumerate(batches):
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                if call is None:
                    got = pair_arrays(kb.document_top_pairwise_scores(PAIR_K))
                else:
                    got = hits_to_arrays(kb.retrieve_batch(*call))
                torch.cuda.synchronize(dev)
                lat.append(time.perf_counter() - t)
                arrays[f"{label}_{rep}_rows"], arrays[f"{label}_{rep}_scores"] = got
            rec["shapes"][label] = {
                "first_s": lat[0], "warm_ms": [x * 1e3 for x in lat[1:]],
                "warm_p50_ms": statistics.median(lat[1:]) * 1e3,
                "exchanges_per_call": per_call(before, len(lat)),
            }
        rec["pack_events"] = dict(kb.engine.pack_events)
    finally:
        kb.close(write_sidecar=False)
    rec["launches"] = P.launch_counts()
    rec["peak_mb"] = torch.cuda.max_memory_allocated(dev) / 1e6
    np.savez(work / f"rank{args.mh_rank}.npz", **arrays)
    (work / f"rank{args.mh_rank}.json").write_text(json.dumps(rec))
    torch.distributed.destroy_process_group()
    return 0


def run_multihost(task: str, store: Path, work: Path, backend: str, devices: list) -> list:
    """Start ``MULTIHOST_PROCESSES`` children of this script (one a
    ``devices`` entry) on a free local port and wait for them; fails when
    one exits non-zero or outlives ``MULTIHOST_CHILD_S`` (then every child
    is killed).  Returns each child's ``(numbers, answers)``."""
    import socket

    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(MULTIHOST_PROCESSES):
        logf = open(work / f"rank{rank}.log", "wb")
        procs.append((logf, subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--multihost-child",
             "--mh-task", task, "--mh-rank", str(rank), "--mh-store", str(store),
             "--mh-coordinator", f"127.0.0.1:{port}", "--mh-backend", backend,
             "--mh-device", devices[rank], "--mh-work", str(work)],
            stdout=logf, stderr=subprocess.STDOUT,
        )))
    deadline = time.monotonic() + MULTIHOST_CHILD_S
    failed = None
    try:
        for rank, (_, proc) in enumerate(procs):
            try:
                code = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed = f"child {rank} outlived {MULTIHOST_CHILD_S} s"
                break
            if code != 0:
                failed = f"child {rank} exited {code}"
                break
    finally:
        for logf, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    if failed is not None:
        for rank in range(MULTIHOST_PROCESSES):
            tail = (work / f"rank{rank}.log").read_bytes()[-4000:].decode(errors="replace")
            log(f"multihost {task} child {rank} log tail:\n{tail}")
        raise AssertionError(f"multihost {task} ({backend}): {failed}")
    return [(json.loads((work / f"rank{r}.json").read_text()),
             dict(np.load(work / f"rank{r}.npz"))) for r in range(MULTIHOST_PROCESSES)]


def multihost_backends() -> list:
    """``(backend, one device per child)`` runs of the multihost phase:
    gloo with both children on ``cuda:0``; NCCL, one card a child, where
    the machine has the cards (NCCL refuses two processes on one card)."""
    import torch

    runs = [("gloo", ["cuda:0"] * MULTIHOST_PROCESSES)]
    if torch.cuda.device_count() >= MULTIHOST_PROCESSES:
        runs.append(("nccl", [f"cuda:{i}" for i in range(MULTIHOST_PROCESSES)]))
    else:
        log(f"multihost: NCCL not run: {torch.cuda.device_count()} CUDA device(s), and NCCL "
            f"refuses {MULTIHOST_PROCESSES} processes on one card")
    return runs


def multihost_phase(label: str, task: str, store: Path, work: Path, out: dict,
                    expected: list, check) -> None:
    """Each backend of ``multihost_backends`` as a path of its own: the
    children run it (``run_multihost``), their launch counts are added to
    this process's (the path ran there), each child's numbers are
    recorded and printed, and ``check(children)`` holds their answers."""
    from svs_tpu_torch.ops import pallas_extract as P

    res = out[f"paths_detail_{label}"] = {}
    for backend, devices in multihost_backends():
        def run():
            children = run_multihost(task, store, work / "multihost", backend, devices)
            for rec, _ in children:
                if rec["shards"] != MULTIHOST_PROCESSES or rec["local_shards"] != 1:
                    raise AssertionError(f"{label}: child {rec['rank']} sees {rec['shards']} "
                                         f"shards, {rec['local_shards']} local")
                for fn in P.KERNEL_WRAPPERS:
                    fn.launches += rec["launches"][fn.__name__]
                for shape, st in rec["shapes"].items():
                    ex = st["exchanges_per_call"]
                    log(f"e2e {label} ({backend}) child {rec['rank']} {shape}: first "
                        f"{st['first_s']:.3f} s, warm {st['warm_ms']} ms (p50 "
                        f"{st['warm_p50_ms']}); exchanges per call {ex['calls']:.1f}, "
                        f"{ex['bytes'] / 1e6:.3f} MB, {ex['seconds'] * 1e3:.2f} ms")
                log(f"e2e {label} ({backend}) child {rec['rank']}: open {rec.get('open_s')} "
                    f"s, pack_events {rec['pack_events']}, peak {rec['peak_mb']:.0f} MB")
            res[backend] = [rec for rec, _ in children]
            check(children)
            log(f"e2e {label} ({backend}): every answer exact vs the brute force, "
                f"bit-identical to the one-process mesh's and across the children")

        drive_path(f"{label}_{backend}", expected, run, out)


def same_arrays(a: tuple, b: tuple) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def multihost_retrieve(store: Path, ref_matrix, mesh_answers: dict, work: Path,
                       out: dict) -> None:
    """``KB(mesh=multihost.initialize(...))`` across two processes
    (``multihost_child``, task ``retrieve``), after the mesh phase (the
    1M store's sidecar: 2 x 507,904 rows) while this process holds no
    ``KB``.  Every child answer is held against the brute-force scan, bit
    for bit against ``mesh_int8``'s answers on the same queries (one
    process, the same two shards), and against the other child's."""
    queries = mesh_queries()

    def check(children):
        for rec, ans in children:
            ev = rec["pack_events"]
            if ev["sidecar"] != 1 or ev["scan"] != 0 or not rec["mirror"]:
                raise AssertionError(f"multihost child {rec['rank']}: pack_events {ev}, "
                                     f"mirror {rec['mirror']}")
            for label, _, n in MULTIHOST_SHAPES:
                for rep in range(MESH_REPS):
                    got = (ans[f"{label}_{rep}_rows"], ans[f"{label}_{rep}_scores"])
                    check_results(*got, queries[label][rep], ref_matrix, n)
                    if not same_arrays(got, mesh_answers[(label, rep)]):
                        raise AssertionError(f"multihost {label} rep {rep}: child "
                                             f"{rec['rank']} differs from mesh_int8")
                    first = children[0][1]
                    if not same_arrays(got, (first[f"{label}_{rep}_rows"],
                                             first[f"{label}_{rep}_scores"])):
                        raise AssertionError(f"multihost {label} rep {rep}: the children differ")

    multihost_phase("multihost_retrieve", "retrieve", store, work, out,
                    ["_fused3_extract_int8", "_fused2_extract_int8", "_staged_finish",
                     "_extract"], check)


def multihost_pairwise(store: Path, ref, oracle, mesh_pairs: tuple, work: Path,
                       out: dict) -> None:
    """The pairwise ring across two processes (``multihost_child``, task
    ``pairs``) on the 100k dupe-planted store: both calls held against the
    brute-force oracle, bit for bit against ``mesh_pairwise``'s first call
    (one process, two shards) and against the other child's."""
    def check(children):
        for rec, ans in children:
            for i in range(2):
                got = (ans[f"pairs_{i}_rows"], ans[f"pairs_{i}_scores"])
                check_pair_rows(*got, ref, oracle, PAIR_K)
                if not same_arrays(got, mesh_pairs):
                    raise AssertionError(f"multihost pairs call {i}: child {rec['rank']} "
                                         f"differs from mesh_pairwise")
                first = children[0][1]
                if not same_arrays(got, (first[f"pairs_{i}_rows"], first[f"pairs_{i}_scores"])):
                    raise AssertionError(f"multihost pairs call {i}: the children differ")

    multihost_phase("multihost_pairwise", "pairs", store, work, out, ["_extract"], check)


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
    Returns the reference matrix with the appended rows, and the mask of
    its deleted rows."""
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
    return ref_matrix, dead


#: The serve phase (``svs_tpu_torch.serve``): single-query ``/retrieve``
#: requests at n=100, sent at once from client threads over keep-alive
#: connections; the outstanding-query bound of its server (so that a burst
#: of eight 128-query requests passes it and is shed); a write store's
#: docs; and the mock-provider store of the two-worker CLI server (past
#: 16,384 docs, so its pack takes the fused kernels).
SERVE_REQUESTS = 256
SERVE_CLIENTS = 64
SERVE_MAX_QUEUE = 512
WRITE_DOCS = 10_000
CLI_DOCS = 20_000
#: Seconds the two CLI workers may take to listen (each packs, warms, and
#: one builds the kernels while the other waits for the build).
CLI_READY_S = 300


class _Served:
    """``make_app(kb).start("127.0.0.1", 0)`` on an event loop thread, for
    blocking clients; ``prepare(kb)`` runs on that loop before the start."""

    def __init__(self, kb, prepare=None, **app_kw):
        from svs_tpu_torch import serve
        from svs_tpu_torch.utils.aio import EventLoopThread

        self.kb = kb
        self.lt = EventLoopThread("chip-smoke-serve")

        async def start():
            if prepare is not None:
                await prepare(kb)
            self.app = serve.make_app(kb, **app_kw)
            return await self.app.start("127.0.0.1", 0)

        try:
            self.port = self.lt.run(start())
        except BaseException:
            self.close()
            raise

    def call(self, method, path, body=None, conn=None):
        """One request (on ``conn`` when given): ``(status, parsed body)``."""
        import http.client

        own = conn is None
        if own:
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=900)
        try:
            data = None if body is None else json.dumps(body).encode()
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            raw = r.read()
            ctype = r.getheader("Content-Type", "")
            return r.status, (json.loads(raw) if "json" in ctype else raw.decode())
        finally:
            if own:
                conn.close()

    def close(self):
        async def stop():
            app = getattr(self, "app", None)
            if app is not None:
                await app.close()
            await self.kb.close()

        try:
            self.lt.run(stop())
        finally:
            self.lt.stop()


def _json_hits(results):
    """A ``/retrieve`` answer as ``retrieve_batch`` hits (for
    :func:`hits_to_arrays`)."""
    return [[{"score": h["score"], "doc": h["doc"]} for h in hits] for hits in results]


def serve_phase(store: Path, ref_matrix, dead, out: dict) -> None:
    """The HTTP server on the 1M int8 store, in this process: an
    ``AsyncKB`` (``device='cuda'``) served by ``make_app(...).start`` on a
    loop thread, after ``load()``, the uploads' settling and
    ``warmup(warm_bucket_ladder(256), n=100)``.  Traffic:
    ``SERVE_REQUESTS`` single-query ``/retrieve`` (n=100) sent at once from
    ``SERVE_CLIENTS`` threads over keep-alive ``http.client`` connections
    (latency per request, requests per second), one 64-query request, then
    a burst of eight 128-query requests past ``SERVE_MAX_QUEUE`` that must
    be partly shed with 429.  Every hit is held against the brute-force
    scan of the live rows; fails when ``/stats`` shows no coalescing
    (``avg_batch`` <= 1), a call of the warm window took the host route,
    an upload failed, or #1, #2 or #3 did not launch."""
    import asyncio
    import http.client
    import threading

    import torch

    import svs_tpu_torch
    from svs_tpu_torch import serve
    from svs_tpu_torch.ops import pallas_extract as P

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 11)
    res = out["paths_detail_serve"] = {}

    async def prepare(kb):
        loop = asyncio.get_running_loop()
        t = time.perf_counter()
        await kb.load()
        res["load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if not await loop.run_in_executor(None, kb.engine.wait_for_mirror, 600):
            raise AssertionError("serve: the uploads did not settle")
        res["settle_s"] = time.perf_counter() - t
        t = time.perf_counter()
        await kb.warmup(serve.warm_bucket_ladder(256), n=100)
        res["warmup_s"] = time.perf_counter() - t

    def queries(label, b):
        v = unit_queries(rng, b)
        texts = [f"serve-{label}-{i}" for i in range(b)]
        qvec.update(zip(texts, v))
        return texts, v

    def concurrently(n_threads, work):
        """``work(i)`` on ``n_threads`` threads released together; the
        first error raises."""
        gate = threading.Barrier(n_threads)
        errors = []

        def run(i):
            try:
                work(i, gate)
            except BaseException as exc:  # re-raised below
                errors.append(exc)
                gate.abort()

        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        if any(th.is_alive() for th in threads):
            raise AssertionError("serve: a client thread did not finish")
        if errors:
            raise errors[0]

    def run():
        kb = svs_tpu_torch.AsyncKB(store, embed, device="cuda")
        srv = _Served(kb, prepare, max_queue=SERVE_MAX_QUEUE)
        try:
            kb._stats.reset()  # the warm window starts here
            before = P.launch_counts()
            texts, vecs = queries("single", SERVE_REQUESTS)
            results = [None] * SERVE_REQUESTS
            lat = [0.0] * SERVE_REQUESTS

            def client(ci, gate):
                conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=900)
                conn.connect()
                try:
                    gate.wait()
                    for i in range(ci, SERVE_REQUESTS, SERVE_CLIENTS):
                        t0 = time.perf_counter()
                        st, body = srv.call("POST", "/retrieve",
                                            {"query": texts[i], "n": 100}, conn)
                        lat[i] = time.perf_counter() - t0
                        if st != 200:
                            raise AssertionError(f"serve: /retrieve answered {st}: {body}")
                        results[i] = body["results"]
                finally:
                    conn.close()

            t = time.perf_counter()
            concurrently(SERVE_CLIENTS, client)
            wall = time.perf_counter() - t
            check_results(*hits_to_arrays(_json_hits(results)), vecs, ref_matrix, 100,
                          dead=dead)
            st, stats = srv.call("GET", "/stats")
            server = dict(stats["server"])
            lat_ms = np.asarray(lat) * 1e3
            res["single"] = {
                "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS, "wall_s": wall,
                "requests_per_s": SERVE_REQUESTS / wall,
                "p50_ms": float(np.percentile(lat_ms, 50)),
                "p99_ms": float(np.percentile(lat_ms, 99)),
                "max_ms": float(lat_ms.max()),
                "server": server,
                "launches": {k: v - before[k] for k, v in P.launch_counts().items()},
            }
            if not server["avg_batch"] > 1:
                raise AssertionError(f"serve: no coalescing: {server}")
            texts64, vecs64 = queries("batch64", 64)
            t = time.perf_counter()
            st, body = srv.call("POST", "/retrieve", {"queries": texts64, "n": 100})
            res["batch64_ms"] = (time.perf_counter() - t) * 1e3
            if st != 200:
                raise AssertionError(f"serve: the 64-query /retrieve answered {st}")
            check_results(*hits_to_arrays(_json_hits(body["results"])), vecs64,
                          ref_matrix, 100, dead=dead)
            # a burst past the outstanding-query bound: shed, all or nothing
            burst = [queries(f"burst{j}", 128) for j in range(8)]
            answers = [None] * 8

            def bursty(j, gate):
                gate.wait()
                answers[j] = srv.call("POST", "/retrieve",
                                      {"queries": burst[j][0], "n": 100})

            concurrently(8, bursty)
            statuses = [a[0] for a in answers]
            if statuses.count(429) == 0 or statuses.count(200) == 0 or set(statuses) - {200, 429}:
                raise AssertionError(f"serve: the burst past max_queue answered {statuses}")
            for (st, body), (_, v) in zip(answers, burst):
                if st == 200:
                    check_results(*hits_to_arrays(_json_hits(body["results"])), v,
                                  ref_matrix, 100, dead=dead)
            st, stats = srv.call("GET", "/stats")
            res["burst"] = {"statuses": statuses, "server": stats["server"]}
            if stats["server"]["shed"] != 128 * statuses.count(429):
                raise AssertionError(f"serve: shed {stats['server']['shed']} queries")
            snap = kb.stats()
            res["phase_p50_ms"] = {k: v["p50_s"] * 1e3 for k, v in snap.items()
                                   if isinstance(v, dict) and "p50_s" in v}
            res["dispatch"] = snap["dispatch"]
            if "host_search" in snap:
                raise AssertionError("serve: a call of the warm window took the host route")
            if snap["dispatch"]["pack_upload_failures"] or snap["dispatch"]["mirror_upload_failures"]:
                raise AssertionError(f"serve: an upload failed: {snap['dispatch']}")
            single = res["single"]
            log(f"e2e serve: load {res['load_s']:.2f} s, settle {res['settle_s']:.2f} s, "
                f"warmup {res['warmup_s']:.2f} s; {SERVE_REQUESTS} single /retrieve from "
                f"{SERVE_CLIENTS} clients: p50 {single['p50_ms']:.2f} ms, p99 "
                f"{single['p99_ms']:.2f} ms, {single['requests_per_s']:.1f} req/s, "
                f"avg_batch {server['avg_batch']:.2f} ({server['batches']} batches), "
                f"launches {({k: v for k, v in single['launches'].items() if v})}; "
                f"64-query request {res['batch64_ms']:.1f} ms; burst {statuses}; "
                f"phases {({k: round(v, 2) for k, v in res['phase_p50_ms'].items()})}; "
                f"exact vs the live rows' scan")
        finally:
            srv.close()

    drive_path("serve", ["_fused3_extract_int8", "_fused2_extract_int8", "_staged_finish"],
               run, out)
    torch.cuda.empty_cache()


def serve_pairwise(store: Path, ref, oracle, out: dict) -> None:
    """``/pairwise`` at n = ``PAIR_K`` on the served 100k dupe-planted store
    and ``tools.find_near_duplicates`` (every pair: threshold -1) on a
    ``KB``, each held to the brute-force pair oracle; the pair kernels
    (#9) must launch."""
    import torch

    import svs_tpu_torch
    from svs_tpu_torch import tools

    async def embed(texts):
        raise AssertionError("the pairwise path does not embed")

    res = out["paths_detail_serve_pairwise"] = {}

    def run():
        srv = _Served(svs_tpu_torch.AsyncKB(store, embed, device="cuda"))
        try:
            lat = []
            for _ in range(2):
                t = time.perf_counter()
                st, body = srv.call("POST", "/pairwise", {"n": PAIR_K})
                lat.append(time.perf_counter() - t)
                if st != 200:
                    raise AssertionError(f"serve: /pairwise answered {st}: {str(body)[:200]}")
                check_pairs([(p["score"], p["doc_a"], p["doc_b"]) for p in body["pairs"]],
                            ref, oracle, PAIR_K)
            res["pairwise_s"] = lat
        finally:
            srv.close()
        kb = svs_tpu_torch.KB(store, embed, device="cuda")
        try:
            t = time.perf_counter()
            dups = tools.find_near_duplicates(kb, threshold=-1.0, max_pairs=PAIR_K)
            res["find_near_duplicates_s"] = time.perf_counter() - t
            with kb.bulk_query_docs() as q:  # doc i + 1 holds row i
                for _, a, _b in dups[:: max(1, len(dups) // 50)]:
                    if q.query_doc(a)["text"] != f"synthetic document #{a - 1}":
                        raise AssertionError("a doc id does not hold its row")
        finally:
            kb.close()
        check_pairs([(s, {"text": f"#{a - 1}"}, {"text": f"#{b - 1}"}) for s, a, b in dups],
                    ref, oracle, PAIR_K)
        log(f"e2e serve_pairwise: /pairwise n={PAIR_K} {[round(x, 3) for x in lat]} s, "
            f"find_near_duplicates {res['find_near_duplicates_s']:.3f} s; exact vs the oracle")

    drive_path("serve_pairwise", ["pairwise_keys_extract"], run, out)
    torch.cuda.empty_cache()


def _socket_owners(port: int, pids) -> dict:
    """``{pid: {tcp state}}`` of the sockets on local ``port`` that each of
    ``pids`` holds (``0A`` listening, ``01`` established), from ``/proc``."""
    import os

    states = {}
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            lines = Path(table).read_text().splitlines()[1:]
        except OSError:
            continue
        for line in lines:
            f = line.split()
            if int(f[1].rsplit(":", 1)[1], 16) == port:
                states[f[9]] = f[3]
    owners = {}
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                link = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if link.startswith("socket:[") and link[8:-1] in states:
                owners.setdefault(pid, set()).add(states[link[8:-1]])
    return owners


def _children(pid: int) -> list:
    import os

    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                stat = Path(f"/proc/{d}/stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d))
    return out


def serve_writes_cli_phase(work: Path, out: dict) -> None:
    """Writes through the server, the CLI server with two workers, and the
    store audit:

    - a ``writable`` server on a new ``WRITE_DOCS`` x 1536 store takes
      ``/add``, ``/delete`` and ``/kv`` calls; ``/retrieve`` then sees the
      added docs and never a deleted one (held to a brute-force scan of
      the live rows), and ``/kv`` reads back what was written;
    - ``python -m svs_tpu_torch serve <store> --workers 2`` as a
      subprocess, from a copy of the package with nothing built, on a
      mock-provider store (``CLI_DOCS`` random 3-dim rows; the mock embeds
      every query as (1, 0, 0)): both workers listen and hold answered
      keep-alive connections (``/healthz``, ``/retrieve`` against a NumPy
      scan), SIGTERM ends the parent with code 0 and its worker reaped, and
      the copy's build directory holds one kernel library and one native
      library (the workers built each once between them);
    - ``tools.selfcheck(store, device="cuda")`` on the write store is
      ``ok``."""
    import os
    import signal
    import socket

    import torch

    import svs_tpu_torch
    from svs_tpu_torch import tools
    from svs_tpu_torch.store.blob import embedding_to_bytes
    from svs_tpu_torch.store.db import Database

    res = out["paths_detail_serve_writes_cli"] = {}

    def write(path, m, params=None):
        db = Database(path)
        try:
            with db.transaction() as tx:
                tx.add_docs_bulk([f"synthetic document #{i}" for i in range(len(m))],
                                 [embedding_to_bytes(r) for r in m])
                if params is not None:
                    tx.set_key("embedding_func_params", json.dumps(params))
                tx.bump_matrix_version()
        finally:
            db.close()

    def run_writes():
        path = work / "writes.sqlite"
        rng = np.random.default_rng(SEED + 12)
        m = unit_queries(rng, WRITE_DOCS)
        write(path, m)
        qvec = {}

        async def embed(texts):
            return [qvec[t].tolist() for t in texts]

        added = unit_queries(rng, 16)
        texts = [f"synthetic document #{WRITE_DOCS + i}" for i in range(16)]
        qvec.update(zip(texts, added))
        ref = torch.from_numpy(np.concatenate([m, added])).cuda()
        dead = torch.zeros(len(ref), dtype=torch.bool, device=ref.device)
        srv = _Served(svs_tpu_torch.AsyncKB(path, embed, device="cuda"), writable=True)
        try:
            st, body = srv.call("POST", "/add", {"texts": texts, "metas": [{"w": i} for i in range(16)]})
            if st != 200 or len(body["ids"]) != 16:
                raise AssertionError(f"serve writes: /add answered {st}: {body}")
            ids = body["ids"]
            # the added docs are found by their own vectors
            st, body = srv.call("POST", "/retrieve", {"queries": texts, "n": 10})
            rows, scores = hits_to_arrays(_json_hits(body["results"]))
            if st != 200 or (rows[:, 0] != WRITE_DOCS + np.arange(16)).any():
                raise AssertionError("serve writes: an added doc was not its own top hit")
            check_results(rows, scores, added, ref, 10, dead=dead)
            # delete four added docs and four of the store's (doc i + 1 holds row i)
            gone_rows = [WRITE_DOCS + i for i in range(4)] + [0, 1, 2, 3]
            st, body = srv.call("POST", "/delete", {"ids": ids[:4] + [1, 2, 3, 4]})
            if st != 200 or body != {"deleted": 8}:
                raise AssertionError(f"serve writes: /delete answered {st}: {body}")
            dead[torch.tensor(gone_rows, device=dead.device)] = True
            gone_q = [texts[i] for i in range(4)]
            for r in range(4):
                qvec[f"gone-{r}"] = m[r]
            st, body = srv.call("POST", "/retrieve",
                                {"queries": gone_q + [f"gone-{r}" for r in range(4)], "n": 10})
            check_results(*hits_to_arrays(_json_hits(body["results"])),
                          np.concatenate([added[:4], m[:4]]), ref, 10, dead=dead)
            kv = [srv.call("PUT", "/kv/a%20key", "v1"), srv.call("GET", "/kv/a%20key"),
                  srv.call("DELETE", "/kv/a%20key"), srv.call("GET", "/kv/a%20key")]
            if [s for s, _ in kv] != [200, 200, 200, 404] or kv[1][1] != {"key": "a key", "value": "v1"}:
                raise AssertionError(f"serve writes: /kv answered {kv}")
            st, body = srv.call("GET", "/healthz")
            res["writes"] = {"healthz": body, "kv": [s for s, _ in kv]}
            if body["docs"] != WRITE_DOCS + 8:
                raise AssertionError(f"serve writes: /healthz counts {body['docs']} docs")
        finally:
            srv.close()
        t = time.perf_counter()
        report = tools.selfcheck(path, device="cuda")
        res["selfcheck_s"] = time.perf_counter() - t
        res["selfcheck"] = {k: v["ok"] for k, v in report["checks"].items()}
        if not report["ok"]:
            raise AssertionError(f"selfcheck failed: {json.dumps(report)[:2000]}")
        log(f"e2e serve writes: /add 16, /delete 8, /kv, then exact /retrieve on the "
            f"live rows; selfcheck ok in {res['selfcheck_s']:.2f} s ({res['selfcheck']})")
        path.unlink(missing_ok=True)

    def run_cli():
        root = Path(__file__).resolve().parent
        pkg = work / "cli_pkg"
        shutil.copytree(root / "svs_tpu_torch", pkg / "svs_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = work / "mock.sqlite"
        m = np.random.default_rng(SEED + 13).standard_normal((CLI_DOCS, 3)).astype(np.float32)
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        write(path, m, {"provider": "mock"})
        mock_q = np.asarray([[1.0, 0.0, 0.0]], dtype=np.float32)  # the mock's query
        ref = torch.from_numpy(m).cuda()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        logf = work / "cli_serve.log"
        t0 = time.perf_counter()
        with open(logf, "wb") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "svs_tpu_torch", "serve", str(path), "--workers", "2",
                 "--port", str(port), "--max-batch", "16"],
                cwd=pkg, stdout=f, stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONPATH": str(pkg)},
            )
        workers = [proc.pid]
        conns = []
        try:
            deadline = time.monotonic() + CLI_READY_S
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"the CLI server exited: {logf.read_text()[-4000:]}")
                workers = [proc.pid] + _children(proc.pid)
                owners = _socket_owners(port, workers)
                if len(workers) == 2 and all("0A" in owners.get(p, ()) for p in workers):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"the two workers never listened: {workers}: "
                                         f"{logf.read_text()[-4000:]}")
                time.sleep(0.2)
            res["cli_ready_s"] = time.perf_counter() - t0
            import http.client

            for _ in range(24):
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                conns.append(c)
                c.request("GET", "/healthz")
                r = c.getresponse()
                body = json.loads(r.read())
                if r.status != 200 or body["docs"] != CLI_DOCS:
                    raise AssertionError(f"CLI server /healthz: {r.status} {body}")
                c.request("POST", "/retrieve", body=json.dumps({"query": "anything", "n": 5}))
                r = c.getresponse()
                body = json.loads(r.read())
                if r.status != 200:
                    raise AssertionError(f"CLI server /retrieve: {r.status} {body}")
                check_results(*hits_to_arrays(_json_hits([body["results"]])), mock_q, ref, 5)
            owners = _socket_owners(port, workers)
            if not all("01" in owners.get(p, ()) for p in workers):
                raise AssertionError(f"a worker answered no connection: {owners}")
            for c in conns:
                c.close()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            if rc != 0:
                raise AssertionError(f"the CLI server exited {rc}: {logf.read_text()[-4000:]}")
            if Path(f"/proc/{workers[1]}").exists():
                raise AssertionError("a worker outlived the parent")
            build = pkg / "build" / "svs_tpu_torch"
            libs = sorted(str(p.relative_to(build)) for p in build.rglob("*.so"))
            res["cli"] = {"workers": workers, "libraries": libs,
                          "ready_s": res["cli_ready_s"]}
            kernel_libs = [p for p in libs if p.endswith("libsvs_kernels.so")]
            native_libs = [p for p in libs if p.endswith("libfastpack.so")]
            if len(kernel_libs) != 1 or len(native_libs) != 1 or len(libs) != 2:
                raise AssertionError(f"the workers' build directory holds {libs}")
            if list(build.rglob(".build-*")) or list(build.rglob("*.tmp")):
                raise AssertionError("a build left a temporary behind")
            log(f"e2e serve CLI: two workers ready in {res['cli_ready_s']:.1f} s (one "
                f"kernel build between them), both answered, SIGTERM -> exit 0; "
                f"build directory {libs}")
        finally:
            for c in conns:
                c.close()
            if proc.poll() is None:
                for pid in _children(proc.pid):
                    os.kill(pid, signal.SIGKILL)
                proc.kill()
                proc.wait(timeout=60)
            path.unlink(missing_ok=True)
            shutil.rmtree(pkg, ignore_errors=True)

    drive_path("serve_writes", [], run_writes, out)
    drive_path("serve_cli", [], run_cli, out)
    torch.cuda.empty_cache()


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


def pair_arrays(results) -> tuple:
    """A pairwise result as ``(doc rows [k, 2], each pair's smaller row
    first; scores float64 [k])`` (doc ``i`` holds row ``i``)."""
    idx = np.asarray(
        [[int(d["text"].rsplit("#", 1)[1]) for d in (a, b)] for _, a, b in results]
    ).reshape(-1, 2)
    idx.sort(axis=1)
    return idx, np.asarray([s for s, _, _ in results], dtype=np.float64)


def check_pairs(results, ref, oracle, k: int) -> None:
    check_pair_rows(*pair_arrays(results), ref, oracle, k)


def check_pair_rows(idx, scores, ref, oracle, k: int) -> None:
    """A pairwise result (``pair_arrays``) against the brute-force oracle
    of ``ref``: k pairs, finite scores within SCORE_TOL of the pairs' true
    dots, the oracle's pair at every rank except where the two scores lie
    within SCORE_TOL, and every oracle pair above the k-th score by
    SCORE_TOL present."""
    import torch

    if len(idx) != k:
        raise AssertionError(f"{len(idx)} pairs, want {k}")
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


def trace_times(prof) -> tuple:
    """``({kernel name: (device ms, launches)}, {host op: (total ms,
    count)})`` of one profiled window, from the profiler's raw events
    (``prof.events()`` builds a tree of them first, which costs seconds a
    window for a call of thousands of launches)."""
    import torch

    kernels: dict = {}
    host: dict = {}
    for e in prof.profiler.kineto_results.events():
        # a record_function range also shows up on the device timeline, as
        # a user annotation spanning kernels
        if e.is_user_annotation():
            continue
        into = kernels if e.device_type() == torch.autograd.DeviceType.CUDA else host
        ms, n = into.get(e.name(), (0.0, 0))
        into[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return kernels, host


#: Whether :func:`device_idle_share` has opened its empty first window.
_TRACER_STARTED = False


def device_idle_share(fn) -> dict:
    """``fn`` once unprofiled, then once in a ``torch.profiler`` window
    (``"profile"``): its wall time, the summed CUDA kernel time, the idle
    share 1 - kernel / wall (None where the profiler saw no device time),
    the twelve largest kernels, each with its launch count and device time
    per launch, the ten host operations with the most total time (host
    clock, nested operations counted in each that holds them, the
    profiler's own cost included), and the seconds spent reading the trace
    (``"read_s"``).  An empty window first, once a process, starts
    the device tracer outside the measured one; ``utils.trace`` tears CUPTI
    down after each window, and a device sync before each keeps its kernel
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    global _TRACER_STARTED
    if not _TRACER_STARTED:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        _TRACER_STARTED = True
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out: dict = {"unprofiled_wall_ms": (time.perf_counter() - t) * 1e3}
    torch.cuda.synchronize()  # completes the CUPTI teardown of the window before
    t_window = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    try:
        by_name, host_ops = trace_times(prof)
    except Exception as exc:  # a measurement, not a check: record why it is missing
        out["profile"] = {"wall_ms": wall_ms, "idle_share": None, "error": repr(exc)}
        return out
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    host = sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:10]
    out["profile"] = {
        "wall_ms": wall_ms,
        "kernel_ms": busy_ms,
        "kernel_launches": sum(n for _, n in by_name.values()),
        "idle_share": None if busy_ms == 0 else 1.0 - busy_ms / wall_ms,
        "top_kernels": {
            name[:80]: {"ms": ms, "launches": n, "us_per_launch": ms * 1e3 / n}
            for name, (ms, n) in top
        },
        "top_host_ops": {name[:60]: {"total_ms": ms, "count": n} for name, (ms, n) in host},
        "read_s": time.perf_counter() - t_window - wall_ms / 1e3,
    }
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
    transaction, then ``document_top_pairwise_scores(10,000)`` twice
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
                for _ in range(PAIR_CALLS):
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
    ``PAIR_CALLS`` calls per path, each result held against the
    brute-force oracle."""
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
                for _ in range(PAIR_CALLS):
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
                    window = prof["profile"]
                    log(f"e2e {label}: unprofiled {prof['unprofiled_wall_ms']:.2f} ms; "
                        f"profiled {window['wall_ms']:.2f} ms (idle share "
                        f"{window['idle_share']}; the trace read in {window.get('read_s', 0):.1f} s)")
                    for name, k in window.get("top_kernels", {}).items():
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
            mesh_pairs = mesh_pairwise(store, ref, oracle, out)
            multihost_pairwise(store, ref, oracle, mesh_pairs, work, out)
            serve_pairwise(store, ref, oracle, out)
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


#: Batches of the calibration phase (``retrieve_batch``, n=100), each first
#: tried at ``CAL_C`` candidates (n=100 before a widen), as the kernel
#: phase's v2/v3 crossover ladder.
CAL_BATCHES = (1, 8, 64, 256)
CAL_C = 400


def calibration_phase(store: Path, ref_matrix, work: Path, cross: dict, out: dict) -> None:
    """The dispatch calibration (``engine.calibrate``) on the card, with a
    fresh cache and probing on: an int8 ``KB`` on the 1M store (from its
    sidecar) and a bf16 one (its own sidecar) each run ``retrieve_batch`` at every
    batch of ``CAL_BATCHES`` (n=100; the width hint cleared before each,
    so that each batch's first try dispatches at C=400), joining the
    background probe each call spawns.  Then: every key has a measured
    winner, printed with its v2 / v3 ms beside the kernel phase's
    crossover; the first engine stayed with its prior (``GUARD_MIN_BATCH``)
    at every batch (one more dispatch each, read from the launch counters);
    a new int8 ``KB`` (and, for bf16, a new engine on the bf16 pack)
    follows the persisted winners — a v3 key launches the v3 kernel and no
    v2 one at C=400, a v2 key the reverse.  Every answer is exact against
    the brute-force scan."""
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.engine import calibrate
    from svs_tpu_torch.engine.index import RetrievalEngine
    from svs_tpu_torch.ops import pallas_extract as P

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 11)
    res = out["paths_detail_calibration"] = {"keys": {}}
    saved = {k: os.environ.get(k) for k in ("SVS_TPU_AUTOCALIB", "SVS_TPU_CALIB_CACHE")}

    def queries(label, b):
        v = unit_queries(rng, b)
        texts = [f"{label}-{i}" for i in range(b)]
        qvec.update(zip(texts, v))
        return texts, v

    def retrieve(kb, label, b):
        texts, v = queries(label, b)
        check_results(*hits_to_arrays(kb.retrieve_batch(texts, 100)), v, ref_matrix, 100)

    def first_dispatch(engine, corpus, b, names):
        """One engine dispatch at C=400 (an n=100 call's first try):
        the launches of the v3 and v2 kernels."""
        _, v = queries(f"dispatch-{b}", b)
        before = P.launch_counts()
        engine.topk_final(corpus, v, 100, CAL_C)
        torch.cuda.synchronize()
        after = P.launch_counts()
        return tuple(after[k] - before[k] for k in names)

    def check_dispatch(label, launched, v3):
        if (launched[0] > 0) != v3 or (launched[1] > 0) == v3:
            raise AssertionError(
                f"calibration {label}: want {'v3' if v3 else 'v2'}, launched "
                f"v3 {launched[0]} / v2 {launched[1]}")

    def run_precision(precision):
        names = (("_fused3_extract_int8", "_fused2_extract_int8") if precision == "int8"
                 else ("_fused3_extract", "_fused2_extract"))
        rec = res[precision] = {}
        t = time.perf_counter()
        # bf16: the KB opens the store under its own name, from that name's sidecar
        path = store if precision == "int8" else precision_store(store, precision)
        kb = svs_tpu_torch.KB(path, embed, device="cuda", precision=precision)
        try:
            retrieve(kb, f"cal-{precision}-open", 1)  # packs; may answer from the host
            settle(kb.engine, rec, f"calibration {precision}")
            rec["open_s"] = time.perf_counter() - t
            eng, corpus = kb.engine, kb.engine.corpus
            for b in CAL_BATCHES:
                eng._cand_hint.clear()  # this batch's first try at C=400
                retrieve(kb, f"cal-{precision}-{b}", b)
                if not eng.join_dispatch_probes(timeout=600):
                    raise AssertionError(f"calibration {precision} B={b}: the probe did not end")
            kind = calibrate.device_kind(eng.device)
            entries = calibrate.get_calibrator().entries()
            winners = {}
            for b in CAL_BATCHES:
                key = calibrate.dispatch_key(kind, precision, corpus.n_padded,
                                             corpus.dim_padded, b, CAL_C)
                if key not in entries:
                    raise AssertionError(f"calibration: no measured winner for {key}")
                prior = b >= P.GUARD_MIN_BATCH
                if eng._guarded_selection_possible(corpus, b, CAL_C) != prior:
                    raise AssertionError(f"calibration {precision} B={b}: the engine left its prior")
                check_dispatch(f"{precision} B={b} (first engine, sticky)",
                               first_dispatch(eng, corpus, b, names), prior)
                winners[b] = entries[key]["winner"]
                res["keys"][key] = dict(entries[key], batch=b, precision=precision,
                                        crossover_ms=cross.get(f"{precision} B={b}"))
                log(f"  calibration {key}: winner {entries[key]['winner']} (v2 "
                    f"{entries[key]['v2_ms']} ms, v3 {entries[key]['v3_ms']} ms); kernel "
                    f"phase crossover {cross.get(f'{precision} B={b}')}")
            if precision == "int8":
                follow = svs_tpu_torch.KB(store, embed, device="cuda")
                try:
                    retrieve(follow, "cal-follow-open", 1)
                    settle(follow.engine, rec, "calibration follow")
                    for b in CAL_BATCHES:
                        follow.engine._cand_hint.clear()
                        check_dispatch(f"int8 B={b} (new KB)", first_dispatch(
                            follow.engine, follow.engine.corpus, b, names), winners[b] == "v3")
                        retrieve(follow, f"cal-follow-{b}", b)
                finally:
                    follow.close()
            else:
                fresh = RetrievalEngine(precision=precision, device="cuda")
                for b in CAL_BATCHES:
                    check_dispatch(f"{precision} B={b} (new engine)",
                                   first_dispatch(fresh, corpus, b, names), winners[b] == "v3")
            rec["winners"] = winners
            rec["pack_events"] = dict(kb.engine.pack_events)
            log(f"e2e calibration {precision}: winners {winners}; the first engine "
                f"kept its prior; a new {'KB' if precision == 'int8' else 'engine'} "
                f"follows the winners; exact vs scan; open {rec['open_s']:.1f} s "
                f"({rec['pack_events']})")
        finally:
            kb.close(write_sidecar=False)

    def run():
        os.environ["SVS_TPU_AUTOCALIB"] = "1"
        os.environ["SVS_TPU_CALIB_CACHE"] = str(work / "calibration_phase.json")
        calibrate.reset_calibrator()
        try:
            run_precision("int8")
            run_precision("bf16")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            calibrate.reset_calibrator()

    drive_path("calibration", ["_fused3_extract_int8", "_fused2_extract_int8",
                               "_fused3_extract", "_fused2_extract", "_staged_finish"],
               run, out)
    torch.cuda.empty_cache()


#: Traced calls of the trace phase, each with its own trace directory.
TRACE_CALLS = 5
#: The port's kernels by the symbols their kernel events carry.
TRACE_SYMBOLS = ("fused3_mma_kernel", "fused3_f32_kernel", "fused_int8_kernel",
                 "fused_float_kernel", "staged_finish_kernel", "extract_kernel",
                 "pair_keys_kernel")


def trace_phase(store: Path, ref_matrix, work: Path, out: dict) -> None:
    """Trace export: with ``SVS_TPU_PROFILE_DIR`` set, ``TRACE_CALLS``
    int8 B=64, n=100 retrieves on the 1M store (a ``KB`` from its sidecar,
    settled; each first try on v3, the width hint cleared) each write
    ``torch.profiler`` traces under ``<dir>/call<i>/retrieve/``, one per
    attempt of the widen loop.  Every trace file must hold a kernel event
    of the port's kernels, each call's traces one kernel event for each
    launch its wrappers counted (each wrapper launches one kernel), among
    them the staged finish (#2) and a prescore kernel (#1 or #3); the
    call's wall with and without the trace."""
    import torch

    import svs_tpu_torch
    from svs_tpu_torch.ops import pallas_extract as P

    qvec = {}

    async def embed(texts):
        return [qvec[t].tolist() for t in texts]

    rng = np.random.default_rng(SEED + 13)
    res = out["paths_detail_trace"] = {}
    prof_dir = work / "profile"

    def call(kb, label):
        v = unit_queries(rng, 64)
        texts = [f"{label}-{i}" for i in range(64)]
        qvec.update(zip(texts, v))
        torch.cuda.synchronize()
        t = time.perf_counter()
        hits = kb.retrieve_batch(texts, 100)
        torch.cuda.synchronize()
        check_results(*hits_to_arrays(hits), v, ref_matrix, 100)
        return (time.perf_counter() - t) * 1e3

    def read_traces(root: Path) -> list:
        """Per trace file under ``root/retrieve``: the kernel events of the
        port's kernels and the count of all kernel events."""
        files = sorted((root / "retrieve").glob("*.pt.trace.json"))
        if not files or any(f.parent != root / "retrieve" for f in files):
            raise AssertionError(f"trace: no trace under {root / 'retrieve'}: {files}")
        per_file = []
        for f in files:  # one trace per attempt of the widen loop
            kernels = 0
            ours: dict = {}
            for e in json.loads(f.read_text())["traceEvents"]:
                if e.get("cat") != "kernel":
                    continue
                kernels += 1
                for sym in TRACE_SYMBOLS:
                    if sym in str(e.get("name", "")):
                        ours[sym] = ours.get(sym, 0) + 1
            per_file.append({"file": f.name, "bytes": f.stat().st_size,
                             "port_kernel_events": ours, "kernel_events": kernels})
        return per_file

    def run():
        kb = svs_tpu_torch.KB(store, embed, device="cuda")
        traces, launched = [], []
        try:
            call(kb, "trace-open")
            settle(kb.engine, res, "trace")
            res["untraced_ms"] = call(kb, "trace-off")
            res["traced_ms"] = []
            for i in range(TRACE_CALLS):
                kb.engine._cand_hint.clear()  # each traced call's first try on v3 (C=400)
                before = P.launch_counts()
                os.environ["SVS_TPU_PROFILE_DIR"] = str(prof_dir / f"call{i}")
                try:
                    res["traced_ms"].append(call(kb, f"trace-on-{i}"))
                finally:
                    del os.environ["SVS_TPU_PROFILE_DIR"]
                launched.append({k: v - before[k] for k, v in P.launch_counts().items()
                                 if v > before[k]})
                traces.append(read_traces(prof_dir / f"call{i}"))
        finally:
            kb.close()
        res["calls"] = [{"launched": n, "files": t} for n, t in zip(launched, traces)]
        res["trace_files"] = sum(len(t) for t in traces)
        res["trace_bytes"] = sum(f["bytes"] for t in traces for f in t)
        res["launches"] = sum(sum(n.values()) for n in launched)
        res["kernel_events_kept"] = sum(sum(f["port_kernel_events"].values())
                                        for t in traces for f in t)
        log(f"e2e trace: {TRACE_CALLS} traced calls, {res['trace_files']} file(s) "
            f"({res['trace_bytes']} bytes); launches counted per call {launched}; the port's "
            f"kernel events per file {[[f['port_kernel_events'] for f in t] for t in traces]} "
            f"({res['kernel_events_kept']} for {res['launches']} launches); all kernel events per "
            f"file {[[f['kernel_events'] for f in t] for t in traces]}; the call "
            f"{res['untraced_ms']:.2f} ms untraced, {[round(x, 2) for x in res['traced_ms']]} ms traced")
        for i, (n, t) in enumerate(zip(launched, traces)):
            held: dict = {}
            for f in t:
                if not f["port_kernel_events"]:
                    raise AssertionError(f"trace: call {i}: {f['file']} holds no kernel event of "
                                         f"the port's kernels: {t}")
                for k, v in f["port_kernel_events"].items():
                    held[k] = held.get(k, 0) + v
            if sum(held.values()) != sum(n.values()):
                raise AssertionError(f"trace: call {i}: its traces hold kernel events {held}, "
                                     f"its wrappers launched {n}")
            if not ("staged_finish_kernel" in held
                    and ("fused3_mma_kernel" in held or "fused_int8_kernel" in held)):
                raise AssertionError(f"trace: call {i}: #2 and #1/#3 not both in its traces: {held}")

    drive_path("trace", ["_staged_finish"], run, out)
    torch.cuda.empty_cache()


#: The providers phase: docs per store (20,000, then 10,000, then 4,000 as
#: the smoke's time filled: a store under 16,384 rows launches no kernel at
#: any of these), and the width of the stub's vectors
#: (``text-embedding-3-small``'s).
PROVIDER_DOCS = 4_000
PROVIDER_DIM = 1536


def seeded_unit(text: str, dim: int) -> np.ndarray:
    """The stub endpoints' vector of ``text``: unit, seeded by its CRC,
    rounded to the 6 decimals the stub sends."""
    v = np.random.default_rng(zlib.crc32(text.encode())).standard_normal(dim)
    return np.round(v / np.linalg.norm(v), 6)


class _EmbeddingStub:
    """A standard-library OpenAI (``/v1/embeddings``) and Ollama
    (``/api/embed``) endpoint on 127.0.0.1 answering ``seeded_unit``
    vectors (written with ``%.6f``: Python's float repr would spend most of
    the phase in ``json.dumps``; each text's row formatted once, for both
    providers); the first request of each path is answered 503."""

    def __init__(self, dim: int) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.requests = 0
        self.unavailable = 0
        failed_paths: set = set()
        stub = self
        row = "[" + ",".join(["%.6f"] * dim) + "]"
        rows: dict = {}

        def row_of(text: str) -> str:
            if text not in rows:
                rows[text] = row % tuple(seeded_unit(text, dim))
            return rows[text]

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                stub.requests += 1
                if self.path not in failed_paths:
                    failed_paths.add(self.path)
                    stub.unavailable += 1
                    status, text = 503, json.dumps({"error": "warming up"})
                else:
                    vecs = [row_of(t) for t in json.loads(raw)["input"]]
                    status = 200
                    text = ('{"embeddings": [%s]}' % ",".join(vecs)
                            if self.path.endswith("/api/embed") else
                            '{"data": [%s]}' % ",".join(
                                '{"index": %d, "embedding": %s}' % iv for iv in enumerate(vecs)))
                data = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


def _rows_of(results, row_of_id: dict) -> tuple:
    rows = np.asarray([[row_of_id[h["doc"]["id"]] for h in hits] for hits in results])
    scores = np.asarray([[h["score"] for h in hits] for hits in results], dtype=np.float64)
    return rows, scores


def providers_phase(work: Path, out: dict) -> None:
    """The HTTP providers through the standard-library transport: for each
    of openai and ollama, a ``PROVIDER_DOCS``-doc store written through its
    factory against a loopback stub of the endpoint (the first request
    answered 503 and retried), closed, reopened with ``KB(path,
    device='cuda')`` and no function (the provider rebuilt from the stored
    params; the ollama ``base_url`` from ``OLLAMA_BASE_URL``, since a
    stored one is dropped), and queried at B = 1, 8 and 64 (n = 10):
    every hit exact against a brute-force scan of the stub's vectors."""
    import torch

    import svs_tpu_torch

    res = out["paths_detail_providers"] = {}
    stub = _EmbeddingStub(PROVIDER_DIM)
    env_keys = ("OPENAI_BASE_URL", "OPENAI_API_KEY", "OLLAMA_BASE_URL")
    saved = {k: os.environ.get(k) for k in env_keys}
    texts = [f"provider document {i}" for i in range(PROVIDER_DOCS)]
    ref = torch.from_numpy(np.stack([seeded_unit(t, PROVIDER_DIM) for t in texts])
                           .astype(np.float32)).cuda()

    def one(provider):
        rec = res[provider] = {}
        path = work / f"{provider}.sqlite"
        if provider == "openai":
            fn = svs_tpu_torch.make_openai_embeddings_func(dimensions=PROVIDER_DIM)
        else:
            fn = svs_tpu_torch.make_ollama_embeddings_func("nomic-embed-text", base_url=stub.url)
        before = (stub.requests, stub.unavailable)
        t = time.perf_counter()
        kb = svs_tpu_torch.KB(path, fn, force_fresh_db=True, device="cuda")
        try:
            with kb.bulk_add_docs() as add:
                ids = [add(x) for x in texts]
        finally:
            kb.close()
        rec["write_s"] = time.perf_counter() - t
        rec["requests"] = stub.requests - before[0]
        rec["retried_503"] = stub.unavailable - before[1]
        if rec["retried_503"] != 1:
            raise AssertionError(f"providers {provider}: {rec['retried_503']} 503s, want 1")
        row_of_id = {d: i for i, d in enumerate(ids)}
        kb = svs_tpu_torch.KB(path, device="cuda")  # no function: rebuilt
        try:
            params = kb.embedding_func.__embedding_func_params__
            if params["provider"] != provider:
                raise AssertionError(f"providers: reopened with {params}")
            lat = {}
            for b in (1, 8, 64):
                qs = [f"provider query {provider} {b} {i}" for i in range(b)]
                qs[0] = texts[(b * 997) % PROVIDER_DOCS]  # a doc's own text
                t = time.perf_counter()
                hits = kb.retrieve_batch(qs, 10)
                lat[b] = (time.perf_counter() - t) * 1e3
                qv = np.stack([seeded_unit(q, PROVIDER_DIM) for q in qs]).astype(np.float32)
                rows, scores = _rows_of(hits, row_of_id)
                check_results(rows, scores, qv, ref, 10)
                if rows[0][0] != (b * 997) % PROVIDER_DOCS:
                    raise AssertionError(f"providers {provider}: a doc's text is not its own top hit")
                settle(kb.engine, rec, f"providers {provider}")
            rec["query_ms"] = lat
        finally:
            kb.close()
        log(f"e2e providers {provider}: {PROVIDER_DOCS} docs x {PROVIDER_DIM} written in "
            f"{rec['write_s']:.1f} s over {rec['requests']} requests (one 503, retried); "
            f"reopened with no function; B=1/8/64 n=10 "
            f"{({b: round(v, 1) for b, v in lat.items()})} ms; exact vs scan")

    def run():
        os.environ["OPENAI_BASE_URL"] = f"{stub.url}/v1/embeddings"
        os.environ["OPENAI_API_KEY"] = "sk-chip-smoke"
        os.environ["OLLAMA_BASE_URL"] = stub.url
        try:
            one("openai")
            one("ollama")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    try:
        drive_path("providers", [], run, out)
    finally:
        stub.close()
    del ref
    torch.cuda.empty_cache()


#: ``BAAI/bge-small-en-v1.5``'s published ``config.json`` (a BertModel).
BGE_SMALL = {
    "model_type": "bert", "architectures": ["BertModel"], "vocab_size": 30522,
    "hidden_size": 384, "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 1536, "max_position_embeddings": 512,
    "type_vocab_size": 2, "hidden_act": "gelu", "layer_norm_eps": 1e-12,
    "position_embedding_type": "absolute", "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02,
    "pad_token_id": 0,
}
#: 131,072-row pack: 16 blocks, the fewest that the guarded v3 kernel
#: (#1) takes (at 50,000 docs it did not launch); 150,000 until the
#: smoke's time had to make room for ``local_mistral``.
LOCAL_DOCS = 120_000
#: bge-small's depth (12) cut to this, to make room for ``local_mistral``
#: in the smoke's time: the widths, the tokenizer and v3 / v1 at d = 384
#: stay.
LOCAL_LAYERS = 4
LOCAL_MAX_LENGTH = 128
LOCAL_BATCH = 128
#: Texts held against the port's own f32 run on the CPU.
LOCAL_PARITY_TEXTS = 256
#: f32 on the card against f32 on the CPU: the same arithmetic in another
#: order (TF32 off), a few ulps of a unit vector's entries.
LOCAL_F32_ATOL = 1e-5
#: bf16 (autocast, f32 parameters) against f32, unit vectors of 384: 12
#: layers of matmul inputs rounded to 8 mantissa bits.  Set before the
#: first run on the card at about 5x the error of bf16 autocast against
#: f32 on the CPU for this checkpoint.
LOCAL_BF16_ATOL = 1e-2
LOCAL_BF16_MIN_COS = 0.999
#: Gain of the random query / key kernels (see ``write_bge_small``).
LOCAL_QK = 2.0


def bert_uncased_vocab(seed: int) -> list:
    """A synthetic 30,522-entry vocabulary in bert-base-uncased's layout:
    ``[PAD]`` 0, ``[unused0-98]``, ``[UNK]`` 100, ``[CLS]`` 101, ``[SEP]``
    102, ``[MASK]`` 103, ``[unused99-993]``, single characters, ``##``
    characters, then seeded whole words and ``##`` pieces."""
    rng = np.random.default_rng(seed)
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += [f"[unused{i}]" for i in range(99, 994)]
    singles = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    tokens += singles + ["##" + c for c in singles if c.isalnum()]
    sylls = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"] + [
        "th", "ch", "sh", "st", "tr", "er", "an", "in", "on", "en", "ing", "ed"]
    seen = set(tokens)
    while len(tokens) < BGE_SMALL["vocab_size"]:
        word = "".join(rng.choice(sylls, int(rng.integers(1, 5))))
        piece = "##" + word if rng.random() < 0.2 else word
        if piece not in seen:
            seen.add(piece)
            tokens.append(piece)
    return tokens


def write_bge_small(path: Path, seed: int) -> list:
    """A checkpoint at ``BGE_SMALL``'s widths with random weights from
    ``seed``, written as ``flax_model.msgpack`` with the port's MessagePack
    writer, plus ``vocab.txt`` and ``tokenizer_config.json``; returns the
    vocabulary.  Embeddings N(0, 0.02), unit LayerNorms, zero biases, Dense
    kernels N(0, 1/fan_in) with the query and key kernels x ``LOCAL_QK``:
    at ``transformers``' N(0, 0.02) init the CLS vectors of unrelated
    texts are nearly parallel (a degenerate store, where the margin check
    widens to the whole corpus); sharper attention spreads them as a
    trained encoder's are spread."""
    from svs_tpu_torch.embeddings.checkpoint import write_checkpoint

    rng = np.random.default_rng(seed)
    c = {**BGE_SMALL, "num_hidden_layers": LOCAL_LAYERS}
    h, inter = c["hidden_size"], c["intermediate_size"]

    def normal(scale, *shape):
        return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)

    def dense(d_in, d_out, gain=1.0):
        return {"kernel": normal(gain / np.sqrt(d_in), d_in, d_out),
                "bias": np.zeros(d_out, np.float32)}

    def norm():
        return {"scale": np.ones(h, np.float32), "bias": np.zeros(h, np.float32)}

    layers = {str(i): {
        "attention": {"self": {"query": dense(h, h, LOCAL_QK), "key": dense(h, h, LOCAL_QK),
                               "value": dense(h, h)},
                      "output": {"dense": dense(h, h), "LayerNorm": norm()}},
        "intermediate": {"dense": dense(h, inter)},
        "output": {"dense": dense(inter, h), "LayerNorm": norm()},
    } for i in range(c["num_hidden_layers"])}
    params = {
        "embeddings": {
            "word_embeddings": {"embedding": normal(0.02, c["vocab_size"], h)},
            "position_embeddings": {"embedding": normal(0.02, c["max_position_embeddings"], h)},
            "token_type_embeddings": {"embedding": normal(0.02, c["type_vocab_size"], h)},
            "LayerNorm": norm(),
        },
        "encoder": {"layer": layers},
        "pooler": {"dense": dense(h, h)},
    }
    write_checkpoint(path, c, params)
    vocab = bert_uncased_vocab(seed)
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "do_lower_case": True, "tokenizer_class": "BertTokenizer",
        "model_max_length": 512, "strip_accents": None,
    }))
    return vocab


def synthetic_texts(vocab: list, n: int, seed: int) -> list:
    """``n`` distinct texts of 8-200 words: vocabulary words by a Zipf law,
    3% out-of-vocabulary letter strings (split into pieces), 5% capitalised,
    5% followed by punctuation."""
    rng = np.random.default_rng(seed)
    words = np.asarray([t for t in vocab if t.isalpha() and t.islower() and len(t) > 1],
                       dtype=object)
    oov = np.asarray(["".join(rng.choice(list("qxzjkvwy"), int(k)))
                      for k in rng.integers(5, 14, 5000)], dtype=object)
    lens = rng.integers(8, 201, n)
    total = int(lens.sum())
    toks = words[(rng.zipf(1.2, total) - 1) % len(words)]
    pick = rng.random(total)
    toks[pick < 0.03] = oov[rng.integers(0, len(oov), int((pick < 0.03).sum()))]
    caps = (pick >= 0.03) & (pick < 0.08)
    toks[caps] = [str(t).capitalize() for t in toks[caps]]
    punct = (pick >= 0.08) & (pick < 0.13)
    toks[punct] = [str(t) + "," for t in toks[punct]]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    texts = [" ".join(toks[bounds[i]:bounds[i + 1]]) for i in range(n)]
    seen: set = set()
    for i, t in enumerate(texts):  # distinct, so a doc's own text finds it alone
        while texts[i] in seen:
            texts[i] = f"{texts[i]} {oov[i % len(oov)]}"
        seen.add(texts[i])
    return texts


def local_phase(work: Path, out: dict) -> None:
    """The local provider on the card at ``BAAI/bge-small-en-v1.5``'s widths
    (random weights from the seed; CLS pooling, ``max_length`` 128, batch
    128, bf16): the checkpoint written with the port's writer; 120,000 docs
    of 8-200 words (OOV words, texts past 128 tokens) embedded and written
    through ``KB.bulk_add_docs`` (tokenizer and encoder seconds from the
    encoder's own counters; its peak device memory); 256 texts held against
    the port's own f32 run on the CPU (f32 on the card within
    ``LOCAL_F32_ATOL``, the stored bf16 rows within ``LOCAL_BF16_ATOL`` and
    a cosine of at least ``LOCAL_BF16_MIN_COS``); ``retrieve_batch`` at B =
    1, 8 and 64, n = 10 and 100, half the queries docs' own texts (each its
    own top hit), exact against a scan of the stored rows; then a reopen
    with ``KB(path, device='cuda')`` and no function: the same answers."""
    import torch

    import svs_tpu_torch

    res = out["paths_detail_local"] = {}
    ck = work / "bge-small-synthetic"
    t = time.perf_counter()
    vocab = write_bge_small(ck, SEED)
    res["checkpoint_s"] = time.perf_counter() - t
    res["checkpoint_mb"] = (ck / "flax_model.msgpack").stat().st_size / 1e6
    t = time.perf_counter()
    texts = synthetic_texts(vocab, LOCAL_DOCS, SEED + 17)
    res["texts_s"] = time.perf_counter() - t
    log(f"e2e local: checkpoint {res['checkpoint_mb']:.1f} MB in {res['checkpoint_s']:.1f} s; "
        f"{LOCAL_DOCS} texts in {res['texts_s']:.1f} s")
    path = work / "local.sqlite"
    # B=64 first: the width hint is per n and shared by every batch, and a
    # widened C past (19 - 2) x 32 = 544 keeps v3 out of reach
    shapes = ((64, 10), (64, 100), (8, 10), (8, 100), (1, 10), (1, 100))

    def query_texts(b, n):
        rng = np.random.default_rng(SEED + 19 + b * 1000 + n)
        own = rng.choice(LOCAL_DOCS, b // 2 + 1 if b > 1 else 1, replace=False)
        fresh = synthetic_texts(vocab, b - len(own), SEED + 23 + b * 1000 + n)
        return [texts[i] for i in own] + fresh, [int(i) for i in own]

    def run():
        fn = svs_tpu_torch.make_local_embeddings_func(
            str(ck), pooling="cls", max_length=LOCAL_MAX_LENGTH,
            batch_size=LOCAL_BATCH, compute_dtype="bfloat16", device="cuda")
        stored: list = []

        async def capture(batch):
            vecs = await fn(batch)
            stored.extend(vecs)
            return vecs

        capture.__embedding_func_params__ = fn.__embedding_func_params__
        enc = fn.encoder
        # parity: the CPU f32 run of the parity texts (the port's own) in a
        # thread beside the write (torch's CPU kernels release the GIL)
        sample = texts[:LOCAL_PARITY_TEXTS]
        cpu_run: dict = {}

        def cpu_reference():
            try:
                t = time.perf_counter()
                cpu_run["vecs"] = np.asarray(asyncio.run(svs_tpu_torch.make_local_embeddings_func(
                    str(ck), pooling="cls", compute_dtype="float32", device="cpu")(sample)),
                    np.float32)
                cpu_run["s"] = time.perf_counter() - t
            except BaseException as exc:  # re-raised below
                cpu_run["error"] = exc

        torch.set_num_threads(os.cpu_count() or 1)
        cpu_thread = threading.Thread(target=cpu_reference, name="local_cpu", daemon=True)
        cpu_thread.start()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        kb = svs_tpu_torch.KB(path, capture, force_fresh_db=True, device="cuda")
        try:
            with kb.bulk_add_docs() as add:
                ids = [add(x) for x in texts]
        finally:
            kb.close()
        res["write_s"] = time.perf_counter() - t
        res["encoder_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
        res["device_peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        st = dict(enc.stats)
        res["encoder_stats"] = st
        res["tokenizer_texts_per_s"] = st["texts"] / st["tokenize_s"]
        res["encoder_texts_per_s"] = st["texts"] / st["forward_s"]
        res["write_docs_per_s"] = LOCAL_DOCS / res["write_s"]
        log(f"e2e local: {LOCAL_DOCS} docs embedded and written in {res['write_s']:.1f} s "
            f"({res['write_docs_per_s']:.0f} docs/s); tokenizer {st['tokenize_s']:.1f} s "
            f"({res['tokenizer_texts_per_s']:.0f} texts/s), encoder (bf16, host clock to "
            f"the result) {st['forward_s']:.1f} s ({res['encoder_texts_per_s']:.0f} "
            f"texts/s); encoder peak {res['encoder_peak_mb']:.1f} MB above "
            f"{base / 1e6:.1f} MB")
        if len(stored) != LOCAL_DOCS:
            raise AssertionError(f"local: {len(stored)} vectors for {LOCAL_DOCS} docs")
        rows = np.asarray(stored, dtype=np.float32)
        del stored
        row_of_id = {d: i for i, d in enumerate(ids)}
        # parity: the CPU f32 run against f32 on the card and the stored
        # bf16 rows
        t = time.perf_counter()
        cpu_thread.join()
        res["cpu_wait_s"] = time.perf_counter() - t
        if "error" in cpu_run:
            raise cpu_run["error"]
        cpu, res["cpu_f32_s"] = cpu_run["vecs"], cpu_run["s"]
        f32 = np.asarray(asyncio.run(svs_tpu_torch.make_local_embeddings_func(
            str(ck), pooling="cls", compute_dtype="float32", device="cuda")(sample)), np.float32)
        bf = rows[:LOCAL_PARITY_TEXTS]
        res["f32_max_abs_err"] = float(np.abs(f32 - cpu).max())
        res["bf16_max_abs_err"] = float(np.abs(bf - cpu).max())
        res["bf16_min_cos"] = float((bf * cpu).sum(axis=1).min())
        log(f"e2e local: {LOCAL_PARITY_TEXTS} texts vs the CPU f32 run ({res['cpu_f32_s']:.1f} s "
            f"beside the write, {res['cpu_wait_s']:.1f} s waited for after it): "
            f"f32 on the card max |err| {res['f32_max_abs_err']:.3g} (tolerance "
            f"{LOCAL_F32_ATOL}), bf16 {res['bf16_max_abs_err']:.3g} (tolerance "
            f"{LOCAL_BF16_ATOL}), min cosine {res['bf16_min_cos']:.6f} (at least "
            f"{LOCAL_BF16_MIN_COS})")
        if res["f32_max_abs_err"] > LOCAL_F32_ATOL:
            raise AssertionError("local: f32 on the card disagrees with the CPU")
        if res["bf16_max_abs_err"] > LOCAL_BF16_ATOL or res["bf16_min_cos"] < LOCAL_BF16_MIN_COS:
            raise AssertionError("local: bf16 on the card disagrees with the CPU f32 run")
        ref = torch.from_numpy(rows).cuda()
        answers = {}

        def queries(kb, label):
            lat = {}
            for b, n in shapes:
                qs, own = query_texts(b, n)
                qv = np.asarray(asyncio.run(fn(list(qs))), np.float32)  # the LRU: the KB's vectors
                t = time.perf_counter()
                hits = kb.retrieve_batch(qs, n)
                lat[f"B{b}_n{n}"] = (time.perf_counter() - t) * 1e3
                got_rows, scores = _rows_of(hits, row_of_id)
                check_results(got_rows, scores, qv, ref, n)
                for j, doc in enumerate(own):
                    if got_rows[j][0] != doc:
                        raise AssertionError(f"local {label} B={b}: a doc's text is not its top hit")
                answers.setdefault(label, {})[(b, n)] = (got_rows, scores)
                if label == "first" and (b, n) == shapes[0]:
                    settle(kb.engine, res, "local")
            res[f"{label}_query_ms"] = lat
            return lat

        kb = svs_tpu_torch.KB(path, fn, device="cuda")
        try:
            lat = queries(kb, "first")
            res["embed_phase_p50_ms"] = kb.stats().get("embed", {}).get("p50_s", 0.0) * 1e3
        finally:
            kb.close()
        kb = svs_tpu_torch.KB(path, device="cuda")  # no function: rebuilt on the card
        try:
            if kb.embedding_func.encoder.device != kb.engine.device:
                raise AssertionError("local: the rebuilt provider is not on the KB's device")
            queries(kb, "reopened")
        finally:
            kb.close()
        for key, (r1, s1) in answers["first"].items():
            r2, s2 = answers["reopened"][key]
            if not np.array_equal(r1, r2) or np.abs(s1 - s2).max() > SCORE_TOL:
                raise AssertionError(f"local: the reopened KB answers {key} otherwise")
        log(f"e2e local: retrieve {({k: round(v, 1) for k, v in lat.items()})} ms; "
            f"`embed` phase p50 {res['embed_phase_p50_ms']:.2f} ms; exact vs scan, each "
            f"doc's own text its top hit; the reopened KB (no function) answers the same")

    # 16 blocks: the v3 finish is one top_k below GUARD_STAGE_MIN_BLOCKS (no #2)
    drive_path("local", ["_fused3_extract_int8"], run, out)
    torch.cuda.empty_cache()



# -- the local provider past BERT ------------------------------------------------

#: ``BAAI/bge-m3``'s published ``config.json`` (an XLMRobertaModel).
BGE_M3 = {
    "model_type": "xlm-roberta", "architectures": ["XLMRobertaModel"], "vocab_size": 250002,
    "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
    "intermediate_size": 4096, "max_position_embeddings": 8194, "type_vocab_size": 1,
    "hidden_act": "gelu", "layer_norm_eps": 1e-05, "position_embedding_type": "absolute",
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02,
}
#: One published checkpoint of each other family the port runs, at its
#: widths, its depth cut to ``FAMILY_LAYERS`` layers (the checks hold
#: precision, not throughput) but ALBERT's: its one shared layer makes
#: depth cost time, not memory, so it runs its published 12.
FAMILY_CONFIGS = {
    "roberta": ("sentence-transformers/all-distilroberta-v1", {
        "model_type": "roberta", "architectures": ["RobertaModel"], "vocab_size": 50265,
        "hidden_size": 768, "num_hidden_layers": 6, "num_attention_heads": 12,
        "intermediate_size": 3072, "max_position_embeddings": 514, "type_vocab_size": 1,
        "hidden_act": "gelu", "layer_norm_eps": 1e-05, "position_embedding_type": "absolute",
        "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2}),
    "distilbert": ("sentence-transformers/msmarco-distilbert-base-v4", {
        "model_type": "distilbert", "architectures": ["DistilBertModel"], "vocab_size": 30522,
        "dim": 768, "n_layers": 6, "n_heads": 12, "hidden_dim": 3072,
        "max_position_embeddings": 512, "activation": "gelu", "sinusoidal_pos_embds": False,
        "pad_token_id": 0}),
    "electra": ("google/electra-base-discriminator", {
        "model_type": "electra", "architectures": ["ElectraForPreTraining"],
        "vocab_size": 30522, "embedding_size": 768, "hidden_size": 768,
        "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
        "max_position_embeddings": 512, "type_vocab_size": 2, "hidden_act": "gelu",
        "layer_norm_eps": 1e-12, "position_embedding_type": "absolute", "pad_token_id": 0}),
    "albert": ("albert/albert-base-v2", {
        "model_type": "albert", "architectures": ["AlbertForMaskedLM"], "vocab_size": 30000,
        "embedding_size": 128, "hidden_size": 768, "num_hidden_layers": 12,
        "num_attention_heads": 12, "intermediate_size": 3072, "max_position_embeddings": 512,
        "type_vocab_size": 2, "hidden_act": "gelu_new", "layer_norm_eps": 1e-12,
        "num_hidden_groups": 1, "inner_group_num": 1, "position_embedding_type": "absolute",
        "pad_token_id": 0, "bos_token_id": 2, "eos_token_id": 3}),
    "roberta-prelayernorm": ("andreasmadsen/efficient_mlm_m0.40", {
        "model_type": "roberta-prelayernorm", "architectures": ["RobertaPreLayerNormForMaskedLM"],
        "vocab_size": 50265, "hidden_size": 1024, "num_hidden_layers": 24,
        "num_attention_heads": 16, "intermediate_size": 4096, "max_position_embeddings": 514,
        "type_vocab_size": 1, "hidden_act": "gelu", "layer_norm_eps": 1e-05,
        "position_embedding_type": "absolute", "pad_token_id": 1, "bos_token_id": 0,
        "eos_token_id": 2}),
}
#: The families that run their published depth.
FAMILY_FULL_DEPTH = ("albert",)
FAMILY_LAYERS = 2
FAMILY_TEXTS = 64
FAMILY_MAX_LENGTH = 128
#: Three 8,192-row blocks of docs (past 16,384 rows the pack is 32,768:
#: 20,000 docs until the smoke's time had to make room): at two (12,000
#: docs) the candidate counts pass what the keyed and v1 kernels take and
#: the exact torch route answers.
LOCAL_XLMR_DOCS = 17_000
#: bge-m3's depth (24) cut to this, to make room for ``local_mistral`` in
#: the smoke's time: the widths, the tokenizer and the retrieval kernels
#: at d = 1,024 stay.
LOCAL_XLMR_LAYERS = 2
LOCAL_XLMR_MAX_LENGTH = 512
LOCAL_XLMR_BATCH = 64
#: Texts held against the port's own f32 run on the CPU.
LOCAL_XLMR_PARITY_TEXTS = 4
#: bf16 (autocast, f32 parameters) against f32 on unit vectors of 1024
#: after 24 layers (``LOCAL_XLMR_LAYERS`` since the cut) at 512 tokens.  Set before the first run on the card at
#: about 5x the error of bf16 autocast against f32 on the CPU, measured at
#: bge-m3's widths with the depth cut to 2, 4 and 8 layers (0.8-1.2e-3,
#: flat in depth) and extrapolated to 24.
LOCAL_XLMR_BF16_ATOL = 1e-2
LOCAL_XLMR_BF16_MIN_COS = 0.999
#: Words a script in the synthetic corpus's lexicon.
XLMR_LEXICON = 20_000
#: Scripts of the synthetic multilingual vocabulary and corpus.
XLMR_SCRIPTS = {
    "latin": "abcdefghijklmnopqrstuvwxyz" + "àáâäçèéêëìíîïñòóôöùúûüýÿßæœ",
    "cyrillic": "абвгдежзийклмнопрстуфхцчшщъыьэюя",
    "greek": "αβγδεζηθικλμνξοπρστυφχψω",
    "arabic": "".join(chr(c) for c in range(0x0627, 0x064B)),
    "cjk": "".join(chr(0x4E00 + i) for i in range(0, 20902, 7)),
}


def random_encoder_params(config: dict, seed: int, qk: float = LOCAL_QK) -> dict:
    """A Flax base-model tree at ``config``'s widths (any ``model_type``
    the port runs) with random weights from ``seed``, as
    ``write_bge_small`` makes them: embeddings N(0, 0.02), unit
    LayerNorms, zero biases, Dense kernels N(0, 1/fan_in), the query and
    key kernels x ``qk``."""
    rng = np.random.default_rng(seed)

    def normal(scale, *shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return a

    def dense(d_in, d_out, gain=1.0):
        return {"kernel": normal(gain / np.sqrt(d_in), d_in, d_out),
                "bias": np.zeros(d_out, np.float32)}

    def norm(w):
        return {"scale": np.ones(w, np.float32), "bias": np.zeros(w, np.float32)}

    c = config
    if c["model_type"] == "distilbert":
        h, inter = c["dim"], c["hidden_dim"]
        emb = {"word_embeddings": {"embedding": normal(0.02, c["vocab_size"], h)}}
        if not c.get("sinusoidal_pos_embds"):
            emb["position_embeddings"] = {"embedding": normal(0.02, c["max_position_embeddings"], h)}
        emb["LayerNorm"] = norm(h)
        layers = {str(i): {
            "attention": {"q_lin": dense(h, h, qk), "k_lin": dense(h, h, qk),
                          "v_lin": dense(h, h), "out_lin": dense(h, h)},
            "sa_layer_norm": norm(h),
            "ffn": {"lin1": dense(h, inter), "lin2": dense(inter, h)},
            "output_layer_norm": norm(h),
        } for i in range(c["n_layers"])}
        return {"embeddings": emb, "transformer": {"layer": layers}}
    kind = c["model_type"]
    h, inter = c["hidden_size"], c["intermediate_size"]
    e = c.get("embedding_size", h) if kind in ("electra", "albert") else h
    params = {"embeddings": {
        "word_embeddings": {"embedding": normal(0.02, c["vocab_size"], e)},
        "position_embeddings": {"embedding": normal(0.02, c["max_position_embeddings"], e)},
        "token_type_embeddings": {"embedding": normal(0.02, c.get("type_vocab_size", 2), e)},
        "LayerNorm": norm(e),
    }}
    if kind == "albert":  # the layer groups, shared across the depth
        params["encoder"] = {"embedding_hidden_mapping_in": dense(e, h), "albert_layer_groups": {
            str(g): {"albert_layers": {str(i): {
                "attention": {"query": dense(h, h, qk), "key": dense(h, h, qk),
                              "value": dense(h, h), "dense": dense(h, h), "LayerNorm": norm(h)},
                "ffn": dense(h, inter), "ffn_output": dense(inter, h),
                "full_layer_layer_norm": norm(h),
            } for i in range(c.get("inner_group_num", 1))}}
            for g in range(c.get("num_hidden_groups", 1))}}
        params["pooler"] = dense(h, h)
        return params
    if e != h:
        params["embeddings_project"] = dense(e, h)
    pre_ln = kind == "roberta-prelayernorm"

    def out_norm():  # post-LN layers normalise after each residual
        return {} if pre_ln else {"LayerNorm": norm(h)}

    layers = {str(i): {
        "attention": {"self": {"query": dense(h, h, qk), "key": dense(h, h, qk),
                               "value": dense(h, h)},
                      "output": {"dense": dense(h, h), **out_norm()}},
        "intermediate": {"dense": dense(h, inter)},
        "output": {"dense": dense(inter, h), **out_norm()},
    } for i in range(c["num_hidden_layers"])}
    if pre_ln:
        for layer in layers.values():
            layer["attention"]["LayerNorm"] = norm(h)
            layer["intermediate"]["LayerNorm"] = norm(h)
        params["LayerNorm"] = norm(h)
    params["encoder"] = {"layer": layers}
    if kind == "big_bird":
        params["pooler"] = dense(h, h)
    elif kind != "electra":
        params["pooler"] = {"dense": dense(h, h)}
    return params


def write_random_encoder(path: Path, config: dict, seed: int) -> None:
    """``config.json`` and ``flax_model.msgpack`` of
    :func:`random_encoder_params`, with the port's MessagePack writer."""
    from svs_tpu_torch.embeddings.checkpoint import write_checkpoint

    write_checkpoint(path, config, random_encoder_params(config, seed))


def write_xlmr_tokenizer(path: Path, seed: int) -> dict:
    """A synthetic 250,002-piece Unigram ``tokenizer.json`` in XLM-R's
    layout (``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, ``<unk>`` 3, ``<mask>``
    250,001 stripping the space to its left; Metaspace, ``<s> $A </s>``),
    pieces from ``XLMR_SCRIPTS`` (every character alone and after ``▁``,
    then seeded 2-7 character pieces, 1-3 for CJK, half after ``▁``), plus
    ``tokenizer_config.json``.  Its normalizer is NFKC then
    ``Replace(" {2,}", " ")``, not XLM-R's ``Precompiled`` charsmap (a
    SentencePiece artefact the smoke cannot build): the port's
    ``Precompiled`` reader is held against ``tokenizers`` in the CPU
    tests.  Returns each script's multi-character pieces (without ``▁``)."""
    rng = np.random.default_rng(seed)
    size = BGE_M3["vocab_size"]
    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    singles = []
    for alphabet in XLMR_SCRIPTS.values():
        for ch in alphabet:
            singles += [ch, "▁" + ch]
    singles += ["▁", ",", ".", "▁,", "▁."] + [str(d) for d in range(10)]
    seen = set(specials) | set(singles) | {"<mask>"}
    pieces: list = []
    by_script: dict = {name: [] for name in XLMR_SCRIPTS}
    names = list(XLMR_SCRIPTS)
    want = size - len(specials) - len(singles) - 1
    while len(pieces) < want:
        name = names[len(pieces) % len(names)]
        alphabet = XLMR_SCRIPTS[name]
        lo, hi = (1, 4) if name == "cjk" else (2, 8)
        k = 4096
        lens = rng.integers(lo, hi, k)
        idx = rng.integers(0, len(alphabet), (k, hi))
        marks = rng.random(k) < 0.5
        for j in range(k):
            body = "".join(alphabet[i] for i in idx[j, : lens[j]])
            piece = ("▁" + body) if marks[j] else body
            if piece in seen or len(body) < 2 and name != "cjk":
                continue
            seen.add(piece)
            pieces.append(piece)
            by_script[name].append(body)
            if len(pieces) == want:
                break
    vocab = [[t, 0.0] for t in specials]
    vocab += [[p, float(s)] for p, s in zip(singles, rng.uniform(-16.0, -12.0, len(singles)))]
    vocab += [[p, float(s)] for p, s in zip(pieces, rng.uniform(-12.0, -6.0, len(pieces)))]
    vocab.append(["<mask>", 0.0])
    assert len(vocab) == size, len(vocab)

    def added(i, content, lstrip=False):
        return {"id": i, "content": content, "single_word": False, "lstrip": lstrip,
                "rstrip": False, "normalized": False, "special": True}

    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [added(i, t) for i, t in enumerate(specials)] + [added(size - 1, "<mask>", True)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFKC"}, {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                          "split": True},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "pair": [], "special_tokens": {
                               "<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]},
                               "</s>": {"id": "</s>", "ids": [2], "tokens": ["</s>"]}}},
        "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                    "split": True},
        "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": False},
    }
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "XLMRobertaTokenizer", "model_max_length": 8192,
        "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>", "sep_token": "</s>",
        "cls_token": "<s>", "pad_token": "<pad>", "mask_token": "<mask>",
    }))
    return by_script


def multilingual_texts(by_script: dict, n: int, seed: int) -> list:
    """``n`` distinct texts of 8-200 words: each text in one script (a
    tenth of its words from another), its words drawn by a Zipf law from
    a lexicon of ``XLMR_LEXICON`` words a script (a word: 1-3 of the
    script's pieces joined), 3% with a full-width digit (NFKC folds it),
    5% followed by a comma; the longest pass 512 tokens."""
    rng = np.random.default_rng(seed)
    names = list(by_script)
    lexicons = {}
    for name in names:
        pool = np.asarray(by_script[name], dtype=object)
        parts = rng.integers(0, len(pool), (XLMR_LEXICON, 3))
        k = rng.integers(1, 4, XLMR_LEXICON)
        lexicons[name] = np.asarray(["".join(pool[parts[i, : k[i]]]) for i in range(XLMR_LEXICON)],
                                    dtype=object)
    texts = []
    for i in range(n):
        home = names[int(rng.integers(0, len(names)))]
        k = int(rng.integers(8, 201))
        away = rng.random(k) < 0.1
        scripts = [names[int(j)] for j in rng.integers(0, len(names), k)]
        ranks = (rng.zipf(1.2, k) - 1) % XLMR_LEXICON
        r = rng.random(k)
        words = []
        for j in range(k):
            word = lexicons[scripts[j] if away[j] else home][ranks[j]]
            if r[j] < 0.03:
                word += chr(0xFF10 + int(r[j] * 333) % 10)
            elif r[j] < 0.08:
                word += ","
            words.append(word)
        texts.append(" ".join(words))
    seen: set = set()
    for i, t in enumerate(texts):
        while texts[i] in seen:
            texts[i] = f"{texts[i]} {lexicons[names[0]][i % XLMR_LEXICON]}"
        seen.add(texts[i])
    return texts


def write_provider_store(path: Path, fn, texts: list, res: dict, label: str) -> tuple:
    """Embed ``texts`` with the local provider ``fn`` (on the card) through
    ``KB.bulk_add_docs`` into a new store at ``path``; into ``res`` the
    encoder's load seconds, the write's seconds, the peak device memory and
    the encoder's counters as texts/s.  Returns the stored rows (f32, as
    the provider returned them), the docs' ids and the device memory
    allocated before the load."""
    import torch

    import svs_tpu_torch

    stored: list = []

    async def capture(batch):
        vecs = await fn(batch)
        stored.extend(vecs)
        return vecs

    capture.__embedding_func_params__ = fn.__embedding_func_params__
    enc = fn.encoder
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    enc._load()
    res["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    kb = svs_tpu_torch.KB(path, capture, force_fresh_db=True, device="cuda")
    try:
        with kb.bulk_add_docs() as add:
            ids = [add(x) for x in texts]
    finally:
        kb.close()
    res["write_s"] = time.perf_counter() - t
    res["encoder_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
    res["device_peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    st = dict(enc.stats)
    res["encoder_stats"] = st
    res["tokenizer_texts_per_s"] = st["texts"] / st["tokenize_s"]
    res["encoder_texts_per_s"] = st["texts"] / st["forward_s"]
    res["write_docs_per_s"] = len(texts) / res["write_s"]
    if len(stored) != len(texts):
        raise AssertionError(f"{label}: {len(stored)} vectors for {len(texts)} docs")
    return np.asarray(stored, dtype=np.float32), ids, base


def query_provider_store(path: Path, fn, rows, ids: list, shapes, query_texts, res: dict,
                         label: str, reopen: bool = True, after=None) -> dict:
    """``retrieve_batch`` at each ``(B, n)`` of ``shapes`` on the store that
    :func:`write_provider_store` wrote, first with ``fn``, then (with
    ``reopen``) on a ``KB`` reopened with no function (the provider rebuilt
    on the card from the stored params): ``query_texts(B, n)`` gives the
    texts and the rows whose own text is among them (each its own top
    hit); every answer exact against a scan of ``rows``, the reopened KB's
    the same as the first; ``after(kb)`` runs on the first ``KB`` before it
    closes.  Returns the first KB's latencies (ms)."""
    import torch

    import svs_tpu_torch

    ref = torch.from_numpy(rows).cuda()
    row_of_id = {d: i for i, d in enumerate(ids)}
    answers: dict = {}

    def queries(kb, qfn, which):
        lat = {}
        for b, n in shapes:
            qs, own = query_texts(b, n)
            qv = np.asarray(asyncio.run(qfn(list(qs))), np.float32)  # the LRU: the KB's vectors
            t = time.perf_counter()
            hits = kb.retrieve_batch(qs, n)
            lat[f"B{b}_n{n}"] = (time.perf_counter() - t) * 1e3
            got_rows, scores = _rows_of(hits, row_of_id)
            check_results(got_rows, scores, qv, ref, n)
            for j, doc in enumerate(own):
                if got_rows[j][0] != doc:
                    raise AssertionError(f"{label} {which} B={b}: a doc's text is not its top hit")
            answers.setdefault(which, {})[(b, n)] = (got_rows, scores)
            if which == "first" and (b, n) == shapes[0]:
                settle(kb.engine, res, label)
        res[f"{which}_query_ms"] = lat
        return lat

    kb = svs_tpu_torch.KB(path, fn, device="cuda")
    try:
        lat = queries(kb, fn, "first")
        if after is not None:
            after(kb)
    finally:
        kb.close()
    if not reopen:
        log(f"e2e {label}: retrieve {({k: round(v, 1) for k, v in lat.items()})} ms; exact vs "
            f"scan, each doc's own text its top hit")
        return lat
    kb = svs_tpu_torch.KB(path, device="cuda")  # no function: rebuilt on the card
    try:
        if kb.embedding_func.encoder.device != kb.engine.device:
            raise AssertionError(f"{label}: the rebuilt provider is not on the KB's device")
        queries(kb, kb.embedding_func, "reopened")
    finally:
        kb.close()
    for key, (r1, s1) in answers["first"].items():
        r2, s2 = answers["reopened"][key]
        if not np.array_equal(r1, r2) or np.abs(s1 - s2).max() > SCORE_TOL:
            raise AssertionError(f"{label}: the reopened KB answers {key} otherwise")
    log(f"e2e {label}: retrieve {({k: round(v, 1) for k, v in lat.items()})} ms; exact vs "
        f"scan, each doc's own text its top hit; the reopened KB (no function) answers the same")
    return lat


def local_xlmr_phase(work: Path, out: dict) -> None:
    """The local provider on the card at ``BAAI/bge-m3``'s widths (an
    XLM-RoBERTa, random weights from the seed; a synthetic 250,002-piece
    Unigram ``tokenizer.json``; CLS pooling, ``max_length`` 512, batch 64,
    bf16): ``LOCAL_XLMR_DOCS`` multilingual docs of 8-200 words (the
    longest past 512 tokens) embedded and written through
    ``KB.bulk_add_docs``; ``LOCAL_XLMR_PARITY_TEXTS`` texts held against
    the port's own f32 run on the CPU (f32 on the card within
    ``LOCAL_F32_ATOL``, the stored bf16 rows within ``LOCAL_XLMR_BF16_ATOL``
    and a cosine of at least ``LOCAL_XLMR_BF16_MIN_COS``);
    ``retrieve_batch`` at B = 1, 8 and 64, n = 10 and 100, half the
    queries docs' own texts (each its own top hit), exact against a scan
    of the stored rows; then a reopen with ``KB(path, device='cuda')`` and
    no function: the same answers."""
    import torch

    import svs_tpu_torch

    res = out["paths_detail_local_xlmr"] = {}
    ck = work / "bge-m3-synthetic"
    t = time.perf_counter()
    write_random_encoder(ck, {**BGE_M3, "num_hidden_layers": LOCAL_XLMR_LAYERS}, SEED + 29)
    res["checkpoint_s"] = time.perf_counter() - t
    res["checkpoint_gb"] = (ck / "flax_model.msgpack").stat().st_size / 1e9
    t = time.perf_counter()
    by_script = write_xlmr_tokenizer(ck, SEED + 31)
    res["tokenizer_write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    texts = multilingual_texts(by_script, LOCAL_XLMR_DOCS, SEED + 37)
    res["texts_s"] = time.perf_counter() - t
    log(f"e2e local_xlmr: checkpoint {res['checkpoint_gb']:.2f} GB in {res['checkpoint_s']:.1f} s; "
        f"tokenizer.json in {res['tokenizer_write_s']:.1f} s; {LOCAL_XLMR_DOCS} texts in "
        f"{res['texts_s']:.1f} s")
    path = work / "local_xlmr.sqlite"
    shapes = ((64, 10), (64, 100), (8, 10), (8, 100), (1, 10), (1, 100))

    def query_texts(b, n):
        rng = np.random.default_rng(SEED + 41 + b * 1000 + n)
        own = rng.choice(LOCAL_XLMR_DOCS, b // 2 + 1 if b > 1 else 1, replace=False)
        fresh = multilingual_texts(by_script, b - len(own), SEED + 43 + b * 1000 + n)
        return [texts[i] for i in own] + fresh, [int(i) for i in own]

    def provider(dtype, device):
        return svs_tpu_torch.make_local_embeddings_func(
            str(ck), pooling="cls", max_length=LOCAL_XLMR_MAX_LENGTH,
            batch_size=LOCAL_XLMR_BATCH, compute_dtype=dtype, device=device)

    def run():
        # the CPU f32 reference of the parity texts runs in a thread while
        # the card embeds the store (torch's CPU kernels release the GIL)
        sample = texts[:LOCAL_XLMR_PARITY_TEXTS]
        cpu_run: dict = {}

        def cpu_reference():
            try:
                t = time.perf_counter()
                cpu_run["vecs"] = np.asarray(asyncio.run(provider("float32", "cpu")(sample)),
                                             np.float32)
                cpu_run["s"] = time.perf_counter() - t
            except BaseException as exc:  # re-raised by the phase below
                cpu_run["error"] = exc

        torch.set_num_threads(os.cpu_count() or 1)
        cpu_thread = threading.Thread(target=cpu_reference, name="local_xlmr_cpu", daemon=True)
        cpu_thread.start()
        fn = provider("bfloat16", "cuda")
        rows, ids, base = write_provider_store(path, fn, texts, res, "local_xlmr")
        st = res["encoder_stats"]
        tok, _ = fn.encoder._load()
        lens = [len(tok.token_ids(x)) + 2 for x in texts[:2000]]
        res["tokens_p50_p99_max"] = [float(np.percentile(lens, 50)), float(np.percentile(lens, 99)),
                                     max(lens)]
        res["past_max_length"] = float(np.mean(np.asarray(lens) > LOCAL_XLMR_MAX_LENGTH))
        log(f"e2e local_xlmr: load {res['load_s']:.1f} s; {LOCAL_XLMR_DOCS} docs embedded and "
            f"written in {res['write_s']:.1f} s ({res['write_docs_per_s']:.0f} docs/s); tokenizer "
            f"{st['tokenize_s']:.1f} s ({res['tokenizer_texts_per_s']:.0f} texts/s), encoder (bf16, "
            f"host clock to the result) {st['forward_s']:.1f} s ({res['encoder_texts_per_s']:.0f} "
            f"texts/s); tokens p50/p99/max {res['tokens_p50_p99_max']}, "
            f"{100 * res['past_max_length']:.1f}% past {LOCAL_XLMR_MAX_LENGTH}; encoder peak "
            f"{res['encoder_peak_mb']:.1f} MB above {base / 1e6:.1f} MB")
        if res["past_max_length"] <= 0:
            raise AssertionError("local_xlmr: no text passes max_length (the truncation is not driven)")
        t = time.perf_counter()
        cpu_thread.join()
        res["cpu_wait_s"] = time.perf_counter() - t
        if "error" in cpu_run:
            raise cpu_run["error"]
        cpu, res["cpu_f32_s"] = cpu_run["vecs"], cpu_run["s"]
        f32 = np.asarray(asyncio.run(provider("float32", "cuda")(sample)), np.float32)
        bf = rows[:LOCAL_XLMR_PARITY_TEXTS]
        res["f32_max_abs_err"] = float(np.abs(f32 - cpu).max())
        res["bf16_max_abs_err"] = float(np.abs(bf - cpu).max())
        res["bf16_min_cos"] = float((bf * cpu).sum(axis=1).min())
        log(f"e2e local_xlmr: {LOCAL_XLMR_PARITY_TEXTS} texts vs the CPU f32 run "
            f"({res['cpu_f32_s']:.1f} s beside the write, {res['cpu_wait_s']:.1f} s waited for "
            f"after it): f32 on the card max |err| {res['f32_max_abs_err']:.3g} "
            f"(tolerance {LOCAL_F32_ATOL}), bf16 {res['bf16_max_abs_err']:.3g} (tolerance "
            f"{LOCAL_XLMR_BF16_ATOL}), min cosine {res['bf16_min_cos']:.6f} (at least "
            f"{LOCAL_XLMR_BF16_MIN_COS})")
        if res["f32_max_abs_err"] > LOCAL_F32_ATOL:
            raise AssertionError("local_xlmr: f32 on the card disagrees with the CPU")
        if (res["bf16_max_abs_err"] > LOCAL_XLMR_BF16_ATOL
                or res["bf16_min_cos"] < LOCAL_XLMR_BF16_MIN_COS):
            raise AssertionError("local_xlmr: bf16 on the card disagrees with the CPU f32 run")
        query_provider_store(path, fn, rows, ids, shapes, query_texts, res, "local_xlmr")

    # the 3-block store is below v3's 16: the keyed v2 prescore (#3) and
    # the staged finish (#2), and v1 (#4) once the margin widens past v2
    drive_path("local_xlmr", ["_fused2_extract_int8", "_fused_extract_int8", "_staged_finish"],
               run, out)
    torch.cuda.empty_cache()


def spm_tokenizer_json(path: Path, vocab: list, unk_id: int, specials: dict, normalizer: dict,
                       tokenizer_config: dict) -> None:
    """Write a SentencePiece-style Unigram ``tokenizer.json`` (what
    ``transformers``' ``SpmConverter`` writes: Metaspace, ``[CLS] $A
    [SEP]``, the special pieces as added tokens, the mask stripping the
    space to its left) and ``tokenizer_config.json``.  ``vocab`` is the
    ``[piece, score]`` list, ``specials`` maps each special piece to its
    id."""
    def added(content):
        return {"id": specials[content], "content": content, "single_word": False,
                "lstrip": content == "[MASK]", "rstrip": False, "normalized": False,
                "special": True}

    def special(name):
        return {"SpecialToken": {"id": name, "type_id": 0}}

    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [added(t) for t in sorted(specials, key=specials.get)],
        "normalizer": normalizer,
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                          "split": True},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [special("[CLS]"), {"Sequence": {"id": "A", "type_id": 0}},
                                      special("[SEP]")],
                           "pair": [], "special_tokens": {
                               t: {"id": t, "ids": [specials[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                    "split": True},
        "model": {"type": "Unigram", "unk_id": unk_id, "vocab": vocab, "byte_fallback": False},
    }
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps(tokenizer_config))


def write_albert_tokenizer(path: Path, words: list, size: int, seed: int) -> None:
    """A SentencePiece Unigram ``tokenizer.json`` in ALBERT's layout
    (``<pad>`` 0, ``<unk>`` 1, ``[CLS]`` 2, ``[SEP]`` 3, ``[MASK]`` 4, as
    ``albert-base-v2``'s first pieces; ``AlbertConverter``'s normalizer:
    the two quote ``Replace``s, NFKD, StripAccents, Lowercase,
    ``Replace(" {2,}", " ")``, with no ``Precompiled`` charsmap, which the
    smoke cannot build) over the pieces of ``words`` (a WordPiece
    vocabulary: ``▁word``, and ``##piece`` as ``piece``), ``size`` ids."""
    rng = np.random.default_rng(seed)
    names = ["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"]
    pieces = []
    for w in words:
        if w.startswith("[") and w.endswith("]"):
            continue
        pieces.append(w[2:] if w.startswith("##") else "▁" + w)
    pieces = [p for p in dict.fromkeys(pieces + ["▁"]) if p and p not in names][: size - len(names)]
    vocab = [[t, 0.0] for t in names] + [[p, float(x)] for p, x in
                                          zip(pieces, rng.uniform(-14.0, -6.0, len(pieces)))]
    norm = {"type": "Sequence", "normalizers": [
        {"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
        {"type": "Replace", "pattern": {"String": "''"}, "content": '"'},
        {"type": "NFKD"}, {"type": "StripAccents"}, {"type": "Lowercase"},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
    spm_tokenizer_json(path, vocab, 1, {t: i for i, t in enumerate(names)}, norm, {
        "tokenizer_class": "AlbertTokenizer", "do_lower_case": True, "keep_accents": False,
        "remove_space": True, "bos_token": "[CLS]", "eos_token": "[SEP]", "unk_token": "<unk>",
        "sep_token": "[SEP]", "pad_token": "<pad>", "cls_token": "[CLS]", "mask_token": "[MASK]"})


# -- a long-document store: BigBird ------------------------------------------------

#: ``google/bigbird-roberta-base``'s published ``config.json`` (a
#: BigBirdForPreTraining): block-sparse attention, blocks of 64 tokens.
BIGBIRD_ROBERTA = {
    "model_type": "big_bird", "architectures": ["BigBirdForPreTraining"], "vocab_size": 50358,
    "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 3072, "max_position_embeddings": 4096, "type_vocab_size": 2,
    "hidden_act": "gelu_new", "layer_norm_eps": 1e-12, "attention_type": "block_sparse",
    "block_size": 64, "num_random_blocks": 3, "use_bias": True, "rescale_embeddings": False,
    "position_embedding_type": "absolute", "pad_token_id": 0, "bos_token_id": 1,
    "eos_token_id": 2, "sep_token_id": 66, "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02,
}
#: Three 8,192-row blocks of docs, as ``local_xlmr``'s store (20,000 until
#: the smoke's time had to make room): retrieval through the keyed v2
#: kernel (#3), v1 (#4) after a widen and the staged finish (#2).
LOCAL_BIGBIRD_DOCS = 17_000
#: bigbird-roberta-base's depth (12) cut to this, to make room for
#: ``local_mistral`` in the smoke's time: the widths, block-sparse
#: attention at 1,024 tokens and the retrieval kernels at d = 768 stay.
LOCAL_BIGBIRD_LAYERS = 2
#: 16 blocks of 64 tokens: the paper's plan (``L`` in 1,024 / 3,072 / 4,096).
LOCAL_BIGBIRD_MAX_LENGTH = 1024
#: The provider's batch; a reopened store's provider (``batch_size`` is
#: not persisted) runs the default 128, so B <= 64 queries take the same
#: power-of-two bucket, and the same bits, in both.
LOCAL_BIGBIRD_BATCH = 64
#: Words a document: 8 + 992 u^3 for u uniform on [0, 1) (mean 256).
LOCAL_BIGBIRD_WORDS = (8, 1000)
#: Texts held against f32 on the CPU; the 2-layer model's lengths (the
#: planned branch at 512, the paper's length at 4,096).
LOCAL_BIGBIRD_PARITY_TEXTS = 4
LOCAL_BIGBIRD_CPU_LAYERS = 2
LOCAL_BIGBIRD_PARITY_LENGTHS = (512, 4096)
#: bf16 (autocast) against f32 on the CPU, full depth at 1,024 tokens,
#: mean pooling: set before the first run on the card at about 5x the
#: error measured on the CPU at these widths (bf16 autocast against f32).
LOCAL_BIGBIRD_BF16_ATOL = 1e-2
LOCAL_BIGBIRD_BF16_MIN_COS = 0.999


def write_bigbird_tokenizer(path: Path, seed: int) -> list:
    """A synthetic 50,358-piece Unigram ``tokenizer.json`` in BigBird's
    layout (``SpmConverter``'s: NFKC in place of the ``Precompiled``
    charsmap, a right ``Strip``, ``Replace(" {2,}", "▁")``; Metaspace;
    ``[CLS] $A [SEP]``), the specials at the published config's ids
    (``<pad>`` 0, ``<s>`` 1, ``</s>`` 2, ``[SEP]`` 66) with ``[CLS]`` 65,
    ``[MASK]`` 67 and ``<unk>`` 100 beside them; the pieces every Latin
    letter alone and after ``▁``, then seeded 2-7 letter pieces, half after
    ``▁``.  Returns the multi-letter pieces (without ``▁``)."""
    rng = np.random.default_rng(seed)
    size = BIGBIRD_ROBERTA["vocab_size"]
    specials = {"<pad>": 0, "<s>": 1, "</s>": 2, "[CLS]": 65, "[SEP]": 66, "[MASK]": 67,
                "<unk>": 100}
    letters = XLMR_SCRIPTS["latin"]
    singles = [x for ch in letters for x in (ch, "▁" + ch)]
    singles += ["▁", ",", ".", "▁,", "▁."] + [str(d) for d in range(10)]
    seen = set(specials) | set(singles)
    bodies: list = []
    pieces: list = []
    want = size - len(specials) - len(singles)
    while len(pieces) < want:
        lens = rng.integers(2, 8, 4096)
        idx = rng.integers(0, len(letters), (4096, 7))
        marks = rng.random(4096) < 0.5
        for j in range(4096):
            body = "".join(letters[i] for i in idx[j, : lens[j]])
            piece = ("▁" + body) if marks[j] else body
            if piece in seen:
                continue
            seen.add(piece)
            pieces.append(piece)
            bodies.append(body)
            if len(pieces) == want:
                break
    scores = iter(list(rng.uniform(-16.0, -12.0, len(singles))) + list(rng.uniform(-12.0, -6.0, want)))
    rest = iter(singles + pieces)
    by_id = {i: t for t, i in specials.items()}
    vocab = [[by_id[i], 0.0] if i in by_id else [next(rest), float(next(scores))]
             for i in range(size)]
    norm = {"type": "Sequence", "normalizers": [
        {"type": "NFKC"}, {"type": "Strip", "strip_left": False, "strip_right": True},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]}
    spm_tokenizer_json(path, vocab, specials["<unk>"], specials, norm, {
        "tokenizer_class": "BigBirdTokenizer", "model_max_length": 4096, "unk_token": "<unk>",
        "bos_token": "<s>", "eos_token": "</s>", "pad_token": "<pad>", "sep_token": "[SEP]",
        "mask_token": "[MASK]", "cls_token": "[CLS]"})
    return bodies


def long_texts(bodies: list, n: int, seed: int) -> list:
    """``n`` distinct English-like documents of ``LOCAL_BIGBIRD_WORDS``
    words (8 + 992 u^3: a quarter and more pass 512 tokens), words drawn by
    a Zipf law from a lexicon of ``XLMR_LEXICON`` words (a word: 1-3 of
    ``bodies`` joined), 5% followed by a comma, 2% capitalised."""
    rng = np.random.default_rng(seed)
    pool = np.asarray(bodies, dtype=object)
    parts = rng.integers(0, len(pool), (XLMR_LEXICON, 3))
    k = rng.integers(1, 4, XLMR_LEXICON)
    lexicon = np.asarray(["".join(pool[parts[i, : k[i]]]) for i in range(XLMR_LEXICON)],
                         dtype=object)
    lo, hi = LOCAL_BIGBIRD_WORDS
    lens = lo + ((hi - lo) * rng.random(n) ** 3).astype(np.int64)
    total = int(lens.sum())
    words = lexicon[(rng.zipf(1.2, total) - 1) % XLMR_LEXICON]
    r = rng.random(total)
    words[r < 0.05] = [w + "," for w in words[r < 0.05]]
    caps = (r >= 0.05) & (r < 0.07)
    words[caps] = [str(w).capitalize() for w in words[caps]]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    texts = [" ".join(words[bounds[i]:bounds[i + 1]]) for i in range(n)]
    seen: set = set()
    for i, t in enumerate(texts):
        while texts[i] in seen:
            texts[i] = f"{texts[i]} {lexicon[i % XLMR_LEXICON]}"
        seen.add(texts[i])
    return texts


def bigbird_flops_per_text(config: dict, seq_len: int) -> dict:
    """The multiply-adds x 2 of one text through a block-sparse BigBird at
    ``seq_len`` tokens: the projections (query, key, value, output, the two
    feed-forward layers) over every token, and the attention's two
    products over each query block's keys: the first and last blocks every
    key, the second and second last 4 + r blocks, each middle block 5 + r
    (r = ``num_random_blocks``; the random blocks are computed although
    they repeat block 0)."""
    h, inter = config["hidden_size"], config["intermediate_size"]
    layers, bs, r = config["num_hidden_layers"], config["block_size"], config["num_random_blocks"]
    nb = seq_len // bs
    proj = 2 * seq_len * (4 * h * h + 2 * h * inter) * layers
    pairs = bs * (2 * seq_len + 2 * (4 + r) * bs + (nb - 4) * (5 + r) * bs)
    attn = 2 * 2 * pairs * h * layers  # QK^T and PV over all heads (head dim x heads = h)
    return {"projections": float(proj), "attention": float(attn), "total": float(proj + attn)}


def local_bigbird_phase(work: Path, out: dict) -> None:
    """A long-document store on the card at ``google/bigbird-roberta-base``'s
    widths, ``LOCAL_BIGBIRD_LAYERS`` of its 12 layers (``BIGBIRD_ROBERTA``:
    block-sparse attention, random
    weights from the seed; a synthetic 50,358-piece Unigram
    ``tokenizer.json``; mean pooling, ``max_length`` 1,024, batch 64,
    bf16): ``LOCAL_BIGBIRD_DOCS`` documents of 8-1,000 words (a quarter
    and more past 512 tokens) embedded and written through
    ``KB.bulk_add_docs``; f32 on the card against f32 on the CPU for
    ``LOCAL_BIGBIRD_PARITY_TEXTS`` texts at 512 and 4,096 tokens with the
    depth cut to ``LOCAL_BIGBIRD_CPU_LAYERS`` (within ``LOCAL_F32_ATOL``);
    the stored bf16 rows of the same texts against a CPU f32 run of the model
    at 1,024 (within ``LOCAL_BIGBIRD_BF16_ATOL``, cosine at least
    ``LOCAL_BIGBIRD_BF16_MIN_COS``); ``retrieve_batch`` at B = 1, 8 and 64,
    n = 10 and 100, half the queries docs' own texts (each its own top
    hit), exact against a scan of the stored rows; a reopen with no
    function: the same answers.  Reports the tokenizer's and the encoder's
    texts/s, the write's seconds, the peak device memory, the encoder's
    share of its bound (:func:`bigbird_flops_per_text` at the bf16 peak),
    and fails if none of #2, #3 and #4 launched."""
    import torch

    import svs_tpu_torch

    res = out["paths_detail_local_bigbird"] = {}
    ck = work / "bigbird-synthetic"
    ck_cut = work / "bigbird-synthetic-2l"
    model = {**BIGBIRD_ROBERTA, "num_hidden_layers": LOCAL_BIGBIRD_LAYERS}
    cut = {**BIGBIRD_ROBERTA, "num_hidden_layers": LOCAL_BIGBIRD_CPU_LAYERS}
    t = time.perf_counter()
    write_random_encoder(ck, model, SEED + 67)
    write_random_encoder(ck_cut, cut, SEED + 67)
    res["checkpoint_s"] = time.perf_counter() - t
    res["checkpoint_gb"] = (ck / "flax_model.msgpack").stat().st_size / 1e9
    t = time.perf_counter()
    bodies = write_bigbird_tokenizer(ck, SEED + 71)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(ck / name, ck_cut / name)
    res["tokenizer_write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    texts = long_texts(bodies, LOCAL_BIGBIRD_DOCS, SEED + 73)
    res["texts_s"] = time.perf_counter() - t
    log(f"e2e local_bigbird: checkpoint {res['checkpoint_gb']:.2f} GB (and a "
        f"{LOCAL_BIGBIRD_CPU_LAYERS}-layer cut) in {res['checkpoint_s']:.1f} s; tokenizer.json in "
        f"{res['tokenizer_write_s']:.1f} s; {LOCAL_BIGBIRD_DOCS} texts in {res['texts_s']:.1f} s")
    path = work / "local_bigbird.sqlite"
    shapes = ((64, 10), (64, 100), (8, 10), (8, 100), (1, 10), (1, 100))
    flops = bigbird_flops_per_text(model, LOCAL_BIGBIRD_MAX_LENGTH)
    res["gflop_per_text"] = {k: v / 1e9 for k, v in flops.items()}
    res["bound_texts_per_s"] = PEAK_OPS_PER_S["bf16"] / flops["total"]

    def query_texts(b, n):
        rng = np.random.default_rng(SEED + 79 + b * 1000 + n)
        own = rng.choice(LOCAL_BIGBIRD_DOCS, b // 2 + 1 if b > 1 else 1, replace=False)
        fresh = long_texts(bodies, b - len(own), SEED + 83 + b * 1000 + n)
        return [texts[i] for i in own] + fresh, [int(i) for i in own]

    def provider(model, dtype, device, max_length=LOCAL_BIGBIRD_MAX_LENGTH):
        return svs_tpu_torch.make_local_embeddings_func(
            str(model), pooling="mean", max_length=max_length, batch_size=LOCAL_BIGBIRD_BATCH,
            compute_dtype=dtype, device=device)

    def run():
        # the sample: the two longest of the first 200 docs, two short ones;
        # the 4,096-token check also gets the first 12 docs joined (past
        # 4,096 tokens) in place of the shortest
        head = texts[:200]
        order = sorted(range(len(head)), key=lambda i: len(head[i]))
        sample_ids = [order[-1], order[-2], order[0], order[len(order) // 2]]
        sample = [texts[i] for i in sample_ids]
        joined = [" ".join(texts[:12])] + sample[:2] + sample[3:]
        cut_texts = {512: sample, 4096: joined}
        cpu_run: dict = {}

        def cpu_reference():
            try:
                t = time.perf_counter()
                cpu_run["full"] = np.asarray(asyncio.run(provider(ck, "float32", "cpu")(sample)),
                                             np.float32)
                for length in LOCAL_BIGBIRD_PARITY_LENGTHS:
                    fn = provider(ck_cut, "float32", "cpu", length)
                    cpu_run[length] = np.asarray(asyncio.run(fn(cut_texts[length])), np.float32)
                cpu_run["s"] = time.perf_counter() - t
            except BaseException as exc:  # re-raised by the phase below
                cpu_run["error"] = exc

        torch.set_num_threads(os.cpu_count() or 1)
        cpu_thread = threading.Thread(target=cpu_reference, name="local_bigbird_cpu", daemon=True)
        cpu_thread.start()
        fn = provider(ck, "bfloat16", "cuda")
        rows, ids, base = write_provider_store(path, fn, texts, res, "local_bigbird")
        st = res["encoder_stats"]
        res["encoder_share_of_bound"] = res["encoder_texts_per_s"] / res["bound_texts_per_s"]
        tok, _ = fn.encoder._load()
        lens = [len(tok.token_ids(x)) + 2 for x in texts[:2000]]
        res["tokens_p50_p99_max"] = [float(np.percentile(lens, 50)), float(np.percentile(lens, 99)),
                                     max(lens)]
        res["past_512"] = float(np.mean(np.asarray(lens) > 512))
        res["past_max_length"] = float(np.mean(np.asarray(lens) > LOCAL_BIGBIRD_MAX_LENGTH))
        log(f"e2e local_bigbird: load {res['load_s']:.1f} s; {LOCAL_BIGBIRD_DOCS} docs embedded "
            f"and written in {res['write_s']:.1f} s ({res['write_docs_per_s']:.0f} docs/s); "
            f"tokenizer {st['tokenize_s']:.1f} s ({res['tokenizer_texts_per_s']:.0f} texts/s), "
            f"encoder (bf16, host clock to the result) {st['forward_s']:.1f} s "
            f"({res['encoder_texts_per_s']:.0f} texts/s, {100 * res['encoder_share_of_bound']:.1f}% "
            f"of the {res['bound_texts_per_s']:.0f} texts/s bound: "
            f"{res['gflop_per_text']['total']:.1f} GFLOP a text at 989 TFLOP/s); tokens "
            f"p50/p99/max {res['tokens_p50_p99_max']}, {100 * res['past_512']:.1f}% past 512, "
            f"{100 * res['past_max_length']:.1f}% past {LOCAL_BIGBIRD_MAX_LENGTH}; encoder peak "
            f"{res['encoder_peak_mb']:.1f} MB above {base / 1e6:.1f} MB")
        if res["past_512"] < 0.25 or res["past_max_length"] <= 0:
            raise AssertionError("local_bigbird: too few texts past 512 / max_length tokens")
        t = time.perf_counter()
        cpu_thread.join()
        res["cpu_wait_s"] = time.perf_counter() - t
        if "error" in cpu_run:
            raise cpu_run["error"]
        res["cpu_f32_s"] = cpu_run["s"]
        for length in LOCAL_BIGBIRD_PARITY_LENGTHS:
            f32 = np.asarray(asyncio.run(provider(ck_cut, "float32", "cuda", length)(
                cut_texts[length])), np.float32)
            res[f"f32_max_abs_err_{length}"] = float(np.abs(f32 - cpu_run[length]).max())
        bf = rows[sample_ids]
        cpu = cpu_run["full"]
        res["bf16_max_abs_err"] = float(np.abs(bf - cpu).max())
        res["bf16_min_cos"] = float((bf * cpu).sum(axis=1).min())
        log(f"e2e local_bigbird: {LOCAL_BIGBIRD_PARITY_TEXTS} texts vs the CPU f32 runs "
            f"({res['cpu_f32_s']:.1f} s beside the write, {res['cpu_wait_s']:.1f} s waited for "
            f"after it): f32 on the card ({LOCAL_BIGBIRD_CPU_LAYERS} layers) max |err| "
            f"{res['f32_max_abs_err_512']:.3g} at 512, {res['f32_max_abs_err_4096']:.3g} at 4096 "
            f"(tolerance {LOCAL_F32_ATOL}); the stored bf16 rows "
            f"({model['num_hidden_layers']} layers, {LOCAL_BIGBIRD_MAX_LENGTH}) "
            f"{res['bf16_max_abs_err']:.3g} (tolerance {LOCAL_BIGBIRD_BF16_ATOL}), min cosine "
            f"{res['bf16_min_cos']:.6f} (at least {LOCAL_BIGBIRD_BF16_MIN_COS})")
        for length in LOCAL_BIGBIRD_PARITY_LENGTHS:
            if res[f"f32_max_abs_err_{length}"] > LOCAL_F32_ATOL:
                raise AssertionError(f"local_bigbird: f32 on the card disagrees with the CPU at {length}")
        if (res["bf16_max_abs_err"] > LOCAL_BIGBIRD_BF16_ATOL
                or res["bf16_min_cos"] < LOCAL_BIGBIRD_BF16_MIN_COS):
            raise AssertionError("local_bigbird: bf16 on the card disagrees with the CPU f32 run")
        query_provider_store(path, fn, rows, ids, shapes, query_texts, res, "local_bigbird")

    drive_path("local_bigbird", [], run, out)
    counts = out["paths"]["local_bigbird"]["launches"]
    launched = {k: counts[k] for k in ("_staged_finish", "_fused2_extract_int8", "_fused_extract_int8")}
    res["hand_kernel_launches"] = launched
    if not any(launched.values()):
        raise AssertionError(f"local_bigbird: none of #2, #3, #4 launched: {launched}")
    shutil.rmtree(ck_cut, ignore_errors=True)
    torch.cuda.empty_cache()


#: The leading pieces of the Llama-2 and Gemma vocabularies (the ids their
#: ``transformers`` converters give the special tokens), before the 256
#: ``<0xNN>`` byte pieces.
DECODER_SPECIALS = {"llama": ["<unk>", "<s>", "</s>"],
                    "gemma": ["<pad>", "<eos>", "<bos>", "<unk>"]}
#: Words that no synthetic decoder vocabulary holds: 1% of a passage's
#: words, tokenized through the byte fallback.
NON_ASCII_WORDS = ("café", "naïve", "straße", "привет", "мир", "κόσμε", "中文", "字",
                   "مرحبا", "한국어", "😀")


def write_decoder_tokenizer(path: Path, layout: str, size: int, seed: int, **config) -> list:
    """A synthetic ``size``-piece BPE ``tokenizer.json`` in Llama-2's layout
    (``LlamaConverter``: ``Prepend("▁")`` + ``Replace(" ", "▁")``, no
    pre-tokenizer) or Gemma's (``GemmaConverter``: ``Replace(" ", "▁")``,
    ``Split(" ", merged_with_previous)``): the special tokens
    (:data:`DECODER_SPECIALS`), the 256 ``<0xNN>`` byte pieces (every
    character outside the alphabet falls back to them), ``▁`` and the
    printable ASCII characters, then seeded words of 2-9 Latin letters,
    half after ``▁``, each built left to right by one merge a letter;
    ``fuse_unk``, ``byte_fallback``; the post-processor ``bos $A``.
    ``tokenizer_config.json`` names ``LlamaTokenizer`` / ``GemmaTokenizer``
    with ``config``'s keys.  Returns the words whose every prefix is a
    piece (without ``▁``)."""
    rng = np.random.default_rng(seed)
    specials = DECODER_SPECIALS[layout]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in ["▁"] + [chr(c) for c in range(33, 127)]:
        vocab.setdefault(ch, len(vocab))
    letters = "abcdefghijklmnopqrstuvwxyz"
    merges: list = []
    words: list = []
    while len(vocab) < size:
        lens = rng.integers(2, 10, 4096)
        idx = rng.integers(0, 26, (4096, 9))
        marks = rng.random(4096) < 0.5
        for j in range(4096):
            body = "".join(letters[i] for i in idx[j, : lens[j]])
            word = ("▁" + body) if marks[j] else body
            cur, whole = word[0], True
            for ch in word[1:]:
                new = cur + ch
                if new not in vocab:
                    if len(vocab) >= size:
                        whole = False
                        break
                    vocab[new] = len(vocab)
                    merges.append([cur, ch])
                cur = new
            if whole:
                words.append(body)
            if len(vocab) >= size:
                break
    norm = ([{"type": "Prepend", "prepend": "▁"}] if layout == "llama" else [])
    norm.append({"type": "Replace", "pattern": {"String": " "}, "content": "▁"})
    bos = specials[1] if layout == "llama" else "<bos>"
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for t in specials],
        "normalizer": {"type": "Sequence", "normalizers": norm},
        "pre_tokenizer": (None if layout == "llama" else
                          {"type": "Split", "pattern": {"String": " "},
                           "behavior": "MergedWithPrevious", "invert": False}),
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}}],
                           "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                                    {"Sequence": {"id": "A", "type_id": 0}},
                                    {"SpecialToken": {"id": bos, "type_id": 1}},
                                    {"Sequence": {"id": "B", "type_id": 1}}],
                           "special_tokens": {bos: {"id": bos, "ids": [vocab[bos]],
                                                    "tokens": [bos]}}},
        "decoder": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    cls = "LlamaTokenizer" if layout == "llama" else "GemmaTokenizer"
    (path / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": cls, **config}))
    return words


def passages(words: list, n: int, seed: int, lo: int, hi: int) -> list:
    """``n`` distinct passages of ``lo``-``hi`` words (uniform), drawn by a
    Zipf law from ``words``; 5% followed by a comma, 2% capitalised, 1%
    from :data:`NON_ASCII_WORDS` (the byte fallback)."""
    rng = np.random.default_rng(seed)
    pool = np.asarray(words, dtype=object)
    lens = rng.integers(lo, hi + 1, n)
    total = int(lens.sum())
    toks = pool[(rng.zipf(1.2, total) - 1) % len(pool)]
    r = rng.random(total)
    toks[r < 0.05] = [w + "," for w in toks[r < 0.05]]
    caps = (r >= 0.05) & (r < 0.07)
    toks[caps] = [str(w).capitalize() for w in toks[caps]]
    odd = (r >= 0.07) & (r < 0.08)
    toks[odd] = np.asarray(NON_ASCII_WORDS, dtype=object)[rng.integers(0, len(NON_ASCII_WORDS),
                                                                       int(odd.sum()))]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    texts = [" ".join(toks[bounds[i]:bounds[i + 1]]) for i in range(n)]
    seen: set = set()
    for i, t in enumerate(texts):  # distinct, so a doc's own text finds it alone
        while texts[i] in seen:
            texts[i] = f"{texts[i]} {pool[i % len(pool)]}"
        seen.add(texts[i])
    return texts


def write_roberta_bpe(path: Path, size: int, seed: int) -> None:
    """A byte-level BPE ``vocab.json`` + ``merges.txt`` of ``size`` entries
    in RoBERTa's layout (``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, ``<unk>`` 3,
    the 256 byte characters, then seeded merges that build words of
    ``XLMR_SCRIPTS``' Latin letters left to right, ``<mask>`` last) and a
    ``tokenizer_config.json`` naming ``RobertaTokenizer``."""
    from svs_tpu_torch.embeddings.bpe import bytes_to_unicode

    rng = np.random.default_rng(seed)
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])}
    for ch in bytes_to_unicode().values():
        vocab.setdefault(ch, len(vocab))
    merges = []
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(vocab) < size - 1:
        word = ("Ġ" if rng.random() < 0.5 else "") + "".join(
            letters[i] for i in rng.integers(0, 26, int(rng.integers(2, 9))))
        cur = word[0]
        for ch in word[1:]:
            new = cur + ch
            if new not in vocab and len(vocab) < size - 1:
                vocab[new] = len(vocab)
                merges.append(f"{cur} {ch}")
            if new not in vocab:
                break
            cur = new
    vocab["<mask>"] = len(vocab)
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n", encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "RobertaTokenizer"}))


def write_encoder_family(work: Path, family: str, seed: int) -> tuple:
    """The ``local_families`` checkpoint of an entry of ``FAMILY_CONFIGS``,
    cut to ``FAMILY_LAYERS`` layers (ALBERT at its published depth), with
    its tokenizer's files.  Returns ``(directory, source, config)``."""
    source, published = FAMILY_CONFIGS[family]
    cfg = dict(published)
    if family not in FAMILY_FULL_DEPTH:
        cfg["n_layers" if family == "distilbert" else "num_hidden_layers"] = FAMILY_LAYERS
    ck = work / f"{family}-synthetic"
    write_random_encoder(ck, cfg, seed)
    vocab = bert_uncased_vocab(SEED)
    if family in ("roberta", "roberta-prelayernorm"):
        write_roberta_bpe(ck, cfg["vocab_size"], SEED + 59)
    elif family == "albert":
        write_albert_tokenizer(ck, vocab, cfg["vocab_size"], SEED + 61)
    else:
        (ck / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
        cls = "DistilBertTokenizer" if family == "distilbert" else "ElectraTokenizer"
        (ck / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": cls, "do_lower_case": True}))
    return ck, source, cfg


def write_families(work: Path) -> dict:
    """Every ``local_families`` checkpoint: ``{family: (directory, source,
    config)}``, the encoders of ``FAMILY_CONFIGS`` then the decoders of
    ``DECODER_FAMILY_CONFIGS``."""
    models = {family: write_encoder_family(work, family, SEED + 53 + i)
              for i, family in enumerate(FAMILY_CONFIGS)}
    models.update({family: write_decoder_family(work, family, SEED + 103 + 7 * i)
                   for i, family in enumerate(DECODER_FAMILY_CONFIGS)})
    return models


def local_families_phase(work: Path, out: dict, families: dict) -> None:
    """The other families on the card, each at a published checkpoint's
    widths (``FAMILY_CONFIGS``, ``DECODER_FAMILY_CONFIGS``) cut to
    ``FAMILY_LAYERS`` layers (ALBERT at its 12), random weights from the
    seed: RoBERTa and RoBERTa-PreLayerNorm (byte-level BPE from
    ``vocab.json`` + ``merges.txt``), DistilBERT (``vocab.txt`` read as
    ``DistilBertTokenizer``), ELECTRA (``ElectraTokenizer``), ALBERT (a
    SentencePiece Unigram ``tokenizer.json``, :func:`write_albert_tokenizer`),
    Llama-2 and Gemma (:func:`write_decoder_family`).  Each embeds
    ``FAMILY_TEXTS`` texts (``max_length`` ``FAMILY_MAX_LENGTH``, mean
    pooling) on the card in f32 (within ``LOCAL_F32_ATOL``) and bf16
    (within ``LOCAL_BF16_ATOL``, cosine at least ``LOCAL_BF16_MIN_COS``)
    against the port's f32 run on the CPU.  ``families`` holds the
    checkpoints (``"models"``, :func:`write_families`) and the CPU vectors
    (``"cpu"``, :func:`family_cpu_references` of :func:`family_texts`):
    what ``local_mistral_phase`` returns, its CPU runs taken beside that
    phase's write."""
    import svs_tpu_torch

    res = out["paths_detail_local_families"] = {}
    published = {**FAMILY_CONFIGS, **DECODER_FAMILY_CONFIGS}

    def layers(cfg):
        return cfg.get("num_hidden_layers", cfg.get("n_layers"))

    def card_runs(ck, texts):
        """``texts`` on the card in f32 and in bf16, the two providers on
        one loaded encoder (the same weights: one load)."""
        runs = []
        for dtype in ("float32", "bfloat16"):
            fn = svs_tpu_torch.make_local_embeddings_func(
                str(ck), max_length=FAMILY_MAX_LENGTH, compute_dtype=dtype, device="cuda")
            if runs:
                fn.encoder._loaded = loaded
            runs.append(np.asarray(asyncio.run(fn(texts)), np.float32))
            loaded = fn.encoder._loaded
        return runs

    def run():
        texts = family_texts()
        cpu_runs = families["cpu"]
        res["cpu_f32_s"] = cpu_runs["s"]
        for family, (ck, source, cfg) in families["models"].items():
            t = time.perf_counter()
            f32, bf = card_runs(ck, texts)
            cpu = cpu_runs[family]
            r = res[family] = {
                "source": source,
                "cut": f"{layers(published[family][1])} -> {layers(cfg)} layers",
                "seconds": time.perf_counter() - t,
                "f32_max_abs_err": float(np.abs(f32 - cpu).max()),
                "bf16_max_abs_err": float(np.abs(bf - cpu).max()),
                "bf16_min_cos": float((bf * cpu).sum(axis=1).min()),
            }
            log(f"e2e local_families {family} ({source} widths, {r['cut']}): {FAMILY_TEXTS} "
                f"texts, f32 max |err| {r['f32_max_abs_err']:.3g}, bf16 "
                f"{r['bf16_max_abs_err']:.3g}, min cosine {r['bf16_min_cos']:.6f} "
                f"({r['seconds']:.1f} s on the card)")
            if r["f32_max_abs_err"] > LOCAL_F32_ATOL:
                raise AssertionError(f"local_families {family}: f32 on the card disagrees with the CPU")
            if r["bf16_max_abs_err"] > LOCAL_BF16_ATOL or r["bf16_min_cos"] < LOCAL_BF16_MIN_COS:
                raise AssertionError(f"local_families {family}: bf16 disagrees with the CPU f32 run")
            shutil.rmtree(ck, ignore_errors=True)

    drive_path("local_families", [], run, out)


#: ``intfloat/e5-mistral-7b-instruct``'s published config (``MistralModel``:
#: 7.11B parameters, 28.4 GB in f32), at its widths and depth.
E5_MISTRAL = {
    "model_type": "mistral", "architectures": ["MistralModel"], "vocab_size": 32000,
    "hidden_size": 4096, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "intermediate_size": 14336, "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-05, "sliding_window": 4096, "hidden_act": "silu", "rope_theta": 10000.0,
    "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 2, "tie_word_embeddings": False,
    "initializer_range": 0.02, "use_cache": False,
}
#: The other Llama-family checkpoints of ``local_families``, cut to
#: ``FAMILY_LAYERS`` layers at their widths: Llama-2 (multi-head, written
#: as a ``LlamaForCausalLM`` tree) and Gemma (multi-query, ``head_dim`` 256,
#: no ``hidden_activation``: ``gelu_pytorch_tanh``).
DECODER_FAMILY_CONFIGS = {
    "llama": ("meta-llama/Llama-2-7b-hf", {
        "model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": 32000,
        "hidden_size": 4096, "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 32, "intermediate_size": 11008, "max_position_embeddings": 4096,
        "rms_norm_eps": 1e-05, "hidden_act": "silu", "rope_theta": 10000.0,
        "attention_bias": False, "bos_token_id": 1, "eos_token_id": 2,
        "tie_word_embeddings": False, "initializer_range": 0.02}),
    "gemma": ("google/gemma-2b", {
        "model_type": "gemma", "architectures": ["GemmaForCausalLM"], "vocab_size": 256000,
        "hidden_size": 2048, "num_hidden_layers": 18, "num_attention_heads": 8,
        "num_key_value_heads": 1, "head_dim": 256, "intermediate_size": 16384,
        "max_position_embeddings": 8192, "rms_norm_eps": 1e-06, "hidden_act": "gelu",
        "rope_theta": 10000.0, "attention_bias": False, "bos_token_id": 2, "eos_token_id": 1,
        "pad_token_id": 0, "initializer_range": 0.02}),
}
#: Three 8,192-row blocks of 4,096-wide docs (a 32,768 x 4,096 int8 pack,
#: as 20,000 docs make; 17,000 leave the smoke room): the keyed v2 kernel
#: (#3), v1 (#4) after a widen and the staged finish (#2); a store of two
#: blocks launches none of them.
LOCAL_MISTRAL_DOCS = 17_000
LOCAL_MISTRAL_MAX_LENGTH = 128
LOCAL_MISTRAL_BATCH = 128
LOCAL_MISTRAL_WORDS = (8, 120)
#: ``save_pretrained``'s default ``max_shard_size="10GB"``: two shards of
#: the 14.2 GB bf16 checkpoint.
LOCAL_MISTRAL_SHARD_BYTES = 10 * 10**9
#: Texts of the f32 card-vs-CPU check, on a cut of the checkpoint to this
#: depth at full width (the CPU would take minutes at 32 layers).
LOCAL_MISTRAL_PARITY_TEXTS = 4
LOCAL_MISTRAL_CPU_LAYERS = 2
#: The stored bf16 rows of the first texts against the card's own f32 run
#: at full depth (the same weights, no second load).  Set before the first
#: run on the card, as the other local stores' bounds.
LOCAL_MISTRAL_BF16_TEXTS = 64
LOCAL_MISTRAL_BF16_ATOL = 1e-2
LOCAL_MISTRAL_BF16_MIN_COS = 0.999
#: Docs of the small store (the 2-layer cut) that the reopen with no
#: function runs on: a second 7B load would cost its 28.4 GB upload again.
LOCAL_MISTRAL_REOPEN_DOCS = 256


def random_decoder_params(config: dict, seed: int, device: str, qk: float = 1.0,
                          dtype: str = "bfloat16") -> dict:
    """A Flax Llama / Mistral / Gemma base tree at ``config``'s widths with
    random weights from the seed's generator on ``device``, as
    :func:`random_encoder_params` makes them: the token embeddings N(0,
    0.02), the RMSNorm weights 1 (Gemma's 0: its norm scales by ``1 + w``),
    Dense kernels N(0, 1/fan_in) (the query and key kernels x ``qk``), no
    biases; torch tensors in ``dtype``, as a bf16 checkpoint holds them.
    ``qk`` is 1, not the encoders' ``LOCAL_QK``: mean-pooled decoder states
    are spread without it (texts' cosines about 0.2), and with it the
    sharper random attention amplifies bf16 rounding into a cosine of
    0.998 to f32 at 32 layers (0.99997 at 1), in ``svs_tpu``'s provider as
    in the port (``tests/test_torch_decoders.py``, at 16 layers)."""
    import torch

    from svs_tpu_torch.embeddings.llama import _cfg

    c = _cfg(config)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dt = getattr(torch, dtype)

    def normal(scale, *shape):
        t = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return t.mul_(scale).to(dt)

    def dense(d_in, d_out, gain=1.0):
        return {"kernel": normal(gain / np.sqrt(d_in), d_in, d_out)}

    h, inter = c["hidden_size"], c["intermediate_size"]
    q_w, kv_w = c["num_attention_heads"] * c["head_width"], c["kv_heads"] * c["head_width"]
    one = 0.0 if c["model_type"] == "gemma" else 1.0

    def norm():
        return {"weight": torch.full((h,), one, device=device, dtype=dt)}

    layers = {str(i): {
        "input_layernorm": norm(),
        "self_attn": {"q_proj": dense(h, q_w, qk), "k_proj": dense(h, kv_w, qk),
                      "v_proj": dense(h, kv_w), "o_proj": dense(q_w, h)},
        "post_attention_layernorm": norm(),
        "mlp": {"gate_proj": dense(h, inter), "up_proj": dense(h, inter),
                "down_proj": dense(inter, h)},
    } for i in range(c["num_hidden_layers"])}
    return {"embed_tokens": {"embedding": normal(0.02, c["vocab_size"], h)}, "layers": layers,
            "norm": norm()}


def decoder_flops_per_text(config: dict, seq_len: int) -> dict:
    """The multiply-adds x 2 of one text through a Llama-family decoder at
    ``seq_len`` tokens (``padding="max_length"``: every text is that long):
    the projections (query, key, value, output, gate, up, down) over every
    token, and the two attention products over every query-key pair of the
    eager ``[L, L]`` scores."""
    from svs_tpu_torch.embeddings.llama import _cfg

    c = _cfg(config)
    h, inter, layers = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    q_w, kv_w = c["num_attention_heads"] * c["head_width"], c["kv_heads"] * c["head_width"]
    per_layer = h * q_w + 2 * h * kv_w + q_w * h + 3 * h * inter
    proj = 2 * seq_len * per_layer * layers
    attn = 2 * 2 * seq_len * seq_len * q_w * layers
    return {"projections": float(proj), "attention": float(attn), "total": float(proj + attn),
            "layer_parameters": float(per_layer * layers)}


class RssPeak:
    """The host's resident set peak of this process while the block runs
    (``VmRSS`` of ``/proc/self/status``, polled every 20 ms), in GB."""

    def __enter__(self) -> "RssPeak":
        self.peak = self.start = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, name="rss_peak", daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
        return 0.0

    def _poll(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def write_decoder_family(work: Path, family: str, seed: int) -> tuple:
    """The ``local_families`` checkpoint of a Llama-family entry of
    :data:`DECODER_FAMILY_CONFIGS`, cut to ``FAMILY_LAYERS`` layers: random
    weights from the seed on the card, written in bf16 (Llama-2's as a
    ``*ForCausalLM`` tree with an ``lm_head``, which the provider
    unwraps), and a synthetic tokenizer in the family's layout at its
    vocabulary size.  Returns ``(directory, source, config)``."""
    import torch

    from svs_tpu_torch.embeddings.checkpoint import write_checkpoint

    source, published = DECODER_FAMILY_CONFIGS[family]
    cfg = {**published, "num_hidden_layers": FAMILY_LAYERS}
    ck = work / f"{family}-synthetic"
    tree = random_decoder_params(cfg, seed, "cuda")
    if family == "llama":
        dev = tree["norm"]["weight"].device
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 1)
        head = torch.randn((cfg["hidden_size"], cfg["vocab_size"]), generator=g, device=dev)
        tree = {"model": tree, "lm_head": {"kernel": head.mul_(0.02).bfloat16()}}
    write_checkpoint(ck, cfg, tree)
    del tree
    torch.cuda.empty_cache()
    pad = {"pad_token": "</s>"} if family == "llama" else {}
    write_decoder_tokenizer(ck, family, cfg["vocab_size"], seed + 2, **pad)
    return ck, source, cfg


def family_texts() -> list:
    """The ``FAMILY_TEXTS`` texts every ``local_families`` entry embeds."""
    return synthetic_texts(bert_uncased_vocab(SEED), FAMILY_TEXTS, SEED + 47)


def family_cpu_references(models: dict, texts: list) -> dict:
    """The port's f32 run on the CPU of each directory of ``models``
    (``{family: directory}``): ``{family: vectors}``, and ``"s"``."""
    import svs_tpu_torch

    t = time.perf_counter()
    refs: dict = {}
    for family, ck in models.items():
        fn = svs_tpu_torch.make_local_embeddings_func(
            str(ck), max_length=FAMILY_MAX_LENGTH, compute_dtype="float32", device="cpu")
        refs[family] = np.asarray(asyncio.run(fn(texts)), np.float32)
    refs["s"] = time.perf_counter() - t
    return refs


def local_mistral_phase(work: Path, out: dict) -> dict:
    """A store on the card at ``intfloat/e5-mistral-7b-instruct``'s widths
    and depth (``E5_MISTRAL``: 7.11B parameters, random weights from the
    seed's generator on the card, written as a sharded bf16 Flax checkpoint
    of two shards and read back through the provider into f32 on the card;
    a synthetic 32,000-piece BPE ``tokenizer.json`` in Llama-2's layout;
    mean pooling, ``max_length`` 128, batch 128, bf16):
    ``LOCAL_MISTRAL_DOCS`` passages of 8-120 words embedded and written
    through ``KB.bulk_add_docs``; f32 on the card against f32 on the CPU
    for ``LOCAL_MISTRAL_PARITY_TEXTS`` texts on a cut of the checkpoint to
    ``LOCAL_MISTRAL_CPU_LAYERS`` layers (within ``LOCAL_F32_ATOL``); the
    stored bf16 rows of ``LOCAL_MISTRAL_BF16_TEXTS`` texts against the
    card's own f32 run at full depth (within ``LOCAL_MISTRAL_BF16_ATOL``,
    cosine at least ``LOCAL_MISTRAL_BF16_MIN_COS``); ``retrieve_batch`` at
    B = 1, 8 and 64, n = 10 and 100, half the queries docs' own texts (each
    its own top hit), exact against a scan of the stored rows; one B=64
    call profiled (the retrieval kernels' device time per launch at d =
    4,096); then, the 7B model freed, a store of ``LOCAL_MISTRAL_REOPEN_DOCS``
    docs through the 2-layer cut and its reopen with no function (the same
    answers); after the path (outside its launch count), the keyed v2
    prescore (#3), the staged finish (#2) and v1 (#4) on the store's own
    int8 pack and the profiled call's 64 queries, each against its plain
    version (:func:`pack_kernel_checks`).  Reports the checkpoint's write, read and upload seconds
    and the host's resident peak during the load, the tokenizer's and the
    encoder's texts/s, the encoder's share of its bound
    (:func:`decoder_flops_per_text` at the bf16 peak), the write's seconds
    and the peak device memory; fails if none of #2, #3 and #4 launched.
    Beside the write, a CPU thread also runs the f32 references of every
    ``local_families`` entry: returns their checkpoints (``"models"``:
    :func:`write_families`) and CPU vectors (``"cpu"``) for
    ``local_families_phase``."""
    import gc

    import torch

    import svs_tpu_torch
    from svs_tpu_torch.embeddings.checkpoint import shard_files, write_checkpoint

    res = out["paths_detail_local_mistral"] = {}
    ck = work / "e5-mistral-synthetic"
    ck_cut = work / "e5-mistral-synthetic-2l"
    t = time.perf_counter()
    tree = random_decoder_params(E5_MISTRAL, SEED + 89, "cuda")
    torch.cuda.synchronize()
    res["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    files = write_checkpoint(ck, E5_MISTRAL, tree, max_shard_size=LOCAL_MISTRAL_SHARD_BYTES)
    res["checkpoint_write_s"] = time.perf_counter() - t
    cut_layers = {str(i): tree["layers"][str(i)] for i in range(LOCAL_MISTRAL_CPU_LAYERS)}
    write_checkpoint(ck_cut, {**E5_MISTRAL, "num_hidden_layers": LOCAL_MISTRAL_CPU_LAYERS},
                     {"embed_tokens": tree["embed_tokens"], "layers": cut_layers,
                      "norm": tree["norm"]})
    del tree, cut_layers
    torch.cuda.empty_cache()
    res["checkpoint_gb"] = sum(f.stat().st_size for f in files) / 1e9
    res["shards"] = [f.name for f in shard_files(ck)]
    if len(res["shards"]) < 2:
        raise AssertionError(f"local_mistral: the checkpoint is not sharded ({res['shards']})")
    t = time.perf_counter()
    words = write_decoder_tokenizer(ck, "llama", E5_MISTRAL["vocab_size"], SEED + 97,
                                    pad_token="</s>")
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(ck / name, ck_cut / name)
    texts = passages(words, LOCAL_MISTRAL_DOCS, SEED + 101, *LOCAL_MISTRAL_WORDS)
    res["tokenizer_and_texts_s"] = time.perf_counter() - t
    # the local_families checkpoints: written now, their CPU runs beside the write
    fam_texts = family_texts()
    families = {"models": write_families(work)}
    log(f"e2e local_mistral: weights on the card in {res['weights_s']:.1f} s; a "
        f"{res['checkpoint_gb']:.2f} GB bf16 checkpoint in {len(res['shards'])} shards written in "
        f"{res['checkpoint_write_s']:.1f} s (and a {LOCAL_MISTRAL_CPU_LAYERS}-layer cut); "
        f"tokenizer.json and {LOCAL_MISTRAL_DOCS} texts in {res['tokenizer_and_texts_s']:.1f} s")
    path = work / "local_mistral.sqlite"
    shapes = ((64, 10), (64, 100), (8, 10), (8, 100), (1, 10), (1, 100))
    flops = decoder_flops_per_text(E5_MISTRAL, LOCAL_MISTRAL_MAX_LENGTH)
    res["gflop_per_text"] = {k: v / 1e9 for k, v in flops.items()}
    res["bound_texts_per_s"] = PEAK_OPS_PER_S["bf16"] / flops["total"]

    def query_texts(b, n):
        rng = np.random.default_rng(SEED + 107 + b * 1000 + n)
        own = rng.choice(LOCAL_MISTRAL_DOCS, b // 2 + 1 if b > 1 else 1, replace=False)
        fresh = passages(words, b - len(own), SEED + 109 + b * 1000 + n, *LOCAL_MISTRAL_WORDS)
        return [texts[i] for i in own] + fresh, [int(i) for i in own]

    def provider(model, dtype, device):
        return svs_tpu_torch.make_local_embeddings_func(
            str(model), pooling="mean", max_length=LOCAL_MISTRAL_MAX_LENGTH,
            batch_size=LOCAL_MISTRAL_BATCH, compute_dtype=dtype, device=device)

    def embed(fn, batch):
        return np.asarray(asyncio.run(fn(list(batch))), np.float32)

    def run():
        sample = texts[:LOCAL_MISTRAL_PARITY_TEXTS]
        cpu_run: dict = {}

        def cpu_reference():
            try:
                t = time.perf_counter()
                cpu_run["cut"] = embed(provider(ck_cut, "float32", "cpu"), sample)
                cpu_run["s"] = time.perf_counter() - t
                cpu_run["families"] = family_cpu_references(
                    {f: v[0] for f, v in families["models"].items()}, fam_texts)
            except BaseException as exc:  # re-raised below
                cpu_run["error"] = exc

        torch.set_num_threads(os.cpu_count() or 1)
        cpu_thread = threading.Thread(target=cpu_reference, name="local_mistral_cpu", daemon=True)
        cpu_thread.start()
        fn = provider(ck, "bfloat16", "cuda")
        with RssPeak() as rss:  # the load: read the shards, upload 28.4 GB
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn.encoder._load()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
        res["load_host_rss_gb"] = {"before": rss.start, "peak": rss.peak}
        res["load_read_s"] = fn.encoder.stats["read_s"]
        res["load_upload_s"] = fn.encoder.stats["upload_s"]
        rows, ids, base = write_provider_store(path, fn, texts, res, "local_mistral")
        res["load_s"] = load_s  # write_provider_store timed the loaded encoder again
        st = res["encoder_stats"]
        res["encoder_share_of_bound"] = res["encoder_texts_per_s"] / res["bound_texts_per_s"]
        tok = fn.encoder._load()[0]
        lens = [len(tok.encode(x, 1 << 20)) for x in texts[:2000]]
        res["tokens_p50_p99_max"] = [float(np.percentile(lens, 50)), float(np.percentile(lens, 99)),
                                     max(lens)]
        res["past_max_length"] = float(np.mean(np.asarray(lens) > LOCAL_MISTRAL_MAX_LENGTH))
        log(f"e2e local_mistral: load {res['load_s']:.1f} s (read and convert "
            f"{res['load_read_s']:.1f} s, upload {res['load_upload_s']:.1f} s; host RSS "
            f"{res['load_host_rss_gb']['before']:.1f} -> peak {res['load_host_rss_gb']['peak']:.1f} "
            f"GB); {LOCAL_MISTRAL_DOCS} docs embedded and written in "
            f"{res['write_s']:.1f} s ({res['write_docs_per_s']:.0f} docs/s); tokenizer "
            f"{st['tokenize_s']:.1f} s ({res['tokenizer_texts_per_s']:.0f} texts/s), encoder "
            f"(bf16, host clock to the result) {st['forward_s']:.1f} s "
            f"({res['encoder_texts_per_s']:.1f} texts/s, {100 * res['encoder_share_of_bound']:.1f}% "
            f"of the {res['bound_texts_per_s']:.1f} texts/s bound: "
            f"{res['gflop_per_text']['total']:.1f} GFLOP a text at 989 TFLOP/s); tokens "
            f"p50/p99/max {res['tokens_p50_p99_max']}, {100 * res['past_max_length']:.1f}% past "
            f"{LOCAL_MISTRAL_MAX_LENGTH}; encoder peak {res['encoder_peak_mb']:.1f} MB above "
            f"{base / 1e6:.1f} MB, device peak {res['device_peak_mb']:.1f} MB")
        if res["past_max_length"] <= 0:
            raise AssertionError("local_mistral: no text passes max_length (the truncation is not driven)")
        # where the encoder's time goes: one batch of the write profiled
        ids_b, mask_b = tok.batch(texts[:LOCAL_MISTRAL_BATCH], LOCAL_MISTRAL_MAX_LENGTH)
        prof = res["encoder_profile"] = device_idle_share(lambda: fn.encoder.forward(ids_b, mask_b))
        window = prof["profile"]
        log(f"e2e local_mistral: one batch of {LOCAL_MISTRAL_BATCH} profiled: "
            f"{window['wall_ms']:.1f} ms, kernels {window.get('kernel_ms')} ms in "
            f"{window.get('kernel_launches')} launches (unprofiled {prof['unprofiled_wall_ms']:.1f} ms)")
        for name, k in window.get("top_kernels", {}).items():
            log(f"  {k['ms']:.3f} ms = {k['launches']} x {k['us_per_launch']:.2f} us  {name}")
        # the stored bf16 rows against the card's own f32 run: the same
        # loaded weights under a provider that computes in f32
        f32fn = provider(ck, "float32", "cuda")
        f32fn.encoder._loaded = fn.encoder._loaded
        t = time.perf_counter()
        f32 = embed(f32fn, texts[:LOCAL_MISTRAL_BF16_TEXTS])
        res["f32_full_depth_s"] = time.perf_counter() - t
        bf = rows[:LOCAL_MISTRAL_BF16_TEXTS]
        res["bf16_max_abs_err"] = float(np.abs(bf - f32).max())
        res["bf16_min_cos"] = float((bf * f32).sum(axis=1).min())
        del f32fn
        t = time.perf_counter()
        cpu_thread.join()
        res["cpu_wait_s"] = time.perf_counter() - t
        if "error" in cpu_run:
            raise cpu_run["error"]
        families["cpu"] = cpu_run["families"]
        res["cpu_f32_s"] = cpu_run["s"]
        f32_cut = embed(provider(ck_cut, "float32", "cuda"), sample)
        res["f32_max_abs_err"] = float(np.abs(f32_cut - cpu_run["cut"]).max())
        log(f"e2e local_mistral: f32 on the card ({LOCAL_MISTRAL_CPU_LAYERS}-layer cut, "
            f"{LOCAL_MISTRAL_PARITY_TEXTS} texts) vs the CPU ({res['cpu_f32_s']:.1f} s beside the "
            f"write, {res['cpu_wait_s']:.1f} s waited for after it): max |err| "
            f"{res['f32_max_abs_err']:.3g} (tolerance {LOCAL_F32_ATOL}); the stored bf16 rows vs the "
            f"card's f32 run at {E5_MISTRAL['num_hidden_layers']} layers "
            f"({LOCAL_MISTRAL_BF16_TEXTS} texts, {res['f32_full_depth_s']:.1f} s): max |err| "
            f"{res['bf16_max_abs_err']:.3g} (tolerance {LOCAL_MISTRAL_BF16_ATOL}), min cosine "
            f"{res['bf16_min_cos']:.6f} (at least {LOCAL_MISTRAL_BF16_MIN_COS})")
        if res["f32_max_abs_err"] > LOCAL_F32_ATOL:
            raise AssertionError("local_mistral: f32 on the card disagrees with the CPU")
        if (res["bf16_max_abs_err"] > LOCAL_MISTRAL_BF16_ATOL
                or res["bf16_min_cos"] < LOCAL_MISTRAL_BF16_MIN_COS):
            raise AssertionError("local_mistral: the stored bf16 rows disagree with f32")
        # then the retrieval kernels at d = 4,096 in situ: a B=64 call at
        # n=10 (the keyed v2 prescore #3 and the staged finish #2) and one
        # at n=100 (v1, #4) profiled together, the width hints cleared
        qs = passages(words, 64, SEED + 113, *LOCAL_MISTRAL_WORDS)

        def profile(kb):
            def calls():
                kb.engine._cand_hint.clear()
                kb.retrieve_batch(qs, 10)
                kb.retrieve_batch(qs, 100)

            res["profiled_B64_n100"] = device_idle_share(calls)
            # the store's device pack and these queries, for the kernels'
            # checks against their plain versions after the path
            corpus = kb.engine.corpus
            held.update(docs=corpus.data, scales=corpus.row_scales, n_valid=corpus.n_valid,
                        qv=torch.from_numpy(embed(fn, qs)).to(corpus.data.device),
                        c=kb.engine.candidate_count(10))

        query_provider_store(path, fn, rows, ids, shapes, query_texts, res, "local_mistral",
                             reopen=False, after=profile)
        prof = res["profiled_B64_n100"]
        window = prof["profile"]
        log(f"e2e local_mistral: profiled B=64 at n=10 and n=100 {window['wall_ms']:.2f} ms, kernels "
            f"{window.get('kernel_ms')} ms (idle share {window['idle_share']})")
        for name, k in window.get("top_kernels", {}).items():
            log(f"  {k['ms']:.3f} ms = {k['launches']} x {k['us_per_launch']:.2f} us  {name}")
        del fn
        gc.collect()
        torch.cuda.empty_cache()
        # the reopen with no function, on the 2-layer cut's own store
        small = work / "local_mistral_2l.sqlite"
        cut_res = res["cut_store"] = {}
        fn_cut = provider(ck_cut, "bfloat16", "cuda")
        small_texts = texts[:LOCAL_MISTRAL_REOPEN_DOCS]
        rows_cut, ids_cut, _ = write_provider_store(small, fn_cut, small_texts, cut_res,
                                                    "local_mistral_2l")

        def small_queries(b, n):
            own = list(range(0, 2 * b, 2))[: b // 2 + 1 if b > 1 else 1]
            fresh = passages(words, b - len(own), SEED + 127 + b, *LOCAL_MISTRAL_WORDS)
            return [small_texts[i] for i in own] + fresh, own

        query_provider_store(small, fn_cut, rows_cut, ids_cut, ((64, 10), (8, 10), (1, 10)),
                             small_queries, cut_res, "local_mistral_2l")

    held: dict = {}
    drive_path("local_mistral", [], run, out)
    counts = out["paths"]["local_mistral"]["launches"]
    launched = {k: counts[k] for k in ("_staged_finish", "_fused2_extract_int8", "_fused_extract_int8")}
    res["hand_kernel_launches"] = launched
    if not any(launched.values()):
        raise AssertionError(f"local_mistral: none of #2, #3, #4 launched: {launched}")
    log(f"e2e local_mistral: #3, #2 and #4 on the store's pack against their plain versions "
        f"(B={held['qv'].shape[0]}, C={held['c']} at n=10)")
    pack_kernel_checks("local_mistral", held["docs"], held["scales"], held["qv"],
                       held["n_valid"], held["c"], out)
    del held
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(ck_cut, ignore_errors=True)
    torch.cuda.empty_cache()
    return families


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=2, help="calls per shape and path")
    ap.add_argument("--kernel-reps", type=int, default=KERNEL_REPS,
                    help="launches per timed window of a kernel or library "
                    "call (a plain version takes a quarter, at least 3)")
    ap.add_argument("--skip-e2e", action="store_true", help="kernel phase only")
    # one child of the multihost phase (the smoke starts them itself)
    ap.add_argument("--multihost-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mh-task", choices=("retrieve", "pairs"), help=argparse.SUPPRESS)
    ap.add_argument("--mh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mh-store", help=argparse.SUPPRESS)
    ap.add_argument("--mh-coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--mh-backend", choices=("gloo", "nccl"), help=argparse.SUPPRESS)
    ap.add_argument("--mh-device", help=argparse.SUPPRESS)
    ap.add_argument("--mh-work", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.multihost_child:
        return multihost_child(args)

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
    # no background dispatch probes outside the calibration phase (they
    # would add launches to the phases whose counts are asserted), and a
    # calibration cache of the run's own: no winner kept from another run
    os.environ["SVS_TPU_AUTOCALIB"] = "0"
    os.environ["SVS_TPU_CALIB_CACHE"] = str(work / "calibration" / "dispatch.json")
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
            e2e = e2e_phase(args.docs, args.reps, work, cross)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    if e2e is not None:  # the kernels' checks on a path's own pack (local_mistral's)
        for name, recs in e2e.pop("kernel_records", {}).items():
            records[name].extend(recs)
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
            tops = prof.get("profile", {}).get("top_kernels", {})
            for kname, k in tops.items():
                for sym, rec_name in symbols.items():
                    if f"{sym}(" in kname:
                        ev = [r["ms"] * 1e3 for r in records[rec_name] if "pair" in r["what"]]
                        log(f"{label}: {sym} {k['us_per_launch']:.2f} us per launch in "
                            f"situ ({k['launches']} launches), {ev[0]:.2f} us in the "
                            f"event-timed run of launches")
        e2e["seconds_total"] = time.perf_counter() - t_start
        print(json.dumps({"e2e": e2e}))
        single = e2e["paths_detail_serve"]["single"]
        print(f"serve: {single['requests']} single /retrieve (n=100) from "
              f"{single['clients']} client threads: p50 {single['p50_ms']:.2f} ms, "
              f"p99 {single['p99_ms']:.2f} ms, {single['requests_per_s']:.1f} req/s, "
              f"avg_batch {single['server']['avg_batch']:.2f}; {card}")
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
