"""RetrievalEngine: owns the device-resident corpus and runs searches
(port of ``svs_tpu.engine.index`` — the single-device retrieval ladder).

- **freshness** — the pack is keyed by the store's ``matrix_version`` plus
  SQLite's ``data_version`` (an O(1) token per query) and, when the token
  moves, the ``(version, count, max id, generation)`` fingerprint of the
  embeddings table; a pack is reused while it matches, else repacked in
  the reference's order: an incremental append (only the new rows are
  fetched and written into the pack's padding), an incremental delete
  (tail rows move into the deleted slots), a current ``<db>.svsx``
  sidecar, and last a full BLOB scan.  The device mirrors follow an
  incremental repack on the card (the appended rows concatenate onto the
  f32 mirror; a delete re-points its row map);
- **search dispatch** — the prescore ladder of the reference for int8,
  bf16 and f32 storage: guarded v3, keyed v2, v1, the two-pass extraction
  (batches above 256), then the plain exact scan, each proposing C
  candidates plus a boundary bound;
- **final selection** — gather the candidates' exact f32 rows from the
  device mirror, f32 dots, and the reference tie rule, emitting one
  ``[B, 2n + 1]`` int32 wire per batch; without a mirror
  (``device_rescore='host'``, a corpus over
  ``SVS_TPU_DEVICE_RESCORE_MAX_BYTES``, or a gather over
  ``_DEVICE_GATHER_MAX_BYTES``) :meth:`RetrievalEngine.topk_with_rescore`
  returns the prescored candidates and the KB rescores them on the host;
- **candidate sizing** — the width hints of the widen-and-retry loops;
- **pairwise** — the top pairs of the corpus (keyed candidates or the
  exact blocked pass, ``ops.pairwise``), their bound ``pairwise_eps`` and
  the f32 pair rescore from the device mirror;
- **metadata filters** — the pre-filter route of a selective filter
  (:meth:`RetrievalEngine.subset_topk`: the matching rows' exact f32
  scores from the device mirror or the host cache) and the derived corpus
  of filtered pairwise (:meth:`RetrievalEngine.subset_pairwise_corpus`).

- **cold start** — a pack of ``DEFER_MIN_BYTES`` and more whose host f32
  rows are kept (a rescan, or a sidecar with its f32 sections) publishes
  with its host arrays and uploads in a background thread
  (:meth:`RetrievalEngine._spawn_pack_upload`), and an f32 mirror past
  ``_MIRROR_SYNC_MAX_BYTES`` uploads in another; both stage through
  pinned buffers on an uploader stream and yield to live queries between
  chunks.  Every device entry point waits for the pack; a failed upload
  leaves the host arrays (moved to the device per call) or the host
  rescore, each counted in :meth:`RetrievalEngine.dispatch_stats`;
- **host route** — :meth:`RetrievalEngine.host_route`: answer from the
  host f32 rows while the pack uploads (nothing is on the card yet) or
  when the caller forces it; with the pack on the card ``'auto'`` always
  takes the device (a deliberate difference from ``svs_tpu``, whose rule
  also weighs an estimated host scan against the device's round-trip
  floor); :meth:`RetrievalEngine.host_topk_exact` is a NumPy scan or the
  native int8 two-pass, with the reference's tie rule.

- **dispatch calibration** — the v2/v3 choice per shape class from a
  measured winner (``engine.calibrate``), the static prior until one is
  measured, sticky per engine.

- **meshes** — with ``mesh=`` the pack is split over a
  ``parallel.mesh.Mesh`` (rows over its ``data`` axis, the dim over a
  ``model`` axis) and every rung runs per shard (``parallel.sharded``):
  the prescore, the device rescore and the pre-filter route where the
  rows live, the pairwise pass as a ring (``parallel.pairwise_sharded``);
  no incremental repack, no deferred upload, no subset pairwise corpus,
  as in the reference.  Replicas are ``parallel.replicas.ReplicaEngine``.

Not ported, by decision: hedged fetches (``ROADMAP.md``).
"""

from __future__ import annotations

import functools
import hashlib
import logging
import os
import threading
import time
import weakref
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..store.db import Database
from ..ops.topk import (
    exact_f32,
    final_select_wire,
    gathered_dots,
    gathered_scores,
    unpack_rows_tail,
)
from . import packing as _packing
from .packing import (
    DIM_MULTIPLE,
    LARGE_ROW_MULTIPLE,
    ROW_MULTIPLE,
    PackedCorpus,
    _cast_padded,
    _grow_rows,
    _is_mmap_backed,
    _move_rows,
    pack_host,
    pad_queries,
    quantize_int8,
    rescore_cache_limit,
)
from .sidecar import (
    load_sidecar,
    save_sidecar,
    save_sidecar_arrays,
    sidecar_fingerprint,
)

if TYPE_CHECKING:
    from ..parallel.mesh import Mesh

log = logging.getLogger(__name__)

#: Initial candidate over-provisioning for the rescore stage (a starting
#: point: the margin check widens it whenever it cannot prove coverage).
CANDIDATE_MULTIPLIER = 4
CANDIDATE_MIN_EXTRA = 32

#: Corpora with at least this many padded rows switch the prescore wire
#: from indices-as-f32-values to the int32 layout.
WIDE_INDEX_MIN_ROWS = 1 << 24

#: Ceiling on the [B, C, d] f32 candidate gather of a device rescore; a
#: batch whose gather exceeds it is rescored on the host, as the
#: reference routes it.
_DEVICE_GATHER_MAX_BYTES = 4_000_000_000

#: Default ceiling on the f32 rescore mirror (bytes); env override
#: ``SVS_TPU_DEVICE_RESCORE_MAX_BYTES`` as in the reference.
_DEVICE_RESCORE_MAX_BYTES = 8_000_000_000

#: A sidecar's memory-mapped f32 cache up to this many bytes is copied into
#: RAM on load (env ``SVS_TPU_HOST_CACHE_RAM_MAX``, the reference's
#: default): the host rescore reads RAM faster than the mapping.
_HOST_CACHE_RAM_MAX = 256 * 1024 * 1024

#: f32 rescore mirrors up to this size upload synchronously inside
#: ``ensure_fresh``; larger ones upload in a background thread, and the
#: rescore reads the host rows until the mirror publishes.
_MIRROR_SYNC_MAX_BYTES = 32 * 1024 * 1024

#: Staged-copy granularity of a mirror upload.
_MIRROR_CHUNK_BYTES = 64 * 1024 * 1024

#: Ceiling on the ``[B, rows]`` f32 score matrix the host exact scan
#: materializes: its slab size.
_HOST_SCAN_MAX_SCORE_BYTES = 256 * 1024 * 1024

#: Rows of an unaligned host cache copied per block (:func:`_aligned_blocks`).
_UNALIGNED_CHUNK_BYTES = 64 * 1024 * 1024


def _aligned_blocks(hf: np.ndarray) -> "Iterator[Tuple[int, np.ndarray]]":
    """``(first row, rows)`` blocks of the host rows ``hf`` that are
    aligned arrays: ``hf`` itself when it is aligned, else aligned copies
    of ``_UNALIGNED_CHUNK_BYTES`` each.  A sidecar's memory-mapped f32
    section sits at an offset the format does not align: NumPy's product
    skips BLAS on it, and native code must not assume its float
    alignment."""
    if hf.flags.aligned:
        yield 0, hf
        return
    step = max(1, _UNALIGNED_CHUNK_BYTES // max(1, hf.shape[1] * 4))
    for lo in range(0, hf.shape[0], step):
        yield lo, np.array(hf[lo : lo + step], dtype=np.float32)


def _host_scores(hf: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Exact f32 scores ``[B, rows]`` of ``queries`` against the host rows
    ``hf``: a matvec for one query (the reference's accumulation), one
    GEMM for a batch, over :func:`_aligned_blocks` (each row's dot
    unchanged)."""

    def scores(rows: np.ndarray) -> np.ndarray:
        return (rows @ queries[0])[None, :] if len(queries) == 1 else queries @ rows.T

    if hf.flags.aligned:
        return scores(hf)
    out = np.empty((len(queries), hf.shape[0]), dtype=np.float32)
    for lo, block in _aligned_blocks(hf):
        out[:, lo : lo + len(block)] = scores(block)
    return out


class _MirrorUploadAborted(Exception):
    """Raised inside a background uploader when ``shutdown()`` asks it to
    stop mid-transfer, or when the corpus it uploads for is superseded."""


def _marks_inflight(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Bracket a device-touching engine method with the in-flight count
    and last-arrival time that the background uploaders yield to."""

    @functools.wraps(fn)
    def wrapper(self: Any, *args: Any, **kwargs: Any) -> Any:
        self._last_query_t = time.monotonic()
        with self._inflight_lock:
            self._inflight += 1
        try:
            return fn(self, *args, **kwargs)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
            self._last_query_t = time.monotonic()

    return wrapper


def _rescore_from_packed(
    packed: torch.Tensor,
    dev_f32: torch.Tensor,
    dev_map: Optional[torch.Tensor],
    queries: torch.Tensor,
    wide: bool,
    dim: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact f32 rescore chained onto the packed prescore wire (C
    candidates): gather the candidates' f32 rows from the mirror and take
    true-f32 dots (one ``bmm``, TF32 off).  Returns ``(rows int64 [B, C],
    exact f32 [B, C], boundary-prescore bits int32 [B, 1])``.

    The gather clamps candidate rows into the mirror, as the reference's
    gathers clamp: a starved guarded pool may name padding rows, and its
    bound is +inf then, so those rows never pass the margin check."""
    if dim is not None and dim != queries.shape[1]:
        queries = queries[:, :dim]
    rows, tail_bits = unpack_rows_tail(packed, packed.shape[1] // 2, wide)
    rows = rows.to(torch.int64)
    # an incremental delete leaves the map shorter than the mirror
    at = rows.clamp(0, (dev_f32 if dev_map is None else dev_map).shape[0] - 1)
    exact = gathered_dots(dev_f32, at if dev_map is None else dev_map[at], queries)
    return rows, exact, tail_bits


def _final_from_packed(
    packed: torch.Tensor,
    dev_f32: torch.Tensor,
    dev_map: Optional[torch.Tensor],
    dev_emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    wide: bool,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Exact rescore (:func:`_rescore_from_packed`) AND final top-k
    selection with the reference tie rule.  Returns the int32 wire
    ``[B, 2k + 1]``: top-k emb ids ++ top-k exact score bits ++
    boundary-prescore bits."""
    rows, exact, tail_bits = _rescore_from_packed(
        packed, dev_f32, dev_map, queries, wide, dim=dim
    )
    emb_of = dev_emb[rows.clamp(0, dev_emb.shape[0] - 1)]
    return final_select_wire(exact, emb_of, tail_bits, k)


def _subset_final(
    dev_f32: torch.Tensor,
    dev_map: Optional[torch.Tensor],
    rows: torch.Tensor,
    emb_of: torch.Tensor,
    n_live: int,
    queries: torch.Tensor,
    k: int,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Exact top-``k`` over an explicit row subset — the pre-filter route
    of selective metadata filters.  ``rows`` are int64 pack rows padded to
    a fixed width (padding repeats row 0), ``emb_of`` the matching int32
    emb ids, ``n_live`` the live prefix length.  The rows' f32 vectors are
    gathered from the mirror through its row map (mapped as
    :func:`_rescore_from_packed` maps them: an incremental delete leaves
    the map shorter than the mirror), one true-f32 ``[B, d] x [F, d]^T``
    product (TF32 off), the padding masked to ``-inf``, and the final
    tie-rule selection wire — exact by construction, so no margin proof
    and no widen loop."""
    if dim is not None and dim != queries.shape[1]:
        queries = queries[:, :dim]
    at = rows.clamp(0, (dev_f32 if dev_map is None else dev_map).shape[0] - 1)
    exact = gathered_scores(dev_f32, at if dev_map is None else dev_map[at], queries)
    live = torch.arange(rows.shape[0], device=rows.device)[None, :] < n_live
    exact = torch.where(live, exact, float("-inf"))
    emb_b = emb_of[None, :].expand(exact.shape[0], -1)
    tail = torch.zeros((exact.shape[0], 1), dtype=torch.int32, device=exact.device)
    return final_select_wire(exact, emb_b, tail, k)


def _subset_select_np(
    exact: np.ndarray, emb: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host top-``k`` of exact subset scores with the reference tie rule
    (descending score, equal scores break to the larger emb id) —
    boundary-tie safe: the argpartition prefilter keeps EVERY row tied
    with the k-th score, then the lexsort decides among them."""
    n_q, f = exact.shape
    k = min(int(k), f)
    out_emb = np.empty((n_q, k), dtype=np.int64)
    out_scores = np.empty((n_q, k), dtype=np.float32)
    for b in range(n_q):
        row = exact[b]
        if k < f:
            part = np.argpartition(row, f - k)[f - k :]
            boundary = row[part].min()
            cand = np.nonzero(row >= boundary)[0]
        else:
            cand = np.arange(f)
        order = np.lexsort((-emb[cand], -row[cand]))[:k]
        sel = cand[order]
        out_emb[b] = emb[sel]
        out_scores[b] = row[sel]
    return out_emb, out_scores


#: Host-route ceiling for the pre-filter subset dot (B * F * d mults):
#: past it the host would be slower than the post-filter device ladder,
#: so ``subset_topk`` declines and the caller widens.
_SUBSET_HOST_MAX_FLOPS = 2_000_000_000

#: Entries kept in the engine's device-side subset cache (rows + emb ids
#: per distinct filter); bounds the device memory held for dead corpora
#: and filters.
_SUBSET_DEV_CACHE_MAX = 16


def _pairwise_rescore_from_rows(
    dev_f32: torch.Tensor,
    dev_map: Optional[torch.Tensor],
    rows_a: torch.Tensor,
    rows_b: torch.Tensor,
) -> torch.Tensor:
    """Exact f32 scores of candidate PAIRS from the device rescore mirror:
    gather both rows of each pair and take true-f32 row . row dots (one
    batched product, TF32 off), so the host fetches C floats.  An f32
    pack is its own mirror at the padded width: zero padding columns add
    nothing to a row . row dot."""
    ga = rows_a if dev_map is None else dev_map[rows_a]
    gb = rows_b if dev_map is None else dev_map[rows_b]
    va = dev_f32[ga]  # [C, d]
    vb = dev_f32[gb]
    with exact_f32():
        return torch.bmm(va[:, None, :], vb[:, :, None])[:, 0, 0]


class RetrievalEngine:
    """Packs the corpus onto one CUDA device (or the CPU, for tests) and
    runs verified-exact cosine top-k."""

    #: First-try successes at a hinted width before probing one ladder
    #: step narrower (see :meth:`initial_candidates`).
    HINT_PROBE_STREAK = 64

    def __init__(
        self,
        precision: str = "auto",
        rescore: Optional[bool] = None,
        device: Union[str, torch.device, None] = None,
        kernel: str = "auto",
        device_rescore: str = "auto",
        mesh: Optional["Mesh"] = None,
        data_axis: str = "data",
        model_axis: Optional[str] = None,
    ) -> None:
        if precision not in ("auto", "f32", "bf16", "int8"):
            raise ValueError(f"unknown precision: {precision!r}")
        if device_rescore not in ("auto", "host"):
            raise ValueError(
                "device_rescore must be 'auto' or 'host'"
            )
        if kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown kernel: {kernel!r}")
        if kernel == "pallas" and precision == "int8":
            raise ValueError(
                "kernel='pallas' requires float storage (f32/bf16); int8 "
                "corpora use the exact int8 path — pass kernel='auto'"
            )
        if kernel == "pallas" and mesh is not None:
            raise ValueError(
                "kernel='pallas' is single-device; sharded meshes use the "
                "per-shard path — pass kernel='auto'"
            )
        #: The mesh a sharded corpus lives on (``parallel.mesh.Mesh``), or
        #: None; a mesh axis named 'model' shards the embedding dim.
        self.mesh = mesh
        if mesh is not None:
            if data_axis not in mesh.axis_names:
                raise ValueError(
                    f"mesh has axes {mesh.axis_names}, expected a {data_axis!r} axis"
                )
            if model_axis is None and "model" in mesh.axis_names:
                model_axis = "model"
        self.data_axis = data_axis
        self.model_axis = model_axis
        #: The reference's names: 'auto' takes the hand-written kernels
        #: where the shapes allow and the exact scan otherwise; 'xla' keeps
        #: every precision on the exact scan; 'pallas' takes the float
        #: kernels (float storage only).
        self.kernel = kernel
        self.device_rescore = device_rescore
        self.requested_precision = precision
        #: Exact f32 re-ranking of the candidates, on by default for every
        #: precision; ``rescore=False`` is the opt-out (raw prescore order).
        self.rescore = rescore if rescore is not None else True
        if precision == "auto":
            # the reference's rule: int8 under the verified rescore, bf16
            # where the int8 path does not apply (rescore off, the host
            # rescore, kernel='pallas', whose kernels are float-only, or a
            # dim-sharded mesh: per-row int8 scales need whole rows)
            precision = (
                "int8"
                if (
                    self.rescore
                    and device_rescore == "auto"
                    and kernel != "pallas"
                    and self.model_axis is None
                )
                else "bf16"
            )
        self.precision = precision
        #: The device of single-device work (uploads, merges, the final
        #: selection): the mesh's primary on a mesh engine.
        self.device = (
            mesh.primary if mesh is not None
            else torch.device("cuda" if device is None else device)
        )
        self._cand_hint: Dict[int, Tuple[int, int]] = {}
        self._pair_hint: Dict[int, Tuple[int, int]] = {}
        self._corpus: Optional[PackedCorpus] = None
        self._fingerprint: Optional[Tuple[int, int, int, int]] = None
        self._quick_token: Optional[Tuple[int, int]] = None
        #: How each :meth:`ensure_fresh` call was satisfied: ``reuse`` =
        #: token/fingerprint hit, ``append``/``delete`` = incremental
        #: repack, ``sidecar`` = mmap load, ``scan`` = full BLOB rescan.
        self.pack_events: Dict[str, int] = {
            "reuse": 0, "append": 0, "delete": 0, "sidecar": 0, "scan": 0,
        }
        #: Margin-check failures that widened the candidate set.
        self.widen_retries = 0
        #: Sidecar file the current pack was loaded from (its bytes are the
        #: pack's, so a write to that path is skipped).
        self._sidecar_source: Optional[Path] = None
        #: Background scan that attaches the f32 rescore cache to a pack
        #: loaded from a sidecar without one, and the fingerprint of its
        #: last spawn (one attempt per store state).
        self._cache_rebuild_thread: Optional[threading.Thread] = None
        self._cache_rebuild_fp: Optional[Tuple[int, int, int, int]] = None
        #: Device arrays of the pre-filter subsets, keyed by the filter's
        #: canonical string: ``(corpus, rows, emb ids, match-set digest)``.
        self._subset_dev: Dict[
            str, Tuple[PackedCorpus, torch.Tensor, torch.Tensor, bytes]
        ] = {}
        self._lock = threading.Lock()
        #: How the last full scan of ``ensure_fresh`` read the store
        #: (``Tx.last_scan``: ``native_parallel``, ``native`` or ``stream``),
        #: and its seconds: the scan (with ``Tx.last_scan_split``), then the
        #: pack (the host pass and, unless deferred, the upload).
        self.last_scan: Optional[str] = None
        self.last_scan_split: Optional[Dict[str, float]] = None

        #: Host dispatch: 'auto' answers from the host f32 rows only while
        #: the pack uploads, 'force' always, 'off' never (:meth:`host_route`).
        #: Env ``SVS_TPU_HOST_DISPATCH``.
        self.host_dispatch = os.environ.get("SVS_TPU_HOST_DISPATCH", "auto")
        if self.host_dispatch not in ("auto", "off", "force"):
            log.warning(
                "ignoring SVS_TPU_HOST_DISPATCH=%r (want auto/off/force)",
                self.host_dispatch,
            )
            self.host_dispatch = "auto"
        #: Background builder of large host int8 prescore arrays.
        self._host_i8_thread: Optional[threading.Thread] = None
        #: Background uploaders of a deferred pack and of a large f32
        #: mirror, and (weakly) the corpus each serves; spawn bookkeeping
        #: under ``_mirror_lock``.
        self._pack_thread: Optional[threading.Thread] = None
        self._mirror_thread: Optional[threading.Thread] = None
        self._pack_thread_corpus: Callable[[], Optional[PackedCorpus]] = lambda: None
        self._mirror_thread_corpus: Callable[[], Optional[PackedCorpus]] = lambda: None
        self._mirror_lock = threading.Lock()
        #: Last query arrival and in-flight count (the uploaders yield to
        #: them), and the threads blocked on a deferred pack (the pack
        #: uploader stops yielding while one waits).
        self._last_query_t = 0.0
        self._inflight = 0
        self._pack_waiters = 0
        self._inflight_lock = threading.Lock()
        #: Set by ``shutdown()``: aborts a background upload; each uploader
        #: captures the event current at its spawn.
        self._mirror_stop = threading.Event()
        #: Uploads that failed: a pack left on the host (moved to the
        #: device per call), a mirror left to the host rescore.
        self.pack_upload_failures = 0
        self.mirror_upload_failures = 0
        #: v2/v3 decisions by calibration key, fixed at their first use
        #: (a probe that lands later changes only later engines), and the
        #: probe threads this engine spawned.
        self._calib_sticky: Dict[str, str] = {}
        self._calib_lock = threading.Lock()
        self._probe_threads: list = []

    def shutdown(self) -> None:
        """Abort and join the background uploads and builders (a
        thread caught mid-device-call at interpreter exit can abort the
        process).  The engine can be used again afterwards: a fresh stop
        event re-arms future uploads, while a straggler keeps the old,
        set one it captured."""
        self._mirror_stop.set()
        for attr in (
            "_pack_thread", "_mirror_thread", "_host_i8_thread",
            "_cache_rebuild_thread",
        ):
            t = getattr(self, attr)
            if t is not None and t.is_alive():
                t.join(timeout=30.0)
            setattr(self, attr, None)
        self.join_dispatch_probes(timeout=30.0)
        self._mirror_stop = threading.Event()

    def invalidate(self) -> None:
        with self._lock:
            self._corpus = None
            self._fingerprint = None
            self._quick_token = None
            self._sidecar_source = None

    @property
    def corpus(self) -> Optional[PackedCorpus]:
        return self._corpus

    def _row_multiple(self, n_rows: int) -> int:
        """Large corpora align to the fused kernels' block multiple; on a
        mesh every shard does (the multiple times the data shards)."""
        base = LARGE_ROW_MULTIPLE if n_rows >= LARGE_ROW_MULTIPLE else ROW_MULTIPLE
        return base * self._shards(self.data_axis)

    def _dim_multiple(self) -> int:
        return DIM_MULTIPLE * self._shards(self.model_axis)

    def _shards(self, axis: Optional[str]) -> int:
        """Shards along a mesh ``axis`` (1 without a mesh or an axis)."""
        if self.mesh is None or axis is None:
            return 1
        return int(self.mesh.shape[axis])

    @staticmethod
    def _store_fingerprint(db: Database) -> Tuple[int, int, int, int]:
        with db.transaction() as tx:
            version = tx.matrix_version()
            count, max_id, generation = tx.embeddings_fingerprint()
        return (version, count, max_id, generation)

    @_marks_inflight
    def ensure_fresh(
        self,
        db: Database,
        sidecar_path: Union[str, Path, None] = None,
    ) -> PackedCorpus:
        """Return a corpus reflecting the store's current embeddings,
        repacking if stale: incrementally after a pure append or a pure
        delete, from the sidecar at ``sidecar_path`` when it is current,
        else from a full BLOB scan.  A large sidecar or scan pack may
        return before its upload (see the module docstring).  The caller
        serializes store access (the KB holds its lock around this)."""
        with db.transaction() as tx:
            quick = (tx.matrix_version(), tx.data_version())
        with self._lock:
            if self._corpus is not None and self._quick_token == quick:
                self.pack_events["reuse"] += 1
                self._maybe_respawn_cache_rebuild(db)
                # the host cache may have attached late (background rebuild)
                self._maybe_build_device_rescore(self._corpus)
                return self._corpus
        fingerprint = self._store_fingerprint(db)
        with self._lock:
            if self._corpus is not None and self._fingerprint == fingerprint:
                # a write that did not touch the embeddings (meta, KV)
                self._quick_token = quick
                self.pack_events["reuse"] += 1
                self._maybe_respawn_cache_rebuild(db)
                return self._corpus
            corpus = self._try_incremental_append(db, fingerprint)
            if corpus is not None:
                self.pack_events["append"] += 1
            if corpus is None:
                corpus = self._try_incremental_delete(db, fingerprint)
                if corpus is not None:
                    self.pack_events["delete"] += 1
            if corpus is None and sidecar_path is not None:
                corpus = self._try_sidecar(sidecar_path, fingerprint)
                if corpus is not None:
                    self.pack_events["sidecar"] += 1
                    self._spawn_rescore_cache_rebuild(db.path, corpus, fingerprint)
            if corpus is None:
                self.pack_events["scan"] += 1
                log.info("packing corpus from store (fingerprint %s)", fingerprint)
                self._sidecar_source = None
                t0 = time.perf_counter()
                with db.transaction() as tx:
                    matrix, emb_ids = tx.build_embeddings_matrix()
                    self.last_scan = tx.last_scan
                t1 = time.perf_counter()
                corpus = self._pack(matrix, emb_ids, fingerprint[0])
                self.last_scan_split = {
                    "scan_s": t1 - t0,
                    **(tx.last_scan_split or {}),
                    "pack_s": time.perf_counter() - t1,
                }
            self._corpus = corpus
            self._fingerprint = fingerprint
            self._quick_token = quick
            if not corpus.device_ready:
                # spawned after the install: the uploader of a pack this one
                # superseded aborts at its next chunk
                self._spawn_pack_upload(corpus)
            self._maybe_build_device_rescore(corpus)
            return corpus

    def _mirror_allowed(
        self, precision: str, cache: Optional[np.ndarray], n: int
    ) -> bool:
        """The device-mirror policy: only under the device rescore and for
        a non-empty pack; an f32 pack is its own mirror (no second copy, no
        budget), else the host cache within
        ``SVS_TPU_DEVICE_RESCORE_MAX_BYTES``."""
        from ..utils.env import env_int

        budget = env_int(
            "SVS_TPU_DEVICE_RESCORE_MAX_BYTES", _DEVICE_RESCORE_MAX_BYTES
        )
        return (
            self.rescore
            and self.device_rescore != "host"
            and budget > 0
            and n > 0
            and (precision == "f32" or (cache is not None and cache.nbytes <= budget))
        )

    def _pack(
        self, matrix: np.ndarray, emb_ids: np.ndarray, version: int
    ) -> PackedCorpus:
        data, scales, ids, cache, row_map, n, d = pack_host(
            matrix,
            emb_ids,
            self.precision,
            row_multiple=self._row_multiple(matrix.shape[0]),
            dim_multiple=self._dim_multiple(),
        )
        # the host f32 cache within SVS_TPU_RESCORE_CACHE_MAX_BYTES (past
        # it the host rescore reads rows from the store)
        if cache.nbytes > rescore_cache_limit():
            cache = row_map = None
        return self._new_pack(data, scales, ids, n, d, version, cache, row_map)

    def _new_pack(
        self,
        data: np.ndarray,
        scales: Optional[np.ndarray],
        emb_ids: np.ndarray,
        n: int,
        d: int,
        version: int,
        cache: Optional[np.ndarray],
        row_map: Optional[np.ndarray],
    ) -> PackedCorpus:
        """A corpus of the host pack: deferred (its host arrays, the upload
        left to ``ensure_fresh``'s :meth:`_spawn_pack_upload`) when host f32
        rows can answer meanwhile and the pack reaches ``DEFER_MIN_BYTES``,
        else uploaded now.  The mirrors follow in
        :meth:`_maybe_build_device_rescore`."""
        from ..convert import packed_from_numpy

        scale_max = float(np.max(scales[:n])) if scales is not None and n > 0 else 0.0
        if self.mesh is not None:
            return self._new_mesh_pack(data, scales, emb_ids, n, d, version, scale_max,
                                       cache, row_map)
        if cache is None or data.nbytes < _packing.DEFER_MIN_BYTES:
            return packed_from_numpy(
                data, scales, emb_ids, n, d, version, self.precision, scale_max,
                cache, row_map, self.device, mirror=False,
            )
        return PackedCorpus(
            data=data,
            row_scales=scales,
            emb_ids=np.asarray(emb_ids, dtype=np.int64),
            n_valid=n,
            dim=d,
            version=int(version),
            precision=self.precision,
            scale_max=scale_max,
            host_cache=(np.asarray(cache, dtype=np.float32), row_map),
            _device_ready=threading.Event(),
        )

    def _new_mesh_pack(
        self,
        data: np.ndarray,
        scales: Optional[np.ndarray],
        emb_ids: np.ndarray,
        n: int,
        d: int,
        version: int,
        scale_max: float,
        cache: Optional[np.ndarray],
        row_map: Optional[np.ndarray],
    ) -> PackedCorpus:
        """A mesh pack: each shard uploads from the host pack straight to
        its device (``parallel.mesh.place``), never deferred (as the
        reference's mesh packs)."""
        from ..parallel.mesh import place

        assert self.mesh is not None
        log.info(
            "placing pack on the mesh %s (%.2f GB)", self.mesh.shape, data.nbytes / 1e9
        )
        return PackedCorpus(
            data=place(data, self.mesh, self.data_axis, self.model_axis,
                       bf16=self.precision == "bf16"),
            row_scales=(
                None if scales is None
                else place(np.asarray(scales, dtype=np.float32), self.mesh, self.data_axis)
            ),
            emb_ids=np.asarray(emb_ids, dtype=np.int64),
            n_valid=n,
            dim=d,
            version=int(version),
            precision=self.precision,
            scale_max=scale_max,
            host_cache=(
                None if cache is None else (np.asarray(cache, dtype=np.float32), row_map)
            ),
        )

    def _try_incremental_append(
        self, db: Database, fingerprint: Tuple[int, int, int, int]
    ) -> Optional[PackedCorpus]:
        """Append-only fast path (the reference's gates): when the only
        change since the last pack is new embeddings, fetch just those rows
        and write them at the pack's end, growing it to the next row
        multiple when they pass its padding, instead of rescanning every
        BLOB.  The host f32 cache grows by the same rows; the device mirror
        is the old one with the new rows' upload concatenated.  Skipped on
        a mesh (growing a sharded pack would move every shard boundary)."""
        from ..convert import emb_mirror

        old = self._corpus
        if old is None or self._fingerprint is None or self.mesh is not None:
            return None
        if old.n_valid == 0:
            # an empty pack has no established dim: a full pack instead
            return None
        _, old_count, old_max, old_gen = self._fingerprint
        _, new_count, new_max, new_gen = fingerprint
        added = new_count - old_count
        if added <= 0 or added != new_max - old_max or old.n_valid != old_count:
            return None
        # the generation counts every embeddings-table write: pure appends
        # move it by exactly `added`, a delete+insert or an UPDATE further
        if new_gen - old_gen != added:
            return None
        with db.transaction() as tx:
            new_rows, new_ids = tx.fetch_embeddings_after(old_max)
        if new_rows.shape[0] != added or new_rows.shape[1] != old.dim:
            return None
        log.info("incremental append: +%d docs (no full repack)", added)
        old_data, old_scales = self._pack_arrays(old)  # a deferred upload lands first
        n0, n1 = old.n_valid, old.n_valid + added
        grow = self._row_multiple(n1)
        dev = old_data.device
        scales_new = None
        scale_max = old.scale_max
        if old.precision == "int8":
            q_new, s_new = quantize_int8(new_rows, added, old.dim_padded)
            data_new = _grow_rows(old_data, torch.from_numpy(q_new).to(dev), n0, grow)
            scales_new = _grow_rows(
                old_scales, torch.from_numpy(s_new).to(dev), n0, grow
            )
            scale_max = max(scale_max, float(np.max(s_new)))
        else:
            from ..convert import _upload_data

            padded = _cast_padded(new_rows, added, old.dim_padded, old.precision)
            data_new = _grow_rows(
                old_data, _upload_data(padded, old.precision, dev), n0, grow
            )
        self._sidecar_source = None

        host_cache = None
        old_cache = old.host_cache  # one read: (f32, row_map) or None
        if old_cache is not None and (
            (len(old_cache[0]) + added) * old.dim * 4 <= rescore_cache_limit()
        ):
            # appended pack rows land at the cache's end in both layouts
            old_f32, old_map = old_cache
            host_f32 = np.concatenate(
                [old_f32, new_rows.astype(np.float32, copy=False)]
            )
            host_map = None
            if old_map is not None:
                host_map = np.concatenate(
                    [old_map, np.arange(len(old_f32), len(host_f32), dtype=np.int64)]
                )
            host_cache = (host_f32, host_map)
        emb_ids = np.concatenate([old.emb_ids, new_ids])
        # the mirror follows on the card: an f32 pack is its own; else the
        # old f32 mirror with the new rows' upload concatenated, unless the
        # grown cache passes a ceiling (the reference then has none either)
        dev_rescore = None
        if old.dev_rescore is not None and self._mirror_allowed(
            old.precision, host_cache[0] if host_cache is not None else None, n1
        ):
            if old.precision == "f32":
                dev_rescore = (data_new, None)
            elif host_cache is not None:
                host_f32, host_map = host_cache
                new_f32 = torch.from_numpy(host_f32[-added:]).to(dev)
                dev_rescore = (
                    torch.cat([old.dev_rescore[0], new_f32]),
                    None if host_map is None else torch.from_numpy(host_map).to(dev),
                )
        return PackedCorpus(
            data=data_new,
            row_scales=scales_new,
            emb_ids=emb_ids,
            n_valid=n1,
            dim=old.dim,
            version=fingerprint[0],
            precision=old.precision,
            scale_max=scale_max,
            host_cache=host_cache,
            dev_rescore=dev_rescore,
            dev_emb=None if dev_rescore is None else emb_mirror(emb_ids, n1, dev),
        )

    def _try_incremental_delete(
        self, db: Database, fingerprint: Tuple[int, int, int, int]
    ) -> Optional[PackedCorpus]:
        """Delete-only fast path (the reference's gates): when the only
        change since the last pack is removed embeddings (count down and
        generation up by exactly ``removed``, the survivors a subset of the
        pack), compact the pack: live rows from the tail move into the
        deleted slots and ``n_valid`` shrinks.  The kernels mask by
        ``n_valid``, so the stale rows past it are never scored.  Declined
        when at least half the pack died (a repack reclaims the buffer) or
        when nothing survives.

        The f32 cache rows never move (they may be a read-only sidecar
        mapping): the cache's row map is re-pointed, and made explicit.
        On the device the f32 mirror stays and only its map is replaced.
        Skipped on a mesh, as the reference skips it."""
        from ..convert import emb_mirror

        old = self._corpus
        if old is None or self._fingerprint is None or self.mesh is not None:
            return None
        if old.n_valid == 0:
            return None
        _, old_count, old_max, old_gen = self._fingerprint
        _, new_count, new_max, new_gen = fingerprint
        removed = old_count - new_count
        if removed <= 0 or new_count <= 0 or old.n_valid != old_count:
            return None
        # pure deletes move the generation by exactly `removed`; any insert
        # or update moves it further
        if new_gen - old_gen != removed or new_max > old_max:
            return None
        if removed * 2 >= old_count:
            return None  # bulk wipe: repack to reclaim the buffer
        with db.transaction() as tx:
            cur_ids = tx.embedding_ids()
        if cur_ids.shape[0] != new_count:
            return None  # raced a foreign writer; the fingerprint is stale
        keep = np.isin(old.emb_ids, cur_ids, assume_unique=True)
        if int(keep.sum()) != new_count:
            return None  # survivors not a subset of the pack
        old_n, new_n = old.n_valid, new_count
        dead = np.flatnonzero(~keep)
        dead_below = dead[dead < new_n]
        live_tail = new_n + np.flatnonzero(keep[new_n:])
        log.info(
            "incremental delete: -%d docs (no full repack; %d rows moved)",
            removed, int(dead_below.size),
        )
        emb_ids = old.emb_ids.copy()
        emb_ids[dead_below] = emb_ids[live_tail]
        emb_ids = emb_ids[:new_n]
        data_new, scales_new = self._pack_arrays(old)  # a deferred upload lands first
        dev = data_new.device
        if dead_below.size:
            src = torch.from_numpy(live_tail).to(dev)
            dst = torch.from_numpy(dead_below).to(dev)
            data_new = _move_rows(data_new, src, dst)
            if scales_new is not None:
                scales_new = _move_rows(scales_new, src, dst)
        # else a pure tail delete: nothing moves, only the mask boundary

        host_cache = None
        old_cache = old.host_cache  # one read: (f32, row_map) or None
        if old_cache is not None:
            cache_f32, old_map = old_cache
            # explicit afterwards: a later append concatenates cache rows
            # at the end and reads a None map as "cache row i = pack row i"
            base = old_map if old_map is not None else np.arange(old_n, dtype=np.int64)
            new_map = base[:old_n].copy()
            new_map[dead_below] = base[live_tail]
            host_cache = (cache_f32, new_map[:new_n])
        self._sidecar_source = None
        dev_rescore = None
        if old.dev_rescore is not None:
            if old.precision == "f32":
                dev_rescore = (data_new, None)
            elif host_cache is not None:
                dev_rescore = (
                    old.dev_rescore[0], torch.from_numpy(host_cache[1]).to(dev)
                )
        return PackedCorpus(
            data=data_new,
            row_scales=scales_new,
            emb_ids=emb_ids,
            n_valid=new_n,
            dim=old.dim,
            version=fingerprint[0],
            precision=old.precision,
            scale_max=old.scale_max,  # still an upper bound for survivors
            host_cache=host_cache,
            dev_rescore=dev_rescore,
            dev_emb=None if dev_rescore is None else emb_mirror(emb_ids, new_n, dev),
        )

    def _maybe_respawn_cache_rebuild(self, db: Database) -> None:
        """A live pack can lack its f32 rescore cache (a sidecar without
        one, a rebuild that found the store moved): re-attempt the
        background rebuild once per store state while queries flow.
        Caller holds the engine lock."""
        corpus, fp = self._corpus, self._fingerprint
        if (
            corpus is None
            or fp is None
            or corpus.host_f32 is not None
            or not self.rescore
            or fp == self._cache_rebuild_fp
        ):
            return
        t = self._cache_rebuild_thread
        if t is not None and t.is_alive():
            return
        self._spawn_rescore_cache_rebuild(db.path, corpus, fp)

    def _spawn_rescore_cache_rebuild(
        self,
        db_path: Union[str, Path],
        corpus: PackedCorpus,
        fingerprint: Tuple[int, int, int, int],
    ) -> None:
        """A pack loaded from a sidecar without the f32 sections has no
        rescore cache, so its rescores read SQLite.  Rebuild the cache from
        a background scan (one transaction, on a connection of its own)
        and attach it to the live corpus only while the store still has
        the pack's fingerprint and the ids agree; the next reuse then
        builds the device mirror."""
        if (
            not self.rescore
            or corpus.host_f32 is not None
            or corpus.n_valid == 0
            or corpus.n_valid * corpus.dim * 4 > rescore_cache_limit()
        ):
            return

        def work() -> None:
            try:
                db2 = Database(db_path)
                try:
                    with db2.transaction() as tx:
                        version = tx.matrix_version()
                        count, max_id, generation = tx.embeddings_fingerprint()
                        if (version, count, max_id, generation) != fingerprint:
                            return
                        matrix, ids = tx.build_embeddings_matrix()
                finally:
                    db2.close()
                row_map = np.searchsorted(ids, corpus.emb_ids).astype(np.int64)
                at = np.minimum(row_map, len(ids) - 1)
                if not np.array_equal(ids[at], corpus.emb_ids):
                    return  # ids diverged from the pack: never attach
                with self._lock:
                    if self._corpus is corpus:
                        # one store publishes the pair: no torn reads
                        object.__setattr__(corpus, "host_cache", (matrix, row_map))
                        log.info(
                            "rescore cache rebuilt in background (%d rows)",
                            matrix.shape[0],
                        )
            except Exception:
                log.warning("background rescore-cache rebuild failed", exc_info=True)

        self._cache_rebuild_fp = fingerprint
        t = threading.Thread(target=work, name="svs-tpu-rescore-cache", daemon=True)
        t.start()
        self._cache_rebuild_thread = t

    # -- deferred uploads and the device mirrors -------------------------------

    def _await_pack_device(self, corpus: PackedCorpus) -> None:
        """Block until a deferred pack is published, counted as a pack
        waiter so the uploader's throttle stops yielding (the waiter is
        often a query that is itself in flight)."""
        if corpus.device_ready:
            return
        with self._inflight_lock:
            self._pack_waiters += 1
        try:
            corpus.wait_device()
        finally:
            with self._inflight_lock:
                self._pack_waiters -= 1

    def _pack_arrays(
        self, corpus: PackedCorpus
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``corpus``'s packed matrix and row scales as tensors on the
        engine's device, for a device entry point: waits out a deferred
        upload first; after a failed one (the host arrays were published)
        moves them to the device for this call."""
        from ..convert import _upload_data, upload

        self._await_pack_device(corpus)
        data, scales = corpus.data, corpus.row_scales
        if self.mesh is not None:
            return data, scales  # shards placed on their devices, never deferred
        if not isinstance(data, torch.Tensor):
            data = _upload_data(data, corpus.precision, self.device)
        if scales is not None and not isinstance(scales, torch.Tensor):
            scales = upload(np.asarray(scales, dtype=np.float32), self.device)
        return data, scales

    def _upload_pack(
        self,
        host_data: np.ndarray,
        host_scales: Optional[np.ndarray],
        precision: str,
        throttle: Callable[[], None],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The host pack staged onto the engine's device (bf16 as its
        16-bit words, viewed as ``torch.bfloat16``)."""
        put = _packing.staged_device_put
        if precision == "bf16":
            data = put(np.asarray(host_data).view(np.int16), self.device, throttle=throttle)
            data = data.view(torch.bfloat16)
        else:
            data = put(np.asarray(host_data), self.device, throttle=throttle)
        scales = None
        if host_scales is not None:
            scales = put(np.asarray(host_scales, dtype=np.float32), self.device)
        return data, scales

    def _spawn_pack_upload(self, corpus: PackedCorpus) -> None:
        """Background uploader of a deferred pack: stage the host pack onto
        the device (yielding to live queries between chunks, at most 5 s
        a chunk), publish it on the corpus, then build the mirrors.  While
        it runs, :meth:`host_route` answers from the host f32 rows, and
        device entry points wait in :meth:`_await_pack_device`.

        Failures retry twice; a permanent failure publishes the HOST
        arrays, so waiters never hang: device entry points then move the
        pack to the device per call (:meth:`_pack_arrays`), logged and
        counted in ``pack_upload_failures``.  An upload whose corpus is no
        longer the engine's aborts at its next chunk and publishes its host
        arrays too (uncounted); the uploader of the newer corpus joins it
        first, so one upload runs at a time and none is skipped."""
        with self._mirror_lock:
            prev = self._pack_thread
            if prev is not None and prev.is_alive():
                if self._pack_thread_corpus() is corpus:
                    return
            else:
                prev = None
            stop = self._mirror_stop
            host_data, host_scales = corpus.data, corpus.row_scales

            def work() -> None:
                if prev is not None:
                    prev.join()
                published = False
                try:
                    throttle = functools.partial(
                        self._mirror_throttle, stop, 5.0, corpus
                    )
                    log.info(
                        "uploading pack to device in background (%.2f GB); "
                        "queries answer from the host rows meanwhile",
                        host_data.nbytes / 1e9,
                    )
                    for attempt in range(3):
                        try:
                            data, scales = self._upload_pack(
                                host_data, host_scales, corpus.precision, throttle
                            )
                            corpus.publish_device(data, scales)
                            published = True
                            log.info("pack live on device")
                            self._maybe_build_device_rescore(corpus)
                            return
                        except _MirrorUploadAborted:
                            log.info("pack upload stopped (shutdown or superseded)")
                            return
                        except Exception as exc:
                            if attempt == 2:
                                raise
                            log.warning("pack upload failed (%s); retrying", exc)
                            time.sleep(2.0 * (attempt + 1))
                except Exception:
                    self.pack_upload_failures += 1
                    log.warning(
                        "background pack upload failed permanently; device "
                        "calls will move the host pack per call",
                        exc_info=True,
                    )
                finally:
                    if not published:
                        corpus.publish_device(host_data, host_scales)

            t = threading.Thread(target=work, name="svs-tpu-pack-upload", daemon=True)
            t.start()
            self._pack_thread, self._pack_thread_corpus = t, weakref.ref(corpus)

    @property
    def pack_uploading(self) -> bool:
        """True while a deferred pack upload is in flight."""
        t = self._pack_thread
        return t is not None and t.is_alive()

    def _maybe_build_device_rescore(self, corpus: PackedCorpus) -> None:
        """Give ``corpus`` its device mirrors when it has none and the
        policy allows one (:meth:`_mirror_allowed`): an f32 pack is its own
        mirror; else the host f32 cache uploads, synchronously up to
        ``_MIRROR_SYNC_MAX_BYTES`` and in one background thread past it
        (the rescore reads the host rows until it publishes; a publish
        onto a superseded corpus is dropped).  A failed upload leaves the
        rescore on the host, logged and counted in
        ``mirror_upload_failures``.  Runs after a sidecar load without f32
        sections once the background rebuild attached the host cache, and
        after a deferred pack lands.  A corpus that is no longer the
        engine's gets none."""
        if (
            corpus.dev_rescore is not None
            or not corpus.device_ready
            or corpus is not self._corpus
        ):
            return
        cache = corpus.host_cache
        if not self._mirror_allowed(
            corpus.precision, cache[0] if cache is not None else None, corpus.n_valid
        ):
            return
        if self.mesh is not None:
            self._build_mesh_rescore(corpus)
            return
        if corpus.precision == "f32":
            if isinstance(corpus.data, torch.Tensor):  # else a failed upload
                self._publish_mirror(corpus, corpus.data, None)
            return
        assert cache is not None
        cache_f32, row_map = cache
        if cache_f32.nbytes <= _MIRROR_SYNC_MAX_BYTES:
            try:
                self._upload_and_publish_mirror(corpus, cache_f32, row_map)
            except Exception:
                self.mirror_upload_failures += 1
                log.warning(
                    "device rescore mirror upload failed; the rescore stays "
                    "on the host rows", exc_info=True,
                )
            return
        with self._mirror_lock:
            prev = self._mirror_thread
            if prev is not None and prev.is_alive():
                if self._mirror_thread_corpus() is corpus:
                    return
            else:
                prev = None
            # the stop event current at the spawn: shutdown() re-arms the
            # attribute after its join
            stop = self._mirror_stop

            def work() -> None:
                if prev is not None:
                    prev.join()  # a superseded corpus's upload aborts
                try:
                    self._upload_and_publish_mirror(corpus, cache_f32, row_map, stop)
                except Exception:
                    self.mirror_upload_failures += 1
                    log.warning(
                        "background mirror upload failed; the rescore stays "
                        "on the host rows", exc_info=True,
                    )

            t = threading.Thread(target=work, name="svs-tpu-mirror-upload", daemon=True)
            t.start()
            self._mirror_thread, self._mirror_thread_corpus = t, weakref.ref(corpus)

    def _build_mesh_rescore(self, corpus: PackedCorpus) -> None:
        """The mesh's mirrors, synchronously: the f32 rows in pack-row
        order, padded to ``n_padded`` and split like the pack's rows (each
        shard's rows made on the host and uploaded to its device), an f32
        pack its own; and the ``[n_padded]`` int32 emb-id mirror on the
        primary.  Each shard then rescores the merged candidates in its
        row range (``parallel.sharded.sharded_rescore_final``).  None on
        a dim-sharded mesh (a shard holds partial rows: the rescore stays
        on the host) or with an emb id past int32."""
        from ..parallel.mesh import place_rows

        assert self.mesh is not None
        if self.model_axis is not None or not corpus.emb_ids_fit_int32():
            return
        n_pad, n_valid = corpus.n_padded, corpus.n_valid
        if corpus.precision == "f32":
            dev = corpus.data
        else:
            assert corpus.host_cache is not None
            cache_f32, row_map = corpus.host_cache
            d = corpus.dim

            def shard_rows(r0: int, r1: int) -> np.ndarray:
                out = np.zeros((r1 - r0, d), dtype=np.float32)
                hi = min(r1, n_valid)
                if hi > r0:
                    rows = np.arange(r0, hi)
                    out[: hi - r0] = cache_f32[rows if row_map is None else row_map[rows]]
                return out

            log.info(
                "uploading sharded f32 rescore mirror (%.2f GB over %d shards)",
                n_pad * d * 4 / 1e9, self._shards(self.data_axis),
            )
            dev = place_rows((n_pad, d), np.float32, shard_rows, self.mesh, self.data_axis)
        emb_pad = np.zeros(n_pad, dtype=np.int32)
        emb_pad[:n_valid] = corpus.emb_ids.astype(np.int32)
        # the emb-id mirror first: a reader that sees dev_rescore reads it
        object.__setattr__(corpus, "dev_emb", torch.from_numpy(emb_pad).to(self.device))
        object.__setattr__(corpus, "dev_rescore", (dev, None))

    def _upload_and_publish_mirror(
        self,
        corpus: PackedCorpus,
        cache_f32: np.ndarray,
        row_map: Optional[np.ndarray],
        stop: Optional[threading.Event] = None,
    ) -> None:
        """Upload the f32 mirror and its row map, and publish both on
        ``corpus``.  The background path passes ``stop``, the shutdown
        event captured at its spawn: its upload yields to live queries,
        stops once ``stop`` is set or ``corpus`` is superseded, and it
        publishes under the engine lock and only onto the engine's current
        corpus."""
        from ..convert import upload

        log.info(
            "uploading f32 rescore mirror to device (%.2f GB)", cache_f32.nbytes / 1e9
        )
        try:
            dev = self._upload_f32_mirror(cache_f32, stop, corpus)
        except _MirrorUploadAborted:
            log.info("mirror upload stopped (shutdown or superseded)")
            return
        dev_map = (
            upload(np.asarray(row_map, dtype=np.int64), self.device)
            if row_map is not None
            else None
        )
        if stop is not None:
            with self._lock:
                if self._corpus is not corpus or corpus.dev_rescore is not None:
                    return
                self._publish_mirror(corpus, dev, dev_map)
            log.info("f32 rescore mirror live on device")
            return
        self._publish_mirror(corpus, dev, dev_map)

    def _publish_mirror(
        self,
        corpus: PackedCorpus,
        dev: torch.Tensor,
        dev_map: Optional[torch.Tensor],
    ) -> None:
        """The emb-id mirror first: a reader that sees ``dev_rescore``
        reads ``dev_emb`` without re-checking."""
        from ..convert import emb_mirror

        object.__setattr__(
            corpus, "dev_emb", emb_mirror(corpus.emb_ids, corpus.n_valid, dev.device)
        )
        object.__setattr__(corpus, "dev_rescore", (dev, dev_map))

    def _upload_f32_mirror(
        self,
        cache_f32: np.ndarray,
        stop: Optional[threading.Event] = None,
        corpus: Optional[PackedCorpus] = None,
    ) -> torch.Tensor:
        """Stage the f32 rows onto the device in ``_MIRROR_CHUNK_BYTES``
        chunks (:func:`packing.staged_device_put`); a background upload
        (``stop`` given) yields to live queries between chunks, for
        ``corpus`` while it stays the engine's."""
        throttle = (
            None
            if stop is None
            else functools.partial(self._mirror_throttle, stop, 60.0, corpus)
        )
        return _packing.staged_device_put(
            np.asarray(cache_f32, dtype=np.float32),
            self.device,
            chunk_bytes=_MIRROR_CHUNK_BYTES,
            throttle=throttle,
        )

    @property
    def mirror_uploading(self) -> bool:
        """True while a background f32 mirror upload is in flight."""
        t = self._mirror_thread
        return t is not None and t.is_alive()

    def wait_for_mirror(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine reaches its steady state: the deferred
        pack upload, the background rescore-cache rebuild and the mirror
        upload have finished, including uploads those stages spawn when
        they land (the cache rebuild is what makes a mirror possible).
        False when ``timeout`` passed first, or when background work kept
        respawning past 8 passes (a fast-failing upload cycle): either
        way not settled, and the caller reads the corpus's state."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def join(t: Optional[threading.Thread]) -> bool:
            if t is None:
                return True
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(left)
            return not t.is_alive()

        spins = 0
        while True:
            spins += 1
            if spins > 8:
                return False
            if not join(self._pack_thread):
                return False
            if not join(self._cache_rebuild_thread):
                return False
            corpus = self._corpus
            if corpus is not None and corpus.device_ready:
                # the cache may have attached after the pack's own kick
                self._maybe_build_device_rescore(corpus)
            if not join(self._mirror_thread):
                return False
            threads = (
                self._pack_thread, self._cache_rebuild_thread, self._mirror_thread,
            )
            if all(t is None or not t.is_alive() for t in threads):
                # with no uploader left, an unpublished pack is not settled
                current = self._corpus
                return current is None or current.device_ready
            if deadline is not None and time.monotonic() >= deadline:
                return False

    def _mirror_throttle(
        self,
        stop: threading.Event,
        max_defer: float = 60.0,
        corpus: Optional[PackedCorpus] = None,
    ) -> None:
        """Called before each background-upload chunk: wait until no query
        is in flight and arrivals have left a 250 ms gap, but never past
        ``max_defer`` seconds a chunk, and not at all while a thread waits
        on the pack (yielding to it would be a priority inversion).
        Raises :class:`_MirrorUploadAborted` once ``stop`` is set, or once
        ``corpus`` (when given) is no longer the engine's."""
        deadline = time.monotonic() + max_defer
        while True:
            if stop.is_set() or (corpus is not None and self._corpus is not corpus):
                raise _MirrorUploadAborted()
            if time.monotonic() >= deadline:
                return
            with self._inflight_lock:
                busy = self._inflight > 0
                waited_on = self._pack_waiters > 0
            if waited_on:
                return
            if not busy and time.monotonic() - self._last_query_t >= 0.25:
                return
            time.sleep(0.05)

    def _try_sidecar(
        self, path: Union[str, Path], fingerprint: Tuple[int, int, int, int]
    ) -> Optional[PackedCorpus]:
        """The pack from a current sidecar at ``path`` (``None`` when it is
        missing, stale, corrupt, of another precision or padding).  Its
        f32 sections become the host cache (an f32 pack's true-dim view is
        its own); a cache within ``SVS_TPU_HOST_CACHE_RAM_MAX`` is copied
        into RAM, a larger one stays mapped.  With a host cache, a pack of
        ``DEFER_MIN_BYTES`` and more stays on the host (the mapping) for
        the background upload; else it uploads here.  The mirrors follow
        in ``ensure_fresh``."""
        from ..utils.env import env_int

        loaded = load_sidecar(path, expected_version=fingerprint)
        if loaded is None:
            return None
        data, row_scales, emb_ids, header = loaded
        if header["precision"] != self.precision:
            log.info(
                "sidecar precision %s != engine %s; rebuilding",
                header["precision"], self.precision,
            )
            return None
        if header["n_padded"] % self._row_multiple(header["n_valid"]) != 0:
            log.info("sidecar row padding incompatible (or with the mesh); rebuilding")
            return None
        if header["dim_padded"] % self._dim_multiple() != 0:
            log.info("sidecar dim padding incompatible (or with the mesh); rebuilding")
            return None
        log.info("loading corpus from sidecar %s", path)
        n_valid, dim = int(header["n_valid"]), int(header["dim"])
        host_cache = None
        if "_f32_cache" in header:
            cache = header["_f32_cache"]
            if cache.nbytes <= rescore_cache_limit():
                host_cache = (cache, header.get("_f32_row_map"))
        elif self.precision == "f32":
            # the mapped pack already is the exact bytes: a true-dim view
            # of it is the host gather source, no rescan and no RAM copy
            host_cache = (data[:n_valid, :dim], None)
        if host_cache is not None:
            cache_arr, rmap = host_cache
            ram_max = env_int("SVS_TPU_HOST_CACHE_RAM_MAX", _HOST_CACHE_RAM_MAX)
            if _is_mmap_backed(cache_arr) and cache_arr.nbytes <= ram_max:
                host_cache = (np.array(cache_arr, copy=True), rmap)
        self._sidecar_source = Path(path)
        return self._new_pack(
            data,
            row_scales,
            emb_ids,
            n_valid,
            dim,
            header["matrix_version"],
            host_cache[0] if host_cache is not None else None,
            host_cache[1] if host_cache is not None else None,
        )

    def write_sidecar(self, path: Union[str, Path]) -> None:
        """Persist the current pack to ``path`` (skipped when the pack was
        loaded from that very file)."""
        if self._corpus is None:
            raise RuntimeError("write_sidecar: nothing packed yet")
        if self._sidecar_source is not None and Path(path) == self._sidecar_source:
            log.debug("sidecar %s already current; skipping write", path)
            return
        self._await_pack_device(self._corpus)  # never a half-uploaded pack
        save_sidecar(path, self._corpus, fingerprint=self._fingerprint)

    def write_sidecar_from_store(
        self,
        db: Database,
        path: Union[str, Path],
        *,
        min_docs: int = 0,
        scan_ok: bool = True,
    ) -> bool:
        """Write or refresh the sidecar at ``path`` to match the store's
        current embeddings — the publish flow of ``close()``, so that no
        consumer pays the cold-start rescan.  Writes the pack in hand when
        it is current (read back from the device), else scans and packs
        on the host only, when ``scan_ok`` (a pure consumer's close under
        the ``'auto'`` policy never pays a full scan).  Skips stores below
        ``min_docs`` and files already current.  Returns True iff a
        current sidecar exists at ``path`` on return."""
        fingerprint = self._store_fingerprint(db)
        if fingerprint[1] < max(1, min_docs):
            return False
        if sidecar_fingerprint(path) == list(fingerprint):
            return True
        with self._lock:
            corpus = self._corpus
            if corpus is not None and self._fingerprint == fingerprint:
                self._await_pack_device(corpus)  # never a half-uploaded pack
                save_sidecar(path, corpus, fingerprint=fingerprint)
                return True
        if not scan_ok:
            log.debug("publish: no current pack and scan_ok=False; skipping %s", path)
            return False
        log.info("publish: packing corpus for sidecar %s", path)
        with db.transaction() as tx:
            matrix, emb_ids = tx.build_embeddings_matrix()
        host_data, host_scales, emb_ids, cache_f32, row_map, n, d = pack_host(
            matrix,
            emb_ids,
            self.precision,
            row_multiple=self._row_multiple(matrix.shape[0]),
            dim_multiple=self._dim_multiple(),
        )
        save_sidecar_arrays(
            path,
            n_valid=n,
            dim=d,
            precision=self.precision,
            matrix_version=fingerprint[0],
            fingerprint=fingerprint,
            emb_ids=emb_ids,
            row_scales=host_scales,
            data=host_data,
            f32_cache=cache_f32,
            f32_row_map=row_map,
        )
        return True

    # -- search ---------------------------------------------------------------

    def dispatch_stats(self) -> Dict[str, float]:
        """Dispatch counters surfaced through ``kb.stats()['dispatch']``:
        the widen retries and the failed uploads."""
        return {
            "widen_retries": float(self.widen_retries),
            "pack_upload_failures": float(self.pack_upload_failures),
            "mirror_upload_failures": float(self.mirror_upload_failures),
        }

    # -- host route --------------------------------------------------------------

    def host_route(self, corpus: PackedCorpus) -> bool:
        """Whether a search of ``corpus`` answers from its host f32 rows:
        while the pack is still uploading (nothing is on the card yet, and
        the host rows are), and under ``'force'``.  Under ``'auto'`` a pack
        on the card always takes the device, at every batch size (the
        reference also sends a search to the host when an estimated host
        scan beats the device's measured round-trip floor; on a local card
        that floor is tens of microseconds).  Never without the exactness
        machinery: the host rows and the rescore."""
        if (
            self.host_dispatch == "off"
            or not self.rescore
            or corpus.host_f32 is None
            or corpus.n_valid == 0
        ):
            return False
        return not corpus.device_ready or self.host_dispatch == "force"

    def host_topk_exact(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-``k`` over the whole corpus on the host with the
        reference tie rule: the native two-pass (:meth:`_host_two_pass`)
        where it applies, else a full f32 scan, a matvec for a solo query
        (the reference's accumulation: the same bits) and one GEMM per
        slab of a batch (``_HOST_SCAN_MAX_SCORE_BYTES`` of scores).
        Returns ``(emb_ids int64 [B, k'], scores f32 [B, k'])`` with
        ``k' = min(k, n_valid)``.

        Host rows that no pack row maps to (the rows an incremental
        delete dropped: their cache rows stay) score ``-inf`` and are
        never returned; ``svs_tpu`` raises there instead."""
        hf, rm = corpus.host_f32, corpus.host_row_map
        assert hf is not None, "host_topk_exact needs the host f32 rows"
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b = queries.shape[0]
        k_eff = min(int(k), corpus.n_valid)
        if k_eff <= 0:
            return (
                np.zeros((b, 0), dtype=np.int64),
                np.zeros((b, 0), dtype=np.float32),
            )
        dead = None
        if rm is None:
            emb_hf = corpus.emb_ids
        else:
            # host row rm[p] holds pack row p: the emb id of each host row
            emb_hf = np.full(hf.shape[0], -1, dtype=np.int64)
            emb_hf[rm] = corpus.emb_ids
            if len(rm) != hf.shape[0]:
                dead = emb_hf < 0
        two = self._host_two_pass(corpus, hf, emb_hf, dead, queries, k_eff)
        if two is not None:
            return two
        slab = max(1, _HOST_SCAN_MAX_SCORE_BYTES // max(1, hf.shape[0] * 4))
        emb_out = np.empty((b, k_eff), dtype=np.int64)
        score_out = np.empty((b, k_eff), dtype=np.float32)
        for lo in range(0, b, slab):
            hi = min(b, lo + slab)
            # one pass over the rows a slab (a solo query: the reference's matvec)
            exact = _host_scores(hf, queries[lo:hi])
            if dead is not None:
                exact[:, dead] = -np.inf
            emb_out[lo:hi], score_out[lo:hi] = _subset_select_np(exact, emb_hf, k_eff)
        return emb_out, score_out

    #: Two-pass bounds: below MIN_ROWS a BLAS matvec is already ~100 us;
    #: past MAX_BATCH the per-query int8 scan re-reads the matrix b times
    #: while the GEMM reads the f32 rows once a slab (crossover b ~ 4).
    HOST_TWOPASS_MIN_ROWS = 4096
    HOST_TWOPASS_MAX_BATCH = 4
    #: Build the host int8 arrays synchronously up to this f32 size, in a
    #: background thread past it (the full scan answers meanwhile).
    HOST_I8_SYNC_MAX_BYTES = 128 * 1024 * 1024

    def _ensure_host_i8(
        self, corpus: PackedCorpus, hf: np.ndarray
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The corpus's host int8 prescore arrays, built lazily from its
        host f32 rows (native quantization, and row sums for the VNNI
        kernel) and attached in one store."""
        tri = corpus.host_i8
        if tri is not None:
            return tri
        from ..native import native_available, quantize_int8 as native_quantize

        if not native_available():
            return None

        def build() -> None:
            di8 = np.empty(hf.shape, dtype=np.int8)
            scales = np.empty(hf.shape[0], dtype=np.float32)
            for lo, block in _aligned_blocks(hf):
                di8[lo : lo + len(block)], scales[lo : lo + len(block)] = (
                    native_quantize(block)
                )
            sums = di8.sum(axis=1, dtype=np.int32)
            object.__setattr__(corpus, "host_i8", (di8, scales, sums))

        if hf.nbytes <= self.HOST_I8_SYNC_MAX_BYTES:
            build()
            return corpus.host_i8
        t = self._host_i8_thread
        if t is None or not t.is_alive():
            t = threading.Thread(target=build, name="svs-tpu-host-i8", daemon=True)
            t.start()
            self._host_i8_thread = t
        return None

    def _host_two_pass(
        self,
        corpus: PackedCorpus,
        hf: np.ndarray,
        emb_hf: np.ndarray,
        dead: Optional[np.ndarray],
        queries: np.ndarray,
        k_eff: int,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Two-pass host search: the native int8 prescore proposes C
        candidates per query, their exact f32 rows are rescored one dot
        per row (the reference's accumulation) with the reference tie
        rule, and the device path's margin proof checks coverage, widening
        C 4x until it holds (C = all rows is exact by construction).
        ``dead`` marks host rows no pack row maps to (scored ``-inf``).
        ``None`` where it does not apply (no native library, a small
        corpus, a batch past the crossover, ``k >= n / 8``, no rescore)."""
        b = queries.shape[0]
        n = hf.shape[0]
        if (
            not self.rescore
            or b > self.HOST_TWOPASS_MAX_BATCH
            or n < self.HOST_TWOPASS_MIN_ROWS
            or k_eff >= n // 8
        ):
            return None
        tri = self._ensure_host_i8(corpus, hf)
        if tri is None:
            return None
        from ..native import int8_topc_prescore

        di8, scales, sums = tri
        s_q = (np.maximum(np.max(np.abs(queries), axis=1), 1e-30) / 127.0).astype(
            np.float32
        )
        q_i8 = np.clip(np.rint(queries / s_q[:, None]), -127, 127).astype(np.int8)
        # the device path's int8 bound without the key-grid term
        d = hf.shape[1]
        s_d = float(scales.max()) if scales.size else 0.0
        t_conc = float(np.sqrt(2.0 * np.log(2.0 / 1e-15)))
        eps = (
            0.5 * t_conc * (s_q.astype(np.float64) + s_d) * 1.001
            + 0.25 * d * s_q.astype(np.float64) * s_d
            + 3e-5
        )
        c = self.candidate_count(k_eff)
        while True:
            c_eff = min(c, n)
            out = int8_topc_prescore(di8, scales, sums, q_i8, s_q, c_eff)
            if out is None:
                return None
            pre_vals, pre_idx = out
            emb_out = np.empty((b, k_eff), dtype=np.int64)
            score_out = np.empty((b, k_eff), dtype=np.float32)
            ok = True
            for bi in range(b):
                rows = pre_idx[bi].astype(np.int64)
                exact = hf[rows] @ queries[bi]  # one dot per row
                if dead is not None:
                    exact[dead[rows]] = -np.inf
                e_sel, s_sel = _subset_select_np(exact[None, :], emb_hf[rows], k_eff)
                if c_eff < n and s_sel[0, -1] < pre_vals[bi, -1] + eps[bi]:
                    ok = False
                    break
                emb_out[bi] = e_sel[0]
                score_out[bi] = s_sel[0]
            if ok:
                return emb_out, score_out
            c *= 4
            log.info(
                "host two-pass margin insufficient; widening candidates to %d",
                min(c, n),
            )

    def _gather_fits(self, b: int, c: int, dev_f32: torch.Tensor) -> bool:
        """Whether the ``[b, c, d]`` f32 candidate gather of a device
        rescore stays within ``_DEVICE_GATHER_MAX_BYTES`` (``d`` the
        mirror's width: an f32 pack's mirror is ``dim_padded`` wide)."""
        return b * c * int(dev_f32.shape[1]) * 4 <= _DEVICE_GATHER_MAX_BYTES

    @_marks_inflight
    def topk_final(
        self, corpus: PackedCorpus, queries: np.ndarray, n: int, c: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The on-device batch pipeline: prescore (``c`` candidates) ->
        exact f32 rescore -> final top-``n`` with the reference tie rule;
        one query upload, one compact ``[B, 2n+1]`` fetch.

        Returns ``(emb_ids int64 [B, n'], scores f32 [B, n'], boundary f32
        [B])`` with ``n' = min(n, c, n_valid)``.  The caller proves
        exactness via ``scores[:, -1] >= boundary + prescore_eps`` and
        widens ``c`` on failure.  ``None`` when the corpus has no device
        mirror (or no int32 emb-id mirror) or the ``[B, C, d]`` gather is
        over ``_DEVICE_GATHER_MAX_BYTES``: the caller then takes
        :meth:`topk_with_rescore` and the host's selection.
        """
        dev = corpus.dev_rescore
        if dev is None or corpus.dev_emb is None:
            return None
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b = queries.shape[0]
        c_eff = min(int(c), corpus.n_valid)
        if not self._gather_fits(b, c_eff, dev[0]):
            return None
        n_eff = min(int(n), c_eff)
        if n_eff <= 0:
            return (
                np.zeros((b, 0), dtype=np.int64),
                np.zeros((b, 0), dtype=np.float32),
                np.full((b,), -np.inf, dtype=np.float32),
            )
        q_dev = torch.from_numpy(pad_queries(queries, corpus.dim_padded)).to(
            self.device
        )
        packed_dev, wide = self._prescore_packed(corpus, q_dev, c_eff)
        dim = corpus.dim if int(dev[0].shape[1]) == corpus.dim else None
        if self.mesh is not None:
            from ..parallel.sharded import sharded_rescore_final

            wire = sharded_rescore_final(
                packed_dev, dev[0], corpus.dev_emb, q_dev, n_eff, wide=wide,
                mesh=self.mesh, data_axis=self.data_axis, dim=dim,
            )
        else:
            wire = _final_from_packed(
                packed_dev, dev[0], dev[1], corpus.dev_emb, q_dev, n_eff, wide,
                dim=dim,
            )
        arr = wire.cpu().numpy()
        emb = arr[:, :n_eff].astype(np.int64)
        scores = np.ascontiguousarray(arr[:, n_eff : 2 * n_eff]).view(np.float32)
        boundary = np.ascontiguousarray(arr[:, 2 * n_eff]).view(np.float32)
        return emb, scores, boundary

    @_marks_inflight
    def topk_with_rescore(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """:meth:`topk` plus, when the corpus has a device mirror and the
        ``[B, k, d]`` gather fits, the exact f32 scores of every candidate,
        gathered and dotted on the device: ``(pre_vals, rows, exact)``.
        Then ``pre_vals`` is the boundary prescore broadcast to ``[B, k]``
        (the margin proof reads its last column; the exact scores
        supersede the rest).  Otherwise ``(pre_vals f32, rows int64,
        None)`` from :meth:`topk` and the caller rescores on the host."""
        dev = corpus.dev_rescore
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b = queries.shape[0]
        k_eff = min(int(k), corpus.n_valid)
        if (
            dev is None
            or self.mesh is not None  # the mesh rescore lives in topk_final only
            or not self._gather_fits(b, k_eff, dev[0])
        ):
            # NOT virtual: under a ReplicaEngine this runs on one replica's
            # slice, and a virtual topk would split it again at batch sizes
            # prescore_eps never saw
            vals, rows = RetrievalEngine.topk(self, corpus, queries, k)
            return vals, rows, None
        if k_eff <= 0:
            empty = np.zeros((b, 0), dtype=np.float32)
            return empty, np.zeros((b, 0), dtype=np.int64), empty
        q_dev = torch.from_numpy(pad_queries(queries, corpus.dim_padded)).to(
            self.device
        )
        packed_dev, wide = self._prescore_packed(corpus, q_dev, k_eff)
        dim = corpus.dim if int(dev[0].shape[1]) == corpus.dim else None
        rows, exact, tail_bits = _rescore_from_packed(
            packed_dev, dev[0], dev[1], q_dev, wide, dim=dim
        )
        exact_np = exact.cpu().numpy()
        tail = tail_bits[:, 0].cpu().numpy().view(np.float32)
        return np.broadcast_to(tail[:, None], exact_np.shape), rows.cpu().numpy(), exact_np

    @_marks_inflight
    def topk(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device prescore alone: top-``k`` per query.  Returns ``(scores
        f32 [B, k'], rows int64 [B, k'])`` with ``k' = min(k, n_valid)``;
        ``rows`` index ``corpus.emb_ids``.  The ``rescore=False`` path."""
        from ..ops.topk import unpack_vals_idx

        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != corpus.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != corpus dim {corpus.dim}"
            )
        k_eff = min(int(k), corpus.n_valid)
        if k_eff <= 0:
            b = queries.shape[0]
            return (
                np.zeros((b, 0), dtype=np.float32),
                np.zeros((b, 0), dtype=np.int64),
            )
        q_dev = torch.from_numpy(pad_queries(queries, corpus.dim_padded)).to(
            self.device
        )
        packed_dev, wide = self._prescore_packed(corpus, q_dev, k_eff)
        return unpack_vals_idx(packed_dev.cpu(), k_eff, wide=wide)

    @_marks_inflight
    def subset_topk(
        self,
        corpus: PackedCorpus,
        queries: np.ndarray,
        emb_sub: np.ndarray,
        k: int,
        cache_key: Optional[str] = None,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Exact top-``k`` restricted to the documents whose embedding ids
        are in ``emb_sub`` — the pre-filter route of selective metadata
        filters (``KB.retrieve(..., where=...)``): score only the matching
        rows in exact f32 and select with the reference tie rule, with no
        margin proof and no widen loop.

        Returns ``(emb_ids int64 [B, k'], scores f32 [B, k'])`` with ``k' =
        min(k, |matching rows in this pack|)``, or ``None`` when no route
        applies (no f32 gather source, or a host-route shape past
        ``_SUBSET_HOST_MAX_FLOPS``): the caller falls back to the
        post-filter ladder.  The device route gathers from the rescore
        mirror (emb ids below 2^31, the ``[F_pad, d]`` gather within
        ``_DEVICE_GATHER_MAX_BYTES``); else the host route gathers the
        pack's f32 cache through its row map and takes one NumPy product
        (the reference's own call).  Ids absent from the pack are dropped.
        ``cache_key`` (the filter's canonical string) keeps the subset's
        device arrays across calls, checked against the corpus object and
        a digest of the match set."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        emb_sub = np.asarray(emb_sub, dtype=np.int64)
        rows, present = corpus.rows_for_emb_ids(emb_sub)
        if not bool(present.all()):
            rows, emb_sub = rows[present], emb_sub[present]
        f = int(rows.size)
        b = queries.shape[0]
        if f == 0:
            return (
                np.zeros((b, 0), dtype=np.int64),
                np.zeros((b, 0), dtype=np.float32),
            )
        k_eff = min(int(k), f)
        dev = corpus.dev_rescore
        if (
            dev is not None
            and (self.mesh is None or corpus.dev_emb is not None)
            and int(emb_sub.max()) < 2**31
        ):
            f_pad = max(512, 1 << (f - 1).bit_length())
            # on a mesh each shard's gather is [F_pad, dim]: the same ceiling
            if f_pad * int(dev[0].shape[1]) * 4 <= _DEVICE_GATHER_MAX_BYTES:
                self._await_pack_device(corpus)
                rows_dev, emb_dev = self._subset_arrays(
                    corpus, rows, emb_sub, f_pad, cache_key
                )
                q_dev = torch.from_numpy(
                    pad_queries(queries, corpus.dim_padded)
                ).to(self.device)
                dim = corpus.dim if int(dev[0].shape[1]) == corpus.dim else None
                if self.mesh is not None:
                    from ..parallel.sharded import sharded_subset_topk

                    wire = sharded_subset_topk(
                        dev[0], corpus.dev_emb, rows_dev, f, q_dev, k_eff,
                        mesh=self.mesh, data_axis=self.data_axis, dim=dim,
                    )
                else:
                    wire = _subset_final(
                        dev[0], dev[1], rows_dev, emb_dev, f, q_dev, k_eff, dim=dim
                    )
                arr = wire.cpu().numpy()
                emb = arr[:, :k_eff].astype(np.int64)
                scores = np.ascontiguousarray(arr[:, k_eff : 2 * k_eff]).view(
                    np.float32
                )
                return emb, scores
        host = corpus.host_f32
        if host is None:
            return None
        if b * f * corpus.dim > _SUBSET_HOST_MAX_FLOPS:
            return None
        row_map = corpus.host_row_map
        src = rows if row_map is None else row_map[rows]
        exact = queries @ host[src].T  # [B, F] exact f32 (the returned scores)
        return _subset_select_np(exact, emb_sub, k_eff)

    def _subset_arrays(
        self,
        corpus: PackedCorpus,
        rows: np.ndarray,
        emb_sub: np.ndarray,
        f_pad: int,
        cache_key: Optional[str],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The subset's padded pack rows (int64) and emb ids (int32) on the
        device, from the cache when its entry holds this corpus and this
        match set (a meta-only update can swap which ids match at the same
        count on the same pack).  A store sweeps every entry of another
        corpus: each pins a superseded pack on the device."""
        digest = hashlib.blake2b(emb_sub.tobytes(), digest_size=16).digest()
        if cache_key is not None:
            with self._lock:
                entry = self._subset_dev.get(cache_key)
            if entry is not None and entry[0] is corpus and entry[3] == digest:
                return entry[1], entry[2]
        f = int(rows.size)
        rows_p = np.zeros(f_pad, dtype=np.int64)
        rows_p[:f] = rows
        emb_p = np.full(f_pad, -1, dtype=np.int32)
        emb_p[:f] = emb_sub
        rows_dev = torch.from_numpy(rows_p).to(self.device)
        emb_dev = torch.from_numpy(emb_p).to(self.device)
        if cache_key is not None:
            with self._lock:
                for ck in [
                    ck for ck, e in self._subset_dev.items() if e[0] is not corpus
                ]:
                    del self._subset_dev[ck]
                while len(self._subset_dev) >= _SUBSET_DEV_CACHE_MAX:
                    self._subset_dev.pop(next(iter(self._subset_dev)))
                self._subset_dev[cache_key] = (corpus, rows_dev, emb_dev, digest)
        return rows_dev, emb_dev

    def candidate_count(self, k: int) -> int:
        """How many candidates the device should return for a final top-k."""
        if not self.rescore:
            return k
        return max(k * CANDIDATE_MULTIPLIER, k + CANDIDATE_MIN_EXTRA)

    def initial_candidates(self, k: int, n_valid: int) -> int:
        """:meth:`candidate_count` with the learned per-``k`` width hint
        applied: hints live on the widen ladder (base x 4^j) and step down
        one rung after ``HINT_PROBE_STREAK`` first-try successes, so a
        corpus that fails the margin at the base width pays one search per
        batch in steady state."""
        c = self._hinted_width(self._cand_hint, self.candidate_count(k), k)
        return min(c, n_valid) if n_valid > 0 else c

    def record_candidates(self, k: int, c_final: int, widened: bool) -> None:
        """Feed the widen loop's outcome back into the width hint."""
        self._record_width(
            self._cand_hint, self.candidate_count(k), k, c_final, widened
        )

    @staticmethod
    def pairwise_candidate_base(k: int) -> int:
        """The KB's first-attempt pairwise over-provisioning (the pair
        ladder's :meth:`candidate_count`)."""
        return max(k + 64, k * 5 // 4)

    def initial_pairwise_candidates(self, k: int, n_valid: int) -> int:
        """First-attempt pairwise candidate width with the learned per-``k``
        hint applied, as :meth:`initial_candidates`: a flat score
        distribution fails the margin at the base width on every call, and
        the hint makes steady state one pass."""
        c = self._hinted_width(self._pair_hint, self.pairwise_candidate_base(k), k)
        total = n_valid * (n_valid - 1) // 2
        return min(c, total) if total > 0 else c

    def record_pairwise_candidates(
        self, k: int, c_final: int, widened: bool
    ) -> None:
        """Feed the pairwise widen loop's outcome back into its hint."""
        self._record_width(
            self._pair_hint, self.pairwise_candidate_base(k), k, c_final, widened
        )

    @staticmethod
    def _hinted_width(
        hints: Dict[int, Tuple[int, int]], base: int, k: int
    ) -> int:
        hint = hints.get(k)
        return base if hint is None else max(base, hint[0])

    def _record_width(
        self,
        hints: Dict[int, Tuple[int, int]],
        base: int,
        k: int,
        c_final: int,
        widened: bool,
    ) -> None:
        if widened:
            hints[k] = (c_final, 0)
            return
        hint = hints.get(k)
        if hint is None:
            return
        c_hint, streak = hint
        if streak + 1 >= self.HINT_PROBE_STREAK:
            narrower = max(base, c_hint // 4)
            if narrower <= base:
                hints.pop(k, None)
            else:
                hints[k] = (narrower, 0)
        else:
            hints[k] = (c_hint, streak + 1)

    def _keyed_selection_possible(
        self, corpus: PackedCorpus, b: int, k: int
    ) -> bool:
        """THE dispatch condition for the keyed (v2) kernel: ``_prescore_packed``
        consults it for dispatch and ``prescore_eps`` for the KEY_EPS term,
        so the two never drift."""
        from ..ops.pallas_extract import fused2_supported

        if not self._selection_kernels_on(corpus):
            return False
        # on a mesh the keyed kernel runs per shard (data axis only), so
        # the shard's shape decides; the key grid is the same, and one
        # KEY_EPS covers the merged candidates
        if self.model_axis is not None:
            return False
        return fused2_supported(
            corpus.n_padded // self._shards(self.data_axis),
            corpus.dim_padded,
            b,
            min(k, corpus.n_valid),
        )

    def _selection_kernels_on(self, corpus: PackedCorpus) -> bool:
        """The reference's gate on the quantized-prescore (v2/v3) kernels:
        only under the verified rescore, and only for ``kernel='auto'``
        (int8) or ``'auto'``/``'pallas'`` (bf16/f32)."""
        if not self.rescore:
            return False
        if corpus.precision == "int8":
            return self.kernel == "auto"
        return self.kernel in ("auto", "pallas")

    def _guarded_selection_possible(
        self, corpus: PackedCorpus, b: int, k: int
    ) -> bool:
        """Dispatch condition for the guarded (v3) kernel — the reference's
        single-device branch: the structural envelope first; where no v2
        can run at this shape, the static ``GUARD_MIN_BATCH`` rule;
        otherwise the calibrated winner (:meth:`_calib_winner`).
        ``prescore_eps`` consults this for the (larger) ``GUARD_KEY_EPS``
        term, so bound and dispatch cannot drift.  Growing ``k`` past
        ``GUARD_MAX_C`` turns it off, so the widen ladder escalates
        v3 -> v2/v1 -> exact."""
        from ..ops.pallas_extract import (
            FUSED_BLOCK_N,
            GUARD_KEYS,
            fused3_shape_ok,
            fused3_supported,
        )

        if not self._selection_kernels_on(corpus):
            return False
        c = min(k, corpus.n_valid)
        n_rows = corpus.n_padded
        if self.mesh is not None:
            # per shard, data axis only; the merged boundary composes the
            # shards' bounds as the single-device wire does, so one
            # GUARD_KEY_EPS covers it
            if self.model_axis is not None:
                return False
            n_rows //= self._shards(self.data_axis)
            # the pack's padding sits at its END, so it concentrates in the
            # trailing shard(s): a shard whose pool cannot seat c LIVE keys
            # returns bound +inf, fails the margin on every batch and traps
            # the widen ladder — refuse unless the worst shard has enough
            # fully live blocks
            pad_rows = corpus.n_padded - corpus.n_valid
            nb_shard = n_rows // FUSED_BLOCK_N
            dead_blocks_worst = min(-(-pad_rows // FUSED_BLOCK_N), nb_shard)
            if c > (nb_shard - dead_blocks_worst) * GUARD_KEYS:
                return False
            # mesh shards keep the static prior: calibration measures the
            # single-device kernels, not the per-shard crossover
            return fused3_supported(n_rows, corpus.dim_padded, b, c)
        if not fused3_shape_ok(n_rows, corpus.dim_padded, b, c):
            return False
        if not self._keyed_selection_possible(corpus, b, k):
            # no v2 at this shape -> nothing to calibrate against; the
            # static rule is the only sound choice
            return fused3_supported(n_rows, corpus.dim_padded, b, c)
        return self._calib_winner(corpus, n_rows, b, c) == "v3"

    def _calib_winner(
        self, corpus: PackedCorpus, n_rows: int, b: int, c: int
    ) -> str:
        """The v2-vs-v3 winner for this shape class: the persisted
        calibration measurement when one exists, else the static prior
        (``GUARD_MIN_BATCH``) — and in that case a one-time background
        probe is spawned to measure the crossover on this card
        (``engine.calibrate``).  Sticky per engine instance
        (``_calib_sticky``)."""
        from ..ops.pallas_extract import GUARD_MIN_BATCH
        from .calibrate import device_kind, dispatch_key, get_calibrator

        key = dispatch_key(
            device_kind(self.device), corpus.precision, n_rows,
            corpus.dim_padded, b, c,
        )
        with self._calib_lock:
            winner = self._calib_sticky.get(key)
            if winner is None:
                winner = get_calibrator().decide(key)
                if winner is None:
                    winner = "v3" if b >= GUARD_MIN_BATCH else "v2"
                    self._maybe_spawn_dispatch_probe(corpus, b, c, key)
                self._calib_sticky[key] = winner
        return winner

    def _maybe_spawn_dispatch_probe(
        self, corpus: PackedCorpus, b: int, c: int, key: str
    ) -> None:
        """Time v2 against v3 at the live shape on the live corpus, once
        per shape class, in a daemon thread on a CUDA stream of its own
        (the first query never waits for it).  The winner is persisted for
        later engines and processes; THIS engine keeps its prior (sticky
        decisions)."""
        from .calibrate import get_calibrator, probing_enabled, time_kernel_pair

        if not probing_enabled(self.device):
            return
        cal = get_calibrator()
        if not cal.claim_probe(key):
            return

        def work() -> None:
            try:
                data, scales = self._pack_arrays(corpus)
                rng = np.random.default_rng(0)
                q_np = rng.standard_normal((b, corpus.dim_padded)).astype(np.float32)
                q_np /= np.linalg.norm(q_np, axis=1, keepdims=True)
                q = torch.from_numpy(q_np).to(data.device)
                wide = corpus.n_padded >= WIDE_INDEX_MIN_ROWS
                v2_s, v3_s = time_kernel_pair(corpus, data, scales, q, c, wide)
                cal.record(key, "v2" if v2_s <= v3_s else "v3", v2_s, v3_s)
            except Exception as exc:  # a probe must never break serving
                cal.release_probe(key)
                log.warning("dispatch probe %s failed (%s); keeping the "
                            "static prior", key, exc)

        t = threading.Thread(
            target=work, name="svs-tpu-dispatch-probe", daemon=True
        )
        self._probe_threads.append(t)
        t.start()

    def join_dispatch_probes(self, timeout: Optional[float] = None) -> bool:
        """Test and smoke hook: wait for this engine's outstanding dispatch
        probes; False when one is still running at ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._calib_lock:
            threads = list(self._probe_threads)
        for t in threads:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(left)
        with self._calib_lock:
            self._probe_threads = [t for t in self._probe_threads if t.is_alive()]
            return not self._probe_threads

    def _scores_over_budget(self, corpus: PackedCorpus, b: int) -> bool:
        """Whether a materializing exact path's ``[B, N]`` f32 score
        matrix would exceed ``FALLBACK_SCORES_BUDGET``."""
        from ..ops.topk import FALLBACK_SCORES_BUDGET

        n_rows = corpus.n_padded
        if self.model_axis is None:
            n_rows //= self._shards(self.data_axis)  # per shard on a mesh
        return b * n_rows * 4 > FALLBACK_SCORES_BUDGET

    def prescore_eps(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> np.ndarray:
        """Per-query bound on ``|device prescore - exact f32 score|`` —
        the reference's formula unchanged (see its docstring for the
        derivation): for bf16 the two-sided rounding term ``2^-8 (1 +
        2^-9)`` plus a 3e-5 cushion; for int8 a Hoeffding-style
        concentration term at delta = 1e-15, a deterministic residual x
        residual term and a 3e-5 f32-accumulation cushion; for f32 1e-4
        (true f32 dots, TF32 off); plus the key grid's term when a keyed
        (KEY_EPS) or guarded (GUARD_KEY_EPS) kernel can dispatch.
        Callers recompute it at the CURRENT candidate count on every
        widen retry."""
        from ..ops.pallas_extract import GUARD_KEY_EPS, KEY_EPS

        b = queries.shape[0]
        if self._guarded_selection_possible(corpus, b, k):
            key_eps = GUARD_KEY_EPS
        elif self._keyed_selection_possible(corpus, b, k):
            key_eps = KEY_EPS
        else:
            key_eps = 0.0
        if corpus.precision == "bf16":
            eps = 2.0**-8 * (1.0 + 2.0**-9) + 3e-5 + key_eps
            return np.full((b,), eps, dtype=np.float64)
        if corpus.precision == "int8":
            d = corpus.dim
            s_d = corpus.scale_max
            s_q = np.max(np.abs(queries), axis=1).astype(np.float64) / 127.0
            t = np.sqrt(2.0 * np.log(2.0 / 1e-15))  # ~8.3
            return (
                0.5 * t * (s_q + s_d) * 1.001  # concentration terms
                + 0.25 * d * s_q * s_d  # residual x residual (deterministic)
                + 3e-5
                + key_eps
            )
        return np.full((b,), 1e-4 + key_eps, dtype=np.float64)

    def _prescore_packed(
        self, corpus: PackedCorpus, q: torch.Tensor, k_eff: int
    ) -> Tuple[torch.Tensor, bool]:
        """Dispatch the prescore ladder on the padded on-device queries;
        returns the ON-DEVICE packed wire (scores ++ indices) and its wire
        format.  The rungs are the reference's, in its order."""
        from ..ops import pallas_extract as P
        from ..ops.quant import score_topk_int8_extract_packed, score_topk_int8_packed
        from ..ops.topk import score_topk_packed, streaming_score_topk_packed

        from ..ops.topk import pack_vals_idx

        data, scales = self._pack_arrays(corpus)  # a deferred upload lands first
        b = q.shape[0]
        n_valid = corpus.n_valid
        wide = corpus.n_padded >= WIDE_INDEX_MIN_ROWS
        if self.mesh is not None:
            from ..parallel.sharded import sharded_score_topk

            # the single-device ladder per shard: guarded (v3) when every
            # shard's pool seats the candidates, else keyed (v2), else the
            # streamed or materialised exact scan
            guarded = self._guarded_selection_possible(corpus, b, k_eff)
            vals, idx = sharded_score_topk(
                data, scales, q, n_valid, k_eff,
                mesh=self.mesh,
                data_axis=self.data_axis,
                model_axis=self.model_axis,
                keyed=not guarded and self._keyed_selection_possible(corpus, b, k_eff),
                guarded=guarded,
            )
            return pack_vals_idx(vals, idx, wide=wide), wide
        n_pad, d_pad = corpus.n_padded, corpus.dim_padded
        if corpus.precision == "int8":
            ops = (data, scales)
            v3, v2, v1 = (
                P.score_topk_fused3_int8_packed,
                P.score_topk_fused2_int8_packed,
                P.score_topk_fused_int8_packed,
            )
            two_pass, exact = score_topk_int8_extract_packed, score_topk_int8_packed
            kernels_ok = self.kernel == "auto" and not wide
        else:
            ops = (data,)
            v3, v2, v1 = (
                P.score_topk_fused3_packed,
                P.score_topk_fused2_packed,
                P.score_topk_fused_packed,
            )
            two_pass, exact = P.score_topk_extract_packed, score_topk_packed
            kernels_ok = self.kernel in ("auto", "pallas") and not wide
        if self._guarded_selection_possible(corpus, b, k_eff):
            return v3(*ops, q, n_valid, k_eff, wide=wide), wide
        if self._keyed_selection_possible(corpus, b, k_eff):
            return v2(*ops, q, n_valid, k_eff, wide=wide), wide
        if kernels_ok and P.fused_supported(n_pad, d_pad, b, k_eff):
            return v1(*ops, q, n_valid, k_eff), wide
        if kernels_ok and P.extract_supported(n_pad, b, k_eff):
            return two_pass(*ops, q, n_valid, k_eff), wide
        if self._scores_over_budget(corpus, b):
            return streaming_score_topk_packed(
                data, q, n_valid, k_eff, row_scales=scales, wide=wide,
            ), wide
        return exact(*ops, q, n_valid, k_eff, wide=wide), wide

    # -- pairwise -------------------------------------------------------------

    def _keyed_pairwise_possible(self, corpus: PackedCorpus) -> bool:
        """Dispatch condition of the keyed pairwise candidate pass: the
        quantized-prescore gate of the retrieval kernels, and shapes the
        pair-key kernel takes.  ``pairwise_eps`` consults it for the
        KEY_EPS term, so bound and dispatch cannot drift; c-independent
        (the candidate count only narrows the route further)."""
        from ..ops.pairwise import keyed_pairwise_route
        from ..ops.pallas_extract import pair_keys_supported

        if not self._selection_kernels_on(corpus) or self.mesh is not None:
            return False
        block_rows = min(256, corpus.n_padded)
        return pair_keys_supported(
            corpus.n_padded, block_rows
        ) and keyed_pairwise_route(corpus.n_padded, block_rows, 1)

    def pairwise_eps(self, corpus: PackedCorpus) -> float:
        """Bound on ``|device pairwise prescore - exact f32 score|`` — the
        reference's formula unchanged: both sides of each dot are stored
        vectors, so int8 stacks both rows' quantization residuals on the
        bf16 term; plus one KEY_EPS when the keyed pass can dispatch."""
        from ..ops.pallas_extract import KEY_EPS

        key_eps = KEY_EPS if self._keyed_pairwise_possible(corpus) else 0.0
        bf16_term = 2.0**-8 * (1.0 + 2.0**-9) + 3e-5
        if corpus.precision == "f32":
            return 1e-4 + key_eps
        if corpus.precision == "bf16":
            return bf16_term + key_eps
        s = corpus.scale_max
        t = float(np.sqrt(2.0 * np.log(2.0 / 1e-15)))
        return bf16_term + t * s * 1.001 + 0.25 * corpus.dim * s * s + key_eps

    @_marks_inflight
    def subset_pairwise_corpus(
        self,
        corpus: PackedCorpus,
        rows: np.ndarray,
        emb_sub: np.ndarray,
    ) -> Optional[PackedCorpus]:
        """A derived :class:`PackedCorpus` of only the given pack rows — the
        filtered-pairwise route (``where=`` on
        ``document_top_pairwise_scores``): the unchanged verified pairwise
        loop then runs on "a corpus of just the matching documents", with
        its bound, margin check, widen and tie rule.

        The rows (and their int8 scales) are gathered on the device, the
        padding rows zeroed as in a real pack, to a multiple of
        ``ROW_MULTIPLE``; the host f32 cache subsets along.  The derived
        corpus gets no device mirror, so its pair rescore runs on the host
        rows (or, without them, from the store by emb id), as the
        reference's does.  ``None`` on a mesh (the pack is sharded): the
        caller post-filters the exact global pair prefix instead."""
        if self.mesh is not None:
            return None
        f = int(rows.size)
        f_pad = max(-(-f // ROW_MULTIPLE) * ROW_MULTIPLE, ROW_MULTIPLE)
        rows_p = np.zeros(f_pad, dtype=np.int64)
        rows_p[:f] = rows
        full_data, full_scales = self._pack_arrays(corpus)
        rows_dev = torch.from_numpy(rows_p).to(full_data.device)
        data = torch.index_select(full_data, 0, rows_dev)
        data[f:] = 0
        scales = None
        if full_scales is not None:
            scales = torch.index_select(full_scales, 0, rows_dev)
            scales[f:] = 0
        host_cache = None
        if corpus.host_f32 is not None:
            row_map = corpus.host_row_map
            src = rows if row_map is None else row_map[rows]
            host_cache = (np.ascontiguousarray(corpus.host_f32[src]), None)
        return PackedCorpus(
            data=data,
            row_scales=scales,
            emb_ids=np.asarray(emb_sub, dtype=np.int64),
            n_valid=f,
            dim=corpus.dim,
            version=corpus.version,
            precision=corpus.precision,
            scale_max=corpus.scale_max,  # an upper bound: the eps stays sound
            host_cache=host_cache,
        )

    @_marks_inflight
    def pairwise_topk(
        self, corpus: PackedCorpus, k: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-``k`` document pairs by similarity (strict upper triangle):
        ``(scores f32 [k'], rows_a int64 [k'], rows_b int64 [k'])``, rows
        indexing ``corpus.emb_ids``.  The keyed candidate pass first
        (quantized prescores, the bound in the last slot; the KB's rescore
        margin owns exactness), the exact blocked pass when the keyed one
        cannot run or comes back not ``ok``."""
        from ..ops.pairwise import (
            keyed_pairwise_route,
            pairwise_candidates_keyed,
            pairwise_topk_blocked,
        )

        n = corpus.n_valid
        k_eff = min(int(k), n * (n - 1) // 2)
        if k_eff <= 0:
            empty_i = np.zeros((0,), dtype=np.int64)
            return np.zeros((0,), dtype=np.float32), empty_i, empty_i
        data, scales = self._pack_arrays(corpus)
        if self.mesh is not None:
            return self._mesh_pairwise_topk(corpus, data, scales, k_eff)
        block_rows = min(256, corpus.n_padded)
        result = None
        if self._keyed_pairwise_possible(corpus) and keyed_pairwise_route(
            corpus.n_padded, block_rows, k_eff
        ):
            vals, rows, cols, ok = pairwise_candidates_keyed(
                data, n, k_eff, block_rows=block_rows, row_scales=scales,
            )
            if ok:
                result = (vals, rows, cols)
        if result is None:
            result = pairwise_topk_blocked(
                data, n, k_eff, block_rows=block_rows, row_scales=scales,
            )
        vals, rows, cols = (t.cpu().numpy() for t in result)
        return (
            vals.astype(np.float32, copy=False),
            rows.astype(np.int64),
            cols.astype(np.int64),
        )

    def _mesh_pairwise_topk(
        self, corpus: PackedCorpus, data: Any, scales: Any, k_eff: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The ring (``parallel.pairwise_sharded``) over the shards, whose
        products are float: an int8 pack is dequantized to bf16 per shard
        first (an O(N/D x d) transient), as the reference's mesh does;
        on a dim-sharded mesh each row block's columns are gathered onto
        its row's first device."""
        from ..parallel.mesh import ShardedArray
        from ..parallel.pairwise_sharded import sharded_pairwise_topk

        assert self.mesh is not None
        blocks = []
        for i, row in enumerate(data.blocks):
            blk = row[0] if len(row) == 1 else torch.cat(
                self.mesh.gather(row, device=row[0].device), dim=1
            )
            if scales is not None:
                blk = (blk.to(torch.float32) * scales.block(i)[:, None]).to(torch.bfloat16)
            blocks.append([blk])
        vals, rows, cols = sharded_pairwise_topk(
            ShardedArray(self.mesh, blocks, data.shape), corpus.n_valid, k_eff,
            mesh=self.mesh, data_axis=self.data_axis,
        )
        return (
            vals.cpu().numpy().astype(np.float32, copy=False),
            rows.cpu().numpy().astype(np.int64),
            cols.cpu().numpy().astype(np.int64),
        )

    @_marks_inflight
    def pairwise_rescore(
        self, corpus: PackedCorpus, rows_a: np.ndarray, rows_b: np.ndarray
    ) -> Optional[np.ndarray]:
        """Exact f32 scores of the candidate pairs ``(rows_a[i],
        rows_b[i])`` (pack rows), gathered and dotted on the device from
        the rescore mirror; ``None`` when the corpus has none or is
        sharded (the KB then gathers on the host or from SQLite)."""
        if self.mesh is not None or corpus.dev_rescore is None or corpus.n_padded >= 2**31:
            return None
        c = int(len(rows_a))
        if c == 0:
            return np.zeros((0,), dtype=np.float32)
        dev_f32, dev_map = corpus.dev_rescore
        ra, rb = (
            torch.from_numpy(np.asarray(r, dtype=np.int64)).to(dev_f32.device)
            for r in (rows_a, rows_b)
        )
        out = _pairwise_rescore_from_rows(dev_f32, dev_map, ra, rb)
        return out.cpu().numpy().astype(np.float32, copy=False)
