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

Not ported yet (``ROADMAP.md``): the host route and two-pass host search
(with it the deferred background upload of a cold pack), hedged fetches
and RPC-floor probes, calibration, meshes and replicas (with them the
mesh branch of ``subset_topk``).
"""

from __future__ import annotations

import hashlib
import logging
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..store.db import Database
from ..ops.topk import exact_f32, final_select_wire, unpack_rows_tail
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
    cand = dev_f32[at if dev_map is None else dev_map[at]]  # [B, C, d]
    with exact_f32():
        exact = torch.bmm(cand, queries[:, :, None].to(torch.float32))[:, :, 0]
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
    cand = dev_f32[at if dev_map is None else dev_map[at]]  # [F, d]
    with exact_f32():
        exact = queries.to(torch.float32) @ cand.t()  # [B, F]
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
            # rescore, or kernel='pallas', whose kernels are float-only)
            precision = (
                "int8"
                if self.rescore and device_rescore == "auto" and kernel != "pallas"
                else "bf16"
            )
        self.precision = precision
        self.device = torch.device("cuda" if device is None else device)
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

    def shutdown(self) -> None:
        """Join the background rescore-cache rebuild, if one runs."""
        t = self._cache_rebuild_thread
        if t is not None and t.is_alive():
            t.join(timeout=30.0)
        self._cache_rebuild_thread = None

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
        """Large corpora align to the fused kernels' block multiple."""
        return LARGE_ROW_MULTIPLE if n_rows >= LARGE_ROW_MULTIPLE else ROW_MULTIPLE

    @staticmethod
    def _store_fingerprint(db: Database) -> Tuple[int, int, int, int]:
        with db.transaction() as tx:
            version = tx.matrix_version()
            count, max_id, generation = tx.embeddings_fingerprint()
        return (version, count, max_id, generation)

    def ensure_fresh(
        self,
        db: Database,
        sidecar_path: Union[str, Path, None] = None,
    ) -> PackedCorpus:
        """Return a corpus reflecting the store's current embeddings,
        repacking if stale: incrementally after a pure append or a pure
        delete, from the sidecar at ``sidecar_path`` when it is current,
        else from a full BLOB scan.  The caller serializes store access
        (the KB holds its lock around this)."""
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
                with db.transaction() as tx:
                    matrix, emb_ids = tx.build_embeddings_matrix()
                corpus = self._pack(matrix, emb_ids, fingerprint[0])
            self._corpus = corpus
            self._fingerprint = fingerprint
            self._quick_token = quick
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
        from ..convert import packed_from_numpy

        data, scales, ids, cache, row_map, n, d = pack_host(
            matrix,
            emb_ids,
            self.precision,
            row_multiple=self._row_multiple(matrix.shape[0]),
            dim_multiple=DIM_MULTIPLE,
        )
        # the host f32 cache within SVS_TPU_RESCORE_CACHE_MAX_BYTES (past
        # it the host rescore reads rows from the store)
        if cache.nbytes > rescore_cache_limit():
            cache = row_map = None
        return packed_from_numpy(
            data,
            scales,
            ids,
            n,
            d,
            version,
            self.precision,
            float(scales[:n].max()) if scales is not None and n > 0 else 0.0,
            cache,
            row_map,
            self.device,
            mirror=self._mirror_allowed(self.precision, cache, n),
        )

    def _try_incremental_append(
        self, db: Database, fingerprint: Tuple[int, int, int, int]
    ) -> Optional[PackedCorpus]:
        """Append-only fast path (the reference's gates): when the only
        change since the last pack is new embeddings, fetch just those rows
        and write them at the pack's end, growing it to the next row
        multiple when they pass its padding, instead of rescanning every
        BLOB.  The host f32 cache grows by the same rows; the device mirror
        is the old one with the new rows' upload concatenated."""
        from ..convert import emb_mirror

        old = self._corpus
        if old is None or self._fingerprint is None:
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
        n0, n1 = old.n_valid, old.n_valid + added
        grow = self._row_multiple(n1)
        dev = old.device
        scales_new = None
        scale_max = old.scale_max
        if old.precision == "int8":
            q_new, s_new = quantize_int8(new_rows, added, old.dim_padded)
            data_new = _grow_rows(old.data, torch.from_numpy(q_new).to(dev), n0, grow)
            scales_new = _grow_rows(
                old.row_scales, torch.from_numpy(s_new).to(dev), n0, grow
            )
            scale_max = max(scale_max, float(np.max(s_new)))
        else:
            from ..convert import _upload_data

            padded = _cast_padded(new_rows, added, old.dim_padded, old.precision)
            data_new = _grow_rows(
                old.data, _upload_data(padded, old.precision, dev), n0, grow
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
        On the device the f32 mirror stays and only its map is replaced."""
        from ..convert import emb_mirror

        old = self._corpus
        if old is None or self._fingerprint is None:
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
        dev = old.device
        data_new, scales_new = old.data, old.row_scales
        if dead_below.size:
            src = torch.from_numpy(live_tail).to(dev)
            dst = torch.from_numpy(dead_below).to(dev)
            data_new = _move_rows(old.data, src, dst)
            if old.row_scales is not None:
                scales_new = _move_rows(old.row_scales, src, dst)
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

    def _maybe_build_device_rescore(self, corpus: PackedCorpus) -> None:
        """Give ``corpus`` its device mirrors when it has none and the
        policy allows one: after a sidecar load without the f32 sections,
        once the background rebuild has attached the host cache.  Caller
        holds the engine lock."""
        from ..convert import device_mirror

        if corpus.dev_rescore is not None:
            return
        cache = corpus.host_cache
        if not self._mirror_allowed(
            corpus.precision, cache[0] if cache is not None else None, corpus.n_valid
        ):
            return
        dev_rescore, dev_emb = device_mirror(
            corpus.data, corpus.precision, cache, corpus.emb_ids, corpus.n_valid
        )
        # the emb-id mirror first: a reader that sees dev_rescore sees both
        object.__setattr__(corpus, "dev_emb", dev_emb)
        object.__setattr__(corpus, "dev_rescore", dev_rescore)

    def _try_sidecar(
        self, path: Union[str, Path], fingerprint: Tuple[int, int, int, int]
    ) -> Optional[PackedCorpus]:
        """The pack from a current sidecar at ``path`` (``None`` when it is
        missing, stale, corrupt, of another precision or padding).  Its
        f32 sections become the host cache (an f32 pack's true-dim view is
        its own); a cache within ``SVS_TPU_HOST_CACHE_RAM_MAX`` is copied
        into RAM, a larger one stays mapped.  The pack and the device
        mirror upload synchronously."""
        from ..convert import packed_from_numpy
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
            log.info("sidecar row padding incompatible; rebuilding")
            return None
        if header["dim_padded"] % DIM_MULTIPLE != 0:
            log.info("sidecar dim padding incompatible; rebuilding")
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
        corpus = packed_from_numpy(
            data,
            row_scales,
            emb_ids,
            n_valid,
            dim,
            header["matrix_version"],
            self.precision,
            float(np.max(row_scales[:n_valid]))
            if row_scales is not None and n_valid > 0
            else 0.0,
            host_cache[0] if host_cache is not None else None,
            host_cache[1] if host_cache is not None else None,
            self.device,
            mirror=self._mirror_allowed(
                self.precision,
                host_cache[0] if host_cache is not None else None,
                n_valid,
            ),
        )
        self._sidecar_source = Path(path)
        return corpus

    def write_sidecar(self, path: Union[str, Path]) -> None:
        """Persist the current pack to ``path`` (skipped when the pack was
        loaded from that very file)."""
        if self._corpus is None:
            raise RuntimeError("write_sidecar: nothing packed yet")
        if self._sidecar_source is not None and Path(path) == self._sidecar_source:
            log.debug("sidecar %s already current; skipping write", path)
            return
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
            dim_multiple=DIM_MULTIPLE,
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
        """Dispatch counters surfaced through ``kb.stats()['dispatch']``."""
        return {"widen_retries": float(self.widen_retries)}

    def _gather_fits(self, b: int, c: int, dev_f32: torch.Tensor) -> bool:
        """Whether the ``[b, c, d]`` f32 candidate gather of a device
        rescore stays within ``_DEVICE_GATHER_MAX_BYTES`` (``d`` the
        mirror's width: an f32 pack's mirror is ``dim_padded`` wide)."""
        return b * c * int(dev_f32.shape[1]) * 4 <= _DEVICE_GATHER_MAX_BYTES

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
            corpus.device
        )
        packed_dev, wide = self._prescore_packed(corpus, q_dev, c_eff)
        dim = corpus.dim if int(dev[0].shape[1]) == corpus.dim else None
        wire = _final_from_packed(
            packed_dev, dev[0], dev[1], corpus.dev_emb, q_dev, n_eff, wide,
            dim=dim,
        )
        arr = wire.cpu().numpy()
        emb = arr[:, :n_eff].astype(np.int64)
        scores = np.ascontiguousarray(arr[:, n_eff : 2 * n_eff]).view(np.float32)
        boundary = np.ascontiguousarray(arr[:, 2 * n_eff]).view(np.float32)
        return emb, scores, boundary

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
        if dev is None or not self._gather_fits(b, k_eff, dev[0]):
            vals, rows = self.topk(corpus, queries, k)
            return vals, rows, None
        if k_eff <= 0:
            empty = np.zeros((b, 0), dtype=np.float32)
            return empty, np.zeros((b, 0), dtype=np.int64), empty
        q_dev = torch.from_numpy(pad_queries(queries, corpus.dim_padded)).to(
            corpus.device
        )
        packed_dev, wide = self._prescore_packed(corpus, q_dev, k_eff)
        dim = corpus.dim if int(dev[0].shape[1]) == corpus.dim else None
        rows, exact, tail_bits = _rescore_from_packed(
            packed_dev, dev[0], dev[1], q_dev, wide, dim=dim
        )
        exact_np = exact.cpu().numpy()
        tail = tail_bits[:, 0].cpu().numpy().view(np.float32)
        return np.broadcast_to(tail[:, None], exact_np.shape), rows.cpu().numpy(), exact_np

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
            corpus.device
        )
        packed_dev, wide = self._prescore_packed(corpus, q_dev, k_eff)
        return unpack_vals_idx(packed_dev.cpu(), k_eff, wide=wide)

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
        if dev is not None and int(emb_sub.max()) < 2**31:
            f_pad = max(512, 1 << (f - 1).bit_length())
            if f_pad * int(dev[0].shape[1]) * 4 <= _DEVICE_GATHER_MAX_BYTES:
                rows_dev, emb_dev = self._subset_arrays(
                    corpus, rows, emb_sub, f_pad, cache_key
                )
                q_dev = torch.from_numpy(
                    pad_queries(queries, corpus.dim_padded)
                ).to(corpus.device)
                dim = corpus.dim if int(dev[0].shape[1]) == corpus.dim else None
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
        rows_dev = torch.from_numpy(rows_p).to(corpus.device)
        emb_dev = torch.from_numpy(emb_p).to(corpus.device)
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
        return fused2_supported(
            corpus.n_padded, corpus.dim_padded, b, min(k, corpus.n_valid)
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
        """Dispatch condition for the guarded (v3) kernel, on the static
        ``GUARD_MIN_BATCH`` prior (the reference's calibration, which may
        move the v2/v3 crossover per chip, is not ported yet).  Growing
        ``k`` past ``GUARD_MAX_C`` turns it off, so the widen ladder
        escalates v3 -> v2/v1 -> exact."""
        from ..ops.pallas_extract import fused3_supported

        if not self._selection_kernels_on(corpus):
            return False
        return fused3_supported(
            corpus.n_padded, corpus.dim_padded, b, min(k, corpus.n_valid)
        )

    def _scores_over_budget(self, corpus: PackedCorpus, b: int) -> bool:
        """Whether a materializing exact path's ``[B, N]`` f32 score
        matrix would exceed ``FALLBACK_SCORES_BUDGET``."""
        from ..ops.topk import FALLBACK_SCORES_BUDGET

        return b * corpus.n_padded * 4 > FALLBACK_SCORES_BUDGET

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

        b = q.shape[0]
        n_valid = corpus.n_valid
        wide = corpus.n_padded >= WIDE_INDEX_MIN_ROWS
        n_pad, d_pad = corpus.n_padded, corpus.dim_padded
        if corpus.precision == "int8":
            ops = (corpus.data, corpus.row_scales)
            v3, v2, v1 = (
                P.score_topk_fused3_int8_packed,
                P.score_topk_fused2_int8_packed,
                P.score_topk_fused_int8_packed,
            )
            two_pass, exact = score_topk_int8_extract_packed, score_topk_int8_packed
            kernels_ok = self.kernel == "auto" and not wide
        else:
            ops = (corpus.data,)
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
                corpus.data, q, n_valid, k_eff, row_scales=corpus.row_scales,
                wide=wide,
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

        if not self._selection_kernels_on(corpus):
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

    def subset_pairwise_corpus(
        self,
        corpus: PackedCorpus,
        rows: np.ndarray,
        emb_sub: np.ndarray,
    ) -> PackedCorpus:
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
        reference's does."""
        f = int(rows.size)
        f_pad = max(-(-f // ROW_MULTIPLE) * ROW_MULTIPLE, ROW_MULTIPLE)
        rows_p = np.zeros(f_pad, dtype=np.int64)
        rows_p[:f] = rows
        rows_dev = torch.from_numpy(rows_p).to(corpus.device)
        data = torch.index_select(corpus.data, 0, rows_dev)
        data[f:] = 0
        scales = None
        if corpus.row_scales is not None:
            scales = torch.index_select(corpus.row_scales, 0, rows_dev)
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
        block_rows = min(256, corpus.n_padded)
        result = None
        if self._keyed_pairwise_possible(corpus) and keyed_pairwise_route(
            corpus.n_padded, block_rows, k_eff
        ):
            vals, rows, cols, ok = pairwise_candidates_keyed(
                corpus.data, n, k_eff, block_rows=block_rows,
                row_scales=corpus.row_scales,
            )
            if ok:
                result = (vals, rows, cols)
        if result is None:
            result = pairwise_topk_blocked(
                corpus.data, n, k_eff, block_rows=block_rows,
                row_scales=corpus.row_scales,
            )
        vals, rows, cols = (t.cpu().numpy() for t in result)
        return (
            vals.astype(np.float32, copy=False),
            rows.astype(np.int64),
            cols.astype(np.int64),
        )

    def pairwise_rescore(
        self, corpus: PackedCorpus, rows_a: np.ndarray, rows_b: np.ndarray
    ) -> Optional[np.ndarray]:
        """Exact f32 scores of the candidate pairs ``(rows_a[i],
        rows_b[i])`` (pack rows), gathered and dotted on the device from
        the rescore mirror; ``None`` when the corpus has none (the KB then
        gathers on the host or from SQLite)."""
        if corpus.dev_rescore is None or corpus.n_padded >= 2**31:
            return None
        c = int(len(rows_a))
        if c == 0:
            return np.zeros((0,), dtype=np.float32)
        dev_f32, dev_map = corpus.dev_rescore
        ra, rb = (
            torch.from_numpy(np.asarray(r, dtype=np.int64)).to(corpus.device)
            for r in (rows_a, rows_b)
        )
        out = _pairwise_rescore_from_rows(dev_f32, dev_map, ra, rb)
        return out.cpu().numpy().astype(np.float32, copy=False)
