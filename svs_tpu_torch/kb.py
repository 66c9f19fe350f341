"""The synchronous knowledge-base facade :class:`KB` (port of
``svs_tpu.kb.KB``, the retrieval main path).

Same constructor keywords and the same SQLite file as the reference:
a database written by ``svs_tpu.KB`` opens here, and the reverse.
Retrieval runs the reference pipeline on one CUDA device:

1. the engine keeps the corpus packed on the device — int8 by default
   (``precision='auto'``), or bf16 / f32 — and proposes an
   over-provisioned candidate set per query (fused selection kernels);
2. the candidates are rescored in exact f32 from a device mirror of the
   stored vectors and selected with the reference tie rule — or, with
   ``device_rescore='host'`` (reference-bit-identical scores) or a corpus
   whose f32 rows pass ``SVS_TPU_DEVICE_RESCORE_MAX_BYTES``, on the host
   from the pack's f32 cache (from SQLite past
   ``SVS_TPU_RESCORE_CACHE_MAX_BYTES``);
3. the margin check against ``prescore_eps`` proves the candidate set
   covered the true top-n — otherwise the candidates widen 4x and the
   search retries — and the winners are hydrated from SQLite.

``rescore=False`` skips steps 2-3: the top-n prescores come back in
device order (``precision='auto'`` then stores bf16), as in the
reference.  ``kernel='xla'`` keeps float storage on the plain exact scan;
``kernel='pallas'`` selects the float kernels.

``document_top_pairwise_scores(n)`` runs the reference's pairwise pipeline
the same way: keyed pair candidates (or the exact blocked pass), the f32
pair rescore, the margin check against ``pairwise_eps`` with the 4x widen
and its width hint, then hydration.

The reference's other synchronous methods are here with its semantics:
``bulk_del_docs``, ``bulk_query_docs``, ``bulk_graph_update`` and
``bulk_keyval_update`` (one transaction each, rolled back when the block
raises), ``load()`` (pack now and prewarm the hydration row cache) and
``warmup()``.  A write moves the store's fingerprint, so the next search
repacks and never returns a deleted row: incrementally after a pure
append or a pure delete, as the reference does, else from a full rescan.

Sidecars as in the reference: with ``sidecar='auto'`` (the default) or
``True`` a cold open loads a current ``<db>.svsx`` instead of rescanning
the store (fetched beside a remote URL when the publisher shipped one),
``load()`` writes one for stores of ``SIDECAR_AUTO_MIN_DOCS`` and more
(always with ``True``), and ``close()`` publishes one per the same policy
or its ``write_sidecar`` override.  The file format is the reference's,
so each package loads the other's sidecar.

Not ported yet: ``AsyncKB``, metadata filters (``where=``, also on the
pairwise call), meshes, replicas and the host search route (with it the
deferred background upload of a cold pack).  Where a call needs one of
them it raises ``NotImplementedError`` naming what is missing.
"""

from __future__ import annotations

import json
import logging
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from .embeddings import make_embeddings_func
from .embeddings.base import (
    MAGNITUDE_TOLERANCE,
    wrap_embeddings_func_check_magnitude,
)
from .engine.index import RetrievalEngine
from .engine.packing import PackedCorpus
from .engine.sidecar import sidecar_path_for
from .store.blob import embedding_to_bytes
from .store.db import Database
from .store.tx import Tx
from .types import (
    DocumentAdder,
    DocumentDeleter,
    DocumentId,
    DocumentQuerier,
    DocumentRecord,
    EdgeId,
    EdgeRecord,
    EmbeddingFunc,
    GraphInterface,
    KeyValueInterface,
    NetworkXGraphTypes,
    Retrieval,
)
from .utils import (
    EventLoopThread,
    atomic_gzip_file,
    chunkify,
    delete_file_if_exists,
    resolve_to_local_uncompressed_file,
    try_fetch_remote_sidecar,
)
from .utils.topk_np import top_k_numpy
from .utils.trace import QueryStats, phase, profiler_trace
from .utils.typecheck import typeguard_exempt

log = logging.getLogger(__name__)

#: How many texts go to the embedding provider per request during bulk-add.
BULK_EMBEDDING_CHUNK_SIZE = 200

_OUT_OF_CONTEXT = "You may not call this function outside of the context manager!"

#: The ``'auto'`` sidecar policy persists the pack for stores of at least
#: this many docs (below it a rescan is cheap).
SIDECAR_AUTO_MIN_DOCS = 50_000


def _reconcile_embedding_func(
    db: Database, embedding_func: Optional[EmbeddingFunc]
) -> EmbeddingFunc:
    """The open-time handshake that makes a KB self-describing (the
    reference's four cases over constructor func x params stored in the
    DB): both known -> warn if they differ (constructor wins); only DB ->
    rebuild from stored params; only constructor -> persist its params;
    neither -> error (a brand-new DB needs a function)."""
    db.check_or_set_schema_version()
    with db.transaction() as tx:
        try:
            db_params = json.loads(tx.get_key("embedding_func_params"))
        except KeyError:
            db_params = None
    ctor_params = getattr(embedding_func, "__embedding_func_params__", None)

    if db_params is not None and ctor_params is not None:
        if db_params != ctor_params:
            log.warning(
                "You are overriding the embedding function stored in the "
                "database! Your function: %s, database function: %s",
                ctor_params,
                db_params,
            )
        assert embedding_func is not None
    elif db_params is not None:
        if embedding_func is not None:
            log.warning(
                "You are overriding the embedding function stored in the "
                "database! Your function: *unknown params*, database "
                "function: %s",
                db_params,
            )
        else:
            embedding_func = make_embeddings_func(db_params, trusted=False)
    elif ctor_params is not None:
        with db.transaction() as tx:
            tx.set_key("embedding_func_params", json.dumps(ctor_params))
        assert embedding_func is not None
    else:
        if embedding_func is not None:
            log.warning(
                "Cannot store this non-standard embeddings function to the "
                "database. You'll have to pass it explicitly to all future "
                "instantiations of this database."
            )
        else:
            raise RuntimeError(
                "No embedding function. You did not pass one to the "
                "constructor and there is not one in the database. Pass the "
                "embedding function on the *first* usage of a new database; "
                "it will be stored there for later use."
            )
    return embedding_func


def _open_database(
    local_path: Union[str, Path],
    force_fresh_db: bool,
    embedding_func: Optional[EmbeddingFunc],
) -> Tuple[Database, EmbeddingFunc]:
    if force_fresh_db:
        delete_file_if_exists(local_path)
        delete_file_if_exists(sidecar_path_for(local_path))
    db = Database(local_path)
    try:
        return db, _reconcile_embedding_func(db, embedding_func)
    except BaseException:
        db.close()
        raise


def _publish_sidecar(
    engine: RetrievalEngine,
    policy: Union[bool, str],
    db: Database,
    override: Optional[bool],
) -> None:
    """Close-time sidecar policy: leave a current ``<db>.svsx`` behind so
    consumers skip the cold-start rescan.  Never fatal — a failed write
    only costs the next opener a rescan.  Under ``'auto'`` a full store
    scan happens only when this connection wrote (``total_changes``); a
    pure consumer at most writes the pack it already holds."""
    if override is False or (override is None and policy is False):
        return
    auto = override is None and policy == "auto"
    min_docs = SIDECAR_AUTO_MIN_DOCS if auto else 0
    wrote = db.conn is not None and db.conn.total_changes > 0
    try:
        engine.write_sidecar_from_store(
            db,
            sidecar_path_for(db.path),
            min_docs=min_docs,
            scan_ok=(not auto) or wrote,
        )
    except Exception:
        log.warning("publish-time sidecar write failed", exc_info=True)


def _prebuilt_record(
    rec_id: Any, parent_id: Any, level: Any, text: Any, meta_str: Any
) -> Tuple[DocumentRecord, Optional[str]]:
    """Cacheable (record, meta_json) pair: the record's values are all
    immutable, so hits shallow-copy it and patch meta from the JSON."""
    return (
        {
            "id": rec_id,
            "parent_id": parent_id,
            "level": level,
            "text": text,
            "embedding": True,
            "meta": None,
        },
        meta_str,
    )


def _edge_record(
    row: "Tuple[EdgeId, DocumentId, DocumentId, DocumentId, Optional[float], bool]",
) -> EdgeRecord:
    edge_id, a, b, r, w, d = row
    return {
        "id": edge_id,
        "a": a,
        "b": b,
        "relationship": r,
        "weight": w,
        "directed": d,
    }


class DocRowCache:
    """Host cache of raw doc rows keyed by embedding id — hydration reads
    through it, so repeated batches do not re-read SQLite.  Emptied
    whenever ``Tx.change_token()`` moves (any write to the file)."""

    def __init__(
        self,
        max_rows: Optional[int] = None,
        max_bytes: Optional[int] = None,
    ) -> None:
        from .utils.env import env_int

        if max_rows is None:
            max_rows = env_int("SVS_TPU_DOC_CACHE_MAX_ROWS", 4_000_000)
        if max_bytes is None:
            max_bytes = env_int("SVS_TPU_DOC_CACHE_MAX_BYTES", 2_000_000_000)
        self.max_rows = max_rows
        self.max_bytes = max_bytes
        self._rows: Dict[int, Tuple[DocumentRecord, Optional[str]]] = {}
        self._token: Optional[Tuple[int, int]] = None
        self._warm = False

    def is_warm_for(self, tx: Tx) -> bool:
        """True when the cache is prewarmed AND current."""
        return self._warm and tx.change_token() == self._token

    def prewarm(self, tx: Tx) -> int:
        """Load every embedded document's raw row up front (one full
        scan), within ``max_rows`` / ``max_bytes``.  Returns the number of
        cached rows (0 = over budget, demand-filled behavior kept)."""
        token = tx.change_token()
        rows: Dict[int, Tuple[DocumentRecord, Optional[str]]] = {}
        approx_bytes = 0
        for emb_id, rec_id, parent_id, level, text, meta_str in (
            tx.iter_doc_rows_with_emb()
        ):
            rows[int(emb_id)] = _prebuilt_record(
                rec_id, parent_id, level, text, meta_str
            )
            approx_bytes += len(text) + (len(meta_str) if meta_str else 0)
            if len(rows) > self.max_rows or approx_bytes > self.max_bytes:
                return 0
        self._rows = rows
        self._token = token
        self._warm = True
        return len(rows)

    def rows_for(
        self, tx: Tx, emb_ids: List[int]
    ) -> Dict[int, Tuple[DocumentRecord, Optional[str]]]:
        """Prebuilt doc records for ``emb_ids``, reading through the
        cache."""
        token = tx.change_token()
        if token != self._token:
            self._rows.clear()
            self._warm = False
            self._token = token
        rows = self._rows
        if self._warm:
            return rows
        missing = [e for e in emb_ids if e not in rows]
        if missing:
            fetched = {
                emb_id: _prebuilt_record(*raw)
                for emb_id, raw in tx.fetch_doc_rows_by_emb_ids(
                    missing
                ).items()
            }
            if len(rows) + len(fetched) > self.max_rows:
                out = {e: rows[e] for e in emb_ids if e in rows}
                out.update(fetched)
                self._rows = fetched if len(fetched) <= self.max_rows else {}
                return out
            rows.update(fetched)
        return rows


def _hydrate_and_mint(
    tx: Tx,
    top_emb: np.ndarray,
    top_scores: np.ndarray,
    doc_cache: Optional[DocRowCache],
) -> List[List[Retrieval]]:
    """One batched hydration for the whole batch's unique docs, then
    fresh, never-aliasing hit dicts."""
    emb_list: List[List[int]] = top_emb.tolist()
    score_list: List[List[float]] = np.asarray(
        top_scores, dtype=np.float32
    ).tolist()
    if doc_cache is not None and doc_cache.is_warm_for(tx):
        row_by_emb = doc_cache.rows_for(tx, [])
    else:
        unique_emb = [int(e) for e in np.unique(top_emb)]
        if doc_cache is not None:
            row_by_emb = doc_cache.rows_for(tx, unique_emb)
        else:
            row_by_emb = {
                emb_id: _prebuilt_record(*raw)
                for emb_id, raw in tx.fetch_doc_rows_by_emb_ids(
                    unique_emb
                ).items()
            }
    loads = json.loads
    results: List[List[Retrieval]] = []
    for scores_b, embs_b in zip(score_list, emb_list):
        hits: List[Retrieval] = []
        for score, emb_id in zip(scores_b, embs_b):
            rec, meta_str = row_by_emb[emb_id]
            doc = dict(rec)
            if meta_str is not None:
                doc["meta"] = loads(meta_str)
            hits.append({"score": score, "doc": doc})  # type: ignore[typeddict-item]
        results.append(hits)
    return results


def _finalize_device_final(
    tx: Tx,
    corpus: PackedCorpus,
    emb: np.ndarray,
    scores: np.ndarray,
    boundary: np.ndarray,
    c_count: int,
    pre_eps: Optional[np.ndarray],
    doc_cache: Optional[DocRowCache] = None,
) -> Optional[List[List[Retrieval]]]:
    """Finalize the on-device pipeline's result: the device already
    rescored in exact f32 and selected with the reference tie rule, so the
    host's only math is the margin proof — if any query's weakest returned
    score does not clear the boundary prescore by its error bound, return
    ``None`` so the caller widens the candidates."""
    if emb.size == 0:
        return [[] for _ in range(emb.shape[0])]
    verify = pre_eps is not None and c_count < corpus.n_valid
    if verify:
        v_k = scores[:, -1]
        if np.any(v_k < boundary + np.asarray(pre_eps)):
            return None
    return _hydrate_and_mint(tx, emb, scores, doc_cache)


def _finalize_batch(
    tx: Tx,
    corpus: PackedCorpus,
    vectors: np.ndarray,
    pre_vals: np.ndarray,
    pre_rows: np.ndarray,
    k: int,
    pre_eps: Optional[np.ndarray],
    doc_cache: Optional[DocRowCache] = None,
    device_exact: Optional[np.ndarray] = None,
) -> Optional[List[List[Retrieval]]]:
    """The reference's host-finalised rescore: exact f32 scores of the
    candidates ``pre_rows`` (pack rows), the reference tie rule, the
    margin proof, hydration.

    The scores are ``device_exact`` when the engine rescored on the
    device; else one BLAS matvec per query over the rows gathered from the
    pack's host f32 cache (``host_f32[rows] @ q``, the reference's own
    call, so the scores are bit-identical to it); without a host cache,
    over the rows of one ``fetch_embedding_rows`` of the union of
    candidates.  Returns ``None`` when some query's k-th exact score does
    not clear the boundary prescore ``pre_vals[:, -1]`` by ``pre_eps``
    (unless every document was a candidate): the caller widens."""
    n_queries = vectors.shape[0]
    if pre_rows.size == 0:
        return [[] for _ in range(n_queries)]
    c_count = pre_rows.shape[1]
    k_eff = min(k, c_count)
    vec32 = vectors.astype(np.float32, copy=False)
    if device_exact is not None:
        exact = np.asarray(device_exact, dtype=np.float32)
    elif corpus.host_f32 is not None:
        exact = np.empty((n_queries, c_count), dtype=np.float32)
        hf, rm = corpus.host_f32, corpus.host_row_map
        for b in range(n_queries):
            rows_b = pre_rows[b] if rm is None else rm[pre_rows[b]]
            exact[b] = hf[rows_b] @ vec32[b]
    else:
        exact = np.empty((n_queries, c_count), dtype=np.float32)
        unique_rows = np.unique(pre_rows)
        sub_matrix = tx.fetch_embedding_rows(corpus.emb_ids[unique_rows])
        pos_arr = np.searchsorted(unique_rows, pre_rows)  # [B, C]
        for b in range(n_queries):
            exact[b] = sub_matrix[pos_arr[b]] @ vec32[b]
    # the reference tie rule: equal scores break to the LARGER emb id, so
    # order the candidates by emb id, then a reversed stable argsort
    emb_of = corpus.emb_ids[pre_rows]  # [B, C]
    id_order = np.argsort(emb_of, axis=1, kind="stable")
    exact_o = np.take_along_axis(exact, id_order, axis=1)
    rows_o = np.take_along_axis(pre_rows, id_order, axis=1)
    rev = exact_o[:, ::-1]
    order_rev = np.argsort(-rev, axis=1, kind="stable")[:, :k_eff]
    order = c_count - 1 - order_rev
    top_scores = np.take_along_axis(exact_o, order, axis=1)
    top_rows = np.take_along_axis(rows_o, order, axis=1)
    if pre_eps is not None and c_count < corpus.n_valid and k_eff > 0:
        # no non-candidate's true score can pass its prescore (at most the
        # boundary) plus the error bound
        v_k = top_scores[:, k_eff - 1]
        if np.any(v_k < pre_vals[:, -1] + np.asarray(pre_eps)):
            return None
    return _hydrate_and_mint(tx, corpus.emb_ids[top_rows], top_scores, doc_cache)


def _finalize_prescores(
    tx: Tx,
    corpus: PackedCorpus,
    pre_vals: np.ndarray,
    pre_rows: np.ndarray,
    k: int,
    doc_cache: Optional[DocRowCache] = None,
) -> List[List[Retrieval]]:
    """The ``rescore=False`` branch of the reference's ``_finalize_batch``:
    raw device prescores in device order.  Among exactly tied scores the
    device breaks toward the SMALLER pack row and fetched only ``k``
    candidates, so the reference tie rule does not apply here."""
    if pre_rows.size == 0:
        return [[] for _ in range(pre_rows.shape[0])]
    k_eff = min(k, pre_rows.shape[1])
    top_emb = corpus.emb_ids[pre_rows[:, :k_eff]]
    return _hydrate_and_mint(tx, top_emb, pre_vals[:, :k_eff], doc_cache)


def _finalize_pairwise(
    tx: Tx,
    corpus: PackedCorpus,
    pre_vals: np.ndarray,
    rows_a: np.ndarray,
    rows_b: np.ndarray,
    k: int,
    rescore: bool,
    pre_eps: Optional[float] = None,
    device_rescorer: Optional[
        Callable[[np.ndarray, np.ndarray], Optional[np.ndarray]]
    ] = None,
) -> Optional[List[Tuple[float, DocumentRecord, DocumentRecord]]]:
    """Hydrate the top pairs, f32-rescoring the candidates first when
    ``rescore`` is on.  Returns ``None`` when the margin check fails: the
    k-th rescored score must clear the boundary prescore ``pre_vals[-1]``
    by ``pre_eps`` unless the candidates were every pair.

    The exact scores come from ``device_rescorer`` (the engine's
    ``pairwise_rescore``); when it declines, from the host f32 rows in
    4096-pair blocks (one flat gather would hold 2·C·d floats); without
    host rows either, from the stored vectors in SQLite."""
    emb_a = corpus.emb_ids[rows_a]
    emb_b = corpus.emb_ids[rows_b]
    n_pairs = len(emb_a)
    if n_pairs == 0:
        return []
    total_pairs = corpus.n_valid * (corpus.n_valid - 1) // 2
    if rescore:
        exact: Optional[np.ndarray] = None
        if device_rescorer is not None:
            exact = device_rescorer(np.asarray(rows_a), np.asarray(rows_b))
        if exact is None and corpus.host_f32 is not None:
            ra = np.asarray(rows_a, dtype=np.int64)
            rb = np.asarray(rows_b, dtype=np.int64)
            if corpus.host_row_map is not None:
                ra = corpus.host_row_map[ra]
                rb = corpus.host_row_map[rb]
            host = corpus.host_f32
            exact = np.empty((n_pairs,), dtype=np.float32)
            blk = 4096
            for i in range(0, n_pairs, blk):
                exact[i : i + blk] = np.einsum(
                    "ij,ij->i", host[ra[i : i + blk]], host[rb[i : i + blk]]
                )
        elif exact is None:
            unique = sorted(set(map(int, emb_a)) | set(map(int, emb_b)))
            vectors = tx.fetch_embedding_rows(unique)
            pos = {e: i for i, e in enumerate(unique)}
            va = vectors[[pos[int(e)] for e in emb_a]]
            vb = vectors[[pos[int(e)] for e in emb_b]]
            exact = np.einsum("ij,ij->i", va, vb)
        order = top_k_numpy(exact, k)
        triples = [(score, int(emb_a[i]), int(emb_b[i])) for score, i in order]
        if pre_eps is not None and n_pairs < total_pairs and triples:
            if triples[-1][0] < float(pre_vals[-1]) + pre_eps:
                return None
    else:
        triples = [
            (float(pre_vals[i]), int(emb_a[i]), int(emb_b[i]))
            for i in range(min(k, n_pairs))
        ]
    doc_by_emb = tx.fetch_docs_by_emb_ids(
        sorted({e for _, e1, e2 in triples for e in (e1, e2)})
    )
    return [(score, doc_by_emb[e1], doc_by_emb[e2]) for score, e1, e2 in triples]


def _resolve_device(device: Any) -> torch.device:
    """``device=None`` means the CUDA device — never a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "svs_tpu_torch.KB runs on a CUDA device and none is "
                "available; pass device='cpu' explicitly for a CPU run"
            )
        return torch.device("cuda")
    return torch.device(device)


class KB:
    """Synchronous knowledge base: same constructor and retrieval surface
    as ``svs_tpu.KB``, on one CUDA device (``device='cpu'`` runs the
    kernels' plain versions, for tests)."""

    def __init__(
        self,
        local_path_or_remote_url: Union[Path, str],
        embedding_func: Optional[EmbeddingFunc] = None,
        force_fresh_db: bool = False,
        *,
        precision: str = "auto",
        rescore: Optional[bool] = None,
        mesh: Optional[Any] = None,
        device: Optional[Any] = None,
        sidecar: Union[bool, str] = "auto",
        kernel: str = "auto",
        device_rescore: str = "auto",
        replicas: Optional[Any] = None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (sharded corpora) is not ported to svs_tpu_torch yet"
            )
        if replicas is not None:
            raise NotImplementedError(
                "replicas= is not ported to svs_tpu_torch yet"
            )
        self.local_path_or_remote_url = local_path_or_remote_url
        self.embedding_func = embedding_func
        self.embedding_func_orig = embedding_func
        self.engine = RetrievalEngine(
            precision=precision,
            rescore=rescore,
            device=_resolve_device(device),
            kernel=kernel,
            device_rescore=device_rescore,
        )
        self.sidecar = sidecar
        self._stats = QueryStats()
        self._doc_cache = DocRowCache()
        self._lock = threading.Lock()
        self._loop = EventLoopThread()
        self.db: Optional[Database] = None
        try:
            local_path = self._loop.run(
                resolve_to_local_uncompressed_file(local_path_or_remote_url)
            )
            if sidecar is not False and not force_fresh_db:
                # publishers ship <db>.svsx beside a remote <db>(.gz)
                self._loop.run(
                    try_fetch_remote_sidecar(local_path_or_remote_url, local_path)
                )
            self.db, self.embedding_func = _open_database(
                local_path, force_fresh_db, embedding_func
            )
        except BaseException:
            self._loop.stop()
            raise

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Rolling per-phase timing stats plus ``pack_events`` (how each
        freshness check was satisfied) and ``dispatch`` counters."""
        out = self._stats.snapshot()
        out["pack_events"] = {
            k: float(v) for k, v in self.engine.pack_events.items()
        }
        out["dispatch"] = self.engine.dispatch_stats()
        return out

    def _require_db(self) -> Database:
        if self.db is None:
            raise RuntimeError("KB is closed")
        return self.db

    def _sidecar_path(self) -> Optional[Path]:
        if self.sidecar is False or self.db is None:
            return None
        return sidecar_path_for(self.db.path)

    def _ensure_engine_fresh(self) -> PackedCorpus:
        return self.engine.ensure_fresh(self._require_db(), self._sidecar_path())

    def load(self) -> None:
        """Pack the device corpus now, write a sidecar per the policy
        (``True``, or ``'auto'`` at ``SIDECAR_AUTO_MIN_DOCS`` docs and
        more), and prewarm the hydration row cache, so that batched
        hydration never reads the store."""
        with self._lock:
            corpus = self._ensure_engine_fresh()
            path = self._sidecar_path()
            if path is not None and (
                self.sidecar is True
                or (self.sidecar == "auto" and corpus.n_valid >= SIDECAR_AUTO_MIN_DOCS)
            ):
                self.engine.write_sidecar(path)
            with self._require_db().transaction() as tx:
                warmed = self._doc_cache.prewarm(tx)
            if warmed:
                log.info("hydration cache prewarmed (%d rows)", warmed)

    def warmup(
        self,
        batch_sizes: Sequence[int] = (1,),
        n: int = 16,
        rounds: int = 2,
        routes: str = "both",
    ) -> None:
        """Run ``rounds`` searches of random unit queries at each batch
        size (the ``warmup`` phase of :meth:`stats`), so that the kernels
        are built and the width hints set before live traffic.  ``routes``
        is accepted for the reference's signature: the host route is not
        ported, so every search takes the device route."""
        del routes
        with self._lock:
            corpus = self._ensure_engine_fresh()
        if corpus.n_valid == 0 or corpus.dim == 0:
            return
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            for _ in range(max(1, rounds)):
                v = rng.standard_normal((int(b), corpus.dim)).astype(np.float32)
                v /= np.linalg.norm(v, axis=1, keepdims=True)
                with phase("warmup", self._stats):
                    self._search_hydrated(corpus, v, min(n, corpus.n_valid))

    def close(
        self,
        vacuum: bool = False,
        also_gzip: bool = False,
        write_sidecar: Optional[bool] = None,
    ) -> None:
        """Publish a sidecar (``write_sidecar``: ``True`` always, ``False``
        never, ``None`` per the instance's policy), close the database
        (optionally VACUUM it and publish a ``.gz`` copy) and drop the
        device corpus."""
        self._loop.stop()
        with self._lock:
            if self.db is None:
                return
            db = self.db
            _publish_sidecar(self.engine, self.sidecar, db, write_sidecar)
            if vacuum:
                db.vacuum()
            db.close()
            path = db.path
            self.db = None
            self.embedding_func = self.embedding_func_orig
            self.engine.invalidate()
            self.engine.shutdown()
            if also_gzip:
                atomic_gzip_file(path, f"{path}.gz")

    def _checked_embedding_func(self) -> EmbeddingFunc:
        assert self.embedding_func  # true unless closed
        return wrap_embeddings_func_check_magnitude(
            self.embedding_func, MAGNITUDE_TOLERANCE
        )

    def _embed(self, texts: List[str]) -> List[List[float]]:
        return self._loop.run(self._checked_embedding_func()(texts))

    def _embed_to_bytes(self, texts: List[str]) -> List[bytes]:
        return [embedding_to_bytes(v) for v in self._embed(texts)]

    @typeguard_exempt
    @contextmanager
    def bulk_add_docs(self) -> Iterator[DocumentAdder]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True
                pending: List[Tuple[DocumentId, str]] = []

                def add_doc(
                    text: str,
                    parent_id: Optional[DocumentId] = None,
                    meta: Optional[Dict[str, Any]] = None,
                    no_embedding: bool = False,
                ) -> DocumentId:
                    assert in_context, _OUT_OF_CONTEXT
                    doc_id = tx.add_doc(text, parent_id, meta, None)
                    if not no_embedding:
                        pending.append((doc_id, text))
                    return doc_id

                try:
                    yield add_doc
                finally:
                    in_context = False
                for chunk in chunkify(pending, BULK_EMBEDDING_CHUNK_SIZE):
                    blobs = self._embed_to_bytes([t for _, t in chunk])
                    for (doc_id, _), blob in zip(chunk, blobs):
                        tx.set_doc_embedding(doc_id, blob, skip_check_old=True)
                if pending:
                    tx.bump_matrix_version()

    @typeguard_exempt
    @contextmanager
    def bulk_del_docs(self) -> Iterator[DocumentDeleter]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True

                def del_doc(doc_id: DocumentId) -> None:
                    assert in_context, _OUT_OF_CONTEXT
                    tx.del_doc(doc_id)

                try:
                    yield del_doc
                finally:
                    in_context = False
                tx.bump_matrix_version()

    @typeguard_exempt
    @contextmanager
    def bulk_query_docs(self) -> Iterator[DocumentQuerier]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True

                class Querier(DocumentQuerier):
                    def count(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.count_docs()

                    def query_doc(
                        self, doc_id: DocumentId, include_embedding: bool = False
                    ) -> DocumentRecord:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.fetch_doc(doc_id, include_embedding)

                    def query_children(
                        self, doc_id: DocumentId, include_embedding: bool = False
                    ) -> List[DocumentRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.fetch_doc_children(doc_id, include_embedding)

                    def query_level(
                        self,
                        level: int,
                        include_embedding: bool = False,
                        limit: Optional[int] = None,
                    ) -> List[DocumentRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.fetch_docs_at_level(
                            level, include_embedding, limit
                        )

                    def dfs_traversal(
                        self, include_embedding: bool = False
                    ) -> Iterator[DocumentRecord]:
                        def visit(doc: DocumentRecord) -> Iterator[DocumentRecord]:
                            yield doc
                            for child in self.query_children(
                                doc["id"], include_embedding
                            ):
                                yield from visit(child)

                        for root in self.query_level(0, include_embedding):
                            yield from visit(root)

                    def update_doc_meta(
                        self,
                        doc_id: DocumentId,
                        new_meta: Optional[Dict[str, Any]],
                    ) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        tx.update_doc_meta(doc_id, new_meta)

                try:
                    yield Querier()
                finally:
                    in_context = False

    @typeguard_exempt
    @contextmanager
    def bulk_graph_update(self) -> Iterator[GraphInterface]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True

                class Graph(GraphInterface):
                    def count_edges(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.count_edges()

                    def add_directed_edge(
                        self,
                        from_doc: DocumentId,
                        to_doc: DocumentId,
                        relationship: DocumentId,
                        weight: Optional[float] = None,
                    ) -> EdgeId:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.add_directed_edge(
                            from_doc, to_doc, relationship, weight
                        )

                    def add_edge(
                        self,
                        doc1: DocumentId,
                        doc2: DocumentId,
                        relationship: DocumentId,
                        weight: Optional[float] = None,
                    ) -> EdgeId:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.add_edge(doc1, doc2, relationship, weight)

                    def del_edge(self, edge_id: EdgeId) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        tx.del_edge(edge_id)

                    def edges(
                        self, limit: Optional[int] = None, offset: int = 0
                    ) -> List[EdgeRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        return [
                            _edge_record(row)
                            for row in tx.list_edges(limit, offset)
                        ]

                    def build_networkx_graph(
                        self, multigraph: bool = True
                    ) -> NetworkXGraphTypes:
                        # networkx is imported by the Tx, only when called
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.build_networkx_graph(multigraph)

                try:
                    yield Graph()
                finally:
                    in_context = False

    @typeguard_exempt
    @contextmanager
    def bulk_keyval_update(self) -> Iterator[KeyValueInterface]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True

                class KeyVal(KeyValueInterface):
                    def has(self, key: str) -> bool:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.has_key_user(key)

                    def __contains__(self, key: str) -> bool:
                        return self.has(key)

                    def get(self, key: str, default: Any = KeyError) -> Any:
                        assert in_context, _OUT_OF_CONTEXT
                        try:
                            return tx.get_key_user(key)
                        except KeyError:
                            if default is KeyError:
                                raise
                            return default

                    def __getitem__(self, key: str) -> Any:
                        return self.get(key)

                    def set(self, key: str, val: Any) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        tx.set_key_user(key, val)

                    def __setitem__(self, key: str, val: Any) -> None:
                        self.set(key, val)

                    def remove(self, key: str) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        tx.del_key_user(key)

                    def __delitem__(self, key: str) -> None:
                        self.remove(key)

                    def count(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.count_keys_user()

                    def __len__(self) -> int:
                        return self.count()

                    def items(self) -> Iterator[Tuple[str, Any]]:
                        assert in_context, _OUT_OF_CONTEXT
                        yield from tx.iter_keyval_user()

                    def __iter__(self) -> Iterator[str]:
                        assert in_context, _OUT_OF_CONTEXT
                        yield from tx.iter_keys_user()

                try:
                    yield KeyVal()
                finally:
                    in_context = False

    def retrieve(self, query: str, n: int, where: None = None) -> List[Retrieval]:
        return self.retrieve_batch([query], n, where=where)[0]

    def retrieve_batch(
        self, queries: List[str], n: int, where: None = None
    ) -> List[List[Retrieval]]:
        """Top-``n`` documents for every query, exact: scores are f32 dots
        of the stored vectors, ties break to the larger embedding id.
        With ``rescore=False`` they are the device prescores instead, in
        device order."""
        if where is not None:
            raise NotImplementedError(
                "where= (filtered retrieval) is not ported to svs_tpu_torch yet"
            )
        if not queries:
            return []
        log.info("retrieving top %d for %d queries", n, len(queries))
        with phase("pack", self._stats), self._lock:
            corpus = self._ensure_engine_fresh()
        if corpus.n_valid == 0 or n <= 0:
            return [[] for _ in queries]
        with phase("embed", self._stats):
            vectors = np.asarray(self._embed(queries), dtype=np.float32)
        return self._search_hydrated(corpus, vectors, n)

    def _search_hydrated(
        self, corpus: PackedCorpus, vectors: np.ndarray, n: int
    ) -> List[List[Retrieval]]:
        c = c0 = self.engine.initial_candidates(n, corpus.n_valid)
        if not self.engine.rescore:
            with phase("device_search", self._stats), profiler_trace("retrieve"):
                pre_vals, pre_rows = self.engine.topk(corpus, vectors, c)
            with phase("finalize", self._stats), self._lock:
                db = self._require_db()
                with db.transaction() as tx:
                    results = _finalize_prescores(
                        tx, corpus, pre_vals, pre_rows, n,
                        doc_cache=self._doc_cache,
                    )
            self.engine.record_candidates(n, c, widened=False)
            return results
        while True:
            # recomputed each retry: the v2/v3 dispatch (and its key-eps
            # term) depends on the current c
            pre_eps = self.engine.prescore_eps(corpus, vectors, c)
            with phase("device_search", self._stats), profiler_trace("retrieve"):
                final = self.engine.topk_final(corpus, vectors, n, c)
                if final is None:
                    # no device mirror, or a gather past its ceiling: the
                    # host rescores the prescored candidates
                    pre_vals, pre_rows, dev_exact = self.engine.topk_with_rescore(
                        corpus, vectors, c
                    )
            with phase("finalize", self._stats), self._lock:
                db = self._require_db()
                with db.transaction() as tx:
                    if final is not None:
                        emb, scores, boundary = final
                        results = _finalize_device_final(
                            tx, corpus, emb, scores, boundary,
                            min(c, corpus.n_valid), pre_eps,
                            doc_cache=self._doc_cache,
                        )
                    else:
                        results = _finalize_batch(
                            tx, corpus, vectors, pre_vals, pre_rows, n,
                            pre_eps, doc_cache=self._doc_cache,
                            device_exact=dev_exact,
                        )
            if results is not None:
                self.engine.record_candidates(n, c, widened=(c != c0))
                return results
            self.engine.widen_retries += 1
            c = min(corpus.n_valid, c * 4)
            log.info(
                "rescore margin insufficient at the candidate boundary; "
                "widening device candidates to %d and retrying", c,
            )

    def document_top_pairwise_scores(
        self, n: int, where: None = None
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """The ``n`` most similar document pairs, exact: ``(score, doc,
        doc)`` by descending f32 score of the stored vectors (with
        ``rescore=False``, the device prescores in device order)."""
        if where is not None:
            raise NotImplementedError(
                "where= (filtered pairwise) is not ported to svs_tpu_torch yet"
            )
        with self._lock:
            corpus = self._ensure_engine_fresh()
        if corpus.n_valid < 2 or n <= 0:
            return []
        c = n
        c0 = None
        pre_eps = None
        if self.engine.rescore:
            c0 = c = self.engine.initial_pairwise_candidates(n, corpus.n_valid)
            pre_eps = self.engine.pairwise_eps(corpus)
        total_pairs = corpus.n_valid * (corpus.n_valid - 1) // 2
        while True:
            with phase("pairwise_search", self._stats), profiler_trace("pairwise"):
                vals, rows_a, rows_b = self.engine.pairwise_topk(corpus, c)
            with phase("pairwise_finalize", self._stats), self._lock:
                db = self._require_db()
                with db.transaction() as tx:
                    results = _finalize_pairwise(
                        tx, corpus, vals, rows_a, rows_b, n,
                        self.engine.rescore, pre_eps,
                        device_rescorer=lambda ra, rb:
                            self.engine.pairwise_rescore(corpus, ra, rb),
                    )
            if results is not None:
                if c0 is not None:
                    self.engine.record_pairwise_candidates(
                        n, c, widened=(c != c0)
                    )
                return results
            self.engine.widen_retries += 1
            c = min(total_pairs, c * 4)
            log.info("pairwise rescore margin insufficient; widening to %d", c)

    def __len__(self) -> int:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                return tx.count_docs()
