"""The knowledge-base facades :class:`KB` (synchronous) and
:class:`AsyncKB` (port of ``svs_tpu.kb``).

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

Metadata filters as in the reference: ``where=`` takes a dict of meta
equalities, a :func:`meta_filter_predicate`, or any predicate over the
hydrated record.  A declarative filter matching few rows (the
:class:`MetaRowIndex` lookup within ``_PREFILTER_MAX_ROWS`` and a quarter
of the corpus, or no more than ``n``) scores only those rows
(``RetrievalEngine.subset_topk``); any other filter runs the post-filter
ladder, exact top-``m`` prefixes from ``m = 4n`` widening 4x until every
query has ``n`` survivors.  Filtered pairwise runs the pairwise loop on a
derived corpus of the matching rows.

The reference's other methods are here with its semantics:
``bulk_del_docs``, ``bulk_query_docs``, ``bulk_graph_update`` and
``bulk_keyval_update`` (one transaction each, rolled back when the block
raises), ``load()`` (pack now and prewarm the hydration row cache) and
``warmup()``.  A write moves the store's fingerprint, so the next search
repacks and never returns a deleted row: incrementally after a pure
append or a pure delete, as the reference does, else from a full rescan.
:class:`AsyncKB` opens its database lazily, awaits the embedding function
on the caller's event loop and runs the heavy work in the loop's
executor; both facades run one copy of the search loops
(:class:`_Searcher`).

Sidecars as in the reference: with ``sidecar='auto'`` (the default) or
``True`` a cold open loads a current ``<db>.svsx`` instead of rescanning
the store (fetched beside a remote URL when the publisher shipped one),
``load()`` writes one for stores of ``SIDECAR_AUTO_MIN_DOCS`` and more
(always with ``True``), and ``close()`` publishes one per the same policy
or its ``write_sidecar`` override.  The file format is the reference's,
so each package loads the other's sidecar.

The host route: a call answers from the host f32 rows (``host_search``
in :meth:`KB.stats`) while a cold pack uploads in the background, or
always under ``SVS_TPU_HOST_DISPATCH=force`` (``off``: never).  With the
pack on the card ``auto`` takes the device; ``svs_tpu`` also sends a call
to the host when an estimated host scan beats the device's measured round
trip, which this port does not (``RetrievalEngine.host_route``).

Meshes and replicas as in the reference: ``mesh=`` (a
``parallel.default_mesh`` / ``mesh_2d``) shards the corpus over several
devices and every search runs per shard (filtered pairwise then
post-filters the exact global pair prefix), ``replicas=`` copies it to
several devices and splits each batch across them.  A mesh or a replica
list may repeat a device (``[torch.device('cpu')] * 4`` on the CPU).
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from contextlib import asynccontextmanager, contextmanager
from pathlib import Path
from typing import (
    Any,
    AsyncIterator,
    Callable,
    ContextManager,
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
    AsyncDocumentAdder,
    AsyncDocumentDeleter,
    AsyncDocumentQuerier,
    AsyncGraphInterface,
    AsyncKeyValueInterface,
    DocumentAdder,
    DocumentDeleter,
    DocumentId,
    DocumentPredicate,
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
    db: Database, embedding_func: Optional[EmbeddingFunc], device: torch.device
) -> EmbeddingFunc:
    """The open-time handshake that makes a KB self-describing (the
    reference's four cases over constructor func x params stored in the
    DB): both known -> warn if they differ (constructor wins); only DB ->
    rebuild from stored params (a ``local`` provider on the KB's
    ``device``); only constructor -> persist its params; neither -> error
    (a brand-new DB needs a function)."""
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
            embedding_func = make_embeddings_func(
                db_params, trusted=False, device=device
            )
    elif ctor_params is not None:
        # immediate, and unless another opener stored params meanwhile:
        # processes opening one new database together must not deadlock
        with db.transaction(immediate=True) as tx:
            try:
                tx.get_key("embedding_func_params")
            except KeyError:
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
    device: torch.device,
) -> Tuple[Database, EmbeddingFunc]:
    if force_fresh_db:
        delete_file_if_exists(local_path)
        delete_file_if_exists(sidecar_path_for(local_path))
    db = Database(local_path)
    try:
        return db, _reconcile_embedding_func(db, embedding_func, device)
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


def meta_filter_predicate(flt: Dict[str, Any]) -> DocumentPredicate:
    """A :data:`~svs_tpu_torch.types.DocumentPredicate` testing meta-key
    equalities: every key in ``flt`` must be present in the document's
    meta with exactly the given value (docs without meta match only the
    empty filter).  Passing the dict itself as ``where=`` is the same as
    passing this predicate.

    The returned predicate carries its spec (``__meta_filter__``), which
    lets the facades take the pre-filter route for selective filters: look
    the matching emb ids up in the :class:`MetaRowIndex` and score only
    those rows (``RetrievalEngine.subset_topk``) instead of widening an
    exact global prefix.  Hand-written predicates are opaque — they always
    take the post-filter ladder."""

    def predicate(doc: DocumentRecord) -> bool:
        meta = doc.get("meta") or {}
        return all(k in meta and meta[k] == v for k, v in flt.items())

    predicate.__meta_filter__ = dict(flt)  # type: ignore[attr-defined]
    return predicate


class MetaRowIndex:
    """Map from a meta equality ``(key, value)`` to the sorted emb ids of
    the matching documents — the lookup side of pre-filter retrieval,
    dropped whole on ANY store change (``Tx.change_token``, the
    :class:`DocRowCache` gate).

    Entries build lazily on first lookup.  Scalar equalities evaluate
    inside SQLite (``Tx.meta_eq_emb_ids``, a JSON1 scan, no per-row Python
    JSON parse); pairs SQL cannot express with Python-equality semantics
    batch into ONE ``(emb_id, meta)`` Python scan evaluating literally the
    comparison of :func:`meta_filter_predicate` (``key in meta and
    meta[key] == value``), so the routes never disagree.  At most
    ``max_entries`` pairs are kept (first in, first out)."""

    def __init__(self, max_entries: int = 64) -> None:
        self._token: Optional[Tuple[int, int]] = None
        self._entries: Dict[Tuple[str, str], np.ndarray] = {}
        self.max_entries = max_entries

    def _store(self, ck: Tuple[str, str], ids: np.ndarray) -> None:
        while len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))
        self._entries[ck] = ids

    @staticmethod
    def canonical(flt: Dict[str, Any]) -> str:
        """Canonical cache string for a filter dict (sorted, compact)."""
        return json.dumps(flt, sort_keys=True, separators=(",", ":"))

    def lookup(self, tx: Tx, flt: Dict[str, Any]) -> Optional[np.ndarray]:
        """Sorted int64 emb ids of documents matching EVERY equality in
        ``flt``, or ``None`` for the empty filter (it matches everything).
        Raises ``TypeError`` for a value ``json.dumps`` refuses (it cannot
        be cache-keyed: the caller takes the ladder)."""
        if not flt:
            return None
        token = tx.change_token()
        if token != self._token:
            self._entries.clear()
            self._token = token
        keys = [
            (k, json.dumps(v, sort_keys=True, separators=(",", ":")))
            for k, v in flt.items()
        ]
        # resolve into a LOCAL map: `_store`'s eviction may drop an entry
        # this very lookup still needs once the cache is full
        have: Dict[Tuple[str, str], np.ndarray] = {}
        scan: List[Tuple[str, str]] = []
        for ck in keys:
            cached = self._entries.get(ck)
            if cached is not None:
                have[ck] = cached
                continue
            ids_sql = tx.meta_eq_emb_ids(ck[0], flt[ck[0]])
            if ids_sql is None:
                scan.append(ck)
            else:
                have[ck] = np.asarray(ids_sql, dtype=np.int64)
                self._store(ck, have[ck])
        if scan:
            want = {ck: (ck[0], flt[ck[0]]) for ck in scan}
            found: Dict[Tuple[str, str], List[int]] = {ck: [] for ck in scan}
            loads = json.loads
            for emb_id, meta_str in tx.iter_emb_meta():
                if meta_str is None:
                    continue
                meta = loads(meta_str)
                for ck, (k, v) in want.items():
                    if k in meta and meta[k] == v:
                        found[ck].append(emb_id)
            for ck, ids in found.items():
                have[ck] = np.asarray(sorted(ids), dtype=np.int64)
                self._store(ck, have[ck])
        out = have[keys[0]]
        for ck in keys[1:]:
            out = np.intersect1d(out, have[ck], assume_unique=True)
        return out


#: Pre-filter ceiling: past this many matching rows the subset gather
#: stops beating the streamed full-corpus kernels, and the post-filter
#: ladder converges in one round anyway.
_PREFILTER_MAX_ROWS = 1 << 16


def _prefilter_emb_ids(
    tx: Tx,
    index: MetaRowIndex,
    corpus: PackedCorpus,
    flt: Dict[str, Any],
    n: int,
) -> Optional[np.ndarray]:
    """Matching emb ids when the pre-filter route should run, else
    ``None`` (unselective or unindexable filters take the post-filter
    ladder).  Gate: at most ``_PREFILTER_MAX_ROWS`` matches AND under a
    quarter of the corpus, OR no more matches than ``n`` (the answer is
    all of them, ranked)."""
    try:
        ids = index.lookup(tx, flt)
    except TypeError:
        # values json.dumps refuses (numpy scalars, sets, ...): the
        # ladder's predicate compares them with Python equality
        return None
    if ids is None:
        return None
    f = int(ids.size)
    if f <= n:
        return ids
    if f > _PREFILTER_MAX_ROWS or f * 4 > corpus.n_valid:
        return None
    return ids


def _filter_match_emb_ids(
    tx: Tx,
    index: MetaRowIndex,
    where: Union[DocumentPredicate, Dict[str, Any]],
) -> Optional[np.ndarray]:
    """Sorted emb ids of EVERY embedded document passing ``where``, or
    ``None`` when the filter matches everything (the empty dict) — the
    match set of filtered pairwise, which needs the whole subset up front.
    Declarative filters ride the :class:`MetaRowIndex`; opaque predicates
    pay one hydrated scan of the store."""
    flt = where if isinstance(where, dict) else getattr(where, "__meta_filter__", None)
    if flt is not None:
        if not flt:
            return None
        try:
            ids = index.lookup(tx, flt)
        except TypeError:
            ids = None  # unserializable values: the predicate scan below
        if ids is not None:
            return ids
    pred = meta_filter_predicate(where) if isinstance(where, dict) else where
    loads = json.loads
    out = [
        int(emb_id)
        for emb_id, rec_id, parent_id, level, text, meta_str
        in tx.iter_doc_rows_with_emb()
        if pred(
            {
                "id": rec_id,
                "parent_id": parent_id,
                "level": level,
                "text": text,
                "embedding": True,
                "meta": loads(meta_str) if meta_str is not None else None,
            }
        )
    ]
    return np.asarray(sorted(out), dtype=np.int64)


#: Initial over-fetch of the filter ladder: round r searches the exact
#: top ``min(n * 4^(r+1), n_valid)``, so a filter of selectivity s
#: converges in O(log_4(1/s)) rounds.
_FILTER_OVERFETCH = 4


def _filter_round(
    results: List[List[Retrieval]],
    pending: List[int],
    out: List[Optional[List[Retrieval]]],
    where: DocumentPredicate,
    n: int,
    n_valid: int,
    m: int,
) -> List[int]:
    """One round of the filter ladder.  ``results`` are the exact top-``m``
    lists of the queries at positions ``pending``; each keeps its first
    ``n`` predicate-passing hits.  Candidates arrive in exact global score
    order, so ``n`` survivors inside an exact top-``m`` prefix ARE the
    exact filtered top-``n``.  A query with fewer survivors is done only
    when the prefix covers the whole corpus (``m >= n_valid``); otherwise
    it stays pending for the next, 4x wider round.  Returns the positions
    still pending."""
    still: List[int] = []
    for qi, rlist in zip(pending, results):
        survivors: List[Retrieval] = []
        for r in rlist:
            if where(r["doc"]):
                survivors.append(r)
                if len(survivors) == n:
                    break
        if len(survivors) >= n or m >= n_valid:
            out[qi] = survivors
        else:
            still.append(qi)
    return still


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


def _make_engine(
    precision: str,
    rescore: Optional[bool],
    mesh: Optional[Any],
    device: Optional[Any],
    kernel: str,
    device_rescore: str,
    replicas: Optional[Any],
) -> RetrievalEngine:
    """The engine of both facades: on one device, on a mesh
    (``parallel.mesh.Mesh``: the corpus sharded, for capacity), or a
    :class:`~svs_tpu_torch.parallel.replicas.ReplicaEngine` when
    ``replicas`` is set (an int: the first N CUDA devices; or an explicit
    device sequence, taken as given: copies of the corpus, for
    throughput).  A mesh and replicas are different axes and mutually
    exclusive here."""
    if replicas is None:
        if mesh is not None:
            # the mesh places the shards; its first device is the engine's
            return RetrievalEngine(
                precision=precision,
                rescore=rescore,
                kernel=kernel,
                device_rescore=device_rescore,
                mesh=mesh,
            )
        return RetrievalEngine(
            precision=precision,
            rescore=rescore,
            device=_resolve_device(device),
            kernel=kernel,
            device_rescore=device_rescore,
        )
    if mesh is not None:
        raise ValueError(
            "mesh and replicas are mutually exclusive: a mesh SHARDS the "
            "corpus (capacity/latency), replicas COPY it (throughput)"
        )
    if device is not None:
        raise ValueError(
            "pass devices via replicas=[dev, ...] instead of device= in "
            "replica mode"
        )
    from .parallel.replicas import ReplicaEngine

    by_count = isinstance(replicas, int)
    return ReplicaEngine(
        precision=precision,
        rescore=rescore,
        n_replicas=replicas if by_count else None,
        devices=None if by_count else list(replicas),
        kernel=kernel,
        device_rescore=device_rescore,
    )


Where = Optional[Union[DocumentPredicate, Dict[str, Any]]]


class _Searcher:
    """The search loops of both facades, written once: the exact top-``n``
    loop with its margin widen, the pre-filter route, the filter ladder and
    the pairwise loop.  They take embedded query vectors and a packed
    corpus and run on the calling thread (:class:`KB`) or on an executor
    thread (:class:`AsyncKB`).  ``lock`` is the facade's lock as a context
    manager entered on that thread, held only around store access;
    ``require_db`` returns the open database or raises."""

    def __init__(
        self,
        engine: RetrievalEngine,
        stats: QueryStats,
        doc_cache: DocRowCache,
        meta_index: MetaRowIndex,
        lock: ContextManager[Any],
        require_db: Callable[[], Database],
    ) -> None:
        self.engine = engine
        self.stats = stats
        self.doc_cache = doc_cache
        self.meta_index = meta_index
        self.lock = lock
        self.require_db = require_db

    def retrieve(
        self, corpus: PackedCorpus, vectors: np.ndarray, n: int, where: Where
    ) -> List[List[Retrieval]]:
        """Exact top-``n`` of every query, among the documents passing
        ``where`` when one is given: the pre-filter route for a selective
        declarative filter, else the post-filter ladder."""
        if where is None:
            return self.search_hydrated(corpus, vectors, n)
        if isinstance(where, dict):
            flt: Optional[Dict[str, Any]] = where
            where = meta_filter_predicate(where)
        else:
            flt = getattr(where, "__meta_filter__", None)
        if flt is not None:
            fast = self.prefiltered(corpus, vectors, n, flt)
            if fast is not None:
                return fast
        m = min(corpus.n_valid, max(n * _FILTER_OVERFETCH, n))
        out: List[Optional[List[Retrieval]]] = [None] * len(vectors)
        pending = list(range(len(vectors)))
        while True:
            results = self.search_hydrated(corpus, vectors[pending], m)
            pending = _filter_round(results, pending, out, where, n, corpus.n_valid, m)
            if not pending:
                return [r if r is not None else [] for r in out]
            m = min(corpus.n_valid, m * 4)
            log.info(
                "filter left %d queries under-filled; widening the exact "
                "prefix to %d and retrying", len(pending), m,
            )

    def prefiltered(
        self,
        corpus: PackedCorpus,
        vectors: np.ndarray,
        n: int,
        flt: Dict[str, Any],
    ) -> Optional[List[List[Retrieval]]]:
        """The pre-filter route of a declarative filter: look the matching
        emb ids up, score only those rows exactly
        (``RetrievalEngine.subset_topk``), hydrate.  ``None`` when the gate
        or the engine declines: the caller runs the ladder."""
        with phase("filter_index", self.stats), self.lock:
            with self.require_db().transaction() as tx:
                ids = _prefilter_emb_ids(tx, self.meta_index, corpus, flt, n)
        if ids is None:
            return None
        if ids.size == 0:
            return [[] for _ in range(vectors.shape[0])]
        with phase("device_search", self.stats), profiler_trace("retrieve"):
            sub = self.engine.subset_topk(
                corpus, vectors, ids, n, MetaRowIndex.canonical(flt)
            )
        if sub is None:
            return None
        emb, scores = sub
        with phase("finalize", self.stats), self.lock:
            with self.require_db().transaction() as tx:
                return _hydrate_and_mint(tx, emb, scores, self.doc_cache)

    def search_hydrated(
        self, corpus: PackedCorpus, vectors: np.ndarray, n: int
    ) -> List[List[Retrieval]]:
        """Verified-exact top-``n`` search and hydration: the host route
        when the engine's rule takes it (``host_search``), else the device
        search (with ``rescore=False``, the device prescores in device
        order)."""
        engine = self.engine
        if engine.host_route(corpus):
            with phase("host_search", self.stats):
                emb, scores = engine.host_topk_exact(corpus, vectors, n)
            with phase("finalize", self.stats), self.lock:
                with self.require_db().transaction() as tx:
                    return _hydrate_and_mint(tx, emb, scores, self.doc_cache)
        c = c0 = engine.initial_candidates(n, corpus.n_valid)
        if not engine.rescore:
            with phase("device_search", self.stats), profiler_trace("retrieve"):
                pre_vals, pre_rows = engine.topk(corpus, vectors, c)
            with phase("finalize", self.stats), self.lock:
                with self.require_db().transaction() as tx:
                    results = _finalize_prescores(
                        tx, corpus, pre_vals, pre_rows, n, doc_cache=self.doc_cache
                    )
            engine.record_candidates(n, c, widened=False)
            return results
        while True:
            # recomputed each retry: the v2/v3 dispatch (and its key-eps
            # term) depends on the current c
            pre_eps = engine.prescore_eps(corpus, vectors, c)
            with phase("device_search", self.stats), profiler_trace("retrieve"):
                final = engine.topk_final(corpus, vectors, n, c)
                if final is None:
                    # no device mirror, or a gather past its ceiling: the
                    # host rescores the prescored candidates
                    pre_vals, pre_rows, dev_exact = engine.topk_with_rescore(
                        corpus, vectors, c
                    )
            with phase("finalize", self.stats), self.lock:
                with self.require_db().transaction() as tx:
                    if final is not None:
                        emb, scores, boundary = final
                        results = _finalize_device_final(
                            tx, corpus, emb, scores, boundary,
                            min(c, corpus.n_valid), pre_eps,
                            doc_cache=self.doc_cache,
                        )
                    else:
                        results = _finalize_batch(
                            tx, corpus, vectors, pre_vals, pre_rows, n,
                            pre_eps, doc_cache=self.doc_cache,
                            device_exact=dev_exact,
                        )
            if results is not None:
                engine.record_candidates(n, c, widened=(c != c0))
                return results
            engine.widen_retries += 1
            c = min(corpus.n_valid, c * 4)
            log.info(
                "rescore margin insufficient at the candidate boundary; "
                "widening device candidates to %d and retrying", c,
            )

    def warmup(
        self,
        corpus: PackedCorpus,
        batch_sizes: Sequence[int],
        n: int,
        rounds: int,
    ) -> None:
        """``rounds`` searches of random unit queries at each batch size
        (the ``warmup`` phase), each on the route a live call would take."""
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            for _ in range(max(1, rounds)):
                v = rng.standard_normal((int(b), corpus.dim)).astype(np.float32)
                v /= np.linalg.norm(v, axis=1, keepdims=True)
                with phase("warmup", self.stats):
                    self.search_hydrated(corpus, v, min(n, corpus.n_valid))

    def top_pairs(
        self, corpus: PackedCorpus, n: int, where: Where
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """The ``n`` most similar document pairs, both passing ``where``
        when one is given: the pairwise loop then runs on a derived corpus
        of the matching rows, exactly as on a store holding only those
        documents (and feeds no width hint: subset widths would pollute
        the full corpus's)."""
        engine = self.engine
        filtered = False
        if where is not None:
            with phase("filter_index", self.stats), self.lock:
                with self.require_db().transaction() as tx:
                    ids = _filter_match_emb_ids(tx, self.meta_index, where)
            if ids is not None:
                rows, present = corpus.rows_for_emb_ids(ids)
                if not bool(present.all()):
                    rows, ids = rows[present], ids[present]
                if rows.size < 2:
                    return []
                sub = engine.subset_pairwise_corpus(corpus, rows, ids)
                if sub is None:  # a mesh engine: no subset corpus
                    return self.pairwise_postfiltered(corpus, n, where)
                corpus = sub
                filtered = True
        if corpus.n_valid < 2 or n <= 0:
            return []
        c = n
        c0 = None
        pre_eps = None
        if engine.rescore:
            c0 = c = engine.initial_pairwise_candidates(n, corpus.n_valid)
            pre_eps = engine.pairwise_eps(corpus)
        total_pairs = corpus.n_valid * (corpus.n_valid - 1) // 2
        while True:
            with phase("pairwise_search", self.stats), profiler_trace("pairwise"):
                vals, rows_a, rows_b = engine.pairwise_topk(corpus, c)
            with phase("pairwise_finalize", self.stats), self.lock:
                with self.require_db().transaction() as tx:
                    results = _finalize_pairwise(
                        tx, corpus, vals, rows_a, rows_b, n,
                        engine.rescore, pre_eps,
                        device_rescorer=lambda ra, rb:
                            engine.pairwise_rescore(corpus, ra, rb),
                    )
            if results is not None:
                if c0 is not None and not filtered:
                    engine.record_pairwise_candidates(n, c, widened=(c != c0))
                return results
            engine.widen_retries += 1
            c = min(total_pairs, c * 4)
            log.info("pairwise rescore margin insufficient; widening to %d", c)


    def pairwise_postfiltered(
        self, corpus: PackedCorpus, n: int, where: Where
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """Filtered pairwise for engines without a subset corpus (a mesh):
        the exact global top-``c`` pairs, kept where BOTH documents pass,
        ``c`` widened 4x while fewer than ``n`` survive.  Exact: a passing
        pair outside an exact top-``c`` prefix scores at most the c-th
        pair, so at most the n-th survivor."""
        assert where is not None
        pred = meta_filter_predicate(where) if isinstance(where, dict) else where
        total = corpus.n_valid * (corpus.n_valid - 1) // 2
        c = max(n * _FILTER_OVERFETCH, n)
        while True:
            pairs = self.top_pairs(corpus, min(c, total), None)
            kept = [t for t in pairs if pred(t[1]) and pred(t[2])]
            if len(kept) >= n or c >= total:
                return kept[:n]
            c = min(total, c * 4)
            log.info(
                "pairwise filter under-filled (%d/%d); widening the exact "
                "pair prefix to %d", len(kept), n, c,
            )


class _LoopLock:
    """An :class:`AsyncKB`'s ``asyncio.Lock`` held from an executor thread:
    entering acquires it on the facade's event loop (which awaits the
    executor, so it is free to run the acquire), leaving releases it
    there."""

    def __init__(self, lock: asyncio.Lock, loop: asyncio.AbstractEventLoop) -> None:
        self._lock = lock
        self._loop = loop

    def __enter__(self) -> None:
        asyncio.run_coroutine_threadsafe(self._lock.acquire(), self._loop).result()

    def __exit__(self, *exc: Any) -> None:
        self._loop.call_soon_threadsafe(self._lock.release)


class _BulkCalls:
    """The store calls of one :class:`AsyncKB` bulk block: each runs on the
    loop's executor, one at a time, and only while the block is open."""

    def __init__(self, loop: asyncio.AbstractEventLoop) -> None:
        self.loop = loop
        self.lock = asyncio.Lock()
        self.open = True

    async def __call__(self, fn: Callable[..., Any], *args: Any) -> Any:
        assert self.open, _OUT_OF_CONTEXT
        async with self.lock:
            return await self.loop.run_in_executor(None, fn, *args)


class AsyncKB:
    """Asynchronous knowledge base for web services and pipelines: the
    constructor and methods of ``svs_tpu.AsyncKB``, on one CUDA device
    (``device='cpu'`` runs the kernels' plain versions, for tests).

    The database opens lazily on first use (or on :meth:`load`), and the
    instance can be used again after :meth:`close`.  One ``asyncio.Lock``
    serializes store access.  The embedding function is awaited on the
    caller's event loop (a function bound to that loop, such as one holding
    an HTTP session, keeps working); opening, packing, searching,
    hydrating, sidecar publishing, VACUUM and gzip run in the loop's
    executor."""

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
        self.local_path_or_remote_url = local_path_or_remote_url
        self.db: Optional[Database] = None
        self.db_lock: Optional[asyncio.Lock] = None
        self.embedding_func = embedding_func
        self.embedding_func_orig = embedding_func
        self.force_fresh_db = force_fresh_db
        self.engine = _make_engine(
            precision, rescore, mesh, device, kernel, device_rescore, replicas
        )
        self.sidecar = sidecar
        self._stats = QueryStats()
        self._doc_cache = DocRowCache()
        self._meta_index = MetaRowIndex()

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Rolling per-phase timing stats plus ``pack_events`` (how each
        freshness check was satisfied) and ``dispatch`` counters."""
        out = self._stats.snapshot()
        out["pack_events"] = {
            k: float(v) for k, v in self.engine.pack_events.items()
        }
        out["dispatch"] = self.engine.dispatch_stats()
        return out

    # -- plumbing ------------------------------------------------------------

    def _get_lock(self) -> asyncio.Lock:
        if self.db_lock is None:
            self.db_lock = asyncio.Lock()
        return self.db_lock

    def _require_db(self) -> Database:
        if self.db is None:
            raise RuntimeError("KB is closed")
        return self.db

    def _searcher(self, loop: asyncio.AbstractEventLoop) -> _Searcher:
        """The shared search loops, to run on an executor thread of
        ``loop`` under this instance's lock."""
        return _Searcher(
            self.engine, self._stats, self._doc_cache, self._meta_index,
            _LoopLock(self._get_lock(), loop), self._require_db,
        )

    async def _ensure_db(self) -> Database:
        if self.db is None:
            local_path = await resolve_to_local_uncompressed_file(
                self.local_path_or_remote_url
            )
            if self.sidecar is not False and not self.force_fresh_db:
                # publishers ship <db>.svsx beside a remote <db>(.gz)
                await try_fetch_remote_sidecar(
                    self.local_path_or_remote_url, local_path
                )
            loop = asyncio.get_running_loop()
            self.db, self.embedding_func = await loop.run_in_executor(
                None, _open_database, local_path, self.force_fresh_db,
                self.embedding_func, self.engine.device,
            )
        return self.db

    def _sidecar_path(self) -> Optional[Path]:
        if self.sidecar is False or self.db is None:
            return None
        return sidecar_path_for(self.db.path)

    async def _ensure_engine_fresh(self) -> PackedCorpus:
        """Pack (or reuse) the device corpus.  The caller holds the lock."""
        db = await self._ensure_db()
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self.engine.ensure_fresh, db, self._sidecar_path()
        )

    async def load(self) -> None:
        """Open the database and pack the device corpus now, write a
        sidecar per the policy (``True``, or ``'auto'`` at
        ``SIDECAR_AUTO_MIN_DOCS`` docs and more), and prewarm the hydration
        row cache."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            corpus = await self._ensure_engine_fresh()
            path = self._sidecar_path()
            if path is not None and (
                self.sidecar is True
                or (self.sidecar == "auto" and corpus.n_valid >= SIDECAR_AUTO_MIN_DOCS)
            ):
                await loop.run_in_executor(None, self.engine.write_sidecar, path)
            db = self._require_db()

            def warm() -> int:
                with db.transaction() as tx:
                    return self._doc_cache.prewarm(tx)

            warmed = await loop.run_in_executor(None, warm)
            if warmed:
                log.info("hydration cache prewarmed (%d rows)", warmed)

    async def warmup(
        self,
        batch_sizes: Sequence[int] = (1,),
        n: int = 16,
        rounds: int = 2,
        routes: str = "both",
    ) -> None:
        """Run ``rounds`` searches of random unit queries at each batch
        size (the ``warmup`` phase of :meth:`stats`), so that the kernels
        are built and the width hints set before live traffic; ``routes``
        as in :meth:`KB.warmup`: accepted for ``svs_tpu``'s signature, it
        changes nothing."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            corpus = await self._ensure_engine_fresh()
        if corpus.n_valid == 0 or corpus.dim == 0:
            return
        await loop.run_in_executor(
            None, self._searcher(loop).warmup, corpus, batch_sizes, n, rounds
        )

    async def close(
        self,
        vacuum: bool = False,
        also_gzip: bool = False,
        write_sidecar: Optional[bool] = None,
    ) -> None:
        """Publish a sidecar (``write_sidecar``: ``True`` always, ``False``
        never, ``None`` per the instance's policy), close the database
        (optionally VACUUM it and publish a ``.gz`` copy) and drop the
        device corpus.  Like every method it opens the database first; a
        later call opens it again."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            db = await self._ensure_db()

            def heavy() -> Union[str, Path]:
                _publish_sidecar(self.engine, self.sidecar, db, write_sidecar)
                if vacuum:
                    db.vacuum()
                db.close()
                return db.path

            path = await loop.run_in_executor(None, heavy)
            self.db = None
            self.embedding_func = self.embedding_func_orig
            self.engine.invalidate()
            await loop.run_in_executor(None, self.engine.shutdown)
            if also_gzip:
                await loop.run_in_executor(None, atomic_gzip_file, path, f"{path}.gz")

    def _checked_embedding_func(self) -> EmbeddingFunc:
        assert self.embedding_func  # every caller has opened the database
        return wrap_embeddings_func_check_magnitude(
            self.embedding_func, MAGNITUDE_TOLERANCE
        )

    async def _embed(self, texts: List[str]) -> List[List[float]]:
        return await self._checked_embedding_func()(texts)

    async def _embed_to_bytes(self, texts: List[str]) -> List[bytes]:
        vectors = await self._embed(texts)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: [embedding_to_bytes(v) for v in vectors]
        )

    @asynccontextmanager
    async def _transaction(self) -> AsyncIterator[Tuple[Tx, "_BulkCalls"]]:
        """Hold the lock and one store transaction for a bulk block:
        ``(tx, call)``, ``call`` running the block's store calls.  Commits
        when the block completes, rolls back when anything in it raised."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            db = await self._ensure_db()
            txn = db.transaction()
            tx = await loop.run_in_executor(None, txn.__enter__)
            ok = False
            try:
                yield tx, _BulkCalls(loop)
                ok = True
            finally:
                exc = None if ok else BaseException("rollback")
                await loop.run_in_executor(
                    None, txn.__exit__, None if ok else type(exc), exc, None
                )

    # -- bulk operations -----------------------------------------------------

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_add_docs(self) -> AsyncIterator[AsyncDocumentAdder]:
        """One transaction: add documents, then embed and store their
        vectors in provider-sized chunks before the commit.  An exception
        anywhere (the embedding included) rolls the whole batch back."""
        loop = asyncio.get_running_loop()
        async with self._transaction() as (tx, call):
            pending: List[Tuple[DocumentId, str]] = []

            async def add_doc(
                text: str,
                parent_id: Optional[DocumentId] = None,
                meta: Optional[Dict[str, Any]] = None,
                no_embedding: bool = False,
            ) -> DocumentId:
                doc_id = await call(tx.add_doc, text, parent_id, meta, None)
                if not no_embedding:
                    pending.append((doc_id, text))
                return doc_id

            try:
                yield add_doc
            finally:
                call.open = False
            for chunk in chunkify(pending, BULK_EMBEDDING_CHUNK_SIZE):
                blobs = await self._embed_to_bytes([t for _, t in chunk])

                def backfill() -> None:
                    for (doc_id, _), blob in zip(chunk, blobs):
                        tx.set_doc_embedding(doc_id, blob, skip_check_old=True)

                await loop.run_in_executor(None, backfill)
            if pending:
                await loop.run_in_executor(None, tx.bump_matrix_version)

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_del_docs(self) -> AsyncIterator[AsyncDocumentDeleter]:
        """One transaction deleting documents (with their embeddings and
        incident edges); a document that still has children refuses."""
        loop = asyncio.get_running_loop()
        async with self._transaction() as (tx, call):

            async def del_doc(doc_id: DocumentId) -> None:
                await call(tx.del_doc, doc_id)

            try:
                yield del_doc
            finally:
                call.open = False
            await loop.run_in_executor(None, tx.bump_matrix_version)

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_query_docs(self) -> AsyncIterator[AsyncDocumentQuerier]:
        async with self._transaction() as (tx, call):

            class Querier(AsyncDocumentQuerier):
                async def count(self) -> int:
                    return await call(tx.count_docs)

                async def query_doc(
                    self, doc_id: DocumentId, include_embedding: bool = False
                ) -> DocumentRecord:
                    return await call(tx.fetch_doc, doc_id, include_embedding)

                async def query_children(
                    self, doc_id: DocumentId, include_embedding: bool = False
                ) -> List[DocumentRecord]:
                    return await call(
                        tx.fetch_doc_children, doc_id, include_embedding
                    )

                async def query_level(
                    self,
                    level: int,
                    include_embedding: bool = False,
                    limit: Optional[int] = None,
                ) -> List[DocumentRecord]:
                    return await call(
                        tx.fetch_docs_at_level, level, include_embedding, limit
                    )

                async def dfs_traversal(
                    self, include_embedding: bool = False
                ) -> AsyncIterator[DocumentRecord]:
                    async def visit(
                        doc: DocumentRecord,
                    ) -> AsyncIterator[DocumentRecord]:
                        yield doc
                        for child in await self.query_children(
                            doc["id"], include_embedding
                        ):
                            async for sub in visit(child):
                                yield sub

                    for root in await self.query_level(0, include_embedding):
                        async for doc in visit(root):
                            yield doc

                async def update_doc_meta(
                    self,
                    doc_id: DocumentId,
                    new_meta: Optional[Dict[str, Any]],
                ) -> None:
                    await call(tx.update_doc_meta, doc_id, new_meta)

            try:
                yield Querier()
            finally:
                call.open = False

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_graph_update(self) -> AsyncIterator[AsyncGraphInterface]:
        async with self._transaction() as (tx, call):

            class Graph(AsyncGraphInterface):
                async def count_edges(self) -> int:
                    return await call(tx.count_edges)

                async def add_directed_edge(
                    self,
                    from_doc: DocumentId,
                    to_doc: DocumentId,
                    relationship: DocumentId,
                    weight: Optional[float] = None,
                ) -> EdgeId:
                    return await call(
                        tx.add_directed_edge, from_doc, to_doc, relationship, weight
                    )

                async def add_edge(
                    self,
                    doc1: DocumentId,
                    doc2: DocumentId,
                    relationship: DocumentId,
                    weight: Optional[float] = None,
                ) -> EdgeId:
                    return await call(tx.add_edge, doc1, doc2, relationship, weight)

                async def del_edge(self, edge_id: EdgeId) -> None:
                    await call(tx.del_edge, edge_id)

                async def edges(
                    self, limit: Optional[int] = None, offset: int = 0
                ) -> List[EdgeRecord]:
                    rows = await call(tx.list_edges, limit, offset)
                    return [_edge_record(row) for row in rows]

                async def build_networkx_graph(
                    self, multigraph: bool = True
                ) -> NetworkXGraphTypes:
                    # networkx is imported by the Tx, only when called
                    return await call(tx.build_networkx_graph, multigraph)

            try:
                yield Graph()
            finally:
                call.open = False

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_keyval_update(self) -> AsyncIterator[AsyncKeyValueInterface]:
        async with self._transaction() as (tx, call):

            class KeyVal(AsyncKeyValueInterface):
                async def has(self, key: str) -> bool:
                    return await call(tx.has_key_user, key)

                async def get(self, key: str, default: Any = KeyError) -> Any:
                    try:
                        return await call(tx.get_key_user, key)
                    except KeyError:
                        if default is KeyError:
                            raise
                        return default

                async def set(self, key: str, val: Any) -> None:
                    await call(tx.set_key_user, key, val)

                async def remove(self, key: str) -> None:
                    await call(tx.del_key_user, key)

                async def count(self) -> int:
                    return await call(tx.count_keys_user)

                async def items(self) -> AsyncIterator[Tuple[str, Any]]:
                    for item in await call(lambda: list(tx.iter_keyval_user())):
                        yield item

            try:
                yield KeyVal()
            finally:
                call.open = False

    # -- retrieval -----------------------------------------------------------

    async def retrieve(self, query: str, n: int, where: Where = None) -> List[Retrieval]:
        """Exact top-``n`` for one query (see :meth:`retrieve_batch`)."""
        return (await self.retrieve_batch([query], n, where=where))[0]

    async def retrieve_batch(
        self, queries: List[str], n: int, where: Where = None
    ) -> List[List[Retrieval]]:
        """Top-``n`` documents for every query, exact, with the semantics
        of :meth:`KB.retrieve_batch` (``where`` included): one embedding
        call awaited on this loop, then the search on an executor
        thread."""
        if not queries:
            return []
        log.info("retrieving top %d for %d queries", n, len(queries))
        loop = asyncio.get_running_loop()
        with phase("pack", self._stats):
            async with self._get_lock():
                corpus = await self._ensure_engine_fresh()
        if corpus.n_valid == 0 or n <= 0:
            return [[] for _ in queries]
        with phase("embed", self._stats):
            vectors = np.asarray(await self._embed(queries), dtype=np.float32)
        return await loop.run_in_executor(
            None, self._searcher(loop).retrieve, corpus, vectors, n, where
        )

    async def document_top_pairwise_scores(
        self, n: int, where: Where = None
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """The ``n`` most similar document pairs, exact, with the semantics
        of :meth:`KB.document_top_pairwise_scores` (``where`` included)."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            corpus = await self._ensure_engine_fresh()
        return await loop.run_in_executor(
            None, self._searcher(loop).top_pairs, corpus, n, where
        )


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
        self.local_path_or_remote_url = local_path_or_remote_url
        self.embedding_func = embedding_func
        self.embedding_func_orig = embedding_func
        self.engine = _make_engine(
            precision, rescore, mesh, device, kernel, device_rescore, replicas
        )
        self.sidecar = sidecar
        self._stats = QueryStats()
        self._doc_cache = DocRowCache()
        self._meta_index = MetaRowIndex()
        self._lock = threading.Lock()
        self._search = _Searcher(
            self.engine, self._stats, self._doc_cache, self._meta_index,
            self._lock, self._require_db,
        )
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
                local_path, force_fresh_db, embedding_func, self.engine.device
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
        are built and the width hints set before live traffic.  Each
        search takes the route a live call would: with the pack on the
        card, the device.  ``routes`` (``'both'`` or ``'live'``) is
        accepted for ``svs_tpu``'s signature and changes nothing: in
        ``svs_tpu``, ``'both'`` also warms the device route of a batch
        size its rule sent to the host, which this port's rule never does
        with the pack on the card, and no search here touches
        ``engine.host_dispatch``."""
        with self._lock:
            corpus = self._ensure_engine_fresh()
        if corpus.n_valid == 0 or corpus.dim == 0:
            return
        self._search.warmup(corpus, batch_sizes, n, rounds)

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

    def retrieve(self, query: str, n: int, where: Where = None) -> List[Retrieval]:
        return self.retrieve_batch([query], n, where=where)[0]

    def retrieve_batch(
        self, queries: List[str], n: int, where: Where = None
    ) -> List[List[Retrieval]]:
        """Top-``n`` documents for every query, exact: scores are f32 dots
        of the stored vectors, ties break to the larger embedding id.
        With ``rescore=False`` they are the device prescores instead, in
        device order.

        ``where`` (a dict of meta equalities, a
        :func:`meta_filter_predicate` or any predicate over the hydrated
        record) keeps the documents that pass it, exactly: a selective
        declarative filter scores only its matching rows; any other runs
        the ladder of exact top-``m`` prefixes (``m = 4n``, then 4x) with
        the predicate applied on the host to the hits in score order,
        until each query has ``n`` survivors or the prefix covers the
        corpus.  The predicate may see a document more than once; its
        exceptions propagate."""
        if not queries:
            return []
        log.info("retrieving top %d for %d queries", n, len(queries))
        with phase("pack", self._stats), self._lock:
            corpus = self._ensure_engine_fresh()
        if corpus.n_valid == 0 or n <= 0:
            return [[] for _ in queries]
        with phase("embed", self._stats):
            vectors = np.asarray(self._embed(queries), dtype=np.float32)
        return self._search.retrieve(corpus, vectors, n, where)

    def document_top_pairwise_scores(
        self, n: int, where: Where = None
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """The ``n`` most similar document pairs, exact: ``(score, doc,
        doc)`` by descending f32 score of the stored vectors (with
        ``rescore=False``, the device prescores in device order).  With
        ``where``, both documents of every pair pass it: the same pairs as
        on a store holding only the matching documents."""
        with self._lock:
            corpus = self._ensure_engine_fresh()
        return self._search.top_pairs(corpus, n, where)

    def __len__(self) -> int:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                return tx.count_docs()
