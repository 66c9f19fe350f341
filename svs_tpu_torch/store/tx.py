"""The transaction-scoped query handle: every SQL statement lives here.

A :class:`Tx` is only ever obtained from ``Database.transaction()`` and is
valid for the duration of that transaction.  Behavioral invariants carried
over from the reference (``svs/kb.py:147-774``):

- a document's ``level`` is derived, not chosen: root docs are level 0 and a
  child is ``parent.level + 1``;
- deleting a document that still has children is refused; deleting a
  document cascades to every edge touching it (as endpoint *or* as the
  relationship doc) and to its embedding row;
- the ``(a, b, r)`` edge triplet is unique — violating it raises
  ``RuntimeError``;
- embedding BLOBs are little-endian float32 (see :mod:`svs_tpu_torch.store.blob`).

New in this framework: :meth:`bump_matrix_version` / :meth:`matrix_version`
— a monotonic counter over embedding mutations that derived device state
(packed HBM matrix, sidecar file) uses for precise staleness checks.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..types import DocumentId, DocumentRecord, EdgeId, NetworkXGraphTypes
from .blob import embedding_from_bytes, matrix_from_blob_rows

_MATRIX_VERSION_KEY = "svs_tpu_matrix_version"

#: SQLite's default host-parameter limit is 999; IN-query chunks stay under.
_IN_CHUNK = 500

#: Use the multi-threaded native scan for corpora at least this large
#: (below it the range bookkeeping costs more than it saves).
_PARALLEL_SCAN_MIN_ROWS = 100_000


def _record(
    rec_id: Any,
    parent_id: Any,
    level: Any,
    text: Any,
    embedding: Any,
    meta_str: Any,
) -> DocumentRecord:
    """One place that shapes a docs row into a DocumentRecord."""
    return {
        "id": rec_id,
        "parent_id": parent_id,
        "level": level,
        "text": text,
        "embedding": embedding,
        "meta": json.loads(meta_str) if meta_str is not None else None,
    }


class Tx:
    """All queries for one open transaction."""

    def __init__(self, conn: sqlite3.Connection) -> None:
        self._conn = conn
        #: Snapshot of ``total_changes`` at transaction start: a non-zero
        #: delta later means THIS transaction has uncommitted writes, so
        #: out-of-connection readers (the native scan) must not run.
        self._changes_at_begin = int(conn.total_changes)
        #: How the last matrix scan of this transaction ran:
        #: ``native_parallel``, ``native`` or ``stream``, and the seconds of
        #: its native steps (``ranges_s``: the id ranges and their counts;
        #: ``rows_s``: the row scan).
        self.last_scan: Optional[str] = None
        self.last_scan_split: Optional[Dict[str, float]] = None

    def _chunked_in(
        self, sql_template: str, ids: Sequence[int]
    ) -> Iterator[Tuple[Any, ...]]:
        """Run ``sql_template`` (containing ``{marks}``) over ``ids`` in
        chunks under the host-parameter limit, yielding all rows."""
        for start in range(0, len(ids), _IN_CHUNK):
            chunk = ids[start : start + _IN_CHUNK]
            marks = ",".join("?" * len(chunk))
            yield from self._conn.execute(
                sql_template.format(marks=marks), chunk
            )

    # -- internal keyval ----------------------------------------------------

    def get_key(self, key: str) -> Any:
        row = self._conn.execute(
            "SELECT val FROM keyval WHERE key = ?;", (key,)
        ).fetchone()
        if row is None:
            raise KeyError(key)
        return row[0]

    def set_key(self, key: str, val: Any) -> None:
        self._conn.execute(
            "INSERT INTO keyval (key, val) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET val = excluded.val;",
            (key, val),
        )

    def del_key(self, key: str) -> None:
        cur = self._conn.execute("DELETE FROM keyval WHERE key = ?;", (key,))
        if cur.rowcount == 0:
            raise KeyError(key)

    # -- matrix version (engine staleness tracking) -------------------------

    def matrix_version(self) -> int:
        try:
            return int(self.get_key(_MATRIX_VERSION_KEY))
        except KeyError:
            return 0

    def bump_matrix_version(self) -> int:
        version = self.matrix_version() + 1
        self.set_key(_MATRIX_VERSION_KEY, version)
        return version

    # -- user keyval ---------------------------------------------------------

    def get_key_user(self, key: str) -> Any:
        row = self._conn.execute(
            "SELECT val FROM keyval_user WHERE key = ?;", (key,)
        ).fetchone()
        if row is None:
            raise KeyError(key)
        return row[0]

    def set_key_user(self, key: str, val: Any) -> None:
        self._conn.execute(
            "INSERT INTO keyval_user (key, val) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET val = excluded.val;",
            (key, val),
        )

    def del_key_user(self, key: str) -> None:
        cur = self._conn.execute("DELETE FROM keyval_user WHERE key = ?;", (key,))
        if cur.rowcount == 0:
            raise KeyError(key)

    def has_key_user(self, key: str) -> bool:
        row = self._conn.execute(
            "SELECT 1 FROM keyval_user WHERE key = ?;", (key,)
        ).fetchone()
        return row is not None

    def count_keys_user(self) -> int:
        (n,) = self._conn.execute("SELECT COUNT(*) FROM keyval_user;").fetchone()
        return int(n)

    def iter_keyval_user(self) -> Iterator[Tuple[str, Any]]:
        yield from self._conn.execute("SELECT key, val FROM keyval_user;")

    def iter_keys_user(self) -> Iterator[str]:
        for (key,) in self._conn.execute("SELECT key FROM keyval_user;"):
            yield key

    # -- documents -----------------------------------------------------------

    def count_docs(self) -> int:
        (n,) = self._conn.execute("SELECT COUNT(*) FROM docs;").fetchone()
        return int(n)

    def add_doc(
        self,
        text: str,
        parent_id: Optional[DocumentId],
        meta: Optional[Dict[str, Any]],
        embedding: Optional[bytes],
    ) -> DocumentId:
        level = 0
        if parent_id is not None:
            row = self._conn.execute(
                "SELECT level FROM docs WHERE id = ?;", (parent_id,)
            ).fetchone()
            if row is None:
                raise ValueError(f"invalid parent_id: {parent_id}")
            level = int(row[0]) + 1
        emb_id = self._insert_embedding(embedding) if embedding is not None else None
        cur = self._conn.execute(
            "INSERT INTO docs (parent_id, level, text, embedding, meta) "
            "VALUES (?, ?, ?, ?, ?);",
            (
                parent_id,
                level,
                text,
                emb_id,
                json.dumps(meta) if meta is not None else None,
            ),
        )
        assert cur.lastrowid is not None
        return cur.lastrowid

    def update_doc_meta(
        self, doc_id: DocumentId, new_meta: Optional[Dict[str, Any]]
    ) -> None:
        cur = self._conn.execute(
            "UPDATE docs SET meta = ? WHERE id = ?;",
            (json.dumps(new_meta) if new_meta is not None else None, doc_id),
        )
        if cur.rowcount != 1:
            raise KeyError(doc_id)

    def del_doc(self, doc_id: DocumentId) -> None:
        if self._conn.execute(
            "SELECT 1 FROM docs WHERE parent_id = ? LIMIT 1;", (doc_id,)
        ).fetchone() is not None:
            raise RuntimeError("You cannot delete a document that is a parent.")
        self._conn.execute(
            "DELETE FROM edges WHERE a = ? OR b = ? OR r = ?;",
            (doc_id, doc_id, doc_id),
        )
        row = self._conn.execute(
            "SELECT embedding FROM docs WHERE id = ?;", (doc_id,)
        ).fetchone()
        if row is None:
            raise KeyError(doc_id)
        if row[0] is not None:
            self._conn.execute("DELETE FROM embeddings WHERE id = ?;", (row[0],))
        self._conn.execute("DELETE FROM docs WHERE id = ?;", (doc_id,))

    def fetch_doc(self, doc_id: DocumentId, include_embedding: bool) -> DocumentRecord:
        row = self._conn.execute(
            "SELECT id, parent_id, level, text, embedding, meta "
            "FROM docs WHERE id = ?;",
            (doc_id,),
        ).fetchone()
        if row is None:
            raise KeyError(doc_id)
        rec_id, parent_id, level, text, emb_id, meta_str = row
        embedding: Any
        if include_embedding:
            embedding = (
                self._fetch_embedding_floats(emb_id) if emb_id is not None else None
            )
        else:
            embedding = emb_id is not None
        return _record(rec_id, parent_id, level, text, embedding, meta_str)

    def fetch_doc_children(
        self, doc_id: DocumentId, include_embedding: bool
    ) -> List[DocumentRecord]:
        ids = [
            row[0]
            for row in self._conn.execute(
                "SELECT id FROM docs WHERE parent_id = ?;", (doc_id,)
            )
        ]
        return [self.fetch_doc(i, include_embedding) for i in ids]

    def fetch_docs_at_level(
        self, level: int, include_embedding: bool, limit: Optional[int] = None
    ) -> List[DocumentRecord]:
        """Docs at ``level``; ``limit`` caps the fetch in SQL (a level can
        hold the whole corpus — bounded consumers like the HTTP
        ``/level/{level}`` route must not hydrate O(corpus) to serve a
        fixed-size page)."""
        if limit is None:
            sql, params = (
                "SELECT id FROM docs WHERE level = ?;",
                (level,),
            )
        else:
            sql, params = (
                "SELECT id FROM docs WHERE level = ? LIMIT ?;",
                (level, limit),
            )
        ids = [row[0] for row in self._conn.execute(sql, params)]
        return [self.fetch_doc(i, include_embedding) for i in ids]

    def doc_id_for_emb_id(self, emb_id: int) -> DocumentId:
        row = self._conn.execute(
            "SELECT id FROM docs WHERE embedding = ?;", (emb_id,)
        ).fetchone()
        if row is None:
            raise KeyError(emb_id)
        return int(row[0])

    def fetch_doc_rows_by_emb_ids(
        self, emb_ids: Sequence[int]
    ) -> Dict[int, Tuple[Any, Any, Any, Any, Any]]:
        """Raw ``(id, parent_id, level, text, meta_json)`` rows for the
        documents owning the given embedding ids, in batched IN queries.

        This is the batched-retrieval hydration path: a 256-query batch
        rescoring 400 candidates each touches tens of thousands of docs —
        point lookups per doc measured seconds per batch; chunked IN
        queries amortize to milliseconds.  Rows stay raw (meta as its JSON
        text) so callers can cache them and mint a *fresh*
        ``DocumentRecord`` per hit — ``json.loads`` per hit replaces the
        per-hit ``copy.deepcopy`` that dominated finalize profiles.
        """
        out: Dict[int, Tuple[Any, Any, Any, Any, Any]] = {}
        wanted = [int(e) for e in emb_ids]
        for emb_id, rec_id, parent_id, level, text, meta_str in self._chunked_in(
            "SELECT embedding, id, parent_id, level, text, meta "
            "FROM docs WHERE embedding IN ({marks});",
            wanted,
        ):
            out[int(emb_id)] = (rec_id, parent_id, level, text, meta_str)
        missing = set(wanted) - set(out)
        if missing:
            raise KeyError(sorted(missing)[0])
        return out

    def fetch_docs_by_emb_ids(
        self, emb_ids: Sequence[int]
    ) -> Dict[int, DocumentRecord]:
        """Hydrate the documents owning the given embedding ids (embeddings
        reported as presence booleans).  See
        :meth:`fetch_doc_rows_by_emb_ids` for the raw-row variant."""
        return {
            emb_id: _record(rec_id, parent_id, level, text, True, meta_str)
            for emb_id, (rec_id, parent_id, level, text, meta_str)
            in self.fetch_doc_rows_by_emb_ids(emb_ids).items()
        }

    def iter_doc_rows_with_emb(
        self,
    ) -> Iterator[Tuple[int, Any, Any, Any, Any, Any]]:
        """Stream ``(emb_id, id, parent_id, level, text, meta_json)`` for
        every embedded document — the hydration-cache prewarm scan."""
        yield from self._conn.execute(
            "SELECT embedding, id, parent_id, level, text, meta "
            "FROM docs WHERE embedding IS NOT NULL;"
        )

    def iter_emb_meta(self) -> Iterator[Tuple[int, Optional[str]]]:
        """Stream ``(emb_id, meta_json)`` for every embedded document —
        the meta-filter index build scan (lighter than
        :meth:`iter_doc_rows_with_emb`: no text column off disk)."""
        yield from self._conn.execute(
            "SELECT embedding, meta FROM docs WHERE embedding IS NOT NULL;"
        )

    def meta_eq_emb_ids(self, key: str, value: Any) -> Optional[List[int]]:
        """Emb ids of embedded documents whose meta satisfies
        ``key in meta and meta[key] == value`` — evaluated inside SQLite
        (JSON1 ``json_type``/``json_extract``), sorted ascending.

        Returns ``None`` when the pair can't be routed through SQL with
        *exactly* the Python-equality semantics of
        :func:`svs_tpu_torch.kb.meta_filter_predicate` — non-scalar values
        (dict/list compare structurally in Python, textually in SQL),
        ints outside SQLite's 64-bit range, keys needing JSON-path
        escaping, or a build without JSON1 — so the caller falls back to
        the Python scan.  Scalar cross-type cases match Python: JSON
        ``true``/``1``/``1.0`` are mutually equal, text never equals a
        number, absent keys never match, and ``json_type = 'null'``
        distinguishes a stored JSON ``null`` (matches ``value=None``)
        from an absent key (matches nothing).  Object/array *stored*
        values are excluded by ``json_type`` so a string filter value
        can never textually collide with an object's JSON serialization.
        """
        if '"' in key or "\\" in key:
            return None
        if isinstance(value, bool):
            pass  # binds as 0/1 — same equivalence class as Python's
        elif isinstance(value, int):
            if not -(1 << 63) <= value < (1 << 63):
                return None
        elif isinstance(value, float):
            # Stored ints past int64 reach SQL as lossily-rounded REALs
            # (JSON1 coercion), which a huge float filter could equal
            # where Python's exact int/float comparison says no.  Only
            # float filters >= 2^53 can collide with that rounding (and
            # this also declines inf, whose JSON spelling is invalid
            # anyway); Python equality below 2^53 matches SQL exactly.
            if abs(value) >= float(1 << 53):
                return None
        elif not isinstance(value, (str, type(None))):
            return None
        path = f'$."{key}"'
        try:
            if value is None:
                rows = self._conn.execute(
                    "SELECT embedding FROM docs WHERE embedding IS NOT NULL"
                    " AND meta IS NOT NULL AND json_type(meta, ?) = 'null'"
                    " ORDER BY embedding;",
                    (path,),
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT embedding FROM docs WHERE embedding IS NOT NULL"
                    " AND meta IS NOT NULL"
                    " AND json_type(meta, ?) NOT IN ('object', 'array')"
                    " AND json_extract(meta, ?) = ?"
                    " ORDER BY embedding;",
                    (path, path, value),
                ).fetchall()
        except sqlite3.OperationalError:
            return None  # malformed meta JSON or no JSON1: Python scan
        return [r[0] for r in rows]

    def change_token(self) -> Tuple[int, int]:
        """O(1) staleness token covering EVERY kind of database change:
        SQLite's ``data_version`` moves when any *other* connection writes
        the file, and this connection's ``total_changes`` counts every row
        this process inserted/updated/deleted (including doc-meta updates,
        which the embeddings fingerprint deliberately ignores).  Used to
        gate host-side hydration caches."""
        return (self.data_version(), int(self._conn.total_changes))

    # -- embeddings ----------------------------------------------------------

    def add_docs_bulk(
        self, texts: Sequence[str], blobs: Sequence[bytes]
    ) -> None:
        """Bulk-load fast path: insert root documents with embeddings in
        two ``executemany`` batches (one row-at-a-time ``add_doc`` loop
        measured ~6x slower at 1M rows).  Embedding ids are read back as
        the contiguous rowid range SQLite allocates within one
        transaction; contiguity is asserted, and any violation (possible
        only if another writer interleaves, which the transaction
        excludes) raises before the docs insert."""
        assert len(texts) == len(blobs)
        if not texts:
            return
        (base,) = self._conn.execute(
            "SELECT COALESCE(MAX(id), 0) FROM embeddings;"
        ).fetchone()
        self._conn.executemany(
            "INSERT INTO embeddings (embedding) VALUES (?);",
            ((b,) for b in blobs),
        )
        (new_max,) = self._conn.execute(
            "SELECT MAX(id) FROM embeddings;"
        ).fetchone()
        if new_max - base != len(blobs):
            raise RuntimeError("non-contiguous embedding rowids in bulk load")
        self._conn.executemany(
            "INSERT INTO docs (parent_id, level, text, embedding, meta) "
            "VALUES (NULL, 0, ?, ?, NULL);",
            zip(texts, range(base + 1, new_max + 1)),
        )

    def _insert_embedding(self, blob: bytes) -> int:
        cur = self._conn.execute(
            "INSERT INTO embeddings (embedding) VALUES (?);", (blob,)
        )
        assert cur.lastrowid is not None
        return cur.lastrowid

    def _fetch_embedding_floats(self, emb_id: int) -> List[float]:
        row = self._conn.execute(
            "SELECT embedding FROM embeddings WHERE id = ?;", (emb_id,)
        ).fetchone()
        if row is None:
            raise ValueError(f"invalid embedding id: {emb_id}")
        return embedding_from_bytes(row[0])

    def set_doc_embedding(
        self,
        doc_id: DocumentId,
        embedding: Optional[bytes],
        skip_check_old: bool = False,
    ) -> None:
        """Replace a doc's embedding.  ``skip_check_old=True`` skips looking
        up (and deleting) a previous embedding row — the bulk-add fast path,
        where docs were just inserted with no embedding."""
        if not skip_check_old:
            row = self._conn.execute(
                "SELECT embedding FROM docs WHERE id = ?;", (doc_id,)
            ).fetchone()
            if row is None:
                raise KeyError(doc_id)
            if row[0] is not None:
                self._conn.execute("DELETE FROM embeddings WHERE id = ?;", (row[0],))
        emb_id = self._insert_embedding(embedding) if embedding is not None else None
        cur = self._conn.execute(
            "UPDATE docs SET embedding = ? WHERE id = ?;", (emb_id, doc_id)
        )
        if cur.rowcount != 1:
            raise KeyError(doc_id)

    def count_embeddings(self) -> int:
        (n,) = self._conn.execute("SELECT COUNT(*) FROM embeddings;").fetchone()
        return int(n)

    def embeddings_fingerprint(self) -> Tuple[int, int, int]:
        """Change detector over the embeddings table:
        (count, max id, generation).  Used with ``matrix_version`` to decide
        device-cache staleness even for databases mutated by tools that
        don't bump the counter.  The generation term comes from triggers
        that fire on ANY embeddings write (see ``db._GENERATION_DDL``), so
        a foreign DELETE+INSERT that reuses the max rowid — invisible to
        count/max — still changes the fingerprint.

        All three terms are O(log n): the count comes from the
        trigger-maintained ``svs_tpu_emb_count`` key (seeded at open —
        ``db.Database._init_emb_count``; exact for ANY writer because the
        triggers live in the file), MAX(id) is a rightmost b-tree seek on
        the INTEGER PRIMARY KEY, and the generation is a keyval read.
        The COUNT(*) fallback only runs for read-only opens of stores
        that never had the key seeded (~30-80 s uncached at 1M rows —
        the cost this design removes from every cold open)."""
        (max_id,) = self._conn.execute(
            "SELECT COALESCE(MAX(id), 0) FROM embeddings;"
        ).fetchone()
        return self._embeddings_count(), int(max_id), self.embeddings_generation()

    def _embeddings_count(self) -> int:
        """The trigger-maintained embeddings count (O(1)), or ``COUNT(*)``
        for a store that never had it seeded."""
        row = self._conn.execute(
            "SELECT val FROM keyval WHERE key = 'svs_tpu_emb_count';"
        ).fetchone()
        return int(row[0]) if row is not None else self.count_embeddings()

    def embedding_ids(self) -> np.ndarray:
        """All embedding ids as int64 in id order — the incremental-delete
        packing path's survivor check (id-only PK scan, no BLOB decode).
        One pass over the table: a ``COUNT(*)`` first would walk every
        leaf page a second time (each holds one or two 6 KB rows)."""
        return np.fromiter(
            (
                r[0]
                for r in self._conn.execute(
                    "SELECT id FROM embeddings ORDER BY id;"
                )
            ),
            dtype=np.int64,
        )

    def embeddings_generation(self) -> int:
        """O(1) trigger-maintained write counter of the embeddings table."""
        row = self._conn.execute(
            "SELECT val FROM keyval WHERE key = 'svs_tpu_emb_generation';"
        ).fetchone()
        return int(row[0]) if row is not None else 0

    def data_version(self) -> int:
        """SQLite's per-connection file-change counter: increments whenever
        ANOTHER connection modified the database file — an O(1) foreign-
        writer detector (our own writes are tracked by matrix_version)."""
        (v,) = self._conn.execute("PRAGMA data_version;").fetchone()
        return int(v)

    def embedding_dim(self) -> int:
        """Dimensionality of stored embeddings (0 if none stored yet)."""
        row = self._conn.execute(
            "SELECT embedding FROM embeddings LIMIT 1;"
        ).fetchone()
        return len(row[0]) // 4 if row is not None else 0

    def _native_matrix_scan(
        self, after_id: int, n: int, dim: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The native scanner (``native.scan_embeddings``): separate
        read-only SQLite connections copy the blobs straight into NumPy
        buffers, one thread and connection per id range from
        ``_PARALLEL_SCAN_MIN_ROWS`` rows.

        The separate connections see only COMMITTED state, so this path
        runs only when it provably matches this transaction's snapshot
        (the reference's gates):

        - the caller has already read (the dim and count queries), so
          under a non-WAL journal this connection holds a shared lock and
          no writer can commit until the transaction ends; WAL databases,
          whose readers do not block writers, skip the native path;
        - a transaction with any uncommitted write of its own skips it
          outright (``total_changes``): count and max id cannot tell a
          same-transaction delete + reinsert that reuses the max rowid;
        - the scanned rows' count and max id are checked against this
          transaction's view.

        ``None`` on any gate or mismatch: the caller streams instead."""
        if n <= 0 or dim <= 0:
            return None
        if int(self._conn.total_changes) != self._changes_at_begin:
            return None
        (_, _, path) = self._conn.execute("PRAGMA database_list;").fetchone()
        if not path:  # in-memory or temp database
            return None
        (mode,) = self._conn.execute("PRAGMA journal_mode;").fetchone()
        if str(mode).lower() == "wal":
            return None
        from ..native import scan_embeddings, scan_embeddings_parallel

        t0 = time.perf_counter()
        res = None
        route = "native"
        ranges_s = 0.0
        if n >= _PARALLEL_SCAN_MIN_ROWS:
            # K disjoint id ranges on K threads / connections: the btree and
            # overflow-page walk parallelizes; the range counts come from
            # this transaction's snapshot
            k_threads = min(8, os.cpu_count() or 1)
            (hi,) = self._conn.execute(
                "SELECT max(id) FROM embeddings WHERE id > ?;", (after_id,)
            ).fetchone()
            if k_threads > 1 and hi is not None and hi > after_id:
                edges = [
                    after_id + (int(hi) - after_id) * i // k_threads
                    for i in range(k_threads + 1)
                ]
                ranges = []
                total = 0
                for lo, up in zip(edges, edges[1:]):
                    if up <= lo:
                        continue
                    (cnt,) = self._conn.execute(
                        "SELECT count(*) FROM embeddings "
                        "WHERE id > ? AND id <= ?;",
                        (lo, up),
                    ).fetchone()
                    ranges.append((lo, up, int(cnt)))
                    total += int(cnt)
                ranges_s = time.perf_counter() - t0
                if total == n:
                    res = scan_embeddings_parallel(path, ranges, n, dim)
                    route = "native_parallel"
        if res is None:
            res = scan_embeddings(path, after_id, n, dim)
            route = "native"
        if res is None:
            return None
        matrix, ids = res
        (max_id,) = self._conn.execute(
            "SELECT max(id) FROM embeddings WHERE id > ?;", (after_id,)
        ).fetchone()
        if int(ids[-1]) != int(max_id):
            return None
        self.last_scan = route
        self.last_scan_split = {
            "ranges_s": ranges_s, "rows_s": time.perf_counter() - t0 - ranges_s,
        }
        return matrix, ids

    def _stream_matrix(
        self, cursor: "sqlite3.Cursor", n: int, dim: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Stream ``n`` (id, blob) rows from ``cursor`` into a float32
        ``[n, dim]`` matrix + int64 id array.

        Why streaming: ``fetchall`` materializes every blob as a Python
        bytes object at once — measured 13x slower than a ``fetchmany``
        loop at 200k x 6 KB rows (allocator churn), and the big
        destination buffer is allocated as a bytearray (kernel-zeroed,
        pre-touched) and filled through a memoryview, which sustains
        >4 GB/s where growing/concatenating paths measured ~100 MB/s.
        This is the cold-start path of the 1M-doc benchmark — the
        reference's equivalent per-row struct unpack is ~100 s
        (``svs/kb.py:573-618``).
        """
        row_bytes = dim * 4
        ids = np.empty(n, dtype=np.int64)
        buf = bytearray(n * row_bytes)
        mv = memoryview(buf)
        i = 0
        off = 0
        while True:
            rows = cursor.fetchmany(4096)
            if not rows:
                break
            j = i + len(rows)
            ids[i:j] = [r[0] for r in rows]
            try:
                for row in rows:
                    # length-validating memcpy: a wrong-size blob raises
                    mv[off : off + row_bytes] = row[1]
                    off += row_bytes
            except ValueError:
                raise AssertionError(
                    "inconsistent embedding dimensionality"
                ) from None
            i = j
        assert i == n, f"embeddings changed mid-scan: expected {n}, got {i}"
        self.last_scan, self.last_scan_split = "stream", None
        matrix = np.frombuffer(buf, dtype="<f4").reshape(n, dim)
        return matrix, ids

    def build_embeddings_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """Scan all embedding BLOBs into a float32 ``[n, dim]`` matrix plus
        an int64 ``[n]`` array mapping matrix row -> embedding id (the
        cold-start path; see :meth:`_stream_matrix` for why it streams)."""
        dim = self.embedding_dim()
        (n,) = self._conn.execute(
            "SELECT count(*) FROM embeddings;"
        ).fetchone()
        if dim == 0:
            ids = np.fromiter(
                (
                    r[0]
                    for r in self._conn.execute(
                        "SELECT id FROM embeddings;"
                    )
                ),
                dtype=np.int64,
                count=n,
            )
            return np.zeros((n, 0), dtype=np.float32), ids
        native = self._native_matrix_scan(-1, n, dim)
        if native is not None:
            return native
        cur = self._conn.execute("SELECT id, embedding FROM embeddings;")
        return self._stream_matrix(cur, n, dim)

    def fetch_embeddings_after(
        self, after_emb_id: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """All embeddings with id > ``after_emb_id`` in id order — the
        incremental-append packing path (bulk adds only ever append new
        embedding rows with increasing ids)."""
        (n,) = self._conn.execute(
            "SELECT count(*) FROM embeddings WHERE id > ?;", (after_emb_id,)
        ).fetchone()
        dim = self.embedding_dim()
        if n == 0 or dim == 0:
            ids = np.fromiter(
                (
                    r[0]
                    for r in self._conn.execute(
                        "SELECT id FROM embeddings WHERE id > ? ORDER BY id;",
                        (after_emb_id,),
                    )
                ),
                dtype=np.int64,
                count=n,
            )
            return np.zeros((n, dim), dtype=np.float32), ids
        native = self._native_matrix_scan(after_emb_id, n, dim)
        if native is not None:
            return native
        cur = self._conn.execute(
            "SELECT id, embedding FROM embeddings WHERE id > ? ORDER BY id;",
            (after_emb_id,),
        )
        return self._stream_matrix(cur, n, dim)

    def fetch_embedding_rows(self, emb_ids: Sequence[int]) -> np.ndarray:
        """Fetch specific embeddings as a float32 matrix, in the order of
        ``emb_ids`` (rescore path).  Batched IN queries, not per-id point
        lookups — a batch of 256 retrievals rescoring 4x-overprovisioned
        candidates touches tens of thousands of rows."""
        wanted = [int(e) for e in emb_ids]
        found: Dict[int, bytes] = {}
        for emb_id, blob in self._chunked_in(
            "SELECT id, embedding FROM embeddings WHERE id IN ({marks});",
            wanted,
        ):
            found[emb_id] = blob
        try:
            blobs = [found[e] for e in wanted]
        except KeyError as exc:
            raise KeyError(exc.args[0])
        dim = len(blobs[0]) // 4 if blobs else self.embedding_dim()
        return matrix_from_blob_rows(blobs, dim)

    # -- edges ----------------------------------------------------------------

    def count_edges(self) -> int:
        (n,) = self._conn.execute("SELECT COUNT(*) FROM edges;").fetchone()
        return int(n)

    def _add_edge_row(
        self,
        a: DocumentId,
        b: DocumentId,
        r: DocumentId,
        w: Optional[float],
        directed: bool,
    ) -> EdgeId:
        try:
            cur = self._conn.execute(
                "INSERT INTO edges (a, b, r, w, d) VALUES (?, ?, ?, ?, ?);",
                (a, b, r, w, 1 if directed else 0),
            )
        except sqlite3.IntegrityError:
            raise RuntimeError("This edge triplet already exists!")
        assert cur.lastrowid is not None
        return cur.lastrowid

    def add_directed_edge(
        self,
        from_doc: DocumentId,
        to_doc: DocumentId,
        relationship: DocumentId,
        weight: Optional[float],
    ) -> EdgeId:
        return self._add_edge_row(from_doc, to_doc, relationship, weight, True)

    def add_edge(
        self,
        doc1: DocumentId,
        doc2: DocumentId,
        relationship: DocumentId,
        weight: Optional[float],
    ) -> EdgeId:
        return self._add_edge_row(doc1, doc2, relationship, weight, False)

    def del_edge(self, edge_id: EdgeId) -> None:
        cur = self._conn.execute("DELETE FROM edges WHERE id = ?;", (edge_id,))
        if cur.rowcount != 1:
            raise KeyError(edge_id)

    def iter_edges(
        self,
    ) -> Iterator[Tuple[DocumentId, DocumentId, DocumentId, Optional[float], bool]]:
        """All edge rows as ``(a, b, r, w, directed)`` in insertion order —
        the faithful-copy path: round-tripping edges through a networkx view
        materializes undirected edges as two arcs whenever any directed edge
        exists, doubling rows and losing the undirected flag."""
        for a, b, r, w, d in self._conn.execute(
            "SELECT a, b, r, w, d FROM edges ORDER BY id;"
        ):
            yield a, b, r, w, bool(d)

    def list_edges(
        self, limit: Optional[int] = None, offset: int = 0
    ) -> List[Tuple[EdgeId, DocumentId, DocumentId, DocumentId, Optional[float], bool]]:
        """Edge rows as ``(edge_id, a, b, r, w, directed)`` in insertion
        order, optionally paged — the id-bearing variant of
        :meth:`iter_edges` (ids are what :meth:`del_edge` consumes, so any
        caller that wants to enumerate-then-delete needs them)."""
        sql = "SELECT id, a, b, r, w, d FROM edges ORDER BY id"
        params: Tuple[int, ...] = ()
        if limit is not None:
            sql += " LIMIT ? OFFSET ?"
            params = (limit, offset)
        elif offset:
            sql += " LIMIT -1 OFFSET ?"
            params = (offset,)
        return [
            (i, a, b, r, w, bool(d))
            for i, a, b, r, w, d in self._conn.execute(sql + ";", params)
        ]

    def build_networkx_graph(self, multigraph: bool = True) -> NetworkXGraphTypes:
        """Materialize the edge table as a NetworkX graph.

        The graph is directed iff any directed edge exists; undirected edges
        in a directed graph get an explicit back-edge.  Edge attributes:
        ``edge_doc`` (the relationship doc id) and, when set, ``weight``.
        """
        import networkx as nx  # type: ignore[import-untyped]

        any_directed = (
            self._conn.execute(
                "SELECT 1 FROM edges WHERE d = 1 LIMIT 1;"
            ).fetchone()
            is not None
        )
        if multigraph:
            graph: NetworkXGraphTypes = (
                nx.MultiDiGraph() if any_directed else nx.MultiGraph()
            )
        else:
            graph = nx.DiGraph() if any_directed else nx.Graph()
        for a, b, r, w, d in self._conn.execute("SELECT a, b, r, w, d FROM edges;"):
            attrs: Dict[str, Any] = {"edge_doc": r}
            if w is not None:
                attrs["weight"] = w
            graph.add_edge(a, b, **attrs)
            if any_directed and d == 0:
                graph.add_edge(b, a, **attrs)
        return graph

    # -- raw dumps (tests only) ------------------------------------------------

    def _debug_keyval(self) -> Dict[str, Any]:
        return dict(self._conn.execute("SELECT key, val FROM keyval;"))

    def _debug_embeddings(self) -> List[Tuple[Any, ...]]:
        return [tuple(r) for r in self._conn.execute("SELECT * FROM embeddings;")]

    def _debug_docs(self) -> List[Tuple[Any, ...]]:
        return [tuple(r) for r in self._conn.execute("SELECT * FROM docs;")]

    def _debug_edges(self) -> List[Tuple[Any, ...]]:
        return [tuple(r) for r in self._conn.execute("SELECT * FROM edges;")]
