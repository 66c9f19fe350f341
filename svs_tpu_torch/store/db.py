"""Connection + transaction management for the single-file store.

One :class:`Database` wraps one ``sqlite3`` connection.  All access happens
inside explicit transactions: ``with db.transaction() as tx:`` opens a
``BEGIN``, yields a :class:`Tx` query handle, and commits on clean exit or
rolls back on exception — the rollback is what makes every bulk operation
in the KB facade atomic (reference behavior: ``svs/kb.py:777-853``).

Thread model: the connection is created with ``check_same_thread=False``
and callers are expected to serialize access per-KB (the facades hold one
lock per KB instance), mirroring the reference's deliberate
one-thread-at-a-time design note (``svs/kb.py:116-137``).
"""

from __future__ import annotations

import logging
import sqlite3
from datetime import datetime, timezone
from pathlib import Path
from types import TracebackType
from typing import Optional, Type, Union

from .tx import Tx

log = logging.getLogger(__name__)

#: Bump on any table change and add a migration in check_or_set_schema_version.
#: Version 1 is shared with the reference format (``svs/kb.py:64``).
SCHEMA_VERSION = 1

_DDL = """
CREATE TABLE IF NOT EXISTS keyval (
    id INTEGER PRIMARY KEY,
    key TEXT NOT NULL UNIQUE,
    val ANY NOT NULL
) STRICT;

CREATE TABLE IF NOT EXISTS keyval_user (
    id INTEGER PRIMARY KEY,
    key TEXT NOT NULL UNIQUE,
    val ANY NOT NULL
) STRICT;

CREATE TABLE IF NOT EXISTS embeddings (
    id INTEGER PRIMARY KEY,
    embedding BLOB NOT NULL
) STRICT;

CREATE TABLE IF NOT EXISTS docs (
    id INTEGER PRIMARY KEY,
    parent_id INTEGER REFERENCES docs(id),
    level INTEGER NOT NULL,
    text TEXT NOT NULL,
    embedding INTEGER REFERENCES embeddings(id),
    meta TEXT
) STRICT;

CREATE INDEX IF NOT EXISTS idx_docs_parent_id ON docs(parent_id);
CREATE INDEX IF NOT EXISTS idx_docs_level ON docs(level);
CREATE INDEX IF NOT EXISTS idx_docs_embedding ON docs(embedding);

CREATE TABLE IF NOT EXISTS edges (
    id INTEGER PRIMARY KEY,
    a INTEGER REFERENCES docs(id) NOT NULL,
    b INTEGER REFERENCES docs(id) NOT NULL,
    r INTEGER REFERENCES docs(id) NOT NULL,
    w REAL,
    d INTEGER NOT NULL
) STRICT;

CREATE UNIQUE INDEX IF NOT EXISTS idx_edges_abr ON edges(a, b, r);
CREATE INDEX IF NOT EXISTS idx_edges_a ON edges(a);
CREATE INDEX IF NOT EXISTS idx_edges_b ON edges(b);
CREATE INDEX IF NOT EXISTS idx_edges_r ON edges(r);
CREATE INDEX IF NOT EXISTS idx_edges_d ON edges(d);
"""

# Embedding-generation triggers: a monotonic counter in the internal keyval
# bumped by ANY writer of the embeddings table — including foreign tools
# that know nothing about this framework (they share the .sqlite file, and
# triggers live in the file).  This is what makes device-cache staleness
# detection exact: a foreign DELETE+INSERT that reuses the max rowid leaves
# (COUNT, MAX(id)) unchanged, but can't avoid firing these.
_EMB_GENERATION_KEY = "svs_tpu_emb_generation"
_GENERATION_DDL = "".join(
    f"""
CREATE TRIGGER IF NOT EXISTS svs_tpu_emb_gen_{op.lower()} AFTER {op} ON embeddings
BEGIN
    INSERT INTO keyval (key, val) VALUES ('{_EMB_GENERATION_KEY}', 1)
    ON CONFLICT(key) DO UPDATE SET val = val + 1;
END;
"""
    for op in ("INSERT", "UPDATE", "DELETE")
)

# Trigger-maintained embeddings row count: COUNT(*) walks the table
# b-tree (~30-80 s on an uncached 8 GB store at 1M rows), which sat on
# every cold open's fingerprint.  Like the generation counter, the
# triggers live in the FILE, so any writer — including the reference
# package — keeps the count exact.  UPDATE-only bodies on purpose: a
# missing key stays missing (readers fall back to COUNT(*)) until
# ``Database.__init__`` initializes it under BEGIN IMMEDIATE, so the
# counter can never start from a mid-stream zero.
_EMB_COUNT_KEY = "svs_tpu_emb_count"
_COUNT_DDL = f"""
CREATE TRIGGER IF NOT EXISTS svs_tpu_emb_cnt_insert AFTER INSERT ON embeddings
BEGIN
    UPDATE keyval SET val = val + 1 WHERE key = '{_EMB_COUNT_KEY}';
END;
CREATE TRIGGER IF NOT EXISTS svs_tpu_emb_cnt_delete AFTER DELETE ON embeddings
BEGIN
    UPDATE keyval SET val = val - 1 WHERE key = '{_EMB_COUNT_KEY}';
END;
"""

# STRICT tables require SQLite >= 3.37; older builds get the plain flavor.
SQLITE_IS_STRICT = sqlite3.sqlite_version_info >= (3, 37, 0)
if not SQLITE_IS_STRICT:  # pragma: no cover - depends on host sqlite
    log.warning("SQLite %s lacks STRICT tables; using non-strict schema",
                sqlite3.sqlite_version)
    _DDL = _DDL.replace(" STRICT;", ";")


class Database:
    """One SQLite connection with manual transaction control."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = path
        self._in_tx = False
        conn = sqlite3.connect(
            path,
            isolation_level=None,  # manual BEGIN/COMMIT
            check_same_thread=False,  # serialized by the owning KB's lock
        )
        try:
            try:
                conn.executescript(_DDL + _GENERATION_DDL + _COUNT_DDL)
                conn.commit()
                self._init_emb_count(conn)
            except sqlite3.OperationalError as exc:
                # Read-only media (baked image, ro-mount): a pre-existing
                # database can still be SERVED — no one can write it, so
                # the generation triggers (foreign-writer detection) and
                # schema creation are unnecessary.  Fail only if the
                # schema genuinely isn't there.
                if "readonly" not in str(exc).lower():
                    raise
                tables = {
                    row[0]
                    for row in conn.execute(
                        "SELECT name FROM sqlite_master WHERE type='table';"
                    )
                }
                if not {"docs", "embeddings", "keyval"} <= tables:
                    raise
                log.info(
                    "opened read-only database %s without DDL "
                    "(schema present; triggers skipped)", path,
                )
        except BaseException:
            conn.close()
            raise
        self.conn: Optional[sqlite3.Connection] = conn

    @staticmethod
    def _init_emb_count(conn: sqlite3.Connection) -> None:
        """Seed the trigger-maintained embeddings count for stores that
        predate it (reference-created, or written by older versions of
        this package).  BEGIN IMMEDIATE holds the write lock across the
        check + COUNT + insert, so a concurrent writer can't slip a row
        between the count and the commit; once the key exists this is a
        single O(1) SELECT per open."""
        row = conn.execute(
            "SELECT 1 FROM keyval WHERE key = ?;", (_EMB_COUNT_KEY,)
        ).fetchone()
        if row is not None:
            return
        conn.execute("BEGIN IMMEDIATE;")
        try:
            row = conn.execute(
                "SELECT 1 FROM keyval WHERE key = ?;", (_EMB_COUNT_KEY,)
            ).fetchone()
            if row is None:
                conn.execute(
                    "INSERT INTO keyval (key, val) "
                    "VALUES (?, (SELECT COUNT(*) FROM embeddings));",
                    (_EMB_COUNT_KEY,),
                )
            conn.execute("COMMIT;")
        except BaseException:
            conn.execute("ROLLBACK;")
            raise

    def transaction(self, immediate: bool = False) -> "Transaction":
        """One atomic unit of work: ``with db.transaction() as tx: ...``.
        Commits on clean exit, rolls back when an exception passes through.
        ``immediate`` takes the write lock at BEGIN (waiting out another
        writer), for a read-then-write that other processes may race: two
        deferred transactions that both read and then both write deadlock,
        and SQLite fails one of them at once with "database is locked".

        Returns a :class:`Transaction` whose ``__enter__``/``__exit__`` can
        also be driven manually — the async facade needs to hold a
        transaction open across an ``async with`` block while running the
        actual SQL calls in an executor.
        """
        return Transaction(self, immediate)

    def vacuum(self) -> None:
        assert self.conn is not None, "database is closed"
        assert not self._in_tx
        self.conn.execute("VACUUM;")

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def check_or_set_schema_version(self) -> None:
        """New database: stamp schema version + creation time.  Existing
        database: verify the version matches (future migrations hook in
        here).  The stamp is written under an immediate transaction that
        reads the version again, so processes opening a new database
        together (the forked workers of ``serve --workers``) stamp it once
        instead of deadlocking."""
        with self.transaction() as tx:
            try:
                version = tx.get_key("schema_version")
            except KeyError:
                version = None
        if version is None:
            with self.transaction(immediate=True) as tx:
                try:
                    version = tx.get_key("schema_version")
                except KeyError:
                    tx.set_key("schema_version", SCHEMA_VERSION)
                    tx.set_key(
                        "created_datetime", datetime.now(timezone.utc).isoformat()
                    )
                    return
        if version != SCHEMA_VERSION:
            raise RuntimeError(
                f"unsupported schema version {version!r} "
                f"(this build supports {SCHEMA_VERSION})"
            )


class Transaction:
    """BEGIN on ``__enter__`` (yields a :class:`Tx`), COMMIT on clean
    ``__exit__``, ROLLBACK + re-raise when exiting with an exception."""

    def __init__(self, db: Database, immediate: bool = False) -> None:
        self._db = db
        self._begin = "BEGIN IMMEDIATE TRANSACTION;" if immediate else "BEGIN TRANSACTION;"

    def __enter__(self) -> Tx:
        db = self._db
        assert db.conn is not None, "database is closed"
        assert not db._in_tx, "transactions do not nest"
        db.conn.execute(self._begin)
        db._in_tx = True
        return Tx(db.conn)

    def __exit__(
        self,
        exc_type: Optional[Type[BaseException]],
        exc_val: Optional[BaseException],
        exc_tb: Optional[TracebackType],
    ) -> None:
        db = self._db
        assert db.conn is not None and db._in_tx
        try:
            if exc_type is not None:
                db.conn.rollback()
                log.warning("transaction rolled back: %s", exc_val)
                return None  # propagate the exception
            try:
                db.conn.commit()
            except sqlite3.OperationalError:
                # COMMIT can fail (e.g. SQLITE_BUSY from a competing
                # lock).  Roll back so the connection leaves the open
                # transaction — otherwise every later BEGIN fails with
                # "cannot start a transaction within a transaction" and
                # the Database is wedged until process restart.
                db.conn.rollback()
                raise
            return None
        finally:
            db._in_tx = False
