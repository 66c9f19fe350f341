"""HTTP serving facade with request micro-batching (port of
``svs_tpu.serve`` onto the port's :class:`AsyncKB`).

One batched device step over ``B`` queries reads the corpus once, so the
server is a **micro-batcher**: concurrent ``/retrieve`` requests coalesce
into single :meth:`AsyncKB.retrieve_batch` steps bounded by a small time
window, padded to a power of two (from 16 queries the prescore kernels
run on the core of ``csrc/fused3.cuh``, which reads the corpus once for
up to 64 queries).

Overload behavior: the batcher bounds *outstanding* queries — queued
AND in flight on the device (``max_queue``, default 16 batches' worth);
a request that would exceed the bound is shed immediately with **429
Too Many Requests**, and admission is all-or-nothing per request (a
multi-query request is never half-enqueued, so no device time is spent
on work the client will see 429'd) — on a saturated device, queueing
further only converts overload into timeout storms.

Routes (JSON in/out):

- ``GET  /healthz``   -> ``{"ok": true, "docs": N, "warming": bool}``
  (doc count cached ~1 s so health probes never add store queries under
  load; ``warming`` is true while a background pack or f32-mirror
  upload runs)
- ``GET  /stats``     -> KB phase timings + server batching counters
- ``POST /retrieve``  -> ``{"query": str | "queries": [str], "n": int,
  "meta_filter"?: {key: value}}`` -> one result list per query; each hit
  is ``{"score": float, "doc": DocumentRecord}`` (embeddings reported as
  presence booleans).  ``meta_filter`` restricts hits to documents whose
  meta carries every given key at exactly the given value (exact
  filtered retrieval via the KB's ``where=`` widen ladder; filtered
  requests skip co-batching but share the admission bound)
- ``POST /pairwise``  -> ``{"n": int, "meta_filter"?: {key: value}}`` ->
  top-n most-similar document pairs (the reference's
  ``document_top_pairwise_scores``); ``meta_filter`` restricts pairs to
  documents whose meta equals every given value (both endpoints)
- ``POST /add``       -> ``{"texts": [str], "metas": [obj]?}`` (only with
  ``writable=True``; at most ``MAX_ADD_TEXTS`` per request) -> ``{"ids":
  [int]}``
- ``POST /delete``    -> ``{"ids": [int]}`` (writable only)
- ``GET  /doc/{id}``  -> ``{"doc": DocumentRecord}``; 404 unknown id
- ``GET  /doc/{id}/children`` -> ``{"docs": [DocumentRecord]}``
- ``GET  /level/{level}``     -> ``{"docs": [...], "truncated": bool}``
  (at most ``MAX_LEVEL_DOCS`` records per response)
- ``PUT  /doc/{id}/meta``     -> JSON body = the new meta object or
  ``null`` (writable only)
- ``GET  /graph/edges``       -> ``{"edges": [EdgeRecord], "total": N}``
  (``?limit=`` up to ``MAX_EDGE_LIST``, ``?offset=`` for paging)
- ``POST /graph/edge``        -> ``{"a": id, "b": id, "relationship": id,
  "weight"?: float, "directed"?: bool}`` (writable only) ->
  ``{"edge_id": int}``; 409 on a duplicate ``(a, b, r)`` triplet
- ``DELETE /graph/edge/{id}`` (writable only); 404 unknown edge
- ``GET  /kv/{key}``, ``PUT /kv/{key}`` (JSON body = value, writable
  only), ``DELETE /kv/{key}`` (writable only) — the user key/value store

The transport is the standard library's (``asyncio.start_server`` and a
small HTTP/1.1 reader and writer: ``Content-Length`` bodies, keep-alive,
percent-decoded path segments and query), so the server runs where
``aiohttp`` is not installed.  A client sees what ``svs_tpu.serve``'s
aiohttp application answers: the same JSON, status codes and error
texts, 404 for an unknown path, 405 for a known path with another method,
413 past a 1 MiB body, and 500 for an uncaught error (the server stays
up).  :func:`make_app` returns an :class:`App` whose ``kb`` and
``batcher`` attributes take the place of the reference's ``KB_KEY`` /
``BATCHER_KEY`` application keys.

Start from the CLI: ``svs-tpu-torch serve kb.sqlite --port 8080``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote

from .kb import AsyncKB, meta_filter_predicate
from .types import Retrieval

log = logging.getLogger(__name__)

#: Default micro-batch window: long enough to coalesce a burst arriving
#: within one event-loop tick + scheduling jitter, short next to the
#: device step it feeds.
DEFAULT_WINDOW_MS = 2.0
#: Matches the fused kernels' resident-batch ceiling
#: (``ops.pallas_extract.FUSED_MAX_BATCH``).
DEFAULT_MAX_BATCH = 256
#: Default outstanding-query bound, in batches (queued + in flight):
#: past this the server sheds (429) rather than queueing — see module
#: docstring.
DEFAULT_MAX_QUEUE_BATCHES = 16
#: Upper bound on per-request result count (rescore over-provisions 4x
#: on the device; an unbounded n would let one request drive an
#: arbitrarily large device top-k).
MAX_RETRIEVE_N = 1000
#: Upper bound on texts per /add request: one request is one transaction
#: (and one embedding-provider burst); callers with more chunk client-side.
MAX_ADD_TEXTS = 1000
#: Upper bound on /pairwise n (pair hydration is 2 docs per pair).
MAX_PAIRWISE_N = 10_000
#: Upper bound on documents per /level/{level} response (a level can hold
#: the whole corpus; the route reports ``truncated`` when it clips).
MAX_LEVEL_DOCS = 1000
#: Upper bound on edges per /graph/edges page (?limit= is clamped here);
#: unpaginated requests get DEFAULT_EDGE_LIST edges.
MAX_EDGE_LIST = 10_000
DEFAULT_EDGE_LIST = 1000
#: /healthz doc-count cache lifetime.
HEALTH_CACHE_S = 1.0
#: Request bodies of this many bytes and more are refused with 413 when a
#: route reads them (aiohttp's default ``client_max_size``).
MAX_BODY_BYTES = 1024**2
#: Bounds on a request's head: bytes per line, and header lines.
_MAX_LINE_BYTES = 8190
_MAX_HEADERS = 100


class Overloaded(Exception):
    """Raised by :meth:`MicroBatcher.retrieve` when the queue is full."""


def _n_bucket(n: int) -> int:
    """Next power of two >= n: requests in the same bucket co-batch.

    ``retrieve_batch`` runs the whole batch at one candidate width, so one
    n=1000 request co-batched with 255 n=10 requests would multiply the
    device candidate count (and the rescore gather) for everyone by 100x.
    Bucketing bounds that inflation at 2x while keeping the batching win
    for the (typical) homogeneous-n traffic.
    """
    b = 1
    while b < n:
        b <<= 1
    return b


class MicroBatcher:
    """Coalesces concurrent retrieve calls into batched device steps.

    Single-event-loop discipline: all state is touched only from loop
    callbacks, so no locks are needed.  A request either rides the next
    flush (queue below ``max_batch``) or triggers an immediate one; a
    request arriving at a full queue raises :class:`Overloaded`.
    """

    def __init__(
        self,
        kb: AsyncKB,
        max_batch: int = DEFAULT_MAX_BATCH,
        window_ms: float = DEFAULT_WINDOW_MS,
        max_queue: Optional[int] = None,
    ) -> None:
        self._kb = kb
        self._max_batch = max(1, int(max_batch))
        self._window_s = max(0.0, float(window_ms)) / 1e3
        if max_queue is None:
            max_queue = DEFAULT_MAX_QUEUE_BATCHES * self._max_batch
        self._max_queue = max(1, int(max_queue))
        self._queue: List[Tuple[str, int, "asyncio.Future[List[Retrieval]]"]] = []
        self._timer: Optional[asyncio.TimerHandle] = None
        #: Admitted-but-unresolved queries (queued + in flight on the
        #: device).  The overload bound must count in-flight work too:
        #: _flush drains the queue synchronously, so under sustained
        #: saturation the *queue* stays near-empty while unbounded
        #: concurrent batches pile up — bounding only queue length would
        #: never shed.
        self._pending = 0
        #: Flush tasks not yet finished (the loop holds tasks weakly).
        self._flushes: "set[asyncio.Task[None]]" = set()
        # observability
        self.requests = 0
        self.batches = 0
        self.batched_queries = 0
        self.shed = 0

    async def retrieve(self, query: str, n: int) -> List[Retrieval]:
        return (await self.retrieve_many([query], n))[0]

    async def run_unbatched(
        self,
        queries: List[str],
        n: int,
        where: "Any",
    ) -> List[List[Retrieval]]:
        """Run a filtered request directly on the KB (per-request
        predicates can't co-batch), still charged against the same
        admission bound as batched queries so the overload contract
        (bounded outstanding device work, 429 past it) holds."""
        if self._pending + len(queries) > self._max_queue:
            self.shed += len(queries)
            raise Overloaded(
                f"retrieve queue full ({self._max_queue} outstanding)"
            )
        self._pending += len(queries)
        self.requests += len(queries)
        try:
            return await self._kb.retrieve_batch(queries, n, where=where)
        finally:
            self._pending -= len(queries)

    async def retrieve_many(
        self, queries: List[str], n: int
    ) -> List[List[Retrieval]]:
        """Admit ``queries`` all-or-nothing, then await their results.

        Capacity is checked for the WHOLE request before any query is
        enqueued (admission is synchronous — no await between check and
        enqueue), so an overloaded server never spends device time on a
        request it is about to 429.
        """
        if self._pending + len(queries) > self._max_queue:
            self.shed += len(queries)
            raise Overloaded(
                f"retrieve queue full ({self._max_queue} outstanding)"
            )
        loop = asyncio.get_running_loop()
        futs: List["asyncio.Future[List[Retrieval]]"] = []
        for query in queries:
            fut: "asyncio.Future[List[Retrieval]]" = loop.create_future()
            fut.add_done_callback(self._on_done)
            self._queue.append((query, n, fut))
            self._pending += 1
            futs.append(fut)
        self.requests += len(queries)
        if len(self._queue) >= self._max_batch:
            self._cancel_timer()
            self._spawn_flush()
        elif self._queue and self._timer is None:
            self._timer = loop.call_later(self._window_s, self._spawn_flush)
        # return_exceptions so a failed batch's sibling futures are all
        # retrieved here; re-raise the first failure for the route's
        # error handling
        results = await asyncio.gather(*futs, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)  # type: ignore[arg-type]

    def _spawn_flush(self) -> None:
        task = asyncio.ensure_future(self._flush())
        self._flushes.add(task)
        task.add_done_callback(self._flushes.discard)

    def _on_done(self, fut: "asyncio.Future[List[Retrieval]]") -> None:
        self._pending -= 1
        if fut.cancelled():
            # a disconnected client's query must leave the queue with its
            # capacity slot, or a timeout storm defeats the overload bound
            # (pending drains while dead queries still fill the queue AND
            # burn device batches)
            self._queue = [it for it in self._queue if it[2] is not fut]

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    async def _flush(self) -> None:
        self._cancel_timer()
        batch = self._queue[: self._max_batch]
        self._queue = self._queue[self._max_batch :]
        if not batch:
            return
        if self._queue:
            # leftover burst: keep draining without waiting another window
            self._spawn_flush()
        self.batches += 1
        self.batched_queries += len(batch)
        # co-batch per n-bucket: a single outlier n must not multiply the
        # device candidate width for the whole batch (see _n_bucket)
        groups: Dict[int, List[Tuple[str, int, Any]]] = {}
        for item in batch:
            # cap at MAX_RETRIEVE_N: bucketing must not round a legal n
            # (<= the cap) up past the cap it exists to enforce
            groups.setdefault(
                min(_n_bucket(item[1]), MAX_RETRIEVE_N), []
            ).append(item)
        await asyncio.gather(
            *(self._run_group(bucket_n, items)
              for bucket_n, items in groups.items())
        )

    async def _run_group(
        self, bucket_n: int, items: List[Tuple[str, int, Any]]
    ) -> None:
        # Bucket the BATCH SIZE too (pad with copies of the first query,
        # results discarded), as the reference does to bound its jit
        # shapes: the batches the device sees are 1, 2, 4, ..., max_batch
        # (the ladder ``warm_bucket_ladder`` warms).  Padding with a REAL
        # query (not zeros) keeps every batch row unit-norm, so the
        # rescore margin proof behaves identically.
        texts = [q for q, _, _ in items]
        pad_to = min(self._max_batch, _n_bucket(len(texts)))
        if pad_to > len(texts):
            texts = texts + [texts[0]] * (pad_to - len(texts))
        try:
            results = await self._kb.retrieve_batch(texts, bucket_n)
        except Exception as exc:  # propagate to every waiter
            for _, _, fut in items:
                if not fut.done():
                    fut.set_exception(exc)
            return
        for (_, n, fut), res in zip(items, results):
            if not fut.done():
                fut.set_result(res[:n])


def _doc_json(doc: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(doc)
    # embeddings may be float lists when callers asked for them; the wire
    # format reports presence only (payloads are corpus-sized)
    if not isinstance(out.get("embedding"), (bool, type(None))):
        out["embedding"] = True
    return out


class _DocFragmentCache:
    """Per-doc preserialized JSON fragments for the /retrieve hot path.

    Hot docs repeat across requests, so each DocumentRecord is serialized
    ONCE and responses are assembled by byte concatenation (Python JSON
    encoding of every hit is otherwise the server's largest host cost).

    Staleness: each cached fragment stores the doc dict it was built
    from and re-validates by ONE C-level dict equality per hit (~25x
    cheaper than re-serializing).  This is airtight under any write
    concurrency — a changed doc (meta update, re-add, foreign writer)
    simply compares unequal and re-serializes — with no epoch/token
    plumbing to race.
    """

    def __init__(self, max_entries: int = 200_000) -> None:
        # Two-generation (segmented) eviction: on overflow the current
        # segment becomes the old one and a fresh segment starts; hits
        # in the old segment promote.  A wholesale clear() would drop the
        # hottest entries along with the coldest at corpora larger than
        # the cache; segments keep roughly the hottest half resident.
        self._seg_max = max(1, max_entries // 2)
        self._frags: Dict[int, Tuple[Dict[str, Any], bytes]] = {}
        self._old: Dict[int, Tuple[Dict[str, Any], bytes]] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._frags) + len(self._old)

    def frag(self, doc: Dict[str, Any]) -> bytes:
        key = doc["id"]
        entry = self._frags.get(key)
        if entry is None:
            entry = self._old.get(key)
            promoted = entry is not None
        else:
            promoted = False
        if entry is not None and entry[0] == doc:
            self.hits += 1
            if promoted:
                self._store(key, entry)
            return entry[1]
        self.misses += 1
        raw = json.dumps(
            _doc_json(doc), separators=(",", ":"), ensure_ascii=False
        ).encode()
        # ``doc`` is the minted hit dict (never aliased by the caller
        # after rendering), so retaining it as the validation witness is
        # safe.
        self._store(key, (doc, raw))
        return raw

    def _store(
        self, key: int, entry: Tuple[Dict[str, Any], bytes]
    ) -> None:
        if len(self._frags) >= self._seg_max:
            self._old = self._frags
            self._frags = {}
        # AFTER any rotation: drop the old-segment copy on promotion or
        # refresh — popping before rotation would leave a stale duplicate
        # behind when the refreshed key was in the segment that just
        # rotated out.
        self._old.pop(key, None)
        self._frags[key] = entry

    def render(
        self, results: List[List[Retrieval]], single: bool
    ) -> bytes:
        """The full ``{"results": ...}`` response body as bytes."""
        frag = self.frag
        qparts = []
        for res in results:
            qparts.append(
                b"[" + b",".join(
                    b'{"score":%s,"doc":%s}'
                    % (repr(r["score"]).encode(), frag(r["doc"]))
                    for r in res
                ) + b"]"
            )
        if single:
            return b'{"results":' + qparts[0] + b"}"
        return b'{"results":[' + b",".join(qparts) + b"]}"


# -- the HTTP/1.1 transport ------------------------------------------------------


class HTTPError(Exception):
    """A route's refusal: ``status`` with a plain-text body (``text``,
    default ``"<status>: <reason>"``), as aiohttp's ``HTTPException``."""

    def __init__(
        self,
        status: int,
        text: Optional[str] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        if text is None:
            text = f"{status}: {HTTPStatus(status).phrase}"
        super().__init__(text)
        self.status = status
        self.text = text
        self.headers = headers or {}


def _too_large(max_size: int, actual_size: int) -> HTTPError:
    return HTTPError(
        413,
        f"Maximum request body size {max_size} exceeded, actual body size "
        f"{actual_size}",
    )


class Request:
    """One parsed request: ``method``, the raw ``path``, its decoded
    ``query`` (first value of each key), ``headers`` (lower-case names),
    ``match_info`` (the decoded ``{name}`` segments of its route) and the
    body, which :meth:`read` refuses past :data:`MAX_BODY_BYTES`."""

    def __init__(
        self,
        method: str,
        path: str,
        query: Dict[str, str],
        headers: Dict[str, str],
        body: Optional[bytes],
        body_size: int,
    ) -> None:
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.match_info: Dict[str, str] = {}
        self._body = body
        self._body_size = body_size

    async def read(self) -> bytes:
        if self._body is None:
            raise _too_large(MAX_BODY_BYTES, self._body_size)
        return self._body

    async def json(self) -> Any:
        """The body parsed as JSON; ``ValueError`` when it is not JSON
        (an empty body included)."""
        return json.loads((await self.read()).decode("utf-8"))


class Response:
    def __init__(
        self,
        body: bytes,
        status: int = 200,
        content_type: str = "application/json",
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}


def json_response(data: Any, status: int = 200) -> Response:
    return Response(
        json.dumps(data).encode(), status, "application/json; charset=utf-8"
    )


def _text_response(
    status: int, text: str, headers: Optional[Dict[str, str]] = None
) -> Response:
    return Response(text.encode(), status, "text/plain; charset=utf-8", headers)


class _BadRequest(Exception):
    """A request the reader cannot frame: answered, then the connection
    closes."""

    def __init__(self, status: int, text: str) -> None:
        super().__init__(text)
        self.status = status


async def _readline(reader: asyncio.StreamReader) -> bytes:
    """One line of a request's head; past the stream's limit
    (``_MAX_LINE_BYTES``) a 400."""
    try:
        return await reader.readline()
    except ValueError:
        raise _BadRequest(400, "Request head line too long")


Handler = Callable[[Request], Awaitable[Response]]


class App:
    """The port's HTTP application: the routes of ``svs_tpu.serve`` over
    ``asyncio`` streams.  ``kb`` and ``batcher`` are the served
    :class:`AsyncKB` and its :class:`MicroBatcher`; :meth:`start` binds
    and returns the port, :meth:`close` stops serving."""

    def __init__(self, kb: AsyncKB, batcher: MicroBatcher) -> None:
        self.kb = kb
        self.batcher = batcher
        #: ``(method, path segments, handler)``; ``{name}`` segments match
        #: any non-empty segment.
        self._routes: List[Tuple[str, Tuple[str, ...], Handler]] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: "set[asyncio.StreamWriter]" = set()

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.append((method, tuple(path[1:].split("/")), handler))

    def _match(self, method: str, path: str) -> Tuple[Handler, Dict[str, str]]:
        segs = path[1:].split("/")
        allowed: List[str] = []
        for m, tmpl, handler in self._routes:
            if len(tmpl) != len(segs):
                continue
            info: Dict[str, str] = {}
            for t, s in zip(tmpl, segs):
                if t.startswith("{"):
                    if not s:
                        break
                    info[t[1:-1]] = unquote(s)
                elif unquote(s) != t:
                    break
            else:
                if m == method or (method == "HEAD" and m == "GET"):
                    return handler, info
                allowed.append(m)
        if allowed:
            if "GET" in allowed:
                allowed.append("HEAD")
            raise HTTPError(405, headers={"Allow": ",".join(sorted(allowed))})
        raise HTTPError(404)

    async def handle(self, request: Request) -> Tuple[Response, bool]:
        """Route and run one request: ``(response, keep the connection)``.
        An uncaught error is logged and answered with a 500, and that
        connection closes (the server stays up)."""
        try:
            handler, request.match_info = self._match(request.method, request.path)
            return await handler(request), True
        except HTTPError as exc:
            return _text_response(exc.status, exc.text, exc.headers), True
        except Exception:
            log.exception("error handling %s %s", request.method, request.path)
            return _text_response(
                500, "500 Internal Server Error\n\nServer got itself in trouble"
            ), False

    async def _read_request(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> Optional[Tuple[Request, bool]]:
        """The next request on the connection and whether the client keeps
        it alive; None at a clean end of the stream."""
        line = b"\r\n"
        while line in (b"\r\n", b"\n"):  # blank lines before a request
            line = await _readline(reader)
            if not line:
                return None
        if not line.endswith(b"\n"):
            raise _BadRequest(400, "Bad request line")
        parts = line.decode("latin-1").split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise _BadRequest(400, "Bad request line")
        method, target, version = parts
        headers: Dict[str, str] = {}
        while True:
            hl = await _readline(reader)
            if not hl.endswith(b"\n"):
                raise _BadRequest(400, "Bad header line")
            if hl in (b"\r\n", b"\n"):
                break
            if len(headers) >= _MAX_HEADERS:
                raise _BadRequest(400, "Too many headers")
            name, sep, value = hl.decode("latin-1").partition(":")
            if not sep or not name.strip():
                raise _BadRequest(400, "Bad header line")
            headers[name.strip().lower()] = value.strip()
        if "transfer-encoding" in headers:
            raise _BadRequest(501, "Transfer-Encoding is not supported; "
                              "send a Content-Length body")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "Bad Content-Length")
        if length < 0:
            raise _BadRequest(400, "Bad Content-Length")
        if length and headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        body: Optional[bytes]
        if length >= MAX_BODY_BYTES:
            # drained, so the connection stays usable; a route that reads
            # it answers 413 (aiohttp's client_max_size)
            left = length
            while left:
                left -= len(await reader.readexactly(min(left, 1 << 16)))
            body = None
        else:
            body = await reader.readexactly(length)
        if not target.startswith("/"):
            raise _BadRequest(400, "Bad request target")
        path, _, qs = target.partition("?")
        query: Dict[str, str] = {}
        for k, v in parse_qsl(qs, keep_blank_values=True):
            query.setdefault(k, v)
        conn = headers.get("connection", "").lower()
        keep = conn != "close" if version == "HTTP/1.1" else conn == "keep-alive"
        return Request(method, path, query, headers, body, length), keep

    async def _serve_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    got = await self._read_request(reader, writer)
                except _BadRequest as exc:
                    self._write(writer, _text_response(exc.status, str(exc)),
                                False, False)
                    await writer.drain()
                    return
                if got is None:
                    return
                request, keep = got
                response, ok = await self.handle(request)
                keep = keep and ok
                self._write(writer, response, keep, request.method == "HEAD")
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away mid-request
        finally:
            self._writers.discard(writer)
            writer.close()

    @staticmethod
    def _write(
        writer: asyncio.StreamWriter, response: Response, keep: bool, head: bool
    ) -> None:
        status = response.status
        lines = [
            f"HTTP/1.1 {status} {HTTPStatus(status).phrase}",
            f"Content-Type: {response.content_type}",
            f"Content-Length: {len(response.body)}",
        ]
        lines += [f"{k}: {v}" for k, v in response.headers.items()]
        if not keep:
            lines.append("Connection: close")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        if not head:
            writer.write(response.body)

    async def start(
        self, host: str = "127.0.0.1", port: int = 0, *, reuse_port: bool = False
    ) -> int:
        """Bind ``host:port`` (``0``: any free port) and start serving;
        returns the bound port.  ``reuse_port`` sets ``SO_REUSEPORT`` (the
        forked workers of :func:`run_server` share one port)."""
        self._server = await asyncio.start_server(
            self._serve_conn, host, port, reuse_port=reuse_port or None,
            limit=_MAX_LINE_BYTES + 2,
        )
        return int(self._server.sockets[0].getsockname()[1])

    async def close(self) -> None:
        """Stop accepting, close every open connection, and wait for the
        server to wind down."""
        server, self._server = self._server, None
        if server is None:
            return
        server.close()
        for w in list(self._writers):
            w.close()
        await server.wait_closed()


# -- the routes --------------------------------------------------------------------


async def _json_body(request: Request) -> Dict[str, Any]:
    try:
        body = await request.json()
    except ValueError:
        raise HTTPError(400, "body must be JSON")
    if not isinstance(body, dict):
        raise HTTPError(400, "body must be a JSON object")
    return body


def _int_match(request: Request, name: str) -> int:
    """Parse an integer path segment (400 on garbage)."""
    raw = request.match_info[name]
    try:
        return int(raw)
    except ValueError:
        raise HTTPError(400, f"'{name}' must be an integer, got {raw!r}")


def _int_field(body: Dict[str, Any], name: str) -> int:
    val = body.get(name)
    if isinstance(val, bool) or not isinstance(val, int):
        raise HTTPError(400, f"'{name}' must be an integer")
    return val


def make_app(
    kb: AsyncKB,
    *,
    writable: bool = False,
    max_batch: int = DEFAULT_MAX_BATCH,
    window_ms: float = DEFAULT_WINDOW_MS,
    max_queue: Optional[int] = None,
) -> App:
    """Build the application serving ``kb`` (the routes of the module
    docstring); ``await app.start(host, port)`` serves it."""
    fragcache = _DocFragmentCache()
    batcher = MicroBatcher(
        kb, max_batch=max_batch, window_ms=window_ms, max_queue=max_queue
    )
    app = App(kb, batcher)
    # (count, monotonic deadline); shared mutable cell for the health cache
    health_cache: List[Tuple[int, float]] = []

    async def healthz(request: Request) -> Response:
        now = time.monotonic()
        if health_cache and now < health_cache[0][1]:
            docs = health_cache[0][0]
        else:
            async with kb.bulk_query_docs() as q:
                docs = await q.count()
            health_cache[:] = [(docs, now + HEALTH_CACHE_S)]
        return json_response(
            {
                "ok": True,
                "docs": docs,
                # true while the background pack or f32-mirror upload is
                # still in flight: results are exact either way, but
                # batched latency improves once it lands — load balancers
                # can prefer non-warming replicas.
                "warming": (kb.engine.pack_uploading
                            or kb.engine.mirror_uploading),
                # live serving internals: a collapsing fragment-cache
                # hit rate or a deep batcher queue is the first sign of
                # host-side saturation
                "fragment_cache": {
                    "hits": fragcache.hits,
                    "misses": fragcache.misses,
                    "entries": len(fragcache),
                },
                "queue_depth": batcher._pending,
            }
        )

    async def stats(request: Request) -> Response:
        return json_response(
            {
                "kb": kb.stats(),
                "server": {
                    "requests": batcher.requests,
                    "batches": batcher.batches,
                    "batched_queries": batcher.batched_queries,
                    "shed": batcher.shed,
                    "avg_batch": (
                        batcher.batched_queries / batcher.batches
                        if batcher.batches
                        else 0.0
                    ),
                },
            }
        )

    async def retrieve(request: Request) -> Response:
        body = await _json_body(request)
        n = body.get("n", 10)
        if isinstance(n, bool) or not isinstance(n, int) or not (
            0 < n <= MAX_RETRIEVE_N
        ):
            raise HTTPError(
                400, f"'n' must be an integer in [1, {MAX_RETRIEVE_N}]"
            )
        if "queries" in body:
            queries = body["queries"]
            single = False
        elif "query" in body:
            queries = [body["query"]]
            single = True
        else:
            raise HTTPError(400, "missing 'query' or 'queries'")
        if not isinstance(queries, list) or not all(
            isinstance(q, str) for q in queries
        ):
            raise HTTPError(400, "'queries' must be a list of strings")
        meta_filter = body.get("meta_filter")
        if meta_filter is not None and not isinstance(meta_filter, dict):
            raise HTTPError(
                400,
                "'meta_filter' must be a JSON object of "
                "meta-key -> required-value equalities",
            )
        try:
            if meta_filter:
                # Filtered requests can't co-batch (each carries its own
                # predicate + widen ladder): run them directly on the KB,
                # but count them against the same admission bound so the
                # overload contract holds for every route.
                results = await batcher.run_unbatched(
                    queries, n, where=meta_filter_predicate(meta_filter)
                )
            else:
                results = await batcher.retrieve_many(queries, n)
        except Overloaded as exc:
            raise HTTPError(429, str(exc))
        return Response(fragcache.render(results, single))

    async def pairwise(request: Request) -> Response:
        body = await _json_body(request)
        n = body.get("n", 10)
        if isinstance(n, bool) or not isinstance(n, int) or not (
            0 < n <= MAX_PAIRWISE_N
        ):
            raise HTTPError(
                400, f"'n' must be an integer in [1, {MAX_PAIRWISE_N}]"
            )
        meta_filter = body.get("meta_filter")
        if meta_filter is not None and not isinstance(meta_filter, dict):
            raise HTTPError(
                400,
                "'meta_filter' must be a JSON object of "
                "meta-key -> required-value equalities",
            )
        pairs = await kb.document_top_pairwise_scores(
            n, where=meta_filter or None
        )
        payload = [
            {
                "score": score,
                "doc_a": _doc_json(dict(a)),
                "doc_b": _doc_json(dict(b)),
            }
            for score, a, b in pairs
        ]
        return json_response({"pairs": payload})

    def _require_writable() -> None:
        if not writable:
            raise HTTPError(403, "server started read-only")

    async def add(request: Request) -> Response:
        _require_writable()
        body = await _json_body(request)
        texts = body.get("texts")
        if not isinstance(texts, list) or not all(
            isinstance(t, str) for t in texts
        ):
            raise HTTPError(400, "'texts' must be a list of strings")
        if len(texts) > MAX_ADD_TEXTS:
            raise _too_large(MAX_ADD_TEXTS, len(texts))
        metas = body.get("metas")
        if metas is None:
            metas = [None] * len(texts)
        if not isinstance(metas, list) or len(metas) != len(texts):
            raise HTTPError(400, "'metas' must be a list matching 'texts'")
        ids: List[int] = []
        async with kb.bulk_add_docs() as add_doc:
            for text, meta in zip(texts, metas):
                ids.append(await add_doc(text, meta=meta))
        return json_response({"ids": ids})

    async def delete(request: Request) -> Response:
        _require_writable()
        body = await _json_body(request)
        ids = body.get("ids")
        if not isinstance(ids, list) or not all(
            isinstance(i, int) and not isinstance(i, bool) for i in ids
        ):
            raise HTTPError(400, "'ids' must be a list of integers")
        if len(ids) > MAX_ADD_TEXTS:
            raise _too_large(MAX_ADD_TEXTS, len(ids))
        try:
            async with kb.bulk_del_docs() as del_doc:
                for doc_id in ids:
                    await del_doc(doc_id)
        except RuntimeError as exc:  # delete-with-children etc.
            raise HTTPError(409, str(exc))
        except KeyError as exc:
            raise HTTPError(404, f"no such document: {exc}")
        return json_response({"deleted": len(ids)})

    async def doc_get(request: Request) -> Response:
        doc_id = _int_match(request, "id")
        async with kb.bulk_query_docs() as q:
            try:
                doc = await q.query_doc(doc_id)
            except KeyError:
                raise HTTPError(404, f"no such document: {doc_id}")
        return json_response({"doc": _doc_json(dict(doc))})

    async def doc_children(request: Request) -> Response:
        doc_id = _int_match(request, "id")
        async with kb.bulk_query_docs() as q:
            try:
                await q.query_doc(doc_id)  # 404 on unknown parent
            except KeyError:
                raise HTTPError(404, f"no such document: {doc_id}")
            docs = await q.query_children(doc_id)
        return json_response({"docs": [_doc_json(dict(d)) for d in docs]})

    async def doc_level(request: Request) -> Response:
        level = _int_match(request, "level")
        # limit pushed into SQL: a level can hold the whole corpus, and a
        # bounded response must not hydrate O(corpus) docs to produce it.
        async with kb.bulk_query_docs() as q:
            docs = await q.query_level(level, limit=MAX_LEVEL_DOCS + 1)
        truncated = len(docs) > MAX_LEVEL_DOCS
        return json_response(
            {
                "docs": [_doc_json(dict(d)) for d in docs[:MAX_LEVEL_DOCS]],
                "truncated": truncated,
            }
        )

    async def doc_meta_put(request: Request) -> Response:
        _require_writable()
        doc_id = _int_match(request, "id")
        try:
            meta = await request.json()
        except ValueError:
            raise HTTPError(400, "body must be JSON (the new meta)")
        if meta is not None and not isinstance(meta, dict):
            raise HTTPError(400, "meta must be a JSON object or null")
        async with kb.bulk_query_docs() as q:
            try:
                await q.update_doc_meta(doc_id, meta)
            except KeyError:
                raise HTTPError(404, f"no such document: {doc_id}")
        return json_response({"id": doc_id, "ok": True})

    async def graph_edges(request: Request) -> Response:
        try:
            limit = int(request.query.get("limit", DEFAULT_EDGE_LIST))
            offset = int(request.query.get("offset", 0))
        except ValueError:
            raise HTTPError(400, "limit/offset must be integers")
        if not (0 < limit <= MAX_EDGE_LIST) or offset < 0:
            raise HTTPError(
                400, f"limit must be in [1, {MAX_EDGE_LIST}], offset >= 0"
            )
        async with kb.bulk_graph_update() as g:
            total = await g.count_edges()
            edges = await g.edges(limit, offset)
        return json_response({"edges": edges, "total": total})

    async def graph_edge_add(request: Request) -> Response:
        _require_writable()
        body = await _json_body(request)
        a = _int_field(body, "a")
        b = _int_field(body, "b")
        rel = _int_field(body, "relationship")
        weight = body.get("weight")
        if weight is not None and not isinstance(weight, (int, float)):
            raise HTTPError(400, "'weight' must be a number")
        directed = body.get("directed", False)
        if not isinstance(directed, bool):
            raise HTTPError(400, "'directed' must be a boolean")
        try:
            async with kb.bulk_graph_update() as g:
                if directed:
                    edge_id = await g.add_directed_edge(a, b, rel, weight)
                else:
                    edge_id = await g.add_edge(a, b, rel, weight)
        except RuntimeError as exc:  # duplicate (a, b, r) triplet
            # (endpoints are NOT validated: SQLite FK enforcement is off
            # by default and the reference leaves it off — parity)
            raise HTTPError(409, str(exc))
        return json_response({"edge_id": edge_id})

    async def graph_edge_delete(request: Request) -> Response:
        _require_writable()
        edge_id = _int_match(request, "id")
        try:
            async with kb.bulk_graph_update() as g:
                await g.del_edge(edge_id)
        except KeyError:
            raise HTTPError(404, f"no such edge: {edge_id}")
        return json_response({"edge_id": edge_id, "ok": True})

    async def kv_get(request: Request) -> Response:
        key = request.match_info["key"]
        async with kb.bulk_keyval_update() as kv:
            if not await kv.has(key):
                raise HTTPError(404, f"no such key: {key!r}")
            val = await kv.get(key)
        return json_response({"key": key, "value": val})

    async def kv_put(request: Request) -> Response:
        _require_writable()
        key = request.match_info["key"]
        try:
            value = await request.json()
        except ValueError:
            raise HTTPError(400, "body must be JSON (the value)")
        if isinstance(value, bool) or not isinstance(value, (str, int, float)):
            # KV values are SQLite-bindable scalars (reference semantics:
            # whatever `keyval_user.val` accepts) — a dict/list/bool would
            # come back as something else on read, and the schema's
            # NOT NULL rejects null at the store layer
            raise HTTPError(400, "value must be a JSON string or number")
        async with kb.bulk_keyval_update() as kv:
            await kv.set(key, value)
        return json_response({"key": key, "ok": True})

    async def kv_delete(request: Request) -> Response:
        _require_writable()
        key = request.match_info["key"]
        async with kb.bulk_keyval_update() as kv:
            if not await kv.has(key):
                raise HTTPError(404, f"no such key: {key!r}")
            await kv.remove(key)
        return json_response({"key": key, "ok": True})

    app.add_route("GET", "/healthz", healthz)
    app.add_route("GET", "/stats", stats)
    app.add_route("POST", "/retrieve", retrieve)
    app.add_route("POST", "/pairwise", pairwise)
    app.add_route("POST", "/add", add)
    app.add_route("POST", "/delete", delete)
    app.add_route("GET", "/doc/{id}", doc_get)
    app.add_route("GET", "/doc/{id}/children", doc_children)
    app.add_route("GET", "/level/{level}", doc_level)
    app.add_route("PUT", "/doc/{id}/meta", doc_meta_put)
    app.add_route("GET", "/graph/edges", graph_edges)
    app.add_route("POST", "/graph/edge", graph_edge_add)
    app.add_route("DELETE", "/graph/edge/{id}", graph_edge_delete)
    app.add_route("GET", "/kv/{key}", kv_get)
    app.add_route("PUT", "/kv/{key}", kv_put)
    app.add_route("DELETE", "/kv/{key}", kv_delete)
    return app


def warm_bucket_ladder(max_batch: int) -> List[int]:
    """The batch sizes a server should warm: the micro-batcher pads
    coalesced bursts to powers of two (``_run_group``), so the batches the
    device sees are exactly 1, 2, 4, ..., max_batch."""
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return out


def run_server(
    db_path: str,
    *,
    host: str = "127.0.0.1",
    port: int = 8080,
    writable: bool = False,
    max_batch: int = DEFAULT_MAX_BATCH,
    window_ms: float = DEFAULT_WINDOW_MS,
    max_queue: Optional[int] = None,
    warm: bool = True,
    warm_n: int = 16,
    workers: int = 1,
    **kb_kwargs: Any,
) -> None:
    """Open ``db_path`` and serve it until interrupted (CLI entry).

    ``warm`` (default on) runs the batcher's power-of-two batch shapes
    once before accepting traffic, so the kernels are built and the
    candidate-width hints set before live requests arrive.

    ``workers`` > 1 forks that many processes sharing the port via
    ``SO_REUSEPORT`` (the kernel load-balances accepts); each worker
    opens the KB independently — reads share the SQLite file and the
    sidecar, writes serialize through SQLite's own locking.  The fork
    happens before anything touches CUDA (the device is resolved, and the
    kernel library built or loaded, inside each worker: a CUDA context
    does not survive a fork), and the workers share one kernel build (an
    ``fcntl`` lock in ``ops.kernels.build``).  Each worker owns a full
    Python runtime and its own pack on the device, so the host side
    (HTTP, JSON render, hydration) scales with cores while every worker
    holds a copy of the corpus on the card."""
    import os
    import signal

    worker_pids: List[int] = []
    forked = False
    if workers > 1:
        if not hasattr(os, "fork"):  # pragma: no cover - windows
            log.warning("--workers needs fork(); serving single-process")
        else:
            forked = True
            for _ in range(workers - 1):
                pid = os.fork()
                if pid == 0:
                    worker_pids = []  # child: serves, owns no siblings
                    break
                worker_pids.append(pid)
            if worker_pids:
                # Parent: until its event loop runs, translate SIGTERM
                # (systemd/docker stop) into the KeyboardInterrupt path so
                # the finally block below reaps the children — the default
                # disposition would kill only the parent and orphan workers
                # still holding the SO_REUSEPORT socket.
                def _term(_sig: int, _frm: object) -> None:
                    raise KeyboardInterrupt

                signal.signal(signal.SIGTERM, _term)

    async def _main() -> None:
        # Once the loop runs, SIGTERM and SIGINT stop it in order: a
        # KeyboardInterrupt raised inside a loop callback can leave a
        # transport half closed and the shutdown waiting on it forever.
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (ValueError, RuntimeError):  # not the main thread
                pass
        kb = AsyncKB(db_path, **kb_kwargs)
        await kb.load()  # pack the corpus before accepting traffic
        if warm:
            t0 = time.perf_counter()
            await kb.warmup(warm_bucket_ladder(max_batch), n=warm_n)
            log.info("warmup (%d batch shapes): %.1fs",
                     len(warm_bucket_ladder(max_batch)),
                     time.perf_counter() - t0)
        app = make_app(
            kb,
            writable=writable,
            max_batch=max_batch,
            window_ms=window_ms,
            max_queue=max_queue,
        )
        # reuse_port only when fork actually happened
        bound = await app.start(host, port, reuse_port=forked)
        log.info("serving %s on http://%s:%d (pid %d)",
                 db_path, host, bound, os.getpid())

        async def rewarm_after_uploads() -> None:
            """A deferred-upload cold start warms on the host route
            (blocking start-up on the multi-GB transfer would be worse);
            once the uploads land, warm the shapes again on the device
            route in the background, so the first live calls after the
            host -> device flip do not pay the kernels' first use."""
            try:
                if not warm:
                    return
                corpus = kb.engine.corpus
                if corpus is None or corpus.device_ready:
                    return
                loop = asyncio.get_running_loop()
                settled = await loop.run_in_executor(
                    None, lambda: kb.engine.wait_for_mirror(timeout=1800)
                )
                if settled and not stop.is_set():
                    t0 = time.perf_counter()
                    await kb.warmup(
                        warm_bucket_ladder(max_batch), n=warm_n,
                        routes="live",
                    )
                    log.info("post-upload device warmup: %.1fs",
                             time.perf_counter() - t0)
            except asyncio.CancelledError:
                raise
            except Exception:
                # fire-and-forget: an unlogged failure here would
                # silently re-expose live traffic to first-use costs
                log.warning("post-upload warmup failed", exc_info=True)

        rewarm = asyncio.ensure_future(rewarm_after_uploads())
        try:
            await stop.wait()
        finally:
            stop.set()  # the executor leg of rewarm checks this
            rewarm.cancel()
            await app.close()
            await kb.close()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        pass
    finally:
        for pid in worker_pids:
            try:
                os.kill(pid, signal.SIGINT)
            except OSError:
                pass
        for pid in worker_pids:
            try:
                os.waitpid(pid, 0)
            except OSError:
                pass
