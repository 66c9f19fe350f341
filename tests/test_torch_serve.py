"""The port's HTTP server (``svs_tpu_torch.serve``) against ``svs_tpu.serve``
on the CPU.

The cases of the reference's ``tests/test_serve.py`` run as parity cases:
one scenario drives each package's server (``svs_tpu``'s aiohttp
application through aiohttp's ``TestServer``; the port's standard-library
server on a loopback socket, with ``AsyncKB(device='cpu')``) through the
same requests from aiohttp's client, asserts the reference's expectations
on each, and records a transcript of statuses and bodies; the two
transcripts must be equal (ids and texts exactly, scores within
``SCORE_ATOL``).  Then what the port's transport does on its own: 404 and
405, 413 past 1 MiB, 500 with the server staying up, percent-decoding,
keep-alive, HEAD and malformed requests over ``http.client`` and raw
sockets, processes started together sharing one kernel build and one
native build (build steps stubbed: there is no ``nvcc`` here), and ``python -m
svs_tpu_torch serve --workers 2`` answering from both workers and exiting
0 on SIGTERM."""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.parse
from pathlib import Path

import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

import svs_tpu  # noqa: E402
import svs_tpu.serve as ref_serve  # noqa: E402
import svs_tpu_torch  # noqa: E402
import svs_tpu_torch.serve as port_serve  # noqa: E402
from svs_tpu_torch.store.db import Database  # noqa: E402

from kb_helpers import make_onehot_embedder  # noqa: E402

torch.set_num_threads(2)

SCORE_ATOL = 2e-6
REPO = Path(svs_tpu_torch.__file__).resolve().parent.parent


class Pkg:
    """One package's ``AsyncKB`` / ``KB`` and serve module."""

    def __init__(self, name, serve, akb, skb, kw):
        self.name, self.serve, self._akb, self._skb, self._kw = name, serve, akb, skb, kw

    def AsyncKB(self, *args, **kw):
        return self._akb(*args, **self._kw, **kw)

    def KB(self, *args, **kw):
        return self._skb(*args, **self._kw, **kw)


REF = Pkg("svs_tpu", ref_serve, svs_tpu.AsyncKB, svs_tpu.KB, {})
PORT = Pkg("svs_tpu_torch", port_serve, svs_tpu_torch.AsyncKB, svs_tpu_torch.KB,
           {"device": "cpu"})


class _PortClient:
    """aiohttp's client against the port's server on a loopback port (the
    calls of ``aiohttp.test_utils.TestClient`` the scenarios use)."""

    def __init__(self, app):
        self.app = app

    async def start(self):
        self.port = await self.app.start("127.0.0.1", 0)
        self.session = aiohttp.ClientSession(f"http://127.0.0.1:{self.port}")

    def request(self, method, path, **kw):
        return self.session.request(method, path, **kw)

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def post(self, path, **kw):
        return self.request("POST", path, **kw)

    def put(self, path, **kw):
        return self.request("PUT", path, **kw)

    def delete(self, path, **kw):
        return self.request("DELETE", path, **kw)

    async def close(self):
        await self.session.close()
        await self.app.close()


async def _client(pkg, kb, **kwargs):
    app = pkg.serve.make_app(kb, **kwargs)
    if pkg is REF:
        client = TestClient(TestServer(app))
        await client.start_server()
        return client
    client = _PortClient(app)
    await client.start()
    return client


async def _make_kb(pkg, db_path, n_docs=12):
    kb = pkg.AsyncKB(db_path, make_onehot_embedder(), force_fresh_db=True)
    async with kb.bulk_add_docs() as add:
        for i in range(n_docs):
            await add(f"vec:{i}")
    return kb


class Transcript(list):
    """``(label, status, body)`` of each recorded response: JSON parsed,
    anything else as text."""

    async def call(self, client, method, path, label=None, **kw):
        r = await client.request(method, path, **kw)
        text = await r.text()
        body = json.loads(text) if "json" in (r.content_type or "") else text
        self.append((label or f"{method} {path}", r.status, body))
        return r.status, body


def _same(a, b, where="body"):
    """``a == b`` with floats within SCORE_ATOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), where
        assert abs(a - b) <= SCORE_ATOL, (where, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


async def _parity(scenario, tmp_path, **kw):
    """Run ``scenario(pkg, db_path, transcript)`` on both packages; their
    transcripts must be equal."""
    got = {}
    for pkg in (REF, PORT):
        t = got[pkg.name] = Transcript()
        await scenario(pkg, tmp_path / f"{pkg.name}.sqlite", t, **kw)
    assert got["svs_tpu"], "the scenario recorded nothing"
    _same(list(got["svs_tpu"]), list(got["svs_tpu_torch"]), "transcript")


def _slow_embedder(kb):
    gate = asyncio.Event()
    inner = kb.embedding_func

    async def slow_embed(texts):
        await gate.wait()
        return await inner(texts)

    slow_embed.__embedding_func_params__ = getattr(
        inner, "__embedding_func_params__", None
    )
    kb.embedding_func = slow_embed
    return gate


# -- the reference's cases, through both servers -----------------------------------


async def test_healthz_and_retrieve_single(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb)
        try:
            st, body = await t.call(client, "GET", "/healthz")
            assert st == 200
            assert body["ok"] is True and body["docs"] == 12
            assert body["warming"] is False
            st, body = await t.call(client, "POST", "/retrieve",
                                    json={"query": "vec:3", "n": 2})
            assert st == 200
            hits = body["results"]
            assert hits[0]["doc"]["text"] == "vec:3"
            assert hits[0]["score"] == pytest.approx(1.0)
            assert len(hits) == 2
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_retrieve_many_and_bad_requests(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb)
        try:
            st, body = await t.call(client, "POST", "/retrieve",
                                    json={"queries": ["vec:1", "vec:7"], "n": 1})
            assert [h[0]["doc"]["text"] for h in body["results"]] == ["vec:1", "vec:7"]
            for kw in ({"json": {"n": 3}}, {"json": {"queries": [1, 2]}},
                       {"data": b"not json"}, {"json": [1]},
                       {"json": {"query": "vec:1", "n": 0}},
                       {"json": {"query": "vec:1", "n": True}},
                       {"json": {"query": "vec:1", "n": 1001}},
                       {"json": {"query": "vec:1", "meta_filter": "x"}}):
                st, _ = await t.call(client, "POST", "/retrieve", **kw)
                assert st == 400
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_concurrent_requests_coalesce_into_batches(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb, window_ms=20.0)
        try:
            results = await asyncio.gather(*(
                client.post("/retrieve", json={"query": f"vec:{i % 12}", "n": 1})
                for i in range(24)
            ))
            for i, r in enumerate(results):
                body = await r.json()
                assert body["results"][0]["doc"]["text"] == f"vec:{i % 12}"
                t.append((f"burst {i}", r.status, body))
            stats = await (await client.get("/stats")).json()
            server = stats["server"]
            assert server["requests"] == 24
            assert server["batched_queries"] == 24
            # 24 concurrent requests within one 20 ms window must coalesce
            # into far fewer device steps than requests
            assert server["batches"] < 24
            assert server["avg_batch"] > 1.5
            t.append(("stats", server["requests"], server["batched_queries"]))
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_add_gated_by_writable(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb)  # read-only default
        try:
            st, _ = await t.call(client, "POST", "/add", json={"texts": ["vec:99"]})
            assert st == 403
        finally:
            await client.close()
        client = await _client(pkg, kb, writable=True)
        try:
            st, body = await t.call(client, "POST", "/add",
                                    json={"texts": ["vec:13"], "metas": [{"a": 1}]})
            assert st == 200 and len(body["ids"]) == 1
            st, body = await t.call(client, "POST", "/retrieve",
                                    json={"query": "vec:13", "n": 1})
            hit = body["results"][0]
            assert hit["doc"]["text"] == "vec:13"
            assert hit["doc"]["meta"] == {"a": 1}
            for kw in ({"json": {"texts": "nope"}},
                       {"json": {"texts": ["a"], "metas": [1, 2]}}):
                st, _ = await t.call(client, "POST", "/add", **kw)
                assert st == 400
            st, _ = await t.call(client, "POST", "/add",
                                 json={"texts": ["x"] * 1001})
            assert st == 413
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_batcher_max_batch_splits_bursts(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        batcher = pkg.serve.MicroBatcher(kb, max_batch=4, window_ms=50.0)
        results = await asyncio.gather(
            *(batcher.retrieve(f"vec:{i % 12}", 1) for i in range(10))
        )
        for i, res in enumerate(results):
            assert res[0]["doc"]["text"] == f"vec:{i % 12}"
            t.append((f"q{i}", res[0]["score"], dict(res[0]["doc"])))
        assert batcher.requests == 10
        assert batcher.batches >= 3  # 4 + 4 + 2
        t.append(("counts", batcher.requests, batcher.batched_queries))
        await kb.close()

    await _parity(scenario, tmp_path)


async def test_batcher_propagates_errors(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        await kb.close()

        async def boom(texts):
            raise RuntimeError("embedder down")

        kb2 = pkg.AsyncKB(db_path, boom)
        batcher = pkg.serve.MicroBatcher(kb2, max_batch=8, window_ms=1.0)
        with pytest.raises(RuntimeError, match="embedder down") as exc:
            await batcher.retrieve("vec:1", 1)
        t.append(("error", 0, str(exc.value)))
        await kb2.close()

    await _parity(scenario, tmp_path)


async def test_cancelled_waiters_release_queue_capacity(tmp_path):
    """A disconnected client's queries leave the queue WITH their capacity
    slots (else a timeout storm defeats the overload bound)."""
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        gate = _slow_embedder(kb)
        batcher = pkg.serve.MicroBatcher(kb, max_batch=32, window_ms=5.0, max_queue=8)
        try:
            waiters = [
                asyncio.ensure_future(batcher.retrieve(f"vec:{i}", 1))
                for i in range(8)
            ]
            await asyncio.sleep(0)  # admit all 8
            assert batcher._pending == 8
            for w in waiters:
                w.cancel()
            await asyncio.sleep(0)  # run cancellation callbacks
            assert batcher._pending == 0
            assert batcher._queue == []  # dead queries evicted, not dispatched
            gate.set()
            res = await asyncio.gather(
                *(batcher.retrieve(f"vec:{i % 12}", 1) for i in range(8))
            )
            assert all(r[0]["score"] == pytest.approx(1.0) for r in res)
            t.extend((f"q{i}", r[0]["score"], r[0]["doc"]["text"]) for i, r in enumerate(res))
        finally:
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_kv_put_null_rejected_not_500(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb, writable=True)
        try:
            st, body = await t.call(client, "PUT", "/kv/x", json=None)
            assert st == 400 and "null" not in body
            st, _ = await t.call(client, "PUT", "/kv/x", data=b"null",
                                 headers={"Content-Type": "application/json"})
            assert st == 400
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_concurrent_writes_and_reads(tmp_path):
    """Writes through /add interleaved with concurrent /retrieve bursts:
    every response stays consistent and new docs are retrievable."""
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb, writable=True, window_ms=5.0)
        try:
            async def reader(i):
                r = await client.post("/retrieve", json={"query": f"vec:{i % 12}", "n": 1})
                assert r.status == 200
                return (await r.json())["results"][0]["doc"]["text"]

            async def writer(wave):
                r = await client.post("/add", json={"texts": [f"vec:{12 + wave}"]})
                assert r.status == 200
                return (await r.json())["ids"]

            for wave in range(3):
                results = await asyncio.gather(writer(wave), *(reader(i) for i in range(10)))
                assert results[1:] == [f"vec:{i % 12}" for i in range(10)]
                t.append((f"wave {wave}", 200, results))
                st, body = await t.call(client, "POST", "/retrieve",
                                        json={"query": f"vec:{12 + wave}", "n": 1})
                assert body["results"][0]["doc"]["text"] == f"vec:{12 + wave}"
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_queue_bound_sheds_with_429(tmp_path):
    """A burst beyond the queue bound is shed with 429, not queued without
    limit; accepted requests still complete correctly.  Which requests are
    shed depends on arrival order, so each server is held to the
    reference's expectations and the transcripts to their shape."""
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        gate = _slow_embedder(kb)
        client = await _client(pkg, kb, max_batch=4, max_queue=8, window_ms=1.0)
        try:
            tasks = [
                asyncio.ensure_future(
                    client.post("/retrieve", json={"query": f"vec:{i % 12}", "n": 1})
                )
                for i in range(20)
            ]
            await asyncio.sleep(0.1)  # let the queue fill and shedding begin
            gate.set()
            responses = await asyncio.gather(*tasks)
            statuses = [r.status for r in responses]
            assert statuses.count(429) > 0, statuses
            assert statuses.count(200) > 0, statuses
            texts = set()
            for r in responses:
                if r.status == 200:
                    body = await r.json()
                    assert body["results"][0]["score"] == pytest.approx(1.0)
                else:
                    texts.add(await r.text())
            stats = await (await client.get("/stats")).json()
            assert stats["server"]["shed"] == statuses.count(429)
            t.append(("shed texts", 429, sorted(texts)))
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_n_bucketing_isolates_outlier_n(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        batcher = pkg.serve.MicroBatcher(kb, max_batch=16, window_ms=20.0)
        results = await asyncio.gather(
            batcher.retrieve("vec:0", 64),
            *(batcher.retrieve(f"vec:{i % 12}", 1) for i in range(8)),
        )
        assert len(results[0]) == 12  # n=64 capped by corpus size
        for i, res in enumerate(results[1:]):
            assert len(res) == 1 and res[0]["doc"]["text"] == f"vec:{i % 12}"
        assert batcher.batches == 1  # one flush, grouped internally
        t.extend(
            (f"q{i}", [h["score"] for h in res], [h["doc"]["id"] for h in res])
            for i, res in enumerate(results)
        )
        await kb.close()

    await _parity(scenario, tmp_path)


async def test_pairwise_route(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb)
        try:
            st, body = await t.call(client, "POST", "/pairwise", json={"n": 3})
            assert st == 200
            pairs = body["pairs"]
            assert len(pairs) == 3
            for p in pairs:
                assert set(p) == {"score", "doc_a", "doc_b"}
                assert p["doc_a"]["id"] != p["doc_b"]["id"]
            for n in (0, 10**9):
                st, _ = await t.call(client, "POST", "/pairwise", json={"n": n})
                assert st == 400
            async with kb.bulk_query_docs() as q:
                roots = [d async for d in q.dfs_traversal()]
                for d in roots[:6]:
                    await q.update_doc_meta(d["id"], {"grp": "x"})
            st, body = await t.call(client, "POST", "/pairwise",
                                    json={"n": 2, "meta_filter": {"grp": "x"}})
            assert st == 200
            fp = body["pairs"]
            assert len(fp) == 2
            assert all(p["doc_a"]["meta"] == {"grp": "x"}
                       and p["doc_b"]["meta"] == {"grp": "x"} for p in fp)
            st, _ = await t.call(client, "POST", "/pairwise",
                                 json={"n": 2, "meta_filter": [1]})
            assert st == 400
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_delete_route(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb, writable=True)
        try:
            st, body = await t.call(client, "POST", "/retrieve",
                                    json={"query": "vec:5", "n": 1})
            doc_id = body["results"][0]["doc"]["id"]
            st, body = await t.call(client, "POST", "/delete", json={"ids": [doc_id]})
            assert st == 200 and body == {"deleted": 1}
            await client.get("/healthz")
            # healthz count may be cached ~1s; wait out the TTL
            await asyncio.sleep(1.1)
            st, body = await t.call(client, "GET", "/healthz")
            assert body["docs"] == 11
            st, _ = await t.call(client, "POST", "/delete", json={"ids": "x"})
            assert st == 400
            st, _ = await t.call(client, "POST", "/delete", json={"ids": [999999]})
            assert st == 404
        finally:
            await client.close()
            await kb.close()
        client = await _client(pkg, kb)  # read-only
        try:
            st, _ = await t.call(client, "POST", "/delete", json={"ids": [1]})
            assert st == 403
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_kv_routes(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb, writable=True)
        try:
            steps = [
                ("GET", "/kv/color", {}, 404),
                ("PUT", "/kv/color", {"json": {"hue": "red"}}, 400),
                ("PUT", "/kv/color", {"json": "red"}, 200),
                ("GET", "/kv/color", {}, 200),
                ("PUT", "/kv/n", {"json": 2.5}, 200),
                ("GET", "/kv/n", {}, 200),
                ("DELETE", "/kv/color", {}, 200),
                ("GET", "/kv/color", {}, 404),
                ("DELETE", "/kv/none", {}, 404),
            ]
            for method, path, kw, want in steps:
                st, body = await t.call(client, method, path, **kw)
                assert st == want, (method, path, st, body)
            assert t[3][2] == {"key": "color", "value": "red"}
        finally:
            await client.close()
            await kb.close()
        client = await _client(pkg, kb)  # read-only: reads ok, writes gated
        try:
            st, _ = await t.call(client, "PUT", "/kv/x", json=1)
            assert st == 403
            st, _ = await t.call(client, "DELETE", "/kv/x")
            assert st == 403
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_serve_with_replica_engine_is_not_ported(tmp_path):
    """The reference's ``test_serve_with_replica_engine`` through both
    servers (the replica engine is ported now; the name is kept): each
    micro-batch of a burst splits across 4 replicas inside the engine, the
    reference's on its virtual devices, the port's on ``[cpu] * 4``."""

    async def scenario(pkg, db_path, t):
        make = svs_tpu.AsyncKB if pkg is REF else svs_tpu_torch.AsyncKB  # no device=
        kb = make(db_path, make_onehot_embedder(), force_fresh_db=True,
                  replicas=4 if pkg is REF else ["cpu"] * 4)
        async with kb.bulk_add_docs() as add:
            for i in range(16):
                await add(f"vec:{i}")
        client = await _client(pkg, kb)
        try:
            outs = await asyncio.gather(*[
                t.call(client, "POST", "/retrieve", label=f"vec:{i}",
                       json={"query": f"vec:{i}", "n": 1})
                for i in range(10)
            ])
            for i, (st, body) in enumerate(outs):
                assert st == 200
                assert body["results"][0]["doc"]["text"] == f"vec:{i}"
            t.sort(key=lambda entry: entry[0])  # completion order varies
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_doc_routes(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = pkg.AsyncKB(db_path, make_onehot_embedder(), force_fresh_db=True)
        async with kb.bulk_add_docs() as add:
            root = await add("vec:0", meta={"kind": "root"})
            kid_a = await add("vec:1", parent_id=root)
            kid_b = await add("vec:2", parent_id=root)
        client = await _client(pkg, kb, writable=True)
        try:
            st, body = await t.call(client, "GET", f"/doc/{root}")
            assert st == 200
            doc = body["doc"]
            assert doc["text"] == "vec:0" and doc["meta"] == {"kind": "root"}
            assert doc["level"] == 0 and doc["embedding"] is True
            assert (await t.call(client, "GET", "/doc/999999"))[0] == 404
            assert (await t.call(client, "GET", "/doc/xyz"))[0] == 400
            st, body = await t.call(client, "GET", f"/doc/{root}/children")
            kids = body["docs"]
            assert {d["id"] for d in kids} == {kid_a, kid_b}
            assert all(d["level"] == 1 for d in kids)
            assert (await t.call(client, "GET", "/doc/999999/children"))[0] == 404
            st, body = await t.call(client, "GET", "/level/1")
            assert {d["id"] for d in body["docs"]} == {kid_a, kid_b}
            assert body["truncated"] is False
            assert (await t.call(client, "GET", "/level/7"))[0] == 200
            assert (await t.call(client, "GET", "/level/x"))[0] == 400
            st, _ = await t.call(client, "PUT", f"/doc/{kid_a}/meta", json={"tag": "x"})
            assert st == 200
            st, body = await t.call(client, "GET", f"/doc/{kid_a}")
            assert body["doc"]["meta"] == {"tag": "x"}
            st, _ = await t.call(client, "PUT", f"/doc/{kid_a}/meta", data=b"null",
                                 headers={"Content-Type": "application/json"})
            assert st == 200
            st, body = await t.call(client, "GET", f"/doc/{kid_a}")
            assert body["doc"]["meta"] is None
            st, _ = await t.call(client, "PUT", f"/doc/{kid_a}/meta",
                                 json=["not", "a", "dict"])
            assert st == 400
            assert (await t.call(client, "PUT", "/doc/999999/meta", json={}))[0] == 404
        finally:
            await client.close()
        client = await _client(pkg, kb)
        try:
            assert (await t.call(client, "GET", f"/doc/{root}"))[0] == 200
            assert (await t.call(client, "PUT", f"/doc/{root}/meta", json={}))[0] == 403
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_graph_routes(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path, n_docs=4)
        client = await _client(pkg, kb, writable=True)
        try:
            st, body = await t.call(client, "POST", "/graph/edge",
                                    json={"a": 1, "b": 2, "relationship": 3, "weight": 0.5})
            assert st == 200
            e1 = body["edge_id"]
            st, body = await t.call(client, "POST", "/graph/edge",
                                    json={"a": 2, "b": 3, "relationship": 4, "directed": True})
            e2 = body["edge_id"]
            st, _ = await t.call(client, "POST", "/graph/edge",
                                 json={"a": 1, "b": 2, "relationship": 3})
            assert st == 409
            st, body = await t.call(client, "GET", "/graph/edges")
            assert body["total"] == 2
            assert body["edges"] == [
                {"id": e1, "a": 1, "b": 2, "relationship": 3, "weight": 0.5,
                 "directed": False},
                {"id": e2, "a": 2, "b": 3, "relationship": 4, "weight": None,
                 "directed": True},
            ]
            st, body = await t.call(client, "GET", "/graph/edges?limit=1&offset=1")
            assert [e["id"] for e in body["edges"]] == [e2] and body["total"] == 2
            st, body = await t.call(client, "GET", "/graph/edges?limit=%31&offset=+0")
            assert st == 200 and len(body["edges"]) == 1
            for q in ("limit=0", "limit=zzz", "offset=-1", "limit=10001"):
                assert (await t.call(client, "GET", f"/graph/edges?{q}"))[0] == 400
            for bad in ({"a": 1, "b": 2},
                        {"a": 1, "b": 2, "relationship": 3, "directed": "yes"},
                        {"a": 1, "b": 2, "relationship": 3, "weight": "w"},
                        {"a": True, "b": 2, "relationship": 3}):
                assert (await t.call(client, "POST", "/graph/edge", json=bad))[0] == 400
            assert (await t.call(client, "DELETE", f"/graph/edge/{e1}"))[0] == 200
            assert (await t.call(client, "DELETE", f"/graph/edge/{e1}"))[0] == 404
            st, body = await t.call(client, "GET", "/graph/edges")
            assert body["total"] == 1
        finally:
            await client.close()
            await kb.close()
        client = await _client(pkg, kb)  # read-only: listing ok, mutation gated
        try:
            assert (await t.call(client, "GET", "/graph/edges"))[0] == 200
            st, _ = await t.call(client, "POST", "/graph/edge",
                                 json={"a": 1, "b": 2, "relationship": 3})
            assert st == 403
            assert (await t.call(client, "DELETE", "/graph/edge/1"))[0] == 403
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_retrieve_meta_filter(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = pkg.AsyncKB(db_path, make_onehot_embedder(), force_fresh_db=True)
        async with kb.bulk_add_docs() as add:
            for i in range(12):
                await add(f"vec:{i}", meta={"lang": "en" if i % 2 == 0 else "de"})
        client = await _client(pkg, kb)
        try:
            st, body = await t.call(client, "POST", "/retrieve",
                                    json={"query": "vec:3", "n": 3,
                                          "meta_filter": {"lang": "de"}})
            assert st == 200
            hits = body["results"]
            assert hits[0]["doc"]["text"] == "vec:3"
            assert all(h["doc"]["meta"]["lang"] == "de" for h in hits)
            assert len(hits) == 3
            for flt in ({"lang": "fr"}, {"nope": None}):
                st, body = await t.call(client, "POST", "/retrieve",
                                        json={"query": "vec:3", "n": 3, "meta_filter": flt})
                assert body["results"] == []
            st, body = await t.call(client, "POST", "/retrieve",
                                    json={"queries": ["vec:3", "vec:4"], "n": 2,
                                          "meta_filter": {"lang": "en"}})
            assert body["results"][1][0]["doc"]["text"] == "vec:4"
            st, _ = await t.call(client, "POST", "/retrieve",
                                 json={"query": "vec:3", "n": 3, "meta_filter": ["lang"]})
            assert st == 400
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_fragment_cache_meta_update_invalidates(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb, writable=True)
        try:
            st, body = await t.call(client, "POST", "/retrieve", json={"query": "vec:5", "n": 1})
            doc = body["results"][0]["doc"]
            assert doc["meta"] is None
            st, body = await t.call(client, "POST", "/retrieve", json={"query": "vec:5", "n": 1})
            assert body["results"][0]["doc"] == doc
            st, _ = await t.call(client, "PUT", f"/doc/{doc['id']}/meta", json={"tag": "fresh"})
            assert st == 200
            st, body = await t.call(client, "POST", "/retrieve", json={"query": "vec:5", "n": 1})
            assert body["results"][0]["doc"]["meta"] == {"tag": "fresh"}
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_fragment_render_matches_json_dumps(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = pkg.AsyncKB(db_path, make_onehot_embedder(), force_fresh_db=True)
        async with kb.bulk_add_docs() as add:
            await add("vec:1", meta={"u": "héllo ☃", "n": [1, 2.5, None]})
            await add("vec:2")
            await add("vec:3")
        client = await _client(pkg, kb)
        try:
            st, body = await t.call(client, "POST", "/retrieve",
                                    json={"queries": ["vec:1", "vec:2"], "n": 3})
            results = body["results"]
            assert len(results) == 2 and len(results[0]) == 3
            by_text = {h["doc"]["text"]: h for h in results[0]}
            assert by_text["vec:1"]["doc"]["meta"] == {"u": "héllo ☃", "n": [1, 2.5, None]}
            assert by_text["vec:1"]["doc"]["embedding"] is True
            assert isinstance(by_text["vec:1"]["score"], float)
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_warm_bucket_ladder_and_kb_warmup(tmp_path):
    for b in (256, 1, 48, 3, 1000):
        assert port_serve.warm_bucket_ladder(b) == ref_serve.warm_bucket_ladder(b)
    assert port_serve.warm_bucket_ladder(256) == [1, 2, 4, 8, 16, 32, 64, 128, 256]

    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        try:
            await kb.warmup([1, 4], n=3)
            assert kb.stats()["warmup"]["count"] == 4  # 2 sizes x 2 rounds
            hits = await kb.retrieve("vec:2", 2)
            assert hits[0]["doc"]["text"] == "vec:2"
            t.append(("hits", [h["score"] for h in hits], [h["doc"]["id"] for h in hits]))
        finally:
            await kb.close()

    await _parity(scenario, tmp_path)


def test_sync_kb_warmup(tmp_path):
    counts = []
    for pkg in (REF, PORT):
        kb = pkg.KB(tmp_path / f"{pkg.name}.sqlite", make_onehot_embedder(),
                    force_fresh_db=True)
        try:
            with kb.bulk_add_docs() as add:
                for i in range(8):
                    add(f"vec:{i}")
            kb.warmup([1, 2], n=2, rounds=1)
            counts.append(kb.stats()["warmup"]["count"])
        finally:
            kb.close()
    assert counts == [2, 2]


def test_fragment_cache_segmented_eviction():
    """Overflow moves the current segment to 'old' instead of dropping
    everything; hot entries promote back and survive rollovers; both
    packages' caches count alike."""
    seen = []
    for serve in (ref_serve, port_serve):
        fc = serve._DocFragmentCache(max_entries=8)  # segments of 4
        docs = [
            {"id": i, "parent_id": None, "level": 0, "text": f"t{i}",
             "embedding": True, "meta": None}
            for i in range(20)
        ]
        hot = docs[0]
        frags = [fc.frag(hot)]
        for d in docs[1:20]:
            frags.append(fc.frag(d))
            fc.frag(hot)
        before = fc.misses
        fc.frag(hot)
        assert fc.misses == before
        assert fc.hits >= 19
        assert len(fc) <= 8
        seen.append((fc.hits, fc.misses, len(fc), frags))
    assert seen[0] == seen[1]


async def test_healthz_exports_cache_and_queue(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path)
        client = await _client(pkg, kb)
        try:
            st, _ = await t.call(client, "POST", "/retrieve", json={"query": "vec:1", "n": 2})
            assert st == 200
            st, h = await t.call(client, "GET", "/healthz")
            assert h["ok"] is True
            assert h["fragment_cache"]["misses"] >= 1
            assert h["queue_depth"] == 0
            await t.call(client, "POST", "/retrieve", json={"query": "vec:1", "n": 2})
            st, h2 = await t.call(client, "GET", "/healthz")
            assert h2["fragment_cache"]["hits"] > h["fragment_cache"]["hits"]
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


# -- the transport: both servers, then the port's own ----------------------------


async def test_unknown_path_and_wrong_method(tmp_path):
    """404 for an unknown path, 405 (with ``Allow``) for a known path with
    another method, as aiohttp answers."""
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path, n_docs=2)
        client = await _client(pkg, kb, writable=True)
        try:
            for method, path in (("GET", "/nope"), ("GET", "/kv/"), ("GET", "/kv/a/b"),
                                 ("GET", "/healthz/"), ("POST", "/healthz"),
                                 ("GET", "/retrieve"), ("POST", "/kv/x"),
                                 ("GET", "/graph/edge/3"), ("PATCH", "/doc/1/meta"),
                                 ("DELETE", "/doc/1")):
                r = await client.request(method, path)
                t.append((f"{method} {path}", r.status,
                          [await r.text(), r.headers.get("Allow")]))
                assert r.status in (404, 405), (method, path, r.status)
            r = await client.request("HEAD", "/healthz")
            t.append(("HEAD", r.status, await r.text()))
            assert r.status == 200
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_body_past_one_mib_is_413(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path, n_docs=2)
        client = await _client(pkg, kb, writable=True)
        try:
            for size in (2**20 - 1, 2**20, 2**20 + 5):
                body = b'"' + b"x" * (size - 2) + b'"'
                st, text = await t.call(client, "POST", "/retrieve", data=body)
                assert st == (400 if size < 2**20 else 413), (size, st)
                st, _ = await t.call(client, "PUT", "/kv/big", data=body)
                assert st == (200 if size < 2**20 else 413)
            # a route that does not read the body answers as usual
            st, _ = await t.call(client, "GET", "/healthz", data=b"x" * 2**20)
            assert st == 200
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_uncaught_error_is_500_and_server_stays_up(tmp_path):
    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path, n_docs=2)
        client = await _client(pkg, kb)

        def boom():
            raise RuntimeError("stats exploded")

        real, kb.stats = kb.stats, boom
        try:
            st, text = await t.call(client, "GET", "/stats")
            assert st == 500 and "stats exploded" not in text
            kb.stats = real
            st, _ = await t.call(client, "GET", "/healthz")
            assert st == 200
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


async def test_percent_decoded_kv_keys(tmp_path):
    keys = ["a b", "a/b", "snow☃man", "a+b", "50%", "q?x=1"]

    async def scenario(pkg, db_path, t):
        kb = await _make_kb(pkg, db_path, n_docs=2)
        client = await _client(pkg, kb, writable=True)
        try:
            for i, key in enumerate(keys):
                path = "/kv/" + urllib.parse.quote(key, safe="")
                st, body = await t.call(client, "PUT", path, json=i)
                assert st == 200 and body == {"key": key, "ok": True}
                st, body = await t.call(client, "GET", path)
                assert body == {"key": key, "value": i}
            st, body = await t.call(client, "GET", "/kv/a%20b")
            assert body["value"] == 0
        finally:
            await client.close()
            await kb.close()

    await _parity(scenario, tmp_path)


class _Server:
    """The port's server on a loop thread, for blocking clients."""

    def __init__(self, tmp_path, **kw):
        from svs_tpu_torch.utils.aio import EventLoopThread

        self.lt = EventLoopThread("test-serve")

        async def start():
            kb = await _make_kb(PORT, tmp_path / "port.sqlite", n_docs=4)
            app = port_serve.make_app(kb, **kw)
            return kb, app, await app.start("127.0.0.1", 0)

        self.kb, self.app, self.port = self.lt.run(start())

    def close(self):
        async def stop():
            await self.app.close()
            await self.kb.close()

        try:
            self.lt.run(stop())
        finally:
            self.lt.stop()


def test_keep_alive_across_requests(tmp_path):
    srv = _Server(tmp_path, writable=True)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.connect()
        sock = conn.sock
        for i in range(5):
            conn.request("POST", "/retrieve", body=json.dumps({"query": f"vec:{i % 4}", "n": 1}),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            body = json.loads(r.read())
            assert r.status == 200 and body["results"][0]["doc"]["text"] == f"vec:{i % 4}"
            assert r.getheader("Content-Type") == "application/json"
            conn.request("GET", "/nope")  # an error keeps the connection too
            r = conn.getresponse()
            assert r.status == 404 and r.read() == b"404: Not Found"
        assert conn.sock is sock, "the client reconnected"
        assert len(srv.app._writers) == 1
        conn.request("GET", "/healthz", headers={"Connection": "close"})
        r = conn.getresponse()
        assert r.status == 200 and r.getheader("Connection") == "close"
        r.read()
        conn.close()
        # HTTP/1.0 without keep-alive: one request per connection
        with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
            s.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
            data = b""
            while chunk := s.recv(65536):
                data += chunk
        assert data.startswith(b"HTTP/1.1 200 OK\r\n") and b"Connection: close" in data
        assert json.loads(data.split(b"\r\n\r\n", 1)[1])["docs"] == 4
    finally:
        srv.close()


def test_malformed_requests_and_expect_continue(tmp_path):
    srv = _Server(tmp_path, writable=True)
    try:
        def raw(payload):
            with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
                s.sendall(payload)
                data = b""
                while chunk := s.recv(65536):
                    data += chunk
            return data

        assert raw(b"GARBAGE\r\n\r\n").startswith(b"HTTP/1.1 400 ")
        assert raw(b"GET /healthz HTTP/1.1\r\nno colon\r\n\r\n").startswith(b"HTTP/1.1 400 ")
        assert raw(b"GET /healthz HTTP/1.1\r\nContent-Length: x\r\n\r\n").startswith(
            b"HTTP/1.1 400 ")
        assert raw(b"GET /" + b"a" * 9000 + b" HTTP/1.1\r\n\r\n").startswith(b"HTTP/1.1 400 ")
        assert raw(b"POST /add HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n0\r\n\r\n"
                   ).startswith(b"HTTP/1.1 501 ")
        # a client that waits for 100 Continue before its body
        with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
            body = json.dumps({"texts": ["vec:9"]}).encode()
            s.sendall(b"POST /add HTTP/1.1\r\nContent-Length: %d\r\n"
                      b"Expect: 100-continue\r\nConnection: close\r\n\r\n" % len(body))
            assert s.recv(65536).startswith(b"HTTP/1.1 100 Continue\r\n\r\n")
            s.sendall(body)
            data = b""
            while chunk := s.recv(65536):
                data += chunk
        assert data.startswith(b"HTTP/1.1 200 OK") and b'"ids": [5]' in data
        # the server is still up
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        conn.close()
    finally:
        srv.close()


def test_app_exposes_kb_and_batcher(tmp_path):
    """The reference's ``app[KB_KEY]`` / ``app[BATCHER_KEY]`` are the port
    app's ``kb`` / ``batcher`` attributes."""
    srv = _Server(tmp_path, max_batch=8)
    try:
        assert srv.app.kb is srv.kb
        assert isinstance(srv.app.batcher, port_serve.MicroBatcher)
        assert srv.app.batcher._max_batch == 8
    finally:
        srv.close()


# -- forked workers: one build, and the CLI server ------------------------------------


_SHARED_BUILD = """
import os, sys, time
from pathlib import Path

from svs_tpu_torch import native
from svs_tpu_torch.ops import kernels

root, which = Path(sys.argv[1]), sys.argv[2]


def stand_in(target):  # nvcc's or g++'s: slow, then the file in place
    with open(root / "builds.log", "a") as f:
        f.write(f"{os.getpid()}\\n")
    time.sleep(1.0)
    tmp = target.with_name(f".{os.getpid()}.tmp")
    tmp.write_bytes(b"library")
    os.replace(tmp, target)


def fake_compile(target):
    stand_in(target)
    native._tag_path(target).write_text("portable")
    return True


kernels._BUILD_ROOT = root / "build"
kernels._build = lambda target, csrc: stand_in(target)
native._compile = fake_compile
(root / f"ready.{os.getpid()}").touch()
while not (root / "go").exists():
    time.sleep(0.01)
if which == "kernels":
    print(kernels.build(root / "csrc"))
else:
    assert native._build_locked(root / "native" / "_fastpack.so")
"""


def _together(tmp_path, script, *args, n=3):
    """``n`` processes of ``script`` (``-c``; argv ``tmp_path, *args``),
    released together once all have started (each touches ``ready.<pid>``
    and waits for ``go``); fails unless each exits 0."""
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(tmp_path), *args],
                         cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for _ in range(n)
    ]
    try:
        deadline = time.monotonic() + 120
        while len(list(tmp_path.glob("ready.*"))) < n:
            assert time.monotonic() < deadline, "the processes never got ready"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.05)
        (tmp_path / "go").touch()  # all at once
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _build_together(tmp_path, which):
    """Three processes started together, each building ``which`` (the
    kernel library or the native one) with the compiler stubbed; returns
    the pids that ran the stubbed build."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// a kernel\n")
    _together(tmp_path, _SHARED_BUILD, which)
    return (tmp_path / "builds.log").read_text().split()


def test_processes_started_together_share_one_kernel_build(tmp_path):
    """The forked workers of ``serve --workers`` each load the kernel
    library at their first search: one builds, the others wait on the
    build directory's lock and load its library."""
    from svs_tpu_torch.ops import kernels

    assert len(_build_together(tmp_path, "kernels")) == 1
    libs = list((tmp_path / "build").rglob("*.so"))
    assert [p.name for p in libs] == ["libsvs_kernels.so"]
    assert not list((tmp_path / "build").rglob("*.tmp"))
    assert libs[0].parent.name == kernels.library_path(tmp_path / "csrc").parent.name


def test_processes_started_together_share_one_native_build(tmp_path):
    from svs_tpu_torch import native

    assert len(_build_together(tmp_path, "native")) == 1
    assert native._usable(tmp_path / "native" / "_fastpack.so")


_OPEN_TOGETHER = """
import sys, time
from pathlib import Path

from svs_tpu_torch.store.db import Database
from svs_tpu_torch.store.tx import Tx

root = Path(sys.argv[1])
real = Tx.get_key


def slow_get_key(self, key):  # widen the read-then-write window
    try:
        return real(self, key)
    finally:
        time.sleep(0.3)


Tx.get_key = slow_get_key
(root / f"ready.{__import__('os').getpid()}").touch()
while not (root / "go").exists():
    time.sleep(0.01)
db = Database(root / "new.sqlite")
db.check_or_set_schema_version()
with db.transaction() as tx:
    assert tx.get_key("schema_version") == 1
db.close()
"""


def test_processes_opening_a_new_store_together_stamp_it_once(tmp_path):
    """The workers of ``serve --workers`` open their store together: on a
    store no KB has stamped yet, each reads the schema version, finds
    none, and writes it.  Two deferred transactions that read and then
    write deadlock (SQLite fails one at once with "database is locked");
    the stamp's immediate transaction makes the others wait for it."""
    Database(tmp_path / "new.sqlite").close()  # the schema, no stamp
    _together(tmp_path, _OPEN_TOGETHER)
    db = Database(tmp_path / "new.sqlite")
    with db.transaction() as tx:
        assert tx.get_key("schema_version") == 1
    db.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(pid):
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


def _socket_owners(port, pids):
    """``{pid: {tcp state}}`` of the sockets on local ``port`` that each of
    ``pids`` holds (``0A`` listening, ``01`` established)."""
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


def test_cli_serve_two_workers_answer_and_exit_on_sigterm(tmp_path):
    db = tmp_path / "served.sqlite"
    kb = svs_tpu_torch.KB(db, svs_tpu_torch.make_mock_embeddings_func(),
                          force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        for i in range(6):
            add(f"doc {i}")
    kb.close()
    port = _free_port()
    log = tmp_path / "serve.log"  # a file: a worker outliving the parent keeps no pipe
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "svs_tpu_torch", "serve", str(db), "--device", "cpu",
             "--workers", "2", "--port", str(port), "--max-batch", "4"],
            cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
        )
    conns = []
    workers = [proc.pid]
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            assert proc.poll() is None, log.read_text()
            workers = [proc.pid] + _children(proc.pid)
            owners = _socket_owners(port, workers)
            if len(workers) == 2 and all("0A" in owners.get(p, ()) for p in workers):
                break
            time.sleep(0.2)
        else:
            pytest.fail(f"the two workers never listened: {workers}")
        # keep-alive connections stay with the worker that accepted them:
        # both workers hold some once enough are open
        for _ in range(24):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("GET", "/healthz")
            r = c.getresponse()
            assert r.status == 200 and json.loads(r.read())["docs"] == 6
            c.request("POST", "/retrieve", body=json.dumps({"query": "x", "n": 2}))
            r = c.getresponse()
            hits = json.loads(r.read())["results"]
            assert r.status == 200 and [h["doc"]["text"] for h in hits] == ["doc 5", "doc 4"]
            conns.append(c)
        owners = _socket_owners(port, workers)
        assert all("01" in owners.get(p, ()) for p in workers), owners
        for c in conns:
            c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()
        for pid in workers[1:]:
            assert not Path(f"/proc/{pid}").exists(), f"worker {pid} outlived the parent"
    finally:
        for c in conns:
            c.close()
        if proc.poll() is None:
            for pid in _children(proc.pid):
                os.kill(pid, signal.SIGKILL)
            proc.kill()
        proc.wait(timeout=60)
