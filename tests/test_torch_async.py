"""The PyTorch port's ``AsyncKB`` against the JAX package's on the CPU:
the scenarios of the reference's ``test_kb_async.py`` run through both
packages' ``AsyncKB`` (``svs_tpu_torch`` with ``device='cpu'``) with the
same expected results, then parity checks: filtered retrieval and
filtered pairwise against ``svs_tpu.AsyncKB``, the port's ``AsyncKB``
against its ``KB`` on one file, embeddings awaited on the caller's event
loop, concurrent calls, and reuse after ``close()``."""

import asyncio
import zlib

import numpy as np
import pytest
import torch

import svs_tpu
import svs_tpu_torch

from kb_helpers import make_angle_embedder, make_onehot_embedder

torch.set_num_threads(2)

SCORE_ATOL = 2e-6


@pytest.fixture(params=["svs_tpu", "svs_tpu_torch"])
def AKB(request):
    """The ``AsyncKB`` of one package (the port's on the CPU)."""
    if request.param == "svs_tpu":
        return svs_tpu.AsyncKB

    def make(*args, **kw):
        return svs_tpu_torch.AsyncKB(*args, device="cpu", **kw)

    return make


# --- the reference's scenarios, through both packages -------------------------------


async def test_lazy_init_and_reopen_from_params(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    assert kb.db is None  # nothing opened yet
    async with kb.bulk_add_docs() as add:
        await add("hello")
    await kb.close()
    kb2 = AKB(db_path)  # no function: restored from the database
    hits = await kb2.retrieve("x", 1)
    assert hits[0]["doc"]["text"] == "hello"
    await kb2.close()


async def test_close_on_new_db_without_func_raises(db_path, AKB):
    kb = AKB(db_path)
    with pytest.raises(RuntimeError, match="No embedding function"):
        await kb.close()


async def test_embedding_func_reset_on_close(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    await kb.load()
    await kb.close()
    kb2 = AKB(db_path)
    await kb2.load()
    assert kb2.embedding_func is not None
    await kb2.close()
    assert kb2.embedding_func is None


async def test_gzip_artifact_bytes_match_db(db_path, AKB):
    import gzip

    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    async with kb.bulk_add_docs() as add:
        await add("content")
    await kb.close(also_gzip=True)
    with gzip.open(f"{db_path}.gz", "rb") as f:
        assert f.read() == db_path.read_bytes()


async def test_no_func_anywhere_raises(db_path, AKB):
    kb = AKB(db_path)
    with pytest.raises(RuntimeError, match="No embedding function"):
        async with kb.bulk_add_docs():
            pass


async def test_retrieve_ordering(db_path, AKB):
    kb = AKB(db_path, make_angle_embedder())
    async with kb.bulk_add_docs() as add:
        for deg in [0, 10, 20, 45, 90]:
            await add(f"angle:{deg}")
    hits = await kb.retrieve("angle:12", 3)
    assert [h["doc"]["text"] for h in hits] == ["angle:10", "angle:20", "angle:0"]
    assert hits[0]["score"] == pytest.approx(np.cos(np.radians(2)), abs=1e-6)
    await kb.close()


async def test_retrieve_batch(db_path, AKB):
    kb = AKB(db_path, make_onehot_embedder())
    async with kb.bulk_add_docs() as add:
        for i in range(6):
            await add(f"vec:{i}")
    res = await kb.retrieve_batch(["vec:1", "vec:4"], 2)
    assert res[0][0]["doc"]["text"] == "vec:1"
    assert res[1][0]["doc"]["text"] == "vec:4"
    assert await kb.retrieve_batch([], 2) == []
    await kb.close()


async def test_load_warms_engine(db_path, AKB):
    kb = AKB(db_path, make_onehot_embedder())
    async with kb.bulk_add_docs() as add:
        await add("vec:0")
    await kb.load()
    assert kb.engine.corpus is not None
    assert kb.engine.corpus.n_valid == 1
    await kb.close()


async def test_bulk_add_rollback(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    with pytest.raises(RuntimeError, match="boom"):
        async with kb.bulk_add_docs() as add:
            await add("doomed")
            raise RuntimeError("boom")
    async with kb.bulk_query_docs() as q:
        assert await q.count() == 0
    await kb.close()


async def test_bulk_add_rollback_on_embedding_failure(db_path, AKB):
    async def flaky(texts):
        raise ConnectionError("down")

    kb = AKB(db_path, flaky)
    with pytest.raises(ConnectionError):
        async with kb.bulk_add_docs() as add:
            await add("doomed")
    async with kb.bulk_query_docs() as q:
        assert await q.count() == 0
    await kb.close()


async def test_escape_guard(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    async with kb.bulk_add_docs() as add:
        await add("x")
    with pytest.raises(AssertionError):
        await add("outside")
    await kb.close()


async def test_hierarchy_and_dfs(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    async with kb.bulk_add_docs() as add:
        root = await add("root")
        kid = await add("kid", parent_id=root)
        grand = await add("grand", parent_id=kid)
        other = await add("other-root")
    async with kb.bulk_query_docs() as q:
        assert await q.count() == 4
        assert (await q.query_doc(grand))["level"] == 2
        assert [d["id"] for d in await q.query_children(root)] == [kid]
        assert [d["id"] for d in await q.query_level(0, limit=1)] == [root]
        order = [d["id"] async for d in q.dfs_traversal()]
        assert order == [root, kid, grand, other]
        await q.update_doc_meta(root, {"m": 1})
        assert (await q.query_doc(root))["meta"] == {"m": 1}
    await kb.close()


async def test_bulk_del(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    async with kb.bulk_add_docs() as add:
        await add("a")
        b = await add("b")
    async with kb.bulk_del_docs() as dd:
        await dd(b)
    async with kb.bulk_query_docs() as q:
        assert await q.count() == 1
    await kb.close()


async def test_keyval_interface(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    async with kb.bulk_keyval_update() as kv:
        assert not await kv.has("a")
        await kv.set("a", 42)
        await kv.set("b", b"raw-bytes")
        assert await kv.get("a") == 42
        assert await kv.get("missing", "fallback") == "fallback"
        with pytest.raises(KeyError):
            await kv.get("missing")
        assert await kv.count() == 2
        items = [i async for i in kv.items()]
        assert sorted(items) == [("a", 42), ("b", b"raw-bytes")]
        await kv.remove("a")
        with pytest.raises(KeyError):
            await kv.remove("a")
    await kb.close()


async def test_keyval_rollback(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    with pytest.raises(RuntimeError, match="boom"):
        async with kb.bulk_keyval_update() as kv:
            await kv.set("a", 1)
            raise RuntimeError("boom")
    async with kb.bulk_keyval_update() as kv:
        assert await kv.count() == 0
    await kb.close()


async def test_graph_interface(db_path, AKB):
    import networkx as nx

    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    async with kb.bulk_add_docs() as add:
        a, b, r = await add("a"), await add("b"), await add("r")
    async with kb.bulk_graph_update() as g:
        e = await g.add_edge(a, b, r, weight=1.5)
        with pytest.raises(RuntimeError, match="already exists"):
            await g.add_edge(a, b, r)
        assert await g.count_edges() == 1
        graph = await g.build_networkx_graph()
        assert isinstance(graph, nx.MultiGraph)
        assert graph[a][b][0]["weight"] == 1.5
        await g.del_edge(e)
        assert await g.count_edges() == 0
    await kb.close()


async def test_graph_edges_enumeration(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    async with kb.bulk_add_docs() as add:
        a, b, r = await add("a"), await add("b"), await add("r")
    async with kb.bulk_graph_update() as g:
        e1 = await g.add_edge(a, b, r, weight=0.5)
        e2 = await g.add_directed_edge(b, a, r)
        rows = await g.edges()
        assert rows == [
            {"id": e1, "a": a, "b": b, "relationship": r, "weight": 0.5,
             "directed": False},
            {"id": e2, "a": b, "b": a, "relationship": r, "weight": None,
             "directed": True},
        ]
        assert await g.edges(limit=1) == rows[:1]
        assert await g.edges(limit=5, offset=1) == rows[1:]
    await kb.close()


async def test_pairwise_scores(db_path, AKB):
    kb = AKB(db_path, make_angle_embedder())
    async with kb.bulk_add_docs() as add:
        for deg in [0, 5, 90, 180]:
            await add(f"angle:{deg}")
    pairs = await kb.document_top_pairwise_scores(1)
    _, d1, d2 = pairs[0]
    assert {d1["text"], d2["text"]} == {"angle:0", "angle:5"}
    await kb.close()


async def test_close_gzip(db_path, AKB):
    kb = AKB(db_path, svs_tpu_torch.make_mock_embeddings_func())
    async with kb.bulk_add_docs() as add:
        await add("z")
    await kb.close(vacuum=True, also_gzip=True)
    kb2 = AKB(f"{db_path}.gz")
    async with kb2.bulk_query_docs() as q:
        assert await q.count() == 1
    await kb2.close()


async def test_reference_retrieval_scenario(db_path, AKB):
    """The reference suite's canonical retrieve scenario: exact orderings
    and freshness across an add and deletes."""

    async def embed(texts):
        table = {
            "first": [1.0, 0.001, 0.0],
            "second": [0.0, 1.0, 0.0001],
            "third": [0.01, 0.0, 1.0],
            "forth": [0.707, 0.707, 0.0],
        }
        return [next(v for key, v in table.items() if key in t) for t in texts]

    kb = AKB(db_path, embed)
    async with kb.bulk_add_docs() as add_doc:
        assert await add_doc("third doc") == 1
        assert await add_doc("first doc") == 2
        assert await add_doc("second doc") == 3
    for query, order in [
        ("... first ...", ["first doc", "third doc", "second doc"]),
        ("... second ...", ["second doc", "first doc", "third doc"]),
        ("... third ...", ["third doc", "first doc", "second doc"]),
    ]:
        docs = await kb.retrieve(query, n=3)
        assert [d["doc"]["text"] for d in docs] == order
    records = await kb.document_top_pairwise_scores(n=2)
    assert [(a["id"], b["id"]) for _, a, b in records] == [(1, 2), (2, 3)]
    assert (await kb.retrieve("... forth ...", 1))[0]["doc"]["text"] == "first doc"
    async with kb.bulk_add_docs() as add_doc:
        assert await add_doc("forth doc") == 4
    assert (await kb.retrieve("... forth ...", 1))[0]["doc"]["text"] == "forth doc"
    async with kb.bulk_del_docs() as del_doc:
        await del_doc(1), await del_doc(2), await del_doc(4)
    assert (await kb.retrieve("... forth ...", 1))[0]["doc"]["text"] == "second doc"
    await kb.close()


async def test_concurrent_retrieves(db_path, AKB):
    kb = AKB(db_path, make_onehot_embedder())
    async with kb.bulk_add_docs() as add:
        for i in range(10):
            await add(f"vec:{i}")
    results = await asyncio.gather(*(kb.retrieve(f"vec:{i}", 1) for i in range(5)))
    assert [r[0]["doc"]["text"] for r in results] == [f"vec:{i}" for i in range(5)]
    await kb.close()


async def test_retrieve_filtered(db_path, AKB):
    """Oracle-exact filtered top-n, including a forced widen past the
    first prefix and a dict on the pre-filter route."""
    kb = AKB(db_path, make_angle_embedder(), rescore=True)
    async with kb.bulk_add_docs() as add:
        for deg in range(0, 180, 5):
            await add(f"angle:{deg}", meta={"bucket": deg % 3})
    where = lambda d: (d["meta"] or {}).get("bucket") == 0  # noqa: E731
    hits = await kb.retrieve("angle:47", 4, where=where)
    full = await kb.retrieve("angle:47", 36)
    oracle = [h for h in full if where(h["doc"])][:4]
    key = lambda hs: [(h["doc"]["id"], h["score"]) for h in hs]  # noqa: E731
    assert key(hits) == key(oracle)
    assert key(await kb.retrieve("angle:47", 4, where={"bucket": 0})) == key(oracle)
    far = await kb.retrieve(
        "angle:0", 3, where=lambda d: int(d["text"].split(":")[1]) >= 165
    )
    assert [h["doc"]["text"] for h in far] == ["angle:165", "angle:170", "angle:175"]
    await kb.close()


async def test_filtered_pairwise(db_path, AKB):
    kb = AKB(db_path, make_angle_embedder())
    async with kb.bulk_add_docs() as add:
        for deg in (0, 3, 10, 40, 41, 90):
            await add(f"angle:{deg}", meta={"even": deg % 2 == 0})
    pairs = await kb.document_top_pairwise_scores(2, where={"even": True})
    assert [{a["text"], b["text"]} for _, a, b in pairs] == [
        {"angle:0", "angle:10"}, {"angle:10", "angle:40"}
    ]
    assert await kb.document_top_pairwise_scores(2, where={"even": "x"}) == []
    await kb.close()


async def test_mesh_and_replicas_refused():
    for kw in ({"mesh": object()}, {"replicas": 2}):
        with pytest.raises(NotImplementedError):
            svs_tpu_torch.AsyncKB("unused.sqlite", device="cpu", **kw)


# --- parity with svs_tpu.AsyncKB and the port's KB ------------------------------------

DIM = 16


def _vec(text):
    v = np.random.default_rng(zlib.crc32(text.encode())).standard_normal(DIM)
    return (v / np.linalg.norm(v)).astype(np.float32)


async def _embed(texts):
    return [_vec(t).tolist() for t in texts]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """1,200 random unit docs at d = 16, meta ``bucket`` (30 values: 40
    docs each, the pre-filter route) and ``half`` (the ladder)."""
    path = tmp_path_factory.mktemp("async") / "store.sqlite"
    kb = svs_tpu.KB(path, _embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(1200):
            add(f"doc {i}", meta={"bucket": i % 30, "half": i % 2})
    kb.close()
    return path


def _same(got, want):
    assert [[h["doc"]["id"] for h in hs] for hs in got] == [
        [h["doc"]["id"] for h in hs] for hs in want
    ]
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            [h["score"] for h in g], [h["score"] for h in w], rtol=0, atol=SCORE_ATOL
        )


CALLS = [
    (None, 10),
    ({"bucket": 4}, 10),
    ({"half": 1}, 10),
    (lambda d: d["meta"]["bucket"] < 2, 10),
]


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
async def test_async_kb_matches_jax_async_kb(store, precision):
    queries = [f"q {i}" for i in range(5)]
    out = {}
    for name, make in (
        ("ref", lambda: svs_tpu.AsyncKB(store, _embed, precision=precision)),
        ("port", lambda: svs_tpu_torch.AsyncKB(store, _embed, precision=precision,
                                               device="cpu")),
    ):
        kb = make()
        try:
            out[name] = [await kb.retrieve_batch(queries, n, where=w) for w, n in CALLS]
            out[name].append(await kb.document_top_pairwise_scores(8, where={"bucket": 2}))
        finally:
            await kb.close()
    for got, want in zip(out["port"][:-1], out["ref"][:-1]):
        _same(got, want)
    got_p, want_p = out["port"][-1], out["ref"][-1]
    assert [(a["id"], b["id"]) for _, a, b in got_p] == [(a["id"], b["id"]) for _, a, b in want_p]
    np.testing.assert_allclose([s for s, _, _ in got_p], [s for s, _, _ in want_p],
                               rtol=0, atol=SCORE_ATOL)


async def test_async_kb_matches_kb_on_one_file(store):
    """The port's two facades run one copy of the search loops: the same
    answers on the same file, filtered and not."""
    queries = [f"q {i}" for i in range(4)]
    kb = svs_tpu_torch.KB(store, _embed, device="cpu")
    try:
        want = [kb.retrieve_batch(queries, n, where=w) for w, n in CALLS]
        want_pairs = kb.document_top_pairwise_scores(6, where={"half": 0})
    finally:
        kb.close()
    akb = svs_tpu_torch.AsyncKB(store, _embed, device="cpu")
    try:
        got = [await akb.retrieve_batch(queries, n, where=w) for w, n in CALLS]
        got_pairs = await akb.document_top_pairwise_scores(6, where={"half": 0})
    finally:
        await akb.close()
    assert got == want  # same code, same bits
    assert got_pairs == want_pairs


async def test_embeddings_are_awaited_on_the_callers_loop(store):
    """An embedding function bound to the caller's loop keeps working: it
    runs on that loop, while search and hydration leave it."""
    seen = []

    async def embed(texts):
        seen.append(asyncio.get_running_loop())
        return await _embed(texts)

    kb = svs_tpu_torch.AsyncKB(store, embed, device="cpu")
    try:
        await kb.retrieve_batch(["q 0", "q 1"], 3)
        await kb.retrieve("q 2", 3, where={"bucket": 1})
    finally:
        await kb.close()
    assert seen and all(loop is asyncio.get_running_loop() for loop in seen)


async def test_concurrent_filtered_calls_match_serial(store):
    """Four unfiltered batches, one filtered batch and a filtered pairwise
    call in one ``asyncio.gather``: the same answers as one at a time."""
    batches = [[f"c {b}-{i}" for i in range(6)] for b in range(5)]
    wheres = [None, None, None, None, {"bucket": 7}]
    kb = svs_tpu_torch.AsyncKB(str(store), _embed, device="cpu")
    try:
        await kb.load()
        serial = [await kb.retrieve_batch(q, 10, where=w) for q, w in zip(batches, wheres)]
        serial.append(await kb.document_top_pairwise_scores(5, where={"bucket": 3}))
        together = await asyncio.gather(
            *(kb.retrieve_batch(q, 10, where=w) for q, w in zip(batches, wheres)),
            kb.document_top_pairwise_scores(5, where={"bucket": 3}),
        )
        assert kb.stats()["pack_events"]["scan"] == 1.0
    finally:
        await kb.close()
    assert list(together) == serial


async def test_reuse_after_close_and_warmup(db_path):
    kb = svs_tpu_torch.AsyncKB(db_path, make_angle_embedder(), device="cpu")
    async with kb.bulk_add_docs() as add:
        for deg in range(0, 90, 10):
            await add(f"angle:{deg}", meta={"b": deg % 20})
    await kb.close()
    assert kb.db is None
    # the same instance opens the file again on first use
    await kb.warmup((1, 3), n=4)
    assert kb.stats()["warmup"]["count"] == 4
    hits = await kb.retrieve("angle:31", 2, where={"b": 10})
    assert [h["doc"]["text"] for h in hits] == ["angle:30", "angle:50"]
    await kb.close()


async def test_where_dict_takes_the_prefilter_route(db_path):
    """The reference's ``test_where_dict_async``: a selective dict on
    ``AsyncKB`` scores only its bucket's rows and answers as the sync
    facade does, in both packages."""
    kb = svs_tpu.KB(db_path, make_angle_embedder())
    with kb.bulk_add_docs() as add:
        for i in range(800):
            add(f"angle:{i * 0.2}", meta={"bucket": i % 40})
    want = [(h["doc"]["id"], h["score"]) for h in kb.retrieve("angle:60", 4, where={"bucket": 3})]
    kb.close()
    for akb in (svs_tpu.AsyncKB(db_path, make_angle_embedder()),
                svs_tpu_torch.AsyncKB(db_path, make_angle_embedder(), device="cpu")):
        calls = []
        real = akb.engine.subset_topk

        def spy(corpus, vectors, ids, n, key=None, real=real):
            calls.append(int(np.asarray(ids).size))
            return real(corpus, vectors, ids, n, key)

        akb.engine.subset_topk = spy
        try:
            hits = await akb.retrieve("angle:60", 4, where={"bucket": 3})
        finally:
            await akb.close()
        assert calls == [20]
        got = [(h["doc"]["id"], h["score"]) for h in hits]
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=0, atol=SCORE_ATOL)
