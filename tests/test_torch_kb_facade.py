"""The PyTorch port's KB facade beyond retrieval, against the JAX package
on the CPU: deletes, document queries, edges, key/value, ``load()``,
``warmup()`` and ``close(write_sidecar=...)``.  Each test copies one store
written by ``svs_tpu.KB`` (roots with children), makes the same calls
through both packages' ``KB``s on two copies of it, and compares what
they return; retrieval after a delete also reads one file with both."""

import shutil
import zlib

import numpy as np
import pytest
import torch

import svs_tpu
import svs_tpu_torch

torch.set_num_threads(2)

DIM = 32
N_ROOTS = 300
#: f32 dots accumulate in another order in XLA and torch
SCORE_ATOL = 2e-6


def _vector(text: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    v = rng.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


async def _embed(texts):
    return [_vector(t).tolist() for t in texts]


@pytest.fixture(scope="module")
def base_store(tmp_path_factory):
    """``N_ROOTS`` roots, each with one child and every fifth with a
    grandchild under that child; every doc embedded, some with meta."""
    path = tmp_path_factory.mktemp("facade") / "base.sqlite"
    kb = svs_tpu.KB(path, _embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(N_ROOTS):
            root = add(f"root {i}", meta={"i": i} if i % 3 == 0 else None)
            child = add(f"child {i}", parent_id=root)
            if i % 5 == 0:
                add(f"grandchild {i}", parent_id=child, meta={"deep": True})
    kb.close()
    return path


@pytest.fixture
def stores(base_store, tmp_path, monkeypatch):
    """Two copies of the base store: ``(reference's, port's)``.  The
    reference's host route is off, so that it searches on its device
    path as the port does."""
    monkeypatch.setenv("SVS_TPU_HOST_DISPATCH", "off")
    ref, port = tmp_path / "ref.sqlite", tmp_path / "port.sqlite"
    shutil.copy(base_store, ref)
    shutil.copy(base_store, port)
    return ref, port


def _ids(results):
    return [[h["doc"]["id"] for h in hits] for hits in results]


def _assert_same_hits(ref, got):
    assert _ids(got) == _ids(ref)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(
            [h["score"] for h in g], [h["score"] for h in r], rtol=0, atol=SCORE_ATOL
        )
        assert [h["doc"]["text"] for h in g] == [h["doc"]["text"] for h in r]
        assert [h["doc"]["meta"] for h in g] == [h["doc"]["meta"] for h in r]


QUERIES = [f"query {i}" for i in range(12)]


def _retrieve_both(path, n=10):
    """``retrieve_batch(QUERIES, n)`` through both KBs on one file."""
    ref_kb = svs_tpu.KB(path, _embed)
    try:
        ref = ref_kb.retrieve_batch(QUERIES, n)
    finally:
        ref_kb.close()
    kb = svs_tpu_torch.KB(path, _embed, device="cpu")
    try:
        got = kb.retrieve_batch(QUERIES, n)
    finally:
        kb.close()
    return ref, got


def _leaf_hits(results, count):
    """Up to ``count`` distinct hit ids that are not parents (children
    and grandchildren of roots whose index is not a multiple of 5)."""
    out = []
    for hits in results:
        for h in hits:
            text = h["doc"]["text"]
            leaf = text.startswith("grandchild") or (
                text.startswith("child") and int(text.split()[1]) % 5 != 0
            )
            if leaf and h["doc"]["id"] not in out:
                out.append(h["doc"]["id"])
    return out[:count]


@pytest.mark.parametrize("precision", ["auto", "f32"])
def test_delete_then_retrieve_matches_reference(stores, precision):
    """Deletes through each package, on a KB that has already packed: the
    next search repacks as the reference's does (an incremental delete,
    the same ``pack_events``), returns no deleted id, and both packages
    read the same hits from the file."""
    ref_path, path = stores
    ref_kb = svs_tpu.KB(ref_path, _embed, precision=precision)
    kb = svs_tpu_torch.KB(path, _embed, device="cpu", precision=precision)
    try:
        before = kb.retrieve_batch(QUERIES, 10)
        ref_kb.retrieve_batch(QUERIES, 10)
        gone = _leaf_hits(before, 15)
        assert len(gone) == 15
        for k in (kb, ref_kb):
            with k.bulk_del_docs() as delete:
                for doc_id in gone:
                    delete(doc_id)
        after = kb.retrieve_batch(QUERIES, 10)
        ref_kb.retrieve_batch(QUERIES, 10)
        assert kb.stats()["pack_events"] == ref_kb.stats()["pack_events"]
        assert kb.stats()["pack_events"]["delete"] == 1.0
        assert len(kb) == 2 * N_ROOTS + N_ROOTS // 5 - len(gone)
    finally:
        kb.close()
        ref_kb.close()
    assert not set(gone) & {i for row in _ids(after) for i in row}
    ref, got = _retrieve_both(path)
    _assert_same_hits(ref, got)
    _assert_same_hits(ref, after)


def test_same_deletes_through_both_packages(stores):
    """The same deletes through each package's ``bulk_del_docs``, one copy
    each; deleting a parent raises in both and rolls back that block."""
    paths = dict(zip(("ref", "port"), stores))
    kbs = {
        "ref": svs_tpu.KB(paths["ref"], _embed),
        "port": svs_tpu_torch.KB(paths["port"], _embed, device="cpu"),
    }
    out = {}
    try:
        for name, kb in kbs.items():
            with kb.bulk_query_docs() as q:
                grandchildren = [d["id"] for d in q.query_level(2)]
                parent = q.query_doc(grandchildren[1])["parent_id"]
            with kb.bulk_del_docs() as delete:
                for doc_id in grandchildren[::2]:
                    delete(doc_id)
            with pytest.raises(RuntimeError, match="parent"):
                with kb.bulk_del_docs() as delete:
                    delete(grandchildren[3])  # rolled back with the block
                    delete(parent)
            out[name] = (len(kb), kb.retrieve_batch(QUERIES[:4], 5))
    finally:
        for kb in kbs.values():
            kb.close()
    assert out["port"][0] == out["ref"][0] == 2 * N_ROOTS + N_ROOTS // 5 - 30
    _assert_same_hits(out["ref"][1], out["port"][1])


def test_load_prewarms_then_retrieves_like_reference(stores):
    _, path = stores
    kb = svs_tpu_torch.KB(path, _embed, device="cpu")
    try:
        kb.load()
        assert kb.engine.pack_events["scan"] == 1
        cache = kb._doc_cache
        assert cache._warm and len(cache._rows) == 2 * N_ROOTS + N_ROOTS // 5
        got = kb.retrieve_batch(QUERIES, 10)
        with kb._require_db().transaction() as tx:
            assert cache.is_warm_for(tx)  # hydration read nothing new
        assert kb.engine.pack_events["scan"] == 1
    finally:
        kb.close()
    ref_kb = svs_tpu.KB(path, _embed)
    try:
        ref_kb.load()
        ref = ref_kb.retrieve_batch(QUERIES, 10)
    finally:
        ref_kb.close()
    _assert_same_hits(ref, got)


def test_delete_after_load_drops_prewarmed_rows(stores):
    _, path = stores
    kb = svs_tpu_torch.KB(path, _embed, device="cpu")
    try:
        kb.load()
        gone = _leaf_hits(kb.retrieve_batch(QUERIES, 10), 4)
        with kb.bulk_del_docs() as delete:
            for doc_id in gone:
                delete(doc_id)
        with kb._require_db().transaction() as tx:
            assert not kb._doc_cache.is_warm_for(tx)
        got = kb.retrieve_batch(QUERIES, 10)
        assert not kb._doc_cache._warm
        cached = {rec["id"] for rec, _ in kb._doc_cache._rows.values()}
        assert cached and not set(gone) & cached
        assert not set(gone) & {i for row in _ids(got) for i in row}
    finally:
        kb.close()
    ref, _ = _retrieve_both(path)
    _assert_same_hits(ref, got)


def _query_calls(kb):
    """A fixed sequence of ``bulk_query_docs`` calls and their results."""
    with kb.bulk_query_docs() as q:
        first = q.query_level(0, limit=3)
        q.update_doc_meta(first[0]["id"], {"tag": "updated", "n": [1, 2]})
        q.update_doc_meta(first[1]["id"], None)
        out = {
            "count": q.count(),
            "dfs": list(q.dfs_traversal()),
            "dfs_emb": [d["embedding"] for d in q.dfs_traversal(True)][:8],
            "children": q.query_children(first[0]["id"]),
            "level1": q.query_level(1, limit=7),
            "doc": q.query_doc(first[0]["id"]),
            "doc_emb": q.query_doc(first[2]["id"], include_embedding=True),
        }
    with kb.bulk_query_docs() as q:
        out["after"] = [q.query_doc(d["id"]) for d in first]
    return out


def test_bulk_query_docs_matches_reference(stores):
    ref_path, port_path = stores
    ref_kb = svs_tpu.KB(ref_path, _embed)
    try:
        ref = _query_calls(ref_kb)
    finally:
        ref_kb.close()
    kb = svs_tpu_torch.KB(port_path, _embed, device="cpu")
    try:
        got = _query_calls(kb)
    finally:
        kb.close()
    assert len(got["dfs"]) == got["count"] == 2 * N_ROOTS + N_ROOTS // 5
    # depth first: every doc follows its parent
    seen = set()
    for d in got["dfs"]:
        assert d["parent_id"] is None or d["parent_id"] in seen
        seen.add(d["id"])
    assert got["after"][0]["meta"] == {"tag": "updated", "n": [1, 2]}
    assert got["after"][1]["meta"] is None
    for key in ("count", "dfs", "children", "level1", "doc", "after"):
        assert got[key] == ref[key], key
    for key in ("dfs_emb",):
        for g, r in zip(got[key], ref[key]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    np.testing.assert_array_equal(
        np.asarray(got["doc_emb"]["embedding"]), np.asarray(ref["doc_emb"]["embedding"])
    )


def _graph_calls(kb):
    with kb.bulk_query_docs() as q:
        ids = [d["id"] for d in q.query_level(0, limit=6)]
    with kb.bulk_graph_update() as g:
        e1 = g.add_edge(ids[0], ids[1], ids[2])
        g.add_directed_edge(ids[1], ids[3], ids[2], weight=0.5)
        g.add_edge(ids[3], ids[4], ids[5], 2.0)
        e4 = g.add_directed_edge(ids[4], ids[0], ids[5])
    with pytest.raises(RuntimeError, match="already exists"):
        with kb.bulk_graph_update() as g:
            g.add_edge(ids[5], ids[0], ids[1])  # rolled back with the block
            g.add_edge(ids[0], ids[1], ids[2])  # the same triplet again
    with kb.bulk_graph_update() as g:
        g.del_edge(e1)
        with pytest.raises(KeyError):
            g.del_edge(e4 + 100)
        return {
            "count": g.count_edges(),
            "edges": g.edges(),
            "page": g.edges(limit=2, offset=1),
            "ids": e4 - e1,
        }


def test_bulk_graph_update_matches_reference(stores):
    ref_path, port_path = stores
    ref_kb = svs_tpu.KB(ref_path, _embed)
    try:
        ref = _graph_calls(ref_kb)
    finally:
        ref_kb.close()
    kb = svs_tpu_torch.KB(port_path, _embed, device="cpu")
    try:
        got = _graph_calls(kb)
    finally:
        kb.close()
    assert got["count"] == 3
    assert [e["directed"] for e in got["edges"]] == [True, False, True]
    assert got["edges"][0]["weight"] == 0.5
    assert got == ref


def _keyval_calls(kb):
    with kb.bulk_keyval_update() as kv:
        kv["a"] = 1
        kv.set("b", "two")
        kv["c"] = 3.5
        kv["a"] = 10  # overwrite
        del kv["c"]
        with pytest.raises(KeyError):
            kv.remove("c")
        with pytest.raises(KeyError):
            kv.get("c")
        out = {
            "has": ("a" in kv, kv.has("c")),
            "get": (kv["a"], kv.get("b"), kv.get("c", None)),
            "len": (len(kv), kv.count()),
            "items": sorted(kv.items()),
            "keys": sorted(kv),
        }
    with kb.bulk_keyval_update() as kv:
        out["reopened"] = sorted(kv.items())
    return out


def test_bulk_keyval_update_matches_reference(stores):
    ref_path, port_path = stores
    ref_kb = svs_tpu.KB(ref_path, _embed)
    try:
        ref = _keyval_calls(ref_kb)
    finally:
        ref_kb.close()
    kb = svs_tpu_torch.KB(port_path, _embed, device="cpu")
    try:
        got = _keyval_calls(kb)
    finally:
        kb.close()
    assert got["items"] == [("a", 10), ("b", "two")]
    assert got == ref


def _first_leaf(kb):
    with kb.bulk_query_docs() as q:
        return q.query_level(2, limit=1)[0]["id"]


#: Each bulk context with a write made inside it, then an exception.
ROLLBACKS = {
    "del": (lambda kb: kb.bulk_del_docs(), lambda ctx, kb, leaf: ctx(leaf)),
    "query": (
        lambda kb: kb.bulk_query_docs(),
        lambda ctx, kb, leaf: ctx.update_doc_meta(leaf, {"x": 1}),
    ),
    "graph": (
        lambda kb: kb.bulk_graph_update(),
        lambda ctx, kb, leaf: ctx.add_edge(leaf, leaf, leaf),
    ),
    "keyval": (lambda kb: kb.bulk_keyval_update(), lambda ctx, kb, leaf: ctx.set("k", 1)),
}


def _state(kb, leaf):
    with kb.bulk_query_docs() as q:
        doc = q.query_doc(leaf)
        count = q.count()
    with kb.bulk_graph_update() as g:
        edges = g.count_edges()
    with kb.bulk_keyval_update() as kv:
        keys = kv.count()
    return count, doc["meta"], edges, keys


@pytest.mark.parametrize("package", ["ref", "port"])
@pytest.mark.parametrize("context", sorted(ROLLBACKS))
def test_exception_rolls_back_bulk_context(stores, context, package):
    """A write made inside a bulk context is rolled back when the block
    raises, and the context's calls assert once the block has ended."""
    path = stores[0] if package == "ref" else stores[1]
    kb = (
        svs_tpu.KB(path, _embed)
        if package == "ref"
        else svs_tpu_torch.KB(path, _embed, device="cpu")
    )
    enter, write = ROLLBACKS[context]
    try:
        leaf = _first_leaf(kb)
        before = _state(kb, leaf)
        with pytest.raises(ZeroDivisionError):
            with enter(kb) as ctx:
                write(ctx, kb, leaf)
                1 / 0
        assert _state(kb, leaf) == before
        with pytest.raises(AssertionError, match="outside of the context"):
            write(ctx, kb, leaf)
    finally:
        kb.close()


def test_warmup_records_its_phase(stores):
    _, path = stores
    kb = svs_tpu_torch.KB(path, _embed, device="cpu")
    try:
        kb.warmup(batch_sizes=(1, 4), n=5, rounds=2, routes="device")
        stats = kb.stats()
        assert stats["warmup"]["count"] == 4
        assert stats["pack_events"]["scan"] == 1.0
        assert "embed" not in stats  # random queries, no embedding calls
    finally:
        kb.close()


def test_close_write_sidecar_publishes_like_reference(stores):
    """``close(write_sidecar=True)`` on a KB that never packed: each package
    scans, packs on the host and publishes ``<db>.svsx``; the two files are
    byte for byte the same, and the port's KB is closed after it."""
    ref_path, path = stores
    kb = svs_tpu_torch.KB(path, _embed, device="cpu")
    assert len(kb) == 2 * N_ROOTS + N_ROOTS // 5
    kb.close(write_sidecar=True)
    with pytest.raises(RuntimeError, match="closed"):
        len(kb)
    svs_tpu.KB(ref_path, _embed).close(write_sidecar=True)
    ours = path.with_name(path.name + ".svsx").read_bytes()
    theirs = ref_path.with_name(ref_path.name + ".svsx").read_bytes()
    assert ours == theirs
