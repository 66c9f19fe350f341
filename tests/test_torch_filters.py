"""The PyTorch port's metadata filters on retrieval, against the JAX
package on the CPU: one store written by ``svs_tpu.KB`` is searched with
the same ``where=`` through ``svs_tpu.KB`` and ``svs_tpu_torch.KB(
device='cpu')`` (int8, bf16 and f32 storage, ``rescore=False``,
``device_rescore='host'``): the pre-filter route of a selective dict, the
post-filter ladder of an unselective one, an opaque predicate forced to
widen, and the edge cases.  Ids must be identical and scores within
``SCORE_ATOL``.  Then the reference's own filter tests
(``test_filter_prefilter.py``, ``test_filter_fuzz.py`` and the ``where=``
cases of ``test_kb_sync.py``) run as parity cases, and the engine's subset
routes are held to the reference's on one pack."""

import shutil
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svs_tpu
from svs_tpu.engine import index as jindex
from svs_tpu.engine.packing import pack_host as j_pack_host
import svs_tpu_torch
from svs_tpu_torch import kb as tkb
from svs_tpu_torch.convert import packed_from_numpy
from svs_tpu_torch.engine import index as tindex
from svs_tpu_torch.engine.index import RetrievalEngine

from kb_helpers import make_angle_embedder

torch.set_num_threads(2)

DIM = 16
N_DOCS = 3000
#: f32 dots accumulate in another order in XLA and torch: a few ulps of a
#: unit-norm score, far inside this.
SCORE_ATOL = 2e-6
QUERIES = [f"query {i}" for i in range(6)]


def _vector(text: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    v = rng.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


async def _embed(texts):
    return [_vector(t).tolist() for t in texts]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """3,000 random unit docs at d = 16: ``bucket`` (40 values, 75 docs
    each: the pre-filter route), ``half`` (1,500 docs each: the ladder)
    and ``rare`` (6 docs: fewer than n)."""
    path = tmp_path_factory.mktemp("filters") / "store.sqlite"
    kb = svs_tpu.KB(path, _embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(N_DOCS):
            add(
                f"doc {i}",
                meta={"bucket": i % 40, "half": i % 2, "rare": i % 500 == 0},
            )
    kb.close()
    return path


@pytest.fixture(scope="module", params=["int8", "bf16", "f32"])
def kbs(request, store):
    ref = svs_tpu.KB(store, _embed, precision=request.param)
    got = svs_tpu_torch.KB(store, _embed, precision=request.param, device="cpu")
    yield ref, got
    ref.close()
    got.close()


def _ids(results):
    return [[h["doc"]["id"] for h in hits] for hits in results]


def _assert_same(ref, got, atol=SCORE_ATOL):
    assert len(got) == len(ref)
    assert _ids(got) == _ids(ref)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(
            [h["score"] for h in g], [h["score"] for h in r], rtol=0, atol=atol
        )
        assert [h["doc"]["meta"] for h in g] == [h["doc"]["meta"] for h in r]


def _bucket7(doc):
    return doc["meta"]["bucket"] == 7


#: name -> (where, n)
CASES = {
    "prefilter_dict": ({"bucket": 7}, 10),
    "multi_key_dict": ({"bucket": 7, "half": 1}, 10),
    "ladder_dict": ({"half": 1}, 10),
    "predicate_widens": (_bucket7, 10),
    "empty_dict": ({}, 10),
    "zero_matches": ({"bucket": 99}, 10),
    "fewer_than_n": ({"rare": True}, 10),
    "n0": ({"bucket": 7}, 0),
}


def _spy_subset(kb, calls):
    real = kb.engine.subset_topk

    def spy(corpus, vectors, ids, n, key=None):
        calls.append(int(np.asarray(ids).size))
        return real(corpus, vectors, ids, n, key)

    kb.engine.subset_topk = spy  # type: ignore[method-assign]
    return real


def _spy_rounds(kb, rounds):
    """Record the ``n`` of every exact search the port's loops run."""
    real = kb._search.search_hydrated

    def spy(corpus, vectors, n):
        rounds.append(n)
        return real(corpus, vectors, n)

    kb._search.search_hydrated = spy  # type: ignore[method-assign]


@pytest.mark.parametrize("case", list(CASES))
def test_where_matches_jax_kb(kbs, case):
    ref_kb, kb = kbs
    where, n = CASES[case]
    calls, rounds = [], []
    real_subset = _spy_subset(kb, calls)
    _spy_rounds(kb, rounds)
    try:
        ref = ref_kb.retrieve_batch(QUERIES, n, where=where)
        got = kb.retrieve_batch(QUERIES, n, where=where)
    finally:
        kb.engine.subset_topk = real_subset
        del kb._search.search_hydrated
    _assert_same(ref, got)
    pred = where if callable(where) else svs_tpu_torch.meta_filter_predicate(where)
    assert all(pred(h["doc"]) for hits in got for h in hits)
    if case in ("prefilter_dict", "multi_key_dict", "fewer_than_n"):
        assert calls and not rounds  # the pre-filter route answered
        assert all(len(hits) == min(n, calls[0]) for hits in got)
    if case == "ladder_dict":
        assert not calls and rounds[0] == 40
    if case == "predicate_widens":
        assert not calls and rounds[:2] == [40, 160]  # the ladder widened
    if case == "empty_dict":
        assert not calls and rounds == [40]
    if case in ("zero_matches", "n0"):
        assert got == [[] for _ in QUERIES]


@pytest.mark.parametrize("where", [{"bucket": 7}, {"half": 0}, _bucket7],
                         ids=["prefilter", "ladder", "predicate"])
def test_where_rescore_off_matches_jax_kb(store, where):
    """``rescore=False`` ('auto' stores bf16, no device mirror): the
    pre-filter route scores the subset exactly from the host f32 cache,
    the ladder filters raw prescores (summed in another order by XLA and
    torch: near ties may trade places)."""
    ref_kb = svs_tpu.KB(store, _embed, rescore=False)
    kb = svs_tpu_torch.KB(store, _embed, rescore=False, device="cpu")
    try:
        ref = ref_kb.retrieve_batch(QUERIES, 10, where=where)
        got = kb.retrieve_batch(QUERIES, 10, where=where)
        assert kb.engine.precision == "bf16"
    finally:
        ref_kb.close()
        kb.close()
    for r, g in zip(ref, got):
        rs = np.asarray([h["score"] for h in r])
        np.testing.assert_allclose([h["score"] for h in g], rs, rtol=0, atol=1e-6)
        for j, (hr, hg) in enumerate(zip(r, g)):
            if hr["doc"]["id"] != hg["doc"]["id"]:
                assert np.min(np.abs(rs - rs[j])[np.arange(len(rs)) != j]) < 1e-6


@pytest.mark.parametrize("where", [{"bucket": 7}, {"half": 0}],
                         ids=["prefilter", "ladder"])
def test_where_host_rescore_matches_jax_and_device_route(store, where):
    """``device_rescore='host'``: no device mirror, the pre-filter subset
    is scored on the host (the reference's NumPy product, so the scores
    are its bits) and must equal the device route."""
    ref_kb = svs_tpu.KB(store, _embed, precision="int8", device_rescore="host")
    kb = svs_tpu_torch.KB(
        store, _embed, precision="int8", device_rescore="host", device="cpu"
    )
    dev_kb = svs_tpu_torch.KB(store, _embed, precision="int8", device="cpu")
    try:
        ref = ref_kb.retrieve_batch(QUERIES, 10, where=where)
        got = kb.retrieve_batch(QUERIES, 10, where=where)
        dev = dev_kb.retrieve_batch(QUERIES, 10, where=where)
        assert kb.engine.corpus.dev_rescore is None
        assert dev_kb.engine.corpus.dev_rescore is not None
    finally:
        ref_kb.close()
        kb.close()
        dev_kb.close()
    # the pre-filter host route is the reference's NumPy product: its bits
    _assert_same(ref, got, atol=0.0 if "bucket" in where else SCORE_ATOL)
    _assert_same(dev, got)


def test_where_after_incremental_delete_matches_jax_kb(store, tmp_path):
    """After an incremental delete the port's device row map is shorter
    than its mirror: the pre-filter gather maps rows through it."""
    ref_path, path = tmp_path / "ref.sqlite", tmp_path / "port.sqlite"
    shutil.copy(store, ref_path)
    shutil.copy(store, path)
    out = []
    for pkg, p, kw in ((svs_tpu, ref_path, {}), (svs_tpu_torch, path, {"device": "cpu"})):
        kb = pkg.KB(p, _embed, **kw)
        try:
            kb.retrieve_batch(QUERIES[:1], 5)  # pack first
            with kb.bulk_del_docs() as delete:
                for doc_id in range(1, 400, 3):
                    delete(doc_id)
            out.append(kb.retrieve_batch(QUERIES, 10, where={"bucket": 5}))
            assert kb.engine.pack_events["delete"] == 1
            if pkg is svs_tpu_torch:
                dev_f32, dev_map = kb.engine.corpus.dev_rescore
                assert dev_map is not None and dev_map.shape[0] < dev_f32.shape[0]
        finally:
            kb.close()
    _assert_same(*out)
    assert all((h["doc"]["id"] - 1) % 3 or h["doc"]["id"] >= 400 for hits in out[1] for h in hits)


# --- the engine's subset routes -------------------------------------------------


@pytest.mark.parametrize("with_map", [False, True], ids=["identity", "short_map"])
def test_subset_final_matches_jax(with_map):
    """The port's ``_subset_final`` against the JAX one on the same arrays:
    a mirror of 900 rows, pack rows mapped into it (a map of 700 rows,
    shorter than the mirror, as after an incremental delete), 300 subset
    rows padded to 512 with row 0."""
    rng = np.random.default_rng(41)
    d, f, f_pad, b, k = 24, 300, 512, 5, 17
    dev_f32 = rng.standard_normal((900, d)).astype(np.float32)
    dev_f32 /= np.linalg.norm(dev_f32, axis=1, keepdims=True)
    dev_map = rng.permutation(900)[:700].astype(np.int64) if with_map else None
    n_rows = 700 if with_map else 900
    rows = np.zeros(f_pad, dtype=np.int64)
    rows[:f] = rng.choice(n_rows, f, replace=False)
    emb = np.full(f_pad, -1, dtype=np.int32)
    emb[:f] = np.sort(rng.choice(10_000, f, replace=False))
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = np.asarray(jindex._subset_final(
        jnp.asarray(dev_f32),
        None if dev_map is None else jnp.asarray(dev_map.astype(np.int32)),
        jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(emb),
        jnp.int32(f),
        jnp.asarray(q),
        k,
    ))
    got = tindex._subset_final(
        torch.from_numpy(dev_f32),
        None if dev_map is None else torch.from_numpy(dev_map),
        torch.from_numpy(rows),
        torch.from_numpy(emb),
        f,
        torch.from_numpy(q),
        k,
    ).numpy()
    assert got.shape == want.shape == (b, 2 * k + 1)
    np.testing.assert_array_equal(got[:, :k], want[:, :k])
    np.testing.assert_allclose(
        got[:, k : 2 * k].view(np.float32), want[:, k : 2 * k].view(np.float32),
        rtol=0, atol=SCORE_ATOL,
    )
    # and the plain answer: the exact top-k of the live rows, ties to the
    # larger emb id
    src = rows[:f] if dev_map is None else dev_map[rows[:f]]
    exact = q @ dev_f32[src].T
    for r in range(b):
        order = np.lexsort((-emb[:f], -exact[r]))[:k]
        assert list(emb[:f][order]) == list(got[r, :k])


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
def test_engine_subset_topk_matches_jax(precision):
    """``subset_topk`` on the device route (the f32 pack is its own
    mirror), through the cache, with absent ids dropped, and on the host
    route; both packages on the same pack."""
    from svs_tpu.engine.packing import pack_corpus

    rng = np.random.default_rng(42)
    m = rng.standard_normal((1000, 20)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    ids = np.arange(1, 1001, dtype=np.int64) * 7
    host = j_pack_host(m, ids, precision)
    data, scales, emb, cache, row_map, n_valid, dim = host

    def port_corpus(mirror):
        return packed_from_numpy(
            data, scales, emb, n_valid, dim, 1, precision,
            float(scales[:n_valid].max()) if scales is not None else 0.0,
            cache, row_map, "cpu", mirror=mirror,
        )

    jcorpus = pack_corpus(m, ids, 1, precision)
    corpus, host_corpus = port_corpus(True), port_corpus(False)
    assert corpus.dev_rescore is not None and host_corpus.dev_rescore is None
    ref = jindex.RetrievalEngine(precision=precision)
    got = RetrievalEngine(device="cpu", precision=precision)
    q = rng.standard_normal((4, 20)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sub = np.concatenate([ids[::13], [3, 99_999]])  # two absent ids
    want = ref.subset_topk(jcorpus, q, sub, 12, "k")
    for _ in range(2):  # the second call rides the cache
        emb_d, scores_d = got.subset_topk(corpus, q, sub, 12, "k")
        np.testing.assert_array_equal(emb_d, want[0])
        np.testing.assert_allclose(scores_d, want[1], rtol=0, atol=SCORE_ATOL)
    assert list(got._subset_dev) == ["k"] and got._subset_dev["k"][0] is corpus
    # the host route: the reference's NumPy product
    emb_h, scores_h = got.subset_topk(host_corpus, q, sub, 12)
    np.testing.assert_array_equal(emb_h, want[0])
    np.testing.assert_allclose(scores_h, want[1], rtol=0, atol=SCORE_ATOL)
    # no matching row in the pack: empty lists
    e0, s0 = got.subset_topk(corpus, q, np.asarray([5]), 12)
    assert e0.shape == (4, 0) and s0.shape == (4, 0)


def test_engine_subset_topk_declines_without_a_route(monkeypatch):
    """No mirror and a host product past ``_SUBSET_HOST_MAX_FLOPS``: None
    (the caller runs the ladder), as the reference declines."""
    rng = np.random.default_rng(43)
    m = rng.standard_normal((600, 8)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    ids = np.arange(1, 601, dtype=np.int64)
    data, scales, emb, cache, row_map, n_valid, dim = j_pack_host(m, ids, "int8")
    corpus = packed_from_numpy(
        data, scales, emb, n_valid, dim, 1, "int8", float(scales[:n_valid].max()),
        cache, row_map, "cpu", mirror=False,
    )
    engine = RetrievalEngine(device="cpu")
    monkeypatch.setattr(tindex, "_SUBSET_HOST_MAX_FLOPS", 0)
    assert engine.subset_topk(corpus, m[:2], ids[:50], 5) is None


# --- the reference's filter tests, as parity cases -------------------------------


def _twin(db_path, n_docs=800, n_buckets=40):
    """The reference's pre-filter corpus (``n_docs`` distinct angles, meta
    bucket i % n_buckets) written by ``svs_tpu.KB``, and a copy for the
    port: ``(reference path, port path)``."""
    kb = svs_tpu.KB(db_path, make_angle_embedder())
    with kb.bulk_add_docs() as add:
        for i in range(n_docs):
            add(f"angle:{i * 0.2}", meta={"bucket": i % n_buckets})
    kb.close()
    port = db_path.with_name("port.sqlite")
    shutil.copy(db_path, port)
    return db_path, port


def _open_both(paths, **kw):
    return (
        svs_tpu.KB(paths[0], make_angle_embedder(), **kw),
        svs_tpu_torch.KB(paths[1], make_angle_embedder(), device="cpu", **kw),
    )


def _key(hits):
    return [(h["doc"]["id"], h["score"]) for h in hits]


def _assert_key_close(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=SCORE_ATOL)


def _oracle(kb, query, n, pred):
    full = kb.retrieve(query, len(kb))
    return [(h["doc"]["id"], h["score"]) for h in full if pred(h["doc"])][:n]


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_prefilter_matches_ladder_oracle_and_jax(db_path, precision):
    paths = _twin(db_path)
    out = []
    for kb in _open_both(paths, precision=precision):
        try:
            calls = []
            _spy_subset(kb, calls)
            pred = svs_tpu_torch.meta_filter_predicate({"bucket": 7})
            fast = kb.retrieve("angle:33.3", 5, where={"bucket": 7})
            assert calls == [20]
            ladder = kb.retrieve("angle:33.3", 5, where=lambda d: pred(d))
            assert _key(fast) == _key(ladder) == _oracle(kb, "angle:33.3", 5, pred)
            assert all(h["doc"]["meta"] == {"bucket": 7} for h in fast)
            out.append(_key(fast))
        finally:
            kb.close()
    _assert_key_close(out[1], out[0])


def test_prefilter_tie_rule_larger_emb_id_first(db_path):
    """Duplicate vectors inside the filtered subset: equal exact scores
    surface the LARGER emb id first, in both packages."""
    out = []
    for i, pkg in enumerate((svs_tpu, svs_tpu_torch)):
        kw = {"device": "cpu"} if pkg is svs_tpu_torch else {}
        kb = pkg.KB(db_path.with_name(f"tie{i}.sqlite"), make_angle_embedder(), **kw)
        try:
            with kb.bulk_add_docs() as add:
                for j in range(400):
                    add(f"angle:{j}", meta={"dup": False})
                for _ in range(4):
                    add("angle:12", meta={"dup": True})
            calls = []
            _spy_subset(kb, calls)
            hits = kb.retrieve("angle:12", 4, where={"dup": True})
            assert calls == [4]
            ids = [h["doc"]["id"] for h in hits]
            assert ids == sorted(ids, reverse=True) and len(ids) == 4
            assert len({h["score"] for h in hits}) == 1
            out.append(_key(hits))
        finally:
            kb.close()
    assert out[0] == out[1]


def test_prefilter_zero_matches_and_unselective_gate(db_path):
    paths = _twin(db_path, n_docs=400, n_buckets=2)  # 200 per bucket
    out = []
    for kb in _open_both(paths):
        try:
            calls = []
            _spy_subset(kb, calls)
            assert kb.retrieve("angle:0", 3, where={"bucket": 99}) == []
            pred = svs_tpu_torch.meta_filter_predicate({"bucket": 1})
            hits = kb.retrieve("angle:10", 5, where={"bucket": 1})
            assert calls == []  # the gate refused both
            assert _key(hits) == _oracle(kb, "angle:10", 5, pred)
            out.append(_key(hits))
        finally:
            kb.close()
    _assert_key_close(out[1], out[0])


def test_prefilter_fewer_matches_than_n(db_path):
    paths = _twin(db_path)
    out = []
    for kb in _open_both(paths):
        try:
            calls = []
            _spy_subset(kb, calls)
            hits = kb.retrieve("angle:5", 50, where={"bucket": 11})  # 20 match
            assert calls == [20] and len(hits) == 20
            scores = [h["score"] for h in hits]
            assert scores == sorted(scores, reverse=True)
            assert all(h["doc"]["meta"]["bucket"] == 11 for h in hits)
            out.append(_key(hits))
        finally:
            kb.close()
    _assert_key_close(out[1], out[0])


def test_prefilter_index_invalidates_on_write(db_path):
    paths = _twin(db_path)
    out = []
    for kb in _open_both(paths):
        try:
            before = kb.retrieve("angle:160", 3, where={"bucket": 0})
            with kb.bulk_add_docs() as add:
                add("angle:160.01", meta={"bucket": 0})
            after = kb.retrieve("angle:160", 3, where={"bucket": 0})
            assert "angle:160.01" in [h["doc"]["text"] for h in after]
            assert after != before
            out.append(_key(after))
        finally:
            kb.close()
    _assert_key_close(out[1], out[0])


def test_prefilter_host_route_matches_device_route(db_path):
    paths = _twin(db_path)
    ref_kb, kb_dev = _open_both(paths)
    try:
        want = _key(ref_kb.retrieve("angle:42", 6, where={"bucket": 13}))
        dev = _key(kb_dev.retrieve("angle:42", 6, where={"bucket": 13}))
    finally:
        ref_kb.close()
        kb_dev.close()
    kb_host = svs_tpu_torch.KB(paths[1], make_angle_embedder(), device="cpu",
                               device_rescore="host")
    try:
        calls = []
        _spy_subset(kb_host, calls)
        hits = kb_host.retrieve("angle:42", 6, where={"bucket": 13})
        assert calls == [20]
    finally:
        kb_host.close()
    _assert_key_close(_key(hits), want)
    _assert_key_close(_key(hits), dev)


def test_prefilter_declines_to_ladder_when_no_route(db_path, monkeypatch):
    import svs_tpu.engine.index as eidx

    monkeypatch.setattr(eidx, "_SUBSET_HOST_MAX_FLOPS", 0)
    monkeypatch.setattr(tindex, "_SUBSET_HOST_MAX_FLOPS", 0)
    paths = _twin(db_path)
    out = []
    for kb in _open_both(paths, device_rescore="host"):
        try:
            pred = svs_tpu_torch.meta_filter_predicate({"bucket": 7})
            hits = kb.retrieve("angle:33.3", 5, where={"bucket": 7})
            assert _key(hits) == _oracle(kb, "angle:33.3", 5, pred)
            out.append(_key(hits))
        finally:
            kb.close()
    _assert_key_close(out[1], out[0])


def test_prefilter_repeat_queries_reuse_device_subset(db_path):
    paths = _twin(db_path)
    kb = svs_tpu_torch.KB(paths[1], make_angle_embedder(), device="cpu")
    try:
        kb.retrieve("angle:1", 3, where={"bucket": 5})
        key = tkb.MetaRowIndex.canonical({"bucket": 5})
        assert key == svs_tpu.kb.MetaRowIndex.canonical({"bucket": 5})
        entry = kb.engine._subset_dev[key]
        kb.retrieve("angle:2", 3, where={"bucket": 5})
        assert kb.engine._subset_dev[key] is entry  # reused, not re-uploaded
    finally:
        kb.close()


def test_meta_row_index_value_types_match_jax(db_path):
    """Value semantics match ``meta_filter_predicate`` across JSON types
    (str/int/float/bool/nested through the Python scan, absent keys,
    null), multi-key filters intersect, and both packages' indexes agree."""
    kb = svs_tpu_torch.KB(db_path, make_angle_embedder(), device="cpu")
    metas = [
        {"k": "a", "j": 1},
        {"k": "a", "j": 2},
        {"k": 1},
        {"k": 1.0},
        {"k": True},
        {"k": {"nested": [1, 2]}},
        {"k": None},
        {"k": "1"},
        None,
    ]
    try:
        with kb.bulk_add_docs() as add:
            for i, meta in enumerate(metas):
                add(f"angle:{i * 7}", meta=meta)
        idx, jidx = tkb.MetaRowIndex(), svs_tpu.kb.MetaRowIndex()
        with kb._require_db().transaction() as tx:
            for flt in (
                {"k": "a"},
                {"k": 1},
                {"k": True},
                {"k": 1.0},
                {"k": "1"},
                {"k": None},
                {"k": {"nested": [1, 2]}},
                {"k": "a", "j": 2},
                {"missing": 0},
            ):
                got = idx.lookup(tx, flt)
                pred = svs_tpu_torch.meta_filter_predicate(flt)
                want = sorted(
                    i + 1 for i, meta in enumerate(metas) if pred({"meta": meta})
                )
                assert got.tolist() == want, flt
                assert got.tolist() == jidx.lookup(tx, flt).tolist(), flt
            assert idx.lookup(tx, {}) is None
    finally:
        kb.close()


def test_rows_for_emb_ids_inverse_with_missing(db_path):
    paths = _twin(db_path, n_docs=100, n_buckets=4)
    kb = svs_tpu_torch.KB(paths[1], make_angle_embedder(), device="cpu")
    try:
        with kb._lock:
            corpus = kb._ensure_engine_fresh()
        ids = np.asarray([1, 50, 100, 101, 9999], dtype=np.int64)
        rows, present = corpus.rows_for_emb_ids(ids)
        assert present.tolist() == [True, True, True, False, False]
        assert np.array_equal(corpus.emb_ids[rows[present]], ids[present])
    finally:
        kb.close()


def test_filter_constants_match_jax():
    assert tkb._PREFILTER_MAX_ROWS == svs_tpu.kb._PREFILTER_MAX_ROWS
    assert tkb._FILTER_OVERFETCH == svs_tpu.kb._FILTER_OVERFETCH
    assert tindex._SUBSET_HOST_MAX_FLOPS == jindex._SUBSET_HOST_MAX_FLOPS
    assert tindex._SUBSET_DEV_CACHE_MAX == jindex._SUBSET_DEV_CACHE_MAX


def test_meta_only_swap_invalidates_subset_cache(db_path):
    """A meta update that swaps which docs match at the same count must
    not serve the old match set from the device subset cache."""
    paths = _twin(db_path, n_docs=200, n_buckets=10)
    out = []
    for kb in _open_both(paths):
        try:
            first = kb.retrieve("angle:10.0", 3, where={"bucket": 7})
            a = first[0]["doc"]["id"]
            with kb.bulk_query_docs() as q:
                some_b3 = next(
                    d["id"] for d in q.dfs_traversal() if d["meta"] == {"bucket": 3}
                )
                q.update_doc_meta(a, {"bucket": 3})
                q.update_doc_meta(some_b3, {"bucket": 7})
            after = kb.retrieve("angle:10.0", 3, where={"bucket": 7})
            assert a not in {h["doc"]["id"] for h in after}
            ladder = kb.retrieve("angle:10.0", 3,
                                 where=lambda d: d["meta"] == {"bucket": 7})
            assert _key(after) == _key(ladder)
            out.append(_key(after))
        finally:
            kb.close()
    _assert_key_close(out[1], out[0])


def test_meta_index_eviction_does_not_break_inflight_lookup(db_path):
    paths = _twin(db_path, n_docs=100, n_buckets=4)
    kb = svs_tpu_torch.KB(paths[1], make_angle_embedder(), device="cpu")
    try:
        with kb._require_db().transaction() as tx:
            idx = tkb.MetaRowIndex(max_entries=1)
            assert idx.lookup(tx, {"bucket": 1, "missing": "x"}).size == 0
            assert idx.lookup(tx, {"bucket": 1}).size == 25
    finally:
        kb.close()


def test_unserializable_filter_value_falls_back_to_ladder(db_path):
    paths = _twin(db_path, n_docs=80, n_buckets=4)
    out = []
    for kb in _open_both(paths):
        try:
            got = kb.retrieve("angle:4.2", 3, where={"bucket": np.int64(1)})
            assert len(got) == 3
            assert all(h["doc"]["meta"]["bucket"] == 1 for h in got)
            pred = svs_tpu_torch.meta_filter_predicate({"bucket": 1})
            assert _key(got) == _key(kb.retrieve("angle:4.2", 3, where=lambda d: pred(d)))
            out.append(_key(got))
        finally:
            kb.close()
    _assert_key_close(out[1], out[0])


def test_subset_cache_sweeps_stale_corpus_entries(db_path):
    paths = _twin(db_path, n_docs=200, n_buckets=10)
    kb = svs_tpu_torch.KB(paths[1], make_angle_embedder(), device="cpu")
    try:
        kb.retrieve("angle:10.0", 3, where={"bucket": 7})
        eng = kb.engine
        assert len(eng._subset_dev) == 1
        old_corpus = next(iter(eng._subset_dev.values()))[0]
        with kb.bulk_add_docs() as add:  # a repack
            for i in range(40):
                add(f"angle:{900 + i * 0.2}", meta={"bucket": i % 10})
        kb.retrieve("angle:10.0", 3, where={"bucket": 3})
        assert eng._subset_dev and all(
            e[0] is not old_corpus for e in eng._subset_dev.values()
        )
    finally:
        kb.close()


# --- the reference's filter fuzz, in lockstep -------------------------------------

FUZZ_DIM = 8
VALUES = ["a", "b", 1, 1.0, True, 0, False, None, "1", [1], {"x": 1}]
KEYS = ["k", "tag", "n"]


def _fuzz_vec(text):
    v = np.random.default_rng(zlib.crc32(text.encode())).standard_normal(FUZZ_DIM)
    return v / np.linalg.norm(v)


async def _fuzz_embed(texts):
    return [[float(x) for x in _fuzz_vec(t)] for t in texts]


def _rand_meta(rng):
    if rng.random() < 0.15:
        return None
    meta = {k: VALUES[int(rng.integers(0, len(VALUES)))]
            for k in KEYS if rng.random() < 0.6}
    return meta or None


def _rand_filter(rng):
    flt = {}
    for _ in range(1 if rng.random() < 0.7 else 2):
        flt[KEYS[int(rng.integers(0, len(KEYS)))]] = VALUES[int(rng.integers(0, len(VALUES)))]
    return flt


@pytest.mark.parametrize("seed", [3, 41])
def test_filtered_retrieval_fuzz_matches_jax(tmp_path, seed):
    """Random adds, deletes and meta updates interleaved with filtered
    retrieves, applied alike to a store of each package: every retrieve
    runs the pre-filter route (dict) and the ladder (opaque callable) on
    both KBs, against an in-memory oracle."""
    rng = np.random.default_rng(seed)
    ref_kb = svs_tpu.KB(tmp_path / "ref.sqlite", _fuzz_embed, precision="f32",
                        force_fresh_db=True)
    kb = svs_tpu_torch.KB(tmp_path / "port.sqlite", _fuzz_embed, precision="f32",
                          force_fresh_db=True, device="cpu")
    model = {}
    next_text = 0
    try:
        for step in range(40):
            op = rng.choice(["add", "del", "meta", "retrieve", "retrieve", "retrieve"])
            if op == "add" or not model:
                items = []
                for _ in range(int(rng.integers(1, 5))):
                    items.append((f"doc-{next_text}", _rand_meta(rng), bool(rng.random() < 0.1)))
                    next_text += 1
                for k in (ref_kb, kb):
                    with k.bulk_add_docs() as add:
                        ids = [add(t, meta=m, no_embedding=ne) for t, m, ne in items]
                for doc_id, (t, m, ne) in zip(ids, items):
                    model[doc_id] = (None if ne else _fuzz_vec(t), m)
            elif op == "del":
                victim = int(rng.choice(list(model)))
                for k in (ref_kb, kb):
                    with k.bulk_del_docs() as dd:
                        dd(victim)
                del model[victim]
            elif op == "meta":
                doc_id = int(rng.choice(list(model)))
                new_meta = _rand_meta(rng)
                for k in (ref_kb, kb):
                    with k.bulk_query_docs() as q:
                        q.update_doc_meta(doc_id, new_meta)
                model[doc_id] = (model[doc_id][0], new_meta)
            else:
                qtext = f"doc-{int(rng.integers(0, max(next_text, 1)))}"
                n = int(rng.integers(1, 6))
                flt = _rand_filter(rng)
                pred = svs_tpu_torch.meta_filter_predicate(flt)
                qvec = _fuzz_vec(qtext)
                scored = sorted(
                    (
                        (float(np.dot(vec, qvec)), doc_id)
                        for doc_id, (vec, meta) in model.items()
                        if vec is not None and pred({"meta": meta})
                    ),
                    key=lambda t: (-t[0], -t[1]),
                )
                want = [i for _, i in scored[:n]]
                ref = _key(ref_kb.retrieve(qtext, n, where=flt))
                fast = _key(kb.retrieve(qtext, n, where=flt))
                ladder = _key(kb.retrieve(qtext, n, where=lambda d: pred(d)))
                assert [i for i, _ in fast] == want, (step, flt)
                assert fast == ladder, (step, flt)
                _assert_key_close(fast, ref)
    finally:
        ref_kb.close()
        kb.close()


# --- the where= cases of test_kb_sync -----------------------------------------------


def _bucket_where(want):
    return lambda d: (d["meta"] or {}).get("bucket") == want


def _angles(db_path, degs, meta):
    paths = []
    for i, pkg in enumerate((svs_tpu, svs_tpu_torch)):
        p = db_path.with_name(f"angles{i}.sqlite")
        kw = {"device": "cpu"} if pkg is svs_tpu_torch else {}
        kb = pkg.KB(p, make_angle_embedder(), rescore=True, **kw)
        with kb.bulk_add_docs() as add:
            for deg in degs:
                add(f"angle:{deg}", meta=meta(deg))
        paths.append(kb)
    return paths


def test_retrieve_filtered_matches_oracle(db_path):
    out = []
    for kb in _angles(db_path, range(0, 180, 5), lambda deg: {"bucket": deg % 3}):
        try:
            where = _bucket_where(0)
            hits = kb.retrieve("angle:47", 4, where=where)
            assert len(hits) == 4 and all(where(h["doc"]) for h in hits)
            assert _key(hits) == _oracle(kb, "angle:47", 4, where)
            out.append(_key(hits))
        finally:
            kb.close()
    _assert_key_close(out[1], out[0])


def test_retrieve_filtered_widens_to_reach_rare_matches(db_path):
    kbs_ = _angles(db_path, range(0, 180, 5), lambda deg: {"far": deg >= 165})
    rounds = {}
    for name, kb in zip(("ref", "port"), kbs_):
        try:
            searches = rounds[name] = []
            if name == "port":
                _spy_rounds(kb, searches)
            else:
                real = kb._search_hydrated

                def spy(corpus, vectors, n, real=real, searches=searches):
                    searches.append(n)
                    return real(corpus, vectors, n)

                kb._search_hydrated = spy
            hits = kb.retrieve("angle:0", 3, where=lambda d: (d["meta"] or {})["far"])
            assert [h["doc"]["text"] for h in hits] == [
                "angle:165", "angle:170", "angle:175"
            ]
            assert len(searches) >= 2 and searches[0] == 12 and searches[-1] == 36
        finally:
            kb.close()
    assert rounds["port"] == rounds["ref"]


def test_retrieve_filtered_fewer_matches_than_n(db_path):
    for kb in _angles(db_path, range(0, 90, 10),
                      lambda deg: {"bucket": 1 if deg == 40 else 2}):
        try:
            hits = kb.retrieve("angle:0", 5, where=_bucket_where(1))
            assert [h["doc"]["text"] for h in hits] == ["angle:40"]
            assert kb.retrieve("angle:0", 5, where=_bucket_where(99)) == []
        finally:
            kb.close()


def test_retrieve_batch_filtered_mixed_satisfaction(db_path):
    """Per-query convergence: an all-matching filter is satisfied in round
    one; a far filter widens on its own queries only."""
    ref_kb, kb = _angles(db_path, range(0, 180, 5), lambda deg: {"far": deg >= 165})
    try:
        batch_sizes = []
        real = kb._search.search_hydrated

        def spy(corpus, vectors, n):
            batch_sizes.append(vectors.shape[0])
            return real(corpus, vectors, n)

        kb._search.search_hydrated = spy
        res = kb.retrieve_batch(["angle:0", "angle:0"], 2, where=lambda d: True)
        assert all(len(r) == 2 for r in res)
        assert len(batch_sizes) == 1
        far = lambda d: (d["meta"] or {})["far"]  # noqa: E731
        res2 = kb.retrieve_batch(["angle:0", "angle:90"], 2, where=far)
        assert all(
            [h["doc"]["text"] for h in r] == ["angle:165", "angle:170"] for r in res2
        )
        want = ref_kb.retrieve_batch(["angle:0", "angle:90"], 2, where=far)
        for r, g in zip(want, res2):
            _assert_key_close(_key(g), _key(r))
    finally:
        ref_kb.close()
        kb.close()


def test_retrieve_filtered_predicate_exception_propagates(db_path):
    kb = svs_tpu_torch.KB(db_path, make_angle_embedder(), device="cpu")
    try:
        with kb.bulk_add_docs() as add:
            add("angle:0")

        def boom(doc):
            raise RuntimeError("predicate exploded")

        with pytest.raises(RuntimeError, match="predicate exploded"):
            kb.retrieve("angle:0", 1, where=boom)
    finally:
        kb.close()
