"""The PyTorch port's filtered pairwise (``document_top_pairwise_scores(n,
where=...)``) against the JAX package on the CPU: the same store through
``svs_tpu.KB`` and ``svs_tpu_torch.KB(device='cpu')`` must return the same
pairs (ids identical, scores within ``SCORE_ATOL``) for dict and
predicate filters at every storage precision, the edge cases and a meta
update (the reference's ``test_pairwise_filtered.py``, single-device
cases), plus one subset on the keyed route (a padded subset that is a
multiple of 4,096 rows) and one on the exact blocked pass.  Random unit
vectors give distinct pair scores."""

import shutil
import zlib

import numpy as np
import pytest
import torch

import svs_tpu
from svs_tpu.engine import index as jindex
from svs_tpu.engine.packing import pack_corpus as j_pack_corpus
from svs_tpu.engine.packing import pack_host as j_pack_host
import svs_tpu_torch
from svs_tpu_torch.convert import packed_from_numpy
from svs_tpu_torch.engine.index import RetrievalEngine
from svs_tpu_torch.ops import pairwise as tpw

torch.set_num_threads(2)

DIM = 16
SCORE_ATOL = 2e-6


def _vec(text):
    v = np.random.default_rng(zlib.crc32(text.encode())).standard_normal(DIM)
    return v / np.linalg.norm(v)


async def _embed(texts):
    return [[float(x) for x in _vec(t)] for t in texts]


def _twin(path, n=90, meta=lambda i: {"b": i % 3}):
    """A store of ``n`` docs written by ``svs_tpu.KB`` and a copy for the
    port: ``(reference path, port path)``."""
    kb = svs_tpu.KB(path, _embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(n):
            add(f"doc-{i}", meta=meta(i))
    kb.close()
    port = path.with_name(path.stem + "_port.sqlite")
    shutil.copy(path, port)
    return path, port


def _open_both(paths, **kw):
    return (
        svs_tpu.KB(paths[0], _embed, **kw),
        svs_tpu_torch.KB(paths[1], _embed, device="cpu", **kw),
    )


def _key(pairs):
    return [(a["id"], b["id"]) for _, a, b in pairs]


def _assert_same(got, want):
    assert _key(got) == _key(want)
    np.testing.assert_allclose(
        [s for s, _, _ in got], [s for s, _, _ in want], rtol=0, atol=SCORE_ATOL
    )


def _postfiltered_oracle(kb, n, pred):
    total = len(kb) * (len(kb) - 1) // 2
    full = kb.document_top_pairwise_scores(total)
    return [t for t in full if pred(t[1]) and pred(t[2])][:n]


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_filtered_pairwise_matches_jax_and_postfiltered_oracle(db_path, precision):
    pred = lambda d: d["meta"]["b"] == 1  # noqa: E731
    out = []
    for kb in _open_both(_twin(db_path), precision=precision):
        try:
            want = _postfiltered_oracle(kb, 7, pred)
            got_dict = kb.document_top_pairwise_scores(7, where={"b": 1})
            got_pred = kb.document_top_pairwise_scores(7, where=pred)
            assert _key(got_dict) == _key(want) == _key(got_pred)
            assert all(pred(a) and pred(b) for _, a, b in got_dict)
            out.append((got_dict, got_pred))
        finally:
            kb.close()
    _assert_same(out[1][0], out[0][0])
    _assert_same(out[1][1], out[0][1])


def test_filtered_pairwise_rescore_off_matches_jax(db_path):
    out = []
    for kb in _open_both(_twin(db_path), rescore=False):
        try:
            out.append(kb.document_top_pairwise_scores(6, where={"b": 2}))
        finally:
            kb.close()
    # raw bf16 prescores, summed in another order by XLA and torch
    assert _key(out[1]) == _key(out[0])
    np.testing.assert_allclose([s for s, _, _ in out[1]], [s for s, _, _ in out[0]],
                               rtol=0, atol=1e-6)


def test_filtered_pairwise_edge_cases(db_path):
    out = []
    for kb in _open_both(_twin(db_path, n=20)):
        try:
            with kb.bulk_query_docs() as q:
                some = next(iter(q.dfs_traversal()))["id"]
                q.update_doc_meta(some, {"b": 99})
            assert kb.document_top_pairwise_scores(5, where={"b": 99}) == []
            assert kb.document_top_pairwise_scores(0, where={"b": 1}) == []
            got = kb.document_top_pairwise_scores(4, where={})
            assert _key(got) == _key(kb.document_top_pairwise_scores(4))
            with kb.bulk_query_docs() as q:
                f = sum(1 for d in q.dfs_traversal() if d["meta"] == {"b": 1})
            all_pairs = kb.document_top_pairwise_scores(10_000, where={"b": 1})
            assert len(all_pairs) == f * (f - 1) // 2
            out.append(all_pairs)
        finally:
            kb.close()
    _assert_same(out[1], out[0])


def test_filtered_pairwise_after_meta_update(db_path):
    out = []
    for kb in _open_both(_twin(db_path, n=30)):
        try:
            before = kb.document_top_pairwise_scores(3, where={"b": 0})
            mover = before[0][1]["id"]
            with kb.bulk_query_docs() as q:
                q.update_doc_meta(mover, {"b": 7})
            after = kb.document_top_pairwise_scores(3, where={"b": 0})
            assert all(a["id"] != mover and b["id"] != mover for _, a, b in after)
            pred = lambda d: d["meta"]["b"] == 0  # noqa: E731
            assert _key(after) == _key(_postfiltered_oracle(kb, 3, pred))
            out.append(after)
        finally:
            kb.close()
    _assert_same(out[1], out[0])


def test_filtered_pairwise_feeds_no_width_hint(db_path):
    """A filtered call leaves the full corpus's pairwise hint alone."""
    ref_kb, kb = _open_both(_twin(db_path, n=60), precision="f32")
    try:
        for k in (ref_kb, kb):
            k.document_top_pairwise_scores(5, where={"b": 0})
        assert kb.engine._pair_hint == ref_kb.engine._pair_hint == {}
    finally:
        ref_kb.close()
        kb.close()


@pytest.fixture(scope="module")
def routes_store(tmp_path_factory):
    """6,000 docs: ``head`` marks the first 4,096 (a subset padded to
    4,096 rows: the keyed route) and ``g`` halves the store (3,000 rows,
    padded to 3,072: the exact blocked pass)."""
    path = tmp_path_factory.mktemp("routes") / "store.sqlite"
    kb = svs_tpu.KB(path, _embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(6000):
            add(f"doc-{i}", meta={"head": i < 4096, "g": i % 2})
    kb.close()
    return path


@pytest.mark.parametrize(
    "where,keyed",
    [({"head": True}, True), ({"g": 0}, False), (lambda d: d["meta"]["g"] == 0, False)],
    ids=["keyed_subset", "blocked_subset", "blocked_predicate"],
)
def test_subset_routes_match_jax(routes_store, monkeypatch, where, keyed):
    calls = []
    real_keyed, real_blocked = tpw.pairwise_candidates_keyed, tpw.pairwise_topk_blocked

    def keyed_spy(*a, **k):
        out = real_keyed(*a, **k)
        calls.append(("keyed", out[3]))
        return out

    def blocked_spy(*a, **k):
        calls.append(("blocked", True))
        return real_blocked(*a, **k)

    monkeypatch.setattr(tpw, "pairwise_candidates_keyed", keyed_spy)
    monkeypatch.setattr(tpw, "pairwise_topk_blocked", blocked_spy)
    ref_kb = svs_tpu.KB(routes_store, _embed)
    kb = svs_tpu_torch.KB(routes_store, _embed, device="cpu")
    try:
        want = ref_kb.document_top_pairwise_scores(20, where=where)
        got = kb.document_top_pairwise_scores(20, where=where)
    finally:
        ref_kb.close()
        kb.close()
    assert calls and all(c == ("keyed", True) for c in calls) == keyed, calls
    _assert_same(got, want)
    # the brute-force f32 top pairs of the subset
    rows = [i for i in range(6000) if (i < 4096 if keyed else i % 2 == 0)]
    m = np.stack([_vec(f"doc-{i}") for i in rows]).astype(np.float32)
    s = m @ m.T
    iu = np.triu_indices(len(rows), 1)
    top = np.argsort(-s[iu], kind="stable")[:20]
    assert _key(got) == [(rows[iu[0][t]] + 1, rows[iu[1][t]] + 1) for t in top]


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
def test_engine_subset_pairwise_corpus_matches_jax(precision):
    """The derived corpus: the subset's pack rows (and int8 scales) with
    zeroed padding to a multiple of 256, the host f32 rows along, no
    device mirror, and the reference's bytes."""
    rng = np.random.default_rng(51)
    m = rng.standard_normal((1000, 24)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    ids = np.arange(1, 1001, dtype=np.int64) * 3
    data, scales, emb, cache, row_map, n_valid, dim = j_pack_host(m, ids, precision)
    corpus = packed_from_numpy(
        data, scales, emb, n_valid, dim, 1, precision,
        float(scales[:n_valid].max()) if scales is not None else 0.0,
        cache, row_map, "cpu",
    )
    jcorpus = j_pack_corpus(m, ids, 1, precision)
    sub_ids = ids[::3]
    rows, present = corpus.rows_for_emb_ids(sub_ids)
    assert present.all()
    got = RetrievalEngine(device="cpu", precision=precision).subset_pairwise_corpus(
        corpus, rows, sub_ids
    )
    want = jindex.RetrievalEngine(precision=precision).subset_pairwise_corpus(
        jcorpus, rows, sub_ids
    )
    assert (got.n_valid, got.n_padded, got.dim) == (334, 512, want.dim)
    assert got.dev_rescore is None and got.dev_emb is None
    got_data = got.data.view(torch.int16) if precision == "bf16" else got.data
    want_data = np.asarray(want.data).view(np.int16) if precision == "bf16" else np.asarray(want.data)
    np.testing.assert_array_equal(got_data.numpy(), want_data)
    if precision == "int8":
        np.testing.assert_array_equal(got.row_scales.numpy(), np.asarray(want.row_scales))
    np.testing.assert_array_equal(got.emb_ids, sub_ids)
    np.testing.assert_array_equal(got.host_f32, want.host_f32)
    assert got.host_row_map is None and got.scale_max == corpus.scale_max
    assert not got.data[got.n_valid:].any()
