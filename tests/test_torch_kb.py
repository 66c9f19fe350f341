"""The PyTorch port's retrieval slice as a whole, against the JAX package
on the CPU: one store written by ``svs_tpu.KB`` and searched by both
``KB``s (int8, bf16 and f32 storage, ``rescore=False``, and a batch above
256), the engine's guarded (v3) path on an identical pack, and the pack
bytes themselves."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svs_tpu
from svs_tpu.engine import index as jindex
from svs_tpu.engine.packing import pack_corpus as j_pack_corpus
from svs_tpu.engine.packing import pack_host as j_pack_host
from svs_tpu.ops import pallas_extract as J
import svs_tpu_torch
from svs_tpu_torch.convert import packed_from_numpy
from svs_tpu_torch.engine.index import RetrievalEngine
from svs_tpu_torch.engine.packing import pack_host as t_pack_host

torch.set_num_threads(2)

DIM = 64
N_DOCS = 20_000
#: f32 dots accumulate in another order in XLA and torch: a few ulps of
#: a unit-norm score, far inside this.
SCORE_ATOL = 2e-6


def _vector(text: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    v = rng.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


async def _embed(texts):
    return [_vector(t).tolist() for t in texts]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = tmp_path_factory.mktemp("kb") / "store.sqlite"
    kb = svs_tpu.KB(path, _embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(N_DOCS):
            add(f"document number {i}")
    kb.close()
    return path


@pytest.mark.parametrize("b", [4, 16])
def test_retrieve_batch_matches_jax_kb(store, b):
    queries = [f"query {b}-{i}" for i in range(b)]
    ref_kb = svs_tpu.KB(store, _embed)
    try:
        ref = ref_kb.retrieve_batch(queries, 10)
    finally:
        ref_kb.close()
    kb = svs_tpu_torch.KB(store, _embed, device="cpu")
    try:
        got = kb.retrieve_batch(queries, 10)
        assert len(kb) == N_DOCS
        assert kb.stats()["pack_events"]["scan"] == 1.0
    finally:
        kb.close()
    assert len(got) == b
    for r, g in zip(ref, got):
        assert [h["doc"]["id"] for h in g] == [h["doc"]["id"] for h in r]
        assert [h["doc"]["text"] for h in g] == [h["doc"]["text"] for h in r]
        np.testing.assert_allclose(
            [h["score"] for h in g], [h["score"] for h in r],
            rtol=0, atol=SCORE_ATOL,
        )


def _both_kbs(store, queries, n, monkeypatch, **kw):
    """``retrieve_batch`` through both packages' KBs with the same options.
    The reference's host route is turned off so that it, too, searches on
    its device path."""
    monkeypatch.setenv("SVS_TPU_HOST_DISPATCH", "off")
    ref_kb = svs_tpu.KB(store, _embed, **kw)
    try:
        ref = ref_kb.retrieve_batch(queries, n)
    finally:
        ref_kb.close()
    kb = svs_tpu_torch.KB(store, _embed, device="cpu", **kw)
    try:
        got = kb.retrieve_batch(queries, n)
        precision = kb.engine.precision
    finally:
        kb.close()
    assert len(got) == len(queries)
    return ref, got, precision


def _assert_same_hits(ref, got, atol):
    """Same documents in the same order, except that two hits whose
    scores lie within ``atol`` may trade places; scores within ``atol``."""
    for r, g in zip(ref, got):
        assert len(g) == len(r)
        rs = np.asarray([h["score"] for h in r])
        gs = np.asarray([h["score"] for h in g])
        np.testing.assert_allclose(gs, rs, rtol=0, atol=atol)
        for j, (hr, hg) in enumerate(zip(r, g)):
            if hr["doc"]["id"] != hg["doc"]["id"]:
                assert np.min(np.abs(rs - rs[j])[np.arange(len(rs)) != j]) < atol


@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_float_precisions_match_jax_kb(store, b, precision, monkeypatch):
    queries = [f"query {precision} {b}-{i}" for i in range(b)]
    ref, got, used = _both_kbs(store, queries, 10, monkeypatch, precision=precision)
    assert used == precision
    for r, g in zip(ref, got):
        assert [h["doc"]["id"] for h in g] == [h["doc"]["id"] for h in r]
        np.testing.assert_allclose(
            [h["score"] for h in g], [h["score"] for h in r],
            rtol=0, atol=SCORE_ATOL,
        )


@pytest.mark.parametrize("b", [4, 16])
def test_rescore_off_matches_jax_kb(store, b, monkeypatch):
    """``rescore=False``: 'auto' stores bf16 and both packages return the
    raw v1 prescores in device order (f32 sums of bf16 products, summed in
    another order by XLA and torch)."""
    queries = [f"raw query {b}-{i}" for i in range(b)]
    ref, got, used = _both_kbs(store, queries, 10, monkeypatch, rescore=False)
    assert used == "bf16"
    _assert_same_hits(ref, got, 1e-6)


def test_batch_above_256_matches_jax_kb(store, monkeypatch):
    """B = 300 on int8: past FUSED_MAX_BATCH both packages take the
    two-pass ``_extract`` (n_padded = 32,768)."""
    queries = [f"wide query {i}" for i in range(300)]
    ref, got, used = _both_kbs(store, queries, 10, monkeypatch)
    assert used == "int8"
    for r, g in zip(ref, got):
        assert [h["doc"]["id"] for h in g] == [h["doc"]["id"] for h in r]
        np.testing.assert_allclose(
            [h["score"] for h in g], [h["score"] for h in r],
            rtol=0, atol=SCORE_ATOL,
        )


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"rescore": False},
        {"kernel": "pallas"},
        {"kernel": "xla"},
        {"precision": "f32", "rescore": False},
        {"precision": "int8", "kernel": "xla"},
    ],
    ids=["auto", "rescore_off", "pallas", "xla", "f32_raw", "int8_xla"],
)
def test_engine_options_resolve_like_jax(kw):
    """``precision='auto'`` resolves by the reference's rule, and the
    candidate count and v2/v3 gates follow ``rescore`` and ``kernel``."""
    ref = jindex.RetrievalEngine(**kw)
    got = RetrievalEngine(device="cpu", **kw)
    assert (got.precision, got.rescore, got.kernel) == (ref.precision, ref.rescore, ref.kernel)
    assert got.candidate_count(10) == ref.candidate_count(10)
    m, ids = _pack_inputs(20_000, DIM, 6)
    data, scales, emb, cache, row_map, n_valid, dim = j_pack_host(
        m, ids, got.precision, row_multiple=16384
    )
    jcorpus = j_pack_corpus(m, ids, 1, got.precision, row_multiple=16384)
    corpus = packed_from_numpy(
        data, scales, emb, n_valid, dim, 1, got.precision,
        float(scales[:n_valid].max()) if scales is not None else 0.0,
        cache, row_map, "cpu",
    )
    for b, c in ((8, 40), (16, 400), (300, 40)):
        assert got._keyed_selection_possible(corpus, b, c) == ref._keyed_selection_possible(jcorpus, b, c)
        assert got._guarded_selection_possible(corpus, b, c) == ref._guarded_selection_possible(jcorpus, b, c)
    q = np.eye(4, DIM, dtype=np.float32)
    np.testing.assert_array_equal(
        got.prescore_eps(corpus, q, 40), ref.prescore_eps(jcorpus, q, 40)
    )


def test_refused_options():
    with pytest.raises(ValueError, match="float storage"):
        RetrievalEngine(device="cpu", precision="int8", kernel="pallas")
    with pytest.raises(ValueError, match="device_rescore"):
        RetrievalEngine(device="cpu", device_rescore="device")


def _pack_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    emb_ids = np.arange(1, n + 1, dtype=np.int64) * 3  # not the row numbers
    return m, emb_ids


def _cache_rows(cache, row_map):
    return cache if row_map is None else cache[row_map]


def test_pack_host_bytes_match_jax():
    m, ids = _pack_inputs(20_000, DIM, 4)
    j = j_pack_host(m, ids, "int8", row_multiple=16384)
    t = t_pack_host(m, ids, "int8", row_multiple=16384)
    for a, b in zip(j[:3], t[:3]):  # data, scales, emb ids
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert j[5:] == t[5:]  # n, d
    np.testing.assert_array_equal(_cache_rows(j[3], j[4]), _cache_rows(t[3], t[4]))


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_pack_host_float_bytes_match_jax(precision):
    m, ids = _pack_inputs(20_000, DIM, 5)
    m[3, :3] = [1e-40, -0.0, 3.4e38]  # a subnormal, a signed zero, a round-up
    j = j_pack_host(m, ids, precision, row_multiple=16384)
    t = t_pack_host(m, ids, precision, row_multiple=16384)
    assert j[1] is None and t[1] is None  # no row scales
    assert j[0].shape == t[0].shape and j[0].dtype.itemsize == t[0].dtype.itemsize
    assert j[0].tobytes() == t[0].tobytes()
    assert j[2].tobytes() == t[2].tobytes()  # emb ids
    assert j[5:] == t[5:]  # n, d
    np.testing.assert_array_equal(_cache_rows(j[3], j[4]), _cache_rows(t[3], t[4]))


def test_engine_v3_path_matches_jax():
    """131,072 x 128 (nb = 16, the smallest guarded corpus), B = 16: the
    port's engine on the JAX package's own pack, through
    ``convert.packed_from_numpy``, against the reference's v3 prescore +
    on-device final selection."""
    n, d, b, k = 131_072 - 3000, 128, 16, 10
    m, ids = _pack_inputs(n, d, 8)
    data, scales, emb, cache, row_map, n_valid, dim = j_pack_host(
        m, ids, "int8", row_multiple=16384
    )
    corpus = packed_from_numpy(
        data, scales, emb, n_valid, dim, 1, "int8",
        float(scales[:n_valid].max()), cache, row_map, "cpu",
    )
    engine = RetrievalEngine(device="cpu")
    c = engine.initial_candidates(k, n_valid)
    assert engine._guarded_selection_possible(corpus, b, c)
    rng = np.random.default_rng(12)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got_emb, got_scores, got_boundary = engine.topk_final(corpus, q, k, c)

    packed = J.score_topk_fused3_int8_packed(
        jnp.asarray(data), jnp.asarray(scales), jnp.asarray(q),
        jnp.int32(n_valid), c, interpret=True,
    )
    wire = np.asarray(
        jindex._final_from_packed(
            packed,
            jnp.asarray(cache),
            None if row_map is None else jnp.asarray(row_map.astype(np.int32)),
            jnp.asarray(emb.astype(np.int32)),
            jnp.asarray(q),
            k,
            False,
        )
    )
    np.testing.assert_array_equal(got_emb, wire[:, :k])
    ref_scores = np.ascontiguousarray(wire[:, k : 2 * k]).view(np.float32)
    np.testing.assert_allclose(got_scores, ref_scores, rtol=0, atol=SCORE_ATOL)
    ref_boundary = np.ascontiguousarray(wire[:, 2 * k]).view(np.float32)
    # the boundary is the prescore path's bound: identical bits
    np.testing.assert_array_equal(got_boundary.view(np.int32), ref_boundary.view(np.int32))
    # and the returned ids are the brute-force f32 top-k
    exact = q @ m.T
    for row in range(b):
        top = np.argsort(-exact[row], kind="stable")[:k]
        assert list(ids[top]) == list(got_emb[row])
