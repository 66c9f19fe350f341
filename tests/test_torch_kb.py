"""The PyTorch port's retrieval slice as a whole, against the JAX package
on the CPU: one store written by ``svs_tpu.KB`` and searched by both
``KB``s, the engine's guarded (v3) path on an identical pack, and the
pack bytes themselves."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svs_tpu
from svs_tpu.engine import index as jindex
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
