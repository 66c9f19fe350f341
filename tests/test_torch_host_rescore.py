"""The host-finalised rescore of the PyTorch port against the JAX package
on the CPU: one store written by ``svs_tpu.KB``, searched by both
packages' ``KB``s with ``device_rescore='host'``, with the device mirror
over its ceiling (``SVS_TPU_DEVICE_RESCORE_MAX_BYTES=0``), with no host
f32 cache either (``SVS_TPU_RESCORE_CACHE_MAX_BYTES=0``: rows from
SQLite), and with the candidate gather over its ceiling.  Both packages
rescore with the same NumPy matvecs, so the ids are identical and the
scores bit-identical."""

import zlib

import numpy as np
import pytest
import torch

import svs_tpu
from svs_tpu.engine import index as jindex
import svs_tpu_torch
from svs_tpu_torch.convert import packed_from_numpy
from svs_tpu_torch.engine import index as tindex
from svs_tpu_torch.engine.index import RetrievalEngine
from svs_tpu_torch.engine.packing import pack_host

torch.set_num_threads(2)

DIM = 64
N_DOCS = 2_000
N_NEAR = 600

#: How each configuration reaches the host rescore: ``KB`` keywords,
#: environment, and whether both gather ceilings are cut to one byte.
CONFIGS = {
    "host": ({"device_rescore": "host"}, {}, False),
    "over_mirror": ({}, {"SVS_TPU_DEVICE_RESCORE_MAX_BYTES": "0"}, False),
    "sqlite": (
        {},
        {"SVS_TPU_DEVICE_RESCORE_MAX_BYTES": "0", "SVS_TPU_RESCORE_CACHE_MAX_BYTES": "0"},
        False,
    ),
    "gather": ({}, {}, True),
}


def _vector(text: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    v = rng.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


def _near(text: str) -> np.ndarray:
    """Near-duplicates of one direction: every score within ~1e-3, so
    the margin check fails until the candidates cover the store."""
    base = _vector("the near-tie axis")
    v = base + 1e-3 * _vector(text)
    return (v / np.linalg.norm(v)).astype(np.float32)


async def _embed(texts):
    return [_vector(t).tolist() for t in texts]


async def _embed_near(texts):
    return [_near(t).tolist() for t in texts]


def _write(path, embed, n, distinct):
    """``n`` docs over ``distinct`` texts: past ``distinct`` every vector
    comes again, so equal scores meet the reference tie rule."""
    kb = svs_tpu.KB(path, embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(n):
            add(f"document number {i % distinct}")
    kb.close()
    return path


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_rescore")
    return {
        "plain": (_write(root / "plain.sqlite", _embed, N_DOCS, N_DOCS), _embed),
        "near": (_write(root / "near.sqlite", _embed_near, N_NEAR, N_NEAR // 2), _embed_near),
    }


@pytest.fixture(scope="module")
def kb_pairs():
    """Open ``(svs_tpu.KB, svs_tpu_torch.KB)`` pairs, one per store,
    configuration and precision, closed when the module ends."""
    pairs = {}
    yield pairs
    for ref, kb in pairs.values():
        ref.close()
        kb.close()


def _pair(stores, kb_pairs, store, config, precision, monkeypatch):
    kw, env, small_gather = CONFIGS[config]
    monkeypatch.setenv("SVS_TPU_HOST_DISPATCH", "off")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if small_gather:
        monkeypatch.setattr(jindex, "_DEVICE_GATHER_MAX_BYTES", 1)
        monkeypatch.setattr(tindex, "_DEVICE_GATHER_MAX_BYTES", 1)
    key = (store, config, precision)
    if key not in kb_pairs:
        path, embed = stores[store]
        ref = svs_tpu.KB(path, embed, precision=precision, **kw)
        kb = svs_tpu_torch.KB(path, embed, precision=precision, device="cpu", **kw)
        kb_pairs[key] = (ref, kb)
    return kb_pairs[key]


def _same(ref, got):
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert [h["doc"]["id"] for h in g] == [h["doc"]["id"] for h in r]
        rs = np.asarray([h["score"] for h in r], dtype=np.float32)
        gs = np.asarray([h["score"] for h in g], dtype=np.float32)
        np.testing.assert_array_equal(gs.view(np.int32), rs.view(np.int32))


def _routes_to_host(kb, config):
    corpus = kb.engine.corpus
    if config == "gather":
        assert corpus.dev_rescore is not None
    else:
        assert corpus.dev_rescore is None
    assert (corpus.host_f32 is None) == (config == "sqlite")


@pytest.mark.parametrize("n", [10, 100])
@pytest.mark.parametrize("b", [1, 8, 64, 300])
@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("config", ["host", "over_mirror", "sqlite"])
def test_host_rescore_matches_jax_kb(stores, kb_pairs, config, precision, b, n, monkeypatch):
    ref_kb, kb = _pair(stores, kb_pairs, "plain", config, precision, monkeypatch)
    queries = [f"query {config} {precision} {b} {n} {i}" for i in range(b)]
    ref = ref_kb.retrieve_batch(queries, n)
    got = kb.retrieve_batch(queries, n)
    assert kb.engine.precision == precision
    _routes_to_host(kb, config)
    _same(ref, got)


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("config", ["host", "over_mirror", "sqlite", "gather"])
def test_near_tie_store_widens_like_jax_kb(stores, kb_pairs, config, precision, monkeypatch):
    """All scores within ~1e-3, each vector stored twice: the margin
    check widens the candidates (to the whole store where the prescore
    error is wider than the spread), equal scores break to the larger
    emb id, and the results match the reference bit for bit."""
    ref_kb, kb = _pair(stores, kb_pairs, "near", config, precision, monkeypatch)
    queries = [f"near query {config} {precision} {i}" for i in range(8)]
    before = kb.engine.widen_retries
    ref = ref_kb.retrieve_batch(queries, 10)
    got = kb.retrieve_batch(queries, 10)
    assert kb.engine.widen_retries > before
    _routes_to_host(kb, config)
    _same(ref, got)


@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("precision", ["int8", "f32"])
def test_gather_ceiling_routes_like_jax_kb(stores, kb_pairs, precision, b, monkeypatch):
    """A ``[B, C, d]`` gather over ``_DEVICE_GATHER_MAX_BYTES`` goes to the
    host rescore, as the reference routes it."""
    ref_kb, kb = _pair(stores, kb_pairs, "plain", "gather", precision, monkeypatch)
    queries = [f"gather query {precision} {b} {i}" for i in range(b)]
    ref = ref_kb.retrieve_batch(queries, 10)
    got = kb.retrieve_batch(queries, 10)
    _routes_to_host(kb, "gather")
    _same(ref, got)


def _corpus(precision, mirror):
    rng = np.random.default_rng(3)
    m = rng.standard_normal((1_000, DIM)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    ids = np.arange(1, len(m) + 1, dtype=np.int64) * 7
    data, scales, emb, cache, row_map, n, d = pack_host(m, ids, precision)
    corpus = packed_from_numpy(
        data, scales, emb, n, d, 1, precision,
        float(scales[:n].max()) if scales is not None else 0.0,
        cache, row_map, "cpu", mirror=mirror,
    )
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    return corpus, m, q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
def test_topk_final_returns_none_without_mirror(precision):
    corpus, _, q = _corpus(precision, mirror=False)
    engine = RetrievalEngine(device="cpu", precision=precision)
    assert corpus.dev_rescore is None and corpus.dev_emb is None
    assert engine.topk_final(corpus, q, 10, 40) is None
    vals, rows, exact = engine.topk_with_rescore(corpus, q, 40)
    assert exact is None
    ref_vals, ref_rows = engine.topk(corpus, q, 40)
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(vals, ref_vals)


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
def test_topk_with_rescore_on_the_mirror(precision):
    """With a mirror, ``topk_with_rescore`` returns the prescore's rows,
    their exact f32 scores and the boundary prescore in every column."""
    corpus, m, q = _corpus(precision, mirror=True)
    engine = RetrievalEngine(device="cpu", precision=precision)
    vals, rows, exact = engine.topk_with_rescore(corpus, q, 40)
    ref_vals, ref_rows = engine.topk(corpus, q, 40)
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(vals, np.broadcast_to(ref_vals[:, -1:], vals.shape))
    host = np.stack([m[corpus.host_row_map[r] if corpus.host_row_map is not None else r] @ qi
                     for r, qi in zip(rows, q)])
    np.testing.assert_allclose(exact, host, rtol=0, atol=2e-6)


@pytest.mark.parametrize("precision", ["auto", "int8", "bf16", "f32"])
def test_host_engine_builds_no_mirror(precision):
    """``device_rescore='host'`` resolves ``precision='auto'`` as the
    reference does and packs no device mirror, for f32 either."""
    ref = jindex.RetrievalEngine(precision=precision, device_rescore="host")
    got = RetrievalEngine(device="cpu", precision=precision, device_rescore="host")
    assert got.precision == ref.precision
    rng = np.random.default_rng(5)
    m = rng.standard_normal((300, DIM)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    corpus = got._pack(m, np.arange(1, 301, dtype=np.int64), 1)
    assert corpus.dev_rescore is None and corpus.host_f32 is not None
