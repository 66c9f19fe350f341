"""The PyTorch port's pairwise slice as a whole, against the JAX package on
the CPU: ``svs_tpu.KB`` and ``svs_tpu_torch.KB(device='cpu')`` open the
same SQLite store and must return the same top document pairs, in the same
order except near-ties, with scores within 1e-6 — on the exact blocked
route and on the keyed route, for every storage precision, with
``rescore=False``, a margin widen with its width hint, and the SQLite
rescore of a corpus without a mirror.  The engine's pairwise bound,
dispatch, hint and pair rescore are held to the reference's on one pack."""

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
from svs_tpu_torch.store.tx import Tx
from svs_tpu_torch.utils.topk_np import top_pairs_numpy

torch.set_num_threads(2)

#: Rescored f32 dots are summed in another order by XLA and by torch: pairs
#: whose scores lie closer than this may trade places; scores agree within
#: it.
NEAR_TIE = 1e-6


def _unit(m):
    return (m / np.linalg.norm(m, axis=1, keepdims=True)).astype(np.float32)


def _store(path, matrix):
    """A store written by ``svs_tpu.KB``: doc ``i`` (text ``doc i``) holds
    row ``i`` of ``matrix``.  Returns the embedding function both KBs use."""

    async def embed(texts):
        return [matrix[int(t.split()[1])].tolist() for t in texts]

    kb = svs_tpu.KB(path, embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(len(matrix)):
            add(f"doc {i}")
    kb.close()
    return embed


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    """600 docs at d = 32: a 768-row pack, off the keyed route's 4096
    alignment, so every precision takes the exact blocked pass."""
    m = _unit(np.random.default_rng(31).standard_normal((600, 32)))
    path = tmp_path_factory.mktemp("small") / "store.sqlite"
    return path, _store(path, m), m


@pytest.fixture(scope="module")
def keyed_store(tmp_path_factory):
    """4000 docs at d = 64 with 100 planted near-duplicate pairs (doc j and
    doc 2000 + j at cos 0.9997-0.9999): a 4096-row pack on the keyed
    route, and top pairs dense enough that the margin fails at the first
    width for f32 storage."""
    rng = np.random.default_rng(32)
    m = _unit(rng.standard_normal((4000, 64)))
    cos = np.linspace(0.9997, 0.9999, 100)
    w = rng.standard_normal((100, 64))
    w -= (w * m[:100]).sum(axis=1, keepdims=True) * m[:100]
    w = _unit(w)
    m[2000:2100] = _unit(cos[:, None] * m[:100] + np.sqrt(1 - cos**2)[:, None] * w)
    path = tmp_path_factory.mktemp("keyed") / "store.sqlite"
    return path, _store(path, m), m


def _pairs(results):
    """``([(row, row)], scores)``: doc ``i`` holds matrix row ``i``."""

    def row(doc):
        return int(doc["text"].split()[1])

    return [(row(a), row(b)) for _, a, b in results], np.asarray(
        [s for s, _, _ in results]
    )


def _assert_same_pairs(ref, got):
    """Same doc pairs in the same order, except two pairs whose scores lie
    within NEAR_TIE may trade places; scores within NEAR_TIE."""
    rp, rs = _pairs(ref)
    gp, gs = _pairs(got)
    assert len(gp) == len(rp)
    np.testing.assert_allclose(gs, rs, rtol=0, atol=NEAR_TIE)
    for j, (a, b) in enumerate(zip(rp, gp)):
        if a != b:
            assert np.min(np.abs(np.delete(rs, j) - rs[j])) < NEAR_TIE, (j, a, b)


def _both(store, n, monkeypatch, keyed=None, **kw):
    """``document_top_pairwise_scores(n)`` through both KBs with the same
    options; ``keyed`` asserts which route the port's engine took."""
    path, embed, _ = store
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
    ref_kb = svs_tpu.KB(path, embed, **kw)
    try:
        ref = ref_kb.document_top_pairwise_scores(n)
    finally:
        ref_kb.close()
    kb = svs_tpu_torch.KB(path, embed, device="cpu", **kw)
    try:
        got = kb.document_top_pairwise_scores(n)
        engine = kb.engine
    finally:
        kb.close()
    if keyed is not None:
        assert all(c == ("keyed", True) for c in calls) == keyed, calls
        assert calls
    return ref, got, engine


@pytest.mark.parametrize(
    "kw",
    [{}, {"precision": "bf16"}, {"precision": "f32"}, {"rescore": False}],
    ids=["int8", "bf16", "f32", "rescore_off"],
)
def test_exact_route_matches_jax_kb(small_store, kw, monkeypatch):
    ref, got, engine = _both(small_store, 40, monkeypatch, keyed=False, **kw)
    rescore = kw.get("rescore", True)
    assert engine.precision == kw.get("precision", "int8" if rescore else "bf16")
    _assert_same_pairs(ref, got)
    # and the brute-force f32 top pairs (prescores under rescore=False)
    oracle = top_pairs_numpy(small_store[2] @ small_store[2].T, 40)
    pairs, scores = _pairs(got)
    tol = NEAR_TIE if rescore else 2.0**-8  # raw bf16 prescores
    np.testing.assert_allclose(scores, [v for v, _, _ in oracle], rtol=0, atol=tol)
    if rescore:
        assert pairs == [(r, c) for _, r, c in oracle]


@pytest.mark.parametrize(
    "kw", [{}, {"precision": "bf16"}], ids=["int8", "bf16"]
)
def test_keyed_route_matches_jax_kb(keyed_store, kw, monkeypatch):
    ref, got, _ = _both(keyed_store, 20, monkeypatch, keyed=True, **kw)
    _assert_same_pairs(ref, got)


def test_keyed_widen_and_hint_match_jax_kb(keyed_store, monkeypatch):
    """f32 storage, n = 10: the planted pairs are so dense that the margin
    fails at the first width (74) and passes after one 4x widen (296); the
    hint then starts the next call at 296.  Both KBs agree on the pairs
    and on the hint."""
    path, embed, _ = keyed_store
    ref_kb = svs_tpu.KB(path, embed, precision="f32")
    kb = svs_tpu_torch.KB(path, embed, device="cpu", precision="f32")
    try:
        for call in range(2):
            ref = ref_kb.document_top_pairwise_scores(10)
            got = kb.document_top_pairwise_scores(10)
            _assert_same_pairs(ref, got)
            assert kb.engine._pair_hint == ref_kb.engine._pair_hint
        assert kb.engine._pair_hint == {10: (296, 1)}
        assert kb.engine.widen_retries == 1
        assert kb.engine.initial_pairwise_candidates(10, 4000) == 296
    finally:
        ref_kb.close()
        kb.close()


def test_sqlite_rescore_without_mirror_matches_jax_kb(small_store, monkeypatch):
    """``SVS_TPU_DEVICE_RESCORE_MAX_BYTES=0`` and
    ``SVS_TPU_RESCORE_CACHE_MAX_BYTES=0``: the corpus has no device mirror
    and keeps no host f32 rows, so the rescore reads the stored vectors
    from SQLite."""
    monkeypatch.setenv("SVS_TPU_DEVICE_RESCORE_MAX_BYTES", "0")
    monkeypatch.setenv("SVS_TPU_RESCORE_CACHE_MAX_BYTES", "0")
    fetched = []
    real = Tx.fetch_embedding_rows

    def spy(self, emb_ids):
        fetched.append(len(emb_ids))
        return real(self, emb_ids)

    monkeypatch.setattr(Tx, "fetch_embedding_rows", spy)
    ref, got, _ = _both(small_store, 40, monkeypatch)
    assert fetched
    _assert_same_pairs(ref, got)


def test_where_and_n0_match_jax_kb(small_store):
    """``where=`` and ``n=0`` through both KBs: no pairs for n = 0 (with or
    without a filter) nor for a filter no document passes (these docs have
    no meta); the empty dict matches every document."""
    path, embed, _ = small_store
    out = []
    for pkg, kw in ((svs_tpu, {}), (svs_tpu_torch, {"device": "cpu"})):
        kb = pkg.KB(path, embed, **kw)
        try:
            assert kb.document_top_pairwise_scores(0) == []
            assert kb.document_top_pairwise_scores(0, where={"a": 1}) == []
            assert kb.document_top_pairwise_scores(5, where={"a": 1}) == []
            assert kb.document_top_pairwise_scores(5, where=lambda d: False) == []
            every = kb.document_top_pairwise_scores(5, where={})
            assert every == kb.document_top_pairwise_scores(5)
            out.append(every)
        finally:
            kb.close()
    _assert_same_pairs(*out)


def test_16384_doc_store_takes_the_keyed_route(tmp_path, monkeypatch):
    """Exactly 16,384 docs at d = 16 (f32 storage): a 16,384-row permuted
    pack, 4096-aligned, so the keyed route runs and comes back ok, and
    the margin clears at the first width."""
    m = _unit(np.random.default_rng(33).standard_normal((16384, 16)))
    path = tmp_path / "store.sqlite"
    store = (path, _store(path, m), m)
    ref, got, engine = _both(store, 10, monkeypatch, keyed=True, precision="f32")
    assert engine.widen_retries == 0
    _assert_same_pairs(ref, got)


# --- engine level ---------------------------------------------------------------


def _packs(m, precision, row_multiple):
    ids = np.arange(1, len(m) + 1, dtype=np.int64) * 3
    data, scales, emb, cache, row_map, n_valid, dim = j_pack_host(
        m, ids, precision, row_multiple=row_multiple
    )
    jcorpus = j_pack_corpus(m, ids, 1, precision, row_multiple=row_multiple)
    corpus = packed_from_numpy(
        data, scales, emb, n_valid, dim, 1, precision,
        float(scales[:n_valid].max()) if scales is not None else 0.0,
        cache, row_map, "cpu",
    )
    return jcorpus, corpus


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"precision": "bf16"},
        {"precision": "f32"},
        {"rescore": False},
        {"kernel": "xla"},
        {"precision": "f32", "kernel": "pallas"},
        {"precision": "int8", "kernel": "xla"},
    ],
    ids=["int8", "bf16", "f32", "rescore_off", "xla", "pallas", "int8_xla"],
)
@pytest.mark.parametrize("n_docs", [600, 4000, 16384])
def test_engine_pairwise_bound_and_dispatch_match_jax(kw, n_docs):
    ref = jindex.RetrievalEngine(**kw)
    got = RetrievalEngine(device="cpu", **kw)
    m = _unit(np.random.default_rng(34).standard_normal((n_docs, 24)))
    row_multiple = 16384 if n_docs >= 16384 else 256
    jcorpus, corpus = _packs(m, got.precision, row_multiple)
    assert corpus.n_padded == int(jcorpus.data.shape[0])
    assert got._keyed_pairwise_possible(corpus) == ref._keyed_pairwise_possible(jcorpus)
    assert got.pairwise_eps(corpus) == ref.pairwise_eps(jcorpus)
    assert got.pairwise_candidate_base(10) == ref.pairwise_candidate_base(10)


def test_engine_pairwise_hint_matches_jax():
    """The pair ladder's hint: widened outcomes pin it, first-try
    successes count a streak and step down one rung after
    ``HINT_PROBE_STREAK``."""
    ref = jindex.RetrievalEngine()
    got = RetrievalEngine(device="cpu")
    events = [(10, 296, True), (10, 296, False), (20, 84, False), (10, 1184, True)]
    events += [(10, 1184, False)] * (got.HINT_PROBE_STREAK + 1)
    for k, c, widened in events:
        ref.record_pairwise_candidates(k, c, widened)
        got.record_pairwise_candidates(k, c, widened)
        assert got._pair_hint == ref._pair_hint
        for n_valid in (5, 100, 4000):
            assert got.initial_pairwise_candidates(k, n_valid) == (
                ref.initial_pairwise_candidates(k, n_valid)
            )


@pytest.mark.parametrize("precision", ["int8", "f32"])
def test_engine_pairwise_rescore_matches_jax(precision):
    """Exact f32 pair scores from the device mirror (a separate f32 mirror
    through the pack-row map for int8; the padded pack itself for f32)."""
    m = _unit(np.random.default_rng(35).standard_normal((16384 + 300, 24)))
    jcorpus, corpus = _packs(m, precision, 16384)
    ref = jindex.RetrievalEngine(precision=precision)
    got = RetrievalEngine(device="cpu", precision=precision)
    rng = np.random.default_rng(36)
    ra = rng.integers(0, len(m), 3000)
    rb = rng.integers(0, len(m), 3000)
    want = ref.pairwise_rescore(jcorpus, ra, rb)
    out = got.pairwise_rescore(corpus, ra, rb)
    assert out.dtype == np.float32 and out.shape == (3000,)
    np.testing.assert_allclose(out, want, rtol=0, atol=3e-5)
    host = corpus.host_f32 if corpus.host_row_map is None else corpus.host_f32[corpus.host_row_map]
    np.testing.assert_allclose(out, (host[ra] * host[rb]).sum(axis=1), rtol=0, atol=1e-6)
    assert got.pairwise_rescore(corpus, ra[:0], rb[:0]).shape == (0,)
