"""The port's host route (``RetrievalEngine.host_route`` /
``host_topk_exact`` / the native two-pass) against ``svs_tpu`` on the CPU.

Both packages open one SQLite file written from a numpy seed.  The
dispatch rule is the port's own (the host while the pack uploads and under
``force``; with the pack on the card ``auto`` takes the device, where
``svs_tpu`` also weighs a host-scan estimate against a round-trip floor);
its exactness preconditions are the reference's; host and device routes
agree; the host answers are the reference's bits (ids and scores) on the
same file, through the full scan and the two-pass; after an incremental
delete the port's host route stays exact and never returns a deleted doc
(``svs_tpu`` raises there); ``warmup(routes=)`` never touches the shared
dispatch on either facade.  No test asserts on wall-clock time."""

import asyncio
import dataclasses
import math
import threading

import numpy as np
import pytest

import svs_tpu
from svs_tpu.engine import RetrievalEngine as JaxEngine
from svs_tpu.store import Database as JaxDatabase
from svs_tpu_torch import KB, AsyncKB
from svs_tpu_torch import native
from svs_tpu_torch.engine import RetrievalEngine
from svs_tpu_torch.store.blob import embedding_to_bytes
from svs_tpu_torch.store.db import Database
from tests.kb_helpers import make_angle_embedder, make_onehot_embedder

needs_native = pytest.mark.skipif(
    not native.native_available(), reason="no C++ toolchain for the native library"
)


def _build(db_path, n_docs=40, **kw):
    kb = KB(db_path, make_angle_embedder(), force_fresh_db=True, device="cpu", **kw)
    with kb.bulk_add_docs() as add:
        for i in range(n_docs):
            add(f"angle:{(i * 11) % 360}")
    return kb


def _write_store(path, m):
    db = Database(path)
    with db.transaction() as tx:
        tx.add_docs_bulk([f"d{i}" for i in range(len(m))],
                         [embedding_to_bytes(v) for v in m])
        tx.bump_matrix_version()
    db.close()


def _engines(path, precision="int8"):
    """The JAX engine and the port's, each packed from ``path``."""
    jdb, tdb = JaxDatabase(path), Database(path)
    ref, got = JaxEngine(precision=precision), RetrievalEngine(
        precision=precision, device="cpu"
    )
    return jdb, tdb, ref, got, ref.ensure_fresh(jdb), got.ensure_fresh(tdb)


# -- the dispatch rule --------------------------------------------------------


def _uploading(corpus):
    """``corpus`` as it stands while its pack is still uploading."""
    return dataclasses.replace(corpus, _device_ready=threading.Event())


@pytest.mark.parametrize("dispatch, state, want", [
    ("auto", "on_card", False),
    ("auto", "uploading", True),
    ("force", "on_card", True),
    ("force", "uploading", True),
    ("off", "on_card", False),
    ("off", "uploading", False),
    ("auto", "empty", False),
])
def test_host_route_decision_rule(db_path, dispatch, state, want):
    """One case per row of the rule: ``off`` never; the host while the
    pack uploads and under ``force``; ``auto`` with the pack on the card
    the device, at every batch size; never an empty corpus."""
    kb = _build(db_path)
    try:
        eng = kb.engine
        corpus = kb._ensure_engine_fresh()
        assert corpus.host_f32 is not None and corpus.device_ready
        if state == "uploading":
            corpus = _uploading(corpus)
            assert not corpus.device_ready
        elif state == "empty":
            corpus = dataclasses.replace(corpus, n_valid=0)
        eng.host_dispatch = dispatch
        assert eng.host_route(corpus) is want
        if want:
            return
        # the device route answers the call, at every batch size
        for b in (1, 4, 64, 256, 1024):
            kb.retrieve_batch([f"angle:{i}" for i in range(b)], 3)
        assert "host_search" not in kb.stats()
    finally:
        kb.close()


@pytest.mark.parametrize("value, want", [
    ("auto", "auto"), ("off", "off"), ("force", "force"), ("sometimes", "auto"),
])
def test_host_dispatch_env(monkeypatch, value, want):
    monkeypatch.setenv("SVS_TPU_HOST_DISPATCH", value)
    assert RetrievalEngine(device="cpu").host_dispatch == want
    assert JaxEngine().host_dispatch == want


def test_host_route_requires_exactness_machinery(db_path):
    kb = KB(db_path, make_angle_embedder(), force_fresh_db=True, device="cpu",
            rescore=False, precision="f32")
    try:
        with kb.bulk_add_docs() as add:
            for i in range(8):
                add(f"angle:{i * 13}")
        corpus = kb._ensure_engine_fresh()
        for dispatch in ("auto", "force"):
            kb.engine.host_dispatch = dispatch
            assert not kb.engine.host_route(corpus)
            assert not kb.engine.host_route(_uploading(corpus))
        # no host rows: nothing to answer from
        no_cache = dataclasses.replace(corpus, host_cache=None)
        kb.engine.rescore = True
        assert not kb.engine.host_route(no_cache)
        assert not kb.engine.host_route(_uploading(no_cache))
    finally:
        kb.close()


# -- result parity ------------------------------------------------------------


@pytest.mark.parametrize("precision", ["auto", "bf16", "f32"])
def test_host_and_device_routes_agree(db_path, precision):
    texts = [f"angle:{(i * 7) % 360}" for i in range(60)]
    kb = KB(db_path, make_angle_embedder(), force_fresh_db=True, device="cpu",
            precision=precision)
    try:
        with kb.bulk_add_docs() as add:
            for t in texts:
                add(t)
        queries = ["angle:3", "angle:181", "angle:90"]
        kb.engine.host_dispatch = "off"
        dev_hits = [kb.retrieve(q, 7) for q in queries]
        kb.engine.host_dispatch = "force"
        host_hits = [kb.retrieve(q, 7) for q in queries]
        stats = kb.stats()
    finally:
        kb.close()
    assert stats["host_search"]["count"] == len(queries)
    for dh, hh in zip(dev_hits, host_hits):
        assert [h["doc"]["id"] for h in dh] == [h["doc"]["id"] for h in hh]
        np.testing.assert_allclose(
            [h["score"] for h in dh], [h["score"] for h in hh], rtol=0, atol=1e-6
        )


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("n_docs", [300, 17_000])
def test_host_topk_exact_bits_match_svs_tpu(tmp_path, rng, precision, n_docs):
    """Both engines on one file (17,000 rows: the permuted pack and its
    row map) give the same ids and the same score bits, solo and batched."""
    path = tmp_path / "same.sqlite"
    d = 24 if n_docs < 1000 else 12
    m = rng.standard_normal((n_docs, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    _write_store(path, m)
    jdb, tdb, ref, got, rc, gc = _engines(path, precision)
    try:
        assert (gc.host_row_map is None) == (n_docs < 16384)
        q = rng.standard_normal((6, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        for batch in (q[:1], q):
            e_ref, s_ref = ref.host_topk_exact(rc, batch, 9)
            e_got, s_got = got.host_topk_exact(gc, batch, 9)
            np.testing.assert_array_equal(e_got, e_ref)
            np.testing.assert_array_equal(s_got, s_ref)
    finally:
        got.shutdown(), ref.shutdown(), jdb.close(), tdb.close()


def test_host_route_tie_rule(db_path):
    """Exactly tied scores break to the larger emb id, as the reference's."""
    kb = KB(db_path, make_onehot_embedder(8), force_fresh_db=True, device="cpu")
    try:
        kb.engine.host_dispatch = "force"
        with kb.bulk_add_docs() as add:
            for _ in range(6):
                add("vec:2")
            for _ in range(4):
                add("vec:5")
        hits = kb.retrieve("vec:2", 8)
        scores = [h["score"] for h in hits]
        assert scores == sorted(scores, reverse=True)
        tied = [h["doc"]["id"] for h in hits if h["score"] > 0.999]
        assert len(tied) == 6 and tied == sorted(tied, reverse=True)
    finally:
        kb.close()


def test_host_route_with_permuted_row_map(db_path):
    kb = _build(db_path, n_docs=30)
    try:
        corpus = kb._ensure_engine_fresh()
        hf = corpus.host_f32
        assert corpus.host_row_map is None
        q = np.asarray([[math.cos(math.radians(45)), math.sin(math.radians(45))]],
                       np.float32)
        emb0, scores0 = kb.engine.host_topk_exact(corpus, q, 6)
        rm = np.random.default_rng(7).permutation(corpus.n_valid).astype(np.int64)
        hf_perm = np.empty_like(hf)
        hf_perm[rm] = hf
        permuted = dataclasses.replace(corpus, host_cache=(hf_perm, rm))
        emb1, scores1 = kb.engine.host_topk_exact(permuted, q, 6)
        np.testing.assert_array_equal(emb0, emb1)
        np.testing.assert_array_equal(scores0, scores1)
    finally:
        kb.close()


async def test_async_host_route_and_stats(tmp_path):
    kb = AsyncKB(tmp_path / "hd.sqlite", make_onehot_embedder(8),
                 force_fresh_db=True, device="cpu")
    kb.engine.host_dispatch = "force"
    async with kb.bulk_add_docs() as add:
        for i in range(12):
            await add(f"vec:{i % 8}")
    hits = await kb.retrieve("vec:3", 4)
    assert hits[0]["score"] == pytest.approx(1.0)
    top_ids = [h["doc"]["id"] for h in hits if h["score"] > 0.999]
    assert top_ids == sorted(top_ids, reverse=True)
    assert kb.stats()["host_search"]["count"] == 1
    await kb.close()


# -- the two-pass -------------------------------------------------------------


def _pair(tmp_path, m, precision="int8"):
    path = tmp_path / "two.sqlite"
    _write_store(path, m)
    return _engines(path, precision)


def _emb_hf(corpus):
    rm = corpus.host_row_map
    if rm is None:
        return corpus.emb_ids
    e = np.full(corpus.host_f32.shape[0], -1, np.int64)
    e[rm] = corpus.emb_ids
    return e


@needs_native
def test_two_pass_equals_full_scan_and_svs_tpu(tmp_path, unit_rows, monkeypatch):
    monkeypatch.setattr(RetrievalEngine, "HOST_TWOPASS_MIN_ROWS", 64)
    monkeypatch.setattr(JaxEngine, "HOST_TWOPASS_MIN_ROWS", 64)
    m = unit_rows(3000, 96)
    jdb, tdb, ref, got, rc, gc = _pair(tmp_path, m)
    try:
        q = unit_rows(3, 96)
        two = got._host_two_pass(gc, gc.host_f32, _emb_hf(gc), None, q, 25)
        assert two is not None, "the two-pass declined"
        want = ref._host_two_pass(rc, rc.host_f32, _emb_hf(rc), q, 25)
        np.testing.assert_array_equal(two[0], want[0])
        np.testing.assert_array_equal(two[1], want[1])
        # the full scan through the public entry (two-pass off): the same
        # ids, and a solo query's bits
        monkeypatch.setattr(RetrievalEngine, "HOST_TWOPASS_MIN_ROWS", 10**9)
        e1, s1 = got.host_topk_exact(gc, q, 25)
        np.testing.assert_array_equal(e1, two[0])
        np.testing.assert_allclose(s1, two[1], atol=1e-6)
        e1s, s1s = got.host_topk_exact(gc, q[:1], 25)
        monkeypatch.setattr(RetrievalEngine, "HOST_TWOPASS_MIN_ROWS", 64)
        e2s, s2s = got.host_topk_exact(gc, q[:1], 25)
        np.testing.assert_array_equal(e1s, e2s)
        np.testing.assert_array_equal(s1s, s2s)
    finally:
        got.shutdown(), ref.shutdown(), jdb.close(), tdb.close()


@needs_native
def test_two_pass_widens_on_adversarial_cluster(tmp_path, monkeypatch, caplog):
    """Thousands of rows inside one int8 step at the candidate boundary:
    the margin fails, the candidates widen, the answer is the f32 scan's
    and ``svs_tpu``'s."""
    import logging

    monkeypatch.setattr(RetrievalEngine, "HOST_TWOPASS_MIN_ROWS", 64)
    monkeypatch.setattr(JaxEngine, "HOST_TWOPASS_MIN_ROWS", 64)
    n, k = 4000, 10
    scores = 0.7 + np.arange(n, dtype=np.float64) * 1e-7
    m = np.zeros((n, 32), dtype=np.float32)
    m[:, 0] = scores
    m[:, 1] = np.sqrt(1.0 - scores**2)
    jdb, tdb, ref, got, rc, gc = _pair(tmp_path, m)
    try:
        q = np.zeros((1, 32), dtype=np.float32)
        q[0, 0] = 1.0
        with caplog.at_level(logging.INFO, logger="svs_tpu_torch.engine.index"):
            emb, s = got.host_topk_exact(gc, q, k)
        assert any("two-pass margin" in r.message for r in caplog.records)
        e_ref, s_ref = ref.host_topk_exact(rc, q, k)
        np.testing.assert_array_equal(emb, e_ref)
        np.testing.assert_array_equal(s, s_ref)
        assert list(emb[0]) == sorted(gc.emb_ids.tolist(), reverse=True)[:k]
    finally:
        got.shutdown(), ref.shutdown(), jdb.close(), tdb.close()


@needs_native
def test_two_pass_respects_row_map(tmp_path, unit_rows, monkeypatch):
    monkeypatch.setattr(RetrievalEngine, "HOST_TWOPASS_MIN_ROWS", 64)
    m = unit_rows(1500, 48)
    jdb, tdb, ref, got, rc, gc = _pair(tmp_path, m)
    try:
        perm = np.random.default_rng(3).permutation(gc.n_valid)
        shuffled = gc.host_f32[np.argsort(perm)].copy()
        object.__setattr__(gc, "host_cache", (shuffled, perm.astype(np.int64)))
        object.__setattr__(gc, "host_i8", None)
        q = unit_rows(1, 48)
        e2, s2 = got.host_topk_exact(gc, q, 15)
        monkeypatch.setattr(RetrievalEngine, "HOST_TWOPASS_MIN_ROWS", 10**9)
        e1, s1 = got.host_topk_exact(gc, q, 15)
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(s1, s2)
    finally:
        got.shutdown(), ref.shutdown(), jdb.close(), tdb.close()


@needs_native
def test_large_cache_builds_int8_in_background(tmp_path, unit_rows, monkeypatch):
    monkeypatch.setattr(RetrievalEngine, "HOST_TWOPASS_MIN_ROWS", 64)
    monkeypatch.setattr(RetrievalEngine, "HOST_I8_SYNC_MAX_BYTES", 0)
    m = unit_rows(1000, 32)
    jdb, tdb, ref, got, rc, gc = _pair(tmp_path, m)
    try:
        q = unit_rows(1, 32)
        e1, s1 = got.host_topk_exact(gc, q, 5)  # the full scan answers
        t = got._host_i8_thread
        assert t is not None
        t.join(30)
        assert gc.host_i8 is not None
        calls = []
        real = got._host_two_pass
        monkeypatch.setattr(
            got, "_host_two_pass",
            lambda *a: calls.append(real(*a)) or calls[-1],
        )
        e2, s2 = got.host_topk_exact(gc, q, 5)
        assert calls and calls[-1] is not None, "the two-pass did not answer"
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(s1, s2)
    finally:
        got.shutdown(), ref.shutdown(), jdb.close(), tdb.close()


# -- after an incremental delete ------------------------------------------------


@pytest.mark.parametrize("two_pass", [False, True])
def test_host_route_after_incremental_delete(db_path, rng, monkeypatch, two_pass):
    """A delete re-points the host row map and leaves the dropped rows in
    the cache: the host route scores them -inf, returns no deleted doc, and
    equals the device route."""
    if two_pass and not native.native_available():
        pytest.skip("no C++ toolchain for the native library")
    monkeypatch.setattr(
        RetrievalEngine, "HOST_TWOPASS_MIN_ROWS", 64 if two_pass else 10**9
    )
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    table = {f"v{i}": vecs[i] for i in range(600)}
    queries = rng.standard_normal((3, 16)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    table.update({f"q{i}": queries[i] for i in range(3)})

    async def embed(texts):
        return [table[t].tolist() for t in texts]

    kb = KB(db_path, embed, force_fresh_db=True, device="cpu")
    try:
        with kb.bulk_add_docs() as add:
            ids = [add(f"v{i}") for i in range(600)]
        kb.retrieve("q0", 5)
        # delete the docs nearest to each query: the dropped rows would win
        near = np.argsort(-(vecs @ queries.T), axis=0)[:4].ravel()
        gone = {ids[i] for i in near}
        with kb.bulk_del_docs() as delete:
            for doc in gone:
                delete(doc)
        kb.engine.host_dispatch = "off"
        dev = kb.retrieve_batch(["q0", "q1", "q2"], 10)
        assert kb.engine.pack_events["delete"] == 1
        corpus = kb.engine.corpus
        assert len(corpus.host_row_map) < corpus.host_f32.shape[0]
        kb.engine.host_dispatch = "force"
        for solo in (False, True):
            host = (
                [kb.retrieve(f"q{i}", 10) for i in range(3)]
                if solo else kb.retrieve_batch(["q0", "q1", "q2"], 10)
            )
            for dh, hh in zip(dev, host):
                assert not gone & {h["doc"]["id"] for h in hh}
                assert [h["doc"]["id"] for h in hh] == [h["doc"]["id"] for h in dh]
                np.testing.assert_allclose(
                    [h["score"] for h in hh], [h["score"] for h in dh], atol=1e-6
                )
        live = np.array([i for i in range(600) if ids[i] not in gone])
        for qi, hh in enumerate(host):
            s = vecs[live] @ queries[qi]
            want = [ids[live[j]] for j in np.argsort(-s, kind="stable")[:10]]
            assert [h["doc"]["id"] for h in hh] == want
    finally:
        kb.close()


# -- warmup(routes=) ------------------------------------------------------------


class _DispatchWatch:
    """Records every write of ``engine.host_dispatch`` (warmup must make
    none: the attribute is shared with concurrent live calls)."""

    def __init__(self, eng):
        self.writes = []
        cls = type(eng)
        watch = self

        class Watched(cls):
            def __setattr__(self, name, value):
                if name == "host_dispatch":
                    watch.writes.append(value)
                super().__setattr__(name, value)

        eng.__class__ = Watched


def _count_device_searches(eng, monkeypatch):
    calls = []  # one per device search (its widen loop starts there)
    real = eng.initial_candidates
    monkeypatch.setattr(
        eng, "initial_candidates", lambda *a: calls.append(1) or real(*a)
    )
    return calls


@pytest.mark.parametrize("routes", ["both", "live"])
def test_kb_warmup_routes(db_path, monkeypatch, routes):
    """Both ``routes`` values warm the live route, the device with the pack
    on the card, and never write ``engine.host_dispatch``."""
    kb = _build(db_path)
    try:
        eng = kb.engine
        eng.host_dispatch = "auto"
        kb._ensure_engine_fresh()
        calls = _count_device_searches(eng, monkeypatch)
        watch = _DispatchWatch(eng)
        kb.warmup((1, 2), n=3, rounds=2, routes=routes)
        assert watch.writes == []
        assert "host_search" not in kb.stats()
        assert len(calls) == 4 and kb.stats()["warmup"]["count"] == 4
        assert eng.host_dispatch == "auto"
    finally:
        kb.close()


def test_kb_warmup_force_warms_no_device_route(db_path, monkeypatch):
    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "force"
        calls = _count_device_searches(kb.engine, monkeypatch)
        kb.warmup((1,), n=3, rounds=1)
        assert not calls and kb.stats()["host_search"]["count"] == 1
    finally:
        kb.close()


@pytest.mark.parametrize("routes", ["both", "live"])
def test_async_kb_warmup_routes(tmp_path, monkeypatch, routes):
    async def run():
        kb = AsyncKB(tmp_path / "w.sqlite", make_angle_embedder(),
                     force_fresh_db=True, device="cpu")
        try:
            async with kb.bulk_add_docs() as add:
                for i in range(40):
                    await add(f"angle:{(i * 11) % 360}")
            eng = kb.engine
            eng.host_dispatch = "auto"
            calls = _count_device_searches(eng, monkeypatch)
            watch = _DispatchWatch(eng)
            await kb.warmup((4,), n=3, rounds=1, routes=routes)
            assert watch.writes == []
            assert "host_search" not in kb.stats()
            assert len(calls) == 1
        finally:
            await kb.close()

    asyncio.run(run())


def test_warmup_routes_match_svs_tpu(tmp_path):
    """The same ``warmup`` on both packages, held to the deliberate
    difference between them: where ``svs_tpu``'s rule sends a warm
    pack's small batches to the host (a host scan estimated below a slow
    device round trip) and ``routes='both'`` adds one device search per
    batch size under a toggled ``host_dispatch``, the port's ``auto``
    takes the device for every search and leaves the dispatch alone."""
    counts = []
    for pkg in (svs_tpu, None):
        path = tmp_path / f"r{len(counts)}.sqlite"
        kw = {} if pkg is not None else {"device": "cpu"}
        kb = (pkg.KB if pkg is not None else KB)(
            path, make_angle_embedder(), force_fresh_db=True, **kw
        )
        try:
            with kb.bulk_add_docs() as add:
                for i in range(40):
                    add(f"angle:{(i * 11) % 360}")
            eng = kb.engine
            eng.host_dispatch = "auto"
            if pkg is not None:
                # the reference's estimates: a 10 s round trip, so the host wins
                eng._rpc_floor, eng._rpc_floor_t = 10.0, float("inf")
                eng._host_bw_t = float("inf")
            kb.warmup((1, 3), n=4, rounds=2)
            st = kb.stats()
            counts.append((st.get("host_search", {}).get("count", 0),
                           st["warmup"]["count"], eng.host_dispatch))
        finally:
            kb.close()
    assert counts[0] == (4, 6, "auto")  # svs_tpu: 4 host searches + 2 device
    assert counts[1] == (0, 4, "auto")  # the port: 4 device searches


def test_unaligned_mapped_cache_scans_in_aligned_blocks(tmp_path, rng, monkeypatch):
    """A sidecar's f32 section is mapped at an unaligned offset; the host
    scan copies it block by block (BLAS skips unaligned arrays) and gives
    the answers of the aligned rows."""
    import svs_tpu_torch.engine.index as index_mod

    monkeypatch.setattr(index_mod, "_UNALIGNED_CHUNK_BYTES", 1000 * 24 * 4)
    m = rng.standard_normal((2600, 24)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    path = tmp_path / "x.sqlite"
    _write_store(path, m)
    tdb = Database(path)
    eng = RetrievalEngine(precision="int8", device="cpu")
    try:
        corpus = eng.ensure_fresh(tdb)
        raw = tmp_path / "rows.bin"
        with open(raw, "wb") as f:
            f.write(b"xyz")
            f.write(np.ascontiguousarray(corpus.host_f32).tobytes())
        mapped = np.memmap(raw, dtype="<f4", mode="r", offset=3,
                           shape=corpus.host_f32.shape)
        assert not mapped.flags.aligned
        unaligned = dataclasses.replace(
            corpus, host_cache=(mapped, corpus.host_row_map)
        )
        q = rng.standard_normal((5, 24)).astype(np.float32)
        for batch in (q[:1], q):
            want = eng.host_topk_exact(corpus, batch, 7)
            got = eng.host_topk_exact(unaligned, batch, 7)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
        s_aligned = index_mod._host_scores(corpus.host_f32, q[:1])
        np.testing.assert_array_equal(index_mod._host_scores(mapped, q[:1]), s_aligned)
        del mapped, unaligned
    finally:
        eng.shutdown()
        tdb.close()
