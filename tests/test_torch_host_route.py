"""The port's host route (``RetrievalEngine.host_route`` /
``host_topk_exact`` / the native two-pass) against ``svs_tpu`` on the CPU.

Both packages open one SQLite file written from a numpy seed.  The
dispatch rule, its exactness preconditions and the score-matrix guard are
the reference's; host and device routes agree; the host answers are the
reference's bits (ids and scores) on the same file, through the full scan
and the two-pass; after an incremental delete the port's host route stays
exact and never returns a deleted doc (``svs_tpu`` raises there);
``warmup(routes=)`` warms the device route on both facades; the
round-trip floor's re-probe schedule runs on injected measurements, and
no test asserts on wall-clock time."""

import asyncio
import dataclasses
import math

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


def test_host_route_decision_rule(db_path):
    kb = _build(db_path)
    try:
        eng = kb.engine
        corpus = kb._ensure_engine_fresh()
        assert corpus.host_f32 is not None
        eng._rpc_floor, eng._rpc_floor_t = 0.030, float("inf")
        eng._host_scan_bw = 1e9
        eng.host_dispatch = "auto"
        assert eng.host_route(corpus, 1)
        assert eng.host_route(corpus, 4)
        eng._rpc_floor = 1e-9
        assert not eng.host_route(corpus, 1)
        eng._rpc_floor = 0.030
        eng.host_dispatch = "off"
        assert not eng.host_route(corpus, 1)
        eng.host_dispatch = "force"
        eng._rpc_floor = 1e-9
        assert eng.host_route(corpus, 1)
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
        kb.engine._rpc_floor, kb.engine._rpc_floor_t = 10.0, float("inf")
        kb.engine.host_dispatch = "auto"
        assert not kb.engine.host_route(corpus, 1)
        kb.engine.host_dispatch = "force"
        assert not kb.engine.host_route(corpus, 1)
        # no host rows: nothing to answer from
        no_cache = dataclasses.replace(corpus, host_cache=None)
        kb.engine.rescore = True
        assert not kb.engine.host_route(no_cache, 1)
    finally:
        kb.close()


def test_host_route_declines_large_score_matrix(db_path):
    kb = _build(db_path, n_docs=16)
    try:
        corpus = kb._ensure_engine_fresh()
        kb.engine._rpc_floor, kb.engine._rpc_floor_t = 10.0, float("inf")
        kb.engine.host_dispatch = "auto"
        huge_batch = (256 * 1024 * 1024) // (corpus.n_valid * 4) + 1
        assert not kb.engine.host_route(corpus, huge_batch)
        assert kb.engine.host_route(corpus, 1)
    finally:
        kb.close()


def test_measured_scan_corrects_a_wrong_prior(db_path):
    """One host scan moves the bandwidth EWMA toward the machine, and the
    rule flips with it."""
    kb = _build(db_path)
    try:
        eng = kb.engine
        corpus = kb._ensure_engine_fresh()
        eng._host_scan_bw = 1.0  # 1 byte/s
        eng._host_bw_t = float("inf")  # fresh: no background probe
        eng._rpc_floor, eng._rpc_floor_t = 50e-6, float("inf")
        eng.host_dispatch = "auto"
        assert not eng.host_route(corpus, 1)
        eng.host_topk_exact(corpus, np.asarray([[1.0, 0.0]], np.float32), 5)
        assert eng._host_scan_bw > 1e3
    finally:
        kb.close()


def test_stale_bandwidth_probe_refreshes(db_path):
    kb = _build(db_path)
    try:
        eng = kb.engine
        corpus = kb._ensure_engine_fresh()
        eng._host_scan_bw = 1e3
        eng._host_bw_t = 0.0  # stale
        eng.host_dispatch = "auto"
        eng._rpc_floor, eng._rpc_floor_t = 0.001, float("inf")
        eng.host_route(corpus, 1)
        t = eng._host_bw_thread
        assert t is not None, "a stale estimate spawned no probe"
        t.join(30)
        assert eng._host_scan_bw > 1e3
        eng._host_bw_thread = None
        eng.host_route(corpus, 1)
        assert eng._host_bw_thread is None  # fresh now: no second probe
    finally:
        kb.close()


# -- the round-trip floor -----------------------------------------------------


def test_rpc_floor_reprobe_schedule_with_injected_measurements(monkeypatch):
    eng = RetrievalEngine(device="cpu")
    probes = []

    def fake():
        probes.append(1)
        return 0.002

    monkeypatch.setattr(eng, "_measure_rpc_floor_once", fake)
    assert eng.device_rpc_floor() == 0.002  # first quiet call measures
    assert eng._rpc_probes == 1
    assert eng._rpc_refresh_interval() == eng.RPC_REPROBE_BASE_S
    # fresh: no re-probe
    eng.device_rpc_floor()
    assert eng._rpc_probe_thread is None and len(probes) == 1
    # a bad value converges: the EWMA halves the error per probe
    eng._rpc_floor = 0.2
    for _ in range(8):
        eng._rpc_floor_t = 0.0  # stale
        eng.device_rpc_floor()
        eng._rpc_probe_thread.join(30)
    assert abs(eng._rpc_floor - 0.002) < 0.2 / 2**7
    assert eng._rpc_probes == 9
    assert eng._rpc_refresh_interval() == eng.RPC_REPROBE_MAX_S
    assert eng.dispatch_stats()["rpc_floor_ms"] == pytest.approx(eng._rpc_floor * 1e3)


def test_rpc_floor_waits_for_a_quiet_moment(monkeypatch):
    eng = RetrievalEngine(device="cpu")
    monkeypatch.setattr(eng, "_measure_rpc_floor_once", lambda: 0.001)
    monkeypatch.setenv("SVS_TPU_RPC_FLOOR", "0.5")
    eng._inflight = 1  # a search in flight: the prior, nothing cached
    assert eng.device_rpc_floor() == 0.5
    assert eng._rpc_floor is None
    eng._inflight = 0
    assert eng.device_rpc_floor() == 0.001


def test_rpc_floor_probe_failure_keeps_the_prior(monkeypatch):
    eng = RetrievalEngine(device="cpu")

    def boom():
        raise RuntimeError("device lost")

    monkeypatch.setattr(eng, "_measure_rpc_floor_once", boom)
    assert eng.device_rpc_floor() == pytest.approx(0.030)
    assert eng._rpc_floor is None


def test_rpc_floor_measures_a_round_trip():
    eng = RetrievalEngine(device="cpu")
    floor = eng._measure_rpc_floor_once()
    assert 0.0 < floor < float("inf")


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
        assert got._host_twopass_bw is not None
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
            lambda *a: calls.append(1) or real(*a),
        )
        e2, s2 = got.host_topk_exact(gc, q, 5)
        assert calls and got._host_twopass_bw is not None
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


@pytest.mark.parametrize("routes, device_calls", [("both", 1), ("live", 0)])
def test_kb_warmup_routes(db_path, monkeypatch, routes, device_calls):
    kb = _build(db_path)
    try:
        eng = kb.engine
        eng.host_dispatch = "auto"
        eng._rpc_floor, eng._rpc_floor_t = 10.0, float("inf")  # host wins
        eng._host_bw_t = float("inf")
        calls = []  # one per device search (its widen loop starts there)
        real = eng.initial_candidates
        monkeypatch.setattr(
            eng, "initial_candidates", lambda *a: calls.append(1) or real(*a)
        )
        kb.warmup((1, 2), n=3, rounds=2, routes=routes)
        assert kb.stats()["host_search"]["count"] == 4
        assert len(calls) == 2 * device_calls
        assert eng.host_dispatch == "auto"
    finally:
        kb.close()


def test_kb_warmup_force_warms_no_device_route(db_path, monkeypatch):
    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "force"
        calls = []
        real = kb.engine.initial_candidates
        monkeypatch.setattr(
            kb.engine, "initial_candidates", lambda *a: calls.append(1) or real(*a)
        )
        kb.warmup((1,), n=3, rounds=1)
        assert not calls and kb.stats()["host_search"]["count"] == 1
    finally:
        kb.close()


@pytest.mark.parametrize("routes, device_calls", [("both", 1), ("live", 0)])
def test_async_kb_warmup_routes(tmp_path, monkeypatch, routes, device_calls):
    async def run():
        kb = AsyncKB(tmp_path / "w.sqlite", make_angle_embedder(),
                     force_fresh_db=True, device="cpu")
        try:
            async with kb.bulk_add_docs() as add:
                for i in range(40):
                    await add(f"angle:{(i * 11) % 360}")
            eng = kb.engine
            eng.host_dispatch = "auto"
            eng._rpc_floor, eng._rpc_floor_t = 10.0, float("inf")
            eng._host_bw_t = float("inf")
            calls = []
            real = eng.initial_candidates
            monkeypatch.setattr(
                eng, "initial_candidates", lambda *a: calls.append(1) or real(*a)
            )
            await kb.warmup((4,), n=3, rounds=1, routes=routes)
            assert kb.stats()["host_search"]["count"] == 1
            assert len(calls) == device_calls
        finally:
            await kb.close()

    asyncio.run(run())


def test_warmup_routes_match_svs_tpu(tmp_path, monkeypatch):
    """The same ``warmup`` on both packages takes the same routes."""
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
            eng._rpc_floor, eng._rpc_floor_t = 10.0, float("inf")
            eng._host_bw_t = float("inf")
            kb.warmup((1, 3), n=4, rounds=2)
            st = kb.stats()
            counts.append((st["host_search"]["count"], st["warmup"]["count"]))
        finally:
            kb.close()
    assert counts[0] == counts[1]


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
