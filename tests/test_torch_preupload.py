"""The port's deferred pack and mirror uploads on the CPU (the
reference's ``tests/test_preupload.py`` and the readiness tests of
``tests/test_dispatch_fresh.py``): a deferred pack publishes at once with
its host arrays, queries answer exactly from the host rows while the
upload is held at a gate, device paths wait for it, the device copies
swap in when it lands, and a failed upload neither hangs nor runs a
search on the host copy of the pack."""

import logging
import threading

import numpy as np
import pytest
import torch

import svs_tpu
from svs_tpu_torch import KB
from svs_tpu_torch.engine import RetrievalEngine
from svs_tpu_torch.store.blob import embedding_to_bytes
from svs_tpu_torch.store.db import Database
from tests.kb_helpers import make_angle_embedder


@pytest.fixture
def gated_upload(monkeypatch):
    """Tiny packs take the deferred path, and every staged upload (pack
    and mirror) waits at a gate the test opens."""
    import svs_tpu_torch.engine.packing as packing

    monkeypatch.setattr(packing, "DEFER_MIN_BYTES", 0)
    gate = threading.Event()
    real = packing.staged_device_put

    def gated(host, device, chunk_bytes=None, throttle=None):
        assert gate.wait(timeout=30), "the test never opened the gate"
        return real(host, device, chunk_bytes=chunk_bytes, throttle=throttle)

    monkeypatch.setattr(packing, "staged_device_put", gated)
    return gate


def _build(db_path, n=40, **kw):
    kb = KB(db_path, make_angle_embedder(), force_fresh_db=True, device="cpu", **kw)
    with kb.bulk_add_docs() as add:
        for i in range(n):
            add(f"angle:{(i * 11) % 360}")
    return kb


def _ids(hits):
    return [h["doc"]["id"] for h in hits]


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
def test_queries_answer_during_upload_then_device_takes_over(
    db_path, gated_upload, precision
):
    kb = _build(db_path, precision=precision)
    try:
        kb.engine.host_dispatch = "auto"
        hits_cold = kb.retrieve("angle:33", 6)
        corpus = kb.engine.corpus
        assert not corpus.device_ready
        assert isinstance(corpus.data, np.ndarray)
        assert kb.engine.pack_uploading
        assert kb.stats()["host_search"]["count"] == 1
        assert corpus.dev_rescore is None  # the mirror follows the pack

        gated_upload.set()
        assert kb.engine.wait_for_mirror(timeout=60)
        assert corpus.device_ready and isinstance(corpus.data, torch.Tensor)
        assert corpus.dev_rescore is not None
        kb.engine._rpc_floor, kb.engine._rpc_floor_t = 0.0, float("inf")
        hits_warm = kb.retrieve("angle:33", 6)
        assert kb.stats()["device_search"]["count"] >= 1
        assert _ids(hits_warm) == _ids(hits_cold)
        np.testing.assert_allclose(
            [h["score"] for h in hits_warm], [h["score"] for h in hits_cold], atol=1e-6
        )
        st = kb.stats()["dispatch"]
        assert st["pack_upload_failures"] == st["mirror_upload_failures"] == 0
    finally:
        gated_upload.set()
        kb.close()


def test_batches_answer_during_upload(db_path, gated_upload):
    """The pre-upload host route takes any batch size (a slabbed scan)."""
    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "auto"
        queries = [f"angle:{a}" for a in (0, 45, 90, 135, 180, 225)]
        res = kb.retrieve_batch(queries, 4)
        assert len(res) == 6 and all(len(r) == 4 for r in res)
        assert not kb.engine.corpus.device_ready
        assert res[2][0]["doc"]["text"] == "angle:88"
    finally:
        gated_upload.set()
        kb.close()


def _blocked_until_gate(gate, call):
    """``call`` on a thread: still running while the gate is shut, done
    after it opens; returns its result."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", call()))
    t.start()
    t.join(timeout=1.0)
    assert t.is_alive(), "a device path ran before the upload landed"
    gate.set()
    t.join(timeout=60)
    assert not t.is_alive()
    return out["r"]


def test_device_route_waits_for_upload(db_path, gated_upload):
    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "off"
        hits = _blocked_until_gate(gated_upload, lambda: kb.retrieve("angle:100", 3))
        assert _ids(hits) == _ids(kb.retrieve("angle:100", 3))
        assert kb.engine.corpus.device_ready
    finally:
        gated_upload.set()
        kb.close()


def test_pairwise_waits_for_upload(db_path, gated_upload):
    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "auto"
        kb.retrieve("angle:1", 2)  # the deferred pack, answered by the host
        assert not kb.engine.corpus.device_ready
        pairs = _blocked_until_gate(
            gated_upload, lambda: kb.document_top_pairwise_scores(5)
        )
        assert len(pairs) == 5
    finally:
        gated_upload.set()
        kb.close()


def test_engine_device_entry_points_wait(tmp_path, rng, gated_upload):
    """``topk``, ``pairwise_topk``, ``subset_pairwise_corpus`` and the
    sidecar writes wait for the pack; none reads the host arrays."""
    path = tmp_path / "e.sqlite"
    m = rng.standard_normal((300, 16)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    db = Database(path)
    with db.transaction() as tx:
        tx.add_docs_bulk(["d"] * 300, [embedding_to_bytes(v) for v in m])
        tx.bump_matrix_version()
    eng = RetrievalEngine(device="cpu")
    try:
        corpus = eng.ensure_fresh(db)
        assert not corpus.device_ready
        calls = {
            "topk": lambda: eng.topk(corpus, m[:2], 5),
            "pairwise": lambda: eng.pairwise_topk(corpus, 5),
            "subset": lambda: eng.subset_pairwise_corpus(
                corpus, np.arange(10), corpus.emb_ids[:10]
            ),
            "sidecar": lambda: eng.write_sidecar(tmp_path / "e.svsx"),
        }
        results = {}
        threads = [
            threading.Thread(target=lambda k=k, f=f: results.setdefault(k, f()))
            for k, f in calls.items()
        ]
        for t in threads:
            t.start()
        for _ in range(400):  # until every call waits on the pack
            if eng._pack_waiters == len(threads):
                break
            threading.Event().wait(0.05)
        assert eng._pack_waiters == len(threads)
        assert all(t.is_alive() for t in threads)
        gated_upload.set()
        for t in threads:
            t.join(timeout=60)
        assert set(results) == set(calls)
        assert isinstance(results["subset"].data, torch.Tensor)
        assert eng._pack_waiters == 0
    finally:
        gated_upload.set()
        eng.shutdown()
        db.close()


def test_superseded_upload_aborts_and_the_newer_pack_uploads(
    tmp_path, rng, gated_upload
):
    """A rescan while a deferred pack still uploads (one embedding
    replaced: the count stays, so neither incremental path applies) gives
    a second deferred pack.  The first upload aborts at its next chunk and
    releases its waiters with the host arrays; the second uploads, so no
    device call on the new pack waits for ever, and nothing is counted as
    a failure."""
    path = tmp_path / "s.sqlite"
    m = rng.standard_normal((300, 16)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    db = Database(path)
    with db.transaction() as tx:
        tx.add_docs_bulk(["d"] * 300, [embedding_to_bytes(v) for v in m])
        tx.bump_matrix_version()
        doc_id = tx._conn.execute("SELECT id FROM docs LIMIT 1 OFFSET 7;").fetchone()[0]
    eng = RetrievalEngine(device="cpu")
    try:
        first = eng.ensure_fresh(db)
        assert not first.device_ready and eng.pack_uploading
        held = eng._pack_thread
        writer = Database(path)  # another connection moves data_version
        with writer.transaction() as tx:
            tx.set_doc_embedding(doc_id, embedding_to_bytes(m[8]))
        writer.close()
        second = eng.ensure_fresh(db)
        assert second is not first and eng.pack_events["scan"] == 2
        assert not second.device_ready
        assert eng._pack_thread is not held  # a thread for the newer pack
        gated_upload.set()
        assert eng.wait_for_mirror(timeout=60)
        assert not held.is_alive()
        assert first.device_ready and isinstance(first.data, np.ndarray)
        assert second.device_ready and isinstance(second.data, torch.Tensor)
        assert second.dev_rescore is not None and first.dev_rescore is None
        scores, _, _ = eng.pairwise_topk(second, 5)
        assert len(scores) == 5
        st = eng.dispatch_stats()
        assert st["pack_upload_failures"] == st["mirror_upload_failures"] == 0
    finally:
        gated_upload.set()
        eng.shutdown()
        db.close()


def test_sidecar_cold_start_answers_during_upload(tmp_path, gated_upload):
    """A sidecar with its f32 sections defers too: a reopened KB answers
    from them while the pack uploads, with the ids a KB of ``svs_tpu``
    gives on the same file."""
    path = tmp_path / "side.sqlite"
    kb = KB(path, make_angle_embedder(), force_fresh_db=True, sidecar=True,
            device="cpu", precision="int8")
    gated_upload.set()  # the build and the publish upload freely
    with kb.bulk_add_docs() as add:
        for i in range(40):
            add(f"angle:{(i * 11) % 360}")
    baseline = kb.retrieve("angle:33", 6)
    kb.close()  # writes the .svsx sidecar
    assert (tmp_path / "side.sqlite.svsx").exists()

    gated_upload.clear()  # hold the reopen's upload
    kb2 = KB(path, make_angle_embedder(), sidecar=True, device="cpu",
             precision="int8")
    try:
        kb2.engine.host_dispatch = "auto"
        hits = kb2.retrieve("angle:33", 6)
        corpus = kb2.engine.corpus
        assert not corpus.device_ready
        assert kb2.engine.pack_events["sidecar"] == 1
        assert _ids(hits) == _ids(baseline)
        gated_upload.set()
        assert kb2.engine.wait_for_mirror(timeout=60)
        assert corpus.device_ready and corpus.dev_rescore is not None
    finally:
        gated_upload.set()
        kb2.close()
    ref = svs_tpu.KB(path, make_angle_embedder())
    try:
        assert _ids(ref.retrieve("angle:33", 6)) == _ids(hits)
    finally:
        ref.close()


def test_failed_upload_neither_hangs_nor_searches_the_host_pack(
    db_path, monkeypatch, caplog
):
    """A permanently failing upload publishes the host arrays (waiters
    are released), counts ``pack_upload_failures``, and every device call
    moves the pack to the device for itself."""
    import svs_tpu_torch.convert as convert
    import svs_tpu_torch.engine.index as index_mod
    import svs_tpu_torch.engine.packing as packing

    monkeypatch.setattr(packing, "DEFER_MIN_BYTES", 0)

    def boom(host, device, chunk_bytes=None, throttle=None):
        raise RuntimeError("link down")

    monkeypatch.setattr(packing, "staged_device_put", boom)
    monkeypatch.setattr(index_mod.time, "sleep", lambda s: None)
    moved = []
    real_upload = convert._upload_data
    monkeypatch.setattr(
        convert, "_upload_data", lambda *a: moved.append(1) or real_upload(*a)
    )
    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "off"  # the device path
        with caplog.at_level(logging.WARNING, logger="svs_tpu_torch.engine.index"):
            hits = kb.retrieve("angle:11", 3)
        assert hits[0]["doc"]["text"] == "angle:11"
        assert kb.engine.wait_for_mirror(timeout=30)
        corpus = kb.engine.corpus
        assert corpus.device_ready and isinstance(corpus.data, np.ndarray)
        assert moved, "the device call did not move the host pack"
        assert any("failed permanently" in r.message for r in caplog.records)
        st = kb.stats()["dispatch"]
        assert st["pack_upload_failures"] == 1
        assert st["mirror_upload_failures"] >= 1  # the mirror uploads fail too
        assert corpus.dev_rescore is None  # the rescore stays on the host
        assert _ids(kb.retrieve("angle:11", 3)) == _ids(hits)
        kb.engine.host_dispatch = "force"
        assert _ids(kb.retrieve("angle:11", 3)) == _ids(hits)
    finally:
        kb.close()


def test_large_mirror_uploads_in_background(db_path, monkeypatch):
    """A mirror past ``_MIRROR_SYNC_MAX_BYTES`` uploads in a thread; the
    rescore reads the host rows until it publishes; a publish onto a
    superseded corpus is dropped."""
    import svs_tpu_torch.engine.index as index_mod
    import svs_tpu_torch.engine.packing as packing

    monkeypatch.setattr(index_mod, "_MIRROR_SYNC_MAX_BYTES", 0)
    gate = threading.Event()
    real = packing.staged_device_put

    def gated(host, device, chunk_bytes=None, throttle=None):
        if host.dtype == np.float32 and host.ndim == 2 and throttle is not None:
            assert gate.wait(timeout=30)
        return real(host, device, chunk_bytes=chunk_bytes, throttle=throttle)

    monkeypatch.setattr(packing, "staged_device_put", gated)
    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "off"
        hits = kb.retrieve("angle:50", 4)
        corpus = kb.engine.corpus
        assert corpus.device_ready and corpus.dev_rescore is None
        assert kb.engine.mirror_uploading
        gate.set()
        assert kb.engine.wait_for_mirror(timeout=60)
        assert corpus.dev_rescore is not None
        assert _ids(kb.retrieve("angle:50", 4)) == _ids(hits)

        # a mirror built for a corpus that is no longer the engine's is
        # dropped at the publish
        import dataclasses

        stale = dataclasses.replace(corpus, dev_rescore=None, dev_emb=None)
        kb.engine._upload_and_publish_mirror(
            stale, stale.host_f32, stale.host_row_map, threading.Event()
        )
        assert stale.dev_rescore is None
        kb.engine._upload_and_publish_mirror(stale, stale.host_f32, stale.host_row_map)
        assert stale.dev_rescore is not None  # the synchronous path publishes
    finally:
        gate.set()
        kb.close()


def test_shutdown_aborts_a_held_upload(db_path, monkeypatch):
    """``shutdown()`` sets the stop event the uploader captured; its
    throttle raises between chunks and the thread ends."""
    import svs_tpu_torch.engine.packing as packing

    monkeypatch.setattr(packing, "DEFER_MIN_BYTES", 0)
    monkeypatch.setattr(packing, "STAGE_CHUNK_BYTES", 64)
    kb = _build(db_path, n=200)
    eng = kb.engine
    eng._inflight = 1  # a query in flight: the throttle holds every chunk
    eng.host_dispatch = "auto"
    kb.retrieve("angle:5", 2)  # the host route; the upload waits
    assert eng.pack_uploading
    t = eng._pack_thread
    eng.shutdown()
    assert not t.is_alive()
    assert eng.corpus.device_ready  # the host arrays were released
    assert eng.dispatch_stats()["pack_upload_failures"] == 0
    eng._inflight = 0
    kb.close()


def test_wait_for_mirror_joins_cache_rebuild_and_builds_mirror(
    tmp_path, unit_rows, monkeypatch
):
    """A sidecar without f32 sections opens with no host cache: the
    background rescan attaches it, and ``wait_for_mirror`` waits for that
    and for the mirror it makes possible."""
    import svs_tpu_torch.engine.index as index_mod

    path = tmp_path / "t.sqlite"
    m = unit_rows(64, 32)
    db = Database(path)
    with db.transaction() as tx:
        tx.add_docs_bulk(["d"] * 64, [embedding_to_bytes(v) for v in m])
        tx.bump_matrix_version()
    eng = RetrievalEngine(precision="bf16", device="cpu")
    eng.ensure_fresh(db)
    side = tmp_path / "t.svsx"
    eng.write_sidecar(side)
    eng.shutdown()
    db.close()
    real_load = index_mod.load_sidecar

    def load_stripped(p, expected_version=None):
        out = real_load(p, expected_version=expected_version)
        if out is None:
            return None
        data, scales, ids, header = out
        header = {k: v for k, v in header.items()
                  if k not in ("_f32_cache", "_f32_row_map")}
        return data, scales, ids, header

    monkeypatch.setattr(index_mod, "load_sidecar", load_stripped)
    db2 = Database(path)
    try:
        eng2 = RetrievalEngine(precision="bf16", device="cpu")
        corpus2 = eng2.ensure_fresh(db2, side)
        assert eng2.pack_events["sidecar"] == 1
        assert eng2.wait_for_mirror(timeout=60)
        assert corpus2.host_f32 is not None
        assert corpus2.dev_rescore is not None
        eng2.shutdown()
    finally:
        db2.close()


def test_wait_for_mirror_spin_cap_reports_not_ready(monkeypatch):
    """Background work that keeps respawning behind the check ends in
    False: never a fall-through True, never a hang."""
    eng = RetrievalEngine(device="cpu")

    class _FakeCorpus:
        device_ready = True

    eng._corpus = _FakeCorpus()  # type: ignore[assignment]
    monkeypatch.setattr(eng, "_maybe_build_device_rescore", lambda corpus: None)

    class Flicker:
        """Dead when joined, alive at the re-check."""

        def __init__(self) -> None:
            self.calls = 0

        def is_alive(self) -> bool:
            self.calls += 1
            return self.calls % 2 == 0

        def join(self, timeout=None) -> None:
            pass

    eng._mirror_thread = Flicker()  # type: ignore[assignment]
    assert eng.wait_for_mirror() is False  # the spin cap
    assert eng._mirror_thread.calls > 8
    eng._mirror_thread = Flicker()  # type: ignore[assignment]
    assert eng.wait_for_mirror(timeout=0.3) is False


def test_throttle_yields_to_queries_but_not_to_pack_waiters(monkeypatch):
    """Between chunks the uploader waits while a query is in flight, at
    most ``max_defer`` (injected clock), and not at all while a thread
    waits on the pack."""
    import svs_tpu_torch.engine.index as index_mod

    eng = RetrievalEngine(device="cpu")
    clock = [100.0]
    monkeypatch.setattr(index_mod.time, "monotonic", lambda: clock[0])

    def sleep(s):
        clock[0] += s

    monkeypatch.setattr(index_mod.time, "sleep", sleep)
    stop = threading.Event()
    eng._inflight = 1
    eng._mirror_throttle(stop, max_defer=5.0)
    assert clock[0] == pytest.approx(105.0, abs=0.06)  # held to its bound
    eng._pack_waiters = 1
    before = clock[0]
    eng._mirror_throttle(stop, max_defer=5.0)
    assert clock[0] == before  # a waiter: no yield
    eng._inflight = eng._pack_waiters = 0
    eng._last_query_t = clock[0]
    eng._mirror_throttle(stop, max_defer=5.0)
    assert clock[0] - before == pytest.approx(0.25, abs=0.06)  # the quiet gap
    stop.set()
    with pytest.raises(index_mod._MirrorUploadAborted):
        eng._mirror_throttle(stop)
