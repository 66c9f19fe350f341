"""The port's replica mode (``svs_tpu_torch.parallel.ReplicaEngine``,
``KB(replicas=...)``) against the JAX package's on the CPU: the cases of
``tests/test_replicas.py``, each run through ``svs_tpu.parallel.
ReplicaEngine`` / ``svs_tpu.KB(replicas=4)`` on JAX's virtual CPU devices
and through the port on ``[torch.device('cpu')] * R`` on the same store.

The contract under test: a replicated result is the single-device
result (the same docs, the same scores, the reference tie order) for
every batch size, including batches smaller than the replica count and
splits that cross a dispatch boundary; and the port's replicated results
are the JAX package's (ids equal, scores within 1e-6, as the other
parity tests hold them)."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import svs_tpu
import svs_tpu_torch
from svs_tpu.parallel import ReplicaEngine as JReplicas
from svs_tpu.store import Database as JDatabase
from svs_tpu.store import embedding_to_bytes
from svs_tpu_torch.engine.index import RetrievalEngine
from svs_tpu_torch.parallel import ReplicaEngine, default_mesh
from svs_tpu_torch.store.db import Database

from kb_helpers import make_onehot_embedder

torch.set_num_threads(2)

NEAR_TIE = 1e-6


def _cpus(n):
    return ["cpu"] * n


def _fill(db_path, vectors):
    """A store written through the JAX package's ``Database`` (doc ``i``
    holds row ``i``); returns both packages' handles on it."""
    db = JDatabase(db_path)
    with db.transaction() as tx:
        for i, v in enumerate(vectors):
            tx.add_doc(f"d{i}", None, None, embedding_to_bytes(list(map(float, v))))
        tx.bump_matrix_version()
    return db, Database(db_path)


def _close(*dbs):
    for db in dbs:
        db.close()


@pytest.mark.parametrize("precision", ["bf16", "f32", "int8"])
def test_replica_topk_matches_single_device_and_jax(db_path, unit_rows, precision):
    """Every fan-out (prescore, rescore, final) returns what one device
    returns, and what the JAX package's replicas return — planted exact
    ties resolving to the larger emb id."""
    m = unit_rows(300, 24)
    m[40:48] = m[40]
    jdb, tdb = _fill(db_path, m)
    jrep = JReplicas(precision=precision, n_replicas=4)
    solo = RetrievalEngine(precision=precision, device="cpu")
    rep = ReplicaEngine(precision=precision, devices=_cpus(4))
    jc, c_solo, c_rep = jrep.ensure_fresh(jdb), solo.ensure_fresh(tdb), rep.ensure_fresh(tdb)
    q = np.concatenate([m[40:41], unit_rows(9, 24)], axis=0)
    n = 7
    c = rep.initial_candidates(n, c_rep.n_valid)
    assert c == jrep.initial_candidates(n, jc.n_valid)
    f_solo, f_rep, f_j = (
        solo.topk_final(c_solo, q, n, c), rep.topk_final(c_rep, q, n, c),
        jrep.topk_final(jc, q, n, c),
    )
    assert (f_solo is None) == (f_rep is None) == (f_j is None)
    if f_rep is not None:
        np.testing.assert_array_equal(f_rep[0], f_solo[0])
        np.testing.assert_array_equal(f_rep[1], f_solo[1])  # the same bits
        np.testing.assert_array_equal(f_rep[0], f_j[0])
        np.testing.assert_allclose(f_rep[1], f_j[1], atol=NEAR_TIE, rtol=0)
        assert f_rep[0].shape == (10, n)
        assert list(f_rep[0][0][:5]) == [48, 47, 46, 45, 44]
    vals_s, rows_s, _ = solo.topk_with_rescore(c_solo, q, c)
    vals_r, rows_r, _ = rep.topk_with_rescore(c_rep, q, c)
    _, rows_j, _ = jrep.topk_with_rescore(jc, q, c)
    assert vals_r.shape == vals_s.shape and rows_r.shape == rows_s.shape
    for b in range(q.shape[0]):
        assert set(rows_r[b].tolist()) == set(rows_s[b].tolist()) == set(rows_j[b].tolist())
    for eng in (jrep, rep):
        eng.shutdown()
    _close(jdb, tdb)


def test_replica_kb_matches_single_kb_and_jax(tmp_path):
    """KB parity: retrieve_batch through 4 replicas equals one device and
    the JAX package's ``KB(replicas=4)``, for batches below, at and above
    the replica count and uneven splits."""
    emb = make_onehot_embedder(dim=64)
    kbs = [
        svs_tpu.KB(tmp_path / "jax.sqlite", emb, force_fresh_db=True, replicas=4),
        svs_tpu_torch.KB(tmp_path / "solo.sqlite", emb, force_fresh_db=True, device="cpu"),
        svs_tpu_torch.KB(tmp_path / "rep.sqlite", emb, force_fresh_db=True, replicas=_cpus(4)),
    ]
    for kb in kbs:
        with kb.bulk_add_docs() as add:
            for i in range(60):
                add(f"vec:{i}")
    try:
        for batch in (1, 3, 4, 7, 20):
            qs = [f"vec:{i}" for i in range(batch)]
            rj, r1, r4 = (kb.retrieve_batch(qs, 3) for kb in kbs)
            for hj, h1, h4 in zip(rj, r1, r4):
                assert [x["doc"]["text"] for x in h4] == [x["doc"]["text"] for x in h1]
                assert [x["doc"]["text"] for x in h4] == [x["doc"]["text"] for x in hj]
                np.testing.assert_array_equal([x["score"] for x in h4], [x["score"] for x in h1])
                np.testing.assert_allclose(
                    [x["score"] for x in h4], [x["score"] for x in hj], atol=NEAR_TIE
                )
    finally:
        for kb in kbs:
            kb.close()


def test_replica_clones_and_recloning(db_path, unit_rows):
    """Clones ride the corpus snapshot (one per secondary, distinct
    tensors equal to the primary's even on a repeated device, host state
    shared by reference), and a store change makes a new corpus with its
    own clones while the old snapshot keeps its own — as in the JAX
    package."""
    m = unit_rows(64, 16)
    jdb, tdb = _fill(db_path, m)
    jrep = JReplicas(precision="bf16", n_replicas=3)
    rep = ReplicaEngine(precision="bf16", devices=_cpus(3))
    corpus, jcorpus = rep.ensure_fresh(tdb), jrep.ensure_fresh(jdb)
    assert len(corpus.replica_clones) == len(jcorpus.replica_clones) == 2
    for c in corpus.replica_clones:
        assert c.emb_ids is corpus.emb_ids and c.host_cache is corpus.host_cache
        assert c.data is not corpus.data and c.data.data_ptr() != corpus.data.data_ptr()
        assert torch.equal(c.data, corpus.data)
        assert c.dev_rescore is not None and c.dev_emb is not None
        assert torch.equal(c.dev_rescore[0], corpus.dev_rescore[0])
        assert c.dev_rescore[0].data_ptr() != corpus.dev_rescore[0].data_ptr()
    v = np.zeros(16)
    v[3] = 1.0
    with jdb.transaction() as tx:
        tx.add_doc("new", None, None, embedding_to_bytes(list(map(float, v))))
        tx.bump_matrix_version()
    c2, jc2 = rep.ensure_fresh(tdb), jrep.ensure_fresh(jdb)
    assert c2.n_valid == jc2.n_valid == 65
    assert all(c.n_valid == 65 for c in c2.replica_clones)
    assert all(c.n_valid == 64 for c in corpus.replica_clones)
    vals, rows = rep.topk(corpus, m[:6], 3)
    jvals, jrows = jrep.topk(jcorpus, m[:6], 3)
    assert rows.shape == (6, 3) and (rows < 64).all()
    np.testing.assert_array_equal(rows, jrows)
    for eng in (jrep, rep):
        eng.shutdown()
    _close(jdb, tdb)


def test_replica_eps_matches_slice_dispatch(db_path, unit_rows):
    """prescore_eps at the REPLICA batch size: 18 queries over 4 replicas
    are slices of 5, 5, 4 and 4, each bounded as one device bounds its
    slice; the JAX package's values."""
    m = unit_rows(300, 24)
    jdb, tdb = _fill(db_path, m)
    jrep = JReplicas(precision="bf16", n_replicas=4)
    rep = ReplicaEngine(precision="bf16", devices=_cpus(4))
    corpus, jcorpus = rep.ensure_fresh(tdb), jrep.ensure_fresh(jdb)
    q = unit_rows(18, 24)
    eps = rep.prescore_eps(corpus, q, 5)
    np.testing.assert_array_equal(eps, jrep.prescore_eps(jcorpus, q, 5))
    solo = RetrievalEngine(precision="bf16", device="cpu")
    start = 0
    for size in (5, 5, 4, 4):
        want = solo.prescore_eps(corpus, q[start : start + size], 5)
        np.testing.assert_array_equal(eps[start : start + size], want)
        start += size
    for eng in (jrep, rep):
        eng.shutdown()
    _close(jdb, tdb)


def test_replica_mixed_rescore_degrades_whole_batch(db_path, unit_rows):
    """One replica without its device mirrors: the whole batch takes the
    host rescore (``topk_with_rescore`` -> exact None, ``topk_final`` ->
    None), never a mix of exact sources, on both packages."""
    m = unit_rows(200, 16)
    jdb, tdb = _fill(db_path, m)
    q = unit_rows(9, 16)
    for cls, kw, db in ((JReplicas, {"n_replicas": 3}, jdb),
                        (ReplicaEngine, {"devices": _cpus(3)}, tdb)):
        rep = cls(precision="bf16", **kw)
        corpus = rep.ensure_fresh(db)
        c = rep.candidate_count(5)
        object.__setattr__(corpus.replica_clones[0], "dev_rescore", None)
        object.__setattr__(corpus.replica_clones[0], "dev_emb", None)
        assert rep.topk_final(corpus, q, 5, c) is None
        vals, rows, exact = rep.topk_with_rescore(corpus, q, c)
        assert exact is None and vals.shape[0] == rows.shape[0] == 9
        for b in range(9):
            assert set(np.argsort(-(m @ q[b]))[:5].tolist()) <= set(rows[b].tolist())
        rep.shutdown()
    _close(jdb, tdb)


def _replica_threads():
    return [
        t for t in threading.enumerate()
        if t.name.startswith("svs-tpu-replica") and t.is_alive()
    ]


def test_replica_pool_shutdown_on_close(tmp_path):
    """KB.close() releases the fan-out threads (both packages name them
    ``svs-tpu-replica``)."""
    for kb in (
        svs_tpu.KB(tmp_path / "j.sqlite", make_onehot_embedder(), force_fresh_db=True, replicas=3),
        svs_tpu_torch.KB(tmp_path / "t.sqlite", make_onehot_embedder(), force_fresh_db=True,
                         replicas=_cpus(3)),
    ):
        with kb.bulk_add_docs() as add:
            for i in range(8):
                add(f"vec:{i}")
        kb.retrieve_batch(["vec:1", "vec:2", "vec:3"], 1)
        assert _replica_threads()
        kb.close()
        assert kb.engine._pool is None
        for _ in range(50):
            if not _replica_threads():
                break
            time.sleep(0.1)
        assert not _replica_threads()


def test_replica_host_fallback_never_resplits(db_path, unit_rows, monkeypatch):
    """With ``device_rescore='host'`` each slice's prescore runs on its
    replica at its own batch size: one fan-out, never a second split
    inside a slice (the margin proof's bound is per slice)."""
    m = unit_rows(300, 16)
    jdb, tdb = _fill(db_path, m)
    q = unit_rows(12, 16)
    results = []
    for cls, kw, db in ((JReplicas, {"n_replicas": 3}, jdb),
                        (ReplicaEngine, {"devices": _cpus(3)}, tdb)):
        rep = cls(precision="bf16", device_rescore="host", **kw)
        corpus = rep.ensure_fresh(db)
        assert corpus.dev_rescore is None
        calls = []
        orig = cls._plan

        def spying(self, c, qq, orig=orig, calls=calls):
            calls.append(qq.shape[0])
            return orig(self, c, qq)

        monkeypatch.setattr(cls, "_plan", spying)
        vals, rows, exact = rep.topk_with_rescore(corpus, q, rep.candidate_count(5))
        assert exact is None and calls == [12], calls
        for b in range(12):
            assert set(np.argsort(-(m @ q[b]))[:5].tolist()) <= set(rows[b].tolist())
        results.append(rows)
        rep.shutdown()
    for b in range(12):
        assert set(results[0][b].tolist()) == set(results[1][b].tolist())
    _close(jdb, tdb)


def test_replica_shutdown_race_degrades_inline(db_path, unit_rows):
    """A search after the pool is gone (a close() racing it) runs its
    slices inline: correct results, no internal error."""
    m = unit_rows(128, 16)
    jdb, tdb = _fill(db_path, m)
    q = unit_rows(9, 16)
    out = []
    for cls, kw, db in ((JReplicas, {"n_replicas": 3}, jdb),
                        (ReplicaEngine, {"devices": _cpus(3)}, tdb)):
        rep = cls(precision="bf16", **kw)
        corpus = rep.ensure_fresh(db)
        rep.shutdown()
        c = rep.candidate_count(5)
        _, rows = rep.topk(corpus, q, c)
        assert rows.shape == (9, min(c, 128))
        for b in range(9):
            assert set(np.argsort(-(m @ q[b]))[:5].tolist()) <= set(rows[b].tolist())
        out.append(rows)
    for b in range(9):
        assert set(out[0][b].tolist()) == set(out[1][b].tolist())
    _close(jdb, tdb)


def test_replica_pool_recreated_on_reopen(db_path, unit_rows):
    """ensure_fresh re-arms the pool after a shutdown (a reopened KB keeps
    its fan-out)."""
    m = unit_rows(64, 16)
    jdb, tdb = _fill(db_path, m)
    for cls, kw, db in ((JReplicas, {"n_replicas": 3}, jdb),
                        (ReplicaEngine, {"devices": _cpus(3)}, tdb)):
        rep = cls(precision="bf16", **kw)
        rep.ensure_fresh(db)
        rep.shutdown()
        assert rep._pool is None
        corpus = rep.ensure_fresh(db)
        assert rep._pool is not None
        _, rows = rep.topk(corpus, unit_rows(6, 16), 3)
        assert rows.shape == (6, 3)
        rep.shutdown()
    _close(jdb, tdb)


def test_replica_argument_validation(tmp_path):
    """The JAX package's refusals and messages: mesh and replicas
    together, ``device=`` in replica mode, no or too many replicas; an
    int picks the first N CUDA devices (none here)."""
    cases = [
        (dict(mesh=(svs_tpu.parallel.default_mesh(), default_mesh(devices=_cpus(2))),
              replicas=(2, _cpus(2))), "mutually exclusive"),
        (dict(device=(jax.devices()[0], "cpu"), replicas=(2, _cpus(2))), "replicas"),
    ]
    for i, (kw, match) in enumerate(cases):
        for pkg, side in ((svs_tpu, 0), (svs_tpu_torch, 1)):
            with pytest.raises(ValueError, match=match) as err:
                pkg.KB(tmp_path / f"x{i}{side}.sqlite", make_onehot_embedder(),
                       force_fresh_db=True, **{k: v[side] for k, v in kw.items()})
            if side == 0:
                want = str(err.value)
            else:
                assert str(err.value) == want
    for kw in ({"n_replicas": 0}, {"n_replicas": 10_000}):
        with pytest.raises(ValueError) as j_err:
            JReplicas(**kw)
        with pytest.raises(ValueError) as t_err:
            ReplicaEngine(devices=_cpus(8), **kw)
        assert str(t_err.value) == str(j_err.value).replace(str(len(jax.devices())), "8")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="n_replicas=2 but only 0 devices available"):
            svs_tpu_torch.KB(tmp_path / "z.sqlite", make_onehot_embedder(),
                             force_fresh_db=True, replicas=2)
    with pytest.raises(ValueError, match="no devices"):
        ReplicaEngine(devices=[])


def test_replica_filtered_retrieval(tmp_path):
    """Filtered retrieval on a replica KB: the pre-filter route runs on the
    primary and agrees with the post-filter ladder and with the JAX
    package's replica KB."""
    out = []
    for kb in (
        svs_tpu.KB(tmp_path / "j.sqlite", make_onehot_embedder(), force_fresh_db=True, replicas=4),
        svs_tpu_torch.KB(tmp_path / "t.sqlite", make_onehot_embedder(), force_fresh_db=True,
                         replicas=_cpus(4)),
    ):
        with kb.bulk_add_docs() as add:
            for i in range(64):
                add(f"doc {i}", meta={"b": i % 4})
        qs = [f"doc {q}" for q in range(8)]
        filt = kb.retrieve_batch(qs, 3, where={"b": 2})
        ladder = kb.retrieve_batch(qs, 3, where=lambda d: d["meta"]["b"] == 2)

        def key(rs):
            return [[(h["doc"]["id"], h["score"]) for h in r] for r in rs]

        assert key(filt) == key(ladder)
        assert all(h["doc"]["meta"]["b"] == 2 for r in filt for h in r)
        out.append(key(filt))
        kb.close()
    for rj, rt in zip(*out):
        assert [i for i, _ in rt] == [i for i, _ in rj]
        np.testing.assert_allclose([s for _, s in rt], [s for _, s in rj], atol=NEAR_TIE)


def test_kernel_launches_make_the_operand_device_current(monkeypatch):
    """A replica or shard on a second card launches from a thread whose
    current CUDA device is the first (the pool's threads, the mesh's one
    driving thread).  Every launch of a hand-written kernel goes through
    ``kernels.on_device(<operand>.device)``, which makes the operand's
    device current for the launch and hands over that device's stream;
    no launcher is called outside it (read from the wrappers' source)."""
    import ast
    import contextlib
    import inspect

    from svs_tpu_torch.ops import kernels
    from svs_tpu_torch.ops import pallas_extract as P

    current = [torch.device("cuda", 0)]
    seen = []

    @contextlib.contextmanager
    def fake_device(dev):
        current.append(torch.device(dev))
        try:
            yield
        finally:
            current.pop()

    class FakeStream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + torch.device(dev).index

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: seen.append((name, current[-1], args[-1])) or 0

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(kernels, "library", FakeLib)
    for dev in (torch.device("cuda", 1), torch.device("cuda", 3)):
        with kernels.on_device(dev) as (lib, stream):
            assert current[-1] == dev
            kernels.check(lib.svs_extract(0, 8, 1024, 0, 0, stream), "extract")
        assert current == [torch.device("cuda", 0)]
    assert seen == [("svs_extract", torch.device("cuda", 1), 1001),
                    ("svs_extract", torch.device("cuda", 3), 1003)]

    # every launcher call in the wrappers sits inside `with
    # kernels.on_device(<tensor>.device) as (lib, stream)`, which names
    # the library it calls; the library is never fetched another way
    src = inspect.getsource(P)
    assert "kernels.library(" not in src and "current_stream(" not in src
    launches = 0
    for node in ast.walk(ast.parse(src)):
        if not isinstance(node, ast.With):
            continue
        (item,) = node.items
        call = item.context_expr
        if not (isinstance(call, ast.Call) and ast.unparse(call.func) == "kernels.on_device"):
            continue
        (arg,) = call.args
        assert isinstance(arg, ast.Attribute) and arg.attr == "device", ast.unparse(call)
        for inner in ast.walk(node):
            if isinstance(inner, ast.Call) and ast.unparse(inner.func).startswith("lib.svs_"):
                launches += 1
    calls = [
        n for n in ast.walk(ast.parse(src))
        if isinstance(n, ast.Call) and ast.unparse(n.func).startswith("lib.svs_")
    ]
    assert launches == len(calls) == 6  # 5 kernels and the finish's scratch query
