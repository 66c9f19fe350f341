"""The port's kernel-dispatch calibration (``svs_tpu_torch.engine.calibrate``
and the engine's ``_guarded_selection_possible`` / ``_calib_winner``)
against ``svs_tpu``'s on the CPU: the reference's seven cases run against
the port; for the same seeded winners both packages dispatch alike and
give the same ``prescore_eps``; a widen retry into a v3 bucket recomputes
the bound with ``GUARD_KEY_EPS``; the port's key tag and cache path are
its own; and a ``KB`` that follows a measured v3 winner at B=8 returns the
ids of a brute-force scan.  No test asserts on wall-clock time."""

import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svs_tpu.engine import calibrate as jcal
from svs_tpu.engine.index import RetrievalEngine as JaxEngine
from svs_tpu.engine.packing import PackedCorpus as JaxCorpus
from svs_tpu.ops import pallas_extract as J
from svs_tpu_torch import KB
from svs_tpu_torch.engine import calibrate as tcal
from svs_tpu_torch.engine.calibrate import (
    DispatchCalibrator,
    dispatch_key,
    get_calibrator,
    reset_calibrator,
)
from svs_tpu_torch.engine.index import RetrievalEngine
from svs_tpu_torch.engine.packing import PackedCorpus
from svs_tpu_torch.ops import pallas_extract as P
from svs_tpu_torch.store.blob import embedding_to_bytes
from svs_tpu_torch.store.db import Database

torch.set_num_threads(2)


@pytest.fixture
def calib_cache(tmp_path, monkeypatch):
    """Point both packages' process-wide calibrators at a throwaway file
    (the reference's env var, read by both)."""
    path = tmp_path / "dispatch.json"
    monkeypatch.setenv("SVS_TPU_CALIB_CACHE", str(path))
    monkeypatch.delenv("SVS_TPU_AUTOCALIB", raising=False)
    reset_calibrator()
    jcal.reset_calibrator()
    yield path
    reset_calibrator()
    jcal.reset_calibrator()


def _fake_corpus(precision="bf16"):
    """The reference's fake corpus: shape metadata that structurally
    supports BOTH v2 and v3 (block-aligned, nb=16); zeros, since the
    dispatch predicates only read shapes."""
    n_pad = 16 * P.FUSED_BLOCK_N
    n_valid = n_pad - 100
    corpus = PackedCorpus(
        data=torch.zeros((n_pad, 128), dtype=torch.bfloat16),
        row_scales=None,
        emb_ids=np.arange(1, n_valid + 1, dtype=np.int64),
        n_valid=n_valid,
        dim=128,
        version=1,
        precision=precision,
    )
    assert P.fused3_shape_ok(n_pad, corpus.dim_padded, 32, 288)
    assert P.fused2_supported(n_pad, corpus.dim_padded, 32, 288)
    return corpus


def _fake_jax_corpus(precision="bf16"):
    n_pad = 16 * J.FUSED_BLOCK_N
    n_valid = n_pad - 100
    return JaxCorpus(
        data=jnp.zeros((n_pad, 128), jnp.bfloat16),
        row_scales=None,
        emb_ids=np.arange(1, n_valid + 1, dtype=np.int64),
        n_valid=n_valid,
        dim=128,
        version=1,
        precision=precision,
    )


KIND = "cpu"  # the port's device kind of a CPU engine (and jax's)


# -- the reference's seven cases, against the port --------------------------


def test_calibrator_roundtrip_and_persistence(calib_cache):
    cal = DispatchCalibrator(calib_cache)
    key = dispatch_key("NVIDIA_H100_80GB_HBM3", "bf16", 1_015_808, 1536, 256, 400)
    assert cal.decide(key) is None
    assert cal.claim_probe(key)
    assert not cal.claim_probe(key)  # single flight
    cal.record(key, "v2", 0.004, 0.006)
    assert cal.decide(key) == "v2"
    cal2 = DispatchCalibrator(calib_cache)  # a fresh instance reads the file
    assert cal2.decide(key) == "v2"
    data = json.loads(calib_cache.read_text())
    assert data[key] == {"winner": "v2", "v2_ms": 4.0, "v3_ms": 6.0}
    assert not cal2.claim_probe(key)  # a measured key is never re-claimed


def test_calibrator_corrupt_cache_degrades(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    cal = DispatchCalibrator(path)
    assert cal.decide("anything") is None
    cal.record("k", "v3", 0.001, 0.0005)
    assert cal.decide("k") == "v3"


def test_shape_class_bucketing():
    a = dispatch_key("H100", "int8", 1_000_000, 1536, 256, 400)
    b = dispatch_key("H100", "int8", 1_015_808, 1536, 200, 512)
    assert a == b
    assert a != dispatch_key("H100", "bf16", 1_000_000, 1536, 256, 400)
    assert a != dispatch_key("H100", "int8", 1_000_000, 768, 256, 400)
    assert a != dispatch_key("A100", "int8", 1_000_000, 1536, 256, 400)


def test_calibration_overrides_wrong_prior(calib_cache):
    """Seeded measurements flip the dispatch both ways against the static
    prior: v3 demoted at a batch the prior gives it, promoted below
    GUARD_MIN_BATCH."""
    corpus = _fake_corpus()
    eng = RetrievalEngine(precision="bf16", device="cpu")
    n_rows, d = corpus.n_padded, corpus.dim_padded
    b_hi, b_lo = P.GUARD_MIN_BATCH * 2, P.GUARD_MIN_BATCH // 2
    c = eng.candidate_count(64)
    assert eng._guarded_selection_possible(corpus, b_hi, c)
    assert not eng._guarded_selection_possible(corpus, b_lo, c)
    cal = get_calibrator()
    cal.record(dispatch_key(KIND, "bf16", n_rows, d, b_hi, c), "v2", 0.001, 0.002)
    cal.record(dispatch_key(KIND, "bf16", n_rows, d, b_lo, c), "v3", 0.002, 0.001)
    eng2 = RetrievalEngine(precision="bf16", device="cpu")  # empty sticky map
    assert not eng2._guarded_selection_possible(corpus, b_hi, c)
    assert eng2._guarded_selection_possible(corpus, b_lo, c)


def test_sticky_decisions_survive_late_calibration(calib_cache):
    corpus = _fake_corpus()
    eng = RetrievalEngine(precision="bf16", device="cpu")
    b = P.GUARD_MIN_BATCH * 2
    c = eng.candidate_count(64)
    assert eng._guarded_selection_possible(corpus, b, c)  # prior: v3
    get_calibrator().record(
        dispatch_key(KIND, "bf16", corpus.n_padded, corpus.dim_padded, b, c),
        "v2", 0.001, 0.002,
    )
    assert eng._guarded_selection_possible(corpus, b, c)  # sticky v3


def test_probe_records_winner(calib_cache, monkeypatch):
    """With probing forced on and the timing stubbed, the background probe
    persists the faster kernel (joined through the engine's hook)."""
    corpus = _fake_corpus()
    monkeypatch.setenv("SVS_TPU_AUTOCALIB", "force")
    monkeypatch.setattr(
        tcal, "time_kernel_pair",
        lambda corpus, data, scales, q, c, wide: (0.007, 0.003),
    )
    eng = RetrievalEngine(precision="bf16", device="cpu")
    b, c = 32, eng.candidate_count(64)
    eng._guarded_selection_possible(corpus, b, c)  # spawns the probe
    assert eng.join_dispatch_probes(timeout=30)
    key = dispatch_key(KIND, "bf16", corpus.n_padded, corpus.dim_padded, b, c)
    assert get_calibrator().decide(key) == "v3"


def test_probing_disabled_on_cpu_by_default(calib_cache, monkeypatch):
    from svs_tpu_torch.engine.calibrate import probing_enabled

    monkeypatch.delenv("SVS_TPU_AUTOCALIB", raising=False)
    assert not probing_enabled()  # no card here
    assert not probing_enabled("cpu")
    monkeypatch.setenv("SVS_TPU_AUTOCALIB", "0")
    assert not probing_enabled("cuda")
    monkeypatch.setenv("SVS_TPU_AUTOCALIB", "off")
    assert not probing_enabled("cuda")
    monkeypatch.setenv("SVS_TPU_AUTOCALIB", "force")
    assert probing_enabled() and probing_enabled("cpu")


# -- parity with svs_tpu's dispatch and bound -------------------------------


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("winner", [None, "v2", "v3"], ids=["prior", "v2", "v3"])
def test_dispatch_and_eps_match_svs_tpu(calib_cache, precision, b, winner):
    """For the same seeded winner (none: both on the static prior) the
    port's v3 decision and ``prescore_eps`` equal ``svs_tpu``'s on the
    reference's fake 16-block corpus."""
    corpus, jcorpus = _fake_corpus(precision), _fake_jax_corpus(precision)
    got = RetrievalEngine(precision=precision, device="cpu")
    ref = JaxEngine(precision=precision)
    c = got.candidate_count(64)
    assert c == ref.candidate_count(64)
    shape = (corpus.n_padded, corpus.dim_padded, b, c)
    if winner is not None:
        get_calibrator().record(dispatch_key(KIND, precision, *shape), winner, 1e-3, 1e-3)
        jcal.get_calibrator().record(jcal.dispatch_key(KIND, precision, *shape), winner, 1e-3, 1e-3)
    v3 = got._guarded_selection_possible(corpus, b, c)
    assert v3 == ref._guarded_selection_possible(jcorpus, b, c)
    assert v3 == (winner == "v3" or (winner is None and b >= P.GUARD_MIN_BATCH))
    rng = np.random.default_rng(b)
    q = rng.standard_normal((b, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(got.prescore_eps(corpus, q, c), ref.prescore_eps(jcorpus, q, c))


def test_widen_retry_into_a_v3_bucket_recomputes_the_bound(calib_cache):
    """C=42 (bucket 64) measured for v2, C=168 (bucket 256) for v3: the
    first try's bound carries KEY_EPS, the widened retry's GUARD_KEY_EPS,
    and the retry dispatches v3 — the KB recomputes the bound at every
    retry's C."""
    corpus = _fake_corpus()
    eng = RetrievalEngine(precision="bf16", device="cpu")
    b, c0 = 8, eng.candidate_count(10)
    shape = (corpus.n_padded, corpus.dim_padded, b)
    cal = get_calibrator()
    cal.record(dispatch_key(KIND, "bf16", *shape, c0), "v2", 1e-3, 2e-3)
    cal.record(dispatch_key(KIND, "bf16", *shape, 4 * c0), "v3", 2e-3, 1e-3)
    q = np.eye(b, 128, dtype=np.float32)
    base = 2.0**-8 * (1.0 + 2.0**-9) + 3e-5
    np.testing.assert_array_equal(eng.prescore_eps(corpus, q, c0), np.full(b, base + P.KEY_EPS))
    assert not eng._guarded_selection_possible(corpus, b, c0)
    np.testing.assert_array_equal(eng.prescore_eps(corpus, q, 4 * c0), np.full(b, base + P.GUARD_KEY_EPS))
    assert eng._guarded_selection_possible(corpus, b, 4 * c0)


def test_key_tag_and_cache_path_are_the_ports_own(monkeypatch):
    monkeypatch.delenv("SVS_TPU_CALIB_CACHE", raising=False)
    args = ("cpu", "int8", 1_000_000, 1536, 8, 400)
    assert dispatch_key(*args).endswith("|ce1")
    assert jcal.dispatch_key(*args).endswith("|m2")
    assert dispatch_key(*args) != jcal.dispatch_key(*args)
    mine = DispatchCalibrator().path()
    theirs = jcal.DispatchCalibrator().path()
    assert mine.parts[-2:] == ("svs_tpu_torch", "dispatch.json")
    assert mine != theirs
    assert tcal.device_kind("cpu") == "cpu"


def test_time_kernel_pair_on_the_plain_versions(calib_cache, monkeypatch):
    """``force`` on the CPU: the probe times the plain v2 and v3 paths (a
    real run of ``time_kernel_pair``) and records a winner with both
    times; the engine that spawned it keeps its prior."""
    monkeypatch.setenv("SVS_TPU_AUTOCALIB", "force")
    corpus = _fake_corpus("bf16")
    eng = RetrievalEngine(precision="bf16", device="cpu")
    b, c = 8, eng.candidate_count(10)
    assert not eng._guarded_selection_possible(corpus, b, c)  # prior: v2
    assert eng.join_dispatch_probes(timeout=120)
    entry = get_calibrator().entries()[
        dispatch_key(KIND, "bf16", corpus.n_padded, corpus.dim_padded, b, c)
    ]
    assert entry["winner"] in ("v2", "v3")
    assert entry["v2_ms"] > 0 and entry["v3_ms"] > 0
    assert not eng._guarded_selection_possible(corpus, b, c)  # sticky


# -- a KB that follows a measured winner ------------------------------------

N_DOCS, DIM = 131_072 - 3000, 128


def _vector(text):
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    v = rng.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


async def _embed(texts):
    return [_vector(t).tolist() for t in texts]


@pytest.fixture(scope="module")
def big_store(tmp_path_factory):
    """131,072 - 3,000 docs x 128 (a 131,072-row pack: 16 blocks, the
    smallest guarded corpus), written through the port's ``Tx``."""
    rng = np.random.default_rng(42)
    m = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    path = tmp_path_factory.mktemp("calib") / "store.sqlite"
    db = Database(path)
    with db.transaction() as tx:
        tx.add_docs_bulk([f"doc {i}" for i in range(N_DOCS)],
                         [embedding_to_bytes(r) for r in m])
        tx.bump_matrix_version()
    db.close()
    return path, m


def test_kb_follows_a_measured_v3_winner_at_b8(calib_cache, monkeypatch, big_store):
    """A first ``KB`` runs B=8 on its prior (v2) and spawns a probe whose
    stubbed timing says v3; a new ``KB`` dispatches v3 at B=8.  Both return
    the ids of a numpy brute-force scan."""
    path, m = big_store
    monkeypatch.setenv("SVS_TPU_AUTOCALIB", "force")
    monkeypatch.setattr(
        tcal, "time_kernel_pair",
        lambda corpus, data, scales, q, c, wide: (0.002, 0.001),
    )
    calls = {"v2": 0, "v3": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(P, fn.__name__, wrapped)

    spy("v2", P.score_topk_fused2_int8_packed)
    spy("v3", P.score_topk_fused3_int8_packed)
    texts = [f"query {i}" for i in range(8)]
    q = np.stack([_vector(t) for t in texts])
    exact = q @ m.T
    want = np.argsort(-exact, axis=1, kind="stable")[:, :10]

    def run():
        kb = KB(path, _embed, device="cpu")
        try:
            res = kb.retrieve_batch(texts, 10)
            assert kb.engine.corpus.n_padded == 16 * P.FUSED_BLOCK_N
            assert kb.engine.join_dispatch_probes(timeout=60)
        finally:
            kb.close()
        return np.asarray([[int(h["doc"]["text"].split()[1]) for h in r] for r in res])

    np.testing.assert_array_equal(run(), want)
    # the margin may widen C once (42 -> 168): each width is its own key
    v2_calls = calls["v2"]
    assert v2_calls >= 1 and calls["v3"] == 0
    entries = get_calibrator().entries()
    assert len(entries) == v2_calls
    assert all(v["winner"] == "v3" for v in entries.values())
    np.testing.assert_array_equal(run(), want)
    assert calls["v2"] == v2_calls and calls["v3"] >= 1


def test_kb_widen_retry_recomputes_the_bound_in_a_v3_bucket(calib_cache, monkeypatch, big_store):
    """Through the KB's widen loop: B=8, n=10 starts at C=42 (bucket 64,
    measured v2) and widens to C=168 (bucket 256, measured v3); the first
    try's bound carries KEY_EPS and runs v2, the retry's carries
    GUARD_KEY_EPS and runs v3."""
    path, m = big_store
    b, n = 8, 10
    eng0 = RetrievalEngine(device="cpu")
    c0 = eng0.candidate_count(n)
    n_pad, d_pad = 16 * P.FUSED_BLOCK_N, DIM
    cal = get_calibrator()
    cal.record(dispatch_key(KIND, "int8", n_pad, d_pad, b, c0), "v2", 1e-3, 2e-3)
    cal.record(dispatch_key(KIND, "int8", n_pad, d_pad, b, 4 * c0), "v3", 2e-3, 1e-3)
    order = []
    for name, tag in (("score_topk_fused2_int8_packed", "v2"), ("score_topk_fused3_int8_packed", "v3")):
        fn = getattr(P, name)

        def wrapped(*a, _fn=fn, _tag=tag, **kw):
            order.append(_tag)
            return _fn(*a, **kw)
        monkeypatch.setattr(P, name, wrapped)
    texts = [f"query {i}" for i in range(b)]
    kb = KB(path, _embed, device="cpu")
    try:
        eps_at = {}
        real = kb.engine.prescore_eps
        no_keys = RetrievalEngine(device="cpu", kernel="xla")  # the bound less any key term

        def spy(corpus, queries, k):
            eps = real(corpus, queries, k)
            eps_at[k] = eps - no_keys.prescore_eps(corpus, queries, k)
            return eps
        monkeypatch.setattr(kb.engine, "prescore_eps", spy)
        res = kb.retrieve_batch(texts, n)
    finally:
        kb.close()
    assert order[:2] == ["v2", "v3"], order
    np.testing.assert_allclose(eps_at[c0], P.KEY_EPS)
    np.testing.assert_allclose(eps_at[4 * c0], P.GUARD_KEY_EPS)
    q = np.stack([_vector(t) for t in texts])
    want = np.argsort(-(q @ m.T), axis=1, kind="stable")[:, :n]
    got = np.asarray([[int(h["doc"]["text"].split()[1]) for h in r] for r in res])
    np.testing.assert_array_equal(got, want)
