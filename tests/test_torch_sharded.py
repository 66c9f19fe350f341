"""The port's sharded retrieval (``svs_tpu_torch.parallel``) against the
JAX package's on the CPU: each case of ``tests/test_sharded.py`` as a
parity case.  The same seeded inputs go through ``svs_tpu.parallel`` on
JAX's virtual CPU devices (Pallas in interpret mode) and through the
port on ``[torch.device('cpu')] * D`` (the kernels' plain versions), at
D = 2, 4 and 8 shards.

The merged candidates of the keyed (v2) and guarded (v3) routes, and the
guarded route's merged bound, are bit-identical; exact scores agree
within 1e-6 (XLA and torch sum f32 products in other orders), and ids
agree except between scores closer than that.  Also held here: the
trailing-shard refusal of the guarded gate, the streamed per-shard scan,
the mesh rescore (``sharded_rescore_final``: the single-device rescore's
bits), the mesh pre-filter route (``sharded_subset_topk``), and the
pairwise ring with its width escalation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from svs_tpu.engine.index import RetrievalEngine as JEngine
from svs_tpu.engine.packing import pack_corpus as j_pack_corpus
from svs_tpu.engine.packing import pad_matrix, pad_queries
from svs_tpu.ops.quant import quantize_rows_int8 as j_quantize
from svs_tpu.parallel import default_mesh as j_default_mesh
from svs_tpu.parallel import mesh_2d as j_mesh_2d
from svs_tpu.parallel import sharded as j_sharded
from svs_tpu.parallel.pairwise_sharded import sharded_pairwise_topk as j_pairwise
from svs_tpu_torch.engine.index import RetrievalEngine
from svs_tpu_torch.ops import pallas_extract as T
from svs_tpu_torch.parallel import default_mesh, mesh_2d
from svs_tpu_torch.parallel import sharded as t_sharded
from svs_tpu_torch.parallel.mesh import place
from svs_tpu_torch.parallel.pairwise_sharded import sharded_pairwise_topk
from svs_tpu_torch.utils.topk_np import top_k_numpy, top_pairs_numpy

torch.set_num_threads(2)

SHARDS = (2, 4, 8)
#: XLA and torch sum f32 products in other orders.
NEAR_TIE = 1e-6


@pytest.fixture(scope="module", autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest)")


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _meshes(d, model=None):
    devs = jax.devices()[: d * (model or 1)]
    cpus = ["cpu"] * (d * (model or 1))
    if model is None:
        return j_default_mesh(devices=devs), default_mesh(devices=cpus)
    return j_mesh_2d(d, model, devices=devs), mesh_2d(d, model, devices=cpus)


def _jax_put(a, mesh, spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))


def _same_up_to_near_ties(j_vals, j_idx, t_vals, t_idx):
    """ids equal except where the two scores sit within NEAR_TIE; scores
    within NEAR_TIE."""
    j_vals, t_vals = np.asarray(j_vals), np.asarray(t_vals)
    j_idx, t_idx = np.asarray(j_idx), np.asarray(t_idx)
    np.testing.assert_allclose(t_vals, j_vals, atol=NEAR_TIE, rtol=0)
    differ = j_idx != t_idx
    if differ.any():
        near = np.zeros_like(differ)
        for b, r in zip(*np.nonzero(differ)):
            near[b, r] = any(
                abs(j_vals[b, r] - j_vals[b, s]) < NEAR_TIE for s in range(j_vals.shape[1]) if s != r
            )
        assert near[differ].all()


def _both_topk(mp, qp, n_valid, k, d_shards, model=None, int8=False, **route):
    """``sharded_score_topk`` of both packages on the padded matrix ``mp``
    (int8: quantized by the JAX package's quantizer, scales alongside)."""
    jm, tm = _meshes(d_shards, model)
    model_axis = "model" if model else None
    if int8:
        qd, rs = j_quantize(jnp.asarray(mp))
        qd, rs = np.asarray(qd), np.asarray(rs)
        jdocs = _jax_put(qd, jm, P("data", None))
        jscales = _jax_put(rs, jm, P("data"))
        tdocs, tscales = place(qd, tm), place(rs, tm)
    else:
        jdocs = _jax_put(mp, jm, P("data", model_axis))
        jscales = tscales = None
        tdocs = place(mp, tm, "data", model_axis)
    jv, ji = j_sharded.sharded_score_topk(
        jdocs, jscales, jnp.asarray(qp), jnp.int32(n_valid), k,
        mesh=jm, model_axis=model_axis, **route,
    )
    tv, ti = t_sharded.sharded_score_topk(
        tdocs, tscales, torch.from_numpy(qp), n_valid, k,
        mesh=tm, model_axis=model_axis, **route,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _corpus(rng, n=1000, d=64, b=4):
    m = _unit(rng, n, d)
    q = _unit(rng, b, d)
    mp = pad_matrix(m, row_multiple=256 * 8)  # divisible across 8 shards
    return m, q, mp, pad_queries(q, mp.shape[1])


@pytest.mark.parametrize("d_shards", SHARDS)
def test_sharded_1d_matches_jax(d_shards):
    m, q, mp, qp = _corpus(np.random.default_rng(d_shards))
    (jv, ji), (tv, ti) = _both_topk(mp, qp, len(m), 13, d_shards)
    _same_up_to_near_ties(jv, ji, tv, ti)
    for b in range(len(q)):
        assert list(ti[b]) == [i for _, i in top_k_numpy(m @ q[b], 13)]


@pytest.mark.parametrize("d_shards", [2, 4])
def test_sharded_2d_matches_jax(d_shards):
    """Rows over the data axis, the dim over a model axis of 2: the partial
    dots summed per row block (``Mesh.sum``)."""
    m, q, mp, qp = _corpus(np.random.default_rng(10 + d_shards), d=100)  # pads to 128
    (jv, ji), (tv, ti) = _both_topk(mp, qp, len(m), 7, d_shards, model=2)
    _same_up_to_near_ties(jv, ji, tv, ti)
    for b in range(len(q)):
        assert list(ti[b]) == [i for _, i in top_k_numpy(m @ q[b], 7)]


@pytest.mark.parametrize("d_shards", SHARDS)
def test_sharded_int8_matches_jax(d_shards):
    """The materialised int8 route: the same candidates as the JAX
    package's (its scores the same int32 dots, rescaled in its order),
    and they cover the true top 10."""
    m, q, mp, qp = _corpus(np.random.default_rng(20 + d_shards))
    (jv, ji), (tv, ti) = _both_topk(mp, qp, len(m), 50, d_shards, int8=True)
    _same_up_to_near_ties(jv, ji, tv, ti)
    for b in range(len(q)):
        assert {i for _, i in top_k_numpy(m @ q[b], 10)} <= set(ti[b].tolist())


def test_sharded_int8_model_axis_rejected():
    m, q, mp, qp = _corpus(np.random.default_rng(3))
    for mesh, fn, docs, scales, qv, nv in (
        (j_mesh_2d(4, 2), j_sharded.sharded_score_topk, *[jnp.asarray(a) for a in
         j_quantize(jnp.asarray(mp))], jnp.asarray(qp), jnp.int32(len(m))),
        (mesh_2d(4, 2, devices=["cpu"] * 8), t_sharded.sharded_score_topk,
         *[torch.from_numpy(np.asarray(a)) for a in j_quantize(jnp.asarray(mp))],
         torch.from_numpy(qp), len(m)),
    ):
        with pytest.raises(NotImplementedError):
            fn(docs, scales, qv, nv, 5, mesh=mesh, model_axis="model")
    with pytest.raises(NotImplementedError):
        t_sharded.sharded_score_topk(
            place(mp, mesh_2d(4, 2, devices=["cpu"] * 8), "data", "model"), None,
            torch.from_numpy(qp), len(m), 5, mesh=mesh_2d(4, 2, devices=["cpu"] * 8),
            model_axis="model", keyed=True,
        )


@pytest.mark.parametrize("d_shards", SHARDS)
def test_sharded_k_larger_than_shard(d_shards):
    """k past a shard's rows: the per-shard k clamps to its rows and the
    merge is still the exact global top-k."""
    m, q, mp, qp = _corpus(np.random.default_rng(30 + d_shards), n=900)
    k = 400  # > 2048 / 8 = 256 rows per shard at D = 8
    (jv, ji), (tv, ti) = _both_topk(mp, qp, len(m), k, d_shards)
    _same_up_to_near_ties(jv, ji, tv, ti)
    assert list(ti[0]) == [i for _, i in top_k_numpy(m @ q[0], k)]


@pytest.mark.parametrize("d_shards", SHARDS)
def test_sharded_per_shard_extraction_matches_jax(d_shards):
    """Block-aligned shards select through ``extract_topk`` (#8): the
    merged top-k is the JAX package's and the oracle's."""
    n = d_shards * T.BLOCK_N  # one extraction block per shard
    rng = np.random.default_rng(40 + d_shards)
    m = _unit(rng, n, 16)
    mp = np.zeros((n, 128), np.float32)
    mp[:, :16] = m
    pick = [7, 1000, n - 3000]
    qp = np.zeros((3, 128), np.float32)
    qp[:, :16] = m[pick]
    n_valid = n - 57
    assert T.extract_supported(n // d_shards, 3, 9)
    (jv, ji), (tv, ti) = _both_topk(mp, qp, n_valid, 9, d_shards)
    _same_up_to_near_ties(jv, ji, tv, ti)
    exact = m[:n_valid] @ m[pick].T
    for b in range(3):
        assert list(ti[b]) == [i for _, i in top_k_numpy(exact[:, b], 9)]


def _keyed_inputs(d_shards, seed):
    n = d_shards * 2 * T.FUSED_BLOCK_N  # two fused blocks per shard
    rng = np.random.default_rng(seed)
    m = _unit(rng, n, 16)
    mp = np.zeros((n, 128), np.float32)
    mp[:, :16] = m
    pick = [3, 9000, 17000, n - 8000, n - 2000, 50, 16500, 16900]
    qp = np.zeros((8, 128), np.float32)
    qp[:, :16] = m[pick]
    return m, mp, qp, pick, n - 123


def _both_bf16(mp, qp, nv, k, d_shards, **route):
    jm, tm = _meshes(d_shards)
    jdocs = _jax_put(jnp.asarray(mp, jnp.bfloat16), jm, P("data", None))
    bits = np.asarray(jnp.asarray(mp, jnp.bfloat16)).view(np.uint16)
    tdocs = place(bits, tm, bf16=True)
    jv, ji = j_sharded.sharded_score_topk(
        jdocs, None, jnp.asarray(qp), jnp.int32(nv), k, mesh=jm, **route
    )
    tv, ti = t_sharded.sharded_score_topk(
        tdocs, None, torch.from_numpy(qp), nv, k, mesh=tm, **route
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("d_shards", SHARDS)
def test_sharded_keyed_candidates_bit_identical(d_shards):
    """Keyed (v2) per shard, bf16: the merged candidates and their
    decoded prescores are the JAX package's bit for bit, and keep the
    contract the rescore consumes (within KEY_EPS of the storage truth,
    covering every doc clearly above the k-th value)."""
    m, mp, qp, pick, nv = _keyed_inputs(d_shards, 50 + d_shards)
    k = 40
    (jv, ji), (tv, ti) = _both_bf16(mp, qp, nv, k, d_shards, keyed=True)
    np.testing.assert_array_equal(_bits(jv), _bits(tv))
    np.testing.assert_array_equal(ji, ti)
    eps = 2.0**-8 * (1 + 2.0**-9) + T.KEY_EPS + 3e-5
    exact = (m[:nv] @ m[pick].T).T
    for b in range(8):
        assert (np.abs(tv[b] - exact[b][ti[b]]) <= eps).all()
        assert set(np.nonzero(exact[b] > tv[b][k - 1] + eps)[0].tolist()) <= set(ti[b].tolist())
        assert len(set(ti[b].tolist())) == k


@pytest.mark.parametrize("d_shards", SHARDS)
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_sharded_guarded_candidates_and_bound_bit_identical(precision, d_shards):
    """Guarded (v3) per shard: the merged candidates and the merged
    boundary slot ``max(weakest merged, max of the shards' bounds)`` are
    the JAX package's bit for bit, and the boundary bounds every document
    missing from the merged set."""
    m, mp, qp, pick, nv = _keyed_inputs(d_shards, 60 + d_shards)
    k = 40
    if precision == "bf16":
        (jv, ji), (tv, ti) = _both_bf16(mp, qp, nv, k, d_shards, guarded=True)
        model = (m[:, :16] @ m[pick][:, :16].T).T
        eps = 2.0**-8 * (1 + 2.0**-9) + T.GUARD_KEY_EPS + 3e-5
    else:
        (jv, ji), (tv, ti) = _both_topk(mp, qp, nv, k, d_shards, int8=True, guarded=True)
        qd, rs = (np.asarray(a) for a in j_quantize(jnp.asarray(mp)))
        qi, qs = (np.asarray(a) for a in j_quantize(jnp.asarray(qp)))
        model = (qi.astype(np.int32) @ qd.astype(np.int32).T).astype(np.float32) * rs[None, :] * qs[:, None]
        eps = T.GUARD_KEY_EPS + 1e-4
    np.testing.assert_array_equal(_bits(jv), _bits(tv))
    np.testing.assert_array_equal(ji, ti)
    assert (ti >= 0).all() and (ti < nv).all()
    for b in range(8):
        mask = np.ones(nv, dtype=bool)
        mask[ti[b]] = False
        assert model[b][:nv][mask].max() <= tv[b][-1] + eps


def _packs(m, precision, d_shards, model=None):
    """The same pack on a mesh engine of each package: the JAX package's
    ``pack_corpus`` and the port's ``_pack`` (the same bytes), with their
    device mirrors."""
    jm, tm = _meshes(d_shards, model)
    ids = np.arange(1, len(m) + 1, dtype=np.int64)
    jeng = JEngine(precision=precision, mesh=jm)
    jc = j_pack_corpus(
        m, ids, version=1, precision=precision, placement=jeng._placement(),
        row_multiple=jeng._row_multiple(len(m)), dim_multiple=jeng._dim_multiple(),
    )
    jeng._maybe_build_device_rescore(jc)
    teng = RetrievalEngine(precision=precision, mesh=tm)
    tc = teng._pack(m, ids, 1)
    teng._corpus = tc
    teng._maybe_build_device_rescore(tc)
    assert tc.n_padded == jc.n_padded and tc.dim_padded == jc.dim_padded
    return jeng, jc, teng, tc


def _rescored_top(m, corpus, rows, q, n):
    """The KB's host rescore of candidate pack rows: exact f32 dots, the
    reference tie rule (larger emb id first)."""
    out = []
    for b in range(len(q)):
        cand = corpus.emb_ids[rows[b].astype(int)] - 1
        exact = m[cand] @ q[b]
        order = np.lexsort((-cand, -exact))[:n]
        out.append(sorted(int(c) for c in cand[order]))
    return out


@pytest.mark.parametrize("d_shards", SHARDS)
def test_engine_mesh_dispatches_keyed_kernels(d_shards, monkeypatch):
    """The mesh engine takes the keyed per-shard kernel at its shapes (the
    gate judged on the shard), adds KEY_EPS to its bound as the JAX
    engine does, and its rescored top-10 is the JAX engine's and the
    oracle's."""
    calls = []
    real = T.fused2_topk_steps

    def spy(docs, q, nv, k):
        calls.append(tuple(docs.shape))
        return (yield from real(docs, q, nv, k))

    monkeypatch.setattr(T, "fused2_topk_steps", spy)
    n = d_shards * 2 * T.FUSED_BLOCK_N - 1000
    m = _unit(np.random.default_rng(70 + d_shards), n, 16)
    jeng, jc, teng, tc = _packs(m, "bf16", d_shards)
    c = teng.candidate_count(10)
    q = m[:8]
    assert teng._keyed_selection_possible(tc, 8, c) == jeng._keyed_selection_possible(jc, 8, c)
    assert teng._keyed_selection_possible(tc, 8, c)
    np.testing.assert_array_equal(teng.prescore_eps(tc, q, c), jeng.prescore_eps(jc, q, c))
    _, rows = teng.topk(tc, q, c)
    assert calls and all(s[0] == tc.n_padded // d_shards for s in calls)
    _, jrows = jeng.topk(jc, q, c)
    want = [sorted(i for _, i in top_k_numpy(m @ q[b], 10)) for b in range(8)]
    assert _rescored_top(m, tc, rows, q, 10) == want == _rescored_top(m, jc, jrows, q, 10)


@pytest.mark.parametrize("d_shards", SHARDS)
def test_engine_mesh_dispatches_guarded_kernels(d_shards, monkeypatch):
    """b >= GUARD_MIN_BATCH: the guarded per-shard kernel, GUARD_KEY_EPS in
    the bound, the rescored top-10 exact.  The gate's 16-blocks-a-shard
    floor is relaxed for both packages (as the JAX test relaxes it) to
    keep the CPU run small; the trailing-shard refusal is the
    reference's: with 100 padding rows the worst shard loses one block."""
    from svs_tpu.ops import pallas_extract as J

    calls = []
    real = T.fused3_candidates

    def spy(docs, q, nv, c):
        calls.append(tuple(docs.shape))
        return real(docs, q, nv, c)

    for mod in (T, J):
        real_supported = mod.fused3_supported

        def relaxed(n, d, b, c, real_supported=real_supported, mod=mod):
            return (
                n % mod.FUSED_BLOCK_N == 0
                and n // mod.FUSED_BLOCK_N >= 2
                and real_supported(max(n, 16 * mod.FUSED_BLOCK_N), d, b, c)
            )

        monkeypatch.setattr(mod, "fused3_supported", relaxed)
    monkeypatch.setattr(T, "fused3_candidates", spy)
    n = d_shards * 4 * T.FUSED_BLOCK_N - 100  # nb = 4 a shard
    m = _unit(np.random.default_rng(80 + d_shards), n, 16)
    jeng, jc, teng, tc = _packs(m, "bf16", d_shards)
    b = T.GUARD_MIN_BATCH
    c = teng.candidate_count(10)
    for cc in (c, 96, 97):  # the worst shard's pool: (4 - 1) * 32 = 96 keys
        assert teng._guarded_selection_possible(tc, b, cc) == jeng._guarded_selection_possible(jc, b, cc)
    assert teng._guarded_selection_possible(tc, b, 96)
    assert not teng._guarded_selection_possible(tc, b, 97)
    q = m[:b]
    np.testing.assert_array_equal(teng.prescore_eps(tc, q, c), jeng.prescore_eps(jc, q, c))
    assert (teng.prescore_eps(tc, q, c) >= T.GUARD_KEY_EPS).all()
    _, rows = teng.topk(tc, q, c)
    assert calls and all(s[0] == tc.n_padded // d_shards for s in calls)
    want = [sorted(i for _, i in top_k_numpy(m @ q[i], 10)) for i in range(b)]
    assert _rescored_top(m, tc, rows, q, 10) == want


def test_guarded_gate_refuses_a_starved_trailing_shard():
    """The refusal itself, with the real gate: 948,576 docs on 8 shards
    pad to 1,048,576 rows, so the last shard keeps 3 live blocks of 16
    (a pool of 96 keys) and the gate refuses C = 100 on both packages,
    where one device takes it; 1,000,000 docs on 2 shards (62 blocks a
    shard, 2 of them padding) dispatch."""
    from svs_tpu.engine.packing import PackedCorpus as JCorpus
    from svs_tpu_torch.engine.packing import PackedCorpus as TCorpus

    def shaped(cls, n_valid, n_pad):
        return cls(
            data=np.zeros((n_pad, 128), np.int8), row_scales=None,
            emb_ids=np.arange(n_valid, dtype=np.int64), n_valid=n_valid, dim=128,
            version=1, precision="int8",
        )

    def padded(eng, n_valid):
        mult = eng._row_multiple(n_valid)
        return -(-n_valid // mult) * mult

    for d_shards, n_valid, want in ((8, 948_576, False), (2, 1_000_000, True)):
        jm, tm = _meshes(d_shards)
        jeng, teng = JEngine(precision="int8", mesh=jm), RetrievalEngine(precision="int8", mesh=tm)
        n_pad = padded(teng, n_valid)
        assert n_pad == padded(jeng, n_valid)
        assert teng._guarded_selection_possible(shaped(TCorpus, n_valid, n_pad), 64, 100) is want
        assert jeng._guarded_selection_possible(shaped(JCorpus, n_valid, n_pad), 64, 100) is want
    solo = RetrievalEngine(precision="int8", device="cpu")
    assert solo._guarded_selection_possible(
        shaped(TCorpus, 948_576, padded(solo, 948_576)), 64, 100
    )


def _final_parity(m, q, emb_ids, precision, d_shards, n):
    jeng, jc, teng, tc = _packs(m, precision, d_shards)
    assert tc.dev_rescore is not None and tc.dev_emb is not None
    c = teng.candidate_count(n)
    jf = jeng.topk_final(jc, q, n, c)
    tf = teng.topk_final(tc, q, n, c)
    np.testing.assert_array_equal(tf[0], jf[0])
    np.testing.assert_allclose(tf[1], jf[1], atol=NEAR_TIE, rtol=0)
    # the mesh rescore is the single-device rescore's bits (one shard holds
    # each row, and x + 0 = x)
    solo = RetrievalEngine(precision=precision, device="cpu")
    sc = solo._pack(m, emb_ids, 1)
    solo._corpus = sc
    solo._maybe_build_device_rescore(sc)
    sf = solo.topk_final(sc, q, n, c)
    np.testing.assert_array_equal(tf[0], sf[0])
    np.testing.assert_array_equal(_bits(tf[1]), _bits(sf[1]))
    # topk_with_rescore never rescores on the device under a mesh
    assert teng.topk_with_rescore(tc, q, c)[2] is None
    return tf, teng, tc


@pytest.mark.parametrize("d_shards", SHARDS)
def test_mesh_topk_final_matches_jax_and_single_device(d_shards):
    """``sharded_rescore_final`` on a bf16 mesh: the JAX engine's ids and
    scores, the single-device engine's bits, planted ties larger emb id
    first."""
    rng = np.random.default_rng(90 + d_shards)
    m = _unit(rng, 500, 24)
    m[50:60] = m[50]
    q = np.concatenate([m[50:51], _unit(rng, 3, 24)])
    emb_ids = np.arange(1, 501, dtype=np.int64)
    (emb, scores, _), _, _ = _final_parity(m, q, emb_ids, "bf16", d_shards, 15)
    tied = emb[0][scores[0] >= scores[0][0] - 1e-7]
    assert len(tied) >= 10 and list(tied)[:10] == sorted(tied, reverse=True)[:10]


@pytest.mark.parametrize("d_shards", SHARDS)
def test_mesh_topk_final_f32_pack_reuse(d_shards):
    """An f32 mesh pack is its own sharded mirror (no copy, the padded
    width): the final selection matches JAX's and the oracle's."""
    rng = np.random.default_rng(100 + d_shards)
    m = _unit(rng, 400, 20)
    m[30:38] = m[30]
    q = np.concatenate([m[30:31], _unit(rng, 2, 20)])
    emb_ids = np.arange(1, 401, dtype=np.int64)
    (emb, _, _), teng, tc = _final_parity(m, q, emb_ids, "f32", d_shards, 5)
    assert tc.dev_rescore[0] is tc.data
    assert list(emb[0][:5]) == [38, 37, 36, 35, 34]


@pytest.mark.parametrize("d_shards", SHARDS)
def test_mesh_topk_final_int8_and_model_axis_policy(d_shards):
    """int8 mesh packs get the sharded f32 mirror (exact final scores);
    a dim-sharded mesh keeps the host rescore on both packages."""
    rng = np.random.default_rng(110 + d_shards)
    m = _unit(rng, 320, 24)
    emb_ids = np.arange(1, 321, dtype=np.int64)
    _final_parity(m, m[:2], emb_ids, "int8", d_shards, 5)
    if d_shards <= 4:
        jeng, jc, teng, tc = _packs(m, "f32", d_shards, model=2)
        assert jc.dev_rescore is None and tc.dev_rescore is None
        assert teng.topk_final(tc, m[:2], 5, 40) is None


@pytest.mark.parametrize("d_shards", SHARDS)
def test_sharded_streams_past_scores_budget(d_shards, monkeypatch):
    """Past the score-matrix budget each shard streams row blocks
    (float and int8), with the JAX package's results."""
    import svs_tpu.ops.topk as j_topk
    import svs_tpu_torch.ops.topk as t_topk

    calls = []
    real = t_topk.streaming_score_topk

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(j_topk, "FALLBACK_SCORES_BUDGET", 0)
    monkeypatch.setattr(t_topk, "FALLBACK_SCORES_BUDGET", 0)
    monkeypatch.setattr(t_topk, "streaming_score_topk", spy)
    j_sharded._build_sharded_topk.cache_clear()
    try:
        m, q, mp, qp = _corpus(np.random.default_rng(120 + d_shards))
        for int8 in (False, True):
            calls.clear()
            (jv, ji), (tv, ti) = _both_topk(mp, qp, len(m), 11, d_shards, int8=int8)
            assert len(calls) == d_shards
            _same_up_to_near_ties(jv, ji, tv, ti)
    finally:
        j_sharded._build_sharded_topk.cache_clear()


@pytest.mark.parametrize("d_shards", SHARDS)
def test_sharded_subset_topk_matches_jax(d_shards):
    """The mesh pre-filter route: exact scores and the reference tie rule
    over an explicit pack-row subset, ties planted across shards, the
    padding masked by ``n_live``; the JAX package's wire."""
    from svs_tpu.engine.index import _subset_select_np

    jm, tm = _meshes(d_shards)
    rng = np.random.default_rng(130 + d_shards)
    n, d, b, k = 2048, 64, 3, 7
    m = _unit(rng, n, d)
    m[100] = m[700] = m[40]
    q = _unit(rng, b, d)
    rows = np.arange(0, n, 3, dtype=np.int64)
    emb_ids = rows * 10 + 5
    f = rows.size
    f_pad = 1 << (f - 1).bit_length()
    rows_p = np.zeros(f_pad, dtype=np.int64)
    rows_p[:f] = rows
    dev_emb = np.zeros(n, dtype=np.int32)
    dev_emb[rows] = emb_ids.astype(np.int32)
    jwire = np.asarray(j_sharded.sharded_subset_topk(
        _jax_put(m, jm, P("data", None)), _jax_put(dev_emb, jm, P(None)),
        _jax_put(rows_p.astype(np.int32), jm, P(None)), jnp.int32(f),
        _jax_put(q, jm, P(None, None)), k, mesh=jm,
    ))
    twire = t_sharded.sharded_subset_topk(
        place(m, tm), torch.from_numpy(dev_emb), torch.from_numpy(rows_p), f,
        torch.from_numpy(q), k, mesh=tm,
    ).numpy()
    np.testing.assert_array_equal(twire[:, :k], jwire[:, :k])
    got = np.ascontiguousarray(twire[:, k : 2 * k]).view(np.float32)
    want = np.ascontiguousarray(jwire[:, k : 2 * k]).view(np.float32)
    np.testing.assert_allclose(got, want, atol=NEAR_TIE, rtol=0)
    want_emb, _ = _subset_select_np(q @ m[rows].T, emb_ids, k)
    np.testing.assert_array_equal(twire[:, :k], want_emb)


def _both_pairs(m, mp, n, k, d_shards):
    jm, tm = _meshes(d_shards)
    jv, jr, jc = j_pairwise(_jax_put(mp, jm, P("data", None)), jnp.int32(n), k, mesh=jm)
    tv, tr, tc = sharded_pairwise_topk(place(mp, tm), n, k, mesh=tm)
    return (np.asarray(jv), np.asarray(jr), np.asarray(jc)), (tv.numpy(), tr.numpy(), tc.numpy())


@pytest.mark.parametrize("d_shards", SHARDS)
@pytest.mark.parametrize("n,k", [(500, 20), (1000, 7)])
def test_sharded_pairwise_matches_jax(d_shards, n, k):
    """The ring: the exact top pairs of the JAX package's ring and of the
    oracle."""
    m = _unit(np.random.default_rng(n + d_shards), n, 32)
    mp = pad_matrix(m, row_multiple=8 * 8)
    (jv, jr, jc), (tv, tr, tc) = _both_pairs(m, mp, n, k, d_shards)
    oracle = top_pairs_numpy(m @ m.T, k)
    assert list(zip(tr, tc)) == list(zip(jr, jc)) == [(r, c) for _, r, c in oracle]
    np.testing.assert_allclose(tv, jv, atol=NEAR_TIE, rtol=0)


@pytest.mark.parametrize("d_shards", SHARDS)
@pytest.mark.parametrize("exact_dupes", [False, True])
def test_sharded_pairwise_escalates_and_subblocks(d_shards, exact_dupes, monkeypatch):
    """Shards past the 256-row inner block, and a near-duplicate cluster
    past the first per-row width: the ring takes the same widths on both
    packages (the port's ``covered`` test is the reference's) and returns
    the same pairs."""
    from svs_tpu.parallel import pairwise_sharded as jps
    from svs_tpu_torch.parallel import pairwise_sharded as tps

    rng = np.random.default_rng(7)
    n, d = 4096, 16
    base = rng.standard_normal(d).astype(np.float32)
    m = np.zeros((n, d), dtype=np.float32)
    m[:200] = base[None, :] + 0.01 * rng.standard_normal((200, d))
    m[200:] = rng.standard_normal((n - 200, d))
    if exact_dupes:
        # 100 copies of one vector: 4,950 pairs tie at the top, so a row's
        # 64th pair reaches the merged 150th and the ring must widen
        m[:100] = base
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    k = 150
    widths = []
    real = tps._ring_pass

    def spy(docs, n_valid, k, per_row_k, mesh, data_axis):
        widths.append(per_row_k)
        return real(docs, n_valid, k, per_row_k, mesh, data_axis)

    j_widths = []
    j_build = jps._build

    def j_spy(mesh, data_axis, k, per_row_k, force_interp=False):
        j_widths.append(per_row_k)
        return j_build(mesh, data_axis, k, per_row_k, force_interp)

    monkeypatch.setattr(tps, "_ring_pass", spy)
    monkeypatch.setattr(jps, "_build", j_spy)
    (jv, jr, jc), (tv, tr, tc) = _both_pairs(m, m, n, k, d_shards)
    assert widths == j_widths == ([64, 150] if exact_dupes else [64])
    if exact_dupes:
        assert list(zip(tr, tc)) == list(zip(jr, jc))
    np.testing.assert_allclose(tv, jv, atol=NEAR_TIE, rtol=0)
    oracle = top_pairs_numpy(m @ m.T, k)
    np.testing.assert_allclose(tv, [s for s, _, _ in oracle], rtol=1e-5)
    sims = m @ m.T
    np.testing.assert_allclose(sims[tr, tc], tv, rtol=1e-5)
    v_k = oracle[-1][0]
    iu = np.triu_indices(n, 1)
    must = {(int(iu[0][i]), int(iu[1][i])) for i in np.nonzero(sims[iu] > v_k)[0]}
    assert must <= set(zip(tr.tolist(), tc.tolist()))
