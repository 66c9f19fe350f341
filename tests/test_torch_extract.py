"""The PyTorch port's two-pass extraction (``_extract``) and the float
ladder's finishes against the JAX package on the CPU (Pallas kernels in
interpret mode), on the same seeded inputs: bit-identical outputs, rows,
values and bounds, including exact ties, all -inf rows, masked tails and
the coverage checks that trip the exact fallback."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svs_tpu.ops import pallas_extract as J
from svs_tpu.ops import quant as jquant
from svs_tpu.ops.quant import quantize_rows_int8 as j_quantize
from svs_tpu_torch.ops import pallas_extract as T
from svs_tpu_torch.ops import quant as tquant

torch.set_num_threads(2)

D = 128


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _lattice(rng, n) -> np.ndarray:
    """Entries m * 2^-7, m in [-4, 4]: exact in bf16, every dot exact in f32."""
    return (rng.integers(-4, 5, (n, D)) / 128.0).astype(np.float32)


def test_extract_twin_bit_identical():
    """[16, 32768]: random rows, a row of exact ties on a coarse grid, a
    row that is all -inf, a row with five live columns, and a masked tail
    (the last 3000 columns at -inf, as ``mask_cols`` leaves them)."""
    rng = np.random.default_rng(21)
    s = rng.standard_normal((16, 32768)).astype(np.float32)
    s[2] = np.round(s[2] * 2.0) / 2.0
    s[3] = -np.inf
    s[5, 5:] = -np.inf
    s[:, 32768 - 3000 :] = -np.inf
    jv, ji = J._extract(jnp.asarray(s), interpret=True)
    tv, ti = T._extract(torch.from_numpy(s))
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(_bits(ji), _bits(ti.numpy()))
    # an all -inf subtile names its highest column on every round
    assert set(ti.numpy()[3, :8]) == {1023.0}


def _few_values(rng):
    """Four distinct values (no zero, so no -0.0 / +0.0 tie at a max): the
    highest-index rule decides most rounds."""
    return (rng.integers(1, 5, (16, 32768)) / 4.0).astype(np.float32)


def _neg_inf_rows_and_subtiles(rng):
    """Whole rows -inf, every third subtile -inf, a row of eleven live
    entries, on random scores."""
    s = rng.standard_normal((16, 32768)).astype(np.float32)
    s[:2] = -np.inf
    s.reshape(16, -1, 1024)[2:, ::3] = -np.inf
    keep = s[3, ::3001].copy()
    s[3] = -np.inf
    s[3, ::3001] = keep
    return s


def _pair_block_on_grid(rng):
    """The exact pairwise pass's input: the strict upper triangle of a unit
    corpus's pair scores, -inf elsewhere, rounded to a 1/8 grid (ties)."""
    m = rng.standard_normal((32768, 32)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    rows = np.arange(32768 - 16, 32768)
    s = m[rows] @ m.T
    s = np.round(s * 8.0) / 8.0 + np.float32(0.0)  # no -0.0: the port emits a zero max as +0.0
    return np.where(np.arange(32768)[None, :] > rows[:, None], s, -np.inf).astype(np.float32)


@pytest.mark.parametrize(
    "make", [_few_values, _neg_inf_rows_and_subtiles, _pair_block_on_grid],
    ids=["few_values", "neg_inf_rows_and_subtiles", "pair_block_on_grid"],
)
def test_extract_plain_adversarial_bit_identical(make):
    """The card's oracle, ``_extract_plain``, against the JAX kernel in
    interpret mode on the inputs the redesigned kernel is held to."""
    s = make(np.random.default_rng(23))
    jv, ji = J._extract(jnp.asarray(s), interpret=True)
    tv, ti = T._extract_plain(torch.from_numpy(s))
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(_bits(ji), _bits(ti.numpy()))


def test_extract_zero_max_is_positive_zero():
    """A subtile whose max is zero emits +0.0 whatever the signs of the
    zeros it ties (the kernel makes the same canonical zero), at the
    reference's columns: the highest among the equal zeros first."""
    s = np.full((8, T.BLOCK_N), -np.inf, dtype=np.float32)
    s[:, :4] = -0.0
    s[:4, 2] = 0.0
    jv, ji = J._extract(jnp.asarray(s), interpret=True)
    tv, ti = T._extract(torch.from_numpy(s))
    np.testing.assert_array_equal(_bits(ji), _bits(ti.numpy()))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())  # -0.0 == +0.0
    assert (_bits(tv.numpy()[:, :4]) == 0).all()
    np.testing.assert_array_equal(ti.numpy()[:, :8], [[3, 2, 1, 0] + [1023] * 4] * 8)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_score_topk_extract_packed_matches(dtype):
    """Float scoring + ``_extract`` + verified merge + packing on a lattice
    corpus (bf16 or f32 docs), so the scores are exact on both sides."""
    rng = np.random.default_rng(22)
    n, b, k, n_valid = 32768, 16, 40, 32768 - 1000
    docs, q = _lattice(rng, n), _lattice(rng, b)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ref = np.asarray(
        J.score_topk_extract_packed(
            jnp.asarray(docs, jdt), jnp.asarray(q), jnp.int32(n_valid), k,
            interpret=True,
        )
    )
    got = T.score_topk_extract_packed(_t(docs).to(tdt), _t(q), n_valid, k).numpy()
    np.testing.assert_array_equal(_bits(ref), _bits(got))


def test_extract_refuses_non_f32_scores():
    """``_extract`` selects over an f32 score matrix only."""
    with pytest.raises(ValueError, match="f32"):
        T._extract(torch.zeros((8, T.BLOCK_N), dtype=torch.bfloat16))


def test_score_topk_int8_extract_packed_b264():
    """The int8 route for batches above FUSED_MAX_BATCH: B = 264 (a
    multiple of 8) over a masked tail.  Rows are identical.  Values agree
    within a few ulps, not bit for bit: under ``jit`` XLA on the CPU
    rewrites the query scale's ``/ 127.0`` into a multiply by the
    reciprocal, which moves some scales (and their row's scores) by an
    ulp; the port divides as the source is written."""
    rng = np.random.default_rng(23)
    n, b, k, n_valid = 32768, 264, 30, 32768 - 2500
    m = rng.standard_normal((n, D)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    docs, rs = (np.asarray(a) for a in j_quantize(jnp.asarray(m)))
    q = m[rng.integers(0, n_valid, b)] + 0.05 * rng.standard_normal((b, D)).astype(np.float32)
    ref = np.asarray(
        jquant.score_topk_int8_extract_packed(
            jnp.asarray(docs), jnp.asarray(rs), jnp.asarray(q), jnp.int32(n_valid),
            k, interpret=True,
        )
    )
    got = tquant.score_topk_int8_extract_packed(
        _t(docs), _t(rs), _t(q), n_valid, k
    ).numpy()
    assert got.shape == (b, 2 * k)
    np.testing.assert_array_equal(ref[:, k:], got[:, k:])
    np.testing.assert_allclose(ref[:, :k], got[:, :k], rtol=0, atol=1e-6)
    assert (got[:, k:] < n_valid).all()


def test_fused3_candidates_float_matches():
    """Float v3 candidates on a bf16 lattice corpus of 16 blocks (the
    smallest guarded corpus): rows, quantized values and bound."""
    rng = np.random.default_rng(24)
    n, b, c, n_valid = 16 * T.FUSED_BLOCK_N, 16, 200, 16 * T.FUSED_BLOCK_N - 7000
    docs, q = _lattice(rng, n), _lattice(rng, b)
    jv, jr, jb = J.fused3_candidates(
        jnp.asarray(docs, jnp.bfloat16), jnp.asarray(q), jnp.int32(n_valid), c,
        interpret=True,
    )
    tv, tr, tb = T.fused3_candidates(_t(docs).to(torch.bfloat16), _t(q), n_valid, c)
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(_bits(jb), _bits(tb.numpy()))


E2E_N = 4 * T.FUSED_BLOCK_N
E2E_K = 40
def _both(name, docs, q, n_valid, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ref = np.asarray(
        getattr(J, name)(
            jnp.asarray(docs, jdt), jnp.asarray(q), jnp.int32(n_valid), E2E_K,
            interpret=True,
        )
    )
    got = getattr(T, name)(_t(docs).to(tdt), _t(q), n_valid, E2E_K).numpy()
    return ref, got


def _hot_corpus(hot_rows, hot):
    """Background docs orthogonal to the query plus a cluster of hot ones;
    every score is a single product, exact in bf16 and f32."""
    m = np.zeros((E2E_N, D), dtype=np.float32)
    m[:, 1] = 1.0
    m[hot_rows, 0] = hot
    m[hot_rows, 1] = 0.5
    q = np.zeros((1, D), dtype=np.float32)
    q[0, 0] = 1.0
    return m, q


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_fused_float_level1_hidden_trips_exact_fallback(dtype):
    """v1: more than EXTRACT_H winners in ONE 512-doc subtile, so the
    coverage check trips and both packages return the exact top-k."""
    rows = 100 + np.arange(48)
    m, q = _hot_corpus(rows, (1.0 - np.arange(48) / 64.0).astype(np.float32))
    ref, got = _both("score_topk_fused_packed", m, q, E2E_N, dtype)
    np.testing.assert_array_equal(_bits(ref), _bits(got))
    assert set(got[0, E2E_K:].astype(int)) <= set(rows)


def test_fused_float_lattice_end_to_end():
    """v1 end to end (kernel, merge, packing) on a bf16 lattice corpus with
    a partial last block: no fallback, same bits.  (v2 end to end runs in
    the KB tests.)"""
    rng = np.random.default_rng(25)
    m, q = _lattice(rng, E2E_N), _lattice(rng, 3)
    ref, got = _both("score_topk_fused_packed", m, q, E2E_N - 3000, "bf16")
    np.testing.assert_array_equal(_bits(ref), _bits(got))
    assert (got[:, E2E_K:] < E2E_N - 3000).all()


def test_fused2_topk_float_level2_trips_exact_fallback():
    """Winners concentrated in one block but at most 7 per subtile: only
    the pass-2 group tail sees them hidden (``fused2_topk`` unpacked)."""
    rows = np.asarray([s * 512 + i for s in range(6) for i in range(7)])
    m, q = _hot_corpus(rows, (1.0 - np.arange(len(rows)) / 64.0).astype(np.float32))
    assert E2E_K > T._reduce_h2(E2E_N, E2E_K)
    jv, ji = J.fused2_topk(
        jnp.asarray(m, jnp.bfloat16), jnp.asarray(q), jnp.int32(E2E_N), E2E_K,
        interpret=True,
    )
    tv, ti = T.fused2_topk(_t(m).to(torch.bfloat16), _t(q), E2E_N, E2E_K)
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert set(ti.numpy()[0]) == set(rows[:E2E_K])
