"""The PyTorch port's plain kernel twins and finishes against the JAX
package's Pallas kernels (interpret mode on the CPU), on the same seeded
inputs: the four int8 main-path kernels, the v3 staged finish, and the
v2/v1 paths end to end including their exact-fallback trips.

Everything is bit-identical except one named case: XLA on the CPU
contracts the v2 emit's ``(acc * rs) * qs + KEY_BIAS`` into a fused
multiply-add (the Pallas source writes two products and an add), so a
score sitting on a 2^-13 grid edge can key one step apart.  The port's
twin and CUDA kernel round every step as the source is written; the test
proves each mismatch is exactly that contraction and nothing else.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svs_tpu.ops import pallas_extract as J
from svs_tpu.ops.quant import quantize_rows_int8 as j_quantize
from svs_tpu_torch.ops import pallas_extract as T
from svs_tpu_torch.ops.quant import quantize_rows_int8 as t_quantize

torch.set_num_threads(2)

N = 16 * T.FUSED_BLOCK_N  # 131072: nb = 16, the smallest v3 corpus
D = 128
N_VALID = N - 5000  # partial last block


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(2024)
    m = rng.standard_normal((N, D)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    docs, rs = j_quantize(jnp.asarray(m))
    return np.asarray(docs), np.asarray(rs), rng


@pytest.fixture(scope="module", params=[1, 8, 16])
def batch(request, corpus):
    """One query batch (padded to 8 rows like the callers do) with every
    kernel's JAX output, computed once per batch size."""
    docs, rs, _ = corpus
    b = request.param
    rng = np.random.default_rng(b)
    q = rng.standard_normal((max(8, b), D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qi, qs = j_quantize(jnp.asarray(q))
    args = (jnp.asarray(docs), jnp.asarray(rs), qi, qs, jnp.int32(N_VALID))
    out = {
        "q": q,
        "qi": np.asarray(qi),
        "qs": np.asarray(qs),
        "v3": np.asarray(J._fused3_extract_int8(*args, interpret=True)),
        "v2": np.asarray(J._fused2_extract_int8(*args, interpret=True)),
        "v1": tuple(
            np.asarray(a) for a in J._fused_extract_int8(*args, interpret=True)
        ),
    }
    return out


def _torch_args(corpus, batch):
    docs, rs, _ = corpus
    return (_t(docs), _t(rs), _t(batch["qi"]), _t(batch["qs"]), N_VALID)


def test_query_quantization_matches(batch):
    tq, ts = t_quantize(torch.from_numpy(batch["q"]))
    np.testing.assert_array_equal(batch["qi"], tq.numpy())
    np.testing.assert_array_equal(_bits(batch["qs"]), _bits(ts.numpy()))


def test_fused3_kernel_twin_bit_identical(corpus, batch):
    got = T._fused3_extract_int8(*_torch_args(corpus, batch)).numpy()
    assert got.shape == batch["v3"].shape
    np.testing.assert_array_equal(_bits(batch["v3"]), _bits(got))


@pytest.fixture(scope="module", params=[64, 100])
def v3_batch(request, corpus):
    """A v3-sized query batch, zero-padded to a multiple of 8 rows as the
    callers pad it (100 -> 104: not a multiple of the CUDA kernel's
    64-query tile), with the JAX v3 and v2 outputs (both kernels run on
    the CUDA v3 core at these batches)."""
    docs, rs, _ = corpus
    b = request.param
    rng = np.random.default_rng(1000 + b)
    q = np.zeros((-(-b // 8) * 8, D), dtype=np.float32)
    q[:b] = rng.standard_normal((b, D))
    q[:b] /= np.linalg.norm(q[:b], axis=1, keepdims=True)
    qi, qs = j_quantize(jnp.asarray(q))
    args = (jnp.asarray(docs), jnp.asarray(rs), qi, qs, jnp.int32(N_VALID))
    return {
        "qi": np.asarray(qi),
        "qs": np.asarray(qs),
        "v3": np.asarray(J._fused3_extract_int8(*args, interpret=True)),
        "v2": np.asarray(J._fused2_extract_int8(*args, interpret=True)),
    }


def test_fused3_kernel_twin_bit_identical_v3_batches(corpus, v3_batch):
    got = T._fused3_extract_int8(*_torch_args(corpus, v3_batch)).numpy()
    assert got.shape == v3_batch["v3"].shape
    np.testing.assert_array_equal(_bits(v3_batch["v3"]), _bits(got))


def _v2_subtile_keys(docs, rs, qi_row, qs_row, sub, fused):
    """Top-8 v2 keys of one 512-doc subtile, emulated in NumPy with the
    emit either as written (two rounded products, then the add) or
    contracted into a fused multiply-add (exact product, one rounding)."""
    lanes = T.FUSED_SUBTILE
    rows = np.arange(sub * lanes, (sub + 1) * lanes)
    acc = (docs[rows].astype(np.int64) @ qi_row.astype(np.int64)).astype(np.float32)
    prod = (acc * rs[rows]).astype(np.float32)
    if fused:
        t = (prod.astype(np.float64) * np.float64(qs_row) + 1.0625).astype(np.float32)
    else:
        t = (prod * qs_row).astype(np.float32) + np.float32(1.0625)
    keys = np.floor(t * np.float32(8192.0)) * lanes + np.arange(lanes)
    keys = np.where(rows < N_VALID, keys, T.KEY_DEAD).astype(np.float32)
    return np.sort(keys)[::-1][: T.EXTRACT_H]


def _check_fused2_but_xla_fma(corpus, batch, max_subtiles):
    """The v2 twin against the reference: bit-identical except in at most
    ``max_subtiles`` subtiles, each explained by XLA's FMA contraction."""
    docs, rs, _ = corpus
    ref = batch["v2"]
    got = T._fused2_extract_int8(*_torch_args(corpus, batch)).numpy()
    assert got.shape == ref.shape
    subtiles = sorted(
        {tuple(x) for x in np.argwhere(_bits(ref) != _bits(got)) // [1, T.EXTRACT_H]}
    )
    assert len(subtiles) <= max_subtiles, f"{len(subtiles)} subtiles differ"
    for row, sub in subtiles:
        cols = slice(sub * T.EXTRACT_H, (sub + 1) * T.EXTRACT_H)
        args = (docs, rs, batch["qi"][row], batch["qs"][row], sub)
        np.testing.assert_array_equal(ref[row, cols], _v2_subtile_keys(*args, fused=True))
        np.testing.assert_array_equal(got[row, cols], _v2_subtile_keys(*args, fused=False))


def test_fused2_kernel_twin_bit_identical_but_xla_fma(corpus, batch):
    """Bit-identical except in subtiles where XLA contracted the emit into
    an FMA.  There, a NumPy emulation of the FMA reproduces the reference
    exactly and the as-written emulation reproduces the port: the only
    difference is that contraction."""
    _check_fused2_but_xla_fma(corpus, batch, 4)


def test_fused2_kernel_twin_bit_identical_but_xla_fma_v3_batches(corpus, v3_batch):
    """The same at the batches where the CUDA kernel runs on the v3 core
    (up to 4 differing subtiles per 16 query rows, as at B = 16)."""
    _check_fused2_but_xla_fma(corpus, v3_batch, 4 * -(-v3_batch["qi"].shape[0] // 16))


def test_fused_v1_kernel_twin_bit_identical(corpus, batch):
    vals, idx = T._fused_extract_int8(*_torch_args(corpus, batch))
    np.testing.assert_array_equal(_bits(batch["v1"][0]), _bits(vals.numpy()))
    np.testing.assert_array_equal(_bits(batch["v1"][1]), _bits(idx.numpy()))


def test_reduce_keys_twin_bit_identical(batch):
    keys = batch["v2"]
    ref = np.asarray(J._reduce_keys(jnp.asarray(keys), 8, interpret=True))
    got = T._reduce_keys_plain(_t(keys), 8).numpy()
    np.testing.assert_array_equal(_bits(ref), _bits(got))


@pytest.mark.parametrize("b_real", [16, 5])
def test_fused3_staged_finish_matches(b_real):
    """The staged v3 finish (nb >= GUARD_STAGE_MIN_BLOCKS) on a synthetic
    key array: rows, vals and bound bit-identical."""
    rng = np.random.default_rng(b_real)
    b, nb, c = 16, 96, 40
    h2 = T._guard_reduce_h2(nb, c)
    assert nb >= T.GUARD_STAGE_MIN_BLOCKS and h2 <= 48  # staged path
    out = np.full((b, nb, 128), T.KEY_DEAD, dtype=np.float32)
    for s in range(T.GUARD_NSUB):
        lanes = np.stack(
            [rng.choice(T.GUARD_SUBTILE, T.GUARD_H, replace=False)
             for _ in range(b * nb)]
        ).reshape(b, nb, T.GUARD_H)
        # a coarse score grid makes cross-group key ties likely
        q = rng.integers(-400, 400, (b, nb, T.GUARD_H)).astype(np.float32)
        keys = (q + 4352.0) * T.GUARD_SUBTILE + lanes
        out[:, :, s * 4 : s * 4 + 4] = -np.sort(-keys, axis=2)
    out[:, :, 32] = out[:, :, 3:32:4].max(axis=2)
    out = out.reshape(b, nb * 128)
    jv, jr, jb = J._fused3_finish(jnp.asarray(out), c, b_real, interpret=True)
    tv, tr, tb = T._fused3_finish(torch.from_numpy(out), c, b_real)
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(_bits(jb), _bits(tb.numpy()))


E2E_N = 4 * T.FUSED_BLOCK_N
E2E_K = 40
E2E_PATHS = ["score_topk_fused2_int8_packed", "score_topk_fused_int8_packed"]


def _hot_corpus(hot_rows, hot):
    """Background docs orthogonal to the query plus a cluster of hot ones
    (the reference tests' adversarial layout)."""
    m = np.zeros((E2E_N, D), dtype=np.float32)
    m[:, 1] = 1.0
    m[hot_rows, 0] = hot
    m[hot_rows, 1] = np.sqrt(1.0 - hot**2)
    q = np.zeros((1, D), dtype=np.float32)
    q[0, 0] = 1.0
    docs, rs = j_quantize(jnp.asarray(m))
    return np.asarray(docs), np.asarray(rs), q


def _both_packed(name, docs, rs, q, n_valid):
    """One query through a packed path of both packages.  Every call has
    the same shapes and k, so the reference compiles each path once."""
    ref = np.asarray(
        getattr(J, name)(
            jnp.asarray(docs), jnp.asarray(rs), jnp.asarray(q),
            jnp.int32(n_valid), E2E_K, interpret=True,
        )
    )
    got = getattr(T, name)(_t(docs), _t(rs), _t(q), n_valid, E2E_K).numpy()
    return ref, got


@pytest.mark.parametrize("name", E2E_PATHS)
def test_level1_hidden_trips_exact_fallback(name):
    """More than EXTRACT_H winners in ONE 512-doc subtile: the coverage
    check trips and both packages return the exact int8 top-k."""
    rows = 100 + np.arange(48)
    docs, rs, q = _hot_corpus(rows, np.linspace(0.99, 0.9, 48).astype(np.float32))
    ref, got = _both_packed(name, docs, rs, q, E2E_N)
    np.testing.assert_array_equal(_bits(ref), _bits(got))
    assert set(got[0, E2E_K:].astype(int)) <= set(rows)


def test_fused2_level2_hidden_trips_exact_fallback():
    """Winners concentrated in one block but at most 7 per subtile: only
    the pass-2 group tail can see them hidden."""
    rows = np.asarray([s * 512 + i for s in range(6) for i in range(7)])
    hot = np.linspace(0.99, 0.8, len(rows)).astype(np.float32)
    docs, rs, q = _hot_corpus(rows, hot)
    assert E2E_K > T._reduce_h2(E2E_N, E2E_K)
    assert T.fused2_supported(E2E_N, D, 1, E2E_K)
    ref, got = _both_packed("score_topk_fused2_int8_packed", docs, rs, q, E2E_N)
    np.testing.assert_array_equal(_bits(ref), _bits(got))
    assert set(got[0, E2E_K:].astype(int)) == set(rows[:E2E_K])


@pytest.mark.parametrize("name", E2E_PATHS)
def test_random_corpus_end_to_end(name):
    """v2 and v1 end to end (kernel, finish, merge, packing) on random
    unit vectors with a partial last block: no fallback, same bits."""
    rng = np.random.default_rng(31)
    m = rng.standard_normal((E2E_N, D)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    docs, rs = (np.asarray(a) for a in j_quantize(jnp.asarray(m)))
    q = m[[777]] * 0.6 + m[[4321]] * 0.8
    q /= np.linalg.norm(q)
    n_valid = E2E_N - 3000
    ref, got = _both_packed(name, docs, rs, q, n_valid)
    np.testing.assert_array_equal(_bits(ref), _bits(got))
    assert (got[:, E2E_K:] < n_valid).all()
