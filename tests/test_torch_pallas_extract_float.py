"""The PyTorch port's float fused kernels (bf16 / f32 storage) against the
JAX package's Pallas kernels in interpret mode on the CPU: the plain twins
of ``_fused3_kernel``, ``_fused2_kernel`` and ``_fused_kernel`` on the same
seeded inputs.

Two kinds of input.  Lattice data (every entry ``m * 2^-7``, ``m`` an
integer in [-4, 4]) is exact in bf16 and every partial sum of a dot is an
exact f32 number, so the accumulation order cannot matter: the twins are
held bit-identical there, and the lattice's many exact ties exercise the
tie rules.  On random unit vectors the two frameworks sum in different
orders, so a score may differ in its last ulps: v1 values are held within
``TOL`` and every key within one grid step, and only where the score sits
within ``TOL`` of a grid edge.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from svs_tpu.ops import pallas_extract as J
from svs_tpu_torch.ops import pallas_extract as T
from svs_tpu_torch.ops.topk import scores_matmul

torch.set_num_threads(2)

N = 16 * T.FUSED_BLOCK_N  # 131072: nb = 16, the smallest v3 corpus
D = 128
N_VALID = N - 5000  # partial last block
#: |kernel - twin| allowed on random unit data (a few f32 ulps of a score
#: near 1, summed in another order)
TOL = 2e-6
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _rows(rng, n, kind, dtype_name):
    """``[n, D]`` f32 values exactly representable in the storage dtype."""
    if kind == "lattice":
        return (rng.integers(-4, 5, (n, D)) / 128.0).astype(np.float32)
    m = rng.standard_normal((n, D)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    if dtype_name == "bf16":
        m = m.astype(ml_dtypes.bfloat16).astype(np.float32)
    return m


@pytest.fixture(scope="module", params=["bf16", "f32"])
def dtype_name(request):
    return request.param


@pytest.fixture(scope="module", params=["lattice", "unit"])
def corpus(request, dtype_name):
    rng = np.random.default_rng(7 if request.param == "lattice" else 8)
    return request.param, _rows(rng, N, request.param, dtype_name)


@pytest.fixture(scope="module", params=[1, 8, 16])
def case(request, corpus, dtype_name):
    """One query batch (padded to 8 rows like the callers do) with every
    float kernel's JAX output, computed once per (dtype, data, batch)."""
    kind, docs = corpus
    b = request.param
    q = _rows(np.random.default_rng(100 + b), max(8, b), kind, dtype_name)
    jdt, tdt = DTYPES[dtype_name]
    args = (jnp.asarray(docs, jdt), jnp.asarray(q, jdt), jnp.int32(N_VALID))
    return {
        "kind": kind,
        "docs": torch.from_numpy(docs).to(tdt),
        "q": torch.from_numpy(q).to(tdt),
        "v3": np.asarray(J._fused3_extract(*args, interpret=True)),
        "v2": np.asarray(J._fused2_extract(*args, interpret=True)),
        "v1": tuple(np.asarray(a) for a in J._fused_extract(*args, interpret=True)),
    }


def _twin_scores(case) -> np.ndarray:
    """The twin's f32 scores with padding rows masked to -inf."""
    s = scores_matmul(case["docs"], case["q"]).numpy()
    s[:, N_VALID:] = -np.inf
    return s


def _check_keys(ref, got, scores, sub, qscale, clip=False):
    """Each key of ``ref`` within one grid step of the twin's key at the
    same position, its level matching the twin's score of the doc it names
    within ``TOL``.  ``sub`` maps each key column to its subtile's first
    doc; dead positions must agree exactly."""
    dead = got == T.KEY_DEAD
    np.testing.assert_array_equal(ref == T.KEY_DEAD, dead)
    w = float(T.GUARD_SUBTILE if clip else T.FUSED_SUBTILE)
    lv_r, lv_g = np.floor(ref / w), np.floor(got / w)
    assert np.all(np.abs(lv_r - lv_g)[~dead] <= 1)
    rows = np.broadcast_to(np.arange(ref.shape[0])[:, None], ref.shape)
    doc = np.minimum(sub[None, :] + (ref - lv_r * w).astype(np.int64), N - 1)
    s = scores[rows, doc].astype(np.float64)
    if clip:
        s = np.clip(s, -3.0, 3.0)
    x = (s + T.KEY_BIAS) * qscale
    ok = (lv_r >= np.floor(x - TOL * qscale)) & (lv_r <= np.floor(x + TOL * qscale))
    assert np.all(ok[~dead])


def test_fused3_float_twin(case):
    got = T._fused3_extract(case["docs"], case["q"], N_VALID).numpy()
    ref = case["v3"]
    assert got.shape == ref.shape
    if case["kind"] == "lattice":
        np.testing.assert_array_equal(_bits(ref), _bits(got))
        return
    b, nb = ref.shape[0], N // T.FUSED_BLOCK_N
    r3, g3 = ref.reshape(b, nb, 128), got.reshape(b, nb, 128)
    np.testing.assert_array_equal(r3[:, :, 33:], g3[:, :, 33:])
    # the guard lane is the max of its block's subtile tails, on each side
    np.testing.assert_array_equal(r3[:, :, 32], r3[:, :, 3:32:4].max(axis=2))
    np.testing.assert_array_equal(g3[:, :, 32], g3[:, :, 3:32:4].max(axis=2))
    col = np.arange(nb * 32)
    sub = (col // 32) * T.FUSED_BLOCK_N + ((col % 32) // 4) * T.GUARD_SUBTILE
    _check_keys(
        r3[:, :, :32].reshape(b, -1), g3[:, :, :32].reshape(b, -1),
        _twin_scores(case), sub, T.GUARD_QSCALE, clip=True,
    )


@pytest.fixture(scope="module", params=[64, 100])
def v3_case(request, corpus, dtype_name):
    """A v3-sized query batch, zero-padded to a multiple of 8 rows as the
    callers pad it (100 -> 104: not a multiple of the CUDA kernel's
    64-query tile), with the JAX v3 and v2 outputs (both kernels run on
    the CUDA v3 core at these batches)."""
    kind, docs = corpus
    b = request.param
    q = np.zeros((-(-b // 8) * 8, D), dtype=np.float32)
    q[:b] = _rows(np.random.default_rng(200 + b), b, kind, dtype_name)
    jdt, tdt = DTYPES[dtype_name]
    args = (jnp.asarray(docs, jdt), jnp.asarray(q, jdt), jnp.int32(N_VALID))
    return {
        "kind": kind,
        "docs": torch.from_numpy(docs).to(tdt),
        "q": torch.from_numpy(q).to(tdt),
        "v3": np.asarray(J._fused3_extract(*args, interpret=True)),
        "v2": np.asarray(J._fused2_extract(*args, interpret=True)),
    }


def test_fused3_float_twin_v3_batches(v3_case):
    test_fused3_float_twin(v3_case)


def _clip_rows(rng, n):
    """Entries m * 2^-3, m in [-2, 2], with m in {1, 2} on the row pairs
    4j, 4j + 1: all products are multiples of 2^-6 and every partial sum is
    exact (|sum| <= 8 at D = 128).  Two positive rows mostly score above
    3.0, where v3 keys pass 2^24 and the key of odd lane 4j + 1 rounds
    (to even) onto that of lane 4j."""
    m = rng.integers(-2, 3, (n, D))
    pos = rng.integers(1, 3, (n, D))
    rows = (np.arange(n) % 4 < 2)[:, None]
    return (np.where(rows, pos, m) / 8.0).astype(np.float32)


@pytest.mark.parametrize("b", [16, 64])
def test_fused3_clipped_colliding_keys_bit_identical(b):
    """Scores clipped at 3.0 key past 2^24, where key + lane rounds to even
    and equal keys of one subtile all clear in one round: the twin keeps
    the reference's clear-every-equal bit for bit."""
    rng = np.random.default_rng(300 + b)
    docs = _clip_rows(rng, N)
    q = _clip_rows(rng, b)
    ref = np.asarray(
        J._fused3_extract(jnp.asarray(docs), jnp.asarray(q), jnp.int32(N_VALID),
                          interpret=True)
    )
    got = T._fused3_extract(torch.from_numpy(docs), torch.from_numpy(q), N_VALID).numpy()
    np.testing.assert_array_equal(_bits(ref), _bits(got))
    # the input does collide: some subtile holds two equal live keys
    scores = np.clip(q @ docs.T, -3.0, 3.0).reshape(b, -1, T.GUARD_SUBTILE)
    lane = np.arange(T.GUARD_SUBTILE, dtype=np.float32)
    keys = (np.floor((scores + np.float32(T.KEY_BIAS)) * np.float32(T.GUARD_QSCALE))
            * np.float32(T.GUARD_SUBTILE) + lane).astype(np.float32)
    live = (np.arange(N) < N_VALID).reshape(1, -1, T.GUARD_SUBTILE)
    keys = np.sort(np.where(live, keys, T.KEY_DEAD), axis=2)
    same = (keys[:, :, 1:] == keys[:, :, :-1]) & (keys[:, :, 1:] > T.KEY_DEAD)
    assert same.any(axis=2).sum() > 0
    # and the top-4 of a subtile repeats no key (one copy of each value)
    top = ref.reshape(b, -1, 128)[:, :, :32].reshape(b, -1, T.GUARD_H)
    live_top = top[top[:, :, 0] > 2.0**24]
    assert len(live_top) > 0
    assert np.all(np.diff(live_top, axis=1) < 0)


def test_fused2_float_twin(case):
    got = T._fused2_extract(case["docs"], case["q"], N_VALID).numpy()
    ref = case["v2"]
    assert got.shape == ref.shape
    if case["kind"] == "lattice":
        np.testing.assert_array_equal(_bits(ref), _bits(got))
        return
    sub = (np.arange(ref.shape[1]) // T.EXTRACT_H) * T.FUSED_SUBTILE
    _check_keys(ref, got, _twin_scores(case), sub, T.KEY_QSCALE)


def test_fused2_float_twin_v3_batches(v3_case):
    test_fused2_float_twin(v3_case)


def test_fused_v1_float_twin(case):
    vals, idx = (a.numpy() for a in T._fused_extract(case["docs"], case["q"], N_VALID))
    rv, ri = case["v1"]
    if case["kind"] == "lattice":
        np.testing.assert_array_equal(_bits(rv), _bits(vals))
        np.testing.assert_array_equal(_bits(ri), _bits(idx))
        return
    # position by position: values within TOL, and the row the reference
    # names scores (in the twin) within TOL of the twin's value there
    finite = np.isfinite(rv)
    np.testing.assert_array_equal(finite, np.isfinite(vals))
    assert np.all(np.abs(rv[finite] - vals[finite]) <= TOL)
    scores = _twin_scores(case)
    at_ref = np.take_along_axis(scores, ri.astype(np.int64), axis=1)
    assert np.all(np.abs(at_ref[finite] - vals[finite]) <= TOL)
    np.testing.assert_array_equal(ri[~finite], idx[~finite])
