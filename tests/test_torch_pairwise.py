"""The PyTorch port's pairwise slice at op level against the JAX package on
the CPU (Pallas kernels in interpret mode), on the same seeded inputs: the
pair-key kernel's twin bit for bit, the keyed candidate pass identical on
int8 and lattice data and sound on random data, the exact blocked pass
identical except near-ties, and the dispatch predicates at the headline
shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svs_tpu.ops import pairwise as jpw
from svs_tpu.ops import pallas_extract as JP
from svs_tpu_torch.engine.packing import quantize_int8
from svs_tpu_torch.ops import pairwise as tpw
from svs_tpu_torch.ops import pallas_extract as TP
from svs_tpu_torch.utils.topk_np import top_k_numpy, top_pairs_numpy

torch.set_num_threads(2)

#: f32 dots summed in another order by XLA and by torch differ by a few
#: ulps of a unit-norm score: pairs whose scores lie closer than this may
#: trade places, and values agree within it.
NEAR_TIE = 1e-6


def _unit_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _lattice_rows(n, d, seed):
    """Entries m * 2^-7, |m| <= 4: exact in bf16, every dot exact in f32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (n, d)) / 128.0).astype(np.float32)


def _padded(m, n_pad):
    out = np.zeros((n_pad, m.shape[1]), np.float32)
    out[: len(m)] = m
    return out


def _pack(m, n_pad, precision):
    """The same pack for both packages: ``(jax operands, torch operands)``,
    each ``(docs, row_scales or None)``."""
    if precision == "int8":
        data, scales = quantize_int8(m, n_pad, m.shape[1])
        return (
            (jnp.asarray(data), jnp.asarray(scales)),
            (torch.from_numpy(data), torch.from_numpy(scales)),
        )
    docs = _padded(m, n_pad)
    if precision == "bf16":
        return (
            (jnp.asarray(docs, dtype=jnp.bfloat16), None),
            (torch.from_numpy(docs).to(torch.bfloat16), None),
        )
    return (jnp.asarray(docs), None), (torch.from_numpy(docs), None)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _assert_same_pairs(ref, got, tol=NEAR_TIE):
    """``(vals, rows, cols)`` of both packages: values within ``tol``, and
    the same pair at every rank except where its reference score lies
    within ``tol`` of another returned score (a near-tie)."""
    rv, rr, rc = (np.asarray(a) for a in ref)
    gv, gr, gc = (np.asarray(a) for a in got)
    assert rv.shape == gv.shape
    np.testing.assert_allclose(gv, rv, rtol=0, atol=tol)
    for j in np.nonzero((rr != gr) | (rc != gc))[0]:
        others = np.delete(rv, j)
        assert np.min(np.abs(others - rv[j])) < tol, (j, rv[j])


# --- the pair-key kernel ------------------------------------------------------


def _pair_block(r, n, seed):
    """A real pair-score block: the last r rows of a unit corpus against all
    n, masked to the strict upper triangle with PAIR_MASKED (so its early
    subtiles are fully masked)."""
    m = _unit_rows(n, 32, seed)
    s = m[n - r :] @ m.T
    iu = np.arange(n)[None, :] > np.arange(n - r, n)[:, None]
    return np.where(iu, s, np.float32(JP.PAIR_MASKED)).astype(np.float32)


def _random_block(r, n, seed):
    """Uniform scores in [-1, 1) with subtile 1 fully masked, as the
    reference's own kernel test has them."""
    rng = np.random.default_rng(seed)
    s = (rng.random((r, n)) * 2.0 - 1.0).astype(np.float32)
    s[:, 512:1024] = JP.PAIR_MASKED
    return s


@pytest.mark.parametrize(
    "make, r, n",
    [(_random_block, 8, 8192), (_pair_block, 256, 4096)],
    ids=["random_8x8192", "pairs_256x4096"],
)
def test_pairwise_keys_extract_twin_bit_identical(make, r, n):
    scores = make(r, n, 3)
    want = np.asarray(JP.pairwise_keys_extract(jnp.asarray(scores), interpret=True))
    got = TP.pairwise_keys_extract(torch.from_numpy(scores)).numpy()
    assert got.shape == (r, (n // 4096) * 128)
    assert _bits(got) == _bits(want)
    # the key oracle, the KEY_DEAD lanes and the sentinel decode
    lane = np.arange(512, dtype=np.float32)
    tiles = got.reshape(r, n // 4096, 128)
    assert (tiles[:, :, 64:] == TP.KEY_DEAD).all()
    for s in range(n // 512):
        sub = scores[:, s * 512 : (s + 1) * 512]
        keys = (
            np.floor((sub + np.float32(1.0625)) * np.float32(8192.0))
            * np.float32(512.0)
            + lane
        ).astype(np.float32)
        oracle = -np.sort(-keys, axis=1)[:, :8]
        blk, sb = divmod(s, 8)
        np.testing.assert_array_equal(tiles[:, blk, sb * 8 : sb * 8 + 8], oracle)
    masked = scores == np.float32(TP.PAIR_MASKED)
    full = masked.reshape(r, n // 512, 512).all(axis=2)  # fully masked subtiles
    dec = TP._key_vals(torch.from_numpy(tiles[:, :, :64].reshape(r, -1))).numpy()
    dec = dec.reshape(r, n // 512, 8)
    assert full.any() and (dec[full] == TP.PAIR_MASKED).all()


def _few_values_block(r, n, seed):
    """Five distinct scores: every subtile's keys share a few levels, so
    the lane bits decide the order."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, 3, (r, n)) / 8.0).astype(np.float32)


def _masked_block(r, n, seed):
    """A pair block with whole rows and every third subtile at PAIR_MASKED."""
    s = _pair_block(r, n, seed)
    s[:2] = JP.PAIR_MASKED
    s.reshape(r, -1, 512)[2:, ::3] = JP.PAIR_MASKED
    return s


def _past_horizon_block(r, n, seed):
    """Scores above 2.94: keys of 2^24 and more lose lane bits and collide,
    so a round clears several entries at once; half the rows on a 1/16
    grid collide more."""
    s = np.abs(_random_block(r, n, seed)) + np.float32(2.95)
    s[: r // 2] = np.round(s[: r // 2] * 16.0) / 16.0
    return s.astype(np.float32)


@pytest.mark.parametrize(
    "make", [_few_values_block, _masked_block, _past_horizon_block],
    ids=["few_values", "masked_rows_and_subtiles", "past_key_horizon"],
)
def test_pair_keys_plain_adversarial_bit_identical(make):
    """The card's oracle, ``_pair_keys_plain``, against the JAX kernel in
    interpret mode on the inputs the redesigned kernel is held to."""
    scores = make(16, 8192, 4)
    want = np.asarray(JP.pairwise_keys_extract(jnp.asarray(scores), interpret=True))
    got = TP._pair_keys_plain(torch.from_numpy(scores)).numpy()
    assert _bits(got) == _bits(want)
    if make is _past_horizon_block:
        lane = np.arange(512, dtype=np.float32)
        sub = scores.reshape(16, -1, 512)
        keys = np.floor((sub + np.float32(1.0625)) * np.float32(8192.0)) * np.float32(512.0) + lane
        keys = np.sort(keys.astype(np.float32), axis=2)
        assert (keys[:, :, 1:] == keys[:, :, :-1]).any()  # collisions happen


@pytest.mark.parametrize(
    "shape, dtype",
    [
        ((12, 4096), torch.float32),
        ((8, 4000), torch.float32),
        ((264, 4096), torch.float32),
        ((0, 4096), torch.float32),
        ((8, 4096), torch.float64),
    ],
    ids=["rows_not_8", "cols_not_4096", "rows_over_256", "no_rows", "f64"],
)
def test_pairwise_keys_extract_refuses_bad_input(shape, dtype):
    with pytest.raises(ValueError):
        TP.pairwise_keys_extract(torch.zeros(shape, dtype=dtype))
    assert TP.pair_keys_supported(shape[1], shape[0]) == JP.pair_keys_supported(
        shape[1], shape[0]
    )


# --- the keyed candidate pass ---------------------------------------------------


@pytest.mark.parametrize("kind", ["int8_unit", "f32_lattice"])
def test_pairwise_candidates_keyed_identical(kind):
    """n_pad 4096, 500 docs, d 32, c 50: int8 products are exact integers
    and lattice dots exact f32 sums, so both packages give the same bits."""
    n_pad, n_valid, d, c = 4096, 500, 32, 50
    if kind == "int8_unit":
        jops, tops = _pack(_unit_rows(n_valid, d, 11), n_pad, "int8")
    else:
        jops, tops = _pack(_lattice_rows(n_valid, d, 12), n_pad, "f32")
    assert tpw.keyed_pairwise_route(n_pad, 256, c)
    want = jpw.pairwise_candidates_keyed(
        jops[0], jnp.int32(n_valid), c, block_rows=256, row_scales=jops[1]
    )
    got = tpw.pairwise_candidates_keyed(
        tops[0], n_valid, c, block_rows=256, row_scales=tops[1]
    )
    assert want[3] and got[3]
    for w, g in zip(want[:3], got[:3]):
        assert g.dtype in (torch.float32, torch.int32)
        assert _bits(g.numpy()) == _bits(w)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_pairwise_candidates_keyed_soundness(precision):
    """The contract ``_finalize_pairwise`` stands on, on the port's own
    output (random unit rows): every pair left out scores at most
    ``vals[-1] + KEY_EPS`` in the prescore domain, candidates are unique
    upper-triangle pairs, and each decodes within KEY_EPS of its score."""
    n_pad, n_valid, d, c = 4096, 500, 32, 50
    m = _unit_rows(n_valid, d, 13)
    _, (docs, scales) = _pack(m, n_pad, precision)
    if precision == "int8":
        dq = docs.numpy().astype(np.float32) * scales.numpy()[:, None]
        S = dq[:n_valid] @ dq[:n_valid].T
    else:
        S = m @ m.T
    vals, rows, cols, ok = tpw.pairwise_candidates_keyed(
        docs, n_valid, c, block_rows=256, row_scales=scales
    )
    assert ok
    vals, rows, cols = (t.numpy() for t in (vals, rows, cols))
    assert (cols > rows).all() and (cols < n_valid).all() and (rows >= 0).all()
    pairs = set(zip(rows.tolist(), cols.tolist()))
    assert len(pairs) == c
    iu = np.triu_indices(n_valid, 1)
    hidden = np.ones(len(iu[0]), bool)
    pos = {(int(a), int(b)): i for i, (a, b) in enumerate(zip(*iu))}
    for p in pairs:
        hidden[pos[p]] = False
    # 1e-5: the f32 product's associativity slack, as the reference's test
    assert S[iu][hidden].max() <= vals[-1] + TP.KEY_EPS + 1e-5
    exact = S[rows[: c - 1], cols[: c - 1]]
    np.testing.assert_array_less(exact - vals[: c - 1], TP.KEY_EPS + 1e-5)
    np.testing.assert_array_less(vals[: c - 1] - exact, TP.KEY_EPS + 1e-5)


def _keyed_ok(docs_np, n_valid, c):
    jd = jnp.asarray(docs_np)
    td = torch.from_numpy(docs_np)
    j_ok = jpw.pairwise_candidates_keyed(jd, jnp.int32(n_valid), c, block_rows=256)[3]
    t_ok = tpw.pairwise_candidates_keyed(td, n_valid, c, block_rows=256)[3]
    assert j_ok == t_ok
    return t_ok


def test_pairwise_candidates_keyed_not_ok_when_pool_starved():
    """3 docs hold 3 pairs; 10 candidates asked: not ok in both packages."""
    assert not _keyed_ok(_padded(_unit_rows(3, 16, 14), 4096), 3, 10)


def test_pairwise_candidates_keyed_not_ok_past_key_horizon():
    """A pair dotting at 4.0 is past the key horizon: not ok; the same
    shape at unit norm is ok."""
    m = _unit_rows(64, 16, 15) * 2.0
    m[0] = m[1] = 0.0
    m[0, 0] = m[1, 0] = 2.0
    assert not _keyed_ok(_padded(m, 4096), 64, 10)
    assert _keyed_ok(_padded(m / 2.0, 4096), 64, 10)


# --- the exact blocked pass -----------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_pairwise_topk_blocked_matches_jax(precision, monkeypatch):
    """A 512-row pack (not extraction-aligned: per-row top-k on both
    sides), k = 300: the same pairs except near-ties."""
    monkeypatch.setattr(jpw, "_FORCE_EXTRACT_INTERPRET", True)
    n_pad, n_valid, d, k = 512, 480, 32, 300
    jops, tops = _pack(_unit_rows(n_valid, d, 16), n_pad, precision)
    want = jpw.pairwise_topk_blocked(
        jops[0], jnp.int32(n_valid), k, block_rows=256, row_scales=jops[1]
    )
    got = tpw.pairwise_topk_blocked(
        tops[0], n_valid, k, block_rows=256, row_scales=tops[1]
    )
    if precision == "int8":  # exact integer products, the same rescale
        assert all(_bits(g.numpy()) == _bits(w) for w, g in zip(want, got))
    _assert_same_pairs(want, got)


def test_select_rows_topm_extraction_matches_jax(monkeypatch):
    """The per-row selection on the extraction route, with the reference's
    interpret-mode hook: a [256, 16384] block at m = 64 and an [8, 9000]
    block (padded to 16384 with -inf) at m = 9 — identical bits."""
    monkeypatch.setattr(jpw, "_FORCE_EXTRACT_INTERPRET", True)
    rng = np.random.default_rng(17)
    for rows, n, m in ((256, 16384, 64), (8, 9000, 9)):
        assert tpw.extraction_route_chosen(n, rows, m)
        s = (rng.random((rows, n)) * 2.0 - 1.0).astype(np.float32)
        s[3, : n // 2] = -np.inf  # a row half masked, as the triangle leaves it
        jv, ji = jpw.select_rows_topm(jnp.asarray(s), m)
        tv, ti = tpw.select_rows_topm(torch.from_numpy(s), m)
        assert _bits(tv.numpy()) == _bits(jv)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_pairwise_topk_blocked_extraction_route(monkeypatch):
    """A 16384-row pack (600 live rows) runs its per-row selection through
    ``extract_topk``; the result is the brute-force top-k, and the padding
    row blocks are skipped."""
    calls = []
    real = TP.extract_topk

    def spy(scores, m):
        calls.append(scores.shape)
        return real(scores, m)

    monkeypatch.setattr(TP, "extract_topk", spy)
    m = _unit_rows(600, 16, 18)
    docs = torch.from_numpy(_padded(m, 16384))
    vals, rows, cols = tpw.pairwise_topk_blocked(docs, 600, 100)
    assert calls == [(256, 16384)] * 3
    oracle = top_pairs_numpy(m @ m.T, 100)
    _assert_same_pairs(
        (
            [v for v, _, _ in oracle],
            [r for _, r, _ in oracle],
            [c for _, _, c in oracle],
        ),
        (vals.numpy(), rows.numpy(), cols.numpy()),
    )


def test_pairwise_hoarded_ties_match_jax():
    """The reference's dedup shape of ``tests/test_ops.py`` (one doc
    near-duplicated 512 times, k = 200): exact ties abound, so the checks
    are that test's own tie-insensitive ones, with the JAX values."""
    rng = np.random.default_rng(3)
    n, d, k = 512, 16, 200
    base = rng.standard_normal(d).astype(np.float32)
    m = base[None, :] + 0.001 * rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    vals, rows, cols = tpw.pairwise_topk_blocked(torch.from_numpy(m), n, k)
    jv, _, _ = jpw.pairwise_topk_blocked(jnp.asarray(m), jnp.int32(n), k)
    vals, rows, cols = vals.numpy(), rows.numpy(), cols.numpy()
    np.testing.assert_allclose(vals, np.asarray(jv), rtol=0, atol=NEAR_TIE)
    sims = m @ m.T
    iu = np.triu_indices(n, 1)
    flat = sims[iu]
    oracle = top_k_numpy(flat, k)
    np.testing.assert_allclose(vals, [s for s, _ in oracle], rtol=0, atol=NEAR_TIE)
    np.testing.assert_allclose(sims[rows, cols], vals, rtol=1e-6)
    got_pairs = set(zip(rows.tolist(), cols.tolist()))
    v_k = oracle[-1][0]
    must_have = {
        (int(iu[0][i]), int(iu[1][i])) for i in np.nonzero(flat > v_k + NEAR_TIE)[0]
    }
    assert must_have <= got_pairs


def test_pairwise_escalates_when_a_row_hoards_winners(monkeypatch):
    """A hub doc with 100 satellites (hub-satellite pairs ~0.89, satellite
    pairs ~0.8), k = 200: the hub's 64th best beats the 200th pair, so the
    tail check fails at m = 64 and the pass escalates to m = k, in both
    packages; the result is identical to the reference's."""
    rng = np.random.default_rng(4)
    n, d, k = 512, 32, 200
    m = rng.standard_normal((n, d)).astype(np.float32)
    noise = rng.standard_normal((100, d)).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    m[1:101] = m[0] / np.linalg.norm(m[0]) + 0.5 * noise
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    attempts = []
    real = tpw._pairwise_attempt

    def spy(*args):
        out = real(*args)
        attempts.append((args[3], bool(out[3])))
        return out

    monkeypatch.setattr(tpw, "_pairwise_attempt", spy)
    got = tpw.pairwise_topk_blocked(torch.from_numpy(m), n, k)
    assert attempts == [(64, False), (200, True)]
    want = jpw.pairwise_topk_blocked(jnp.asarray(m), jnp.int32(n), k)
    _assert_same_pairs(want, tuple(t.numpy() for t in got))
    oracle = top_pairs_numpy(m @ m.T, k)
    np.testing.assert_allclose(
        got[0].numpy(), [v for v, _, _ in oracle], rtol=0, atol=NEAR_TIE
    )


def test_pairwise_huge_k_skips_too_narrow_widths():
    """k = 40,000 > 512 x 64: only the exact-by-construction width runs."""
    n, k = 512, 40_000
    assert tpw.escalation_widths(k, n, n) == jpw.escalation_widths(k, n, n) == [n]
    m = _unit_rows(n, 8, 19)
    vals, rows, cols = tpw.pairwise_topk_blocked(torch.from_numpy(m), n, k)
    oracle = top_pairs_numpy(m @ m.T, k)
    np.testing.assert_allclose(vals.numpy(), [s for s, _, _ in oracle], rtol=1e-5)
    assert len(set(zip(rows.tolist(), cols.tolist()))) == k
    assert (cols > rows).all()


# --- dispatch predicates ----------------------------------------------------------


def test_routes_pinned_at_headline_shapes():
    """The reference's answers at the headline shapes: 100k docs pad to
    114,688 rows; c 12,500 / 50,000 route keyed at widths 64 / 512 and
    200,000 does not; 1M-row packs; escalation and extraction routing."""
    n_100k = 114_688
    for n_pad in (n_100k, 1 << 20, 4096, 512):
        for c in (1, 12_500, 50_000, 65_536, 200_000):
            assert tpw.keyed_pairwise_route(n_pad, 256, c) == jpw.keyed_pairwise_route(
                n_pad, 256, c
            ), (n_pad, c)
            assert tpw.keyed_row_width(c, n_pad) == jpw.keyed_row_width(c, n_pad)
        for k in (10, 10_000, 40_000, 1 << 20):
            assert tpw.escalation_widths(k, n_pad, n_pad) == jpw.escalation_widths(
                k, n_pad, n_pad
            )
        for m in (9, 64, 1024, 10_000):
            assert tpw.extraction_route_chosen(n_pad, 256, m) == (
                jpw.extraction_route_chosen(n_pad, 256, m)
            )
    assert tpw.keyed_pairwise_route(n_100k, 256, 12_500)
    assert tpw.keyed_row_width(12_500, n_100k) == 64
    assert tpw.keyed_pairwise_route(n_100k, 256, 50_000)
    assert tpw.keyed_row_width(50_000, n_100k) == 512
    assert not tpw.keyed_pairwise_route(n_100k, 256, 200_000)
    assert tpw.escalation_widths(10_000, n_100k, n_100k) == [64, 1024, 10_000]
    assert tpw.extraction_route_chosen(n_100k, 256, 64)
    assert not tpw.extraction_route_chosen(n_100k, 256, 1024)
