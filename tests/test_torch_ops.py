"""Parity of the PyTorch port's plain ops with the JAX package on the CPU:
int8 quantization, the packed prescore wire, and the final tie-rule
selection — all bit-identical on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svs_tpu.ops import topk as jtopk
from svs_tpu.ops.quant import quantize_rows_int8 as j_quantize
from svs_tpu_torch.ops import topk as ttopk
from svs_tpu_torch.ops.quant import quantize_rows_int8 as t_quantize

torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _quant_inputs() -> np.ndarray:
    rng = np.random.default_rng(7)
    rows = [rng.standard_normal((32, 96)).astype(np.float32)]
    # exact .5 ties: absmax 127 -> scale 1.0, so x / scale lands on .5
    ties = np.zeros((4, 96), dtype=np.float32)
    ties[:, 0] = 127.0
    ties[:, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    rows.append(ties)
    rows.append(np.zeros((3, 96), dtype=np.float32))  # zero rows: 1e-30 floor
    # the +-127 clip bound: both signs of the row max land on it
    big = rng.uniform(-1, 1, (16, 96)).astype(np.float32)
    big[:, 5] = np.float32(3.0000002)
    big[:, 6] = -np.float32(3.0000002)
    rows.append(big)
    rows.append((rng.standard_normal((8, 96)) * 1e-20).astype(np.float32))
    return np.concatenate(rows, axis=0)


def test_quantize_rows_int8_bit_identical():
    m = _quant_inputs()
    jq, js = j_quantize(jnp.asarray(m))
    tq, ts = t_quantize(torch.from_numpy(m))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(_bits(js), _bits(ts.numpy()))
    # the tie rows really exercise round-half-to-even
    assert list(tq.numpy()[32, 1:7]) == [0, 2, 2, 0, -2, -2]
    assert np.abs(tq.numpy()).max() == 127


def test_quantize_host_pack_matches_device_quantizer():
    """The port's host quantizer (engine.packing.quantize_int8) and its
    device one agree bit for bit, padding included."""
    from svs_tpu_torch.engine.packing import quantize_int8

    m = _quant_inputs()
    hq, hs = quantize_int8(m, 128, 128)
    tq, ts = t_quantize(torch.from_numpy(m))
    n, d = m.shape
    np.testing.assert_array_equal(hq[:n, :d], tq.numpy())
    np.testing.assert_array_equal(_bits(hs[:n]), _bits(ts.numpy()))
    assert not hq[n:].any() and not hq[:, d:].any()
    zero_scale = np.float32(1e-30) / np.float32(127.0)
    assert (hs[n:] == zero_scale).all()


@pytest.mark.parametrize("wide", [False, True])
def test_pack_vals_idx_and_unpack_rows_tail(wide):
    rng = np.random.default_rng(3)
    vals = np.sort(rng.standard_normal((5, 40)).astype(np.float32), axis=1)[:, ::-1]
    vals = np.ascontiguousarray(vals)
    vals[0, -1] = -0.0
    idx = rng.integers(0, 1 << 20, (5, 40)).astype(np.int32)
    jp = np.asarray(jtopk.pack_vals_idx(jnp.asarray(vals), jnp.asarray(idx), wide=wide))
    tp = ttopk.pack_vals_idx(torch.from_numpy(vals), torch.from_numpy(idx), wide=wide)
    assert jp.dtype == tp.numpy().dtype
    np.testing.assert_array_equal(_bits(jp), _bits(tp.numpy()))
    jr, jt = jtopk.unpack_rows_tail(jnp.asarray(jp), 40, wide)
    tr, tt = ttopk.unpack_rows_tail(tp, 40, wide)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    jv, jrows = jtopk.unpack_vals_idx(jp, 40, wide=wide)
    tv, trows = ttopk.unpack_vals_idx(tp, 40, wide=wide)
    np.testing.assert_array_equal(_bits(jv), _bits(tv))
    np.testing.assert_array_equal(jrows, trows)


def test_final_select_wire_ties_and_negative_zero():
    rng = np.random.default_rng(11)
    b, c, k = 6, 64, 17
    # a coarse grid of scores forces many exact ties, plus +-0.0 ties
    exact = (rng.integers(-4, 5, (b, c)) / 8.0).astype(np.float32)
    exact[0, :10] = 0.0
    exact[0, 10:20] = -0.0
    exact[1, :] = 0.25  # every candidate tied
    emb_of = np.stack(
        [rng.permutation(10_000)[:c] for _ in range(b)]
    ).astype(np.int32)
    tail = rng.integers(-(1 << 30), 1 << 30, (b, 1)).astype(np.int32)
    jw = np.asarray(
        jtopk.final_select_wire(
            jnp.asarray(exact), jnp.asarray(emb_of), jnp.asarray(tail), k
        )
    )
    tw = ttopk.final_select_wire(
        torch.from_numpy(exact), torch.from_numpy(emb_of), torch.from_numpy(tail), k
    ).numpy()
    assert tw.shape == (b, 2 * k + 1) and tw.dtype == np.int32
    np.testing.assert_array_equal(jw, tw)
    # reference rule on the all-tied row: the k largest emb ids, descending
    assert list(tw[1, :k]) == sorted(emb_of[1], reverse=True)[:k]


def test_masked_topk_ties_to_smaller_index():
    rng = np.random.default_rng(5)
    scores = (rng.integers(0, 6, (4, 300)) / 4.0).astype(np.float32)
    jv, ji = jtopk.masked_topk(jnp.asarray(scores), 50, jnp.int32(290))
    tv, ti = ttopk.masked_topk(torch.from_numpy(scores), 50, 290)
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("int8", [False, True])
def test_streaming_score_topk_matches_reference(int8):
    rng = np.random.default_rng(9)
    n, d, k = 4096, 64, 40
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = m[[3, 77, 2000]] + 0.01
    if int8:
        jd, js = j_quantize(jnp.asarray(m))
        docs_j, rs_j = jd, js
        docs_t = torch.from_numpy(np.asarray(jd).copy())
        rs_t = torch.from_numpy(np.asarray(js).copy())
    else:
        docs_j, rs_j = jnp.asarray(m), None
        docs_t, rs_t = torch.from_numpy(m), None
    jv, ji = jtopk.streaming_score_topk(
        docs_j, jnp.asarray(q), jnp.int32(n - 100), k, row_scales=rs_j,
        max_block_rows=1024,
    )
    tv, ti = ttopk.streaming_score_topk(
        docs_t, torch.from_numpy(q), n - 100, k, row_scales=rs_t,
        max_block_rows=1024,
    )
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    if int8:  # int32 sums: exact on both sides
        np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    else:  # f32 dots: accumulation order differs between XLA and torch
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=0, atol=2e-6)
