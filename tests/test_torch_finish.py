"""The staged finish of the PyTorch port (``_staged_finish``: pass 2, the
top-C merge in ``lax.top_k`` order and the decode, one CUDA launch on the
card) against the JAX package's ``_fused2_finish`` / ``_fused3_finish``
with ``_reduce_keys`` in interpret mode, on seeded numpy keys: v2 and v3
staged, B in {1, 8, 64}, h2 in {24, 40}, on random keys, on keys that tie
across groups, on dead-padded rows where C is larger than the live keys,
and on rows past the key horizon (v3: saturated).  Bit for bit, including
``covered`` and ``bound``.

A plain model of the kernel's own selection (order keys, composites with
a 16-bit column field, or 32-bit past 65,536 winners, a radix select of
the C-th, the survivors sorted) is held bit for bit against the plain
version on the same inputs, at both field widths: the CPU proof that the
kernel's route to ``lax.top_k`` order is that order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svs_tpu.ops import pallas_extract as J
from svs_tpu_torch.ops import pallas_extract as T

torch.set_num_threads(2)

#: v2 width: 24 blocks of 128 key lanes (l1 = 3,072, padded to 4,096).
V2_BLOCKS = 24
#: v3: the smallest staged corpus (l1 = 3,072 guarded keys, padded).
V3_BLOCKS = T.GUARD_STAGE_MIN_BLOCKS
#: C per h2: the v3 sizing rule gives h2 = 24 at C = 100, 40 at C = 300.
C_OF_H2 = {24: 100, 40: 300}
DATA = ["random", "ties", "dead", "horizon"]


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.int32)


def _subtile_keys(rng, q, lanes_per, h):
    """Descending keys ``q * lanes_per + lane`` with distinct lanes per
    subtile; ``q`` is ``[..., h]``."""
    lanes = np.argsort(rng.random(q.shape[:-1] + (lanes_per,)), axis=-1)[..., :h]
    keys = q.astype(np.float32) * np.float32(lanes_per) + lanes.astype(np.float32)
    return -np.sort(-keys, axis=-1)


def _scores(rng, shape, data):
    if data == "ties":
        return rng.integers(-3, 4, shape).astype(np.float32) / 16.0
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def _v2_keys(b, data, seed):
    """``[b, V2_BLOCKS * 128]`` v2 keys: per 512-doc subtile its top-8
    keys ``floor((s + KEY_BIAS) * 8192) * 512 + lane``."""
    rng = np.random.default_rng(seed)
    t = V2_BLOCKS * 16
    s = _scores(rng, (b, t, T.EXTRACT_H), data)
    if data == "ties":  # every block the same: equal level-2 keys in every group
        s = np.broadcast_to(s[:, None, :16], (b, V2_BLOCKS, 16, T.EXTRACT_H)).reshape(s.shape)
    if data == "horizon":
        s[0, 5] += 3.5  # keys past 2^24 - 512 in row 0: the domain guard trips
    q = np.floor((s + np.float32(1.0625)) * np.float32(8192.0))
    keys = _subtile_keys(rng, q, T.FUSED_SUBTILE, T.EXTRACT_H)
    if data == "dead":  # 5 live subtiles: 40 live keys, fewer than C
        keys[:, 5:] = T.KEY_DEAD
    return np.ascontiguousarray(keys.reshape(b, t * T.EXTRACT_H), dtype=np.float32)


def _v3_out(b, data, seed):
    """``[b, V3_BLOCKS * 128]`` v3 tiles: per 1024-doc subtile its top-4
    keys ``floor((clip(s) + KEY_BIAS) * 4096) * 1024 + lane``, the guard
    lane (max subtile tail), KEY_DEAD elsewhere."""
    rng = np.random.default_rng(seed)
    nb = V3_BLOCKS
    s = _scores(rng, (b, nb, T.GUARD_NSUB, T.GUARD_H), data)
    if data == "ties":
        s = np.broadcast_to(s[:, :1], s.shape).copy()
    if data == "horizon":
        s[0, 7] = 3.0  # clipped at 3: keys past 2^24 (saturated, colliding re-keys)
        s[0, 8] = 2.6
    q = np.floor((np.clip(s, -3.0, 3.0) + np.float32(1.0625)) * np.float32(4096.0))
    keys = _subtile_keys(rng, q, T.GUARD_SUBTILE, T.GUARD_H)
    if data == "dead":  # 3 live blocks: 96 live keys, fewer than C
        keys[:, 3:] = T.KEY_DEAD
    out = np.full((b, nb, 128), T.KEY_DEAD, dtype=np.float32)
    out[:, :, : T.GUARD_KEYS] = keys.reshape(b, nb, T.GUARD_KEYS)
    out[:, :, T.GUARD_KEYS] = keys[..., -1].max(axis=2)
    return out.reshape(b, nb * 128)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("h2", [24, 40])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_v2_finish_matches_jax(b, h2, data):
    keys1 = _v2_keys(b, data, seed=b * 100 + h2)
    k = C_OF_H2[h2]
    b_real = max(1, b - 3)
    jv, ji, jc = J._fused2_finish(jnp.asarray(keys1), k, h2, b_real, True)
    tv, ti, tc = T._fused2_finish(torch.from_numpy(keys1), k, h2, b_real)
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert tc == bool(jc)
    if data in ("horizon", "dead"):
        assert not tc


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("h2", [24, 40])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_v3_staged_finish_matches_jax(b, h2, data):
    out = _v3_out(b, data, seed=b * 100 + h2 + 1)
    c = C_OF_H2[h2]
    assert T._guard_reduce_h2(V3_BLOCKS, c) == h2
    jv, jr, jb = J._fused3_finish(jnp.asarray(out), c, b, interpret=True)
    tv, tr, tb = T._fused3_finish(torch.from_numpy(out), c, b)
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(_bits(jb), _bits(tb.numpy()))
    if data in ("horizon", "dead"):
        assert np.isinf(tb.numpy()[0])


# --- a plain model of the kernel's selection --------------------------------


def _order_key(x):
    b = np.asarray(x, dtype=np.float32).view(np.int32).astype(np.int64)
    b = np.where(b == -(2**31), 0, b)
    return np.where(b < 0, b ^ 0x7FFFFFFF, b)


def _order_value(o):
    b = np.where(o < 0, o ^ 0x7FFFFFFF, o)
    return (b & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _key_val(key, v3):
    q = np.trunc(key.astype(np.float64)).astype(np.int64) >> (10 if v3 else 9)
    return (
        q.astype(np.float32) / np.float32(4096.0 if v3 else 8192.0)
    ).astype(np.float32) - np.float32(1.0625)


def _shr(x, s):
    """``x >> s`` on uint64, 0 for ``s >= 64`` (as the kernel's ``shr``)."""
    return x >> np.uint64(s) if s < 64 else np.zeros_like(x)


def _kernel_model(src, v3, c, h2, cb=None):
    """``csrc/reduce_keys.cu`` step by step in numpy: per row, pass 2 on
    order keys (clear every entry equal to the round's max), composites
    ``(order key ^ 2^31) << cb | 2^cb - 1 - column``, a radix select of the
    C-th composite by 8-bit digits from the first byte in which two
    winners differ, the C at or above it sorted descending, the decode
    and the row's flags or bound.  ``cb`` is the kernel's choice (16 up to
    65,536 winners, else 32) unless given."""
    b, width = src.shape
    nb = width // 128
    l1 = nb * 32 if v3 else width
    groups = -(-l1 // 2048) * 16
    if cb is None:
        cb = 32 if groups * h2 > 65536 else 16
    cmask = np.uint64((1 << cb) - 1)
    j = np.arange(groups * 128)
    if v3:
        at = np.minimum((j >> 5) * 128 + (j & 31), width - 1)
        pad = np.float32(T.KEY_DEAD)
    else:
        at, pad = np.minimum(j, width - 1), np.float32(0.0)
    dead_key = int(_order_key(np.float32(T.KEY_DEAD)))
    vals = np.empty((b, c), np.float32)
    idx = np.empty((b, c), np.int32)
    aux = np.empty((b,), np.float32 if v3 else np.int32)
    for r in range(b):
        x = np.where(j < l1, src[r, at], pad).astype(np.float32)
        rk = (np.floor(x * np.float32(1 / 128)) * np.float32(128)).astype(np.float32)
        o = _order_key(rk + (j % 128).astype(np.float32)).reshape(groups, 128)
        keys2 = np.empty((groups, h2), np.int64)
        for h in range(h2):
            mm = o.max(axis=1)
            keys2[:, h] = mm
            o = np.where(o == mm[:, None], dead_key, o)
        flat = keys2.reshape(-1).astype(np.uint64)
        comp = (((flat & np.uint64(0xFFFFFFFF)) ^ np.uint64(0x80000000)) << np.uint64(cb)) | (
            cmask - np.arange(len(flat), dtype=np.uint64)
        )
        # the radix starts at the byte of the highest bit in which two
        # winners' order keys differ; the bytes above are common to all
        u = (flat & np.uint64(0xFFFFFFFF)).astype(np.int64)
        w_and = int(np.bitwise_and.reduce(u))
        diff = w_and ^ int(np.bitwise_or.reduce(u))
        top_bit = cb + diff.bit_length() - 1 if diff else cb - 1
        first_shift = top_bit // 8 * 8
        prefix, remaining = ((w_and ^ 0x80000000) << cb) >> (first_shift + 8), c
        for shift in range(first_shift, -1, -8):
            match = _shr(comp, shift + 8) == np.uint64(prefix)
            hist = np.bincount(
                ((comp[match] >> np.uint64(shift)) & np.uint64(255)).astype(np.int64),
                minlength=256,
            )
            above = np.cumsum(hist[::-1])  # counts of digits 255, 254, ...
            t = int(np.argmax(above >= remaining))
            remaining -= int(above[t] - hist[255 - t])
            prefix = (prefix << 8) | (255 - t)
        sel = np.sort(comp[comp >= np.uint64(prefix)])[::-1]
        assert len(sel) == c
        col = (cmask - (sel & cmask)).astype(np.int64)
        u = (sel >> np.uint64(cb)).astype(np.int64) ^ 0x80000000
        k2 = _order_value(np.where(u >= 2**31, u - 2**32, u))
        k2i = np.trunc(k2.astype(np.float64)).astype(np.int64)
        pos = (col // h2) * 128 + (k2i & 127)
        k1i = np.trunc(x[pos].astype(np.float64)).astype(np.int64)
        vals[r] = _key_val(k2, v3)
        tail2 = _order_value(keys2[:, h2 - 1].max())
        if v3:
            jb, s = pos >> 5, (pos & 31) >> 2
            idx[r] = np.minimum(jb * 8192 + s * 1024 + (k1i & 1023), nb * 8192 - 1)
            guard = src[r, np.arange(nb) * 128 + 32].max()
            bound = max(_key_val(np.float32(guard), True), vals[r, -1])
            bound = max(bound, _key_val(np.float32(tail2), True))
            refuse = x[:l1].max() >= np.float32(14942208.0) or np.float32(k1i.min()) <= T.KEY_DEAD
            aux[r] = np.inf if refuse else bound
        else:
            jb, s = pos >> 7, (pos & 127) >> 3
            idx[r] = jb * 8192 + s * 512 + (k1i & 511)
            thr = vals[r, -1] - np.float32(2.0**-12)
            real = x[:l1]
            hidden = (
                _key_val(real[7::8].max(), False) > thr or _key_val(np.float32(tail2), False) > thr
            )
            live = np.where(real == np.float32(T.KEY_DEAD), np.float32(0), real)
            bad = not (real.max() < T.KEY_HORIZON and live.min() > -T.KEY_HORIZON)
            aux[r] = int(hidden) | (2 if bad else 0)
    return vals, idx, aux


@pytest.mark.parametrize("cb", [16, 32])
@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("h2", [24, 40])
@pytest.mark.parametrize("v3", [False, True], ids=["v2", "v3"])
def test_kernel_selection_model_matches_plain(v3, h2, data, cb):
    src = (_v3_out if v3 else _v2_keys)(4, data, seed=h2 + 7)
    c = C_OF_H2[h2]
    ref = [t.numpy() for t in T._staged_finish_plain(torch.from_numpy(src), v3, c, h2)]
    got = _kernel_model(src, v3, c, h2, cb)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.view(np.int32), r.astype(g.dtype).view(np.int32))
