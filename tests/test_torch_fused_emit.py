"""A plain model of the chunked selection of the CUDA v3 core
(``select_chunk`` in ``svs_tpu_torch/csrc/fused_emit.cuh``), held bit for
bit against the one-shot emits of the port's plain versions.

The core walks its 1024 docs in chunks of 256.  Per chunk and query row it
takes the chunk's top-H distinct keys by max-then-clear-every-equal,
stopping at the first max that is not above the running H-th key, and
merges them with the running top-H of the subtile's earlier chunks, one
copy of each value.  v2 (``_fused2_*``, mode 2) keeps the top-8 of a
512-doc subtile over 2 chunks, v3 (``_fused3_*``, mode 3) the top-4 of a
1024-doc subtile over 4.  That equals the reference's H rounds over the
whole subtile: the H largest distinct values of a union are the H largest
distinct values of the union of its parts' top-H lists.  This is the CPU
proof of the kernel's selection argument, on random scores, on lattice
scores (equal key levels, the lane decides), on scores past 2^24 whose
keys collide (key + lane rounds to even), and on partial subtiles (dead
lanes).

v1 (``_fused_*``, mode 1, ``select_chunk_v1``) keeps the top-8 (value,
row) of a 512-doc subtile over its 2 chunks under the order (value
descending, row descending): the highest row wins a tie inside a chunk,
the second chunk's entry wins one across chunks, its rounds stop at the
first max strictly below the running 8th or at the first -inf, and the
last chunk names the subtile's last row beside every -inf.  Held bit for
bit against the one-shot emits of ``_fused_extract_int8_plain`` and
``_fused_extract_plain``, and against ``svs_tpu``'s
``_fused_extract_int8`` in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svs_tpu.ops import pallas_extract as J
from svs_tpu_torch.ops import pallas_extract as T
from svs_tpu_torch.ops.quant import quantize_rows_int8

torch.set_num_threads(2)

B = 4
N = 2 * T.FUSED_BLOCK_N  # 16,384 docs: 32 v2 subtiles, 16 v3 subtiles
CHUNK = 256  # fused3.cuh kChunkDocs


def _pop(lists: torch.Tensor) -> torch.Tensor:
    dead = lists.new_full(lists.shape[:-1] + (1,), T.KEY_DEAD)
    return torch.cat([lists[..., 1:], dead], dim=-1)


def _merge(run: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """Two descending lists of H keys -> the H largest distinct values of
    both, one copy of each (the kernel's merge, pop by pop)."""
    out = []
    for _ in range(run.shape[-1]):
        x = torch.maximum(run[..., 0], top[..., 0])
        out.append(x)
        run = torch.where((run[..., 0] == x)[..., None], _pop(run), run)
        top = torch.where((top[..., 0] == x)[..., None], _pop(top), top)
    return torch.stack(out, dim=-1)


def chunked_select(keys: torch.Tensor, h: int) -> torch.Tensor:
    """``keys [..., S]`` (one subtile per row) -> its top-``h`` keys,
    selected chunk by chunk as the CUDA v3 core selects them."""
    run = keys.new_full(keys.shape[:-1] + (h,), T.KEY_DEAD)
    for c0 in range(0, keys.shape[-1], CHUNK):
        v = keys[..., c0 : c0 + CHUNK]
        top = torch.full_like(run, T.KEY_DEAD)
        done = torch.zeros(keys.shape[:-1], dtype=torch.bool)
        for r in range(h):
            m = v.amax(dim=-1)
            done = done | (m <= run[..., -1])  # the early stop
            top[..., r] = torch.where(done, T.KEY_DEAD, m)
            v = torch.where((v == m[..., None]) & ~done[..., None], T.KEY_DEAD, v)
        run = _merge(run, top)
    return run


def _keys(scores: torch.Tensor, n_valid: int, v3: bool) -> torch.Tensor:
    """Every doc's packed key ``[B, subtiles, lanes]`` as the one-shot
    emits compute it (v3 clips), dead lanes at KEY_DEAD."""
    w = T.GUARD_SUBTILE if v3 else T.FUSED_SUBTILE
    qscale = T.GUARD_QSCALE if v3 else T.KEY_QSCALE
    s = torch.clamp(scores, -3.0, 3.0) if v3 else scores
    lane = torch.arange(w).to(torch.float32)
    keys = torch.floor((s.view(B, -1, w) + T.KEY_BIAS) * qscale) * float(w) + lane
    live = T._live_lanes(N, w, n_valid, scores.device)
    return torch.where(lane < live[:, None], keys, T.KEY_DEAD)


def _scores(kind: str, rng: np.random.Generator) -> torch.Tensor:
    if kind == "random":  # dots of random unit vectors
        q = rng.standard_normal((B, 64))
        d = rng.standard_normal((N, 64))
        s = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
            d / np.linalg.norm(d, axis=1, keepdims=True)
        ).T
    elif kind == "lattice":  # few levels: equal key levels in every subtile
        s = rng.integers(-4, 5, (B, N)) / 8.0
    elif kind == "past_2_24":  # keys of 2^24 and more: lanes collide
        s = 2.95 + rng.random((B, N))
    elif kind == "past_2_24_grid":  # many equal keys per subtile
        s = 2.95 + np.round(rng.random((B, N)) * 16.0) / 16.0
    else:  # "chunk_edge": equal keys on both sides of a chunk boundary
        s = rng.random((B, N)) - 0.5
        # lanes 255 and 256 of every 512: past 2^24 key + 255 rounds (to
        # even) onto key + 256, so the two chunks' lists share their head
        s.reshape(B, -1, 512)[:, :, 255:257] = 3.5
    return torch.from_numpy(np.asarray(s, dtype=np.float32))


KINDS = ["random", "lattice", "past_2_24", "past_2_24_grid", "chunk_edge"]


@pytest.mark.parametrize("n_valid", [N, N - 3000])
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_top8_merge_equals_v2_emit(kind, n_valid):
    scores = _scores(kind, np.random.default_rng(len(kind)))
    keys = _keys(scores, n_valid, v3=False)
    if kind != "random" and kind != "lattice":
        # the case is real: some subtile holds two equal live keys
        srt = keys.sort(dim=-1).values
        assert bool(((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] > T.KEY_DEAD)).any())
    got = chunked_select(keys, T.EXTRACT_H).reshape(B, -1)
    ref = T._v2_emit(scores, n_valid)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_top4_merge_equals_v3_emit(kind):
    n_valid = N - 3000
    scores = _scores(kind, np.random.default_rng(10 + len(kind)))
    got = chunked_select(_keys(scores, n_valid, v3=True), T.GUARD_H)
    ref = T._v3_emit(scores, n_valid).view(B, -1, 128)[:, :, : T.GUARD_KEYS]
    assert torch.equal(
        got.reshape(B, -1).view(torch.int32), ref.reshape(B, -1).view(torch.int32)
    )


def test_early_stop_fires():
    """The model's early stop is exercised: on random scores the second
    chunk of about half the v2 subtiles holds fewer than 8 keys above the
    first chunk's 8th, so its rounds stop early."""
    keys = _keys(_scores("random", np.random.default_rng(5)), N, v3=False)
    first = chunked_select(keys[..., :CHUNK], T.EXTRACT_H)
    second = keys[..., CHUNK:]
    above = (second > first[..., -1:]).sum(dim=-1)
    assert float((above < T.EXTRACT_H).float().mean()) > 0.3


# --- v1: values and rows -----------------------------------------------------

NEG_INF = float("-inf")


def _pop_v1(v: torch.Tensor, r: torch.Tensor) -> tuple:
    return (torch.cat([v[..., 1:], torch.full_like(v[..., :1], NEG_INF)], dim=-1),
            torch.cat([r[..., 1:], r[..., -1:]], dim=-1))


def _merge_v1(tv, tr, rv, rr) -> tuple:
    """The top-H of two descending (value, row) lists, head by head, on
    equal values the chunk's (``tv``) first (the kernel's merge)."""
    mv, mr = [], []
    for _ in range(tv.shape[-1]):
        from_chunk = tv[..., 0] >= rv[..., 0]
        mv.append(torch.where(from_chunk, tv[..., 0], rv[..., 0]))
        mr.append(torch.where(from_chunk, tr[..., 0], rr[..., 0]))
        ptv, ptr = _pop_v1(tv, tr)
        prv, prr = _pop_v1(rv, rr)
        tv = torch.where(from_chunk[..., None], ptv, tv)
        tr = torch.where(from_chunk[..., None], ptr, tr)
        rv = torch.where(from_chunk[..., None], rv, prv)
        rr = torch.where(from_chunk[..., None], rr, prr)
    return torch.stack(mv, dim=-1), torch.stack(mr, dim=-1)


def chunked_select_v1(scores: torch.Tensor, n_valid: int) -> tuple:
    """``scores [B, N]`` -> ``(values, rows as f32, early)``, each output
    ``[B, (N/512)*8]``: the top-8 (value, row) of every 512-doc subtile,
    selected chunk by chunk as the CUDA v3 core's ``select_chunk_v1``
    selects them; ``early`` counts the (query, subtile) pairs whose second
    chunk stopped on a max below the running 8th."""
    b, n = scores.shape
    t, h = n // T.FUSED_SUBTILE, T.EXTRACT_H
    rows = torch.arange(n).view(1, t, T.FUSED_SUBTILE).expand(b, t, T.FUSED_SUBTILE)
    s = torch.where(rows < n_valid, scores.view(b, t, T.FUSED_SUBTILE), NEG_INF)
    rv = torch.full((b, t, h), NEG_INF)
    rr = torch.zeros((b, t, h), dtype=torch.int64)
    early = 0
    for c0 in range(0, T.FUSED_SUBTILE, CHUNK):
        v = s[..., c0 : c0 + CHUNK]
        r = rows[..., c0 : c0 + CHUNK]
        floor = rv[..., -1]
        tv, tr = torch.full_like(rv, NEG_INF), torch.zeros_like(rr)
        done = torch.zeros((b, t), dtype=torch.bool)
        for k in range(h):
            m = v.amax(dim=-1)
            stop = (m < floor) & (m > NEG_INF) & ~done
            if c0:
                early += int(stop.sum())
            done = done | stop | (m == NEG_INF)
            p = torch.where(v == m[..., None], r, -1).amax(dim=-1)  # highest row
            tv[..., k] = torch.where(done, NEG_INF, m)
            tr[..., k] = torch.where(done, 0, p)
            v = torch.where((r == p[..., None]) & ~done[..., None], NEG_INF, v)
        # a first chunk's list is the merged one
        rv, rr = (tv, tr) if c0 == 0 else _merge_v1(tv, tr, rv, rr)
    last_row = rows[..., -1:]  # named beside every -inf
    named = torch.where(rv == NEG_INF, last_row, rr).to(torch.float32)
    return rv.reshape(b, t * h), named.reshape(b, t * h), early


V1_B, V1_D = 8, 64


def _unit(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _v1_inputs(kind: str, precision: str, rng: np.random.Generator):
    """``(plain_fn(n_valid) -> (values, rows), scores [B, N])`` of one v1
    one-shot emit: ``random`` unit rows, or ``four`` distinct scores per
    subtile (so ties decide most rounds)."""
    if kind == "random":
        docs, q = _unit(rng, N, V1_D), _unit(rng, V1_B, V1_D)
    else:  # column 0 alone scores: c / 4, c in 1..4
        docs = np.zeros((N, V1_D), dtype=np.float32)
        docs[:, 0] = rng.integers(1, 5, N)
        q = np.zeros((V1_B, V1_D), dtype=np.float32)
        q[:, 0] = 0.25
    if precision == "int8":
        if kind == "random":
            q_docs, rs = quantize_rows_int8(torch.from_numpy(docs))
            q8, qs = quantize_rows_int8(torch.from_numpy(q))
        else:  # exact: acc = c, scales 1/4 and 1
            q_docs = torch.from_numpy(docs).to(torch.int8)
            rs = torch.full((N,), 0.25)
            q8 = (torch.from_numpy(q) * 4).to(torch.int8)
            qs = torch.ones((V1_B,))
        args = (q_docs, rs, q8, qs)
        return (lambda nv: T._fused_extract_int8_plain(*args, nv),
                T._scores_int8(*args))
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    d_t, q_t = torch.from_numpy(docs).to(dt), torch.from_numpy(q).to(dt)
    return (lambda nv: T._fused_extract_plain(d_t, q_t, nv),
            T.scores_matmul(d_t, q_t))


# the live rows end: nowhere; 3 and 300 docs into subtile 20 (in its first
# and its second chunk, with 11 wholly padded subtiles after it); 3 docs
# into subtile 2 (29 wholly padded subtiles)
V1_N_VALID = [N, 512 * 20 + 3, 512 * 20 + 300, 512 * 2 + 3]


@pytest.mark.parametrize("n_valid", V1_N_VALID)
@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("kind", ["random", "four"])
def test_chunked_v1_equals_plain_emit(kind, precision, n_valid):
    plain, scores = _v1_inputs(kind, precision, np.random.default_rng(len(kind)))
    if kind == "four":
        per_sub = scores.view(V1_B, -1, T.FUSED_SUBTILE)
        assert int(torch.unique(per_sub[0, 0]).numel()) == 4
    vals, rows, early = chunked_select_v1(scores, n_valid)
    ref_v, ref_r = plain(n_valid)
    assert torch.equal(vals.view(torch.int32), ref_v.view(torch.int32))
    assert torch.equal(rows.view(torch.int32), ref_r.view(torch.int32))
    if n_valid < N:  # the -inf tail is in the case, named by the last row
        tail = ref_v == NEG_INF
        assert bool(tail.any())
        last = (torch.arange(ref_v.shape[1]) // T.EXTRACT_H) * T.FUSED_SUBTILE + 511
        assert torch.equal(ref_r[tail], last.expand_as(ref_r)[tail].to(torch.float32))
    if kind == "random":  # the early stop fires: in about half the pairs
        live_subtiles = -(-n_valid // T.FUSED_SUBTILE)
        assert early > 0.3 * V1_B * live_subtiles


def test_chunked_v1_equals_reference_kernel():
    """The chunked model on the port's int8 scores against ``svs_tpu``'s
    Pallas v1 kernel run in interpret mode, live rows ending in a
    subtile's second chunk."""
    rng = np.random.default_rng(7)
    docs, q = _unit(rng, N, 128), _unit(rng, V1_B, 128)
    q_docs, rs = quantize_rows_int8(torch.from_numpy(docs))
    q8, qs = quantize_rows_int8(torch.from_numpy(q))
    n_valid = 512 * 20 + 300
    jv, ji = J._fused_extract_int8(
        jnp.asarray(q_docs.numpy()), jnp.asarray(rs.numpy()),
        jnp.asarray(q8.numpy()), jnp.asarray(qs.numpy()),
        jnp.int32(n_valid), interpret=True,
    )
    vals, rows, _ = chunked_select_v1(T._scores_int8(q_docs, rs, q8, qs), n_valid)
    np.testing.assert_array_equal(np.asarray(jv).view(np.int32), vals.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(ji).view(np.int32), rows.numpy().view(np.int32))
