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
lanes)."""

import numpy as np
import pytest
import torch

from svs_tpu_torch.ops import pallas_extract as T

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
