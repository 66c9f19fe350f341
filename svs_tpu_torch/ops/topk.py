"""Exact scoring + top-k selection in plain torch (port of
``svs_tpu.ops.topk``).

Tie rules are the reference package's, made explicit: device selection
breaks equal scores to the SMALLER index (``lax.top_k``), and the final
selection breaks them to the LARGER emb id (``final_select_wire``).
``torch.topk`` promises no order among ties, so every selection here is a
stable sort.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

NEG_INF = float("-inf")

#: Ceiling on the f32 score-matrix bytes a materializing exact path may
#: allocate (``svs_tpu.ops.topk.FALLBACK_SCORES_BUDGET``); past it the
#: exact path streams over row blocks (:func:`streaming_score_topk`).
FALLBACK_SCORES_BUDGET = 1 << 31  # 2 GiB


#: Threads inside :func:`exact_f32` and the TF32 flags the first of them
#: found (the flags are process-wide; concurrent ``AsyncKB`` searches run
#: their products on several threads at once).
_EXACT_F32_LOCK = threading.Lock()
_exact_f32_state: list = [0, None]


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Run the enclosed float32 products in true f32: TF32 off for both
    cuBLAS and cuDNN.  The engine's error bounds (the 1e-4 and 3e-5
    cushions of ``prescore_eps``) assume full-precision f32 dots.  The
    flags stay off until the last thread inside leaves, which restores
    what the first one found."""
    with _EXACT_F32_LOCK:
        if _exact_f32_state[0] == 0:
            _exact_f32_state[1] = (
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
            )
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _exact_f32_state[0] += 1
    try:
        yield
    finally:
        with _EXACT_F32_LOCK:
            _exact_f32_state[0] -= 1
            if _exact_f32_state[0] == 0:
                (
                    torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                ) = _exact_f32_state[1]


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, equal values in ascending index order.  Returns
    ``(values, int64 positions)``."""
    vals, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def merge_topk(
    values: torch.Tensor, indices: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate sets along the last axis into one exact top-``k``
    (``svs_tpu.ops.topk.merge_topk``): ``values``/``indices`` are ``[...,
    C]`` with C >= k, e.g. per-shard winners side by side.  Any global
    top-k element is in the union of the per-source top-k sets, so
    selecting again over the union is exact; ties keep the union's
    order (:func:`top_k`)."""
    top_vals, top_pos = top_k(values, k)
    return top_vals, torch.gather(indices, -1, top_pos)


def gathered_dots(
    src: torch.Tensor, at: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """Exact f32 dots of rows ``src[at]`` (``at`` ``[B, C]``) with their
    query (``queries`` ``[B, d]``): one gather and one ``bmm``, TF32 off.
    Returns ``[B, C]``."""
    cand = src[at]  # [B, C, d]
    with exact_f32():
        return torch.bmm(cand, queries[:, :, None].to(torch.float32))[:, :, 0]


def gathered_scores(
    src: torch.Tensor, at: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """Exact f32 scores of every query against rows ``src[at]`` (``at``
    ``[F]``): one gather and one ``[B, d] x [F, d]^T`` product, TF32 off.
    Returns ``[B, F]``."""
    cand = src[at]  # [F, d]
    with exact_f32():
        return queries.to(torch.float32) @ cand.t()


def int8_dot(q_int8: torch.Tensor, docs_int8: torch.Tensor) -> torch.Tensor:
    """Exact ``[B, d] x [N, d]^T`` int8 product with int32 accumulation —
    the product the reference package leaves to XLA outside any kernel.
    On the card it is ``torch._int_mm`` (cuBLASLt), which wants more than
    16 rows and widths that are multiples of 8, so the query rows are
    padded; on the CPU a float64 matmul (every partial sum is an integer
    far below 2^53, so exact, and BLAS-fast where torch's int32 matmul is
    not).  Integer sums are exact in any order, so both give the same
    bits."""
    b, d = q_int8.shape
    if q_int8.is_cuda:
        if d % 8 or docs_int8.shape[0] % 8:
            raise ValueError(
                f"int8 product needs widths that are multiples of 8, got "
                f"d={d}, n={docs_int8.shape[0]}"
            )
        rows = max(32, -(-b // 8) * 8)
        qp = q_int8
        if rows != b:
            qp = torch.zeros((rows, d), dtype=torch.int8, device=q_int8.device)
            qp[:b] = q_int8
        return torch._int_mm(qp, docs_int8.t())[:b]
    return (q_int8.to(torch.float64) @ docs_int8.to(torch.float64).t()).to(
        torch.int32
    )


#: Ceiling on the f32 bytes of one row block of a non-f32 corpus widened by
#: :func:`scores_matmul` (the whole corpus is never copied to f32).
_WIDEN_BLOCK_BYTES = 1 << 28


def scores_matmul(docs: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Cosine scores of every (query, doc) pair, ``[B, N]`` f32, as the
    reference computes them (``svs_tpu.ops.topk.scores_matmul``): the
    queries are first rounded to the docs' float dtype (bf16: round to
    nearest even), then every product is accumulated in true f32 (TF32
    off).  A bf16 corpus is widened to f32 one row block at a time
    (exact), so no f32 copy of the whole corpus is made."""
    if docs.dtype != queries.dtype and docs.dtype.is_floating_point:
        queries = queries.to(docs.dtype)
    q32 = queries.to(torch.float32)
    with exact_f32():
        if docs.dtype == torch.float32:
            return q32 @ docs.t()
        n, d = docs.shape
        out = torch.empty(
            (q32.shape[0], n), dtype=torch.float32, device=docs.device
        )
        step = max(1, _WIDEN_BLOCK_BYTES // max(1, d * 4))
        for lo in range(0, n, step):
            blk = docs[lo : lo + step].to(torch.float32)
            out[:, lo : lo + blk.shape[0]] = q32 @ blk.t()
        return out


def mask_cols(scores: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Replace columns >= ``n_valid`` (padding rows of the pack) with
    ``NEG_INF`` along the last axis."""
    live = torch.arange(scores.shape[-1], device=scores.device) < n_valid
    return torch.where(live, scores, torch.full_like(scores, NEG_INF))


def masked_topk(
    scores: torch.Tensor, k: int, n_valid: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with positions >= ``n_valid`` masked out.
    Returns ``(values f32, indices int32)``."""
    vals, idx = top_k(mask_cols(scores, n_valid), k)
    return vals, idx.to(torch.int32)


def score_topk(
    docs: torch.Tensor, queries: torch.Tensor, n_valid: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scoring + exact top-k of an f32 corpus: ``[B, k]`` values
    and int32 indices."""
    return masked_topk(scores_matmul(docs, queries), k, n_valid)


def streaming_score_topk(
    docs: torch.Tensor,
    queries: torch.Tensor,
    n_valid: int,
    k: int,
    row_scales: Optional[torch.Tensor] = None,
    max_block_rows: int = 1 << 21,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked scoring + top-k with O(B x block) score memory.

    Result contract of :func:`score_topk` (``row_scales=None``) or
    ``quant.score_topk_int8`` (int8 corpus + per-row scales), including
    the smaller-index-first tie rule: blocks are scored one at a time and
    merged into a running top-k (carry first, so ties keep global index
    order).  The block size is the largest divisor of ``n`` at most
    ``max_block_rows`` and never below ``k`` (the reference's rule).
    """
    n, _ = docs.shape
    if k > n:
        raise ValueError(f"k={k} exceeds the corpus row count {n}")
    target = max(1, -(-n // max_block_rows))
    steps = target
    while steps * max(k, 1) <= n and n % steps != 0:
        steps += 1
    if steps * max(k, 1) > n or n % steps != 0:
        steps = target
        while steps > 1 and n % steps != 0:
            steps -= 1
    block = n // steps

    if row_scales is not None:
        from .quant import quantize_rows_int8

        q_int8, q_scales = quantize_rows_int8(queries)

    def block_scores(start: int) -> torch.Tensor:
        blk = docs[start : start + block]
        if row_scales is None:
            s = scores_matmul(blk, queries)
        else:
            raw = int8_dot(q_int8, blk)
            s = (
                raw.to(torch.float32)
                * row_scales[None, start : start + block]
                * q_scales[:, None]
            )
        return mask_cols(s, n_valid - start)

    cv, ci = top_k(block_scores(0), k)
    for i in range(1, steps):
        start = i * block
        bv, bi = top_k(block_scores(start), k)
        mv = torch.cat([cv, bv], dim=1)
        mi = torch.cat([ci, bi + start], dim=1)
        cv, p = top_k(mv, k)
        ci = torch.gather(mi, 1, p)
    return cv, ci.to(torch.int32)


def streaming_score_topk_packed(
    docs: torch.Tensor,
    queries: torch.Tensor,
    n_valid: int,
    k: int,
    row_scales: Optional[torch.Tensor] = None,
    wide: bool = False,
) -> torch.Tensor:
    """:func:`streaming_score_topk` + result packing."""
    return pack_vals_idx(
        *streaming_score_topk(docs, queries, n_valid, k, row_scales=row_scales),
        wide=wide,
    )


def pack_vals_idx(
    vals: torch.Tensor, idx: torch.Tensor, wide: bool = False
) -> torch.Tensor:
    """Scores ++ indices in ONE array (``svs_tpu.ops.topk.pack_vals_idx``):
    the f32 layout carries indices as exact f32 values (below 2^24 rows);
    the ``wide`` int32 layout carries the score bits bitcast to int32."""
    if wide:
        return torch.cat(
            [vals.contiguous().view(torch.int32), idx.to(torch.int32)], dim=1
        )
    return torch.cat([vals, idx.to(torch.float32)], dim=1)


def unpack_rows_tail(
    packed: torch.Tensor, c: int, wide: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a :func:`pack_vals_idx` wire's candidate rows and boundary
    (C-th, lowest) prescore: ``(rows int32 [B, C], tail_bits int32
    [B, 1])``."""
    if wide:
        rows = packed[:, c:]
        tail_bits = packed[:, c - 1 : c]
    else:
        rows = packed[:, c:].to(torch.int32)
        tail_bits = packed[:, c - 1 : c].contiguous().view(torch.int32)
    return rows, tail_bits


def final_select_wire(
    exact: torch.Tensor, emb_of: torch.Tensor, tail_bits: torch.Tensor, k: int
) -> torch.Tensor:
    """Final top-k with the REFERENCE tie rule — descending exact score,
    equal scores break to the larger emb id — encoded as the int32 wire
    ``[B, 2k + 1]``: top-k emb ids ++ top-k exact score bits ++ boundary
    bits.  Torch has no multi-key sort, so: a stable sort by emb id
    (descending), then a stable sort by ``-(exact + 0.0)``; the ``+ 0.0``
    canonicalizes -0.0 so an exact-zero tie can't split on zero sign."""
    by_emb = torch.argsort(emb_of, dim=1, descending=True, stable=True)
    exact_e = torch.gather(exact, 1, by_emb)
    emb_e = torch.gather(emb_of, 1, by_emb)
    order = torch.argsort(-(exact_e + 0.0), dim=1, stable=True)[:, :k]
    top_exact = torch.gather(exact_e, 1, order)
    top_emb = torch.gather(emb_e, 1, order)
    return torch.cat(
        [
            top_emb.to(torch.int32),
            top_exact.contiguous().view(torch.int32),
            tail_bits.to(torch.int32),
        ],
        dim=1,
    )


def score_topk_packed(
    docs: torch.Tensor,
    queries: torch.Tensor,
    n_valid: int,
    k: int,
    wide: bool = False,
) -> torch.Tensor:
    """:func:`score_topk` + result packing: the bottom rung of the float
    prescore ladder."""
    return pack_vals_idx(*score_topk(docs, queries, n_valid, k), wide=wide)


def unpack_vals_idx(
    packed: Any, k: int, wide: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of :func:`pack_vals_idx` on a fetched array:
    returns ``(scores f32 [B, k], rows int64 [B, C-k])``."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    if wide:
        vals = np.ascontiguousarray(packed[:, :k]).view(np.float32)
    else:
        vals = packed[:, :k].astype(np.float32, copy=False)
    return vals, packed[:, k:].astype(np.int64)
