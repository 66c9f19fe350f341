"""Corpus-sharded exact retrieval over a device mesh (port of
``svs_tpu.parallel.sharded``).

The packed corpus is split row-wise over the mesh's ``data`` axis (and
column-wise over a ``model`` axis for very wide embeddings,
``parallel.mesh.place``).  Every shard scores only its rows, masks the
pack's padding by GLOBAL row, and selects a local top-k; only those ``k``
candidates per shard reach the merge (:meth:`Mesh.gather`), where one
top-k over the ``D * k`` candidates is the exact global top-k (each
global winner lives in some shard and so is in that shard's top-k).  With
a model axis the partial dot products are summed first (:meth:`Mesh.sum`).

The per-shard routes are the reference's, on the port's kernels:
guarded (v3) candidates with a hidden-score bound, keyed (v2) top-k, a
streamed exact scan past ``FALLBACK_SCORES_BUDGET``, else the exact
score matrix with ``extract_topk`` (#8) or a plain top-k.  Each shard's
work is a generator that yields before its host syncs, and the shards
run in turns (``parallel.mesh.run_interleaved``): every shard's kernels
are queued before the first sync waits.  A shard's kernel that fails to
build or launch fails the call.
"""

from __future__ import annotations

from typing import Generator, List, Optional, Tuple

import torch

from ..ops.quant import quantize_rows_int8
from ..ops.topk import (
    NEG_INF,
    final_select_wire,
    gathered_dots,
    gathered_scores,
    int8_dot,
    merge_topk,
    scores_matmul,
    top_k,
    unpack_rows_tail,
)
from .mesh import Mesh, ShardedArray, run_interleaved

Steps = Generator[None, None, Tuple[torch.Tensor, ...]]


def sharded_score_topk(
    docs: ShardedArray,
    row_scales: Optional[ShardedArray],
    queries: torch.Tensor,
    n_valid: int,
    k: int,
    *,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: Optional[str] = None,
    keyed: bool = False,
    guarded: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``k`` over a mesh-sharded corpus.

    ``docs``: ``[N, d]`` over ``(data_axis, model_axis)``; ``row_scales``:
    ``[N]`` f32 over ``data_axis`` for int8 corpora, or ``None``;
    ``queries``: ``[B, d]`` on the mesh's primary device.  Returns
    ``(values f32 [B, k], global row indices int32 [B, k])`` on the
    primary.

    ``keyed=True`` runs each shard through the keyed (v2) kernels: the
    values are quantized prescores within ``KEY_EPS`` below the true
    score, for the verified rescore (``RetrievalEngine.prescore_eps`` adds
    the term wherever this dispatch is possible).  ``guarded=True`` runs
    each shard through the guarded (v3) kernels: each shard returns
    candidates and a sound bound on every prescore it hid, and the merged
    boundary slot becomes ``max(weakest merged candidate, max over shards
    of the per-shard bounds)``, the composition of the single-device
    wire.  Both need data-axis-only sharding; the engine's
    ``_keyed_selection_possible`` / ``_guarded_selection_possible`` are
    the gates."""
    if row_scales is not None and model_axis is not None:
        raise NotImplementedError(
            "int8 corpora shard over the data axis only (per-query scales "
            "must see the full query vector)"
        )
    if (keyed or guarded) and model_axis is not None:
        raise NotImplementedError(
            "keyed/guarded per-shard selection needs each shard's full "
            "dot products (data-axis-only sharding)"
        )
    grid = mesh.grid(data_axis, model_axis)
    n_local = docs.shape[0] // len(grid)
    k_local = min(int(k), n_local)
    q_on = mesh.replicate(queries)
    if model_axis is None:
        steps = [
            _shard_topk(
                docs.block(i),
                None if row_scales is None else row_scales.block(i),
                q_on[grid[i][0]],
                int(n_valid),
                i * n_local,
                k_local,
                keyed,
                guarded,
            )
            for i in range(len(grid))
        ]
    else:
        # partial dots over each column block, summed per row block onto
        # the row's first device (the reference's psum over the model axis)
        width = docs.shape[1] // len(grid[0])
        partials = [
            [
                scores_matmul(
                    docs.block(i, j),
                    q_on[grid[i][j]][:, j * width : (j + 1) * width],
                )
                for j in range(len(grid[0]))
            ]
            for i in range(len(grid))
        ]
        steps = [
            _select_masked(
                mesh.sum(partials[i], device=grid[i][0]),
                int(n_valid),
                i * n_local,
                k_local,
            )
            for i in range(len(grid))
        ]
    outs = run_interleaved(steps)
    vals = torch.cat(mesh.gather([o[0] for o in outs]), dim=1)
    gidx = torch.cat(mesh.gather([o[1] for o in outs]), dim=1)
    mvals, midx = merge_topk(vals, gidx, int(k))
    if guarded:
        # a doc missing from the merged set was either never extracted in
        # its shard (<= that shard's bound) or dropped at the merge (<= the
        # merged k-th value): this boundary bounds every hidden prescore
        gbound = torch.stack(mesh.gather([o[2] for o in outs])).amax(dim=0)
        mvals = torch.cat(
            [mvals[:, :-1], torch.maximum(mvals[:, -1:], gbound[:, None])], dim=1
        )
    return mvals, midx


def _shard_topk(
    docs: torch.Tensor,
    scales: Optional[torch.Tensor],
    q: torch.Tensor,
    n_valid: int,
    offset: int,
    k_local: int,
    keyed: bool,
    guarded: bool,
) -> Steps:
    """One shard's local top-``k_local`` with GLOBAL row indices (rows
    ``offset ..``); its live prefix is ``clip(n_valid - offset, 0,
    n_local)``."""
    from ..ops import pallas_extract as P
    from ..ops.topk import FALLBACK_SCORES_BUDGET, streaming_score_topk

    n_local = docs.shape[0]
    nv_local = min(max(n_valid - offset, 0), n_local)
    if guarded:
        if scales is not None:
            vals, rows, bound = P.fused3_candidates_int8(docs, scales, q, nv_local, k_local)
        else:
            vals, rows, bound = P.fused3_candidates(docs, q, nv_local, k_local)
        return vals, rows.to(torch.int32) + offset, bound
    if keyed:
        if scales is not None:
            vals, idx = yield from P.fused2_topk_int8_steps(docs, scales, q, nv_local, k_local)
        else:
            vals, idx = yield from P.fused2_topk_steps(docs, q, nv_local, k_local)
        return vals, idx.to(torch.int32) + offset
    if q.shape[0] * n_local * 4 > FALLBACK_SCORES_BUDGET:
        # a [B, N/D] f32 score matrix per shard would pass the budget:
        # stream row blocks instead (exact, the same tie rule)
        vals, idx = streaming_score_topk(docs, q, nv_local, k_local, row_scales=scales)
        return vals, idx + offset
    if scales is not None:
        q_int8, q_scales = quantize_rows_int8(q)
        raw = int8_dot(q_int8, docs)
        scores = raw.to(torch.float32) * scales[None, :] * q_scales[:, None]
    else:
        scores = scores_matmul(docs, q)
    return (yield from _select_masked(scores, n_valid, offset, k_local))


def _select_masked(
    scores: torch.Tensor, n_valid: int, offset: int, k_local: int
) -> Steps:
    """Mask a shard's ``[B, n_local]`` scores to its global live rows and
    take its top-``k_local``: through ``extract_topk`` (#8) where the
    shape allows, else a plain top-k.  Indices come back global."""
    from ..ops.pallas_extract import extract_supported, extract_topk_steps

    n_local = scores.shape[1]
    global_col = offset + torch.arange(n_local, device=scores.device)
    masked = torch.where(global_col < n_valid, scores, NEG_INF)
    if extract_supported(n_local, scores.shape[0], k_local):
        vals, idx = yield from extract_topk_steps(masked, k_local)
    else:
        vals, idx = top_k(masked, k_local)
    return vals, idx.to(torch.int32) + offset


def _shard_partials(
    mirror: ShardedArray,
    rows: torch.Tensor,
    queries: torch.Tensor,
    mesh: Mesh,
    dots,
) -> List[torch.Tensor]:
    """Each shard's partial exact scores of the global pack ``rows``: the
    rows in its range gathered from its slice of the f32 mirror and
    dotted (``dots``: :func:`~svs_tpu_torch.ops.topk.gathered_dots` for
    ``[B, C]`` rows, ``gathered_scores`` for ``[F]``), the rest 0.  Only
    one shard holds a row, so the sum is that shard's dot unchanged."""
    rows_on = mesh.replicate(rows.to(torch.int64))
    q_on = mesh.replicate(queries)
    parts = []
    offset = 0
    for block in mirror.row_blocks():
        n_local = block.shape[0]
        lr = rows_on[block.device] - offset
        valid = (lr >= 0) & (lr < n_local)
        partial = dots(block, lr.clamp(0, n_local - 1), q_on[block.device])
        if partial.dim() == 2 and valid.dim() == 1:
            valid = valid[None, :]
        parts.append(torch.where(valid, partial, 0.0))
        offset += n_local
    return parts


def sharded_rescore_final(
    packed: torch.Tensor,
    mirror: ShardedArray,
    dev_emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    wide: bool,
    mesh: Mesh,
    data_axis: str = "data",
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Mesh analogue of the engine's device rescore and final selection
    (``engine.index._final_from_packed``): each shard gathers the merged
    candidates in its row range from its slice of the f32 mirror and
    takes their exact dots at the single device's ``[B, C, d]`` shape,
    the partials are summed on the primary (:meth:`Mesh.sum`), and the
    final top-``k`` with the reference tie rule runs there; one
    ``[B, 2k + 1]`` int32 wire comes back.

    ``packed``: the prescore wire of :func:`sharded_score_topk` (scores ++
    GLOBAL rows) on the primary; ``mirror``: ``[N_padded, dim]`` f32 in
    pack-row order over ``data_axis``; ``dev_emb``: ``[N_padded]`` int32
    emb ids on the primary; ``queries``: ``[B, dim_padded]`` f32 on the
    primary."""
    del data_axis  # the mirror's row blocks are the data shards
    if dim is not None and dim != queries.shape[1]:
        queries = queries[:, :dim]
    rows, tail_bits = unpack_rows_tail(packed, packed.shape[1] // 2, wide)
    exact = mesh.sum(_shard_partials(mirror, rows, queries, mesh, gathered_dots))
    emb_of = dev_emb[rows.to(torch.int64)]
    return final_select_wire(exact, emb_of, tail_bits, int(k))


def sharded_subset_topk(
    mirror: ShardedArray,
    dev_emb: torch.Tensor,
    rows: torch.Tensor,
    n_live: int,
    queries: torch.Tensor,
    k: int,
    *,
    mesh: Mesh,
    data_axis: str = "data",
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Mesh analogue of the engine's pre-filter route
    (``engine.index._subset_final``): exact top-``k`` over an explicit
    pack-row subset.  Each shard scores the subset rows in its range from
    its slice of the f32 mirror (the single device's ``[B, F]`` product),
    the partials are summed on the primary, the padding is masked by
    ``n_live``, and the final selection runs there.

    ``rows``: ``[F_pad]`` pack rows on the primary (padding repeats row 0,
    masked off); the rest as :func:`sharded_rescore_final`."""
    del data_axis
    if dim is not None and dim != queries.shape[1]:
        queries = queries[:, :dim]
    exact = mesh.sum(_shard_partials(mirror, rows, queries, mesh, gathered_scores))
    live = torch.arange(rows.shape[0], device=exact.device)[None, :] < n_live
    exact = torch.where(live, exact, float("-inf"))
    emb_of = dev_emb[rows.to(torch.int64)]
    emb_b = emb_of[None, :].expand(exact.shape[0], -1)
    tail = torch.zeros((exact.shape[0], 1), dtype=torch.int32, device=exact.device)
    return final_select_wire(exact, emb_b, tail, int(k))
