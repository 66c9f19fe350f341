"""Mesh-sharded all-pairs similarity: a ring over corpus shards (port of
``svs_tpu.parallel.pairwise_sharded``).

The corpus is row-sharded; instead of gathering it anywhere, the shards
rotate around the ring (:meth:`Mesh.shift`):

  ring step s (of D): shard ``me`` holds the shard that started on
  ``(me + s) mod D``.  It streams its RESIDENT rows in row blocks against
  that visiting shard (``[R, N/D]`` products, never an ``(N/D)^2`` score
  matrix), masks to the strict upper GLOBAL triangle and ``n_valid``,
  keeps a per-row top-m (``select_rows_topm``: the extraction kernel
  where the shape allows) and folds the winners into a carry of ``k``.
  Then the visiting shard moves one hop.

After D steps every pair has been scored once, each shard holds its rows'
top-k pairs, and one merge of ``D * k`` candidates on the primary
(:meth:`Mesh.gather`) gives the exact global top-k.  The per-row width
escalates over ``ops.pairwise.escalation_widths`` until no row's m-th
value reaches the merged k-th (the hidden-pair bound); the last width is
exact by construction.  The shards' row blocks run in turns
(``parallel.mesh.run_interleaved``), so each host sync of the extraction
route waits only after every shard has queued its block.
"""

from __future__ import annotations

from typing import Generator, List, Tuple

import torch

from ..ops.pairwise import _score_operand, escalation_widths, select_rows_topm_steps
from ..ops.topk import NEG_INF, scores_matmul, top_k
from .mesh import Mesh, ShardedArray, run_interleaved

#: Collected per-row winners of one ring step up to this many entries are
#: merged by one top-k; past it the carry merges after every row block
#: (the same result: the carry holds the earlier positions).
_COLLECT_MAX = 1 << 27

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sharded_pairwise_topk(
    docs: ShardedArray,
    n_valid: int,
    k: int,
    *,
    mesh: Mesh,
    data_axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-``k`` upper-triangle pairs over a row-sharded float
    corpus.  ``docs``: ``[N, d]`` bf16 or f32 over ``data_axis`` (one
    column block).  Returns ``(scores f32 [k], rows int32 [k], cols int32
    [k])`` on the primary, sorted descending.  The caller clamps ``k`` to
    the number of pairs."""
    n_shards = int(mesh.shape[data_axis])
    n_local = docs.shape[0] // n_shards
    widths = escalation_widths(int(k), docs.shape[0], n_local)
    for m in widths:
        vals, rows, cols, covered = _ring_pass(docs, int(n_valid), int(k), m, mesh, data_axis)
        if bool(covered):
            return vals, rows, cols
    return vals, rows, cols  # the last width is exact by construction


def _ring_pass(
    docs: ShardedArray, n_valid: int, k: int, per_row_k: int, mesh: Mesh, data_axis: str
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One escalation stage: D ring steps, then the merge and the
    ``covered`` test (a device bool)."""
    own = docs.row_blocks()
    n_shards = len(own)
    n_local = own[0].shape[0]
    operands = [_score_operand(b, None) for b in own]
    carries: List[Carry] = []
    for b in own:
        dev = b.device
        carries.append((
            torch.full((k,), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((k,), dtype=torch.int32, device=dev),
            torch.zeros((k,), dtype=torch.int32, device=dev),
            torch.full((), NEG_INF, dtype=torch.float32, device=dev),
        ))
    visiting = list(own)  # the visiting shard starts as each shard's own
    for step in range(n_shards):
        carries = run_interleaved([
            _ring_step(
                me, (me + step) % n_shards, operands[me], _score_operand(visiting[me], None),
                carries[me], n_local, n_valid, k, per_row_k,
            )
            for me in range(n_shards)
        ])
        if step + 1 < n_shards:
            visiting = mesh.shift(visiting, data_axis)
    vals = torch.cat(mesh.gather([c[0] for c in carries]))
    rows = torch.cat(mesh.gather([c[1] for c in carries]))
    cols = torch.cat(mesh.gather([c[2] for c in carries]))
    tails = torch.stack(mesh.gather([c[3] for c in carries]))
    top_v, pos = top_k(vals, k)
    exact = per_row_k >= min(k, n_local)
    covered = torch.logical_or(
        torch.tensor(exact, device=top_v.device), tails.max() < top_v[k - 1]
    )
    return top_v, rows[pos], cols[pos], covered


def _ring_step(
    me: int,
    src: int,
    own: torch.Tensor,
    visiting: torch.Tensor,
    carry: Carry,
    n_local: int,
    n_valid: int,
    k: int,
    per_row_k: int,
) -> Generator[None, None, Carry]:
    """Shard ``me``'s rows in row blocks against the visiting shard
    ``src``, folded into its carry ``(vals, rows, cols, tail max)``; the
    winners of the step are collected in block order after the carry, as
    the reference's scan stacks them."""
    rb = next(c for c in (256, 128, 64, 32, 16, 8, 4, 2, 1) if n_local % c == 0)
    m_eff = min(per_row_k, n_local)
    dev = own.device
    row_base, col_base = me * n_local, src * n_local
    col_ids = col_base + torch.arange(n_local, device=dev)
    c_vals, c_rows, c_cols, c_tail = carry
    collect = n_local * m_eff <= _COLLECT_MAX
    parts = []
    for i in range(n_local // rb):
        row_ids = row_base + i * rb + torch.arange(rb, device=dev)
        scores = scores_matmul(visiting, own[i * rb : (i + 1) * rb])  # [rb, n_local]
        live = (
            (col_ids[None, :] > row_ids[:, None])
            & (col_ids < n_valid)[None, :]
            & (row_ids < n_valid)[:, None]
        )
        scores = torch.where(live, scores, NEG_INF)
        blk_v, blk_c = yield from select_rows_topm_steps(scores, m_eff)
        c_tail = torch.maximum(c_tail, blk_v[:, -1].max())
        flat = (
            blk_v.reshape(-1),
            row_ids.to(torch.int32)[:, None].expand(blk_c.shape).reshape(-1),
            (col_base + blk_c.to(torch.int32)).reshape(-1),
        )
        if collect:
            parts.append(flat)
            continue
        c_vals, pos = top_k(torch.cat([c_vals, flat[0]]), k)
        c_rows = torch.cat([c_rows, flat[1]])[pos]
        c_cols = torch.cat([c_cols, flat[2]])[pos]
    if collect and parts:
        all_v, all_r, all_c = (torch.cat(p) for p in zip(*parts))
        c_vals, pos = top_k(torch.cat([c_vals, all_v]), k)
        c_rows = torch.cat([c_rows, all_r])[pos]
        c_cols = torch.cat([c_cols, all_c])[pos]
    return c_vals, c_rows, c_cols, c_tail
