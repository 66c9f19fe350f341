"""Blocked all-pairs similarity: exact top-k pairs without the O(n^2)
matrix (port of ``svs_tpu.ops.pairwise``).

The computation streams over row blocks of the packed corpus:

  for each block of R rows:
      S = block @ docs.T                      # [R, N] lives only this step
      mask to the strict upper triangle (col > row) and valid docs
      per-row top-m, or per-subtile packed keys (the keyed pass)

Two passes, both the reference's:

- :func:`pairwise_topk_blocked` — exact: per-row top-m through the
  two-pass extraction (``_extract``) where the shape allows, a tail check
  proving no row hides a winner, and widening m (64 -> 1024 -> k) until
  it does;
- :func:`pairwise_candidates_keyed` — quantized candidates plus a sound
  bound on every pair left out, from ``pairwise_keys_extract``; only
  sound under the KB's rescore margin (``kb._finalize_pairwise``), which
  owns the widen-retry.

``lax.scan`` becomes a Python loop over row blocks; its carries stay
device tensors.  A keyed attempt syncs with the host once (``ok``).  The
exact pass syncs once per row block where it selects through
``_extract``: ``extract_topk``'s coverage check
(``pallas_extract._verified_merge``) asks the host whether to take the
fallback, where the reference branches on the device (``lax.cond``); then
once more per attempt (``covered``).  Row blocks made only of padding rows
(the pack's last rows) are skipped: they hold no live pair, and as a
suffix of the collected candidates they never move a live candidate's
position.
"""

from __future__ import annotations

from typing import Generator, List, Optional, Tuple

import torch

from .topk import NEG_INF, int8_dot, scores_matmul, top_k

#: Per-row selection widths tried in order; the last stage uses m = k and
#: is exact by construction.
_ESCALATION = (64, 1024)


def escalation_widths(k: int, n_rows_total: int, width_cap: int) -> List[int]:
    """The per-row widths to attempt: escalation stages capped at
    ``width_cap``, skipping widths whose total selected lanes
    (``n_rows_total * m``) could not hold ``k`` winners, ending at the
    exact-by-construction ``min(k, width_cap)``."""
    last = min(k, width_cap)
    widths = [m for m in _ESCALATION if m < last and n_rows_total * m >= k]
    widths.append(last)
    return widths


def extraction_route_chosen(n: int, rows: int, m: int) -> bool:
    """True when a ``[rows, n]`` per-row top-``m`` selection routes through
    the extraction kernel (the reference's hardware-independent
    predicate; the port takes the route on every device)."""
    from .pallas_extract import BLOCK_N as EX_BLOCK
    from .pallas_extract import extract_supported

    sel_n = ((n + EX_BLOCK - 1) // EX_BLOCK) * EX_BLOCK
    return sel_n <= 2 * n and extract_supported(sel_n, rows, m)


def _extraction_input(scores: torch.Tensor, m: int) -> Optional[torch.Tensor]:
    """The score block as the extraction route takes it (columns padded to
    the kernel's block with -inf), or ``None`` when
    :func:`extraction_route_chosen` says the plain top-k."""
    from .pallas_extract import BLOCK_N as EX_BLOCK

    rows, n = scores.shape
    if not extraction_route_chosen(n, rows, m):
        return None
    sel_n = ((n + EX_BLOCK - 1) // EX_BLOCK) * EX_BLOCK
    if sel_n != n:
        scores = torch.cat(
            [scores, scores.new_full((rows, sel_n - n), NEG_INF)], dim=1
        )
    return scores


def select_rows_topm(
    scores: torch.Tensor, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-``m`` of a ``[R, N]`` score block: ``(vals, cols)``.
    Through ``extract_topk`` (``_extract`` on the card, its plain twin on
    the CPU) when :func:`extraction_route_chosen` says so, with the score
    columns padded to the kernel's block with -inf; else a plain top-k.
    Ties go to the smaller column in the plain top-k and to the higher
    one inside an extraction subtile, as in the reference."""
    from .pallas_extract import extract_topk

    padded = _extraction_input(scores, m)
    if padded is None:
        return top_k(scores, m)
    return extract_topk(padded, m)


def select_rows_topm_steps(
    scores: torch.Tensor, m: int
) -> "Generator[None, None, Tuple[torch.Tensor, torch.Tensor]]":
    """:func:`select_rows_topm` as a generator: it yields once before the
    extraction route's host sync (``pallas_extract.extract_topk_steps``),
    not at all on the plain route."""
    from .pallas_extract import extract_topk_steps

    padded = _extraction_input(scores, m)
    if padded is None:
        return top_k(scores, m)
    return (yield from extract_topk_steps(padded, m))


def _score_operand(
    docs: torch.Tensor, row_scales: Optional[torch.Tensor]
) -> torch.Tensor:
    """The operand of a pass's block products: the int8 pack itself, or
    the float pack widened to f32 once per pass (exact for bf16), so each
    block's ``scores_matmul`` is one f32 GEMM over bf16-rounded operands."""
    if row_scales is not None or docs.dtype == torch.float32:
        return docs
    return docs.to(torch.float32)


def _block_scores(
    docs: torch.Tensor,
    row_scales: Optional[torch.Tensor],
    row0: int,
    block_rows: int,
) -> torch.Tensor:
    """``[block_rows, N]`` f32 scores of rows ``row0 ..`` against every
    row: int8 x int8 with int32 accumulation, rescaled in the reference's
    order, or a true-f32 product (``docs`` from :func:`_score_operand`)."""
    block = docs[row0 : row0 + block_rows]
    if row_scales is not None:
        raw = int8_dot(block, docs)
        s_blk = row_scales[row0 : row0 + block_rows]
        return raw.to(torch.float32) * s_blk[:, None] * row_scales[None, :]
    return scores_matmul(docs, block)


def _blocks_to_run(
    n_valid: int, n_blocks: int, block_rows: int, m: int, want: int
) -> int:
    """How many leading row blocks a pass runs: those holding a valid row,
    unless their ``m`` selections per row could not fill ``want`` slots
    (the pass then ends uncovered / not ok, as the reference's does, and
    runs every block to give the reference's placeholders)."""
    live = min(n_blocks, -(-int(n_valid) // block_rows))
    return live if live * block_rows * m >= want else n_blocks


def _upper_live(
    row_ids: torch.Tensor, col_ids: torch.Tensor, n_valid: int
) -> torch.Tensor:
    return (
        (col_ids[None, :] > row_ids[:, None])
        & (col_ids < n_valid)[None, :]
        & (row_ids < n_valid)[:, None]
    )


def _pairwise_attempt(
    docs: torch.Tensor,
    n_valid: int,
    k: int,
    per_row_k: int,
    block_rows: int,
    row_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One blocked pass with per-row top-``per_row_k`` selection; ``docs``
    from :func:`_score_operand`.  Returns ``(vals, rows, cols, covered)``;
    ``covered`` (a device bool) is False when some row's per-row tail
    reached the merged k-th value."""
    n_padded = docs.shape[0]
    assert n_padded % block_rows == 0, "pad the corpus to a block multiple"
    n_blocks = n_padded // block_rows
    dev = docs.device
    # Collect-then-merge vs merge-per-step (the reference's rule): one final
    # top-k when the collected winners fit, a running carry otherwise.
    collect = n_blocks * block_rows * per_row_k <= (1 << 27)
    col_ids = torch.arange(n_padded, device=dev)
    c_vals = torch.full((k,), NEG_INF, dtype=torch.float32, device=dev)
    c_rows = torch.zeros((k,), dtype=torch.int32, device=dev)
    c_cols = torch.zeros((k,), dtype=torch.int32, device=dev)
    c_tail = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    parts: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
    for blk in range(_blocks_to_run(n_valid, n_blocks, block_rows, per_row_k, k)):
        row0 = blk * block_rows
        row_ids = row0 + torch.arange(block_rows, device=dev)
        scores = _block_scores(docs, row_scales, row0, block_rows)
        scores = torch.where(_upper_live(row_ids, col_ids, n_valid), scores, NEG_INF)
        blk_vals, blk_cols = select_rows_topm(scores, per_row_k)
        blk_rows = row_ids.to(torch.int32)[:, None].expand(blk_cols.shape)
        # the m-th (smallest selected) value per row bounds anything hidden
        c_tail = torch.maximum(c_tail, blk_vals[:, -1].max())
        flat = (
            blk_vals.reshape(-1),
            blk_rows.reshape(-1),
            blk_cols.to(torch.int32).reshape(-1),
        )
        if collect:
            parts.append(flat)
            continue
        all_vals = torch.cat([c_vals, flat[0]])
        top_vals, top_pos = top_k(all_vals, k)
        c_rows = torch.cat([c_rows, flat[1]])[top_pos]
        c_cols = torch.cat([c_cols, flat[2]])[top_pos]
        c_vals = top_vals
    if collect:
        all_vals, all_rows, all_cols = (torch.cat(p) for p in zip(*parts))
        c_vals, pos = top_k(all_vals, k)
        c_rows, c_cols = all_rows[pos], all_cols[pos]
    exact_by_construction = per_row_k >= min(k, n_padded)
    covered = torch.logical_or(
        torch.tensor(exact_by_construction, device=dev), c_tail < c_vals[k - 1]
    )
    return c_vals, c_rows, c_cols, covered


def pairwise_topk_blocked(
    docs: torch.Tensor,
    n_valid: int,
    k: int,
    block_rows: int = 256,
    row_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-``k`` upper-triangle pairs of the row-wise similarity
    matrix: ``(scores f32 [k], rows int32 [k], cols int32 [k])`` sorted by
    score descending.  ``docs`` is ``[N, d]`` with N a multiple of
    ``block_rows`` (rows past ``n_valid`` are ignored); the caller clamps
    ``k`` to ``n_valid * (n_valid - 1) / 2``.  With ``row_scales`` (int8
    corpora) each block is an int8 x int8 product rescaled on the fly."""
    n_padded = docs.shape[0]
    operand = _score_operand(docs, row_scales)
    for m in escalation_widths(k, n_padded, n_padded):
        vals, rows, cols, covered = _pairwise_attempt(
            operand, n_valid, k, m, block_rows, row_scales
        )
        if bool(covered):
            break
    return vals, rows, cols  # the last stage is exact by construction


# --- keyed candidate pass (quantized, margin-verified at the KB) -----------

#: Per-row selection widths for the keyed pass, by candidate count: KB
#: widen-retries move from 64 to 512 and finally off the keyed route.
_KEYED_WIDTHS = ((16384, 64), (1 << 62, 512))

#: Candidate-count ceiling for the keyed route: the hidden-pair bound has a
#: c-independent term (the per-subtile 8th-key tails), so past one retry at
#: the wider rung the KB's ladder hands over to the exact blocked pass.
_KEYED_MAX_C = 65536


def keyed_row_width(c: int, n_cols: int) -> int:
    """Per-row width for a keyed pass at candidate count ``c``, capped by
    the extracted-key pool per row."""
    from .pallas_extract import PAIR_BLOCK_N, PAIR_KEYS

    pool = (n_cols // PAIR_BLOCK_N) * PAIR_KEYS
    for cap, m in _KEYED_WIDTHS:
        if c <= cap:
            return min(m, pool)
    return min(_KEYED_WIDTHS[-1][1], pool)


def keyed_pairwise_route(n_padded: int, block_rows: int, c: int) -> bool:
    """Dispatch predicate of the keyed candidate pass (the reference's):
    kernel-supported shapes, a collected pool that can hold ``c``, and a
    per-row merge width within 16384 keys."""
    from .pallas_extract import PAIR_BLOCK_N, PAIR_KEYS, pair_keys_supported

    if not pair_keys_supported(n_padded, min(block_rows, n_padded)):
        return False
    if n_padded % block_rows != 0:
        return False
    nbc = n_padded // PAIR_BLOCK_N
    m = keyed_row_width(c, n_padded)
    return 0 < c <= min(_KEYED_MAX_C, n_padded * m) and nbc * PAIR_KEYS <= 16384


def _pairwise_keyed(
    docs: torch.Tensor,
    n_valid: int,
    c: int,
    per_row_m: int,
    block_rows: int,
    row_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The keyed pass over ``docs`` from :func:`_score_operand`; ``ok`` is
    a device bool."""
    from .pallas_extract import (
        EXTRACT_H,
        KEY_DEAD,
        KEY_HORIZON,
        PAIR_BLOCK_N,
        PAIR_KEYS,
        PAIR_LIVE_MIN,
        PAIR_MASKED,
        _key_vals,
        pairwise_keys_extract,
    )

    n_padded = docs.shape[0]
    n_blocks = n_padded // block_rows
    nbc = n_padded // PAIR_BLOCK_N
    dev = docs.device
    col_ids = torch.arange(n_padded, device=dev)
    bound_max = torch.full((), PAIR_MASKED, dtype=torch.float32, device=dev)
    in_range = torch.ones((), dtype=torch.bool, device=dev)
    v_parts, c_parts = [], []
    for blk in range(_blocks_to_run(n_valid, n_blocks, block_rows, per_row_m, c)):
        row0 = blk * block_rows
        row_ids = row0 + torch.arange(block_rows, device=dev)
        scores = _block_scores(docs, row_scales, row0, block_rows)
        # finite sentinel, never -inf: an -inf key would destroy lane bits
        scores = torch.where(
            _upper_live(row_ids, col_ids, n_valid), scores, PAIR_MASKED
        )
        t3 = pairwise_keys_extract(scores).view(block_rows, nbc, -1)
        keys = t3[:, :, :PAIR_KEYS].reshape(block_rows, nbc * PAIR_KEYS)
        # Domain guard: keys are exact f32 integers only while |key| < 2^24;
        # a live key at the horizon flips `ok` (KEY_DEAD padding passes).
        live_keys = torch.where(keys == KEY_DEAD, 0.0, keys)
        in_range = in_range & (keys.max() < KEY_HORIZON) & (
            live_keys.min() > -KEY_HORIZON
        )
        sel, pos = top_k(keys, per_row_m)
        vals_q = _key_vals(sel)
        ki = sel.to(torch.int32)
        lane = ki - torch.div(ki, 512, rounding_mode="floor") * 512
        g = torch.div(pos, PAIR_KEYS, rounding_mode="floor")
        sub = torch.div(pos - g * PAIR_KEYS, EXTRACT_H, rounding_mode="floor")
        col = g * PAIR_BLOCK_N + sub * 512 + lane
        # sentinels decode at PAIR_MASKED (-2.0), real pairs at >= -1 - eps
        valid = (
            (col > row_ids[:, None])
            & (col < n_valid)
            & (vals_q > PAIR_LIVE_MIN)
        )
        # Row-level hidden bound before masking: the m-th selected key
        # bounds merge-dropped keys, the subtile 8th-key tails in-subtile
        # drops.
        tails = t3[:, :, EXTRACT_H - 1 : PAIR_KEYS : EXTRACT_H]
        tail_val = _key_vals(tails.reshape(block_rows, -1).amax(dim=1))
        row_bound = torch.maximum(tail_val, vals_q[:, -1])
        bound_max = torch.maximum(bound_max, row_bound.max())
        v_parts.append(torch.where(valid, vals_q, NEG_INF).reshape(-1))
        c_parts.append(torch.where(valid, col, 0).reshape(-1))
    top_v, pos = top_k(torch.cat(v_parts), c)
    # flat index = (blk * block_rows + r) * m + slot -> global row
    rows_out = torch.div(pos, per_row_m, rounding_mode="floor").to(torch.int32)
    cols_out = torch.cat(c_parts)[pos].to(torch.int32)
    ok = (top_v[c - 1] > PAIR_LIVE_MIN) & in_range
    # the boundary slot carries the sound bound on every pair left out
    top_v = torch.cat([top_v[: c - 1], torch.maximum(top_v[c - 1 :], bound_max)])
    return top_v, rows_out, cols_out, ok


def pairwise_candidates_keyed(
    docs: torch.Tensor,
    n_valid: int,
    c: int,
    block_rows: int = 256,
    row_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, bool]:
    """Top-``c`` CANDIDATE pairs by quantized prescore, upper triangle:
    ``(vals f32 [c], rows int32 [c], cols int32 [c], ok)`` sorted
    descending.  ``vals`` are packed-key decodes within ``KEY_EPS`` below
    the block-product score, and ``vals[-1]`` is ``max(weakest candidate,
    hidden-pair bound)`` — the value the rescore margin must clear.
    ``ok`` False (the pool ran short of ``c`` live pairs, or a live key
    reached the f32 rounding horizon) means the caller must take the exact
    path.  Requires :func:`keyed_pairwise_route`."""
    m = keyed_row_width(c, docs.shape[0])
    vals, rows, cols, ok = _pairwise_keyed(
        _score_operand(docs, row_scales), n_valid, c, m, block_rows, row_scales
    )
    return vals, rows, cols, bool(ok)
