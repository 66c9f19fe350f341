"""Int8-quantized scoring (port of ``svs_tpu.ops.quant``).

Storage is symmetric per-row int8 (``q = round(row / (max|row| / 127))``);
queries are quantized per row the same way, the dot runs int8 x int8 with
int32 accumulation, and scores are rescaled to f32.  Quantized scores are
a prescore: the engine's exact f32 rescore of the candidates sets the
returned order and values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .topk import int8_dot, mask_cols, masked_topk, pack_vals_idx

_EPS = 1e-30


def quantize_rows_int8(matrix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization, bit-identical to
    ``svs_tpu.ops.quant.quantize_rows_int8``: the scale is floored at
    1e-30, the rows are DIVIDED by it (never multiplied by a reciprocal),
    rounded half to even and clipped to +-127.

    Returns ``(q int8 [N, d], scales f32 [N])``.
    """
    matrix = matrix.to(torch.float32)
    if matrix.shape[0] == 0:
        return (
            torch.zeros(matrix.shape, dtype=torch.int8, device=matrix.device),
            torch.zeros((0,), dtype=torch.float32, device=matrix.device),
        )
    absmax = matrix.abs().amax(dim=1)
    scales = torch.clamp_min(absmax, _EPS) / 127.0
    q = torch.clamp(torch.round(matrix / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def _int8_scores(
    q_docs: torch.Tensor, row_scales: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    q_queries, query_scales = quantize_rows_int8(queries)
    raw = int8_dot(q_queries, q_docs)  # [B, N] int32
    return raw.to(torch.float32) * row_scales[None, :] * query_scales[:, None]


def score_topk_int8(
    q_docs: torch.Tensor,
    row_scales: torch.Tensor,
    queries: torch.Tensor,
    n_valid: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized scoring + top-k: ``[B, k]`` f32 values and int32 indices."""
    return masked_topk(_int8_scores(q_docs, row_scales, queries), k, n_valid)


def score_topk_int8_packed(
    q_docs: torch.Tensor,
    row_scales: torch.Tensor,
    queries: torch.Tensor,
    n_valid: int,
    k: int,
    wide: bool = False,
) -> torch.Tensor:
    """:func:`score_topk_int8` + result packing."""
    return pack_vals_idx(
        *score_topk_int8(q_docs, row_scales, queries, n_valid, k), wide=wide
    )


def score_topk_int8_extract_packed(
    q_docs: torch.Tensor,
    row_scales: torch.Tensor,
    queries: torch.Tensor,
    n_valid: int,
    k: int,
    wide: bool = False,
) -> torch.Tensor:
    """int8 scoring + the two-pass extraction selection + packing: the
    int8 path for batches above ``FUSED_MAX_BATCH``."""
    from .pallas_extract import extract_topk

    scores = mask_cols(_int8_scores(q_docs, row_scales, queries), n_valid)
    vals, idx = extract_topk(scores, k)
    return pack_vals_idx(vals, idx, wide=wide)
