"""Host-side top-k helpers in NumPy (copy of ``svs_tpu.utils.topk_np``).

The pairwise finalize orders its rescored candidates with
:func:`top_k_numpy`, and the tests use :func:`top_pairs_numpy` as the
small-n oracle.  Ties: ``argpartition``, then ``sorted(reverse=True)`` over
``(score, index)`` — equal scores come out higher index first.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def top_k_numpy(scores: np.ndarray, k: int) -> List[Tuple[float, int]]:
    """Top ``k`` entries of a 1-D score vector as ``(score, index)`` tuples,
    sorted descending.  ``k`` is clamped to ``len(scores)``; ``k <= 0``
    returns ``[]``.  O(n + k log k) via argpartition."""
    assert scores.ndim == 1
    k = min(int(k), len(scores))
    if k <= 0:
        return []
    part = np.argpartition(scores, -k)[-k:]
    return sorted(((float(scores[i]), int(i)) for i in part), reverse=True)


def top_pairs_numpy(pairwise: np.ndarray, k: int) -> List[Tuple[float, int, int]]:
    """Top ``k`` entries of the strict upper triangle of a square pairwise
    score matrix, as ``(score, row, col)`` tuples sorted descending.
    Materializes the upper triangle: O(n^2) memory, for small n only."""
    assert pairwise.ndim == 2 and pairwise.shape[0] == pairwise.shape[1]
    rows, cols = np.triu_indices_from(pairwise, k=1)
    vals = pairwise[rows, cols]
    return [
        (score, int(rows[i]), int(cols[i])) for score, i in top_k_numpy(vals, k)
    ]
