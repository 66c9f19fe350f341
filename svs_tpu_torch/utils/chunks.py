"""Sequence chunking helper (reference parity: ``util.py:236-240``)."""

from __future__ import annotations

from typing import List, Sequence, TypeVar

T = TypeVar("T")


def chunkify(seq: Sequence[T], n: int) -> List[List[T]]:
    """Split ``seq`` into consecutive sublists of length ``n`` (the last one
    may be shorter).  ``n`` must be positive."""
    if n <= 0:
        raise ValueError("n must be positive")
    return [list(seq[i : i + n]) for i in range(0, len(seq), n)]
