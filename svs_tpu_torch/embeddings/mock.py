"""Mock embedding provider: a constant unit vector for every input.

Used by tests and examples that need a provider with no network.  Mirrors
the reference's mock (``svs/embeddings/mock.py:6-21``), including the
``__embedding_func_params__`` tag so it round-trips through a database.
"""

from __future__ import annotations

from typing import List

from ..types import EmbeddingFunc


def make_mock_embeddings_func() -> EmbeddingFunc:
    async def mock_embeddings(list_of_strings: List[str]) -> List[List[float]]:
        return [[1.0, 0.0, 0.0] for _ in list_of_strings]

    setattr(mock_embeddings, "__embedding_func_params__", {"provider": "mock"})
    return mock_embeddings
