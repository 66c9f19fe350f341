"""Ollama embeddings provider (local inference server; port of
``svs_tpu.embeddings.ollama``, through the standard-library transport of
:mod:`svs_tpu_torch.embeddings.http`).

POSTs to ``{base_url}/api/embed``.  Base URL resolution order: explicit
argument, ``OLLAMA_BASE_URL`` env var, then ``http://127.0.0.1:11434``.
(Reference parity: ``svs/embeddings/ollama.py:14-93``.)
"""

from __future__ import annotations

import os
from itertools import repeat
from typing import Any, Dict, List, Optional, Tuple

from ..types import EmbeddingFunc
from ..utils.aio import cached
from .base import EMBEDDINGS_MAX_CACHE_SIZE

_DEFAULT_BASE_URL = "http://127.0.0.1:11434"


def make_ollama_embeddings_func(
    model: str,
    truncate: bool = True,
    keep_alive: str = "5m",
    base_url: Optional[str] = None,
) -> EmbeddingFunc:
    params = {
        "provider": "ollama",
        "model": model,
        "truncate": truncate,
        "keep_alive": keep_alive,
        "base_url": base_url,
    }

    async def ollama_embeddings(list_of_strings: List[str]) -> List[List[float]]:
        assert isinstance(list_of_strings, list)
        assert all(isinstance(s, str) for s in list_of_strings)
        url = base_url or os.environ.get("OLLAMA_BASE_URL", _DEFAULT_BASE_URL)
        data = await _ollama_embeddings_endpoint(
            url, tuple(list_of_strings), model, truncate, keep_alive
        )
        embeddings: List[List[float]] = data["embeddings"]
        assert isinstance(embeddings, list)
        assert len(embeddings) == len(list_of_strings)
        for vec in embeddings:
            assert isinstance(vec, list)
            assert all(map(isinstance, vec, repeat(float)))
        return embeddings

    setattr(ollama_embeddings, "__embedding_func_params__", params)
    return ollama_embeddings


@cached(maxsize=EMBEDDINGS_MAX_CACHE_SIZE)
async def _ollama_embeddings_endpoint(
    base_url: str,
    texts: Tuple[str, ...],
    model: str,
    truncate: bool,
    keep_alive: str,
) -> Any:
    from .http import post_json

    payload: Dict[str, Any] = {
        "model": model,
        "truncate": truncate,
        "keep_alive": keep_alive,
        "input": list(texts),
    }
    return await post_json("ollama", f"{base_url}/api/embed", payload)
