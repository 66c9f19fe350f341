"""OpenAI embeddings provider (port of ``svs_tpu.embeddings.openai``).

POSTs to ``/v1/embeddings`` with ``encoding_format='float'`` through the
shared timeout+retry transport (:mod:`svs_tpu_torch.embeddings.http`, on
the standard library).
Responses are validated for index alignment and float typing, and cached
through the async single-flight LRU.  API key comes from the ``api_key``
argument or ``OPENAI_API_KEY``; the endpoint honors ``OPENAI_BASE_URL``
(hermetic tests, proxies).
"""

from __future__ import annotations

import os
from itertools import repeat
from typing import Any, Dict, List, Optional, Tuple

from ..types import EmbeddingFunc
from ..utils.aio import cached
from .base import EMBEDDINGS_MAX_CACHE_SIZE

_OPENAI_EMBEDDINGS_URL = "https://api.openai.com/v1/embeddings"
_DEFAULT_MODEL = "text-embedding-3-small"


def make_openai_embeddings_func(
    model: str = _DEFAULT_MODEL,
    api_key: Optional[str] = None,
    dimensions: Optional[int] = None,
    user: Optional[str] = None,
) -> EmbeddingFunc:
    if api_key is None:
        api_key = os.environ.get("OPENAI_API_KEY")

    params = {
        "provider": "openai",
        "model": model,
        "dimensions": dimensions,
    }

    async def openai_embeddings(list_of_strings: List[str]) -> List[List[float]]:
        assert isinstance(list_of_strings, list)
        assert all(isinstance(s, str) for s in list_of_strings)
        if api_key is None:
            raise RuntimeError(
                "No OpenAI API key found! Pass api_key= or set the "
                "OPENAI_API_KEY environment variable."
            )
        data = await _openai_embeddings_endpoint(
            api_key, tuple(list_of_strings), model, dimensions, user
        )
        embeddings: List[List[float]] = []
        for i, item in enumerate(data["data"]):
            assert item["index"] == i
            embeddings.append(item["embedding"])
        assert len(embeddings) == len(list_of_strings)
        for vec in embeddings:
            assert isinstance(vec, list)
            assert all(map(isinstance, vec, repeat(float)))
        return embeddings

    setattr(openai_embeddings, "__embedding_func_params__", params)
    return openai_embeddings


@cached(maxsize=EMBEDDINGS_MAX_CACHE_SIZE)
async def _openai_embeddings_endpoint(
    api_key: str,
    texts: Tuple[str, ...],
    model: str,
    dimensions: Optional[int],
    user: Optional[str],
) -> Any:
    from .http import post_json

    payload: Dict[str, Any] = {
        "input": list(texts),
        "model": model,
        "encoding_format": "float",
    }
    if dimensions is not None:
        payload["dimensions"] = dimensions
    if user is not None:
        payload["user"] = user
    url = os.environ.get("OPENAI_BASE_URL", _OPENAI_EMBEDDINGS_URL)
    return await post_json(
        "openai", url, payload, headers={"Authorization": f"Bearer {api_key}"}
    )
