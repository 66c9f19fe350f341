"""Embedding providers of the port, and the restore of a provider from
the params a database stores (``svs_tpu.embeddings.make_embeddings_func``).

Only the ``mock`` provider is ported so far; a database that names a remote
or local provider (``openai``, ``ollama``, ``local``) opens once the caller
passes its embedding function explicitly.
"""

from typing import Any, Dict

from ..store.blob import embedding_from_bytes, embedding_to_bytes
from ..types import EmbeddingFunc
from .base import (
    EMBEDDINGS_MAX_CACHE_SIZE,
    wrap_embeddings_func_check_magnitude,
)
from .mock import make_mock_embeddings_func

_PROVIDERS = {
    "mock": make_mock_embeddings_func,
}

#: Providers of ``svs_tpu.embeddings`` that the port does not carry yet.
_NOT_PORTED = ("openai", "ollama", "local")


def make_embeddings_func(
    embedding_func_params: Dict[str, Any], *, trusted: bool = True
) -> EmbeddingFunc:
    """Rebuild an embedding function from its persisted params dict.

    ``params['provider']`` selects the factory; the remaining keys are
    passed through as keyword arguments.  ``trusted`` is accepted for
    signature parity with ``svs_tpu``; it only matters for the providers
    that are not ported yet.
    """
    del trusted
    params = dict(embedding_func_params)
    provider = params.pop("provider")
    if provider in _NOT_PORTED:
        raise NotImplementedError(
            f"the {provider!r} embedding provider is not ported to "
            "svs_tpu_torch yet; pass the embedding function to KB(...) "
            "explicitly"
        )
    try:
        factory = _PROVIDERS[provider]
    except KeyError:
        raise ValueError(f"unknown embedding provider name: {provider}")
    return factory(**params)


__all__ = [
    "EMBEDDINGS_MAX_CACHE_SIZE",
    "embedding_to_bytes",
    "embedding_from_bytes",
    "wrap_embeddings_func_check_magnitude",
    "make_mock_embeddings_func",
    "make_embeddings_func",
]
