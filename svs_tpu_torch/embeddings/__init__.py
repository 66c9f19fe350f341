"""Embedding providers of the port, and the restore of a provider from
the params a database stores (``svs_tpu.embeddings.make_embeddings_func``).

The four providers of ``svs_tpu``: ``mock``, ``openai`` and ``ollama``
(through a standard-library HTTP transport) and ``local`` (an encoder on
the card: the BERT family, DistilBERT, ALBERT, BigBird, or a Llama /
Mistral / Gemma, GPT-2 / GPT-Neo / GPT-J, BLOOM or XGLM decoder, from a
single-file or sharded Flax checkpoint).
Each factory returns an async ``List[str] ->
List[List[float]]`` tagged with ``__embedding_func_params__``, so a
database written by either package reopens in the other with no function
passed.
"""

from typing import Any, Dict, Optional, Union

import torch

from ..store.blob import embedding_from_bytes, embedding_to_bytes
from ..types import EmbeddingFunc
from .base import (
    EMBEDDINGS_MAX_CACHE_SIZE,
    wrap_embeddings_func_check_magnitude,
)
from .local import make_local_embeddings_func
from .mock import make_mock_embeddings_func
from .ollama import make_ollama_embeddings_func
from .openai import make_openai_embeddings_func

_PROVIDERS = {
    "mock": make_mock_embeddings_func,
    "openai": make_openai_embeddings_func,
    "ollama": make_ollama_embeddings_func,
    "local": make_local_embeddings_func,
}


def make_embeddings_func(
    embedding_func_params: Dict[str, Any],
    *,
    trusted: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> EmbeddingFunc:
    """Rebuild an embedding function from its persisted params dict.

    ``params['provider']`` selects the factory; the remaining keys are
    passed through as keyword arguments.  ``device`` (not persisted) is
    where a ``local`` provider runs its encoder; the port's ``KB`` passes
    its own.

    ``trusted=False`` marks params that came from an untrusted source —
    a downloaded/shared database file.  In that mode, as in ``svs_tpu``:

    - a ``local`` provider whose ``model`` is not an existing local
      directory is refused unless the operator opts in with
      ``SVS_TPU_ALLOW_HUB_MODELS=1`` (the port resolves such a name only
      through the local Hugging Face cache, never downloads; the gate
      still keeps a stored name from choosing a cached model to run);
    - a stored ``ollama`` ``base_url`` is DROPPED (the endpoint resolves
      from the operator's own ``OLLAMA_BASE_URL``/default instead): a
      malicious database storing an attacker URL would otherwise receive
      every query and document text the moment the KB is used.
    """
    import logging
    import os

    params = dict(embedding_func_params)
    provider = params.pop("provider")
    try:
        factory = _PROVIDERS[provider]
    except KeyError:
        raise ValueError(f"unknown embedding provider name: {provider}")
    if provider == "ollama" and not trusted and params.get("base_url"):
        logging.getLogger(__name__).warning(
            "ignoring the ollama base_url stored in this database (%r): "
            "endpoints from untrusted database files are not honored — "
            "set OLLAMA_BASE_URL or pass make_ollama_embeddings_func("
            "base_url=...) explicitly to use a non-default server",
            params["base_url"],
        )
        params["base_url"] = None
    if (
        provider == "local"
        and not trusted
        and not os.path.isdir(str(params.get("model", "")))
        and os.environ.get("SVS_TPU_ALLOW_HUB_MODELS") != "1"
    ):
        raise RuntimeError(
            "This database's stored embedding params name a 'local' "
            f"provider with a non-local model {params.get('model')!r}. "
            "Loading it would run a checkpoint named by the database "
            "(from the local Hugging Face cache). If you trust this "
            "database, set SVS_TPU_ALLOW_HUB_MODELS=1 or pass the embedding "
            "function explicitly: KB(path, make_local_embeddings_func(...))."
        )
    if provider == "local" and device is not None:
        params["device"] = device
    return factory(**params)


__all__ = [
    "EMBEDDINGS_MAX_CACHE_SIZE",
    "embedding_to_bytes",
    "embedding_from_bytes",
    "wrap_embeddings_func_check_magnitude",
    "make_mock_embeddings_func",
    "make_openai_embeddings_func",
    "make_ollama_embeddings_func",
    "make_local_embeddings_func",
    "make_embeddings_func",
]
