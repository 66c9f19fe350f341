"""Drop-in alias for the reference's ``svs.embeddings.util`` module
(``src/svs/embeddings/util.py`` upstream) so code that imported its
helpers directly keeps working after a package swap.

The implementations live where this package's layering puts them: the
LE-f32 blob codec in :mod:`svs_tpu_torch.store.blob` (the on-disk format is a
storage concern) and the magnitude guard in
:mod:`svs_tpu_torch.embeddings.base`.
"""

from __future__ import annotations

from ..store.blob import embedding_from_bytes, embedding_to_bytes
from .base import EMBEDDINGS_MAX_CACHE_SIZE, wrap_embeddings_func_check_magnitude

__all__ = [
    "EMBEDDINGS_MAX_CACHE_SIZE",
    "embedding_from_bytes",
    "embedding_to_bytes",
    "wrap_embeddings_func_check_magnitude",
]
