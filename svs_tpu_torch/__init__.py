"""svs_tpu_torch — the PyTorch/CUDA port of svs_tpu.

Exact top-k retrieval over a single-file SQLite knowledge base, on one
CUDA device, with the int8 selection kernels of ``svs_tpu`` hand-written
in CUDA C++ (``csrc/``): the synchronous :class:`KB` and the asynchronous
:class:`AsyncKB`, metadata filters (``where=``, built by
:func:`meta_filter_predicate` or any predicate) on retrieval and on
pairwise; the HTTP server (:mod:`svs_tpu_torch.serve`), the command line
(``python -m svs_tpu_torch``), the maintenance tools
(:mod:`svs_tpu_torch.tools`), and the embedding providers of
``svs_tpu`` (``mock``, ``openai``, ``ollama``, and ``local``: a BERT
encoder on the card).  The package imports torch and NumPy,
never JAX and never ``svs_tpu``: the two packages share a file format,
not code.
"""

from .embeddings import (
    make_embeddings_func,
    make_local_embeddings_func,
    make_mock_embeddings_func,
    make_ollama_embeddings_func,
    make_openai_embeddings_func,
)
from .kb import KB, AsyncKB, meta_filter_predicate
from .version import __version__

__all__ = [
    "KB",
    "AsyncKB",
    "meta_filter_predicate",
    "make_embeddings_func",
    "make_local_embeddings_func",
    "make_mock_embeddings_func",
    "make_openai_embeddings_func",
    "make_ollama_embeddings_func",
    "__version__",
]
