"""svs_tpu_torch — the PyTorch/CUDA port of svs_tpu.

Exact top-k retrieval over a single-file SQLite knowledge base, on one
CUDA device, with the int8 selection kernels of ``svs_tpu`` hand-written
in CUDA C++ (``csrc/``): the synchronous :class:`KB` and the asynchronous
:class:`AsyncKB`, metadata filters (``where=``, built by
:func:`meta_filter_predicate` or any predicate) on retrieval and on
pairwise.  The package imports torch and NumPy, never JAX and never
``svs_tpu``: the two packages share a file format, not code.
"""

from .embeddings import make_mock_embeddings_func
from .kb import KB, AsyncKB, meta_filter_predicate
from .version import __version__

__all__ = [
    "KB",
    "AsyncKB",
    "make_mock_embeddings_func",
    "meta_filter_predicate",
    "__version__",
]
