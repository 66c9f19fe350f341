"""Cross-cutting utilities copied from ``svs_tpu.utils`` (the parts the
port uses): the private event-loop thread, async caching and locking,
chunking, the ``.env`` loader, file/URL/gzip handling, and the NumPy
top-k helpers."""

from .aio import EventLoopThread, cached, locked
from .chunks import chunkify
from .env import load_env
from .files import (
    atomic_gzip_file,
    delete_file_if_exists,
    file_cached_wget,
    resolve_to_local_uncompressed_file,
    try_fetch_remote_sidecar,
)
from .topk_np import top_k_numpy, top_pairs_numpy

__all__ = [
    "load_env",
    "EventLoopThread",
    "cached",
    "locked",
    "chunkify",
    "atomic_gzip_file",
    "delete_file_if_exists",
    "file_cached_wget",
    "resolve_to_local_uncompressed_file",
    "try_fetch_remote_sidecar",
    "top_k_numpy",
    "top_pairs_numpy",
]
