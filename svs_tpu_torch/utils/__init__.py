"""Cross-cutting utilities copied from ``svs_tpu.utils`` (the parts the
port uses): the private event-loop thread, chunking, and file/URL/gzip
handling."""

from .aio import EventLoopThread, locked
from .chunks import chunkify
from .files import (
    atomic_gzip_file,
    delete_file_if_exists,
    file_cached_wget,
    resolve_to_local_uncompressed_file,
    try_fetch_remote_sidecar,
)

__all__ = [
    "EventLoopThread",
    "locked",
    "chunkify",
    "atomic_gzip_file",
    "delete_file_if_exists",
    "file_cached_wget",
    "resolve_to_local_uncompressed_file",
    "try_fetch_remote_sidecar",
]
