"""The retrieval engine of the port: the int8 pack on one device and the
verified-exact search pipeline over it."""

from .index import RetrievalEngine
from .packing import PackedCorpus, pack_host

__all__ = ["PackedCorpus", "RetrievalEngine", "pack_host"]
