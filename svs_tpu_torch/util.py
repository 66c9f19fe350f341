"""Drop-in alias for the reference's ``svs.util`` module (copy of
``svs_tpu.util``) so code that imported its helpers directly — ``from
svs.util import get_top_k, cached, file_cached_wget`` — keeps working
after a package swap to this port.

The implementations live in the port's ``utils``: selection oracles in
:mod:`svs_tpu_torch.utils.topk_np`, async caching/locking in
:mod:`svs_tpu_torch.utils.aio`, file/network helpers in
:mod:`svs_tpu_torch.utils.files`, and :func:`chunkify` in
:mod:`svs_tpu_torch.utils.chunks`.  ``get_top_k`` / ``get_top_pairs`` are the
reference's names for :func:`top_k_numpy` / :func:`top_pairs_numpy`
(same algorithm, same tie behavior — see the topk_np module docstring).
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Awaitable, Callable, Optional, TypeVar

from .utils.aio import cached
from .utils.aio import locked as _locked_crossloop
from .utils.chunks import chunkify
from .utils.files import (
    delete_file_if_exists,
    file_cached_wget,
    resolve_to_local_uncompressed_file,
)
from .utils.topk_np import top_k_numpy as get_top_k
from .utils.topk_np import top_pairs_numpy as get_top_pairs

_T = TypeVar("_T")


def locked(
    lock: Optional[asyncio.Lock] = None,
) -> Callable[
    [Callable[..., Awaitable[_T]]], Callable[..., Awaitable[_T]]
]:
    """The reference's ``locked`` accepts an optional caller-supplied
    ``asyncio.Lock`` shared across several functions (ref:
    ``src/svs/util.py:32-49``).  Without one, this package's
    cross-event-loop lock serves (it also serializes calls arriving
    from different loops — see ``utils.aio.CrossLoopLock``); with one,
    the explicit lock is honored reference-style (single-loop
    semantics, as an ``asyncio.Lock`` is loop-bound)."""
    if lock is None:
        return _locked_crossloop()

    def decorator(
        fn: Callable[..., Awaitable[_T]],
    ) -> Callable[..., Awaitable[_T]]:
        @functools.wraps(fn)
        async def wrapper(*args: Any, **kwargs: Any) -> _T:
            async with lock:
                return await fn(*args, **kwargs)

        return wrapper

    return decorator

__all__ = [
    "cached",
    "chunkify",
    "delete_file_if_exists",
    "file_cached_wget",
    "get_top_k",
    "get_top_pairs",
    "locked",
    "resolve_to_local_uncompressed_file",
]
