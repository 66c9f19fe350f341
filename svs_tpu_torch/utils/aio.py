"""Async building blocks.

- :func:`locked` — serialize an async function behind one asyncio lock.
- :func:`cached` — async LRU cache with single-flight deduplication of
  concurrent identical calls.
- :class:`EventLoopThread` — a private asyncio event loop running in a
  daemon thread, used by the sync ``KB`` facade to await async embedding
  providers and remote-file resolution without an ambient event loop.

Behavior parity with the reference: ``svs/util.py:32-93`` (locked/cached)
and ``svs/kb.py:1402-1427`` (the private-loop pattern, here factored into a
reusable class instead of being inlined in the KB).
"""

from __future__ import annotations

import asyncio
import functools
import logging
import threading
from collections import OrderedDict
from typing import Any, Awaitable, Callable, Coroutine, Dict, Optional, Tuple, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")


class CrossLoopLock:
    """An async lock that is safe across MULTIPLE event loops.

    ``asyncio.Lock`` wakes waiters with plain ``call_soon`` — correct only
    within one loop.  This package routinely runs several loops at once
    (every sync ``KB`` owns an :class:`EventLoopThread`), and module-level
    ``@locked``/``@cached`` state is shared by all of them, so waiters on
    loop B must be woken from loop A's thread via
    ``call_soon_threadsafe``.  FIFO hand-off: releasing transfers
    ownership directly to the oldest waiter (no thundering herd, no
    executor threads consumed while waiting).
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._held = False
        self._waiters: "OrderedDict[int, Tuple[asyncio.AbstractEventLoop, asyncio.Event]]" = OrderedDict()
        self._next = 0

    async def __aenter__(self) -> "CrossLoopLock":
        loop = asyncio.get_running_loop()
        with self._mu:
            if not self._held:
                self._held = True
                return self
            event = asyncio.Event()
            ticket = self._next
            self._next += 1
            self._waiters[ticket] = (loop, event)
        await event.wait()  # woken OWNING the lock (hand-off in __aexit__)
        return self

    async def __aexit__(self, *exc: Any) -> None:
        with self._mu:
            if self._waiters:
                _, (lp, ev) = self._waiters.popitem(last=False)
                lp.call_soon_threadsafe(ev.set)  # ownership transfers
            else:
                self._held = False


def locked() -> Callable[
    [Callable[..., Awaitable[T]]], Callable[..., Awaitable[T]]
]:
    """Decorator: force calls to an async function to run serially —
    across every event loop in the process (see :class:`CrossLoopLock`)."""

    def decorator(fn: Callable[..., Awaitable[T]]) -> Callable[..., Awaitable[T]]:
        lock = CrossLoopLock()

        @functools.wraps(fn)
        async def wrapper(*args: Any, **kwargs: Any) -> T:
            async with lock:
                return await fn(*args, **kwargs)

        return wrapper

    return decorator


def cached(
    maxsize: Optional[int] = None,
) -> Callable[[Callable[..., Awaitable[T]]], Callable[..., Awaitable[T]]]:
    """Async LRU cache decorator with single-flight semantics.

    Concurrent calls with the same arguments share one in-flight
    computation; the losers wait on loop-local events that the computing
    call sets via ``call_soon_threadsafe``, so deduplication works across
    event loops (several sync ``KB`` instances share one provider cache).
    A failed computation is not cached; one waiter retries.
    ``maxsize=None`` means unbounded.
    """

    def decorator(fn: Callable[..., Awaitable[T]]) -> Callable[..., Awaitable[T]]:
        cache: "OrderedDict[Tuple[Any, ...], T]" = OrderedDict()
        inflight: Dict[
            Tuple[Any, ...],
            "list[Tuple[asyncio.AbstractEventLoop, asyncio.Event]]",
        ] = {}
        mu = threading.Lock()

        @functools.wraps(fn)
        async def wrapper(*args: Any, **kwargs: Any) -> T:
            key = (args, tuple(sorted(kwargs.items())))
            while True:
                with mu:
                    if key in cache:
                        cache.move_to_end(key)
                        return cache[key]
                    waiters = inflight.get(key)
                    if waiters is not None:
                        event = asyncio.Event()
                        waiters.append((asyncio.get_running_loop(), event))
                    else:
                        inflight[key] = []  # we compute
                        event = None
                if event is not None:
                    await event.wait()
                    continue  # either cached now, or the computing call failed
                try:
                    result = await fn(*args, **kwargs)
                    with mu:
                        cache[key] = result
                        if maxsize is not None and len(cache) > maxsize:
                            cache.popitem(last=False)
                    return result
                finally:
                    with mu:
                        woken = inflight.pop(key)
                    for lp, ev in woken:
                        lp.call_soon_threadsafe(ev.set)

        return wrapper

    return decorator


class EventLoopThread:
    """An asyncio event loop owned by a daemon thread.

    ``run(coro)`` submits a coroutine to the loop and blocks the calling
    thread until it completes.  Start is lazy; ``stop()`` is idempotent.
    """

    def __init__(self, name: str = "svs-tpu-loop") -> None:
        self._name = name
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._start_lock = threading.Lock()

    def _ensure_started(self) -> asyncio.AbstractEventLoop:
        with self._start_lock:
            if self._loop is None:
                loop = asyncio.new_event_loop()
                ready = threading.Event()

                def run_loop() -> None:
                    asyncio.set_event_loop(loop)
                    ready.set()
                    loop.run_forever()
                    # Drain cancelled tasks, then close for real.
                    loop.run_until_complete(loop.shutdown_asyncgens())
                    loop.close()

                thread = threading.Thread(target=run_loop, name=self._name, daemon=True)
                thread.start()
                ready.wait()
                self._loop = loop
                self._thread = thread
        assert self._loop is not None
        return self._loop

    def run(self, coro: Coroutine[Any, Any, T]) -> T:
        loop = self._ensure_started()
        future = asyncio.run_coroutine_threadsafe(coro, loop)
        return future.result()

    def stop(self) -> None:
        with self._start_lock:
            loop, thread = self._loop, self._thread
            self._loop = None
            self._thread = None
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
        if thread is not None:
            thread.join()
