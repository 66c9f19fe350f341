"""Observability: phase timers, per-query stats, and profiler hooks.

The reference's only tracing is log lines bracketing expensive phases
(``svs/kb.py:871-874,1191``).  This module keeps that (INFO logs) and adds:

- :func:`phase` — a context manager timing a named phase, feeding both the
  log and a thread-safe in-process stats registry;
- :class:`QueryStats` — the last-N per-phase timings (pack / embed /
  device search / rescore+hydrate), exposed as ``kb.stats()``;
- :func:`profiler_trace` — a ``torch.profiler.record_function`` range, so
  a retrieval shows up as one named span in any ``torch.profiler`` trace
  taken around it.
"""

from __future__ import annotations

import contextlib

from .typecheck import typeguard_exempt
import logging
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, Optional

log = logging.getLogger("svs_tpu_torch.trace")




class QueryStats:
    """Thread-safe rolling window of phase timings (seconds)."""

    def __init__(self, window: int = 256) -> None:
        self._lock = threading.Lock()
        self._window = window
        self._phases: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._counts: Dict[str, int] = defaultdict(int)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._phases[name].append(seconds)
            self._counts[name] += 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-phase {count, p50, mean, last} over the rolling window."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for name, samples in self._phases.items():
                values = sorted(samples)
                if not values:
                    continue
                out[name] = {
                    "count": self._counts[name],
                    "p50_s": values[len(values) // 2],
                    "mean_s": sum(values) / len(values),
                    "last_s": samples[-1],
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._phases.clear()
            self._counts.clear()


@typeguard_exempt
@contextlib.contextmanager
def phase(
    name: str,
    stats: Optional[QueryStats] = None,
    level: int = logging.DEBUG,
) -> Iterator[None]:
    """Time a named phase; record into ``stats`` and log at ``level``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if stats is not None:
            stats.record(name, dt)
        log.log(level, "%s: %.3f ms", name, dt * 1e3)


@typeguard_exempt
@contextlib.contextmanager
def profiler_trace(label: str) -> Iterator[None]:
    """Mark a block as one named range for ``torch.profiler`` (a cheap
    no-op while no profiler is recording)."""
    import torch

    with torch.profiler.record_function(label):
        yield
