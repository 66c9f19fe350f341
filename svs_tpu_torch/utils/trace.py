"""Observability: phase timers, per-query stats, and profiler hooks.

The reference's only tracing is log lines bracketing expensive phases
(``svs/kb.py:871-874,1191``).  This module keeps that (INFO logs) and adds:

- :func:`phase` — a context manager timing a named phase, feeding both the
  log and a thread-safe in-process stats registry;
- :class:`QueryStats` — the last-N per-phase timings (pack / embed /
  device search / rescore+hydrate), exposed as ``kb.stats()``;
- :func:`profiler_trace` — when ``SVS_TPU_PROFILE_DIR`` is set (read at
  call time), a ``torch.profiler`` trace of the block (CPU activities, and
  CUDA ones when there is a card) written under ``<dir>/<label>/`` as
  ``svs_tpu``'s ``jax.profiler`` traces are laid out, a Chrome / Perfetto
  trace file, the device synchronised before the profile starts and
  before it stops (a kernel still in flight would be missing from it);
  unset, a
  ``torch.profiler.record_function`` range, so the block shows up as one
  named span in any trace taken around it.
"""

from __future__ import annotations

import contextlib

from .typecheck import typeguard_exempt
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, Optional

log = logging.getLogger("svs_tpu_torch.trace")

# Kineto (torch.profiler's CUDA tracer) keeps CUPTI attached from one profile
# to the next unless TEARDOWN_CUPTI=1.  On an H100 (torch 2.11, CUDA 12.8,
# under a sandboxed kernel) the kept CUPTI loses kernel records: from about
# a minute after its first use, about every other profile keeps none of its
# kernels, so a device call's trace can lack the port's kernels.  With
# TEARDOWN_CUPTI=1 Kineto tears CUPTI down after each profile, and a later
# CUDA call completes that: a profile started before one loses all its
# events, so profiler_trace syncs the device first
# (tools/profiler_kept_kernels.py shows both).  Set at import, before a
# profile is taken; a value the caller set is kept.
os.environ.setdefault("TEARDOWN_CUPTI", "1")




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


#: One trace at a time: ``torch.profiler`` sessions do not nest, so a
#: block that starts while another thread traces is only marked.
_TRACE_LOCK = threading.Lock()


@typeguard_exempt
@contextlib.contextmanager
def profiler_trace(label: str) -> Iterator[None]:
    """Trace a block into ``$SVS_TPU_PROFILE_DIR/<label>/`` when the
    variable is set (the env var is read at CALL time, so setting it after
    import works), else mark it as one named range (a cheap no-op while no
    profiler is recording)."""
    import torch

    profile_dir = os.environ.get("SVS_TPU_PROFILE_DIR")
    if not profile_dir or not _TRACE_LOCK.acquire(blocking=False):
        with torch.profiler.record_function(label):
            yield
        return
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        cuda = torch.cuda.is_available()
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        out = os.path.join(profile_dir, label)
        if cuda:
            # completes the CUPTI teardown of a profile before (above)
            torch.cuda.synchronize()
        with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(out),
        ):
            try:
                with torch.profiler.record_function(label):
                    yield
            finally:
                # the block's kernels may still run: the profile keeps only
                # what finished before it stops
                if cuda:
                    torch.cuda.synchronize()
        log.info("profiler trace of %r written under %s", label, out)
    finally:
        _TRACE_LOCK.release()
