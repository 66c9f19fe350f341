"""Environment-variable knobs (the ``SVS_TPU_*`` size budgets, read as
in ``svs_tpu.utils.env``)."""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    """``int(os.environ[name])`` with ``default`` on missing or malformed
    values (malformed gets a one-time warning instead of a silent
    swallow).  The shared parser for all size/budget knobs
    (``SVS_TPU_*_MAX_BYTES`` / ``_MAX_ROWS``)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        if name not in _warned_malformed:  # once per key, not per call
            _warned_malformed.add(name)
            import logging

            logging.getLogger(__name__).warning(
                "ignoring malformed %s=%r (want an integer); using %d",
                name, raw, default,
            )
        return default


_warned_malformed: "set[str]" = set()


def env_float(name: str, default: float) -> float:
    """``float(os.environ[name])`` with ``default`` on missing or malformed
    values (a malformed one warns once), as :func:`env_int`."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        if name not in _warned_malformed:
            _warned_malformed.add(name)
            import logging

            logging.getLogger(__name__).warning(
                "ignoring malformed %s=%r (want a number); using %g",
                name, raw, default,
            )
        return default
