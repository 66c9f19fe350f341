"""Environment helpers (copy of ``svs_tpu.utils.env``): the ``.env``
loader of the examples and scripts, and the ``SVS_TPU_*`` size-budget
knobs.

:func:`load_env` gives the reference's ``dotenv.load_dotenv()`` UX
without a hard dependency: ``python-dotenv`` when installed (imported
lazily), else a minimal built-in parser (KEY=VALUE lines, ``#``
comments, optional quotes; never overrides variables already set in the
environment).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union


def load_env(path: Union[str, Path] = ".env") -> bool:
    """Load ``path`` into ``os.environ``; returns True if a file was read."""
    try:
        from dotenv import load_dotenv  # type: ignore[import-not-found]

        return bool(load_dotenv(path))
    except ImportError:
        pass
    p = Path(path)
    if not p.is_file():
        return False
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip()
        if key.startswith("export "):
            key = key[len("export "):].strip()
        val = val.strip()
        # as python-dotenv: a quoted value ends at its closing quote, an
        # unquoted one at an inline ``#`` comment
        if val[:1] in ("'", '"') and len(val) >= 2:
            quote = val[0]
            end = val.find(quote, 1)
            val = val[1:end] if end > 0 else val[1:]
        elif "#" in val:
            val = val.split("#", 1)[0].rstrip()
        if key and key not in os.environ:
            os.environ[key] = val
    return True


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
