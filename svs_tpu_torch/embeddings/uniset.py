r"""Unicode character classes for Python's ``re``, built from the ranges of
:mod:`._unicode_data` (``re`` has no ``\p{...}``).

A class tests its ranges up to U+FFFF as one bitmap, but ``re`` tests
ranges above U+FFFF one by one, so :func:`char_class` puts those behind a
guard that a BMP character fails at once.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

from . import _unicode_data as D

Ranges = Sequence[Tuple[int, int]]


def _set(ranges: Ranges) -> str:
    return "[" + "".join(
        re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
        for a, b in ranges
    ) + "]"


def char_class(*tables: Ranges, negate: bool = False) -> str:
    """A pattern for one character of the union of ``tables`` (with
    ``negate``, of none of them; a negated class matches any character,
    newlines included)."""
    ranges = sorted(r for table in tables for r in table)
    bmp = [(a, min(b, 0xFFFF)) for a, b in ranges if a <= 0xFFFF]
    astral = [(max(a, 0x10000), b) for a, b in ranges if b > 0xFFFF]
    alts = [_set(bmp)] if bmp else []
    if astral:
        alts.append(f"(?=[\\U00010000-\\U0010FFFF]){_set(astral)}")
    pos = "(?:" + "|".join(alts) + ")"
    return f"(?:(?!{pos})(?s:.))" if negate else pos


#: Rust's ``char::is_whitespace`` and Oniguruma's Unicode ``\s``: the
#: White_Space property (Python's ``str.isspace`` also takes U+001C-1F).
WHITE_SPACE = frozenset(chr(c) for a, b in D.WHITE_SPACE for c in range(a, b + 1))


def is_white_space(ch: str) -> bool:
    return ch in WHITE_SPACE
