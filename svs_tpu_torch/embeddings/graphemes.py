"""Extended grapheme clusters (Unicode UAX #29) with Python's ``re``:
the clusters that ``tokenizers``' ``Precompiled`` normalizer walks (it
cuts with the ``unicode-segmentation`` crate; Python's standard library
has no grapheme segmentation, and the machine with the card has no
``regex`` package).

:func:`clusters` matches UAX #29's extended grapheme cluster expression
(its Table 1b, with the Indic conjunct rule GB9c), written as one ``re``
pattern over the property ranges of :mod:`._unicode_data`::

    CR LF | Control | Prepend* core (Extend | ZWJ | SpacingMark)*
    core = Hangul syllable | RI RI | ExtPict (Extend* ZWJ ExtPict)*
         | conjunct cluster | any other character
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import List

from . import _unicode_data as D
from .uniset import char_class as _cls


@lru_cache(maxsize=1)
def _pattern() -> "re.Pattern[str]":
    crlf = ((0x0A, 0x0A), (0x0D, 0x0D))
    control = _cls(D.CONTROL, crlf)
    zwj = ((0x200D, 0x200D),)
    extend = _cls(D.EXTEND)
    post = _cls(D.EXTEND, zwj, D.SPACING_MARK)
    L, V, T = _cls(D.HANGUL_L), _cls(D.HANGUL_V), _cls(D.HANGUL_T)
    LV, LVT = _cls(D.HANGUL_LV), _cls(D.HANGUL_LVT)
    hangul = f"{L}*(?:{V}+|{LV}{V}*|{LVT}){T}*|{L}+|{T}+"
    ri = _cls(D.REGIONAL_INDICATOR)
    pict = _cls(D.EXTENDED_PICTOGRAPHIC)
    xpicto = f"{pict}(?:{extend}*{_cls(zwj)}{pict})*"
    link_ext = _cls(D.INCB_EXTEND, D.INCB_LINKER)
    cons, linker = _cls(D.INCB_CONSONANT), _cls(D.INCB_LINKER)
    conjunct = f"{cons}(?:{link_ext}*{linker}{link_ext}*{cons})+"
    core = f"(?:{hangul}|{ri}{ri}|{xpicto}|{conjunct}|{_cls(D.CONTROL, crlf, negate=True)})"
    prepend = _cls(D.PREPEND)
    # first, for speed: a character that can only start a cluster alone
    plain = _cls(D.CONTROL, crlf, D.PREPEND, D.HANGUL_L, D.HANGUL_V, D.HANGUL_T,
                 D.HANGUL_LV, D.HANGUL_LVT, D.REGIONAL_INDICATOR,
                 D.EXTENDED_PICTOGRAPHIC, D.INCB_CONSONANT, negate=True)
    return re.compile(
        f"{plain}{post}*|\r\n|{control}|{prepend}*{core}{post}*|.", re.DOTALL
    )


@lru_cache(maxsize=1)
def _joiners() -> "re.Pattern[str]":
    """A character that may share a cluster with a neighbour: without one,
    every character is a cluster of its own."""
    return re.compile(_cls(
        ((0x0D, 0x0D), (0x200D, 0x200D)), D.EXTEND, D.SPACING_MARK, D.PREPEND,
        D.HANGUL_L, D.HANGUL_V, D.HANGUL_T, D.HANGUL_LV, D.HANGUL_LVT,
        D.REGIONAL_INDICATOR, D.EXTENDED_PICTOGRAPHIC,
    ))


def clusters(text: str) -> List[str]:
    """``text`` cut into extended grapheme clusters (their concatenation is
    ``text``)."""
    if text.isascii() and "\r" not in text:
        return list(text)
    if _joiners().search(text) is None:
        return list(text)
    return _pattern().findall(text)
