"""SentencePiece's precompiled character map: the ``Precompiled``
normalizer that an XLM-R ``tokenizer.json`` carries (its
``precompiled_charsmap``, base64), read and applied as ``tokenizers``
applies it, with no ``tokenizers`` or ``sentencepiece``.

The blob is a little-endian ``u32`` byte size of a darts-clone double
array, that array (``u32`` units), then NUL-terminated replacement
strings; a key's leaf holds the offset of its replacement.  A unit's
label is ``unit & (1 << 31 | 0xFF)``, its "has a leaf" flag bit 8, its
offset ``(unit >> 10) << ((unit & 1 << 9) >> 6)``, a leaf's value
``unit & 0x7FFFFFFF``; a child of a node is at ``node ^ offset ^ byte``.

Normalising (``tokenizers``' ``Precompiled::normalize``) walks the
text's extended grapheme clusters (:mod:`.graphemes`): a cluster of fewer
than 6 UTF-8 bytes whose bytes begin with a key is replaced whole by the
replacement of the shortest such key; any other cluster is replaced
character by character, each character by the replacement of the
shortest key its bytes begin with, or kept.
"""

from __future__ import annotations

import base64
import struct
from typing import Dict, Optional, Union

import numpy as np

from .graphemes import clusters

_CACHE_MAX = 1 << 18


class PrecompiledCharsMap:
    """A precompiled charsmap, from its raw bytes or its base64 text."""

    def __init__(self, blob: Union[bytes, str]) -> None:
        if isinstance(blob, str):
            blob = base64.b64decode(blob)
        if len(blob) < 4:
            raise ValueError("a precompiled charsmap needs at least its 4-byte trie size")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if trie_size % 4 or 4 + trie_size > len(blob):
            raise ValueError(f"a precompiled charsmap's trie size {trie_size} does not fit its blob")
        self._units = np.frombuffer(blob, dtype="<u4", count=trie_size // 4, offset=4).tolist()
        self._normalized = bytes(blob[4 + trie_size :])
        self._cache: Dict[str, Optional[str]] = {}

    def _first_match(self, key: bytes) -> Optional[int]:
        """The value of the shortest key that ``key`` begins with (darts'
        ``commonPrefixSearch``, first result), or ``None``."""
        units = self._units
        unit = units[0]
        node = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for byte in key:
            if byte == 0:
                return None
            node ^= byte
            if node >= len(units):
                return None
            unit = units[node]
            if unit & ((1 << 31) | 0xFF) != byte:
                return None
            node ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                return units[node] & 0x7FFFFFFF
        return None

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement for ``chunk`` (the shortest key its bytes begin
        with), or ``None`` when no key matches."""
        hit = self._cache.get(chunk, self)
        if hit is not self:
            return hit  # type: ignore[return-value]
        value = self._first_match(chunk.encode("utf-8"))
        out = None
        if value is not None:
            end = self._normalized.find(b"\0", value)
            out = self._normalized[value : end if end >= 0 else len(self._normalized)].decode("utf-8")
        if len(self._cache) >= _CACHE_MAX:
            self._cache = {}
        self._cache[chunk] = out
        return out

    def normalize(self, text: str) -> str:
        out = []
        for g in clusters(text):
            if len(g.encode("utf-8")) < 6:
                rep = self.transform(g)
                if rep is not None:
                    out.append(rep)
                    continue
            for ch in g:
                rep = self.transform(ch)
                out.append(ch if rep is None else rep)
        return "".join(out)
