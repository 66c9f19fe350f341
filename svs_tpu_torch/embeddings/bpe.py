"""Byte-level BPE as ``tokenizers`` runs it (RoBERTa's tokenizer, and the
``BPE`` model and ``ByteLevel`` pre-tokenizer of a ``tokenizer.json``),
with no ``tokenizers`` or ``regex``.

- :func:`gpt2_split`: GPT-2's split pattern ``'s|'t|'re|'ve|'m|'ll|'d|
  ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, which
  ``tokenizers`` compiles with Oniguruma.  Python's ``re`` has no
  ``\\p{L}`` / ``\\p{N}``, so the classes are written out from
  :mod:`._unicode_data` (``\\s`` is the White_Space property);
- :func:`bytes_to_unicode`: GPT-2's map of the 256 byte values onto
  printable characters, which the ``ByteLevel`` pre-tokenizer applies to
  each piece's UTF-8 bytes;
- :class:`BPEModel`: the merges by rank, as ``tokenizers``' ``Word::
  merge_all`` applies them (the lowest-rank pair first, the leftmost of
  equal ranks), with a per-word cache; ``continuing_subword_prefix``,
  ``end_of_word_suffix``, ``unk_token`` with ``fuse_unk``,
  ``byte_fallback`` and ``ignore_merges``; ``dropout`` is refused.  A
  piece with ``▁`` inside (a SentencePiece-style BPE with no
  pre-tokenizer, as Llama-2's, runs the whole text as one piece) is cut
  before each ``▁`` that no merge can join to the character before it,
  and the parts go through the cache: the same ids;
- :func:`load_vocab_merges`: ``vocab.json`` + ``merges.txt``, the files a
  RoBERTa checkpoint without a ``tokenizer.json`` ships
  (:func:`svs_tpu_torch.embeddings.tokenizer_json.roberta_spec` makes the
  ``tokenizer.json`` that ``transformers`` converts them to).
"""

from __future__ import annotations

import heapq
import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from . import _unicode_data as D
from .uniset import char_class

_CACHE_MAX = 1 << 20
#: SentencePiece's word mark: a piece is cut before it where no merge
#: crosses (:meth:`BPEModel.tokenize`).
_MARK = "\u2581"


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> character map: printable Latin-1 bytes map to
    themselves, the other 68 to U+0100 onwards in byte order."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
    bs += list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def byte_level(piece: str) -> str:
    """``piece``'s UTF-8 bytes as GPT-2's characters."""
    table = bytes_to_unicode()
    return "".join(table[b] for b in piece.encode("utf-8"))


@lru_cache(maxsize=1)
def _gpt2_pattern():
    import re

    letter = char_class(D.LETTER)
    number = char_class(D.NUMBER)
    space = char_class(D.WHITE_SPACE)
    other = char_class(D.WHITE_SPACE, D.LETTER, D.NUMBER, negate=True)
    not_space = char_class(D.WHITE_SPACE, negate=True)
    return re.compile(
        f"'s|'t|'re|'ve|'m|'ll|'d| ?{letter}+| ?{number}+| ?{other}+"
        f"|{space}+(?!{not_space})|{space}+"
    )


def gpt2_split(text: str) -> List[str]:
    """``text`` cut by GPT-2's pattern (every match its own piece)."""
    return _gpt2_pattern().findall(text)


class BPEModel:
    """A ``tokenizers`` BPE model from its vocabulary and merges."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        unk_token: Optional[str] = None,
        continuing_subword_prefix: Optional[str] = None,
        end_of_word_suffix: Optional[str] = None,
        fuse_unk: bool = False,
        byte_fallback: bool = False,
        ignore_merges: bool = False,
        dropout: Optional[float] = None,
    ) -> None:
        if dropout:
            raise NotImplementedError("BPE dropout is not ported (it samples merges at random)")
        self.vocab = vocab
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix or ""
        self.suffix = end_of_word_suffix or ""
        self.fuse_unk = fuse_unk
        self.byte_fallback = byte_fallback
        self.ignore_merges = ignore_merges
        # (left id, right id) -> (rank, merged id); a repeated pair keeps its last rank
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        cut = len(self.prefix)
        for rank, (a, b) in enumerate(merges):
            try:
                key = (vocab[a], vocab[b])
                merged = vocab[a + b[cut:]]
            except KeyError as exc:
                raise ValueError(f"merge {a!r} {b!r}: {exc.args[0]!r} is not in the vocabulary") from None
            self.merges[key] = (rank, merged)
        self._cache: Dict[str, Tuple[int, ...]] = {}
        # The characters that some piece holds right before a ``▁``: a cut
        # before a ``▁`` is exact when the character left of it is a piece
        # of its own (not bytes, not unknown) outside this set, since every
        # token is a piece and a token across the cut would hold both.
        self._joins_mark: Optional[frozenset] = None
        unk_merges = unk_token is not None and any(
            vocab.get(unk_token) in pair for pair in self.merges)
        if _MARK in vocab and not self.prefix and not self.suffix and not unk_merges:
            joins = set()
            for piece in vocab:
                i = piece.find(_MARK, 1)
                while i > 0:
                    joins.add(piece[i - 1])
                    i = piece.find(_MARK, i + 1)
            self._joins_mark = frozenset(joins)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def _symbols(self, word: str) -> List[int]:
        """One id per character (``merge_word``), unknowns as ``unk``."""
        out: List[int] = []
        unk: Optional[int] = None  # a pending unknown run (fuse_unk)
        last = len(word) - 1
        for i, ch in enumerate(word):
            s = ch
            if i and self.prefix:
                s = self.prefix + s
            if i == last and self.suffix:
                s = s + self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(tid)
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(b is not None for b in byte_ids):
                    if unk is not None:
                        out.append(unk)
                        unk = None
                    out.extend(byte_ids)  # type: ignore[arg-type]
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab[self.unk_token]
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = unk_id
        if unk is not None:
            out.append(unk)
        return out

    def _merge(self, sym: List[int]) -> List[int]:
        """``Word::merge_all``: a heap of (rank, position) over adjacent
        pairs; a popped entry whose pair has changed is skipped."""
        merges = self.merges
        n = len(sym)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] < n:
                prv[nxt[right]] = pos
            if prv[pos] >= 0:
                m = merges.get((sym[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = merges.get((new_id, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def _parts(self, word: str) -> List[str]:
        """``word`` cut before each ``▁`` that no merge joins to the
        character on its left (see ``__init__``)."""
        joins, vocab = self._joins_mark, self.vocab
        parts, start = [], 0
        i = word.find(_MARK, 1)
        while i > 0:
            left = word[i - 1]
            if left not in joins and left in vocab:
                parts.append(word[start:i])
                start = i
            i = word.find(_MARK, i + 1)
        parts.append(word[start:])
        return parts

    def tokenize(self, word: str) -> Tuple[int, ...]:
        """The ids of one pre-tokenized piece (cached)."""
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if not word:
            return ()
        if self._joins_mark is not None and not self.ignore_merges:
            parts = self._parts(word)
            if len(parts) > 1:
                return tuple(t for part in parts for t in self.tokenize(part))
        whole = self.vocab.get(word) if self.ignore_merges else None
        ids = (whole,) if whole is not None else tuple(self._merge(self._symbols(word)))
        if len(self._cache) >= _CACHE_MAX:
            self._cache = {}
        self._cache[word] = ids
        return ids


def parse_merges(raw: Sequence[Union[str, Sequence[str]]]) -> List[Tuple[str, str]]:
    """``tokenizer.json`` merges: ``"a b"`` strings, or ``[a, b]`` pairs."""
    out = []
    for m in raw:
        if isinstance(m, str):
            a, b = m.split(" ", 1)
        else:
            a, b = m
        out.append((a, b))
    return out


def load_vocab_merges(path: Union[str, Path]) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """``vocab.json`` and ``merges.txt`` of a directory, read as
    ``RobertaTokenizer`` reads them: the merges are the file's lines but
    its first and its last (``split("\\n")[1:-1]``), a repeated pair kept
    at its first place."""
    path = Path(path)
    vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
    lines = (path / "merges.txt").read_text(encoding="utf-8").split("\n")[1:-1]
    merges = list(dict.fromkeys(tuple(line.split()) for line in lines))
    for m in merges:
        if len(m) != 2:
            raise ValueError(f"merges.txt: {' '.join(m)!r} is not a pair")
    return vocab, merges  # type: ignore[return-value]
