"""BERT's WordPiece tokenizer, from ``vocab.txt`` and
``tokenizer_config.json``: the ids ``transformers.BertTokenizer`` gives
(and ``DistilBertTokenizer`` and ``ElectraTokenizer``, which read the same
files the same way), with no ``transformers`` (the machine with the card
has none).  :class:`WordPieceModel` is also the ``WordPiece`` model of a
``tokenizer.json`` (:mod:`.tokenizer_json`).

The steps are that tokenizer's, in its order:

1. special tokens in the text (``[CLS]``, ``[SEP]``, ... and any added
   token) are split out whole and map to their ids; with
   ``do_lower_case`` every other character is lowercased, one at a time;
2. each remaining piece is cleaned (NUL, U+FFFD and control characters
   dropped, whitespace mapped to a space), CJK ideographs are spaced
   apart, the text is NFC-normalised and split on whitespace;
3. each word is lowercased (``do_lower_case``), stripped of accents (NFD,
   combining marks dropped: with ``do_lower_case`` unless
   ``strip_accents`` is False, or when ``strip_accents`` is True) and
   split around punctuation (every ASCII non-alphanumeric, and Unicode
   ``P*``);
4. each piece is WordPiece'd by greedy longest match with ``##``
   continuations; a piece over 100 characters, or one with no match, is
   ``[UNK]``;
5. ``[CLS] ... [SEP]``, truncated to ``max_length``, padded with the
   ``[PAD]`` id.

Speed (the pure-Python tokenizer feeds an encoder on the card): ASCII text
skips the per-character Unicode passes; each distinct word's ids are
cached; and a text stops being tokenized once it fills ``max_length`` (the
truncation would drop the rest), so the ids are the same.
"""

from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

#: Characters over which the WordPiece step gives up and emits ``[UNK]``.
MAX_INPUT_CHARS_PER_WORD = 100
#: Distinct words whose ids are kept; the cache starts over past it.
_WORD_CACHE_MAX = 1 << 20

# ASCII control characters (category Cc) are dropped by the cleaning step,
# tab / newline / carriage return become spaces.
_ASCII_CLEAN = {c: None for c in range(32) if chr(c) not in "\t\n\r"}
_ASCII_CLEAN.update({ord("\t"): " ", ord("\n"): " ", ord("\r"): " ", 127: None})
# ASCII punctuation: every non-alphanumeric printable character.
_ASCII_PUNCT = re.compile(r"([!-/:-@\[-`{-~])")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _strip_accents(word: str) -> str:
    if word.isascii():
        return word
    return "".join(
        ch for ch in unicodedata.normalize("NFD", word)
        if unicodedata.category(ch) != "Mn"
    )


def _split_punctuation(word: str) -> List[str]:
    if word.isascii():
        return [p for p in _ASCII_PUNCT.split(word) if p]
    out: List[str] = []
    start_new = True
    for ch in word:
        if _is_punctuation(ch):
            out.append(ch)
            start_new = True
        else:
            if start_new:
                out.append("")
            start_new = False
            out[-1] += ch
    return out


def load_vocab(path: Union[str, Path]) -> Dict[str, int]:
    """``vocab.txt``: one token a line, its id the line number (a repeated
    token keeps its last line, as ``transformers`` reads it)."""
    vocab: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for index, line in enumerate(f.readlines()):
            vocab[line.rstrip("\n")] = index
    return vocab


def _token_text(value: object, default: str) -> str:
    """A special token of ``tokenizer_config.json``: a string, or an
    ``AddedToken`` dict with its ``content``."""
    if isinstance(value, dict):
        return str(value.get("content", default))
    return default if value is None else str(value)


class WordPieceModel:
    """Greedy longest-match WordPiece over one pre-tokenized piece: the
    first sub-word as is, the others with ``continuing_subword_prefix``;
    the whole piece is ``unk_token`` past ``max_input_chars_per_word``
    characters or when a position has no match."""

    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = "[UNK]",
        continuing_subword_prefix: str = "##",
        max_input_chars_per_word: int = MAX_INPUT_CHARS_PER_WORD,
    ) -> None:
        self.vocab = vocab
        self.unk_token = unk_token
        self.unk_id = vocab.get(unk_token)
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def _unk(self) -> List[int]:
        if self.unk_id is None:
            raise ValueError(f"unk_token {self.unk_token!r} is not in the vocabulary")
        return [self.unk_id]

    def tokenize(self, word: str) -> List[int]:
        vocab = self.vocab
        if len(word) > self.max_chars:
            return self._unk()
        ids: List[int] = []
        start, n = 0, len(word)
        while start < n:
            end = n
            found = None
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                found = vocab.get(sub)
                if found is not None:
                    break
                end -= 1
            if found is None:
                return self._unk()
            ids.append(found)
            start = end
        return ids


#: The slow tokenizer classes that read ``vocab.txt`` as ``BertTokenizer``.
WORDPIECE_CLASSES = ("BertTokenizer", "DistilBertTokenizer", "ElectraTokenizer")


class WordPieceTokenizer:
    """``transformers.BertTokenizer``'s ids from a vocabulary.  Thread-safe
    for concurrent reads; the word cache is best-effort shared state."""

    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        strip_accents: Optional[bool] = None,
        tokenize_chinese_chars: bool = True,
        unk_token: str = "[UNK]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        cls_token: str = "[CLS]",
        mask_token: str = "[MASK]",
        added_tokens: Iterable[str] = (),
    ) -> None:
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.unk_token = unk_token
        self.unk_id = vocab.get(unk_token)
        self.cls_id = self._id(cls_token)
        self.sep_id = self._id(sep_token)
        self.pad_id = self._id(pad_token)
        specials = {unk_token, sep_token, pad_token, cls_token, mask_token}
        specials.update(added_tokens)
        self.special_ids = {t: self._id(t) for t in specials if self._id(t) is not None}
        alternation = "|".join(
            re.escape(t) for t in sorted(self.special_ids, key=len, reverse=True)
        )
        self._special_re = re.compile(f"({alternation})") if alternation else None
        self._word_cache: Dict[str, Tuple[int, ...]] = {}
        self._model = WordPieceModel(vocab, unk_token)

    def _id(self, token: str) -> Optional[int]:
        return self.vocab.get(token, self.unk_id)

    @classmethod
    def from_dir(cls, path: Union[str, Path]) -> "WordPieceTokenizer":
        """Read ``vocab.txt`` and (when present) ``tokenizer_config.json``
        from a checkpoint directory."""
        path = Path(path)
        vocab_file = path / "vocab.txt"
        if not vocab_file.is_file():
            raise FileNotFoundError(f"no vocab.txt in {path}")
        config: Dict[str, object] = {}
        cfg_file = path / "tokenizer_config.json"
        if cfg_file.is_file():
            config = json.loads(cfg_file.read_text(encoding="utf-8"))
        tok_class = str(config.get("tokenizer_class") or "BertTokenizer")
        if tok_class.removesuffix("Fast") not in WORDPIECE_CLASSES:
            raise NotImplementedError(
                f"tokenizer_class {tok_class!r} is not a WordPiece tokenizer "
                f"that reads vocab.txt ({WORDPIECE_CLASSES})"
            )
        if not config.get("do_basic_tokenize", True):
            raise NotImplementedError(
                "do_basic_tokenize=False is not ported: svs_tpu_torch's "
                "tokenizer always runs BERT's basic tokenization"
            )
        added = config.get("added_tokens_decoder") or {}
        strip = config.get("strip_accents")
        return cls(
            load_vocab(vocab_file),
            do_lower_case=bool(config.get("do_lower_case", True)),
            strip_accents=None if strip is None else bool(strip),
            tokenize_chinese_chars=bool(config.get("tokenize_chinese_chars", True)),
            unk_token=_token_text(config.get("unk_token"), "[UNK]"),
            sep_token=_token_text(config.get("sep_token"), "[SEP]"),
            pad_token=_token_text(config.get("pad_token"), "[PAD]"),
            cls_token=_token_text(config.get("cls_token"), "[CLS]"),
            mask_token=_token_text(config.get("mask_token"), "[MASK]"),
            added_tokens=[
                _token_text(v, "") for v in added.values() if isinstance(v, dict)
            ],
        )

    # -- the steps -----------------------------------------------------------

    def _clean(self, text: str) -> str:
        """Step 2: cleaning, CJK spacing and NFC (ASCII text needs only the
        cleaning, by a translation table)."""
        if text.isascii():
            return text.translate(_ASCII_CLEAN)
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                out.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return unicodedata.normalize("NFC", "".join(out))

    def _word_ids(self, word: str) -> Tuple[int, ...]:
        """Steps 3-4 on one whitespace-separated word, cached."""
        hit = self._word_cache.get(word)
        if hit is not None:
            return hit
        w = word
        if self.do_lower_case:
            w = w.lower()
            if self.strip_accents is not False:
                w = _strip_accents(w)
        elif self.strip_accents:
            w = _strip_accents(w)
        pieces = " ".join(_split_punctuation(w)).split()
        ids = tuple(i for p in pieces for i in self._model.tokenize(p))  # step 4
        if len(self._word_cache) >= _WORD_CACHE_MAX:
            self._word_cache = {}
        self._word_cache[word] = ids
        return ids

    def _lower(self, text: str) -> str:
        # character by character, as transformers lowercases outside the
        # special tokens (no context-dependent final sigma)
        return text.lower() if text.isascii() else "".join(ch.lower() for ch in text)

    def token_ids(self, text: str, limit: Optional[int] = None) -> List[int]:
        """The ids of ``text`` without ``[CLS]``/``[SEP]``; with ``limit``,
        tokenizing stops once ``limit`` ids are known (the first ``limit``
        ids are the same as without it)."""
        pieces = [text] if self._special_re is None else self._special_re.split(text)
        ids: List[int] = []
        for i, piece in enumerate(pieces):
            if not piece:
                continue
            if i % 2:  # a special token, split out whole
                ids.append(self.special_ids[piece])
            else:
                if self.do_lower_case:
                    piece = self._lower(piece)
                for word in self._clean(piece).split():
                    ids.extend(self._word_ids(word))
                    if limit is not None and len(ids) >= limit:
                        return ids
            if limit is not None and len(ids) >= limit:
                return ids
        return ids

    def encode(self, text: str, max_length: int) -> List[int]:
        """``[CLS] ids [SEP]``, the ids truncated to ``max_length - 2``."""
        keep = max(0, max_length - 2)
        return [self.cls_id] + self.token_ids(text, keep)[:keep] + [self.sep_id]

    def batch(
        self, texts: Sequence[str], max_length: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``padding='max_length', truncation=True``: ``(input_ids,
        attention_mask)``, both int64 ``[len(texts), max_length]``."""
        width = max(max_length, 2)
        ids = np.full((len(texts), width), self.pad_id, dtype=np.int64)
        mask = np.zeros((len(texts), width), dtype=np.int64)
        for row, text in enumerate(texts):
            seq = self.encode(text, max_length)
            ids[row, : len(seq)] = seq
            mask[row, : len(seq)] = 1
        return ids, mask
