"""``transformers``' slow ``BlenderbotSmallTokenizer`` with no
``transformers``: what ``AutoTokenizer`` loads for a ``blenderbot-small``
checkpoint that has ``vocab.json`` + ``merges.txt`` and no
``tokenizer.json`` (``facebook/blenderbot_small-90M``'s files) when its
``tokenizer_config.json`` names no class, since ``AutoTokenizer`` knows no
fast class for the type.

It is not a byte-level BPE: the text splits on white space, each word
gets a space before ``. , ! ? ( )`` and around ``'``, is lower-cased and
merged by the ranks of ``merges.txt`` over its characters with ``</w>`` on
the last, the pieces joined by ``@@`` (``bpe``); a piece not in
``vocab.json`` (looked up lower-cased) is the unknown token's id.  The added
tokens (the config's ``added_tokens_decoder``, ``added_tokens.json``, then
the special tokens ``__start__``, ``__end__``, ``__unk__``, ``__null__`` or
the config's) are split out of the text first, leftmost-longest, with their
``lstrip`` / ``rstrip`` / ``single_word`` flags
(``PreTrainedTokenizer.tokenize``).  No special token is added around the
ids; ``truncation=True`` cuts to ``max_length`` from the config's side
(right by default) and ``padding="max_length"`` pads with ``__null__``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

#: ``BlenderbotSmallTokenizer.__init__``'s special tokens.
SPECIALS = {"bos_token": "__start__", "eos_token": "__end__", "unk_token": "__unk__",
            "pad_token": "__null__"}
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token")


def _text(value: Any) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return None if value is None else str(value)


class BlenderbotSmallTokenizer:
    """The ids and mask of ``BlenderbotSmallTokenizer(texts,
    padding="max_length", truncation=True, max_length=L)``."""

    tokenizer_class = "BlenderbotSmallTokenizer"

    def __init__(self, encoder: Dict[str, int], merges: List[Tuple[str, ...]],
                 tokenizer_config: Optional[Dict[str, Any]] = None,
                 added_tokens: Optional[Dict[str, int]] = None) -> None:
        cfg = dict(tokenizer_config or {})
        self.encoder = encoder
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {}
        self.padding_side = cfg.get("padding_side", "right")
        self.truncation_side = cfg.get("truncation_side", "right")
        for side in (self.padding_side, self.truncation_side):
            if side not in ("right", "left"):
                raise NotImplementedError(f"padding / truncation side {side!r} is not ported")
        # the added tokens, as PreTrainedTokenizer.__init__ collects them:
        # the config's added_tokens_decoder, added_tokens.json, then the
        # special tokens it lacks (at their vocabulary id, else after it)
        added: Dict[int, Dict[str, Any]] = {}
        for key, tok in sorted((cfg.get("added_tokens_decoder") or {}).items(), key=lambda kv: int(kv[0])):
            added[int(key)] = dict(tok)
        for content, tid in (added_tokens or {}).items():
            if int(tid) not in added:
                added[int(tid)] = {"content": content, "normalized": True}
        specials = {k: _text(cfg.get(k, SPECIALS.get(k))) for k in _SPECIAL_KEYS}
        self.specials = {k: v for k, v in specials.items() if v is not None}
        for content in self.specials.values():
            if content in {t["content"] for t in added.values()}:
                continue
            tid = encoder.get(content)
            if tid is None:
                tid = max([len(encoder)] + [i + 1 for i in added])
            added[tid] = {"content": content, "special": True}
        self.added = {t["content"]: (tid, t) for tid, t in added.items()}
        alternation = "|".join(re.escape(c) for c in sorted(self.added, key=len, reverse=True) if c)
        self._rx = re.compile(alternation) if alternation else None
        unk = self.specials.get("unk_token")
        self.unk_id = None if unk is None else self.token_to_id(unk, unknown=False)
        pad = self.specials.get("pad_token")
        if pad is None:
            raise ValueError("the tokenizer has no pad token, so padding='max_length' fails "
                             "in transformers as well")
        pad_id = self.token_to_id(pad)
        if pad_id is None:
            raise ValueError(f"pad token {pad!r} has no id")
        self.pad_id = pad_id

    @classmethod
    def from_dir(cls, path: Union[str, Path]) -> "BlenderbotSmallTokenizer":
        path = Path(path)
        encoder = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
        lines = (path / "merges.txt").read_text(encoding="utf-8").split("\n")[1:-1]
        merges = [tuple(line.split()) for line in lines]
        cfg: Dict[str, Any] = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            if (path / name).is_file():
                cfg.update(json.loads((path / name).read_text(encoding="utf-8")))
        added = None
        if (path / "added_tokens.json").is_file():
            added = json.loads((path / "added_tokens.json").read_text(encoding="utf-8"))
        return cls(encoder, merges, cfg, added)

    def token_to_id(self, token: str, unknown: bool = True) -> Optional[int]:
        """``convert_tokens_to_ids``: an added token's id, else the
        lower-cased piece's, else (with ``unknown``) the unknown token's."""
        hit = self.added.get(token)
        if hit is not None:
            return hit[0]
        tid = self.encoder.get(token.lower())
        return self.unk_id if tid is None and unknown else tid

    def bpe(self, token: str) -> str:
        """``BlenderbotSmallTokenizer.bpe``: one white-space word as
        ``@@ ``-joined pieces, space-separated where punctuation split it."""
        hit = self.cache.get(token)
        if hit is not None:
            return hit
        token = re.sub("([.,!?()])", r" \1", token)
        token = re.sub("(')", r" \1 ", token)
        token = re.sub(r"\s{2,}", " ", token)
        if "\n" in token:
            token = token.replace("\n", " __newln__")
        words = []
        for part in token.split(" "):
            if not part:
                continue
            part = part.lower()
            word = tuple(part[:-1]) + (part[-1] + "</w>",)
            if len(word) < 2:
                words.append(part)
                continue
            while len(word) > 1:
                pairs = set(zip(word, word[1:]))
                bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
                if bigram not in self.ranks:
                    break
                first, second = bigram
                merged: List[str] = []
                i = 0
                while i < len(word):
                    try:
                        j = word.index(first, i)
                    except ValueError:
                        merged.extend(word[i:])
                        break
                    merged.extend(word[i:j])
                    i = j
                    if i < len(word) - 1 and word[i + 1] == second:
                        merged.append(first + second)
                        i += 2
                    else:
                        merged.append(word[i])
                        i += 1
                word = tuple(merged)
            out = "@@ ".join(word)[:-4]
            self.cache[part] = out
            words.append(out)
        return " ".join(words)

    def _split_added(self, text: str) -> List[str]:
        if self._rx is None:
            return [text]
        out: List[str] = []
        start = 0
        for m in self._rx.finditer(text):
            out += [text[start:m.start()], m.group()]
            start = m.end()
        out.append(text[start:])
        return [t for t in out if t]

    def token_ids(self, text: str) -> List[int]:
        """``tokenize`` then ``convert_tokens_to_ids`` (no special tokens)."""
        tokens = self._split_added(text)
        for i, token in enumerate(tokens):
            hit = self.added.get(token)
            if hit is None:
                continue
            flags = hit[1]
            left = tokens[i - 1] if i > 0 else None
            right = tokens[i + 1] if i < len(tokens) - 1 else None
            if flags.get("rstrip") and right:
                tokens[i + 1] = right.lstrip()
            if flags.get("lstrip") and left:
                tokens[i - 1] = left.rstrip()
            if flags.get("single_word") and left and left[-1] != " ":
                tokens[i - 1] += token
                tokens[i] = ""
            elif flags.get("single_word") and right and right[0] != " ":
                tokens[i + 1] = token + tokens[i + 1]
                tokens[i] = ""
        pieces: List[str] = []
        for token in tokens:
            if not token:
                continue
            if token in self.added:
                pieces.append(token)
                continue
            for word in re.findall(r"\S+\n?", token):
                pieces.extend(self.bpe(word).split(" "))
        ids = [self.token_to_id(p) for p in pieces]
        if any(i is None for i in ids):
            raise ValueError("a piece has no id and the tokenizer no unknown token")
        return [int(i) for i in ids if i is not None]

    def encode(self, text: str, max_length: int) -> List[int]:
        """The ids, truncated to ``max_length`` from the truncation side."""
        ids = self.token_ids(text)
        if len(ids) > max_length:
            ids = ids[:max_length] if self.truncation_side == "right" else ids[len(ids) - max_length:]
        return ids

    def batch(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """``padding='max_length', truncation=True``: ``(input_ids,
        attention_mask)``, both int64 ``[len(texts), max_length]``."""
        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int64)
        mask = np.zeros((len(texts), max_length), dtype=np.int64)
        for i, text in enumerate(texts):
            seq = self.encode(text, max_length)
            if not seq:
                continue
            if self.padding_side == "right":
                ids[i, : len(seq)], mask[i, : len(seq)] = seq, 1
            else:
                ids[i, max_length - len(seq):], mask[i, max_length - len(seq):] = seq, 1
        return ids, mask
