"""SentencePiece's Unigram model as ``tokenizers`` runs it (the ``Unigram``
model of a ``tokenizer.json``: XLM-R, ``bge-m3``, ``multilingual-e5``),
with no ``tokenizers`` or ``sentencepiece``.

A word (one pre-tokenized piece) is cut by Viterbi over the pieces that
start at each character: a path's score is the sum of its pieces' scores
(f64), a character that begins no one-character piece may also be taken
alone as the unknown piece at ``min(score) - 10``; a node keeps the first
path to reach it with the highest score (a later one must beat it), and
the nodes are visited by start, then by length.  Consecutive unknown
characters are fused into one unknown piece (``fuse_unk``, which
``tokenizers`` always sets for Unigram); a piece's id is its vocabulary
id, or ``unk_id``.  ``byte_fallback`` (unknown characters as ``<0xNN>``
byte pieces) is not ported and is refused by name.

The pieces starting at a position are found by walking a dictionary of
every piece and every prefix of one (a trie's common-prefix search: the
walk stops at the first substring that begins no piece), and each
distinct word's ids are cached, so a 250,002-piece vocabulary runs at the
host's dictionary-lookup rate on text whose words repeat.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: ``tokenizers``' penalty of an unknown character below the lowest score.
UNK_PENALTY = 10.0
_CACHE_MAX = 1 << 20


class UnigramModel:
    def __init__(
        self,
        vocab: Sequence[Tuple[str, float]],
        unk_id: Optional[int],
        byte_fallback: bool = False,
    ) -> None:
        if byte_fallback:
            raise NotImplementedError(
                "Unigram byte_fallback is not ported: svs_tpu_torch's Unigram "
                "maps unknown characters to unk_id only"
            )
        if not vocab:
            raise ValueError("a Unigram model needs a vocabulary")
        self.ids: Dict[str, int] = {}
        self.scores: List[float] = []
        for i, (piece, score) in enumerate(vocab):
            self.ids[piece] = i  # a repeated piece keeps its last id
            self.scores.append(float(score))
        self.unk_id = unk_id
        if unk_id is not None and not 0 <= unk_id < len(self.scores):
            raise ValueError(f"unk_id {unk_id} is outside a {len(self.scores)}-piece vocabulary")
        self.unk_score = min(self.scores) - UNK_PENALTY
        # every piece and every proper prefix of one -> the piece's id, or
        # -1 for a prefix alone: a walk from a start stops at the first
        # substring that begins no piece (the trie's common-prefix search)
        self._walk: Dict[str, int] = {}
        for piece in self.ids:
            for k in range(1, len(piece)):
                self._walk.setdefault(piece[:k], -1)
        self._walk.update(self.ids)
        self._cache: Dict[str, Tuple[int, ...]] = {}

    def token_to_id(self, token: str) -> Optional[int]:
        return self.ids.get(token)

    def pieces(self, word: str) -> List[str]:
        """``word`` cut into pieces (unknown runs fused)."""
        n = len(word)
        if n == 0:
            return []
        walk, scores = self._walk, self.scores
        # best[i]: (score, start, id) of the best path ending at i
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)
        best[0] = (0.0, 0, -1)
        for s in range(n):
            here = best[s]
            till = here[0] if here is not None else 0.0
            single = False
            for end in range(s + 1, n + 1):
                pid = walk.get(word[s:end])
                if pid is None:
                    break
                if pid < 0:
                    continue
                cand = scores[pid] + till
                node = best[end]
                if node is None or cand > node[0]:
                    best[end] = (cand, s, pid)
                if end == s + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(
                        f"character {word[s]!r} has no piece and the Unigram model has no unk_id"
                    )
                cand = self.unk_score + till
                node = best[s + 1]
                if node is None or cand > node[0]:
                    best[s + 1] = (cand, s, self.unk_id)
        out: List[str] = []
        fused: List[str] = []
        end = n
        while end > 0:
            _, start, pid = best[end]  # type: ignore[misc]
            if pid == self.unk_id:
                fused.append(word[start:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(word[start:end])
            end = start
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def tokenize(self, word: str) -> Tuple[int, ...]:
        """The ids of one pre-tokenized piece (cached)."""
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        unk = self.unk_id
        ids = tuple(self.ids.get(p, unk) for p in self.pieces(word))  # type: ignore[misc]
        if len(self._cache) >= _CACHE_MAX:
            self._cache = {}
        self._cache[word] = ids
        return ids
