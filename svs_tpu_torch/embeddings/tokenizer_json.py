"""A ``tokenizer.json`` interpreter: the ids and attention mask that
``transformers.AutoTokenizer`` (a fast tokenizer over ``tokenizers``)
gives for ``padding="max_length", truncation=True, max_length=L``, with no
``transformers`` or ``tokenizers`` (the machine with the card has
neither).  ``AutoTokenizer`` reads ``tokenizer.json`` first when a
checkpoint has one, so this is what ``svs_tpu``'s local provider runs.

A text goes through the steps of ``tokenizers``' ``encode``:

1. added tokens whose ``normalized`` is false are split out of the raw
   text (leftmost-longest, ``single_word``, ``lstrip`` / ``rstrip``
   absorbing white space);
2. each remaining piece is normalised (:data:`NORMALIZERS`), then the
   added tokens whose ``normalized`` is true are split out of it;
3. each remaining piece is pre-tokenized (:data:`PRE_TOKENIZERS`), pieces
   that come out empty are dropped, and each word goes through the model
   (``WordPiece``, ``BPE``, ``Unigram``);
4. the ids are truncated to ``max_length`` less the post-processor's
   special tokens (from the right, or the left with
   ``truncation_side="left"``), the post-processor adds its special tokens
   (``TemplateProcessing``, ``RobertaProcessing``, ``BertProcessing``,
   ``ByteLevel``, ``Sequence``) and the row is padded to ``max_length``
   with the pad token's id (right, or left with ``padding_side="left"``),
   the mask 1 over the tokens.

``tokenizer_config.json`` and ``special_tokens_map.json`` add what
``transformers`` adds: the pad token (else the tokenizer class's default,
else the file's ``padding``), special tokens and ``added_tokens_decoder``
entries that ``tokenizer.json`` lacks, the padding and truncation sides
(the config's, else the file's ``padding`` / ``truncation`` direction;
``LlamaTokenizerFast`` and ``GemmaTokenizerFast`` pad on the left unless
told otherwise), the options that ``BertTokenizerFast``
(``do_lower_case``, ``strip_accents``, ``tokenize_chinese_chars``) writes
over the file's normalizer and every fast class (``add_prefix_space``,
default false) over a ``ByteLevel`` pre-tokenizer, ``XGLMTokenizerFast``'s
``<madeupwordN>`` special tokens, the post-processor that the Llama
and Gemma classes rebuild from ``add_bos_token`` / ``add_eos_token``, and
the encoder-decoders' classes: BART's and Blenderbot's RoBERTa specials
(BART's ``<mask>`` normalized), mBART's 25 and mBART-50's 52 language
codes as special tokens and the post-processor they rebuild around
``src_lang`` (``$A </s> en_XX``, ``en_XX $A </s>``), Pegasus's
``<mask_1>`` / ``<mask_2>`` and ``<unk_2>`` .. ``<unk_102>`` (the config's
``added_tokens_decoder`` dropped, as its class drops it).  A Llama
tokenizer has no pad token by default, and neither have GPT-2's (GPT-Neo's,
GPT-J's) and Blenderbot-small's fast class, so ``padding="max_length"``
fails there as in ``transformers``.

A component of any other type raises ``NotImplementedError`` naming it;
nothing falls back to another tokenizer.
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import _unicode_data as D
from .bpe import BPEModel, byte_level, gpt2_split, load_vocab_merges, parse_merges
from .precompiled import PrecompiledCharsMap
from .uniset import char_class, is_white_space
from .unigram import UnigramModel
from .wordpiece import WordPieceModel, WordPieceTokenizer, _is_cjk

if TYPE_CHECKING:
    from .blenderbot_small_bpe import BlenderbotSmallTokenizer

TOKENIZER_JSON = "tokenizer.json"
#: What each part of the interpreter reads.
NORMALIZERS = ("Sequence", "NFC", "NFD", "NFKC", "NFKD", "Lowercase", "Strip",
               "StripAccents", "Replace", "Prepend", "BertNormalizer", "Precompiled")
PRE_TOKENIZERS = ("ByteLevel", "Metaspace", "Whitespace", "WhitespaceSplit",
                  "BertPreTokenizer", "Split", "Sequence")
MODELS = ("BPE", "Unigram", "WordPiece")
POST_PROCESSORS = ("TemplateProcessing", "RobertaProcessing", "BertProcessing",
                   "ByteLevel", "Sequence")

#: The special tokens of the tokenizer classes that define defaults for
#: them (``transformers``' ``__init__`` signatures); ``<mask>`` of the
#: RoBERTa family strips the white space to its left.
_ROBERTA_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
                     "cls_token": "<s>", "unk_token": "<unk>", "pad_token": "<pad>",
                     "mask_token": "<mask>"}
_BERT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
                  "cls_token": "[CLS]", "mask_token": "[MASK]"}
#: ``AlbertTokenizerFast`` / ``BigBirdTokenizerFast`` (SentencePiece
#: vocabularies with BERT's ``[CLS] $A [SEP]``).
_ALBERT_SPECIALS = {"bos_token": "[CLS]", "eos_token": "[SEP]", "unk_token": "<unk>",
                    "sep_token": "[SEP]", "pad_token": "<pad>", "cls_token": "[CLS]",
                    "mask_token": "[MASK]"}
_BIG_BIRD_SPECIALS = {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
                      "pad_token": "<pad>", "sep_token": "[SEP]", "mask_token": "[MASK]",
                      "cls_token": "[CLS]"}
#: ``LlamaTokenizerFast`` (no pad token) and ``GemmaTokenizerFast``: a
#: SentencePiece-style BPE whose post-processor the class rebuilds from
#: ``add_bos_token`` / ``add_eos_token``.
_LLAMA_SPECIALS = {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>"}
_GEMMA_SPECIALS = {"unk_token": "<unk>", "bos_token": "<bos>", "eos_token": "<eos>",
                   "pad_token": "<pad>"}
#: ``GPT2TokenizerFast`` (GPT-2, GPT-Neo, GPT-J: no pad token),
#: ``BloomTokenizerFast`` and ``XGLMTokenizerFast``.
_GPT2_SPECIALS = {"unk_token": "<|endoftext|>", "bos_token": "<|endoftext|>",
                  "eos_token": "<|endoftext|>"}
_BLOOM_SPECIALS = {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
                   "pad_token": "<pad>"}
_XGLM_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
                  "cls_token": "<s>", "unk_token": "<unk>", "pad_token": "<pad>"}
#: The encoder-decoders' classes: ``BartTokenizerFast`` and
#: ``BlenderbotTokenizerFast`` (RoBERTa's), ``MBartTokenizerFast``,
#: ``MBart50TokenizerFast`` (no ``bos_token``), ``PegasusTokenizerFast``
#: (``<mask_2>``) and ``BlenderbotSmallTokenizerFast`` (no pad token).
_MBART50_SPECIALS = {k: v for k, v in _ROBERTA_SPECIALS.items() if k != "bos_token"}
_PEGASUS_SPECIALS = {"pad_token": "<pad>", "eos_token": "</s>", "unk_token": "<unk>",
                     "mask_token": "<mask_2>"}
_BLENDERBOT_SMALL_SPECIALS = {"unk_token": "<|endoftext|>", "bos_token": "<|endoftext|>",
                              "eos_token": "<|endoftext|>"}
#: ``FAIRSEQ_LANGUAGE_CODES`` of ``tokenization_mbart_fast.py`` (25) and,
#: extended to 52, of ``tokenization_mbart50_fast.py``.
MBART_LANGUAGE_CODES = [
    "ar_AR", "cs_CZ", "de_DE", "en_XX", "es_XX", "et_EE", "fi_FI", "fr_XX", "gu_IN", "hi_IN",
    "it_IT", "ja_XX", "kk_KZ", "ko_KR", "lt_LT", "lv_LV", "my_MM", "ne_NP", "nl_XX", "ro_RO",
    "ru_RU", "si_LK", "tr_TR", "vi_VN", "zh_CN"]
MBART50_LANGUAGE_CODES = MBART_LANGUAGE_CODES + [
    "af_ZA", "az_AZ", "bn_IN", "fa_IR", "he_IL", "hr_HR", "id_ID", "ka_GE", "km_KH", "mk_MK",
    "ml_IN", "mn_MN", "mr_IN", "pl_PL", "ps_AF", "pt_XX", "sv_SE", "sw_KE", "ta_IN", "te_IN",
    "th_TH", "tl_XX", "uk_UA", "ur_PK", "xh_ZA", "gl_ES", "sl_SI"]
_CLASS_SPECIALS = {
    "GPT2Tokenizer": _GPT2_SPECIALS,
    "BloomTokenizer": _BLOOM_SPECIALS,
    "XGLMTokenizer": _XGLM_SPECIALS,
    "LlamaTokenizer": _LLAMA_SPECIALS,
    "GemmaTokenizer": _GEMMA_SPECIALS,
    "XLMRobertaTokenizer": _ROBERTA_SPECIALS,
    "RobertaTokenizer": _ROBERTA_SPECIALS,
    "BertTokenizer": _BERT_SPECIALS,
    "DistilBertTokenizer": _BERT_SPECIALS,
    "ElectraTokenizer": _BERT_SPECIALS,
    "AlbertTokenizer": _ALBERT_SPECIALS,
    "BigBirdTokenizer": _BIG_BIRD_SPECIALS,
    "BartTokenizer": _ROBERTA_SPECIALS,
    "BlenderbotTokenizer": _ROBERTA_SPECIALS,
    "MBartTokenizer": _ROBERTA_SPECIALS,
    "MBart50Tokenizer": _MBART50_SPECIALS,
    "PegasusTokenizer": _PEGASUS_SPECIALS,
    "BlenderbotSmallTokenizer": _BLENDERBOT_SMALL_SPECIALS,
}
#: The flags of a class's default mask token (a string in the config):
#: it strips the white space to its left; BART's is also normalized.
_MASK_FLAGS = {
    **{c: {"lstrip": True} for c in ("XLMRobertaTokenizer", "RobertaTokenizer", "AlbertTokenizer",
                                     "BigBirdTokenizer", "BlenderbotTokenizer", "MBartTokenizer",
                                     "MBart50Tokenizer")},
    "BartTokenizer": {"lstrip": True, "normalized": True},
}
#: The classes that rebuild the post-processor around the ``src_lang``
#: code (default ``en_XX``): mBART ``$A </s> code``, mBART-50 ``code $A
#: </s>`` (``set_src_lang_special_tokens``).
_LANGUAGE_CODE_CLASSES = {"MBartTokenizer": MBART_LANGUAGE_CODES,
                          "MBart50Tokenizer": MBART50_LANGUAGE_CODES}
#: ``model_type`` -> the tokenizer class ``AutoTokenizer`` picks without a
#: ``tokenizer_class``.
_MODEL_TOKENIZER = {
    "xlm-roberta": "XLMRobertaTokenizer", "roberta": "RobertaTokenizer",
    "bert": "BertTokenizer", "distilbert": "DistilBertTokenizer",
    "electra": "ElectraTokenizer", "albert": "AlbertTokenizer",
    "big_bird": "BigBirdTokenizer", "roberta-prelayernorm": "RobertaTokenizer",
    "llama": "LlamaTokenizer", "mistral": "LlamaTokenizer", "gemma": "GemmaTokenizer",
    "gpt2": "GPT2Tokenizer", "gpt_neo": "GPT2Tokenizer", "gptj": "GPT2Tokenizer",
    "bloom": "BloomTokenizer", "xglm": "XGLMTokenizer",
    "bart": "BartTokenizer", "mbart": "MBartTokenizer", "pegasus": "PegasusTokenizer",
    "blenderbot": "BlenderbotTokenizer", "blenderbot-small": "BlenderbotSmallTokenizer",
}
#: The classes whose ``padding_side`` is ``"left"`` unless the config says,
#: and that rebuild the post-processor (``update_post_processor``): ``bos
#: $A`` with ``add_bos_token`` (default true), ``$A eos`` with
#: ``add_eos_token`` (default false).
_LLAMA_CLASSES = ("LlamaTokenizer", "GemmaTokenizer")
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                 "cls_token", "mask_token")


def _refuse(kind: str, spec: Any, ported: Sequence[str] = ()) -> NotImplementedError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    known = f" (ported: {', '.join(ported)})" if ported else ""
    return NotImplementedError(f"{kind} {name!r} of tokenizer.json is not ported{known}")


# -- patterns -----------------------------------------------------------------


def _complement(ranges: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out, prev = [], 0
    for a, b in sorted(ranges):
        if a > prev:
            out.append((prev, a - 1))
        prev = max(prev, b + 1)
    if prev <= 0x10FFFF:
        out.append((prev, 0x10FFFF))
    return out


def _escapes() -> Dict[str, Sequence[Tuple[int, int]]]:
    """The class escapes of Rust's ``regex`` / Oniguruma (Unicode) whose
    Python ``re`` meaning differs, as code-point ranges."""
    return {
        "s": D.WHITE_SPACE, "S": _complement(D.WHITE_SPACE),
        "w": D.WORD, "W": _complement(D.WORD),
        "p{L}": D.LETTER, "P{L}": _complement(D.LETTER),
        "p{N}": D.NUMBER, "P{N}": _complement(D.NUMBER),
        "pL": D.LETTER, "PL": _complement(D.LETTER),
        "pN": D.NUMBER, "PN": _complement(D.NUMBER),
    }


def _range_text(ranges: Sequence[Tuple[int, int]]) -> str:
    return "".join(
        re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
        for a, b in ranges
    )


def translate_regex(rx: str) -> str:
    r"""A Rust ``regex`` / Oniguruma pattern as a Python ``re`` pattern:
    ``\s \S \w \W \p{L} \p{N}`` (and their negations) become their
    Unicode ranges, inside a bracket expression or outside one; any other
    ``\p{...}`` / ``\P{...}`` class raises ``NotImplementedError``."""
    table = _escapes()
    out: List[str] = []
    i, depth = 0, 0
    while i < len(rx):
        ch = rx[i]
        if ch == "\\" and i + 1 < len(rx):
            nxt = rx[i + 1]
            key = None
            if nxt in "sSwW":
                key = nxt
            elif nxt in "pP":
                m = re.match(r"[pP](\{[^}]*\}|[A-Za-z])", rx[i + 1:])
                key = m.group(0) if m else None
                if key not in table:
                    raise NotImplementedError(f"regex class \\{key or nxt} of tokenizer.json is not ported")
            if key is not None:
                ranges = _range_text(table[key])
                out.append(ranges if depth else f"[{ranges}]")
                i += 1 + len(key)
                continue
            out.append(rx[i:i + 2])
            i += 2
            continue
        if ch == "[":
            depth += 1
        elif ch == "]" and depth:
            depth -= 1
        out.append(ch)
        i += 1
    return "".join(out)


def _pattern(spec: Dict[str, Any], kind: str) -> "re.Pattern[str]":
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern as a Python ``re``
    pattern (:func:`translate_regex`)."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return re.compile(translate_regex(spec["Regex"]))
    raise _refuse(f"{kind} pattern", next(iter(spec), None))


def _segments(text: str, rx: "re.Pattern[str]", invert: bool) -> List[Tuple[int, int, bool]]:
    """``text`` as ``(start, end, is_match)`` segments (empty matches
    skipped)."""
    out = []
    prev = 0
    for m in rx.finditer(text):
        a, b = m.span()
        if a == b:
            continue
        if prev < a:
            out.append((prev, a, invert))
        out.append((a, b, not invert))
        prev = b
    if prev < len(text):
        out.append((prev, len(text), invert))
    return out


def _char_segments(text: str, test: Callable[[str], bool]) -> List[Tuple[int, int, bool]]:
    """Segments for a character pattern: every matching character is a
    match of its own."""
    out = []
    prev = 0
    for i, ch in enumerate(text):
        if test(ch):
            if prev < i:
                out.append((prev, i, False))
            out.append((i, i + 1, True))
            prev = i + 1
    if prev < len(text):
        out.append((prev, len(text), False))
    return out


def _split(segs: List[Tuple[int, int, bool]], behavior: str) -> List[Tuple[int, int]]:
    """``tokenizers``' ``SplitDelimiterBehavior`` over segments."""
    out: List[List[int]] = []
    if behavior == "Removed":
        return [(a, b) for a, b, m in segs if not m]
    if behavior == "Isolated":
        return [(a, b) for a, b, _ in segs]
    prev = False
    if behavior == "MergedWithPrevious":
        for a, b, m in segs:
            if m and not prev and out:
                out[-1][1] = b
            else:
                out.append([a, b])
            prev = m
    elif behavior == "MergedWithNext":
        for a, b, m in reversed(segs):
            if m and not prev and out:
                out[-1][0] = a
            else:
                out.append([a, b])
            prev = m
        out.reverse()
    elif behavior == "Contiguous":
        for a, b, m in segs:
            if out and m == prev:
                out[-1][1] = b
            else:
                out.append([a, b])
            prev = m
    else:
        raise NotImplementedError(f"split behavior {behavior!r} is not ported")
    return [(a, b) for a, b in out]


# -- normalizers --------------------------------------------------------------


def _lowercase(text: str) -> str:
    # character by character (Rust's char::to_lowercase: no final sigma)
    return text.lower() if text.isascii() else "".join(ch.lower() for ch in text)


def _strip_marks(text: str, categories: Tuple[str, ...]) -> str:
    return "".join(ch for ch in text if unicodedata.category(ch) not in categories)


def _bert_normalizer(spec: Dict[str, Any]) -> Callable[[str], str]:
    clean = spec.get("clean_text", True)
    chinese = spec.get("handle_chinese_chars", True)
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lower if strip is None else strip

    def norm(text: str) -> str:
        if clean:
            out = []
            for ch in text:
                cp = ord(ch)
                if cp == 0 or cp == 0xFFFD:
                    continue
                if ch in "\t\n\r":
                    out.append(" ")
                    continue
                if unicodedata.category(ch).startswith("C"):
                    continue
                out.append(" " if is_white_space(ch) else ch)
            text = "".join(out)
        if chinese and not text.isascii():
            text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
        if strip and not text.isascii():
            text = _strip_marks(unicodedata.normalize("NFD", text), ("Mn",))
        if lower:
            text = _lowercase(text)
        return text

    return norm


def _strip(spec: Dict[str, Any]) -> Callable[[str], str]:
    left, right = spec.get("strip_left", True), spec.get("strip_right", True)

    def norm(text: str) -> str:
        a, b = 0, len(text)
        while left and a < b and is_white_space(text[a]):
            a += 1
        while right and b > a and is_white_space(text[b - 1]):
            b -= 1
        return text[a:b]

    return norm


def build_normalizer(spec: Optional[Dict[str, Any]]) -> Optional[Callable[[str], str]]:
    """A ``normalizer`` entry as a ``str -> str`` function (``None``: no
    normalizer)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [build_normalizer(s) for s in spec.get("normalizers", [])]
        fns = [p for p in parts if p is not None]

        def seq(text: str) -> str:
            for fn in fns:
                text = fn(text)
            return text

        return seq
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda text, form=kind: unicodedata.normalize(form, text)
    if kind == "Lowercase":
        return _lowercase
    if kind == "Strip":
        return _strip(spec)
    if kind == "StripAccents":
        return lambda text: text if text.isascii() else _strip_marks(text, ("Mn", "Mc", "Me"))
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"], "Replace"), spec["content"]
        return lambda text: rx.sub(lambda _: content, text)
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda text: prefix + text if text else text
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind == "Precompiled":
        charsmap = spec.get("precompiled_charsmap")
        if not charsmap:
            return None
        return PrecompiledCharsMap(charsmap).normalize
    raise _refuse("normalizer", spec, NORMALIZERS)


# -- pre-tokenizers ----------------------------------------------------------

#: A piece and whether it starts at the start of the text (Metaspace's
#: ``prepend_scheme: "first"`` prepends only there).
Piece = Tuple[str, bool]
PreTokenizer = Callable[[List[Piece]], List[Piece]]


def _each(split: Callable[[str], List[Tuple[int, int]]]) -> PreTokenizer:
    def pre(pieces: List[Piece]) -> List[Piece]:
        out = []
        for text, first in pieces:
            for a, b in split(text):
                if a < b:
                    out.append((text[a:b], first and a == 0))
        return out

    return pre


def _metaspace(spec: Dict[str, Any]) -> PreTokenizer:
    rep = spec.get("replacement", "▁")
    if "prepend_scheme" in spec:
        scheme = spec["prepend_scheme"]
    else:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "never", "first"):
        raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r} is not ported")
    split = spec.get("split", True)
    r = re.escape(rep)
    pieces_rx = re.compile(f"{r}?(?:(?!{r}).)+|{r}", re.DOTALL)

    def pre(pieces: List[Piece]) -> List[Piece]:
        out = []
        for text, first in pieces:
            if not text:
                continue
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
                text = rep + text
            if not split:
                out.append((text, first))
                continue
            # MergedWithNext on the replacement character: a run of them
            # is one piece each, the last one joined to the text after it
            out.extend((m.group(), first and m.start() == 0) for m in pieces_rx.finditer(text))
        return out

    return pre


def _byte_level_pre(spec: Dict[str, Any]) -> PreTokenizer:
    prefix = spec.get("add_prefix_space", True)
    use_regex = spec.get("use_regex", True)

    def pre(pieces: List[Piece]) -> List[Piece]:
        out = []
        for text, first in pieces:
            if not text:
                continue
            if prefix and not text.startswith(" "):
                text = " " + text
            words = gpt2_split(text) if use_regex else [text]
            out.extend((byte_level(w), first and i == 0) for i, w in enumerate(words) if w)
        return out

    return pre


def _is_bert_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


@lru_cache(maxsize=1)
def _whitespace_pattern() -> "re.Pattern[str]":
    """``\\w+|[^\\w\\s]+`` with Rust ``regex``'s Unicode ``\\w`` / ``\\s``."""
    word = char_class(D.WORD)
    other = char_class(D.WORD, D.WHITE_SPACE, negate=True)
    return re.compile(f"{word}+|{other}+")


def build_pre_tokenizer(spec: Optional[Dict[str, Any]]) -> PreTokenizer:
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [build_pre_tokenizer(s) for s in spec.get("pretokenizers", [])]

        def seq(pieces: List[Piece]) -> List[Piece]:
            for p in parts:
                pieces = p(pieces)
            return pieces

        return seq
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "ByteLevel":
        return _byte_level_pre(spec)
    if kind == "WhitespaceSplit":
        return _each(lambda t: _split(_char_segments(t, is_white_space), "Removed"))
    if kind == "Whitespace":
        return _each(lambda t: [m.span() for m in _whitespace_pattern().finditer(t)])
    if kind == "BertPreTokenizer":
        def bert(t: str) -> List[Tuple[int, int]]:
            out = []
            for a, b in _split(_char_segments(t, is_white_space), "Removed"):
                out.extend((a + x, a + y) for x, y in
                           _split(_char_segments(t[a:b], _is_bert_punct), "Isolated"))
            return out

        return _each(bert)
    if kind == "Split":
        rx = _pattern(spec["pattern"], "Split")
        behavior, invert = spec.get("behavior", "Isolated"), bool(spec.get("invert", False))
        return _each(lambda t: _split(_segments(t, rx, invert), behavior))
    raise _refuse("pre_tokenizer", spec, PRE_TOKENIZERS)


# -- models -------------------------------------------------------------------


Model = Union[BPEModel, UnigramModel, WordPieceModel]


def build_model(spec: Dict[str, Any]) -> Model:
    kind = spec.get("type")
    if kind is None:  # files before the model carried its type
        kind = "Unigram" if isinstance(spec.get("vocab"), list) else (
            "BPE" if "merges" in spec else "WordPiece")
    if kind == "Unigram":
        return UnigramModel([(p, s) for p, s in spec["vocab"]], spec.get("unk_id"),
                            byte_fallback=bool(spec.get("byte_fallback", False)))
    if kind == "BPE":
        return BPEModel(
            dict(spec["vocab"]), parse_merges(spec.get("merges", [])),
            unk_token=spec.get("unk_token"),
            continuing_subword_prefix=spec.get("continuing_subword_prefix"),
            end_of_word_suffix=spec.get("end_of_word_suffix"),
            fuse_unk=bool(spec.get("fuse_unk", False)),
            byte_fallback=bool(spec.get("byte_fallback", False)),
            ignore_merges=bool(spec.get("ignore_merges", False)),
            dropout=spec.get("dropout"),
        )
    if kind == "WordPiece":
        return WordPieceModel(
            dict(spec["vocab"]), spec.get("unk_token", "[UNK]"),
            spec.get("continuing_subword_prefix", "##"),
            int(spec.get("max_input_chars_per_word", 100)),
        )
    raise _refuse("model", spec, MODELS)


# -- post-processors ------------------------------------------------------------


def build_post_processor(spec: Optional[Dict[str, Any]]) -> Tuple[List[int], List[int]]:
    """The special ids a single sequence gets before and after its tokens."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind == "Sequence":
        head: List[int] = []
        tail: List[int] = []
        for s in spec.get("processors", []):
            h, t = build_post_processor(s)
            head, tail = h + head, tail + t
        return head, tail
    if kind == "ByteLevel":
        return [], []
    if kind in ("RobertaProcessing", "BertProcessing"):
        return [int(spec["cls"][1])], [int(spec["sep"][1])]
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        head, tail = [], []
        seen = False
        for item in spec.get("single", []):
            if "Sequence" in item:
                if item["Sequence"].get("id") != "A" or seen:
                    raise NotImplementedError(f"TemplateProcessing single item {item!r} is not ported")
                seen = True
            elif "SpecialToken" in item:
                ids = [int(i) for i in specials[item["SpecialToken"]["id"]]["ids"]]
                (tail if seen else head).extend(ids)
            else:
                raise NotImplementedError(f"TemplateProcessing item {item!r} is not ported")
        if not seen:
            raise NotImplementedError("a TemplateProcessing single template without $A is not ported")
        return head, tail
    raise _refuse("post_processor", spec, POST_PROCESSORS)


# -- added tokens --------------------------------------------------------------


class _Added:
    """One added-token set (the non-normalized or the normalized ones)."""

    def __init__(self, tokens: List[Dict[str, Any]], patterns: List[str]) -> None:
        self.tokens = {p: (t, int(t["id"])) for p, t in zip(patterns, tokens)}
        alternation = "|".join(re.escape(p) for p in sorted(self.tokens, key=len, reverse=True) if p)
        self.rx = re.compile(alternation) if alternation else None

    def split(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """``text`` as pieces, an added token's with its id
        (``AddedVocabulary::find_matches``)."""
        if self.rx is None or not text:
            return [(text, None)]
        out: List[Tuple[str, Optional[int]]] = []
        start_offset = 0
        for m in self.rx.finditer(text):
            start, stop = m.span()
            tok, tid = self.tokens[m.group()]
            if tok.get("single_word"):
                before = start == 0 or not _is_word(text[start - 1])
                after = stop == len(text) or not _is_word(text[stop])
                if not (before and after):
                    continue
            if tok.get("lstrip"):
                s = start
                while s > 0 and is_white_space(text[s - 1]):
                    s -= 1
                start = max(s, start_offset)
            if tok.get("rstrip"):
                while stop < len(text) and is_white_space(text[stop]):
                    stop += 1
            if start_offset < start:
                out.append((text[start_offset:start], None))
            out.append((text[start:stop], tid))
            start_offset = stop
        if start_offset < len(text):
            out.append((text[start_offset:], None))
        return out


def _is_word(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


# -- the tokenizer --------------------------------------------------------------


def _token_text(value: Any) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return None if value is None else str(value)


def _model_size(model: Model) -> int:
    if isinstance(model, UnigramModel):
        return len(model.scores)
    return max(model.vocab.values(), default=-1) + 1


def _class_additional(tok_class: str, cfg: Dict[str, Any], given: List[Any]) -> List[Any]:
    """The additional special tokens the class passes on: the config's
    (``given``) and what the class's ``__init__`` adds to them:
    ``XGLMTokenizerFast``'s seven ``<madeupwordN>`` after them, mBART's 25
    language codes before them, mBART-50's 52 after them, and Pegasus's
    ``mask_token_sent`` (``<mask_1>``) first and ``<unk_N>`` up to its
    ``offset`` (103) after them."""
    listed = {_token_text(t) for t in given}
    if tok_class == "XGLMTokenizer":
        return given + [f"<madeupword{i}>" for i in range(7) if f"<madeupword{i}>" not in listed]
    if tok_class == "MBartTokenizer":
        return MBART_LANGUAGE_CODES + [t for t in given if _token_text(t) not in MBART_LANGUAGE_CODES]
    if tok_class == "MBart50Tokenizer":
        return given + [t for t in MBART50_LANGUAGE_CODES if t not in listed]
    if tok_class == "PegasusTokenizer":
        offset, sent = int(cfg.get("offset", 103)), cfg.get("mask_token_sent", "<mask_1>")
        if not cfg.get("additional_special_tokens"):
            return ([sent] if sent is not None else []) + [f"<unk_{i}>" for i in range(2, offset)]
        out = [sent] + given if sent is not None and sent not in listed else list(given)
        return out + [f"<unk_{i}>" for i in range(len(out), offset - 1)]
    return given


def _added_tokens(
    spec: Dict[str, Any], cfg: Dict[str, Any], smap: Dict[str, Any], tok_class: str, model: Model
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """``(added tokens, special tokens)``: ``tokenizer.json``'s added
    tokens, then what ``transformers`` adds to them when it loads the
    files: ``added_tokens_decoder`` entries and special tokens (the
    config's, the map's or the class's defaults) that the file lacks, each
    at its vocabulary id or after the vocabulary."""
    added = [dict(t) for t in spec.get("added_tokens", [])]
    known = {t["content"] for t in added}
    extra = []
    # PegasusTokenizerFast drops the config's added_tokens_decoder
    decoder = {} if tok_class == "PegasusTokenizer" else cfg.get("added_tokens_decoder") or {}
    for key in sorted(decoder, key=int):
        tok = decoder[key]
        if isinstance(tok, dict) and tok.get("content") not in known:
            extra.append(dict(tok))
            known.add(tok["content"])
    defaults = _CLASS_SPECIALS.get(tok_class, {})
    specials: Dict[str, Any] = {}
    for key in _SPECIAL_KEYS:
        value = cfg.get(key, smap.get(key, defaults.get(key)))
        if value is not None:
            specials[key] = value
    more = list(cfg.get("additional_special_tokens", smap.get("additional_special_tokens")) or [])
    more = _class_additional(tok_class, cfg, more)
    for value in list(specials.values()) + list(more):
        content = _token_text(value)
        if content is None or content in known:
            continue
        tok = dict(value) if isinstance(value, dict) else {"content": content}
        if content == _token_text(specials.get("mask_token")) and not isinstance(value, dict):
            tok.update(_MASK_FLAGS.get(tok_class, {}))
        tok.setdefault("normalized", False)
        tok["special"] = True
        extra.append(tok)
        known.add(content)
    next_id = max([_model_size(model)] + [int(t["id"]) + 1 for t in added])
    for tok in extra:
        tid = model.token_to_id(tok["content"])
        if tid is None:
            tid, next_id = next_id, next_id + 1
        added.append({**tok, "id": tid})
    return added, specials


def _class_options(spec: Dict[str, Any], cfg: Dict[str, Any], tok_class: str) -> Dict[str, Any]:
    """``spec`` with the options ``BertTokenizerFast`` writes over the
    file's normalizer, and the ``add_prefix_space`` (default false) that
    every fast tokenizer writes over a ``ByteLevel`` pre-tokenizer
    (``PreTrainedTokenizerFast.__init__``: RoBERTa's, GPT-2's, BLOOM's) (a
    new dict; ``spec`` is not changed)."""
    spec = dict(spec)
    norm = spec.get("normalizer")
    if (tok_class in ("BertTokenizer", "DistilBertTokenizer", "ElectraTokenizer")
            and isinstance(norm, dict) and norm.get("type") == "BertNormalizer"):
        spec["normalizer"] = {**norm, "lowercase": bool(cfg.get("do_lower_case", True)),
                              "strip_accents": cfg.get("strip_accents"),
                              "handle_chinese_chars": bool(cfg.get("tokenize_chinese_chars", True))}
    pre = spec.get("pre_tokenizer")
    if isinstance(pre, dict) and pre.get("type") == "ByteLevel":
        spec["pre_tokenizer"] = {**pre, "add_prefix_space": bool(cfg.get("add_prefix_space", False))}
    return spec


class JsonTokenizer:
    """The tokenizer of a ``tokenizer.json`` (and the ``transformers``
    files beside it).  Thread-safe for concurrent reads; the models' word
    caches are best-effort shared state."""

    def __init__(
        self,
        spec: Dict[str, Any],
        tokenizer_config: Optional[Dict[str, Any]] = None,
        special_tokens_map: Optional[Dict[str, Any]] = None,
        model_type: Optional[str] = None,
    ) -> None:
        cfg = dict(tokenizer_config or {})
        tok_class = str(cfg.get("tokenizer_class") or _MODEL_TOKENIZER.get(str(model_type), "")
                        or "PreTrainedTokenizerFast").removesuffix("Fast")
        self.tokenizer_class = tok_class
        if tok_class == "PegasusTokenizer":
            for key, default in (("pad_token", "<pad>"), ("eos_token", "</s>"), ("unk_token", "<unk>")):
                if key in cfg and _token_text(cfg[key]) != default:
                    raise NotImplementedError(
                        f"{key} {_token_text(cfg[key])!r} in PegasusTokenizer's "
                        "tokenizer_config.json is not ported: transformers rebuilds the "
                        "tokenizer from its SentencePiece model")
        spec = _class_options(spec, cfg, tok_class)
        self.model = build_model(spec["model"])
        self.normalize = build_normalizer(spec.get("normalizer"))
        self.pre_tokenize = build_pre_tokenizer(spec.get("pre_tokenizer"))
        self.head, self.tail = build_post_processor(spec.get("post_processor"))
        # the config's side, else the file's padding / truncation, else the class's
        padding, truncation = spec.get("padding") or {}, spec.get("truncation") or {}
        default_side = "left" if tok_class in _LLAMA_CLASSES else "right"
        self.padding_side = cfg.get("padding_side",
                                    str(padding.get("direction", default_side)).lower())
        self.truncation_side = cfg.get("truncation_side",
                                       str(truncation.get("direction", "right")).lower())
        for side in (self.padding_side, self.truncation_side):
            if side not in ("right", "left"):
                raise NotImplementedError(f"padding / truncation side {side!r} is not ported")

        added, specials = _added_tokens(spec, cfg, dict(special_tokens_map or {}), tok_class,
                                        self.model)
        self.added_ids = {t["content"]: int(t["id"]) for t in added}
        raw = [t for t in added if not t.get("normalized", not t.get("special", False))]
        norm = [t for t in added if t.get("normalized", not t.get("special", False))]
        self._raw = _Added(raw, [t["content"] for t in raw])
        self._norm = _Added(norm, [self.normalize(t["content"]) if self.normalize else t["content"]
                                   for t in norm])
        if tok_class in _LLAMA_CLASSES:
            self.head, self.tail = self._bos_eos(cfg, specials)
        if tok_class in _LANGUAGE_CODE_CLASSES:
            self.head, self.tail = self._language_code(cfg, specials)

        pad = _token_text(specials.get("pad_token"))
        if pad is None and spec.get("padding"):
            pad = spec["padding"].get("pad_token")
        if pad is None:
            raise ValueError(
                "the tokenizer has no pad token, so padding='max_length' fails "
                "in transformers as well"
            )
        pad_id = self.token_to_id(pad)
        if pad_id is None:
            unk = _token_text(specials.get("unk_token"))
            pad_id = self.token_to_id(unk) if unk is not None else None
        if pad_id is None:
            raise ValueError(f"pad token {pad!r} has no id")
        self.pad_id = pad_id

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.added_ids.get(token)
        return tid if tid is not None else self.model.token_to_id(token)

    def _bos_eos(self, cfg: Dict[str, Any], specials: Dict[str, Any]) -> Tuple[List[int], List[int]]:
        """``LlamaTokenizerFast.update_post_processor``: the file's
        post-processor is replaced by ``bos $A`` / ``$A eos`` as
        ``add_bos_token`` (default true) and ``add_eos_token`` (default
        false) say; a token's id is its vocabulary id, else the unknown
        token's (``convert_tokens_to_ids``).  ``add_prefix_space`` makes
        ``transformers`` rebuild the tokenizer from its SentencePiece model,
        which the port does not read."""
        if cfg.get("add_prefix_space") is not None:
            raise NotImplementedError(
                f"add_prefix_space in {self.tokenizer_class}'s tokenizer_config.json is not "
                "ported: transformers rebuilds the tokenizer from its SentencePiece model"
            )
        ends: List[List[int]] = []
        for key, flag, default in (("bos_token", "add_bos_token", True),
                                   ("eos_token", "add_eos_token", False)):
            if not cfg.get(flag, default):
                ends.append([])
                continue
            token = _token_text(specials.get(key))
            if token is None:
                raise ValueError(f"{flag} = True but {key} = None")
            tid = self.token_to_id(token)
            if tid is None:
                unk = _token_text(specials.get("unk_token"))
                tid = self.token_to_id(unk) if unk is not None else None
            if tid is None:
                raise ValueError(f"{key} {token!r} has no id")
            ends.append([tid])
        return ends[0], ends[1]

    def _language_code(self, cfg: Dict[str, Any], specials: Dict[str, Any]
                       ) -> Tuple[List[int], List[int]]:
        """``set_src_lang_special_tokens`` of ``MBartTokenizerFast`` (``$A
        </s> code``) and ``MBart50TokenizerFast`` (``code $A </s>``): the
        file's post-processor is replaced around the config's ``src_lang``
        (default ``en_XX``), a token's id its vocabulary id, else the unknown
        token's; mBART-50 takes only its own 52 codes."""
        code = cfg.get("src_lang") or "en_XX"
        if (self.tokenizer_class == "MBart50Tokenizer"
                and code not in _LANGUAGE_CODE_CLASSES["MBart50Tokenizer"]):
            raise ValueError(f"src_lang {code!r} is not a language code of MBart50Tokenizer")
        unk = _token_text(specials.get("unk_token"))
        ids = []
        for token in (code, _token_text(specials.get("eos_token"))):
            tid = None if token is None else self.token_to_id(token)
            if tid is None and unk is not None:
                tid = self.token_to_id(unk)
            if tid is None:
                raise ValueError(f"{token!r} has no id in {self.tokenizer_class}")
            ids.append(tid)
        lid, eos = ids
        if self.tokenizer_class == "MBartTokenizer":
            return [], [eos, lid]
        return [lid], [eos]

    @classmethod
    def from_dir(cls, path: Union[str, Path], model_type: Optional[str] = None) -> "JsonTokenizer":
        path = Path(path)
        spec = json.loads((path / TOKENIZER_JSON).read_text(encoding="utf-8"))
        cfg = smap = None
        if (path / "tokenizer_config.json").is_file():
            cfg = json.loads((path / "tokenizer_config.json").read_text(encoding="utf-8"))
        if (path / "special_tokens_map.json").is_file():
            smap = json.loads((path / "special_tokens_map.json").read_text(encoding="utf-8"))
        return cls(spec, cfg, smap, model_type)

    # -- encoding ------------------------------------------------------------

    def token_ids(self, text: str, limit: Optional[int] = None) -> List[int]:
        """The ids of ``text`` without the post-processor's tokens; with
        ``limit``, the words after the first ``limit`` ids are not
        tokenized (the first ``limit`` ids are the same as without it)."""
        ids: List[int] = []
        first = True  # the piece that starts the text
        for raw, tid in self._raw.split(text):
            if tid is not None:
                ids.append(tid)
                first = False
                continue
            normed = self.normalize(raw) if self.normalize else raw
            for piece, ntid in self._norm.split(normed):
                if ntid is not None:
                    ids.append(ntid)
                elif piece:
                    for word, _ in self.pre_tokenize([(piece, first)]):
                        ids.extend(self.model.tokenize(word))
                        if limit is not None and len(ids) >= limit:
                            return ids
                first = False
                if limit is not None and len(ids) >= limit:
                    return ids
            first = False
        return ids

    def encode(self, text: str, max_length: int) -> List[int]:
        """The post-processed ids, truncated so that they fit
        ``max_length``."""
        keep = max(0, max_length - len(self.head) - len(self.tail))
        ids = self.token_ids(text, keep if self.truncation_side == "right" else None)
        if len(ids) > keep:
            ids = ids[:keep] if self.truncation_side == "right" else ids[len(ids) - keep:]
        return self.head + ids + self.tail

    def batch(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """``padding='max_length', truncation=True``: ``(input_ids,
        attention_mask)``, both int64 ``[len(texts), width]``, ``width``
        ``max_length`` (or more when the special tokens alone pass it)."""
        rows = [self.encode(t, max_length) for t in texts]
        width = max([max_length] + [len(r) for r in rows])
        ids = np.full((len(texts), width), self.pad_id, dtype=np.int64)
        mask = np.zeros((len(texts), width), dtype=np.int64)
        for i, seq in enumerate(rows):
            if self.padding_side == "right":
                ids[i, : len(seq)] = seq
                mask[i, : len(seq)] = 1
            elif seq:
                ids[i, width - len(seq):] = seq
                mask[i, width - len(seq):] = 1
        return ids, mask


# -- which tokenizer a checkpoint has ---------------------------------------------

#: SentencePiece model files, which the port does not read.
SENTENCEPIECE_FILES = ("sentencepiece.bpe.model", "spiece.model", "tokenizer.model")


def _read_json(path: Path) -> Optional[Dict[str, Any]]:
    return json.loads(path.read_text(encoding="utf-8")) if path.is_file() else None


#: The classes whose ``vocab.json`` + ``merges.txt`` the port reads, as
#: their converters build a ``tokenizer.json`` from them:
#: ``RobertaConverter`` (RoBERTa's, BART's) and ``BlenderbotConverter``.
BYTE_LEVEL_FILE_CLASSES = ("RobertaTokenizer", "BartTokenizer", "BlenderbotTokenizer")


def roberta_spec(path: Union[str, Path], tokenizer_config: Optional[Dict[str, Any]],
                 tok_class: str = "RobertaTokenizer") -> Dict[str, Any]:
    """The ``tokenizer.json`` that ``transformers``' ``RobertaConverter``
    (``RobertaTokenizer``, ``BartTokenizer``) or ``BlenderbotConverter``
    (``BlenderbotTokenizer``) builds from ``vocab.json`` + ``merges.txt``:
    byte-level BPE (no unknown token), the ``ByteLevel`` pre-tokenizer with
    the config's ``add_prefix_space``, and ``<s> ... </s>`` around the ids
    (Blenderbot: ``... </s>``)."""
    cfg = tokenizer_config or {}
    vocab, merges = load_vocab_merges(path)
    ends = {}
    for key in ("eos_token",) if tok_class == "BlenderbotTokenizer" else ("cls_token", "sep_token"):
        token = _token_text(cfg.get(key)) or _ROBERTA_SPECIALS[key]
        if token not in vocab:
            raise ValueError(f"{key} {token!r} is not in vocab.json")
        ends[key] = [token, vocab[token]]
    prefix = bool(cfg.get("add_prefix_space", False))
    if tok_class == "BlenderbotTokenizer":
        eos, eos_id = ends["eos_token"]
        post: Dict[str, Any] = {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": eos, "type_id": 0}}],
            "special_tokens": {eos: {"id": eos, "ids": [eos_id], "tokens": [eos]}}}
    else:
        post = {"type": "RobertaProcessing", "sep": ends["sep_token"], "cls": ends["cls_token"],
                "trim_offsets": True, "add_prefix_space": prefix}
    return {
        "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": prefix,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": post,
        "model": {"type": "BPE", "vocab": vocab, "merges": [list(m) for m in merges],
                  "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False},
    }


def load_tokenizer(
    path: Union[str, Path], model_type: Optional[str] = None
) -> Union[JsonTokenizer, WordPieceTokenizer, "BlenderbotSmallTokenizer"]:
    """The tokenizer of a checkpoint directory, in the order
    ``AutoTokenizer`` finds one: ``tokenizer.json``; else ``vocab.txt``
    (WordPiece); else ``vocab.json`` + ``merges.txt``: the byte-level BPE
    of RoBERTa, BART and Blenderbot (:func:`roberta_spec`), or, for a
    ``blenderbot-small`` config whose ``tokenizer_config.json`` names no
    class, the slow ``BlenderbotSmallTokenizer`` that ``AutoTokenizer``
    picks there (:mod:`.blenderbot_small_bpe`; named, ``transformers`` fails
    to build its fast class from these files, and the port refuses).  A
    directory with only a SentencePiece model raises
    ``NotImplementedError`` naming the file."""
    path = Path(path)
    if (path / TOKENIZER_JSON).is_file():
        return JsonTokenizer.from_dir(path, model_type)
    if (path / "vocab.txt").is_file():
        return WordPieceTokenizer.from_dir(path)
    cfg = _read_json(path / "tokenizer_config.json")
    if (path / "vocab.json").is_file() and (path / "merges.txt").is_file():
        named = (cfg or {}).get("tokenizer_class")
        tok_class = str(named or _MODEL_TOKENIZER.get(str(model_type), "")).removesuffix("Fast")
        if tok_class == "BlenderbotSmallTokenizer" and not named:
            from .blenderbot_small_bpe import BlenderbotSmallTokenizer

            return BlenderbotSmallTokenizer.from_dir(path)
        if tok_class not in BYTE_LEVEL_FILE_CLASSES:
            raise NotImplementedError(
                f"vocab.json + merges.txt for tokenizer_class {tok_class or None!r} "
                f"is not ported (the port reads them as {BYTE_LEVEL_FILE_CLASSES})"
            )
        return JsonTokenizer(roberta_spec(path, cfg, tok_class), cfg,
                             _read_json(path / "special_tokens_map.json"), model_type)
    for name in SENTENCEPIECE_FILES:
        if (path / name).is_file():
            raise NotImplementedError(
                f"{path / name}: a checkpoint whose tokenizer is only a "
                f"SentencePiece model ({name}) is not ported; svs_tpu_torch "
                f"reads {TOKENIZER_JSON}, vocab.txt or vocab.json + merges.txt"
            )
    raise FileNotFoundError(
        f"no tokenizer in {path}: svs_tpu_torch reads {TOKENIZER_JSON}, "
        "vocab.txt or vocab.json + merges.txt"
    )
