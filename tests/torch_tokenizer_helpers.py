"""Test helpers for the port's tokenizers: a darts-clone double-array
writer for SentencePiece precompiled charsmaps, and seeded strings."""

import json
import struct
import unicodedata

import numpy as np


def build_charsmap(mapping):
    """The bytes of a precompiled charsmap (``u32`` trie size, darts-clone
    units, NUL-terminated replacements) mapping each key string to its
    replacement.  Every node with a child or a leaf gets a block of 256
    units of its own: a child by byte ``c`` of a node whose children sit
    at base ``b`` is unit ``b ^ c`` (= ``b + c``), its leaf unit ``b``."""
    blob = bytearray()
    root = {}
    for key, rep in mapping.items():
        raw = key.encode("utf-8")
        if not raw or b"\0" in raw:
            raise ValueError(f"bad key {key!r}")
        node = root
        for byte in raw:
            node = node.setdefault(byte, {})
        node[None] = len(blob)
        blob += rep.encode("utf-8") + b"\0"
    units = [0] * 256
    next_block = [256]

    def place(node, index):
        """Give ``node`` (its own unit at ``index``) a base and fill it."""
        base = next_block[0]
        next_block[0] += 256
        units.extend([0] * 256)
        offset = index ^ base
        assert offset < 1 << 21
        units[index] |= offset << 10
        if None in node:
            units[index] |= 1 << 8
            units[base] = (1 << 31) | node[None]
        for byte, child in sorted((k, v) for k, v in node.items() if k is not None):
            units[base ^ byte] = byte
            place(child, base ^ byte)

    place(root, 0)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(blob)


#: A charsmap in the spirit of XLM-R's (NFKC-like folds, whitespace to a
#: space, a multi-character key, composed accents, a deleted character):
#: held against ``tokenizers.normalizers.Precompiled``.
CHARSMAP = {
    **{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},  # full-width ASCII
    " ": " ", "　": " ", " ": " ", "\t": " ", "\n": " ",
    "ﬁ": "fi", "ﬂ": "fl", "ﬀ": "ff", "Ⅻ": "XII", "①": "1", "²": "2",
    "é": "é", "ä": "ä", "ô": "ô", "ｅ": "e",
    "​": "", "­": "", "…": "...", "™": "TM", "Å": "Å",
    "각": "각", "가": "가", "é": "é",
}


def seeded_strings(seed, n, pool):
    """``n`` strings of 0-40 draws from ``pool`` joined by seeded
    separators."""
    rng = np.random.default_rng(seed)
    seps = [" ", "", "  ", "\t", "\n", " "]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 40))
        out.append("".join(str(rng.choice(pool)) + str(rng.choice(seps)) for _ in range(k)))
    return out


def nfkc(text):
    return unicodedata.normalize("NFKC", text)


# -- tokenizers of each family, written by transformers / tokenizers --------

#: Words the tiny tokenizers know (several scripts, accents, CJK).
WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "fast", "hello", "world",
         "red", "blue", "big", "small", "happy", "sad", "héllo", "café", "naïve", "мир",
         "привет", "κόσμε", "中文", "字", "مرحبا", "über", "straße"]


def _texts_pool():
    return WORDS + ["Hello", "CAT", "don't", "it's", "x1", "123", "3.14", "!", "?", ",", "...",
                    "ﬁ", "Ｈｅｌｌｏ", " ", " ", "é", "👨‍👩‍👧", "🇫🇷", "한국어",
                    "<mask>", "<s>", "[MASK]", "ΟΔΟΣ", "\t", "unknownword", "zz​zz", "Å"]


def strings(seed, n=200):
    """``n`` seeded strings over :data:`WORDS`, punctuation, white space,
    composed and decomposed accents, emoji, Hangul and special tokens."""
    base = ["", " ", "the cat sat on the mat", "a <mask> b", "x<mask>y", "hello world " * 80]
    return base + seeded_strings(seed, n - len(base), _texts_pool())


def write_unigram_tokenizer(path, seed=0, normalizer="precompiled", prepend_scheme="always"):
    """An XLM-R-layout Unigram tokenizer (``<s>`` 0, ``<pad>`` 1, ``</s>``
    2, ``<unk>`` 3, ``<mask>`` last; Metaspace; ``<s> $A </s>``) saved by
    ``XLMRobertaTokenizerFast``; its normalizer is XLM-R's (``Precompiled``
    on :data:`CHARSMAP`, then ``Replace(" {2,}", " ")``) or NFKC and the
    same ``Replace``.  Returns the vocabulary size."""
    from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors
    from transformers import XLMRobertaTokenizerFast

    rng = np.random.default_rng(seed)
    pieces = []
    for w in WORDS:
        pieces += ["▁" + w, w]
        if len(w) > 3:
            pieces += ["▁" + w[:2], w[2:]]
    chars = sorted(set("".join(WORDS)) | set("abcdefghijklmnopqrstuvwxyz0123456789!?,.'"))
    pieces += chars + ["▁" + c for c in chars] + ["▁"]
    pieces = list(dict.fromkeys(pieces))
    vocab = [("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    vocab += [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces] + [("<mask>", 0.0)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=3, byte_fallback=False))
    first = (normalizers.Precompiled(build_charsmap(CHARSMAP)) if normalizer == "precompiled"
             else normalizers.NFKC())
    tok.normalizer = normalizers.Sequence([first, normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme=prepend_scheme)
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>",
        special_tokens=[("<s>", 0), ("</s>", 2)])
    XLMRobertaTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>", pad_token="<pad>", mask_token="<mask>",
                            cls_token="<s>", sep_token="</s>").save_pretrained(str(path))
    return len(vocab)


def write_bpe_tokenizer(path, seed=0):
    """A RoBERTa byte-level BPE tokenizer trained on seeded strings, saved
    by ``RobertaTokenizerFast`` (``tokenizer.json``, ``vocab.json``,
    ``merges.txt``).  Returns the vocabulary size."""
    from tokenizers import ByteLevelBPETokenizer
    from transformers import RobertaTokenizerFast

    bt = ByteLevelBPETokenizer()
    bt.train_from_iterator(strings(seed, 400), vocab_size=600, min_frequency=1,
                           special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
                           show_progress=False)
    path.mkdir(parents=True, exist_ok=True)
    bt.save_model(str(path))
    tok = RobertaTokenizerFast(str(path / "vocab.json"), str(path / "merges.txt"))
    tok.save_pretrained(str(path))
    return len(tok)


def wordpiece_vocab():
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    tokens += list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~") + ["##s", "##ing", "##ed"]
    tokens += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)] + list("0123456789")
    return list(dict.fromkeys(tokens))


def write_wordpiece_tokenizer(path, cls_name="BertTokenizerFast", lower=True):
    """A WordPiece tokenizer of the named ``transformers`` class (fast:
    ``tokenizer.json`` and ``vocab.txt``; slow: ``vocab.txt``).  Returns
    the vocabulary size."""
    import transformers

    path.mkdir(parents=True, exist_ok=True)
    vocab = wordpiece_vocab()
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    getattr(transformers, cls_name)(str(path / "vocab.txt"), do_lower_case=lower).save_pretrained(str(path))
    return len(vocab)


#: Leading ids of the SentencePiece vocabularies of ``write_sentencepiece_tokenizer``'s
#: layouts: ALBERT's (``albert-base-v2``'s first five pieces) and BigBird's.
SPM_SPECIALS = {
    "albert": ["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"],
    "big_bird": ["<pad>", "<s>", "</s>", "<unk>", "[CLS]", "[SEP]", "[MASK]"],
}


def write_sentencepiece_tokenizer(path, layout="albert", model="unigram", seed=0):
    """A ``tokenizer.json`` in the layout ``transformers``' converter writes
    for an ALBERT (``AlbertConverter``: ``Replace("``")``, ``Replace("''")``,
    NFKD, StripAccents, Lowercase, ``Precompiled`` on :data:`CHARSMAP`,
    ``Replace(" {2,}", " ")``) or a BigBird (``SpmConverter``'s normaliser:
    ``Precompiled``, a right ``Strip``, ``Replace(" {2,}", "▁")``)
    SentencePiece vocabulary: Metaspace, ``[CLS] $A [SEP]``, a Unigram
    model or (``model="bpe"``) a SentencePiece-style BPE (``<unk>``,
    ``fuse_unk``) trained on seeded strings; saved by
    ``AlbertTokenizerFast`` / ``BigBirdTokenizerFast``.  Returns the
    vocabulary size."""
    import transformers
    from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors, trainers

    specials = SPM_SPECIALS[layout]
    unk = specials.index("<unk>")
    rng = np.random.default_rng(seed)
    charsmap = normalizers.Precompiled(build_charsmap(CHARSMAP))
    if layout == "albert":
        norm = normalizers.Sequence([
            normalizers.Replace("``", '"'), normalizers.Replace("''", '"'), normalizers.NFKD(),
            normalizers.StripAccents(), normalizers.Lowercase(), charsmap,
            normalizers.Replace(Regex(" {2,}"), " ")])
    else:
        norm = normalizers.Sequence([charsmap, normalizers.Strip(left=False, right=True),
                                     normalizers.Replace(Regex(" {2,}"), "▁")])
    if model == "unigram":
        pieces = []
        for w in WORDS + ['"', "don", "'", "t"]:
            pieces += ["▁" + w, w]
            if len(w) > 3:
                pieces += ["▁" + w[:2], w[2:]]
        chars = sorted(set("".join(WORDS)) | set("abcdefghijklmnopqrstuvwxyz0123456789!?,.'\""))
        pieces += chars + ["▁" + c for c in chars] + ["▁"]
        pieces = [p for p in dict.fromkeys(pieces) if p not in specials]
        vocab = [(t, 0.0) for t in specials]
        vocab += [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]
        tok = Tokenizer(models.Unigram(vocab, unk_id=unk, byte_fallback=False))
    else:
        tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True, byte_fallback=False))
        tok.normalizer = norm
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        trainer = trainers.BpeTrainer(vocab_size=400, min_frequency=1, special_tokens=specials,
                                      show_progress=False)
        tok.train_from_iterator(strings(seed, 400), trainer)
    tok.normalizer = norm
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="always")
    cls_id, sep_id = specials.index("[CLS]"), specials.index("[SEP]")
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS]:0 $A:0 [SEP]:0", pair="[CLS]:0 $A:0 [SEP]:0 $B:1 [SEP]:1",
        special_tokens=[("[CLS]", cls_id), ("[SEP]", sep_id)])
    cls = "AlbertTokenizerFast" if layout == "albert" else "BigBirdTokenizerFast"
    getattr(transformers, cls)(tokenizer_object=tok).save_pretrained(str(path))
    return tok.get_vocab_size()


#: Leading pieces of the Llama-2 and Gemma vocabularies (``LlamaConverter``,
#: ``GemmaConverter``): the special tokens, then the 256 ``<0xNN>`` byte
#: pieces of the byte fallback.
DECODER_SPECIALS = {"llama": ["<unk>", "<s>", "</s>"],
                    "gemma": ["<pad>", "<eos>", "<bos>", "<unk>"]}


def decoder_tokenizer_spec(layout="llama", seed=0, vocab_size=400):
    """A ``tokenizer.json`` (as a dict) in the layout ``transformers``'
    converter writes for Llama-2 (``Prepend("▁")`` + ``Replace(" ", "▁")``,
    no pre-tokenizer) or Gemma (``Replace(" ", "▁")``, ``Split(" ",
    merged_with_previous)``): a SentencePiece-style BPE with ``<unk>``,
    ``fuse_unk`` and ``byte_fallback``, its alphabet ASCII (every other
    character falls back to ``<0xNN>`` pieces), trained on seeded strings;
    post-processor ``bos $A``."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors, trainers

    specials = DECODER_SPECIALS[layout]
    norm = ([normalizers.Prepend("▁")] if layout == "llama" else []) + [normalizers.Replace(" ", "▁")]
    ascii_only = "".join(chr(c) for c in range(32, 127)) + "▁"
    trainer_tok = Tokenizer(models.BPE(unk_token="<unk>"))
    trainer_tok.normalizer = normalizers.Sequence(norm)
    texts = ["".join(ch for ch in t if ch in ascii_only or ch == " ") for t in strings(seed, 400)]
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, min_frequency=1, show_progress=False,
                                  initial_alphabet=list(ascii_only), limit_alphabet=len(ascii_only))
    trainer_tok.train_from_iterator(texts, trainer)
    trained = json.loads(trainer_tok.to_str())["model"]
    pieces = specials + [f"<0x{b:02X}>" for b in range(256)]
    pieces += [p for p, _ in sorted(trained["vocab"].items(), key=lambda kv: kv[1])
               if p not in pieces]
    vocab = {p: i for i, p in enumerate(pieces)}
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in trained["merges"]]
    tok = Tokenizer(models.BPE(vocab, merges, unk_token="<unk>", fuse_unk=True, byte_fallback=True))
    tok.normalizer = normalizers.Sequence(norm)
    if layout == "gemma":
        tok.pre_tokenizer = pre_tokenizers.Split(" ", "merged_with_previous")
    bos = specials[1] if layout == "llama" else "<bos>"
    tok.post_processor = processors.TemplateProcessing(
        single=f"{bos}:0 $A:0", pair=f"{bos}:0 $A:0 {bos}:1 $B:1",
        special_tokens=[(bos, vocab[bos])])
    from tokenizers import AddedToken

    tok.add_special_tokens([AddedToken(t, normalized=False, special=True) for t in specials])
    return json.loads(tok.to_str())


def write_decoder_tokenizer(path, layout="llama", seed=0, vocab_size=400, **config):
    """:func:`decoder_tokenizer_spec` saved with ``tokenizer_config.json``
    naming ``LlamaTokenizer`` / ``GemmaTokenizer`` (``config`` adds keys:
    ``pad_token``, ``add_eos_token``, ``padding_side``, ...).  Returns the
    vocabulary size."""
    import pathlib

    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    spec = decoder_tokenizer_spec(layout, seed, vocab_size)
    (path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    cls = {"llama": "LlamaTokenizer", "gemma": "GemmaTokenizer"}[layout]
    (path / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": cls, **config}), encoding="utf-8")
    return len(spec["model"]["vocab"])


#: The special tokens of the byte-level BPE layouts, in vocabulary order:
#: GPT-2's one ``<|endoftext|>`` (GPT-Neo's and GPT-J's too) and BLOOM's
#: first four pieces.
BYTE_LEVEL_SPECIALS = {"gpt2": ["<|endoftext|>"], "bloom": ["<unk>", "<s>", "</s>", "<pad>"]}


def write_byte_level_tokenizer(path, layout="gpt2", seed=0, vocab_size=600, **config):
    """A byte-level BPE (``ByteLevel`` pre-tokenizer with GPT-2's split,
    ``ByteLevel`` post-processor) trained on seeded strings, saved by
    ``GPT2TokenizerFast`` (``layout`` ``gpt2``: no pad token unless
    ``config`` names one) or ``BloomTokenizerFast`` (``bloom``); ``config``
    adds keys to ``tokenizer_config.json`` (``pad_token``,
    ``padding_side``, ``add_prefix_space``, ...).  Returns the vocabulary
    size."""
    import pathlib

    from tokenizers import ByteLevelBPETokenizer
    from transformers import BloomTokenizerFast, GPT2TokenizerFast

    path = pathlib.Path(path)
    bt = ByteLevelBPETokenizer()
    bt.train_from_iterator(strings(seed, 400), vocab_size=vocab_size, min_frequency=1,
                           special_tokens=BYTE_LEVEL_SPECIALS[layout], show_progress=False)
    cls = GPT2TokenizerFast if layout == "gpt2" else BloomTokenizerFast
    tok = cls(tokenizer_object=bt._tokenizer)
    tok.save_pretrained(str(path))
    cfg = json.loads((path / "tokenizer_config.json").read_text(encoding="utf-8"))
    cfg.update(config)
    (path / "tokenizer_config.json").write_text(json.dumps(cfg), encoding="utf-8")
    return len(tok)


def write_xglm_tokenizer(path, seed=0, **config):
    """A Unigram tokenizer in XGLM's layout (``<s>`` 0, ``<pad>`` 1,
    ``</s>`` 2, ``<unk>`` 3, the pieces, then the seven ``<madeupwordN>``;
    NFKC and ``Replace(" {2,}", " ")`` in place of the ``Precompiled``
    charsmap, Metaspace, ``</s> $A``) saved by ``XGLMTokenizerFast``;
    ``config`` adds keys to ``tokenizer_config.json``.  Returns the
    vocabulary size."""
    import pathlib

    from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors
    from transformers import XGLMTokenizerFast

    path = pathlib.Path(path)
    rng = np.random.default_rng(seed)
    pieces = []
    for w in WORDS:
        pieces += ["▁" + w, w]
    chars = sorted(set("".join(WORDS)) | set("abcdefghijklmnopqrstuvwxyz0123456789!?,.'"))
    pieces = list(dict.fromkeys(pieces + chars + ["▁" + c for c in chars] + ["▁"]))
    vocab = [("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    vocab += [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]
    vocab += [(f"<madeupword{i}>", 0.0) for i in range(7)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=3, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([normalizers.NFKC(),
                                           normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="</s> $A", pair="</s> $A </s> </s> $B", special_tokens=[("<s>", 0), ("</s>", 2)])
    XGLMTokenizerFast(tokenizer_object=tok).save_pretrained(str(path))
    cfg = json.loads((path / "tokenizer_config.json").read_text(encoding="utf-8"))
    cfg.update(config)
    (path / "tokenizer_config.json").write_text(json.dumps(cfg), encoding="utf-8")
    return len(vocab)


#: The special tokens of the encoder-decoders' byte-level layouts, in
#: vocabulary order: RoBERTa's (BART), Blenderbot-3B's (``<pad>`` 0,
#: ``<s>`` 1, ``</s>`` 2) and Blenderbot-90M's (``__null__`` 0,
#: ``__start__`` 1, ``__end__`` 2, ``__unk__`` 3).
SEQ2SEQ_BYTE_LEVEL = {
    "bart": ("BartTokenizerFast", ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]),
    "blenderbot": ("BlenderbotTokenizerFast", ["<pad>", "<s>", "</s>", "<unk>", "<mask>"]),
    "blenderbot-small": ("BlenderbotSmallTokenizerFast",
                         ["__null__", "__start__", "__end__", "__unk__"]),
}


def _save_with_config(tok, path, config, **save):
    tok.save_pretrained(str(path), **save)
    cfg = json.loads((path / "tokenizer_config.json").read_text(encoding="utf-8"))
    cfg.update(config)
    (path / "tokenizer_config.json").write_text(json.dumps(cfg), encoding="utf-8")


def write_seq2seq_tokenizer(path, layout, seed=0, files="json", **config):
    """An encoder-decoder type's tokenizer, saved by its fast class
    (``config`` adds keys to ``tokenizer_config.json``).  Returns the
    vocabulary size (added tokens included).

    - ``bart``, ``blenderbot``, ``blenderbot-small``: byte-level BPE trained
      on seeded strings with :data:`SEQ2SEQ_BYTE_LEVEL`'s specials and the
      converter's post-processor (``RobertaProcessing``; ``$A </s>``; none);
      with ``files="vocab"`` only ``vocab.json`` + ``merges.txt`` and a
      ``tokenizer_config.json`` naming the class (``BartTokenizer``,
      ``BlenderbotTokenizer``; Blenderbot-small's ``tokenizer_class`` only
      if ``config`` names it); Blenderbot-small with ``files="slow"``:
      :func:`write_blenderbot_small_slow`;
    - ``mbart`` / ``mbart50``: an XLM-R-layout Unigram (NFKC, Metaspace) with
      the converter's language codes and ``<mask>`` after the pieces and its
      post-processor (``$A </s> en_XX`` / ``en_XX $A </s>``);
    - ``pegasus``: Pegasus's Unigram layout (``<pad>``, ``</s>``,
      ``<mask_1>``, ``<mask_2>``, ``<unk_2>`` .. ``<unk_102>``, ``<unk>``
      105, the pieces; NFKC, WhitespaceSplit + Metaspace, ``$A </s>``)."""
    import pathlib

    import transformers as T
    from tokenizers import (ByteLevelBPETokenizer, Regex, Tokenizer, models, normalizers,
                            pre_tokenizers, processors)

    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if files == "slow":
        return write_blenderbot_small_slow(path, seed, **config)
    if layout in SEQ2SEQ_BYTE_LEVEL:
        cls, specials = SEQ2SEQ_BYTE_LEVEL[layout]
        bt = ByteLevelBPETokenizer()
        bt.train_from_iterator(strings(seed, 400), vocab_size=600, min_frequency=1,
                               special_tokens=specials, show_progress=False)
        vocab = bt.get_vocab()
        if files == "vocab":
            bt.save_model(str(path))
            cfg = {} if layout == "blenderbot-small" else {"tokenizer_class": cls[:-4]}
            (path / "tokenizer_config.json").write_text(json.dumps({**cfg, **config}),
                                                        encoding="utf-8")
            return len(vocab)
        if layout == "bart":
            bt._tokenizer.post_processor = processors.RobertaProcessing(
                ("</s>", vocab["</s>"]), ("<s>", vocab["<s>"]))
        elif layout == "blenderbot":
            bt._tokenizer.post_processor = processors.TemplateProcessing(
                single="$A:0 </s>:0", special_tokens=[("</s>", vocab["</s>"])])
        tok = getattr(T, cls)(tokenizer_object=bt._tokenizer)
        _save_with_config(tok, path, config, legacy_format=False)
        return len(tok)
    rng = np.random.default_rng(seed)
    pieces = []
    for w in WORDS:
        pieces += ["▁" + w, w]
        if len(w) > 3:
            pieces += ["▁" + w[:2], w[2:]]
    chars = sorted(set("".join(WORDS)) | set("abcdefghijklmnopqrstuvwxyz0123456789!?,.'<>_"))
    pieces += chars + ["▁" + c for c in chars] + ["▁"]
    pieces = [(p, float(-rng.uniform(1.0, 12.0))) for p in dict.fromkeys(pieces)]
    norm = normalizers.Sequence([normalizers.NFKC(), normalizers.Replace(Regex(" {2,}"), " ")])
    if layout == "pegasus":
        vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<mask_1>", 0.0), ("<mask_2>", 0.0)]
        vocab += [(f"<unk_{i}>", -100.0) for i in range(2, 103)] + [("<unk>", 0.0)] + pieces
        tok = Tokenizer(models.Unigram(vocab, unk_id=105, byte_fallback=False))
        tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                                     pre_tokenizers.Metaspace()])
        tok.post_processor = processors.TemplateProcessing(
            single=["$A", "</s>"], pair=["$A", "$B", "</s>"], special_tokens=[("</s>", 1)])
        cls = T.PegasusTokenizerFast
    else:
        from transformers.models.mbart.tokenization_mbart_fast import FAIRSEQ_LANGUAGE_CODES
        from transformers.models.mbart50.tokenization_mbart50_fast import (
            FAIRSEQ_LANGUAGE_CODES as FAIRSEQ_LANGUAGE_CODES_50,
        )

        codes = FAIRSEQ_LANGUAGE_CODES if layout == "mbart" else FAIRSEQ_LANGUAGE_CODES_50
        vocab = [("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)] + pieces
        vocab += [(c, 0.0) for c in codes] + [("<mask>", 0.0)]
        ids = {p: i for i, (p, _) in enumerate(vocab)}
        tok = Tokenizer(models.Unigram(vocab, unk_id=3, byte_fallback=False))
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        single = "$A </s> en_XX" if layout == "mbart" else "en_XX $A </s>"
        tok.post_processor = processors.TemplateProcessing(
            single=single, special_tokens=[("en_XX", ids["en_XX"]), ("</s>", 2)])
        cls = T.MBartTokenizerFast if layout == "mbart" else T.MBart50TokenizerFast
    tok.normalizer = norm
    fast = cls(tokenizer_object=tok, **{k: v for k, v in config.items() if k == "src_lang"})
    _save_with_config(fast, path, config)
    return len(fast)


def write_blenderbot_small_slow(path, seed=0, **config):
    """``vocab.json`` + ``merges.txt`` in the slow ``BlenderbotSmallTokenizer``'s
    layout (``facebook/blenderbot_small-90M``'s files): a BPE trained with the
    ``</w>`` end-of-word suffix on seeded strings split and lower-cased as
    its ``bpe`` splits them, each piece stored as it is read back (a final
    piece without ``</w>``, an inner one with ``@@``), ``__null__``,
    ``__start__``, ``__end__``, ``__unk__`` first; ``tokenizer_config.json``
    holds ``config`` alone.  Returns the vocabulary size."""
    import pathlib
    import re

    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    words = []
    for text in strings(seed, 400):
        for word in re.findall(r"\S+", text):
            word = re.sub("([.,!?()])", r" \1", word)
            words.append(re.sub("(')", r" \1 ", word).lower())
    tok = Tokenizer(models.BPE(end_of_word_suffix="</w>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.train_from_iterator(words, trainers.BpeTrainer(
        vocab_size=700, min_frequency=1, end_of_word_suffix="</w>", show_progress=False))
    model = json.loads(tok.to_str())["model"]
    vocab = {t: i for i, t in enumerate(["__null__", "__start__", "__end__", "__unk__"])}
    for piece, _ in sorted(model["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(piece[:-4] if piece.endswith("</w>") else piece + "@@", len(vocab))
    merges = [" ".join(m) if not isinstance(m, str) else m for m in model["merges"]]
    (path / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                     encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps(config), encoding="utf-8")
    return len(vocab)
