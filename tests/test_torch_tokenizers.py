"""The port's tokenizers (``svs_tpu_torch.embeddings``: ``tokenizer_json``,
``bpe``, ``unigram``, ``precompiled``, ``graphemes``, ``wordpiece``)
against ``transformers.AutoTokenizer`` and ``tokenizers`` on the CPU.

Token ids and attention masks equal ``AutoTokenizer``'s (what ``svs_tpu``'s
local provider calls, ``padding="max_length", truncation=True``) at
``max_length`` 16 and 512 on 200 seeded strings for: XLM-R's Unigram with
Metaspace (``Precompiled`` and NFKC normalizers), byte-level BPE from
``tokenizer.json`` and from ``vocab.json`` + ``merges.txt``, WordPiece
from ``tokenizer.json``, and the SentencePiece layouts of ALBERT (Unigram)
and BigBird (Unigram and SentencePiece-style BPE), and the SentencePiece-style
BPE with byte fallback of Llama-2 and Gemma read as ``LlamaTokenizerFast`` /
``GemmaTokenizerFast`` (left padding, their ``add_bos_token`` /
``add_eos_token`` post-processor), and the byte-level BPE of
``GPT2TokenizerFast`` / ``BloomTokenizerFast`` and XGLM's Unigram read as
``XGLMTokenizerFast`` (each class's specials and padding side), and the
encoder-decoders' classes: ``BartTokenizerFast`` and
``BlenderbotTokenizerFast`` (from ``tokenizer.json`` and from
``vocab.json`` + ``merges.txt``), ``MBartTokenizerFast`` and
``MBart50TokenizerFast`` (their language codes and the ``src_lang``
post-processor), ``PegasusTokenizerFast``, ``BlenderbotSmallTokenizerFast``
(with a pad token and without) and the slow ``BlenderbotSmallTokenizer``
that reads ``blenderbot_small-90M``'s ``vocab.json`` + ``merges.txt``.  Then each component against its ``tokenizers``
counterpart (the ``Precompiled`` normalizer on a charsmap that
:func:`torch_tokenizer_helpers.build_charsmap` writes, the pre-tokenizers
and normalizers, GPT-2's split, the grapheme clusters against ``regex``'s
``\\X``), and the refusals by name."""

import json
import shutil

import numpy as np
import pytest

pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from tokenizers import Regex
from tokenizers import normalizers as N
from tokenizers import pre_tokenizers as P

from svs_tpu_torch.embeddings import bpe, graphemes
from svs_tpu_torch.embeddings.precompiled import PrecompiledCharsMap
from svs_tpu_torch.embeddings.tokenizer_json import (
    JsonTokenizer,
    build_normalizer,
    build_pre_tokenizer,
    load_tokenizer,
)
from svs_tpu_torch.embeddings.unigram import UnigramModel
from svs_tpu_torch.embeddings.wordpiece import WordPieceTokenizer

from torch_tokenizer_helpers import (
    CHARSMAP,
    DECODER_SPECIALS,
    build_charsmap,
    decoder_tokenizer_spec,
    seeded_strings,
    strings,
    write_bpe_tokenizer,
    write_byte_level_tokenizer,
    write_decoder_tokenizer,
    write_sentencepiece_tokenizer,
    write_seq2seq_tokenizer,
    write_unigram_tokenizer,
    write_wordpiece_tokenizer,
    write_xglm_tokenizer,
)


def _auto(path):
    import transformers
    from transformers import AutoTokenizer

    transformers.logging.set_verbosity_error()
    return AutoTokenizer.from_pretrained(str(path))


def _same_as_auto(path, mine, seed):
    ref = _auto(path)
    texts = strings(seed)
    for max_length in (16, 512):
        want = ref(texts, padding="max_length", truncation=True, max_length=max_length,
                   return_tensors="np")
        ids, mask = mine.batch(texts, max_length)
        for i, text in enumerate(texts):
            assert list(ids[i]) == list(want["input_ids"][i]), (text, max_length)
            assert list(mask[i]) == list(want["attention_mask"][i]), (text, max_length)


@pytest.mark.parametrize("normalizer", ["precompiled", "nfkc"])
@pytest.mark.parametrize("scheme", ["always", "first"])
def test_unigram_metaspace_equals_auto_tokenizer(tmp_path, normalizer, scheme):
    write_unigram_tokenizer(tmp_path, seed=3, normalizer=normalizer, prepend_scheme=scheme)
    mine = load_tokenizer(tmp_path, "xlm-roberta")
    assert isinstance(mine, JsonTokenizer) and isinstance(mine.model, UnigramModel)
    assert mine.pad_id == 1 and mine.head == [0] and mine.tail == [2]
    _same_as_auto(tmp_path, mine, seed=21)


@pytest.mark.parametrize("layout,model", [("albert", "unigram"), ("big_bird", "unigram"),
                                          ("big_bird", "bpe")])
def test_sentencepiece_layouts_equal_auto_tokenizer(tmp_path, layout, model):
    """ALBERT's ``tokenizer.json`` (``AlbertConverter``: quote
    ``Replace``s, NFKD, StripAccents, Lowercase, ``Precompiled``) and
    BigBird's (``SpmConverter``: ``Precompiled``, a right ``Strip``,
    ``Replace(" {2,}", "▁")``), Metaspace and ``[CLS] $A [SEP]``, read
    through ``AlbertTokenizerFast`` / ``BigBirdTokenizerFast``'s special
    tokens."""
    write_sentencepiece_tokenizer(tmp_path, layout, model, seed=3)
    mine = load_tokenizer(tmp_path)
    assert mine.tokenizer_class == {"albert": "AlbertTokenizer", "big_bird": "BigBirdTokenizer"}[layout]
    _same_as_auto(tmp_path, mine, seed=14)


def test_byte_level_bpe_tokenizer_json_equals_auto_tokenizer(tmp_path):
    write_bpe_tokenizer(tmp_path, seed=4)
    mine = load_tokenizer(tmp_path, "roberta")
    assert isinstance(mine.model, bpe.BPEModel) and mine.pad_id == 1
    _same_as_auto(tmp_path, mine, seed=22)


def test_byte_level_bpe_vocab_and_merges_equal_auto_tokenizer(tmp_path):
    """Without ``tokenizer.json``: ``vocab.json`` + ``merges.txt`` read as
    ``RobertaTokenizer`` (``<s> ... </s>``, pad id 1)."""
    write_bpe_tokenizer(tmp_path, seed=5)
    (tmp_path / "tokenizer.json").unlink()
    mine = load_tokenizer(tmp_path, "roberta")
    assert isinstance(mine, JsonTokenizer) and mine.pad_id == 1
    assert (mine.head, mine.tail) == ([0], [2])
    _same_as_auto(tmp_path, mine, seed=23)


@pytest.mark.parametrize("cls_name", ["BertTokenizerFast", "DistilBertTokenizerFast",
                                      "ElectraTokenizerFast"])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "cased"])
def test_wordpiece_tokenizer_json_equals_auto_tokenizer(tmp_path, cls_name, lower):
    write_wordpiece_tokenizer(tmp_path, cls_name, lower)
    mine = load_tokenizer(tmp_path, "bert")
    assert isinstance(mine, JsonTokenizer)  # tokenizer.json first, as AutoTokenizer
    _same_as_auto(tmp_path, mine, seed=24)


@pytest.mark.parametrize("cls_name", ["DistilBertTokenizer", "ElectraTokenizer"])
def test_slow_wordpiece_classes_read_vocab_txt(tmp_path, cls_name):
    write_wordpiece_tokenizer(tmp_path, cls_name)
    mine = load_tokenizer(tmp_path, "distilbert")
    assert isinstance(mine, WordPieceTokenizer)
    _same_as_auto(tmp_path, mine, seed=25)


def test_tokenizer_config_options_written_over_the_file(tmp_path):
    """``BertTokenizerFast`` writes ``do_lower_case`` over the file's
    ``BertNormalizer``, ``RobertaTokenizerFast`` ``add_prefix_space`` over
    its ``ByteLevel``; left padding and truncation come from the config."""
    bert_dir, bpe_dir = tmp_path / "bert", tmp_path / "bpe"
    write_wordpiece_tokenizer(bert_dir, "BertTokenizerFast", lower=True)
    cfg = json.loads((bert_dir / "tokenizer_config.json").read_text())
    cfg.update(do_lower_case=False, padding_side="left", truncation_side="left")
    (bert_dir / "tokenizer_config.json").write_text(json.dumps(cfg))
    mine = load_tokenizer(bert_dir)
    assert mine.padding_side == "left" and mine.truncation_side == "left"
    _same_as_auto(bert_dir, mine, seed=26)
    write_bpe_tokenizer(bpe_dir, seed=6)
    cfg = json.loads((bpe_dir / "tokenizer_config.json").read_text())
    cfg["add_prefix_space"] = True
    (bpe_dir / "tokenizer_config.json").write_text(json.dumps(cfg))
    _same_as_auto(bpe_dir, load_tokenizer(bpe_dir), seed=27)


# -- the components -------------------------------------------------------------

_PRECOMPILED_POOL = list(CHARSMAP) + [
    "abc", "Hello", "é", "é́", "ｅ́", "\U0001F468‍\U0001F469‍\U0001F467",
    "\U0001F1EB\U0001F1F7", "한국어", "각", "각", "नमस्ते", "x‍", "́",
    "\U0001F600́", "ﬁ́", "中文", "<mask>", " x", "\r\n", " ", " ",
    "Å", "\U0001F44D\U0001F3FD", "\U000E0041", "͸", "\U0010FFFD", "�",
]


def test_precompiled_charsmap_equals_tokenizers():
    """Full-width forms, NBSP and other spaces, ligatures, combining marks
    (a cluster whose first character alone is a key), ZWJ emoji, flags,
    Hangul (syllables and jamo), ``<mask>`` inside text and unknown or
    unassigned characters."""
    blob = build_charsmap(CHARSMAP)
    ref = N.Precompiled(blob)
    mine = PrecompiledCharsMap(blob)
    assert mine.transform("ﬁ") == "fi" and mine.transform("q") is None
    texts = _PRECOMPILED_POOL + seeded_strings(31, 600, _PRECOMPILED_POOL)
    for text in texts:
        assert mine.normalize(text) == ref.normalize_str(text), text
    # the base64 form that tokenizer.json carries
    spec = json.loads(N.Sequence([N.Precompiled(blob)]).__getstate__())["normalizers"][0]
    fn = build_normalizer(spec)
    for text in texts[:200]:
        assert fn(text) == ref.normalize_str(text)


def test_grapheme_clusters_equal_regex_x():
    regex = pytest.importorskip("regex")
    pool = [chr(c) for c in list(range(0x20, 0x7F)) + list(range(0x300, 0x370))
            + list(range(0x900, 0x980)) + list(range(0x1100, 0x1200)) + list(range(0xAC00, 0xAC40))
            + list(range(0x1F1E6, 0x1F200)) + list(range(0x1F300, 0x1F320))
            + [0x200D, 0xFE0F, 0x1F3FB, 0x0D, 0x0A, 0x600, 0x0E33, 0x0E01, 0x0E31, 0x200C]]
    rng = np.random.default_rng(32)
    for _ in range(3000):
        text = "".join(rng.choice(pool, int(rng.integers(0, 12))))
        assert graphemes.clusters(text) == regex.findall(r"\X", text), [hex(ord(c)) for c in text]


_PRE_POOL = ["a", "b", "hello", " ", "  ", "▁", "▁▁", "\t", "\n", "!", "?", ",", "don't", "中",
             "é", "é", "x1", "12", "_", "-", "ﬁ", "İ", "ΟΔΟΣ", "ß", "　", "\xa0",
             "\x1c", "Ⓐ", "٣", "'s", "'ll", "\U0001F600"]
_PRE_TOKENIZERS = {
    "metaspace": P.Metaspace(), "metaspace_first": P.Metaspace(prepend_scheme="first"),
    "metaspace_never": P.Metaspace(prepend_scheme="never"),
    "metaspace_nosplit": P.Metaspace(split=False), "whitespace": P.Whitespace(),
    "whitespace_split": P.WhitespaceSplit(), "bert": P.BertPreTokenizer(),
    "byte_level": P.ByteLevel(add_prefix_space=True),
    "byte_level_noregex": P.ByteLevel(add_prefix_space=False, use_regex=False),
    "split_removed": P.Split(" ", "removed"), "split_isolated": P.Split(" ", "isolated"),
    "split_prev": P.Split(" ", "merged_with_previous"),
    "split_next": P.Split(" ", "merged_with_next"),
    "split_contiguous": P.Split(" ", "contiguous"),
    "split_regex": P.Split(Regex(r"\s+"), "removed"),
    "split_regex_invert": P.Split(Regex(r"\w+"), "isolated", invert=True),
    "split_letters": P.Split(Regex(r"[\p{L}]+"), "merged_with_next"),
    "sequence": P.Sequence([P.WhitespaceSplit(), P.Metaspace()]),
}


@pytest.mark.parametrize("name", sorted(_PRE_TOKENIZERS))
def test_pre_tokenizer_equals_tokenizers(name):
    ref = _PRE_TOKENIZERS[name]
    mine = build_pre_tokenizer(json.loads(ref.__getstate__()))
    for text in seeded_strings(33, 400, _PRE_POOL):
        want = [w for w, _ in ref.pre_tokenize_str(text)]
        assert [w for w, _ in mine([(text, True)])] == want, text


_NORMALIZERS = {
    "nfkc": N.NFKC(), "nfd": N.NFD(), "nfc": N.NFC(), "nfkd": N.NFKD(),
    "lowercase": N.Lowercase(), "strip": N.Strip(), "strip_left": N.Strip(right=False),
    "strip_accents": N.StripAccents(), "nfd_strip": N.Sequence([N.NFD(), N.StripAccents()]),
    "replace": N.Replace(" ", "▁"), "replace_regex": N.Replace(Regex(r"\s+"), " "),
    "prepend": N.Prepend("▁"), "bert": N.BertNormalizer(),
    "bert_cased_strip": N.BertNormalizer(lowercase=False, strip_accents=True),
    "bert_raw": N.BertNormalizer(clean_text=False, handle_chinese_chars=False),
}


@pytest.mark.parametrize("name", sorted(_NORMALIZERS))
def test_normalizer_equals_tokenizers(name):
    ref = _NORMALIZERS[name]
    mine = build_normalizer(json.loads(ref.__getstate__()))
    for text in seeded_strings(34, 400, _PRE_POOL + ["\x00", "�", " ", "Ǆ"]):
        assert mine(text) == ref.normalize_str(text), text


def test_gpt2_split_equals_byte_level_pre_tokenizer():
    ref = P.ByteLevel(add_prefix_space=False)
    for text in seeded_strings(35, 1000, _PRE_POOL + ["'S", "'''", "3.14", "  x"]):
        want = [w for w, _ in ref.pre_tokenize_str(text)]
        assert [bpe.byte_level(w) for w in bpe.gpt2_split(text)] == want, text


def test_unigram_viterbi_and_fused_unknowns_equal_tokenizers():
    """Ties, unknown runs fused into one ``<unk>``, a piece that is the
    unknown piece itself."""
    from tokenizers import Tokenizer, models

    vocab = [("<unk>", 0.0), ("a", -1.0), ("b", -1.0), ("ab", -2.0), ("abc", -3.0), ("c", -1.5),
             ("bc", -2.5), ("▁", -1.0), ("▁a", -1.2), ("ca", -2.0), ("aa", -2.0)]
    ref = Tokenizer(models.Unigram(vocab, unk_id=0, byte_fallback=False))
    mine = UnigramModel(vocab, 0)
    for text in seeded_strings(36, 500, ["a", "b", "c", "x", "yz", "abc", "▁", "<unk>", "é"]):
        text = text.replace(" ", "").replace("\t", "").replace("\n", "")
        if text:
            assert list(mine.tokenize(text)) == ref.encode(text).ids, text


# -- refusals -------------------------------------------------------------------


def _spec(tmp_path, **parts):
    write_unigram_tokenizer(tmp_path, seed=1)
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec.update(parts)
    return spec


@pytest.mark.parametrize("part,value,name", [
    ("normalizer", {"type": "NmtNormalizer"}, "NmtNormalizer"),
    ("pre_tokenizer", {"type": "Digits", "individual_digits": True}, "Digits"),
    ("post_processor", {"type": "SomethingNew"}, "SomethingNew"),
    ("model", {"type": "WordLevel", "vocab": {}, "unk_token": "x"}, "WordLevel"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\p{Han}+"}, "behavior": "Isolated",
                       "invert": False}, "Han"),
])
def test_unported_component_raises_naming_it(tmp_path, part, value, name):
    spec = _spec(tmp_path, **{part: value})
    with pytest.raises(NotImplementedError, match=name):
        JsonTokenizer(spec, model_type="xlm-roberta")


def test_unigram_byte_fallback_raises(tmp_path):
    spec = _spec(tmp_path)
    spec["model"]["byte_fallback"] = True
    with pytest.raises(NotImplementedError, match="byte_fallback"):
        JsonTokenizer(spec, model_type="xlm-roberta")


def test_sentencepiece_model_alone_raises_naming_the_file(tmp_path):
    (tmp_path / "sentencepiece.bpe.model").write_bytes(b"\x00")
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "XLMRobertaTokenizer"}))
    with pytest.raises(NotImplementedError, match="sentencepiece.bpe.model"):
        load_tokenizer(tmp_path, "xlm-roberta")
    shutil.rmtree(tmp_path)
    tmp_path.mkdir()
    with pytest.raises(FileNotFoundError, match="no tokenizer"):
        load_tokenizer(tmp_path)


def test_added_token_flags_equal_tokenizers():
    """``single_word``, ``lstrip``, ``rstrip`` and ``normalized`` added
    tokens (a special and a plain one of each) split out as ``tokenizers``
    splits them."""
    from tokenizers import AddedToken, Tokenizer, models

    vocab = {"[UNK]": 0, "[PAD]": 1}
    for w in ["a", "b", "ab", "hello", "world", "é", "x", "_", "1"]:
        vocab[w] = len(vocab)
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = P.WhitespaceSplit()
    tok.normalizer = N.Lowercase()
    tok.add_special_tokens([AddedToken("<sw>", single_word=True), AddedToken("<l>", lstrip=True),
                            AddedToken("<r>", rstrip=True),
                            AddedToken("<lr>", lstrip=True, rstrip=True)])
    tok.add_tokens([AddedToken("HeLLo", normalized=True),
                    AddedToken("wor", single_word=True, normalized=False)])
    mine = JsonTokenizer(json.loads(tok.to_str()), {"pad_token": "[PAD]"})
    pool = ["<sw>", "<l>", "<r>", "<lr>", "HeLLo", "hello", "wor", "world", "a", "ab", "x<sw>",
            "<sw>x", "_<sw>", "é<sw>", " ", "  ", "\t", "é", "\xa0", "1<sw>"]
    for text in seeded_strings(37, 1000, pool):
        assert mine.token_ids(text) == tok.encode(text, add_special_tokens=False).ids, text


@pytest.mark.parametrize("layout,config", [
    ("llama", {"pad_token": "</s>"}),
    ("llama", {"pad_token": "<unk>", "add_eos_token": True}),
    ("llama", {"pad_token": "</s>", "add_bos_token": False, "padding_side": "right",
               "truncation_side": "left"}),
    ("gemma", {}),
    ("gemma", {"add_eos_token": True}),
], ids=["llama", "llama-eos", "llama-no-bos-right", "gemma", "gemma-eos"])
def test_llama_and_gemma_layouts_equal_auto_tokenizer(tmp_path, layout, config):
    """Llama-2's ``tokenizer.json`` (``Prepend("▁")`` + ``Replace``, no
    pre-tokenizer: the whole text is one BPE word) and Gemma's
    (``Replace``, ``Split(" ")``), a BPE with ``byte_fallback`` and
    ``fuse_unk`` whose alphabet is ASCII, so every other character of the
    seeded strings becomes ``<0xNN>`` pieces; ``LlamaTokenizerFast`` /
    ``GemmaTokenizerFast`` pad on the left and rebuild the post-processor
    from ``add_bos_token`` / ``add_eos_token`` over the file's ``bos $A``."""
    write_decoder_tokenizer(tmp_path, layout, seed=6, **config)
    mine = load_tokenizer(tmp_path)
    assert mine.tokenizer_class == {"llama": "LlamaTokenizer", "gemma": "GemmaTokenizer"}[layout]
    assert mine.padding_side == config.get("padding_side", "left")
    bos, eos = (1, 2) if layout == "llama" else (2, 1)
    assert mine.head == ([] if config.get("add_bos_token") is False else [bos])
    assert mine.tail == ([eos] if config.get("add_eos_token") else [])
    first_byte = len(DECODER_SPECIALS[layout])
    ids, _ = mine.batch(strings(25), 64)
    assert ((ids >= first_byte) & (ids < first_byte + 256)).any()  # the byte fallback ran
    _same_as_auto(tmp_path, mine, seed=25)


def test_mistral_model_type_reads_as_llama_tokenizer(tmp_path):
    """With no ``tokenizer_class``, ``AutoTokenizer`` picks
    ``LlamaTokenizerFast`` for ``model_type`` ``mistral`` (left padding,
    ``<s> $A``), and so does the port."""
    write_decoder_tokenizer(tmp_path, "llama", seed=7, pad_token="</s>")
    cfg = json.loads((tmp_path / "tokenizer_config.json").read_text())
    del cfg["tokenizer_class"]
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "mistral"}))
    mine = load_tokenizer(tmp_path, "mistral")
    assert mine.tokenizer_class == "LlamaTokenizer" and mine.padding_side == "left"
    _same_as_auto(tmp_path, mine, seed=26)


def test_llama_tokenizer_refusals(tmp_path):
    """No pad token: ``padding="max_length"`` fails in ``transformers``
    and the port refuses; ``add_prefix_space`` makes ``transformers``
    rebuild from the SentencePiece model, which the port does not read."""
    write_decoder_tokenizer(tmp_path, "llama", seed=8)
    with pytest.raises(ValueError):
        _auto(tmp_path)(["a b"], padding="max_length", max_length=8)
    with pytest.raises(ValueError, match="no pad token"):
        load_tokenizer(tmp_path)
    write_decoder_tokenizer(tmp_path, "llama", seed=8, pad_token="</s>", add_prefix_space=True)
    with pytest.raises(NotImplementedError, match="add_prefix_space"):
        load_tokenizer(tmp_path)


def test_bpe_cut_before_word_marks_is_exact():
    """``BPEModel.tokenize`` cuts a long piece before each ``▁`` that no
    piece joins to the character on its left and tokenizes the parts
    (cached); on a vocabulary trained with merges across ``▁`` (no
    pre-tokenizer) the ids equal the whole piece's merge, and equal
    ``tokenizers``' on the same model."""
    from tokenizers import Tokenizer

    spec = decoder_tokenizer_spec("llama", seed=9, vocab_size=600)
    model = bpe.BPEModel(spec["model"]["vocab"], bpe.parse_merges(spec["model"]["merges"]),
                         unk_token="<unk>", fuse_unk=True, byte_fallback=True)
    assert model._joins_mark, "the vocabulary has no piece with a ▁ inside"
    ref = Tokenizer.from_str(json.dumps({**spec, "normalizer": None, "post_processor": None,
                                         "added_tokens": []}))
    cut = 0
    for text in strings(27, 300):
        word = "▁" + text.replace(" ", "▁")
        whole = tuple(model._merge(model._symbols(word)))
        assert model.tokenize(word) == whole, word
        assert list(whole) == ref.encode(word, add_special_tokens=False).ids, word
        cut += len(model._parts(word)) > 1
    assert cut > 100


@pytest.mark.parametrize("layout,config", [
    ("gpt2", {"pad_token": "<|endoftext|>"}),
    ("gpt2", {"pad_token": "<|endoftext|>", "padding_side": "left", "add_prefix_space": True}),
    ("bloom", {}),
    ("bloom", {"padding_side": "left", "truncation_side": "left"}),
    ("xglm", {}),
    ("xglm", {"additional_special_tokens": ["<madeupword2>"]}),
], ids=["gpt2", "gpt2-left-prefix", "bloom", "bloom-left", "xglm", "xglm-class-madeupwords"])
def test_gpt2_bloom_xglm_classes_equal_auto_tokenizer(tmp_path, layout, config):
    """``GPT2TokenizerFast`` (GPT-2, GPT-Neo, GPT-J: ``<|endoftext|>`` for
    bos / eos / unk, a pad token only if the config names one, the config's
    ``add_prefix_space`` written over the file's ``ByteLevel``),
    ``BloomTokenizerFast`` (``<unk>``, ``<s>``, ``</s>``, ``<pad>``) and
    ``XGLMTokenizerFast`` (``</s> $A``, its seven ``<madeupwordN>`` special
    tokens appended to the config's): ids and masks as ``AutoTokenizer``'s,
    with each class's padding side (right) unless the config says."""
    if layout == "xglm":
        write_xglm_tokenizer(tmp_path, seed=8, **config)
    else:
        write_byte_level_tokenizer(tmp_path, layout, seed=8, **config)
    model_type = {"gpt2": "gptj", "bloom": "bloom", "xglm": "xglm"}[layout]
    mine = load_tokenizer(tmp_path, model_type)
    assert mine.tokenizer_class == {"gpt2": "GPT2Tokenizer", "bloom": "BloomTokenizer",
                                    "xglm": "XGLMTokenizer"}[layout]
    assert mine.padding_side == config.get("padding_side", "right")
    ref = _auto(tmp_path)
    assert mine.pad_id == ref.pad_token_id
    odd = ["a <madeupword3> b<madeupword2>", "<|endoftext|>x", " <pad> </s>"]
    want = ref(odd, padding="max_length", truncation=True, max_length=24, return_tensors="np")
    ids, mask = mine.batch(odd, 24)
    assert ids.tolist() == want["input_ids"].tolist() and mask.tolist() == want["attention_mask"].tolist()
    _same_as_auto(tmp_path, mine, seed=28)


def test_tokenizer_json_padding_direction_is_the_default_side(tmp_path):
    """A ``tokenizer.json`` whose ``padding`` pads on the left and a config
    that names no side: ``PreTrainedTokenizerFast`` takes the file's
    direction, and so does the port; the config's side still wins."""
    write_byte_level_tokenizer(tmp_path, "bloom", seed=9)
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec["padding"] = {"strategy": "BatchLongest", "direction": "Left", "pad_to_multiple_of": None,
                       "pad_id": 3, "pad_type_id": 0, "pad_token": "<pad>"}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    mine = load_tokenizer(tmp_path, "bloom")
    assert mine.padding_side == "left" == _auto(tmp_path).padding_side
    _same_as_auto(tmp_path, mine, seed=29)
    cfg = json.loads((tmp_path / "tokenizer_config.json").read_text())
    cfg["padding_side"] = "right"
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    assert load_tokenizer(tmp_path, "bloom").padding_side == "right" == _auto(tmp_path).padding_side


def test_gpt2_tokenizer_without_pad_token_is_refused(tmp_path):
    """``GPT2TokenizerFast`` names no pad token: ``padding="max_length"``
    fails in ``transformers``, and the port refuses the directory."""
    write_byte_level_tokenizer(tmp_path, "gpt2", seed=10)
    with pytest.raises(ValueError):
        _auto(tmp_path)(["a b"], padding="max_length", max_length=8)
    with pytest.raises(ValueError, match="no pad token"):
        load_tokenizer(tmp_path, "gpt2")


_SEQ2SEQ_CASES = {
    "bart": ("bart", "json", {}),
    "bart-prefix": ("bart", "json", {"add_prefix_space": True}),
    "bart-vocab": ("bart", "vocab", {}),
    "blenderbot": ("blenderbot", "json", {}),
    "blenderbot-vocab-prefix": ("blenderbot", "vocab", {"add_prefix_space": True}),
    "blenderbot-small-pad": ("blenderbot-small", "json", {"pad_token": "__null__"}),
    "mbart": ("mbart", "json", {}),
    "mbart-ro": ("mbart", "json", {"src_lang": "ro_RO"}),
    "mbart50": ("mbart50", "json", {}),
    "mbart50-ro": ("mbart50", "json", {"src_lang": "ro_RO"}),
    "pegasus": ("pegasus", "json", {}),
}
_SEQ2SEQ_CLASS = {"bart": "BartTokenizer", "blenderbot": "BlenderbotTokenizer",
                  "blenderbot-small": "BlenderbotSmallTokenizer", "mbart": "MBartTokenizer",
                  "mbart50": "MBart50Tokenizer", "pegasus": "PegasusTokenizer"}
_SEQ2SEQ_ODD = ["a <mask> b", "x<mask>y", "en_XX hi ro_RO", "<mask_1> x <unk_7> <mask_2>",
                " <pad> </s> __null__", ""]


def _same_ids(ref, mine, texts, max_length):
    want = ref(texts, padding="max_length", truncation=True, max_length=max_length,
               return_tensors="np")
    ids, mask = mine.batch(texts, max_length)
    assert ids.tolist() == want["input_ids"].tolist() and mask.tolist() == want["attention_mask"].tolist()


@pytest.mark.parametrize("case", sorted(_SEQ2SEQ_CASES))
def test_seq2seq_classes_equal_auto_tokenizer(tmp_path, case):
    """The encoder-decoders' tokenizers as their fast classes save them:
    BART's byte-level BPE with ``RobertaProcessing`` and Blenderbot's with
    ``$A </s>`` (also built from ``vocab.json`` + ``merges.txt`` as their
    converters build them, the config's ``add_prefix_space`` written into
    the ``ByteLevel`` pre-tokenizer), Blenderbot-small's (a pad token set),
    mBART's and mBART-50's Unigram with their language codes
    (``$A </s> src_lang``, ``src_lang $A </s>``) and Pegasus's
    (``<mask_1>``, ``<mask_2>``, ``<unk_2>`` .. ``<unk_102>``): ids and masks
    as ``AutoTokenizer``'s."""
    layout, files, config = _SEQ2SEQ_CASES[case]
    write_seq2seq_tokenizer(tmp_path, layout, seed=31, files=files, **config)
    model_type = "mbart" if layout == "mbart50" else layout
    mine = load_tokenizer(tmp_path, model_type)
    assert mine.tokenizer_class == _SEQ2SEQ_CLASS[layout]
    if files == "vocab":
        assert not (tmp_path / "tokenizer.json").exists()
    ref = _auto(tmp_path)
    assert mine.pad_id == ref.pad_token_id
    _same_ids(ref, mine, _SEQ2SEQ_ODD, 24)
    _same_as_auto(tmp_path, mine, seed=32)


@pytest.mark.parametrize("layout,config", [
    ("bart", {}), ("blenderbot", {}), ("mbart", {"src_lang": "ro_RO"}),
    ("mbart50", {"src_lang": "de_DE"}), ("pegasus", {}),
])
def test_seq2seq_class_rules_apply_over_a_bare_file(tmp_path, layout, config):
    """A ``tokenizer.json`` with only the first four special tokens and a
    bare ``$A`` post-processor, and a config naming only the class (and
    ``src_lang``): what each class's ``__init__`` adds comes from the class
    (BART's normalized ``<mask>`` stripping to its left, mBART's 25 and
    mBART-50's 52 language codes as special tokens and the post-processor
    rebuilt around ``src_lang``, Pegasus's ``<mask_1>`` and ``<unk_N>``),
    as ``AutoTokenizer`` adds it."""
    write_seq2seq_tokenizer(tmp_path, layout, seed=33, **config)
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec["added_tokens"] = [t for t in spec["added_tokens"]
                            if t["content"] in ("<s>", "</s>", "<pad>", "<unk>")]
    spec["post_processor"] = {
        "type": "TemplateProcessing", "single": [{"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [{"Sequence": {"id": "A", "type_id": 0}}], "special_tokens": {}}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    cfg = json.loads((tmp_path / "tokenizer_config.json").read_text())
    cfg = {k: v for k, v in cfg.items() if k in ("tokenizer_class", "src_lang")}
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    (tmp_path / "special_tokens_map.json").unlink()
    mine = load_tokenizer(tmp_path, "mbart" if layout == "mbart50" else layout)
    ref = _auto(tmp_path)
    if layout.startswith("mbart"):
        code = ref.convert_tokens_to_ids(config["src_lang"])
        assert (mine.head, mine.tail) == (([], [2, code]) if layout == "mbart" else ([code], [2]))
    _same_ids(ref, mine, _SEQ2SEQ_ODD, 24)
    _same_as_auto(tmp_path, mine, seed=34)


def test_blenderbot_small_without_pad_token_is_refused(tmp_path):
    """``BlenderbotSmallTokenizerFast`` names no pad token:
    ``padding="max_length"`` fails in ``transformers`` and the port
    refuses."""
    write_seq2seq_tokenizer(tmp_path, "blenderbot-small", seed=35)
    with pytest.raises(ValueError):
        _auto(tmp_path)(["a b"], padding="max_length", max_length=8)
    with pytest.raises(ValueError, match="no pad token"):
        load_tokenizer(tmp_path, "blenderbot-small")


@pytest.mark.parametrize("config", [{}, {"truncation_side": "left", "padding_side": "left"},
                                    {"pad_token": "__end__", "added_tokens_decoder": {
                                        "3": {"content": "__unk__", "lstrip": True,
                                              "rstrip": True, "single_word": False,
                                              "normalized": False, "special": True}}}],
                         ids=["defaults", "left", "flags"])
def test_blenderbot_small_slow_files_equal_auto_tokenizer(tmp_path, config):
    """``facebook/blenderbot_small-90M``'s layout: ``vocab.json`` +
    ``merges.txt`` of ``@@`` pieces and no class named, which
    ``AutoTokenizer`` reads with the slow ``BlenderbotSmallTokenizer``
    (white-space words, punctuation split off, lower-cased, ``@@`` BPE; the
    added tokens split out first with their flags; no special tokens
    around the ids): the port's :mod:`blenderbot_small_bpe` gives its ids
    and masks, on either side."""
    from svs_tpu_torch.embeddings.blenderbot_small_bpe import BlenderbotSmallTokenizer

    write_seq2seq_tokenizer(tmp_path, "blenderbot-small", seed=37, files="slow", **config)
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "blenderbot-small"}))
    ref = _auto(tmp_path)
    assert type(ref).__name__ == "BlenderbotSmallTokenizer"
    mine = load_tokenizer(tmp_path, "blenderbot-small")
    assert isinstance(mine, BlenderbotSmallTokenizer) and mine.pad_id == ref.pad_token_id
    odd = ["Hello, World! it's (me)", "line\nbreak  __start__x", "a __unk__ b", "CAT Dog's", ""]
    _same_ids(ref, mine, odd, 24)
    _same_as_auto(tmp_path, mine, seed=38)


def test_blenderbot_small_files_with_the_class_named_are_refused(tmp_path):
    """The same files with ``tokenizer_class`` named: ``AutoTokenizer``
    builds the fast class, which cannot read them, and fails; the port
    refuses, naming the class."""
    write_seq2seq_tokenizer(tmp_path, "blenderbot-small", seed=37, files="slow",
                            tokenizer_class="BlenderbotSmallTokenizer")
    with pytest.raises(Exception):
        _auto(tmp_path)
    with pytest.raises(NotImplementedError, match="BlenderbotSmallTokenizer"):
        load_tokenizer(tmp_path, "blenderbot-small")


def test_pegasus_specials_that_rebuild_the_vocabulary_are_refused(tmp_path):
    """``PegasusTokenizerFast`` rebuilds its vocabulary from the
    SentencePiece model when the pad, eos or unk token is not its default;
    with no model beside the ``tokenizer.json`` ``transformers`` fails, and
    the port refuses by name."""
    write_seq2seq_tokenizer(tmp_path, "pegasus", seed=36)
    cfg = json.loads((tmp_path / "tokenizer_config.json").read_text())
    cfg["pad_token"] = "<unk_5>"
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    with pytest.raises(Exception):
        _auto(tmp_path)
    with pytest.raises(NotImplementedError, match="pad_token"):
        load_tokenizer(tmp_path, "pegasus")


def test_mbart50_src_lang_outside_its_codes_is_refused(tmp_path):
    """``MBart50TokenizerFast`` looks ``src_lang`` up among its 52 codes and
    fails on another; the port refuses it by name."""
    write_seq2seq_tokenizer(tmp_path, "mbart50", seed=39)
    cfg = json.loads((tmp_path / "tokenizer_config.json").read_text())
    cfg["src_lang"] = "xx_XX"
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    with pytest.raises(Exception):
        _auto(tmp_path)
    with pytest.raises(ValueError, match="xx_XX"):
        load_tokenizer(tmp_path, "mbart")
