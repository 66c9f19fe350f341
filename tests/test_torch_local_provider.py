"""The port's local embedding provider (``svs_tpu_torch.embeddings.local``:
its own WordPiece tokenizer, MessagePack checkpoint reader and BERT
encoder) against ``svs_tpu``'s (``transformers`` + Flax) on the CPU.

The reference's tiny Flax BERT fixture (``tests/test_local_provider.py``)
is written once and read from the same directory by both packages: f32
embeddings agree within 1e-5 (mean and CLS pooling, normalised or not),
bf16 within ``BF16_ATOL``; token ids equal ``transformers.BertTokenizer``'s
on seeded strings; a store written by ``svs_tpu.KB`` with the provider
reopens in the port with no function and returns the same ids.  Then the
reference's provider cases (hub gate, validation, param tag, buckets, the
LRU on the encoder), resolution through a fake Hugging Face cache, a
model type that is not ported, and the MessagePack reader and writer
against Flax's."""

import asyncio
import gc
import json
import shutil
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

import svs_tpu
from svs_tpu.embeddings import make_local_embeddings_func as ref_local
from svs_tpu_torch import KB, make_embeddings_func
from svs_tpu_torch.embeddings import checkpoint
from svs_tpu_torch.embeddings.local import _buckets, _LocalEncoder, make_local_embeddings_func
from svs_tpu_torch.embeddings.wordpiece import WordPieceTokenizer

from torch_provider_helpers import TINY_VOCAB, write_tiny_bert

torch.set_num_threads(2)

#: f32 on both sides: the same arithmetic in another order (XLA vs torch
#: CPU kernels) — a few ulps of a unit vector, far inside this.
F32_ATOL = 1e-5
#: bf16 on both sides: each rounds its matmul inputs to 8 mantissa bits at
#: its own places (Flax keeps the softmax in bf16, torch's autocast runs it
#: in f32), a few 2^-8 steps of a unit vector's entries; unnormalised
#: vectors scale it by their norm (~5 at these widths).
BF16_ATOL = {True: 1e-2, False: 5e-2}

TEXTS = ["the cat sat on the mat", "a dog ran fast", "Red, BLUE! big-small",
         "", "unknownword cat", "the " * 40]


@pytest.fixture(scope="session")
def tiny_checkpoint(tmp_path_factory) -> Path:
    """The reference's fixture: a 2-layer 32-wide BERT written by
    ``transformers``' Flax model and tokenizer."""
    from transformers import BertConfig, BertTokenizer, FlaxBertModel

    path = tmp_path_factory.mktemp("tiny_bert")
    (path / "vocab.txt").write_text("\n".join(TINY_VOCAB) + "\n")
    BertTokenizer(str(path / "vocab.txt"), do_lower_case=True).save_pretrained(str(path))
    config = BertConfig(
        vocab_size=len(TINY_VOCAB), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
    )
    FlaxBertModel(config, seed=7).save_pretrained(str(path))
    return path


def _embed(factory, path, texts, **kw):
    return np.asarray(asyncio.run(factory(str(path), max_length=16, **kw)(list(texts))), np.float32)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_f32_embeddings_match_svs_tpu(tiny_checkpoint, pooling, normalize):
    kw = dict(pooling=pooling, normalize=normalize, compute_dtype="float32")
    want = _embed(ref_local, tiny_checkpoint, TEXTS, **kw)
    got = _embed(make_local_embeddings_func, tiny_checkpoint, TEXTS, device="cpu", **kw)
    assert got.shape == want.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
def test_bf16_embeddings_match_svs_tpu(tiny_checkpoint, normalize):
    want = _embed(ref_local, tiny_checkpoint, TEXTS, normalize=normalize)
    got = _embed(make_local_embeddings_func, tiny_checkpoint, TEXTS, device="cpu",
                 normalize=normalize)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL[normalize], rtol=0)


# -- the tokenizer ------------------------------------------------------------

_WORDS = ["the", "cat", "run", "##ning", "##s", "un", "##aff", "##able", "hello",
          "world", "cafe", "café", "naive", "über", "a", "b", "c", "x", "##x",
          "##e", "##é", "中", "国", "人", "日", "本", "Hello", "World", "ÉCOLE",
          "ecole", "##cole", "é", "e", "co", "##ol", "σ", "ς", "οδος", "##ς", "ο", "##δ",
          "##ο", "##σ"]
_PUNCT = list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~") + ["¿", "—", "。", "、"]


def _vocab_file(tmp_path):
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + _WORDS + _PUNCT
    tokens += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(dict.fromkeys(tokens)) + "\n", encoding="utf-8")
    return path


def _strings(seed):
    rng = np.random.default_rng(seed)
    pool = _WORDS + _PUNCT + ["Café", "NAÏVE", "ÜBER", "running", "unaffable",
                              "中国人", "日本語", "x" * 101, "y" * 100, "a\tb\nc\rd",
                              "\x00ctl\x07", "zero​width", "ﬁ", "é",
                              "[CLS]", "[sep]", "[MASK]x", "ΟΔΟΣ", "  ", " nbsp",
                              "hello,world", "don't", "U.S.A.", "😀", "�"]
    out = ["", " ", "[CLS] [SEP]", "Hello World", "x" * 101 + " cat"]
    for _ in range(60):
        k = int(rng.integers(1, 40))
        sep = [" ", "", "  ", "\t"]
        out.append("".join(str(rng.choice(pool)) + str(rng.choice(sep)) for _ in range(k)))
    return out


@pytest.mark.parametrize("strip_accents", [None, True, False], ids=["acc_default", "acc_strip", "acc_keep"])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "cased"])
def test_token_ids_equal_bert_tokenizer(tmp_path, lower, strip_accents):
    from transformers import BertTokenizer

    vocab = _vocab_file(tmp_path)
    ref = BertTokenizer(str(vocab), do_lower_case=lower, strip_accents=strip_accents)
    ref.save_pretrained(str(tmp_path))
    got = WordPieceTokenizer.from_dir(tmp_path)
    assert (got.do_lower_case, got.strip_accents) == (lower, strip_accents)
    for max_length in (8, 16, 128):
        for text in _strings(7):
            want = ref(text, truncation=True, max_length=max_length)["input_ids"]
            assert got.encode(text, max_length) == want, (text, max_length)
    texts = _strings(8)[:9]
    want = ref(texts, padding="max_length", truncation=True, max_length=12, return_tensors="np")
    ids, mask = got.batch(texts, 12)
    np.testing.assert_array_equal(ids, want["input_ids"])
    np.testing.assert_array_equal(mask, want["attention_mask"])


def test_tokenizer_reads_the_reference_fixture(tiny_checkpoint):
    from transformers import AutoTokenizer

    ref = AutoTokenizer.from_pretrained(str(tiny_checkpoint))  # what svs_tpu uses
    got = WordPieceTokenizer.from_dir(tiny_checkpoint)
    for text in TEXTS + ["RED cat, Dog."]:
        assert got.encode(text, 16) == ref(text, truncation=True, max_length=16)["input_ids"]


# -- stores -------------------------------------------------------------------


def test_svs_tpu_local_store_reopens_in_the_port(tiny_checkpoint, tmp_path):
    """A store written by ``svs_tpu.KB`` with the local provider (f32)
    opens in the port with NO function (rebuilt from the stored params, on
    the KB's device) and returns the reference's ids and scores."""
    db = tmp_path / "local.sqlite"
    f = ref_local(str(tiny_checkpoint), max_length=16, compute_dtype="float32")
    kb = svs_tpu.KB(db, f)
    docs = ["the cat sat on the mat", "a dog ran fast", "the dog barks",
            "a happy cat meows", "red and blue", "big small dog", "sad cat sleeps"]
    with kb.bulk_add_docs() as add:
        for d in docs:
            add(d)
    queries = ["cat sleeps", "blue dog", "happy"]
    want = kb.retrieve_batch(queries, 4)
    kb.close()
    port = KB(db, device="cpu")
    try:
        params = port.embedding_func.__embedding_func_params__
        assert params["provider"] == "local" and params["compute_dtype"] == "float32"
        assert port.embedding_func.encoder.device == torch.device("cpu")
        got = port.retrieve_batch(queries, 4)
    finally:
        port.close()
    assert [[h["doc"]["id"] for h in r] for r in got] == [[h["doc"]["id"] for h in r] for r in want]
    np.testing.assert_allclose([[h["score"] for h in r] for r in got],
                               [[h["score"] for h in r] for r in want], atol=F32_ATOL)


def test_kb_end_to_end_with_local_provider(tiny_checkpoint, tmp_path):
    """The reference's end-to-end case through the port: write, retrieve,
    close, reopen with no function, the same results."""
    db = tmp_path / "local_kb.sqlite"
    f = make_local_embeddings_func(str(tiny_checkpoint), max_length=16,
                                   compute_dtype="float32", device="cpu")
    kb = KB(db, f, device="cpu")
    with kb.bulk_add_docs() as add:
        for d in ["the cat sat on the mat", "a dog ran fast", "the dog barks",
                  "a happy cat meows", "red and blue"]:
            add(d)
    first = kb.retrieve("cat sleeps", n=3)
    kb.close()
    kb2 = KB(db, device="cpu")
    second = kb2.retrieve("cat sleeps", n=3)
    kb2.close()
    assert [r["doc"]["text"] for r in second] == [r["doc"]["text"] for r in first]
    np.testing.assert_allclose([r["score"] for r in second], [r["score"] for r in first], atol=1e-6)


# -- the reference's provider cases ------------------------------------------


def test_bucket_ladder():
    assert _buckets(1) == [1]
    assert _buckets(8) == [1, 2, 4, 8]
    assert _buckets(6) == [1, 2, 4, 6]
    assert _buckets(50_000)[-1] == 50_000


def test_untrusted_db_params_refuse_hub_models(monkeypatch):
    hub = {"provider": "local", "model": "someone/huge-model"}
    monkeypatch.delenv("SVS_TPU_ALLOW_HUB_MODELS", raising=False)
    with pytest.raises(RuntimeError, match="SVS_TPU_ALLOW_HUB_MODELS"):
        make_embeddings_func(dict(hub), trusted=False)
    monkeypatch.setenv("SVS_TPU_ALLOW_HUB_MODELS", "1")
    f = make_embeddings_func(dict(hub), trusted=False)
    assert f.__embedding_func_params__["model"] == "someone/huge-model"
    monkeypatch.delenv("SVS_TPU_ALLOW_HUB_MODELS")
    g = make_embeddings_func(dict(hub))
    assert g.__embedding_func_params__["provider"] == "local"


def test_result_cache_lives_on_the_encoder(tiny_checkpoint):
    f = make_local_embeddings_func(str(tiny_checkpoint), max_length=16,
                                   compute_dtype="float32", device="cpu")
    asyncio.run(f(["the cat"]))  # load the weights and fill the LRU
    enc = f.__closure__
    refs = [weakref.ref(c.cell_contents) for c in (enc or [])
            if isinstance(c.cell_contents, _LocalEncoder)]
    assert len(refs) == 1
    del f, enc
    gc.collect()
    assert refs[0]() is None


def test_factory_validation(tiny_checkpoint):
    with pytest.raises(ValueError, match="pooling"):
        make_local_embeddings_func(str(tiny_checkpoint), pooling="max")
    with pytest.raises(ValueError, match="compute_dtype"):
        make_local_embeddings_func(str(tiny_checkpoint), compute_dtype="float16")
    with pytest.raises(ValueError, match="max_length"):
        make_local_embeddings_func(str(tiny_checkpoint), max_length=0)
    with pytest.raises(ValueError, match="batch_size"):
        make_local_embeddings_func(str(tiny_checkpoint), batch_size=0)


def test_param_tag_and_factory_roundtrip(tiny_checkpoint):
    f = make_local_embeddings_func(str(tiny_checkpoint), pooling="cls", max_length=16,
                                   compute_dtype="float32", device="cpu")
    params = f.__embedding_func_params__
    assert params == {  # device is not persisted
        "provider": "local", "model": str(tiny_checkpoint), "pooling": "cls",
        "max_length": 16, "compute_dtype": "float32", "normalize": True,
    }
    assert params == ref_local(str(tiny_checkpoint), pooling="cls", max_length=16,
                               compute_dtype="float32").__embedding_func_params__
    g = make_embeddings_func(dict(params), device="cpu")
    assert g.__embedding_func_params__ == params
    assert g.encoder.device == torch.device("cpu")
    assert make_local_embeddings_func(str(tiny_checkpoint)).encoder.device == torch.device("cuda")


async def test_batch_invariance_across_buckets(tiny_checkpoint):
    texts = ["the cat sat", "a dog ran", "red mat", "blue dog"]
    f1 = make_local_embeddings_func(str(tiny_checkpoint), max_length=16,
                                    compute_dtype="float32", device="cpu")
    solo = np.asarray(await f1(["the cat sat"]), np.float32)
    batched = np.asarray(await f1(texts), np.float32)
    np.testing.assert_allclose(solo[0], batched[0], atol=2e-6)
    f2 = make_local_embeddings_func(str(tiny_checkpoint), max_length=16,
                                    compute_dtype="float32", batch_size=2, device="cpu")
    np.testing.assert_allclose(batched, np.asarray(await f2(texts), np.float32), atol=2e-6)
    assert await f1([]) == []


# -- checkpoints --------------------------------------------------------------


def test_resolution_through_a_fake_hf_cache(tiny_checkpoint, tmp_path, monkeypatch):
    hub = tmp_path / "hub"
    repo = hub / "models--acme--tiny-bert"
    snap = repo / "snapshots" / "0123abcd"
    shutil.copytree(tiny_checkpoint, snap)
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abcd")
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    assert checkpoint.resolve_model_dir("acme/tiny-bert") == snap
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert checkpoint.resolve_model_dir("acme/tiny-bert") == snap
    want = _embed(make_local_embeddings_func, tiny_checkpoint, TEXTS[:2],
                  compute_dtype="float32", device="cpu")
    got = _embed(make_local_embeddings_func, "acme/tiny-bert", TEXTS[:2],
                 compute_dtype="float32", device="cpu")
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    with pytest.raises(FileNotFoundError, match="never downloads"):
        checkpoint.resolve_model_dir("acme/tiny-bert")


def test_non_bert_model_type_raises(tmp_path):
    # the encoders past BERT (roberta, xlm-roberta, distilbert, electra,
    # albert, roberta-prelayernorm, big_bird) are ported; roformer is not
    path = write_tiny_bert(tmp_path / "roformer", model_type="roformer")
    f = make_local_embeddings_func(str(path), device="cpu")
    with pytest.raises(NotImplementedError, match="roformer"):
        asyncio.run(f(["x"]))


def test_state_dict_from_the_flax_tree(tiny_checkpoint):
    """Every Flax leaf but the pooler lands on the encoder, transposed
    where Dense, under the PyTorch BertModel names."""
    from svs_tpu_torch.convert import bert_state_dict_from_flax
    from svs_tpu_torch.embeddings.bert import BertEncoder

    config, params = checkpoint.load_checkpoint(tiny_checkpoint)
    sd = bert_state_dict_from_flax(params)
    enc = BertEncoder(config)
    assert set(sd) == set(enc.state_dict())
    q = params["encoder"]["layer"]["1"]["attention"]["self"]["query"]["kernel"]
    np.testing.assert_array_equal(sd["encoder.layer.1.attention.self.query.weight"].numpy(), q.T)
    np.testing.assert_array_equal(
        sd["embeddings.LayerNorm.weight"].numpy(), params["embeddings"]["LayerNorm"]["scale"])


def test_msgpack_reader_and_writer_against_flax(tmp_path, monkeypatch):
    """The port's reader on Flax's bytes (a chunked array and a bf16 leaf
    included), and Flax's reader on the port's bytes."""
    import flax.serialization as fs
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    tree = {"a": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                  "ids": np.arange(7, dtype=np.int32)},
            "big": rng.standard_normal(1000).astype(np.float32),
            "half": np.asarray(jnp.asarray(rng.standard_normal(4), jnp.bfloat16))}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 1024)  # "big" is chunked
    raw = fs.msgpack_serialize(tree)
    got = checkpoint.unpackb(raw)
    for key in ("big", "half"):
        np.testing.assert_array_equal(np.asarray(got[key], np.float32),
                                      np.asarray(tree[key], np.float32))
    np.testing.assert_array_equal(got["a"]["kernel"], tree["a"]["kernel"])
    np.testing.assert_array_equal(got["a"]["ids"], tree["a"]["ids"])
    mine = {"a": tree["a"], "big": tree["big"]}
    back = fs.msgpack_restore(checkpoint.packb(mine))
    for k in ("kernel", "ids"):
        np.testing.assert_array_equal(back["a"][k], mine["a"][k])
    np.testing.assert_array_equal(back["big"], mine["big"])


def test_port_written_checkpoint_loads_in_transformers(tmp_path):
    """A checkpoint written with the port's writer (as the smoke writes
    one) is one ``transformers`` loads, and both encoders agree in f32."""
    from transformers import FlaxBertModel

    path = write_tiny_bert(tmp_path / "ck", seed=11)
    ref = FlaxBertModel.from_pretrained(str(path))
    ids = np.array([[2, 5, 7, 8, 3, 0]], np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 0]], np.int32)
    want = np.asarray(ref(input_ids=ids, attention_mask=mask).last_hidden_state)
    f = make_local_embeddings_func(str(path), compute_dtype="float32", device="cpu")
    got = f.encoder._load()[1](torch.from_numpy(ids.astype(np.int64)),
                               torch.from_numpy(mask.astype(np.int64)))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=F32_ATOL)
    cfg = json.loads((path / "config.json").read_text())
    assert cfg["model_type"] == "bert"
