"""The port's local provider past BERT (``svs_tpu_torch.embeddings``:
``encoders``, ``bert`` for RoBERTa / XLM-R / ELECTRA /
RoBERTa-PreLayerNorm, ``distilbert``, ``albert``, the ``tokenizer.json``
tokenizers) against ``svs_tpu``'s (``transformers`` + Flax) on the CPU
(BigBird has ``tests/test_torch_big_bird.py``).

For XLM-RoBERTa (a Unigram tokenizer in XLM-R's layout, ``Precompiled``
normaliser), RoBERTa (byte-level BPE), DistilBERT (learned positions with
a ``tokenizer.json``; sinusoidal ones with ``vocab.txt`` read as
``DistilBertTokenizer``), ELECTRA (``embedding_size`` below
``hidden_size``), RoBERTa-PreLayerNorm (byte-level BPE) and ALBERT (a
SentencePiece Unigram ``tokenizer.json`` in ``AlbertConverter``'s layout;
3 layers sharing one group, or 3 groups): a 32-wide Flax checkpoint that
``transformers`` writes from a seed, read from one directory by both
packages.  f32
embeddings agree within 1e-5 (mean and CLS pooling, normalised or not),
bf16 within ``BF16_ATOL``; the state dict converts from the plain tree and
from a head model's; a store that ``svs_tpu.KB`` wrote with the XLM-R
provider reopens in the port with no function and returns the same ids;
the smoke's random-checkpoint writer gives checkpoints that
``FlaxAutoModel`` reads the same way; the encoder-only type the port does
not run (``roformer``) and every option it does not compute raises
``NotImplementedError`` naming it, and the types ported since pass the
check."""

import asyncio
import json

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

import svs_tpu
from svs_tpu.embeddings import make_local_embeddings_func as ref_local
from svs_tpu_torch import KB
from svs_tpu_torch.convert import encoder_state_dict_from_flax
from svs_tpu_torch.embeddings import checkpoint, encoders
from svs_tpu_torch.embeddings.checkpoint import unwrap_head, write_checkpoint
from svs_tpu_torch.embeddings.local import make_local_embeddings_func

from torch_provider_helpers import write_tiny_bert
from torch_tokenizer_helpers import (
    write_bpe_tokenizer,
    write_sentencepiece_tokenizer,
    write_unigram_tokenizer,
    write_wordpiece_tokenizer,
)

torch.set_num_threads(2)

#: f32 on both sides: the same arithmetic in another order (XLA vs torch
#: CPU kernels) — a few ulps of a unit vector, far inside this.
F32_ATOL = 1e-5
#: bf16 on both sides: each rounds its matmul inputs to 8 mantissa bits at
#: its own places (Flax keeps the softmax in bf16, torch's autocast runs it
#: in f32); unnormalised vectors scale it by their norm (~5 at these widths).
BF16_ATOL = {True: 1e-2, False: 5e-2}

TEXTS = ["the cat sat on the mat", "a dog ran fast", "héllo мир κόσμε 中文", "",
         "unknownword cat", "the " * 40, "a <mask> b", "Red, BLUE! big-small"]
FAMILIES = ("xlm-roberta", "roberta", "distilbert", "distilbert-sinusoidal", "electra",
            "roberta-prelayernorm", "albert", "albert-3groups")
_TINY = dict(num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=64)


def _config(family, vocab_size):
    """The ``transformers`` config and base-model class of a family."""
    import transformers as T

    if family == "xlm-roberta":
        return T.XLMRobertaConfig(vocab_size=vocab_size, hidden_size=32, type_vocab_size=1,
                                  layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0,
                                  eos_token_id=2, **_TINY), T.FlaxXLMRobertaModel
    if family == "roberta":
        return T.RobertaConfig(vocab_size=vocab_size, hidden_size=32, type_vocab_size=1,
                               layer_norm_eps=1e-5, pad_token_id=1, **_TINY), T.FlaxRobertaModel
    if family.startswith("distilbert"):
        return T.DistilBertConfig(vocab_size=vocab_size, dim=32, n_layers=2, n_heads=2,
                                  hidden_dim=64, max_position_embeddings=64,
                                  sinusoidal_pos_embds=family.endswith("sinusoidal"),
                                  ), T.FlaxDistilBertModel
    if family == "roberta-prelayernorm":
        return T.RobertaPreLayerNormConfig(
            vocab_size=vocab_size, hidden_size=32, type_vocab_size=1, layer_norm_eps=1e-5,
            pad_token_id=1, **_TINY), T.FlaxRobertaPreLayerNormModel
    if family.startswith("albert"):
        # 3 layers: one group shared by all three, or a group each
        return T.AlbertConfig(vocab_size=vocab_size, embedding_size=16, hidden_size=32,
                              **{**_TINY, "num_hidden_layers": 3},
                              num_hidden_groups=3 if family.endswith("3groups") else 1,
                              ), T.FlaxAlbertModel
    return T.ElectraConfig(vocab_size=vocab_size, embedding_size=16, hidden_size=32,
                           **_TINY), T.FlaxElectraModel


def _tokenizer(family, path):
    if family == "xlm-roberta":
        return write_unigram_tokenizer(path, seed=1)
    if family in ("roberta", "roberta-prelayernorm"):
        return write_bpe_tokenizer(path, seed=2)
    if family.startswith("albert"):
        return write_sentencepiece_tokenizer(path, "albert", seed=4)
    if family == "distilbert":
        return write_wordpiece_tokenizer(path, "DistilBertTokenizerFast")
    if family == "distilbert-sinusoidal":
        return write_wordpiece_tokenizer(path, "DistilBertTokenizer")
    return write_wordpiece_tokenizer(path, "ElectraTokenizerFast")


@pytest.fixture(scope="session")
def checkpoints(tmp_path_factory):
    """A tiny Flax checkpoint and tokenizer of each family, written by
    ``transformers`` from a seed."""
    import transformers

    transformers.logging.set_verbosity_error()
    out = {}
    for i, family in enumerate(FAMILIES):
        path = tmp_path_factory.mktemp(family)
        vocab_size = _tokenizer(family, path)
        config, cls = _config(family, vocab_size)
        cls(config, seed=7 + i).save_pretrained(str(path))
        out[family] = path
    return out


def _embed(factory, path, texts, **kw):
    fn = factory(str(path), max_length=16, **kw)
    return np.asarray(asyncio.run(fn(list(texts))), np.float32)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("family", FAMILIES)
def test_f32_embeddings_match_svs_tpu(checkpoints, family, pooling, normalize):
    kw = dict(pooling=pooling, normalize=normalize, compute_dtype="float32")
    want = _embed(ref_local, checkpoints[family], TEXTS, **kw)
    got = _embed(make_local_embeddings_func, checkpoints[family], TEXTS, device="cpu", **kw)
    assert got.shape == want.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_embeddings_match_svs_tpu(checkpoints, family, normalize):
    want = _embed(ref_local, checkpoints[family], TEXTS, normalize=normalize)
    got = _embed(make_local_embeddings_func, checkpoints[family], TEXTS, device="cpu",
                 normalize=normalize)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL[normalize], rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_state_dict_from_the_flax_tree(checkpoints, family):
    """Every leaf of the base tree but the pooler lands on the encoder,
    Dense kernels transposed, under the Flax tree's names."""
    config, params = checkpoint.load_checkpoint(checkpoints[family])
    sd = encoder_state_dict_from_flax(config, params)
    enc = encoders.build_encoder(config)
    assert set(sd) == set(enc.state_dict())
    if family.startswith("distilbert"):
        q = params["transformer"]["layer"]["1"]["attention"]["q_lin"]["kernel"]
        name = "transformer.layer.1.attention.q_lin.weight"
    elif family.startswith("albert"):
        g = "2" if family.endswith("3groups") else "0"
        q = params["encoder"]["albert_layer_groups"][g]["albert_layers"]["0"]["attention"]["query"]["kernel"]
        name = f"encoder.albert_layer_groups.{g}.albert_layers.0.attention.query.weight"
    else:
        q = params["encoder"]["layer"]["1"]["attention"]["self"]["query"]["kernel"]
        name = "encoder.layer.1.attention.self.query.weight"
    np.testing.assert_array_equal(sd[name].numpy(), q.T)
    if family == "electra":
        assert sd["embeddings_project.weight"].shape == (32, 16)
        assert sd["embeddings.word_embeddings.weight"].shape[1] == 16
    if family.startswith("albert"):
        assert sd["encoder.embedding_hidden_mapping_in.weight"].shape == (32, 16)
        assert len(enc.encoder.albert_layer_groups) == (3 if family.endswith("3groups") else 1)
    if family == "roberta-prelayernorm":
        np.testing.assert_array_equal(sd["LayerNorm.weight"].numpy(), params["LayerNorm"]["scale"])


_HEADS = {"roberta": "FlaxRobertaForMaskedLM", "distilbert": "FlaxDistilBertForMaskedLM",
          "electra": "FlaxElectraForPreTraining", "albert": "FlaxAlbertForMaskedLM",
          "roberta-prelayernorm": "FlaxRobertaPreLayerNormForMaskedLM"}


@pytest.mark.parametrize("family", sorted(_HEADS))
def test_head_checkpoint_unwraps_as_flax_auto_model(checkpoints, family, tmp_path):
    """A head model's checkpoint (the base under ``base_model_prefix``):
    the port reads the base model ``FlaxAutoModel`` reads, and both embed
    alike."""
    import shutil

    import transformers

    config, _ = _config(family, json.loads((checkpoints[family] / "config.json").read_text())["vocab_size"])
    head = getattr(transformers, _HEADS[family])(config, seed=3)
    shutil.copytree(checkpoints[family], tmp_path / "head")
    (tmp_path / "head" / "flax_model.msgpack").unlink()
    head.save_pretrained(str(tmp_path / "head"))
    cfg, params = checkpoint.load_checkpoint(tmp_path / "head")
    assert "embeddings" in params
    sd = encoder_state_dict_from_flax(cfg, params)
    base = head.params[head.base_model_prefix]
    np.testing.assert_array_equal(sd["embeddings.word_embeddings.weight"].numpy(),
                                  np.asarray(base["embeddings"]["word_embeddings"]["embedding"]))
    kw = dict(compute_dtype="float32", pooling="cls")
    np.testing.assert_allclose(
        _embed(make_local_embeddings_func, tmp_path / "head", TEXTS, device="cpu", **kw),
        _embed(ref_local, tmp_path / "head", TEXTS, **kw), atol=F32_ATOL, rtol=0)


def test_xlm_roberta_wrappers(checkpoints, tmp_path):
    """XLM-R's ``base_model_prefix`` is ``xlm-roberta``: a tree under it
    unwraps (as ``FlaxAutoModel`` unwraps it); a tree under ``roberta``
    (what ``transformers``' XLM-R heads save) is refused, where
    ``FlaxAutoModel`` would run random weights."""
    import shutil

    config, params = checkpoint.load_checkpoint(checkpoints["xlm-roberta"])
    path = tmp_path / "wrapped"
    shutil.copytree(checkpoints["xlm-roberta"], path)
    write_checkpoint(path, config, {"xlm-roberta": params, "lm_head": {"bias": np.zeros(3, np.float32)}})
    kw = dict(compute_dtype="float32", pooling="mean")
    np.testing.assert_allclose(_embed(make_local_embeddings_func, path, TEXTS, device="cpu", **kw),
                               _embed(ref_local, path, TEXTS, **kw), atol=F32_ATOL, rtol=0)
    with pytest.raises(ValueError, match="random"):
        unwrap_head(config, {"roberta": params})


def test_svs_tpu_xlm_roberta_store_reopens_in_the_port(checkpoints, tmp_path):
    """A store written by ``svs_tpu.KB`` with the XLM-R provider (f32)
    opens in the port with NO function and returns the reference's ids
    and scores."""
    db = tmp_path / "xlmr.sqlite"
    f = ref_local(str(checkpoints["xlm-roberta"]), max_length=16, compute_dtype="float32",
                  pooling="cls")
    kb = svs_tpu.KB(db, f)
    docs = ["the cat sat on the mat", "a dog ran fast", "привет мир", "κόσμε",
            "中文 字", "happy cat", "big small dog", "héllo café", "مرحبا"]
    with kb.bulk_add_docs() as add:
        for d in docs:
            add(d)
    queries = ["cat", "мир", "dog ran", "中文"]
    want = kb.retrieve_batch(queries, 4)
    kb.close()
    port = KB(db, device="cpu")
    try:
        assert port.embedding_func.__embedding_func_params__["pooling"] == "cls"
        got = port.retrieve_batch(queries, 4)
    finally:
        port.close()
    assert [[h["doc"]["id"] for h in r] for r in got] == [[h["doc"]["id"] for h in r] for r in want]
    np.testing.assert_allclose([[h["score"] for h in r] for r in got],
                               [[h["score"] for h in r] for r in want], atol=F32_ATOL)


_SMOKE_CONFIGS = {
    "xlm-roberta": dict(model_type="xlm-roberta", hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
                        type_vocab_size=1, hidden_act="gelu", layer_norm_eps=1e-5,
                        pad_token_id=1, position_embedding_type="absolute"),
    "distilbert": dict(model_type="distilbert", dim=32, n_layers=2, n_heads=2, hidden_dim=64,
                       max_position_embeddings=64, activation="gelu", sinusoidal_pos_embds=False,
                       pad_token_id=0),
    "electra": dict(model_type="electra", embedding_size=16, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
                    type_vocab_size=2, hidden_act="gelu", layer_norm_eps=1e-12),
    "albert-3groups": dict(model_type="albert", embedding_size=16, hidden_size=32,
                           num_hidden_layers=3, num_hidden_groups=3, inner_group_num=1,
                           num_attention_heads=2, intermediate_size=64,
                           max_position_embeddings=64, type_vocab_size=2, hidden_act="gelu_new",
                           layer_norm_eps=1e-12),
    "roberta-prelayernorm": dict(model_type="roberta-prelayernorm", hidden_size=32,
                                 num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                                 max_position_embeddings=64, type_vocab_size=1, hidden_act="gelu",
                                 layer_norm_eps=1e-5, pad_token_id=1),
}


@pytest.mark.parametrize("family", sorted(_SMOKE_CONFIGS))
def test_smoke_checkpoint_writer_reads_in_transformers(checkpoints, family, tmp_path):
    """``chip_smoke.write_random_encoder`` (the card's random checkpoints)
    writes trees that ``FlaxAutoModel`` reads as the port does."""
    import shutil

    import chip_smoke

    path = tmp_path / family
    shutil.copytree(checkpoints[family], path)
    (path / "flax_model.msgpack").unlink()
    vocab = json.loads((checkpoints[family] / "config.json").read_text())["vocab_size"]
    chip_smoke.write_random_encoder(path, {**_SMOKE_CONFIGS[family], "vocab_size": vocab}, seed=5)
    kw = dict(compute_dtype="float32", pooling="cls")
    np.testing.assert_allclose(_embed(make_local_embeddings_func, path, TEXTS, device="cpu", **kw),
                               _embed(ref_local, path, TEXTS, **kw), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("model_type", sorted(encoders.UNPORTED))
def test_unported_encoder_types_raise_naming_themselves(tmp_path, model_type):
    path = write_tiny_bert(tmp_path / "ck", model_type=model_type)
    f = make_local_embeddings_func(str(path), device="cpu")
    with pytest.raises(NotImplementedError, match=model_type):
        asyncio.run(f(["x"]))


_NOW_PORTED = {"albert": "AlbertEncoder", "big_bird": "BigBirdEncoder",
               "roberta-prelayernorm": "BertEncoder", "bart": "BartEncoder",
               "mbart": "BartEncoder", "pegasus": "PegasusEncoder",
               "blenderbot": "BlenderbotEncoder", "blenderbot-small": "BlenderbotEncoder"}


@pytest.mark.parametrize("model_type", sorted(_NOW_PORTED))
def test_formerly_unported_encoder_types_are_accepted(tmp_path, model_type):
    """The types that raised until they were ported pass ``check_config``
    with a ``config.json`` that ``write_tiny_bert`` writes (the
    encoder-decoders read its ``hidden_size`` and ``num_attention_heads``
    through their ``attribute_map``), and build their encoder."""
    path = write_tiny_bert(tmp_path / "ck", model_type=model_type)
    config = checkpoint.read_config(path)
    assert model_type not in encoders.UNPORTED and model_type in encoders.MODEL_TYPES
    encoders.check_config(config)
    with torch.device("meta"):
        assert type(encoders.build_encoder(config)).__name__ == _NOW_PORTED[model_type]


@pytest.mark.parametrize("change,name", [
    ({"hidden_act": "gelu_fast"}, "gelu_fast"),
    ({"position_embedding_type": "relative_key"}, "relative_key"),
    ({"model_type": "marian"}, "marian"),
    ({"model_type": "distilbert", "activation": "mish"}, "mish"),
])
def test_unported_options_raise_naming_them(change, name):
    config = {"model_type": "roberta", "hidden_size": 32, "num_hidden_layers": 1,
              "num_attention_heads": 2, "intermediate_size": 64, "vocab_size": 10,
              "max_position_embeddings": 16, "dim": 32, "n_layers": 1, "n_heads": 2,
              "hidden_dim": 64, **change}
    with pytest.raises(NotImplementedError, match=name):
        encoders.check_config(config)
