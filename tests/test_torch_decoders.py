"""The port's Llama-family decoders (``svs_tpu_torch.embeddings.llama``,
``checkpoint``'s sharded reader and writer, the Llama and Gemma
tokenizers) against ``svs_tpu``'s local provider (``transformers`` + Flax)
on the CPU.

Tiny checkpoints that ``transformers`` writes from a seed
(``FlaxLlamaModel``, ``FlaxMistralModel``, ``FlaxGemmaModel``: 32 wide, 2
layers, ``max_position_embeddings`` 64) with a seeded tokenizer in
Llama-2's or Gemma's layout, read from one directory by both packages:

- f32 embeddings within 1e-5 and bf16 within ``BF16_ATOL``, mean and CLS
  pooling, normalised or not, on left-padded batches (CLS pools a pad
  position whose keys are all masked; one family adds no ``<s>``, so its
  empty texts are all-pad rows);
- multi-head (Llama, with attention biases), grouped-query (Mistral) and
  multi-query (Gemma, ``head_dim`` apart from ``hidden // heads``)
  attention; Mistral's ``sliding_window`` null (each token sees itself
  only), 2 and 4,096; a Llama with ``rope_theta`` 500,000 and a
  ``rope_scaling``, which Flax ignores, as the port does;
- the hidden states themselves against the Flax model's on hand-made
  masks (an all-pad row, a row padded to its last token);
- a sharded checkpoint that ``save_pretrained(max_shard_size=...)``
  writes reads as the single file does, the port's sharded writer writes
  what ``FlaxAutoModel`` reads, a ``*ForCausalLM`` tree unwraps, the state
  dict holds the checkpoint's arrays with no copy;
- a Llama tokenizer with no pad token is refused as the reference fails;
- a store that ``svs_tpu.KB`` wrote with the Mistral provider reopens in
  the port with no function and returns the same ids;
- bf16 against f32 over 16 layers of random weights with a query / key
  gain of 1 and 2: the port loses no more cosine than twice what
  ``svs_tpu``'s provider loses, and at gain 2 the reference itself loses
  more than 1e-3;
- the configurations Flax does not compute or fails on raise
  ``NotImplementedError`` naming what."""

import asyncio
import json
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

import svs_tpu
from svs_tpu.embeddings import make_local_embeddings_func as ref_local
from svs_tpu_torch import KB
from svs_tpu_torch.convert import encoder_state_dict_from_flax
from svs_tpu_torch.embeddings import checkpoint, encoders, llama
from svs_tpu_torch.embeddings.local import make_local_embeddings_func

from torch_tokenizer_helpers import write_decoder_tokenizer

torch.set_num_threads(2)

#: As ``tests/test_torch_local_encoders.py``: the same arithmetic in
#: another order on both sides, and bf16 rounding at each side's places.
F32_ATOL = 1e-5
BF16_ATOL = {True: 1e-2, False: 5e-2}

TEXTS = ["the cat sat on the mat", "a dog ran fast", "héllo мир κόσμε 中文", "",
         "unknownword cat", "the " * 40, "x", "Red, BLUE! big-small"]
_TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             max_position_embeddings=64)
#: family -> (transformers config class, keys, tokenizer layout, tokenizer config)
FAMILIES = {
    "llama": ("LlamaConfig", dict(num_attention_heads=4, num_key_value_heads=4,
                                  attention_bias=True), "llama", {"pad_token": "</s>"}),
    "llama-rope-theta": ("LlamaConfig", dict(num_attention_heads=4, num_key_value_heads=2,
                                             rope_theta=500000.0,
                                             rope_scaling={"rope_type": "linear", "factor": 4.0}),
                         "llama", {"pad_token": "</s>"}),
    "mistral": ("MistralConfig", dict(num_attention_heads=4, num_key_value_heads=2,
                                      sliding_window=4096), "llama", {"pad_token": "<unk>"}),
    "mistral-window-2": ("MistralConfig", dict(num_attention_heads=4, num_key_value_heads=2,
                                               sliding_window=2), "llama",
                         {"pad_token": "</s>", "add_eos_token": True}),
    "mistral-window-null": ("MistralConfig", dict(num_attention_heads=4, num_key_value_heads=2,
                                                  sliding_window=None), "llama",
                            {"pad_token": "</s>", "add_bos_token": False}),
    "gemma": ("GemmaConfig", dict(num_attention_heads=4, num_key_value_heads=1, head_dim=16,
                                  hidden_activation=None, hidden_act="gelu"), "gemma", {}),
}
_MODEL_CLASS = {"LlamaConfig": "FlaxLlamaModel", "MistralConfig": "FlaxMistralModel",
                "GemmaConfig": "FlaxGemmaModel"}


def _config(family, vocab_size):
    import transformers as T

    cls, keys, _, _ = FAMILIES[family]
    config = getattr(T, cls)(vocab_size=vocab_size, **_TINY, **keys)
    return config, getattr(T, _MODEL_CLASS[cls])


@pytest.fixture(scope="session")
def checkpoints(tmp_path_factory):
    """A tiny Flax checkpoint and tokenizer of each family, written by
    ``transformers`` from a seed."""
    import transformers

    transformers.logging.set_verbosity_error()
    out = {}
    for i, family in enumerate(FAMILIES):
        path = tmp_path_factory.mktemp(family)
        _, _, layout, tok_config = FAMILIES[family]
        vocab_size = write_decoder_tokenizer(path, layout, seed=i, **tok_config)
        config, cls = _config(family, vocab_size)
        cls(config, seed=11 + i).save_pretrained(str(path))
        out[family] = path
    return out


def _embed(factory, path, texts, **kw):
    fn = factory(str(path), max_length=16, **kw)
    return np.asarray(asyncio.run(fn(list(texts))), np.float32)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_embeddings_match_svs_tpu(checkpoints, family, pooling, normalize):
    kw = dict(pooling=pooling, normalize=normalize, compute_dtype="float32")
    want = _embed(ref_local, checkpoints[family], TEXTS, **kw)
    got = _embed(make_local_embeddings_func, checkpoints[family], TEXTS, device="cpu", **kw)
    assert got.shape == want.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_embeddings_match_svs_tpu(checkpoints, family, normalize):
    want = _embed(ref_local, checkpoints[family], TEXTS, normalize=normalize, pooling="cls")
    got = _embed(make_local_embeddings_func, checkpoints[family], TEXTS, device="cpu",
                 normalize=normalize, pooling="cls")
    np.testing.assert_allclose(got, want, atol=BF16_ATOL[normalize], rtol=0)


def _flax_model(path):
    import transformers

    config = json.loads((path / "config.json").read_text())
    cls = getattr(transformers, {"llama": "FlaxLlamaModel", "mistral": "FlaxMistralModel",
                                 "gemma": "FlaxGemmaModel"}[config["model_type"]])
    return cls.from_pretrained(str(path))


def _port_encoder(path):
    config, params = checkpoint.load_checkpoint(path)
    return encoders.load_encoder(config, encoder_state_dict_from_flax(config, params)).eval()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hidden_states_match_flax_under_left_padding(checkpoints, family):
    """Every position's last hidden state, pads included: a full row, rows
    padded on the left to their last 1 and 5 tokens, and an all-pad row
    (each of its queries has every key masked: a uniform softmax over the
    row, as Flax's finfo-minimum bias gives, with no NaN)."""
    model = _flax_model(checkpoints[family])
    rng = np.random.default_rng(3)
    ids = rng.integers(0, model.config.vocab_size, (4, 12))
    mask = np.ones((4, 12), np.int64)
    mask[1, :11] = 0
    mask[2, :7] = 0
    mask[3, :] = 0
    want = np.asarray(model(ids, attention_mask=mask).last_hidden_state)
    with torch.inference_mode():
        got = _port_encoder(checkpoints[family])(torch.from_numpy(ids), torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("window,moves", [(None, False), (2, False), (4096, True)])
def test_mistral_window_is_flax_triu_rule(checkpoints, window, moves):
    """``jnp.triu(causal, k=-(sliding_window or 0))``: the last of 8 tokens
    sees keys 7 - w .. 7, so changing token 0 moves its state only when
    ``w >= 7``; with ``sliding_window: null`` each token sees itself only.
    The port and Flax agree on every state."""
    family = {None: "mistral-window-null", 2: "mistral-window-2", 4096: "mistral"}[window]
    model = _flax_model(checkpoints[family])
    enc = _port_encoder(checkpoints[family])
    ids = np.arange(5, 13)[None].repeat(2, 0)
    ids[1, 0] = 30
    mask = np.ones_like(ids)
    want = np.asarray(model(ids, attention_mask=mask).last_hidden_state)
    with torch.inference_mode():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    moved = float(np.abs(got[0, -1] - got[1, -1]).max())
    assert (moved > 1e-3) == moves, moved
    if window == 2:  # two layers: token i reads tokens i - 4 .. i
        assert np.abs(got[0, 4] - got[1, 4]).max() > 1e-3
        assert np.abs(got[0, 5] - got[1, 5]).max() < 1e-6


def test_rotary_table_ignores_rope_theta(checkpoints):
    """The table is Flax's ``create_sinusoidal_positions`` at base 10,000
    whatever ``rope_theta`` / ``rope_scaling`` say (the checkpoint of
    ``llama-rope-theta`` sets 500,000 and a linear scaling)."""
    from transformers.models.llama.modeling_flax_llama import create_sinusoidal_positions

    want = np.asarray(create_sinusoidal_positions(64, 8))[:, 0, :]
    np.testing.assert_array_equal(llama.rotary_table(64, 8).numpy(), want)
    cfg = json.loads((checkpoints["llama-rope-theta"] / "config.json").read_text())
    assert cfg["rope_theta"] == 500000.0 and cfg["rope_scaling"]


def test_state_dict_is_the_checkpoint_arrays(checkpoints):
    """Every leaf of the base tree lands on the encoder under the Flax
    names; Dense kernels as transposed views and the embedding and norms as
    the arrays themselves: no copy (a 7B checkpoint's 28 GB)."""
    config, params = checkpoint.load_checkpoint(checkpoints["llama"])
    sd = encoder_state_dict_from_flax(config, params)
    enc = encoders.build_encoder(config)
    assert set(sd) == set(enc.state_dict())
    q = params["layers"]["1"]["self_attn"]["q_proj"]["kernel"]
    w = sd["layers.1.self_attn.q_proj.weight"]
    np.testing.assert_array_equal(w.numpy(), q.T)
    assert w.data_ptr() == q.ctypes.data and not w.is_contiguous()
    emb = params["embed_tokens"]["embedding"]
    assert sd["embed_tokens.weight"].data_ptr() == emb.ctypes.data
    assert "layers.0.self_attn.o_proj.bias" in sd and "layers.0.mlp.up_proj.bias" not in sd


def test_sharded_checkpoint_reads_as_the_single_file(checkpoints, tmp_path):
    """``save_pretrained(max_shard_size=...)`` writes an index and shards;
    the port reads the same tree as from the single file, and embeds the
    same as ``svs_tpu`` from the sharded directory.  The port's own
    writer shards as ``flax_shard_checkpoint`` does, and
    ``FlaxAutoModel`` reads its shards."""
    src = checkpoints["mistral"]
    model = _flax_model(src)
    sharded = tmp_path / "sharded"
    shutil.copytree(src, sharded)
    (sharded / "flax_model.msgpack").unlink()
    model.save_pretrained(str(sharded), max_shard_size="20KB")
    files = checkpoint.shard_files(sharded)
    assert len(files) > 2 and all(f.name.startswith("flax_model-000") for f in files)
    _, single = checkpoint.load_checkpoint(src)
    _, split = checkpoint.load_checkpoint(sharded)
    flat_a, flat_b = {}, {}
    checkpoint._flatten(single, "", flat_a)
    checkpoint._flatten(split, "", flat_b)
    assert list(flat_a) != [] and set(flat_a) == set(flat_b)
    for key in flat_a:
        np.testing.assert_array_equal(flat_a[key], flat_b[key])
    kw = dict(compute_dtype="float32", pooling="mean")
    np.testing.assert_allclose(_embed(make_local_embeddings_func, sharded, TEXTS, device="cpu", **kw),
                               _embed(ref_local, sharded, TEXTS, **kw), atol=F32_ATOL, rtol=0)
    # the port's writer on the model's tree (in its order): the same index
    # and shard names, and FlaxAutoModel reads the shards
    import jax

    config = json.loads((src / "config.json").read_text())
    mine = tmp_path / "mine"
    tree = jax.tree_util.tree_map(np.asarray, dict(model.params))
    written = checkpoint.write_checkpoint(mine, config, tree, max_shard_size=20_000)
    index = json.loads((mine / checkpoint.FLAX_WEIGHTS_INDEX).read_text())
    want_index = json.loads((sharded / checkpoint.FLAX_WEIGHTS_INDEX).read_text())
    # (both write an empty first shard, as flax_shard_checkpoint does when
    # the first leaf passes the size; the index names no leaf in it)
    assert index == want_index
    assert [f.name for f in written] == sorted(f.name for f in sharded.glob("flax_model-*"))
    reread = _flax_model(mine)
    ids = np.arange(3, 15)[None]
    np.testing.assert_array_equal(np.asarray(reread(ids).last_hidden_state),
                                  np.asarray(model(ids).last_hidden_state))


def test_bf16_torch_leaves_round_trip():
    """A torch bf16 leaf is written as Flax writes bf16 (``msgpack_restore``
    reads it) and reads back as its f32 values."""
    from flax import serialization

    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).bfloat16()
    f = rng.standard_normal((6, 5)).astype(np.float32)
    blob = checkpoint.packb({"a": {"w": w}, "f": f})
    back = checkpoint.unpackb(blob)
    np.testing.assert_array_equal(back["a"]["w"], w.float().numpy())
    np.testing.assert_array_equal(back["f"], f)
    flax_tree = serialization.msgpack_restore(blob)
    np.testing.assert_array_equal(np.asarray(flax_tree["a"]["w"], np.float32), w.float().numpy())
    np.testing.assert_array_equal(flax_tree["f"], f)


@pytest.mark.parametrize("family", ["llama", "mistral", "gemma"])
def test_causal_lm_tree_unwraps_as_flax_auto_model(checkpoints, family, tmp_path):
    """A ``*ForCausalLM`` checkpoint holds the base model under ``model``
    (these families' ``base_model_prefix``) and an ``lm_head``: the port
    reads the base model ``FlaxAutoModel`` reads, and both embed alike."""
    import transformers

    path = tmp_path / "causal"
    shutil.copytree(checkpoints[family], path)
    (path / "flax_model.msgpack").unlink()
    config, _ = _config(family, json.loads((path / "config.json").read_text())["vocab_size"])
    head = getattr(transformers, _MODEL_CLASS[type(config).__name__].replace("Model", "ForCausalLM"))
    head(config, seed=5).save_pretrained(str(path))
    cfg, params = checkpoint.load_checkpoint(path)
    assert set(params) == {"embed_tokens", "layers", "norm"}
    kw = dict(compute_dtype="float32", pooling="mean")
    np.testing.assert_allclose(_embed(make_local_embeddings_func, path, TEXTS, device="cpu", **kw),
                               _embed(ref_local, path, TEXTS, **kw), atol=F32_ATOL, rtol=0)


def test_llama_tokenizer_without_pad_token_is_refused(checkpoints, tmp_path):
    """``LlamaTokenizerFast`` has no pad token by default, and
    ``padding="max_length"`` fails in ``transformers``; the port refuses
    the same directory."""
    path = tmp_path / "nopad"
    shutil.copytree(checkpoints["mistral"], path)
    write_decoder_tokenizer(path, "llama", seed=2)  # the config names no pad token
    with pytest.raises(ValueError, match="pad"):
        _embed(ref_local, path, ["a cat"])
    with pytest.raises(ValueError, match="no pad token"):
        _embed(make_local_embeddings_func, path, ["a cat"], device="cpu")


def test_svs_tpu_mistral_store_reopens_in_the_port(checkpoints, tmp_path):
    """A store written by ``svs_tpu.KB`` with the Mistral provider (f32)
    opens in the port with NO function and returns the reference's ids
    and scores."""
    db = tmp_path / "mistral.sqlite"
    f = ref_local(str(checkpoints["mistral"]), max_length=16, compute_dtype="float32",
                  pooling="mean")
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
        assert port.embedding_func.__embedding_func_params__["pooling"] == "mean"
        got = port.retrieve_batch(queries, 4)
    finally:
        port.close()
    assert [[h["doc"]["id"] for h in r] for r in got] == [[h["doc"]["id"] for h in r] for r in want]
    np.testing.assert_allclose([[h["score"] for h in r] for r in got],
                               [[h["score"] for h in r] for r in want], atol=F32_ATOL)


_BASE = {"model_type": "llama", "vocab_size": 10, "hidden_size": 32, "intermediate_size": 64,
         "num_hidden_layers": 1, "num_attention_heads": 4, "num_key_value_heads": 2,
         "max_position_embeddings": 64}


@pytest.mark.parametrize("change,name", [
    ({"head_dim": 16}, "head_dim"),
    ({"model_type": "mistral", "head_dim": 4}, "head_dim"),
    ({"num_attention_heads": 3, "num_key_value_heads": 3}, "multiple of num_attention_heads"),
    ({"num_key_value_heads": 3}, "num_key_value_heads"),
    ({"max_position_embeddings": 8}, "max_position_embeddings"),
    ({"model_type": "gemma", "head_dim": 7}, "odd head width"),
    ({"hidden_act": "gelu_fast"}, "gelu_fast"),
    ({"model_type": "gemma", "hidden_activation": "mish"}, "mish"),
])
def test_configs_flax_does_not_compute_raise_naming_them(change, name):
    with pytest.raises(NotImplementedError, match=name):
        encoders.check_config({**_BASE, **change})


@pytest.mark.parametrize("model_type", ["llama", "mistral", "gemma"])
def test_decoder_types_pass_with_their_defaults(model_type):
    """A ``config.json`` that leaves keys out takes ``transformers``'
    defaults (Gemma's ``head_dim`` 256, Mistral's 8 KV heads)."""
    config = {"model_type": model_type, "vocab_size": 10, "hidden_size": 64,
              "num_attention_heads": 4, "num_hidden_layers": 1, "intermediate_size": 8,
              "max_position_embeddings": 512}
    if model_type == "mistral":
        config["num_attention_heads"] = 8
    if model_type == "gemma":  # its default 16 KV heads would not divide 4 heads
        config["num_key_value_heads"] = 1
    encoders.check_config(config)
    with torch.device("meta"):
        enc = encoders.build_encoder(config)
    assert type(enc).__name__ == "LlamaEncoder"
    k = enc.layers[0].self_attn.k_proj.weight
    assert k.shape == {"llama": (64, 64), "mistral": (64, 64), "gemma": (256, 64)}[model_type]


#: The bf16 check's model: e5-mistral-7b-instruct's shape (Mistral, 4
#: query heads a KV head, head width 32 here) at 128 wide and 16 layers,
#: random weights from ``chip_smoke.random_decoder_params``.
_GAIN_CONFIG = {"model_type": "mistral", "architectures": ["MistralModel"], "vocab_size": 2000,
                "hidden_size": 128, "num_hidden_layers": 16, "num_attention_heads": 4,
                "num_key_value_heads": 1, "intermediate_size": 448,
                "max_position_embeddings": 256, "rms_norm_eps": 1e-5, "sliding_window": 4096,
                "hidden_act": "silu", "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 2}


@pytest.mark.parametrize("gain", [1.0, 2.0])
def test_bf16_loss_at_a_query_key_gain_is_the_references(tmp_path, gain):
    """How far bf16 departs from f32 over 16 layers whose query and key
    kernels are drawn ``gain`` times wider (``random_decoder_params``'
    ``qk``): the port's min cosine to its own f32 run loses no more than
    twice what ``svs_tpu``'s bf16 provider loses to its own f32 run, on 8
    passages of 60-120 words.  At gain 2 (the encoders' ``LOCAL_QK``) the
    reference itself loses more than 1e-3, as the 7B store's bf16 rows did
    on the card at gain 2: the sharper random attention amplifies bf16
    rounding in both packages alike, so the decoders of the smoke draw
    gain 1."""
    import chip_smoke

    tree = chip_smoke.random_decoder_params(_GAIN_CONFIG, 7, "cpu", qk=gain, dtype="float32")
    checkpoint.write_checkpoint(tmp_path, _GAIN_CONFIG, tree)
    words = chip_smoke.write_decoder_tokenizer(tmp_path, "llama", 2000, 3, pad_token="</s>")
    texts = chip_smoke.passages(words, 8, 11, 60, 120)
    kw = dict(pooling="mean", max_length=128, batch_size=8)
    loss = {}
    for name, factory, extra in (("port", make_local_embeddings_func, {"device": "cpu"}),
                                 ("svs_tpu", ref_local, {})):
        f32, bf16 = (np.asarray(asyncio.run(factory(str(tmp_path), compute_dtype=dt, **kw,
                                                     **extra)(texts)), np.float32)
                     for dt in ("float32", "bfloat16"))
        loss[name] = 1.0 - float((f32 * bf16).sum(axis=1).min())
    print(f"gain {gain}: 1 - min cosine of bf16 to f32: {loss}")
    assert loss["port"] <= 2.0 * loss["svs_tpu"]
    if gain == 2.0:
        assert loss["svs_tpu"] > 1e-3

