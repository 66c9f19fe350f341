"""The port's GPT-2, GPT-Neo, GPT-J, BLOOM and XGLM decoders
(``svs_tpu_torch.embeddings.gpt2``, ``gpt_neo``, ``gptj``, ``bloom``,
``xglm``) against ``svs_tpu``'s local provider (``transformers`` + Flax)
on the CPU.

Tiny checkpoints that ``transformers`` writes from a seed (``Flax*Model``:
32 wide, 2 layers) with seeded tokenizers saved by each type's fast class
(``GPT2TokenizerFast`` with a pad token, ``BloomTokenizerFast``,
``XGLMTokenizerFast``), read from one directory by both packages:

- f32 embeddings within 1e-5 and bf16 within ``BF16_ATOL``, mean and CLS
  pooling, normalised or not, on right- and left-padded batches;
- the hidden states themselves against the Flax model's on hand-made
  masks (an all-pad row, left and right padding);
- each quirk: GPT-2's ``FlaxConv1D`` kernels taken as they are (the square
  ``c_proj`` transposed would move the result); GPT-Neo's local window
  at a ``max_length`` above it, where it moves the result; GPT-J rotating
  8 of 16 lanes a head, and the whole head with ``rotary_dim: null``;
  BLOOM's ALiBi rounded to bf16 as Flax rounds it, at a length where the
  rounding moves the result, and ``apply_residual_connection_post_layernorm``
  both ways; XGLM with ``scale_embedding`` on and off;
- a ``*LMHeadModel`` / ``*ForCausalLM`` tree unwraps as ``FlaxAutoModel``
  unwraps it (GPT-J's ``lm_head`` with its bias);
- a GPT-2 tokenizer with no pad token is refused as the reference fails;
- the configurations Flax does not compute or fails on (BLOOM with 3 or 6
  heads among them) raise ``NotImplementedError`` naming what."""

import asyncio
import json
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from svs_tpu.embeddings import make_local_embeddings_func as ref_local
from svs_tpu_torch.convert import encoder_state_dict_from_flax
from svs_tpu_torch.embeddings import bloom, checkpoint, encoders
from svs_tpu_torch.embeddings.local import make_local_embeddings_func

from torch_tokenizer_helpers import write_byte_level_tokenizer, write_xglm_tokenizer

torch.set_num_threads(2)

#: As ``tests/test_torch_decoders.py``.
F32_ATOL = 1e-5
BF16_ATOL = {True: 1e-2, False: 5e-2}

TEXTS = ["the cat sat on the mat", "a dog ran fast", "héllo мир κόσμε 中文", "",
         "unknownword cat", "the " * 40, "x", "Red, BLUE! big-small"]
_PAD = {"pad_token": "<|endoftext|>"}
#: family -> (transformers class stem, config keys, tokenizer layout, tokenizer config)
FAMILIES = {
    "gpt2": ("GPT2", dict(n_embd=32, n_layer=2, n_head=4, n_positions=64), "gpt2", _PAD),
    "gpt2-relu-left": ("GPT2", dict(n_embd=32, n_layer=2, n_head=4, n_positions=64, n_inner=48,
                                    activation_function="relu"), "gpt2",
                       {**_PAD, "padding_side": "left"}),
    "gpt_neo": ("GPTNeo", dict(hidden_size=32, num_layers=2, num_heads=4,
                               attention_types=[[["global", "local"], 1]], window_size=4,
                               max_position_embeddings=64), "gpt2", _PAD),
    "gptj": ("GPTJ", dict(n_embd=32, n_layer=2, n_head=2, rotary_dim=8, n_positions=64),
             "gpt2", _PAD),
    "gptj-rotary-null": ("GPTJ", dict(n_embd=32, n_layer=2, n_head=1, rotary_dim=None,
                                      n_positions=64), "gpt2", {**_PAD, "padding_side": "left"}),
    "bloom": ("Bloom", dict(hidden_size=32, n_layer=2, n_head=4), "bloom", {}),
    "bloom-post-ln-left": ("Bloom", dict(hidden_size=32, n_layer=2, n_head=4,
                                         apply_residual_connection_post_layernorm=True),
                           "bloom", {"padding_side": "left"}),
    "xglm": ("XGLM", dict(d_model=32, num_layers=2, attention_heads=4, ffn_dim=64,
                          max_position_embeddings=64), "xglm", {}),
    "xglm-unscaled": ("XGLM", dict(d_model=32, num_layers=2, attention_heads=4, ffn_dim=64,
                                   max_position_embeddings=64, scale_embedding=False),
                      "xglm", {}),
}


def _config(family, vocab_size, **extra):
    import transformers as T

    stem, keys, _, _ = FAMILIES[family]
    return getattr(T, f"{stem}Config")(vocab_size=vocab_size, **keys, **extra)


def _model_class(family, suffix="Model"):
    import transformers as T

    return getattr(T, f"Flax{FAMILIES[family][0]}{suffix}")


def _write_tokenizer(path, family, seed, **config):
    layout, tok_config = FAMILIES[family][2], {**FAMILIES[family][3], **config}
    if layout == "xglm":
        return write_xglm_tokenizer(path, seed, **tok_config)
    return write_byte_level_tokenizer(path, layout, seed, **tok_config)


@pytest.fixture(scope="session")
def checkpoints(tmp_path_factory):
    """A tiny Flax checkpoint and tokenizer of each family, written by
    ``transformers`` from a seed."""
    import transformers

    transformers.logging.set_verbosity_error()
    out = {}
    for i, family in enumerate(FAMILIES):
        path = tmp_path_factory.mktemp(family)
        vocab_size = _write_tokenizer(path, family, seed=i)
        _model_class(family)(_config(family, vocab_size), seed=11 + i).save_pretrained(str(path))
        out[family] = path
    return out


def _embed(factory, path, texts, max_length=16, **kw):
    fn = factory(str(path), max_length=max_length, **kw)
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


def _port_encoder(path):
    config, params = checkpoint.load_checkpoint(path)
    return encoders.load_encoder(config, encoder_state_dict_from_flax(config, params)).eval()


def _hidden(enc, ids, mask, bf16=False):
    with torch.inference_mode(), torch.autocast("cpu", dtype=torch.bfloat16, enabled=bf16):
        return enc(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hidden_states_match_flax_under_padding(checkpoints, family):
    """Every position's last hidden state, pads included: a full row, a row
    padded on the left to its last 7 tokens, one padded on the right after
    its first 5, and an all-pad row (each of its queries has every key
    masked: a uniform softmax over the row, as Flax's dtype-minimum bias
    gives, with no NaN)."""
    model = _model_class(family).from_pretrained(str(checkpoints[family]))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, model.config.vocab_size, (4, 12))
    mask = np.ones((4, 12), np.int64)
    mask[1, :5] = 0
    mask[2, 5:] = 0
    mask[3, :] = 0
    want = np.asarray(model(ids, attention_mask=mask).last_hidden_state)
    got = _hidden(_port_encoder(checkpoints[family]), ids, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_gpt2_conv1d_kernels_are_not_transposed(checkpoints):
    """``FlaxConv1D`` keeps ``[features, in]``, PyTorch's ``[out, in]``: the
    state dict holds GPT-2's kernels as they are (no copy), the non-square
    ``c_attn`` / ``c_fc`` included; the square ``c_proj`` transposed, as
    the Dense walker would take it, moves the hidden states."""
    path = checkpoints["gpt2"]
    config, params = checkpoint.load_checkpoint(path)
    sd = encoder_state_dict_from_flax(config, params)
    for name in ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj"):
        part, leaf = name.split(".")
        kernel = params["h"]["0"][part][leaf]["kernel"]
        w = sd[f"h.0.{name}.weight"]
        np.testing.assert_array_equal(w.numpy(), kernel)
        assert w.data_ptr() == kernel.ctypes.data
    assert sd["h.0.attn.c_attn.weight"].shape == (96, 32)
    assert sd["h.0.mlp.c_fc.weight"].shape == (128, 32)
    assert sd["ln_f.weight"].data_ptr() == params["ln_f"]["scale"].ctypes.data
    ids = np.arange(3, 15)[None]
    mask = np.ones_like(ids)
    enc = encoders.load_encoder(config, sd).eval()
    right = _hidden(enc, ids, mask)
    sd["h.0.attn.c_proj.weight"] = sd["h.0.attn.c_proj.weight"].T
    wrong = _hidden(encoders.load_encoder(config, sd).eval(), ids, mask)
    want = np.asarray(_model_class("gpt2").from_pretrained(str(path))(ids).last_hidden_state)
    np.testing.assert_allclose(right, want, atol=F32_ATOL, rtol=0)
    assert np.abs(wrong - want).max() > 1e-3


def test_gpt_neo_local_window_moves_the_result(checkpoints, tmp_path):
    """The local layer's query sees its last ``window_size`` (4) keys: at
    ``max_length`` 16 (texts past 4 tokens) the embeddings differ from the
    same weights with a 256-token window, and both agree with ``svs_tpu``'s
    provider; so does the per-position rule (``causal ^ tril(causal,
    -window_size)``) on the hidden states."""
    wide = tmp_path / "wide"
    shutil.copytree(checkpoints["gpt_neo"], wide)
    cfg = json.loads((wide / "config.json").read_text())
    assert cfg["window_size"] == 4 and cfg["attention_layers"] == ["global", "local"]
    cfg["window_size"] = 256
    (wide / "config.json").write_text(json.dumps(cfg))
    kw = dict(compute_dtype="float32", pooling="mean")
    runs = {}
    for name, path in (("window 4", checkpoints["gpt_neo"]), ("window 256", wide)):
        got = _embed(make_local_embeddings_func, path, TEXTS, device="cpu", **kw)
        np.testing.assert_allclose(got, _embed(ref_local, path, TEXTS, **kw), atol=F32_ATOL, rtol=0)
        runs[name] = got
    assert np.abs(runs["window 4"] - runs["window 256"]).max() > 1e-3
    model = _model_class("gpt_neo").from_pretrained(str(checkpoints["gpt_neo"]))
    ids = np.arange(5, 17)[None]
    np.testing.assert_allclose(_hidden(_port_encoder(checkpoints["gpt_neo"]), ids, np.ones_like(ids)),
                               np.asarray(model(ids).last_hidden_state), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("family,rotated", [("gptj", 8), ("gptj-rotary-null", 32)])
def test_gptj_rotates_the_first_rotary_dim_lanes(checkpoints, family, rotated):
    """``rotary_dim`` 8 of a 16-lane head turns lanes 0-7 (interleaved
    pairs) and leaves 8-15; ``null`` (one head) turns the whole head.  The
    port's query after the rotation equals Flax's ``apply_rotary_pos_emb``
    on the same lanes, and the hidden states agree (the parity tests)."""
    from transformers.models.gptj.modeling_flax_gptj import (
        apply_rotary_pos_emb,
        create_sinusoidal_positions,
    )

    from svs_tpu_torch.embeddings import gptj

    cfg = json.loads((checkpoints[family] / "config.json").read_text())
    assert cfg["rotary_dim"] == (None if rotated == 32 else rotated)
    n = 12
    table = np.asarray(create_sinusoidal_positions(64, rotated))[:n]
    sin, cos = gptj.sinusoidal_positions(n, rotated)
    np.testing.assert_array_equal(np.concatenate([sin.numpy(), cos.numpy()], -1), table)
    x = np.random.default_rng(0).standard_normal((1, n, 1, rotated)).astype(np.float32)
    want = np.asarray(apply_rotary_pos_emb(x, np.split(table[None], 2, axis=-1)))
    s2, c2 = (t.repeat_interleave(2, -1)[:, None] for t in (sin, cos))
    xt = torch.from_numpy(x)
    got = xt * c2 + gptj._rotate_every_two(xt) * s2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_bloom_alibi_is_flax_build_alibi_tensor():
    """The slopes times ``cumsum(mask) - 1`` (0 on pads), left and right
    padding, cast to the hidden dtype: equal to Flax's
    ``build_alibi_tensor`` in f32 and in bf16 for 4, 8 and 16 heads."""
    import jax.numpy as jnp
    from transformers.models.bloom.modeling_flax_bloom import build_alibi_tensor

    mask = np.ones((3, 600), np.int32)
    mask[1, :200] = 0
    mask[2, 450:] = 0
    for heads in (4, 8, 16):
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            want = np.asarray(build_alibi_tensor(mask, heads, jdt).astype(jnp.float32))
            got = bloom.alibi(torch.from_numpy(mask), heads, dt).float().numpy()
            np.testing.assert_array_equal(got, want)


def test_bloom_bf16_alibi_rounding_moves_the_result(tmp_path):
    """Under bf16 Flax casts the ALiBi tensor to bf16 before adding it: a
    slope of 1/4 times a position past 256 loses its last bits.  On
    weights drawn at ``initializer_range`` 0.2, at 520 tokens the port's
    bf16 hidden states agree with Flax's bf16 ones (within 0.1) and, with
    the tensor left in f32, miss them by more than 0.2; at 200 tokens the
    rounding is exact and moves nothing."""
    import jax.numpy as jnp
    import transformers as T

    cfg = T.BloomConfig(vocab_size=60, hidden_size=32, n_layer=2, n_head=4, initializer_range=0.2)
    T.FlaxBloomModel(cfg, seed=7).save_pretrained(str(tmp_path))
    model = T.FlaxBloomModel.from_pretrained(str(tmp_path), dtype=jnp.bfloat16)
    enc = _port_encoder(tmp_path)
    rounded = bloom.alibi
    for n, moves in ((200, False), (520, True)):
        rng = np.random.default_rng(5)
        ids = rng.integers(0, 60, (2, n))
        mask = np.ones((2, n), np.int64)
        mask[1, : n // 3] = 0
        want = np.asarray(model(ids, attention_mask=mask).last_hidden_state.astype(jnp.float32))
        got = _hidden(enc, ids, mask, bf16=True)
        try:
            bloom.alibi = lambda m, h, dt: rounded(m, h, torch.float32)
            unrounded = _hidden(enc, ids, mask, bf16=True)
        finally:
            bloom.alibi = rounded
        assert np.abs(got - want).max() < 0.1
        moved = float(np.abs(unrounded - want).max())
        assert (moved > 0.2) == moves, moved
        assert (np.abs(unrounded - got).max() > 0) == moves


def test_bloom_post_layernorm_residual_moves_the_result(checkpoints, tmp_path):
    """``apply_residual_connection_post_layernorm`` takes the layer norms
    as the residuals: the same weights (drawn at ``initializer_range`` 0.2,
    so that the layers move the residual stream) with the flag flipped
    embed otherwise, and each agrees with ``svs_tpu``'s provider."""
    import transformers as T

    runs = []
    for flag in (False, True):
        path = tmp_path / f"post_ln_{flag}"
        shutil.copytree(checkpoints["bloom"], path)
        vocab = json.loads((path / "config.json").read_text())["vocab_size"]
        cfg = T.BloomConfig(vocab_size=vocab, hidden_size=32, n_layer=2, n_head=4,
                            initializer_range=0.2, apply_residual_connection_post_layernorm=flag)
        T.FlaxBloomModel(cfg, seed=3).save_pretrained(str(path))
        kw = dict(compute_dtype="float32", pooling="mean")
        got = _embed(make_local_embeddings_func, path, TEXTS, device="cpu", **kw)
        np.testing.assert_allclose(got, _embed(ref_local, path, TEXTS, **kw), atol=F32_ATOL, rtol=0)
        runs.append(got)
    assert np.abs(runs[0] - runs[1]).max() > 1e-2


def test_xglm_positions_and_embedding_scale(checkpoints):
    """The sinusoidal table is Flax's ``create_sinusoidal_positions`` (row
    1 zeroed), read from row 2 whatever the padding; ``scale_embedding``
    multiplies the token embeddings by ``sqrt(d_model)``: the scaled and
    unscaled checkpoints hold different flags and both agree with Flax
    (the parity tests)."""
    from transformers.models.xglm.modeling_flax_xglm import create_sinusoidal_positions

    from svs_tpu_torch.embeddings import xglm

    np.testing.assert_array_equal(xglm.sinusoidal_positions(66, 32).numpy(),
                                  np.asarray(create_sinusoidal_positions(66, 32)))
    flags = {f: json.loads((checkpoints[f] / "config.json").read_text())["scale_embedding"]
             for f in ("xglm", "xglm-unscaled")}
    assert flags == {"xglm": True, "xglm-unscaled": False}
    assert _port_encoder(checkpoints["xglm"]).embed_scale == pytest.approx(32 ** 0.5)
    assert _port_encoder(checkpoints["xglm-unscaled"]).embed_scale == 1.0


_HEADS = {"gpt2": ("GPT2", "LMHeadModel", {"tie_word_embeddings": False}, "transformer"),
          "gpt_neo": ("GPTNeo", "ForCausalLM", {}, "transformer"),
          "gptj": ("GPTJ", "ForCausalLM", {}, "transformer"),
          "bloom": ("Bloom", "ForCausalLM", {}, "transformer"),
          "xglm": ("XGLM", "ForCausalLM", {}, "model")}


@pytest.mark.parametrize("family", sorted(_HEADS))
def test_head_tree_unwraps_as_flax_auto_model(checkpoints, family, tmp_path):
    """A ``*LMHeadModel`` / ``*ForCausalLM`` checkpoint holds the base model
    under ``transformer`` (``model`` for XGLM) beside its ``lm_head`` (GPT-J's
    with a bias): the port reads the base model ``FlaxAutoModel`` reads,
    and both embed alike."""
    _, suffix, extra, prefix = _HEADS[family]
    path = tmp_path / "head"
    shutil.copytree(checkpoints[family], path)
    (path / "flax_model.msgpack").unlink()
    vocab = json.loads((path / "config.json").read_text())["vocab_size"]
    head = _model_class(family, suffix)(_config(family, vocab, **extra), seed=5)
    head.save_pretrained(str(path))
    raw = checkpoint.unpackb(checkpoint._read_file(path / checkpoint.FLAX_WEIGHTS))
    assert prefix in raw
    if family == "gptj":
        assert set(raw["lm_head"]) == {"kernel", "bias"}
    _, params = checkpoint.load_checkpoint(path)
    assert encoders.BASE_TREE_KEY[family] in params and prefix not in params
    kw = dict(compute_dtype="float32", pooling="mean")
    np.testing.assert_allclose(_embed(make_local_embeddings_func, path, TEXTS, device="cpu", **kw),
                               _embed(ref_local, path, TEXTS, **kw), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaves_past_the_chunk_size_are_written_as_flax_chunks(monkeypatch, dtype):
    """A leaf past ``MAX_CHUNK_BYTES`` (2^30, as Flax's; BLOOM-7b1's 250,880
    x 4,096 bf16 embedding is 2.05 GB) is written as Flax's
    ``__msgpack_chunked_array__`` map of 1-D chunks: the port reads it back
    and ``flax.serialization.msgpack_restore`` restores the same array (the
    limit lowered here to 1,000 bytes)."""
    from flax import serialization

    monkeypatch.setattr(checkpoint, "MAX_CHUNK_BYTES", 1000)
    rng = np.random.default_rng(1)
    big = torch.from_numpy(rng.standard_normal((37, 29)).astype(np.float32)).to(getattr(torch, dtype))
    small = rng.standard_normal((3, 4)).astype(np.float32)
    blob = checkpoint.packb({"emb": {"embedding": big}, "ln": {"scale": small}})
    back = checkpoint.unpackb(blob)
    np.testing.assert_array_equal(back["emb"]["embedding"], big.float().numpy())
    np.testing.assert_array_equal(back["ln"]["scale"], small)
    restored = serialization.msgpack_restore(blob)
    np.testing.assert_array_equal(np.asarray(restored["emb"]["embedding"], np.float32),
                                  big.float().numpy())
    import msgpack

    tree = msgpack.unpackb(blob, raw=False, ext_hook=lambda code, data: code)
    chunked = tree["emb"]["embedding"]
    assert chunked["__msgpack_chunked_array__"] is True and chunked["shape"] == {"0": 37, "1": 29}
    assert len(chunked["chunks"]) == -(-37 * 29 * big.element_size() // 1000)


def test_gpt2_tokenizer_without_pad_token_is_refused(checkpoints, tmp_path):
    """``GPT2TokenizerFast`` has no pad token by default, and
    ``padding="max_length"`` fails in ``transformers``; the port refuses
    the same directory."""
    path = tmp_path / "nopad"
    shutil.copytree(checkpoints["gptj"], path)
    write_byte_level_tokenizer(path, "gpt2", seed=3)  # the config names no pad token
    with pytest.raises(ValueError, match="pad"):
        _embed(ref_local, path, ["a cat"])
    with pytest.raises(ValueError, match="no pad token"):
        _embed(make_local_embeddings_func, path, ["a cat"], device="cpu")


_BASE = {
    "gpt2": {"model_type": "gpt2", "vocab_size": 10, "n_embd": 32, "n_layer": 1, "n_head": 4,
             "n_positions": 16},
    "gpt_neo": {"model_type": "gpt_neo", "vocab_size": 10, "hidden_size": 32, "num_layers": 2,
                "num_heads": 4, "attention_types": [[["global", "local"], 1]],
                "max_position_embeddings": 16},
    "gptj": {"model_type": "gptj", "vocab_size": 10, "n_embd": 32, "n_layer": 1, "n_head": 4,
             "rotary_dim": 4, "n_positions": 16},
    "bloom": {"model_type": "bloom", "vocab_size": 10, "hidden_size": 32, "n_layer": 1,
              "n_head": 4},
    "xglm": {"model_type": "xglm", "vocab_size": 10, "d_model": 32, "num_layers": 1,
             "attention_heads": 4, "ffn_dim": 64, "max_position_embeddings": 16},
}


@pytest.mark.parametrize("family,change,name", [
    ("bloom", {"n_head": 3, "hidden_size": 24}, "n_head"),
    ("bloom", {"n_head": 6, "hidden_size": 36}, "n_head"),
    ("bloom", {"n_head": 5}, "multiple of the head count"),
    ("gpt2", {"add_cross_attention": True}, "add_cross_attention"),
    ("gpt2", {"n_head": 5}, "multiple of the head count"),
    ("gpt2", {"activation_function": "gelu_fast"}, "gelu_fast"),
    ("gpt_neo", {"attention_types": [[["global", "local"], 2]]}, "attention_types"),
    ("gpt_neo", {"attention_layers": ["global"]}, "attention_layers"),
    ("gptj", {"rotary_dim": None}, "rotary_dim"),
    ("gptj", {"rotary_dim": 5}, "rotary_dim"),
    ("gptj", {"rotary_dim": 16}, "rotary_dim"),
    ("xglm", {"add_cross_attention": True}, "add_cross_attention"),
    ("xglm", {"activation_function": "quick_gelu"}, "quick_gelu"),
])
def test_configs_flax_does_not_compute_raise_naming_them(family, change, name):
    with pytest.raises(NotImplementedError, match=name):
        encoders.check_config({**_BASE[family], **change})


@pytest.mark.parametrize("family", sorted(_BASE))
def test_flax_fails_where_the_port_refuses(family):
    """The refusals above stand for failures of Flax itself: BLOOM at 3
    heads (``jnp.cat``), GPT-J's ``rotary_dim: null`` with 4 heads (a
    broadcast), and a width that is no multiple of the heads (each
    family's ``_split_heads``)."""
    import transformers as T

    stem = {"gpt2": "GPT2", "gpt_neo": "GPTNeo", "gptj": "GPTJ", "bloom": "Bloom",
            "xglm": "XGLM"}[family]
    keys = {k: v for k, v in _BASE[family].items() if k != "model_type"}
    if family == "bloom":
        keys.update(n_head=3, hidden_size=24)
    elif family == "gptj":
        keys.update(rotary_dim=None)
    else:
        width = {"gpt2": "n_embd", "gpt_neo": "hidden_size", "xglm": "d_model"}[family]
        keys[width] = 30
    with pytest.raises(Exception):
        model = getattr(T, f"Flax{stem}Model")(getattr(T, f"{stem}Config")(**keys), seed=0)
        model(np.arange(4)[None])
    with pytest.raises(NotImplementedError):
        encoders.check_config({**_BASE[family], **{k: keys[k] for k in keys
                                                   if keys[k] != _BASE[family].get(k)}})


@pytest.mark.parametrize("model_type", sorted(_BASE))
def test_decoder_types_pass_with_their_defaults(model_type):
    """A ``config.json`` that names only the type takes ``transformers``'
    defaults (GPT-2's, GPT-Neo-1.3B's, GPT-J-6B's, BLOOM's 64-wide stub,
    XGLM-564M's widths and depths), and the aliases of ``attribute_map``
    (``hidden_size``, ``num_attention_heads``, ``num_hidden_layers``) set
    what they name."""
    config = {"model_type": model_type}
    encoders.check_config(config)
    assert model_type not in encoders.UNPORTED and model_type in encoders.DECODER_TYPES
    aliased = {"model_type": model_type, "hidden_size": 64, "num_attention_heads": 4,
               "num_hidden_layers": 2, "vocab_size": 10}
    if model_type == "gpt_neo":  # its default attention_types fix 24 layers
        aliased["attention_types"] = [[["global", "local"], 1]]
    if model_type == "gptj":  # its default rotary_dim 64 passes a 16-lane head
        aliased["rotary_dim"] = 8
    with torch.device("meta"):
        encs = [encoders.build_encoder(config), encoders.build_encoder(aliased)]
    widths = {"gpt2": 768, "gpt_neo": 2048, "gptj": 4096, "bloom": 64, "xglm": 1024}
    layers = {"gpt2": 12, "gpt_neo": 24, "gptj": 28, "bloom": 2, "xglm": 24}
    for enc, width, depth in zip(encs, (widths[model_type], 64), (layers[model_type], 2)):
        table = getattr(enc, encoders.BASE_TREE_KEY[model_type]).weight
        assert table.shape[1] == width
        assert len(enc.layers if model_type == "xglm" else enc.h) == depth
