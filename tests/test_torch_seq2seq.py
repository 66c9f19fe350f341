"""The port's encoder-decoders (``svs_tpu_torch.embeddings.seq2seq`` and
``bart``, ``pegasus``, ``blenderbot``) against ``svs_tpu``'s local
provider (``transformers`` + Flax) on the CPU.

Tiny checkpoints that ``transformers`` writes from a seed (``Flax*Model``:
32 wide, 2 + 2 layers) with seeded tokenizers saved by each type's fast
class (``BartTokenizerFast``, ``MBartTokenizerFast``,
``MBart50TokenizerFast``, ``PegasusTokenizerFast``,
``BlenderbotTokenizerFast``, ``BlenderbotSmallTokenizerFast`` with a pad
token), read from one directory by both packages:

- f32 embeddings within 1e-5 and bf16 within ``BF16_ATOL``, mean and CLS
  pooling, normalised or not;
- the decoder's hidden states against the Flax model's
  ``last_hidden_state`` on hand-made masks (right padding with the pad id,
  left padding, an all-pad row);
- each quirk: mBART's decoder start wrapped from the last non-pad token
  (``$A </s> en_XX`` starts the decoder at the language code,
  ``en_XX $A </s>`` at ``</s>``); BART's positions read at ``+ 2``;
  Pegasus's sinusoidal table (not XGLM's) and its start at the pad id;
  Blenderbot-small's decoder ``layernorm_embedding`` before the positions
  (and its slow tokenizer's files); a ``*ForConditionalGeneration`` tree unwrapping as ``FlaxAutoModel``
  unwraps it; a ``max_length`` past ``max_position_embeddings`` refused as
  Flax fails on it;
- the weights' conversion (``shared`` read once, Dense kernels as
  transposed views) and the refusals by name."""

import asyncio
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from svs_tpu.embeddings import make_local_embeddings_func as ref_local
from svs_tpu_torch.convert import encoder_state_dict_from_flax
from svs_tpu_torch.embeddings import checkpoint, encoders, seq2seq
from svs_tpu_torch.embeddings.local import make_local_embeddings_func
from svs_tpu_torch.embeddings.tokenizer_json import load_tokenizer

from torch_tokenizer_helpers import write_seq2seq_tokenizer

torch.set_num_threads(2)

#: As ``tests/test_torch_decoders.py``.
F32_ATOL = 1e-5
BF16_ATOL = {True: 1e-2, False: 5e-2}

TEXTS = ["the cat sat on the mat", "a dog ran fast", "héllo мир κόσμε 中文", "",
         "unknownword cat", "the " * 40, "x", "Red, BLUE! big-small"]
_TINY = dict(d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
             decoder_attention_heads=4, encoder_ffn_dim=48, decoder_ffn_dim=48,
             max_position_embeddings=64)
#: family -> (transformers class stem, config keys, tokenizer layout, tokenizer config)
FAMILIES = {
    "bart": ("Bart", _TINY, "bart", {}),
    "mbart": ("MBart", {**_TINY, "scale_embedding": True}, "mbart", {}),
    "mbart50": ("MBart", {**_TINY, "scale_embedding": True}, "mbart50", {"src_lang": "de_DE"}),
    "pegasus": ("Pegasus", {**_TINY, "activation_function": "relu", "scale_embedding": True},
                "pegasus", {}),
    "blenderbot": ("Blenderbot", {**_TINY, "scale_embedding": True}, "blenderbot", {}),
    "blenderbot-small": ("BlenderbotSmall", _TINY, "blenderbot-small",
                         {"pad_token": "__null__"}),
}
_STEMS = {"bart": "Bart", "mbart": "MBart", "pegasus": "Pegasus", "blenderbot": "Blenderbot",
          "blenderbot-small": "BlenderbotSmall"}


def _config(family, vocab_size, **extra):
    import transformers as T

    stem, keys, _, _ = FAMILIES[family]
    return getattr(T, f"{stem}Config")(vocab_size=vocab_size, **{**keys, **extra})


def _model_class(family, suffix="Model"):
    import transformers as T

    return getattr(T, f"Flax{FAMILIES[family][0]}{suffix}")


@pytest.fixture(scope="session")
def checkpoints(tmp_path_factory):
    """A tiny Flax checkpoint and tokenizer of each family, written by
    ``transformers`` from a seed."""
    import transformers

    transformers.logging.set_verbosity_error()
    out = {}
    for i, (family, (_, _, layout, tok_config)) in enumerate(FAMILIES.items()):
        path = tmp_path_factory.mktemp(family)
        vocab_size = write_seq2seq_tokenizer(path, layout, seed=i, **tok_config)
        _model_class(family)(_config(family, vocab_size), seed=11 + i).save_pretrained(str(path))
        out[family] = path
    return out


def _embed(factory, path, texts, max_length=16, **kw):
    fn = factory(str(path), max_length=max_length, **kw)
    return np.asarray(asyncio.run(fn(list(texts))), np.float32)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_embeddings_match_svs_tpu(checkpoints, family, pooling):
    for normalize in (True, False):
        kw = dict(pooling=pooling, normalize=normalize, compute_dtype="float32")
        want = _embed(ref_local, checkpoints[family], TEXTS, **kw)
        got = _embed(make_local_embeddings_func, checkpoints[family], TEXTS, device="cpu", **kw)
        assert got.shape == want.shape == (len(TEXTS), 32)
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_embeddings_match_svs_tpu(checkpoints, family, normalize):
    want = _embed(ref_local, checkpoints[family], TEXTS, normalize=normalize, pooling="mean")
    got = _embed(make_local_embeddings_func, checkpoints[family], TEXTS, device="cpu",
                 normalize=normalize, pooling="mean")
    np.testing.assert_allclose(got, want, atol=BF16_ATOL[normalize], rtol=0)


def _port_encoder(path):
    config, params = checkpoint.load_checkpoint(path)
    return encoders.load_encoder(config, encoder_state_dict_from_flax(config, params)).eval()


def _hidden(enc, ids, mask, bf16=False):
    with torch.inference_mode(), torch.autocast("cpu", dtype=torch.bfloat16, enabled=bf16):
        return enc(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()


def _flax_hidden(path, family, ids, mask):
    model = _model_class(family).from_pretrained(str(path))
    return np.asarray(model(ids, attention_mask=mask).last_hidden_state)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hidden_states_match_flax_under_padding(checkpoints, family):
    """Every position of the decoder's last hidden state: a full row, a
    row padded on the right with the pad id after its first 7 tokens (the
    decoder still sees those pads, causally, and mBART's start token is
    the 7th), one padded on the left (random ids under the mask), and an
    all-pad row (every key of the encoder masked: a uniform softmax, as
    Flax's dtype-minimum bias gives, with no NaN)."""
    path = checkpoints[family]
    pad = json.loads((path / "config.json").read_text())["pad_token_id"]
    vocab = json.loads((path / "config.json").read_text())["vocab_size"]
    rng = np.random.default_rng(3)
    ids = rng.integers(3, vocab, (4, 12))
    mask = np.ones((4, 12), np.int64)
    ids[1, 7:], mask[1, 7:] = pad, 0
    mask[2, :5] = 0
    ids[3], mask[3] = pad, 0
    got = _hidden(_port_encoder(path), ids, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _flax_hidden(path, family, ids, mask), atol=F32_ATOL, rtol=0)


def test_mbart_shift_wraps_the_last_non_pad_token(checkpoints):
    """``shift_right_wrapped`` is Flax mBART's ``shift_tokens_right``:
    the token at (count of non-pad tokens - 1) first, the rest one place
    right; an inner pad shortens the count, an all-pad row wraps its last
    token.  Through the two mBART tokenizer layouts, a text's decoder
    starts at ``$A </s> en_XX``'s language code and at mBART-50's
    ``de_DE $A </s>``'s ``</s>``."""
    from transformers.models.mbart.modeling_flax_mbart import shift_tokens_right

    rng = np.random.default_rng(0)
    ids = rng.integers(3, 90, (5, 9))
    ids[0, 6:] = 1
    ids[1, 3] = 1
    ids[2, :] = 1
    ids[3, 4:] = 1
    ids[3, 1] = 1
    want = np.asarray(shift_tokens_right(ids, 1))
    got = seq2seq.shift_right_wrapped(torch.from_numpy(ids), 1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(seq2seq.shift_right_wrapped(torch.from_numpy(ids[:1]), 1).numpy(),
                                  np.asarray(shift_tokens_right(ids[:1], 1)))
    for family, first in (("mbart", "en_XX"), ("mbart50", "</s>")):
        tok = load_tokenizer(checkpoints[family], "mbart")
        text_ids, mask = tok.batch(["the cat sat", "a dog"], 16)
        lang = tok.token_to_id("de_DE" if family == "mbart50" else "en_XX")
        starts = seq2seq.shift_right_wrapped(torch.from_numpy(text_ids), tok.pad_id)[:, 0]
        want_first = lang if first == "en_XX" else tok.token_to_id("</s>")
        assert starts.tolist() == [want_first, want_first]
        ends = text_ids[np.arange(2), mask.sum(1) - 1]
        assert ends.tolist() == [want_first] * 2
        if family == "mbart50":
            assert text_ids[:, 0].tolist() == [lang] * 2


def _with_layout(enc, **change):
    """``enc`` with both stacks' :class:`seq2seq.Layout` changed (the same
    weights)."""
    for stack in (enc.encoder, enc.decoder):
        stack.layout = dataclasses.replace(stack.layout, **change)
    return enc


def test_bart_positions_are_read_at_offset_two(checkpoints):
    """BART's learned tables hold ``max_position_embeddings + 2`` rows, the
    row of position ``p`` at ``p + 2`` (the first two never read): the port
    agrees with Flax, and reading from row 0 moves the result."""
    path = checkpoints["bart"]
    enc = _port_encoder(path)
    assert enc.encoder.embed_positions.weight.shape == (64 + 2, 32)
    assert enc.layout.offset == 2
    ids = np.arange(5, 17)[None]
    mask = np.ones_like(ids)
    right = _hidden(enc, ids, mask)
    np.testing.assert_allclose(right, _flax_hidden(path, "bart", ids, mask), atol=F32_ATOL, rtol=0)
    wrong = _hidden(_with_layout(enc, offset=0), ids, mask)
    assert np.abs(wrong - right).max() > 1e-3


@pytest.mark.parametrize("width", [32, 33])
def test_pegasus_sinusoidal_table_and_pad_start(checkpoints, width):
    """Pegasus's table is Marian's ``create_sinusoidal_positions`` to the
    bit (the sines of the even columns, then the cosines of the odd ones;
    an odd width too), not XGLM's ``[sin | cos]`` of another frequency; it
    is no parameter of the checkpoint; the decoder starts from the pad id
    0."""
    from transformers.models.pegasus.modeling_flax_pegasus import create_sinusoidal_positions

    from svs_tpu_torch.embeddings import xglm

    table = seq2seq.sinusoidal_positions(64, width).numpy()
    np.testing.assert_array_equal(table, np.asarray(create_sinusoidal_positions(64, width)))
    if width % 2 == 0:
        assert np.abs(table - xglm.sinusoidal_positions(64, width).numpy()).max() > 0.1
    enc = _port_encoder(checkpoints["pegasus"])
    assert not any("embed_positions" in k for k in enc.state_dict())
    ids = torch.tensor([[5, 6, 7, 1, 0]])
    assert enc.c["pad_token_id"] == enc.c["decoder_start_token_id"] == 0
    assert enc.decoder_inputs(ids).tolist() == [[0, 5, 6, 7, 1]]


def test_blenderbot_small_decoder_norms_before_positions(checkpoints):
    """Blenderbot-small's encoder applies ``layernorm_embedding`` to the
    embeddings plus positions, its decoder to the token embeddings before
    the positions: the port agrees with Flax, and the decoder's norm moved
    after the positions moves the result."""
    path = checkpoints["blenderbot-small"]
    enc = _port_encoder(path)
    ids = np.arange(5, 17)[None]
    mask = np.ones_like(ids)
    right = _hidden(enc, ids, mask)
    np.testing.assert_allclose(right, _flax_hidden(path, "blenderbot-small", ids, mask),
                               atol=F32_ATOL, rtol=0)
    wrong = _hidden(_with_layout(enc, embedding_norm="after_positions"), ids, mask)
    assert np.abs(wrong - right).max() > 1e-3


_HEADS = {"bart-untied": {"tie_word_embeddings": False}, "mbart": {}, "pegasus": {},
          "blenderbot-small": {}}


@pytest.mark.parametrize("head", sorted(_HEADS))
def test_conditional_generation_tree_unwraps_as_flax_auto_model(checkpoints, head, tmp_path):
    """A ``*ForConditionalGeneration`` checkpoint holds the base model under
    ``model`` beside ``final_logits_bias`` (and an ``lm_head`` where the
    embeddings are untied): the port reads the base model
    ``FlaxAutoModel`` reads, and both embed alike."""
    family = head.removesuffix("-untied")
    path = tmp_path / "head"
    shutil.copytree(checkpoints[family], path)
    (path / "flax_model.msgpack").unlink()
    vocab = json.loads((path / "config.json").read_text())["vocab_size"]
    model = _model_class(family, "ForConditionalGeneration")(
        _config(family, vocab, **_HEADS[head]), seed=5)
    model.save_pretrained(str(path))
    raw = checkpoint.unpackb(checkpoint._read_file(path / checkpoint.FLAX_WEIGHTS))
    assert "model" in raw and "final_logits_bias" in raw
    assert ("lm_head" in raw) == (head == "bart-untied")
    _, params = checkpoint.load_checkpoint(path)
    assert set(params) == {"shared", "encoder", "decoder"}
    kw = dict(compute_dtype="float32", pooling="mean")
    np.testing.assert_allclose(_embed(make_local_embeddings_func, path, TEXTS, device="cpu", **kw),
                               _embed(ref_local, path, TEXTS, **kw), atol=F32_ATOL, rtol=0)


def test_blenderbot_small_with_its_slow_tokenizer_files(checkpoints, tmp_path):
    """``facebook/blenderbot_small-90M``'s tokenizer files (``vocab.json`` +
    ``merges.txt`` of ``@@`` pieces, no class named: ``AutoTokenizer``'s
    slow ``BlenderbotSmallTokenizer``) beside the checkpoint: both packages
    embed alike."""
    from torch_tokenizer_helpers import write_blenderbot_small_slow

    path = tmp_path / "slow"
    path.mkdir()
    size = write_blenderbot_small_slow(path, seed=4)
    _model_class("blenderbot-small")(_config("blenderbot-small", size), seed=9).save_pretrained(str(path))
    kw = dict(compute_dtype="float32", pooling="mean")
    np.testing.assert_allclose(_embed(make_local_embeddings_func, path, TEXTS, device="cpu", **kw),
                               _embed(ref_local, path, TEXTS, **kw), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("family", ["bart", "blenderbot"])
def test_length_past_max_position_embeddings_is_refused_as_flax_fails(checkpoints, family):
    """At ``max_length`` 64, the tables' length, both embed alike; at 65
    (``padding="max_length"``: every row that long) Flax's decoder fails
    (its causal mask has ``max_position_embeddings`` rows) and the port
    refuses, naming the limit, before any product."""
    path = checkpoints[family]
    kw = dict(compute_dtype="float32", pooling="mean")
    np.testing.assert_allclose(
        _embed(make_local_embeddings_func, path, TEXTS[:3], max_length=64, device="cpu", **kw),
        _embed(ref_local, path, TEXTS[:3], max_length=64, **kw), atol=F32_ATOL, rtol=0)
    with pytest.raises(Exception):
        _embed(ref_local, path, ["a cat"], max_length=65, **kw)
    with pytest.raises(ValueError, match="max_position_embeddings 64"):
        _embed(make_local_embeddings_func, path, ["a cat"], max_length=65, device="cpu", **kw)


def test_state_dict_reads_shared_once_and_transposes_without_copy(checkpoints):
    """``shared`` is one tensor that both stacks look up; Dense kernels are
    transposed views of the checkpoint's arrays (no copy); LayerNorm
    ``scale`` and Embed ``embedding`` become ``weight``."""
    config, params = checkpoint.load_checkpoint(checkpoints["mbart"])
    sd = encoder_state_dict_from_flax(config, params)
    assert [k for k in sd if "shared" in k] == ["shared.weight"]
    kernel = params["decoder"]["layers"]["1"]["encoder_attn"]["k_proj"]["kernel"]
    w = sd["decoder.layers.1.encoder_attn.k_proj.weight"]
    np.testing.assert_array_equal(w.numpy(), kernel.T)
    assert w.data_ptr() == kernel.ctypes.data and not w.is_contiguous()
    assert sd["encoder.layer_norm.weight"].data_ptr() == params["encoder"]["layer_norm"]["scale"].ctypes.data
    assert sd["decoder.embed_positions.weight"].shape == (66, 32)
    enc = encoders.load_encoder(config, sd)
    assert enc.shared.weight.data_ptr() == params["shared"]["embedding"].ctypes.data


_BASE = {"vocab_size": 10, "d_model": 32, "encoder_layers": 1, "decoder_layers": 1,
         "encoder_attention_heads": 4, "decoder_attention_heads": 4, "encoder_ffn_dim": 48,
         "decoder_ffn_dim": 48, "max_position_embeddings": 16}


@pytest.mark.parametrize("model_type,change,name", [
    ("bart", {"decoder_attention_heads": 5}, "multiple of the head count"),
    ("mbart", {"encoder_attention_heads": 3}, "multiple of the head count"),
    ("pegasus", {"activation_function": "gelu_fast"}, "gelu_fast"),
    ("blenderbot", {"decoder_start_token_id": None}, "decoder_start_token_id"),
    ("blenderbot-small", {"pad_token_id": None}, "pad_token_id"),
    ("mbart", {"pad_token_id": None}, "pad_token_id"),
])
def test_configs_flax_does_not_compute_raise_naming_them(model_type, change, name):
    with pytest.raises(NotImplementedError, match=name):
        encoders.check_config({"model_type": model_type, **_BASE, **change})


@pytest.mark.parametrize("model_type,change", [
    ("bart", {"decoder_attention_heads": 5}),
    ("blenderbot", {"decoder_start_token_id": None}),
    ("mbart", {"pad_token_id": None}),
])
def test_flax_fails_where_the_port_refuses(model_type, change):
    """The refusals above stand for failures of Flax itself: a width that
    is no multiple of the heads (``FlaxBartAttention.setup``), and a null
    start or pad id in the shift of the decoder's inputs."""
    import transformers as T

    stem = _STEMS[model_type]
    with pytest.raises(Exception):
        cfg = getattr(T, f"{stem}Config")(**{**_BASE, **change})
        getattr(T, f"Flax{stem}Model")(cfg, seed=0)(np.arange(1, 5)[None])
    with pytest.raises(NotImplementedError):
        encoders.check_config({"model_type": model_type, **_BASE, **change})


_DEFAULT_WIDTHS = {"bart": (1024, 12, 12, 50265), "mbart": (1024, 12, 12, 50265),
                   "pegasus": (1024, 12, 12, 50265), "blenderbot": (2560, 2, 24, 8008),
                   "blenderbot-small": (512, 8, 8, 50265)}


@pytest.mark.parametrize("model_type", sorted(_DEFAULT_WIDTHS))
def test_seq2seq_types_pass_with_their_defaults(model_type):
    """A ``config.json`` that names only the type takes ``transformers``'
    defaults (Blenderbot's: facebook/blenderbot-3B's widths and depth), and
    ``attribute_map``'s aliases (``hidden_size``, ``num_attention_heads``:
    the encoder's heads) set what they name."""
    import transformers as T

    config = {"model_type": model_type}
    encoders.check_config(config)
    assert model_type in encoders.SEQ2SEQ_TYPES and model_type not in encoders.UNPORTED
    d, enc_layers, dec_layers, vocab = _DEFAULT_WIDTHS[model_type]
    ref = getattr(T, f"{_STEMS[model_type]}Config")()
    assert (ref.d_model, ref.encoder_layers, ref.decoder_layers, ref.vocab_size) == _DEFAULT_WIDTHS[model_type]
    aliased = {"model_type": model_type, "hidden_size": 64, "num_attention_heads": 2,
               "decoder_attention_heads": 4}
    with torch.device("meta"):
        built = encoders.build_encoder(config)
        small = encoders.build_encoder(aliased)
    assert built.shared.weight.shape == (vocab, d)
    assert (len(built.encoder.layers), len(built.decoder.layers)) == (enc_layers, dec_layers)
    assert small.shared.weight.shape[1] == 64
    assert small.encoder.layers[0].self_attn.heads == 2
    assert small.decoder.layers[0].self_attn.heads == 4


@pytest.mark.parametrize("model_type", ["roformer", "opt", "t5", "mt5", "longt5", "marian"])
def test_types_still_unported_are_refused_by_name(model_type):
    with pytest.raises(NotImplementedError, match=model_type):
        encoders.check_config({"model_type": model_type})
