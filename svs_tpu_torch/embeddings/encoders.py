"""Which encoder runs a checkpoint: :func:`check_config` refuses, by name,
what the port does not compute, and :func:`build_encoder` builds the one
that does, by the ``model_type`` of ``config.json``.

Ported (``FlaxAutoModel``'s encoder-only types that ``svs_tpu``'s local
provider runs with ``input_ids`` and ``attention_mask`` alone):

- ``bert``, ``roberta``, ``xlm-roberta``, ``electra`` and
  ``roberta-prelayernorm`` (pre-LN layers and a final LayerNorm):
  :mod:`.bert`;
- ``distilbert``: :mod:`.distilbert`;
- ``albert`` (factorised embeddings, layer groups shared across the
  depth): :mod:`.albert`;
- ``big_bird`` (full or block-sparse attention): :mod:`.big_bird`;

and the decoder-only types whose last hidden state it pools:

- ``llama``, ``mistral`` (its sliding window as Flax computes it) and
  ``gemma``: :mod:`.llama`;
- ``gpt2``: :mod:`.gpt2`; ``gpt_neo`` (local-attention layers):
  :mod:`.gpt_neo`; ``gptj`` (partial rotary positions, the parallel
  block): :mod:`.gptj`; ``bloom`` (ALiBi): :mod:`.bloom`; ``xglm``
  (sinusoidal positions): :mod:`.xglm`;

and the encoder-decoder types, whose decoder's last hidden state it pools
(the decoder's inputs are the ids shifted right, its cross-attention over
the encoder's states under the encoder's mask: :mod:`.seq2seq`):

- ``bart`` (post-LN, positions at ``+ 2``) and ``mbart`` (pre-LN, the
  language code wrapped to the decoder's first place): :mod:`.bart`;
- ``pegasus`` (Marian's sinusoidal positions): :mod:`.pegasus`;
- ``blenderbot`` (pre-LN) and ``blenderbot-small`` (post-LN, the
  decoder's ``layernorm_embedding`` before the positions):
  :mod:`.blenderbot`.

``FlaxAutoModel`` also loads ``roformer``, ``opt``, the T5 types and
``marian``, which are not ported: each raises
``NotImplementedError`` naming the type and what it would need
(:data:`UNPORTED`), as does every other type and every ``hidden_act`` /
``activation``, ``position_embedding_type``, BigBird ``attention_type``,
decoder width, head count or rotary width that the encoders do not
compute or on which Flax fails.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from . import (albert, bart, bert, big_bird, blenderbot, bloom, distilbert, gpt2, gpt_neo, gptj,
               llama, pegasus, xglm)

#: ``model_type`` -> the key under which a head model's Flax checkpoint
#: holds the base model (``transformers``' ``base_model_prefix``).
BASE_MODEL_PREFIX = {
    "bert": "bert",
    "roberta": "roberta",
    "xlm-roberta": "xlm-roberta",
    "electra": "electra",
    "distilbert": "distilbert",
    "albert": "albert",
    "roberta-prelayernorm": "roberta_prelayernorm",
    "big_bird": "bert",
    "llama": "model",
    "mistral": "model",
    "gemma": "model",
    "gpt2": "transformer",
    "gpt_neo": "transformer",
    "gptj": "transformer",
    "bloom": "transformer",
    "xglm": "model",
    **{t: "model" for t in bart.MODEL_TYPES + pegasus.MODEL_TYPES + blenderbot.MODEL_TYPES},
}
MODEL_TYPES = tuple(BASE_MODEL_PREFIX)
#: The decoder-only types (no pooler, no token types).
DECODER_TYPES = (llama.MODEL_TYPES + gpt2.MODEL_TYPES + gpt_neo.MODEL_TYPES + gptj.MODEL_TYPES
                 + bloom.MODEL_TYPES + xglm.MODEL_TYPES)
#: The encoder-decoder types (the decoder's states pooled under the
#: encoder's mask; no pooler, no token types).
SEQ2SEQ_TYPES = bart.MODEL_TYPES + pegasus.MODEL_TYPES + blenderbot.MODEL_TYPES
#: The key that a base model's tree holds at its top and a head model's
#: does not (``embeddings`` for the encoders): how
#: :func:`.checkpoint.unwrap_head` tells the two apart.
BASE_TREE_KEY = {
    **{t: "embed_tokens" for t in llama.MODEL_TYPES + xglm.MODEL_TYPES},
    **{t: "wte" for t in gpt2.MODEL_TYPES + gpt_neo.MODEL_TYPES + gptj.MODEL_TYPES},
    "bloom": "word_embeddings",
    **{t: "shared" for t in SEQ2SEQ_TYPES},
}
#: Types that ``FlaxAutoModel`` loads and the port does not run, with what
#: they would need.
UNPORTED = {
    "roformer": "rotary position embeddings, and a tokenizer that needs rjieba",
    "opt": "svs_tpu's provider fails on it too: FlaxOPTModel takes no train argument",
    "t5": "svs_tpu's provider fails on it too: the model needs decoder_input_ids",
    "mt5": "svs_tpu's provider fails on it too: the model needs decoder_input_ids",
    "longt5": "svs_tpu's provider fails on it too: the model needs decoder_input_ids",
    "marian": "its tokenizer is a SentencePiece model alone",
}
#: The encoder class and config check of each type (the rest: :mod:`.bert`).
_ENCODERS = {
    "distilbert": (distilbert.DistilBertEncoder, distilbert.check_config),
    "albert": (albert.AlbertEncoder, albert.check_config),
    "big_bird": (big_bird.BigBirdEncoder, big_bird.check_config),
    **{t: (llama.LlamaEncoder, llama.check_config) for t in llama.MODEL_TYPES},
    "gpt2": (gpt2.GPT2Encoder, gpt2.check_config),
    "gpt_neo": (gpt_neo.GPTNeoEncoder, gpt_neo.check_config),
    "gptj": (gptj.GPTJEncoder, gptj.check_config),
    "bloom": (bloom.BloomEncoder, bloom.check_config),
    "xglm": (xglm.XGLMEncoder, xglm.check_config),
    **{t: (bart.BartEncoder, bart.check_config) for t in bart.MODEL_TYPES},
    "pegasus": (pegasus.PegasusEncoder, pegasus.check_config),
    **{t: (blenderbot.BlenderbotEncoder, blenderbot.check_config) for t in blenderbot.MODEL_TYPES},
}


def _entry(model_type: Any) -> tuple:
    return _ENCODERS.get(model_type, (bert.BertEncoder, bert.check_config))


def check_config(config: Dict[str, Any]) -> None:
    """Raise ``NotImplementedError`` naming what of ``config`` is not
    ported; return quietly when :func:`build_encoder` can run it."""
    model_type = config.get("model_type")
    if model_type in UNPORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported ({UNPORTED[model_type]}): "
            f"svs_tpu_torch's local provider runs {MODEL_TYPES}"
        )
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported: svs_tpu_torch's local "
            f"provider runs {MODEL_TYPES}"
        )
    _entry(model_type)[1](config)


def build_encoder(config: Dict[str, Any]) -> nn.Module:
    """The port's encoder for ``config`` (f32 parameters, uninitialised
    until a state dict is loaded)."""
    check_config(config)
    return _entry(config["model_type"])[0](config)


def load_encoder(config: Dict[str, Any], state_dict: Dict[str, torch.Tensor]) -> nn.Module:
    """:func:`build_encoder` holding ``state_dict``'s tensors (CPU, f32).
    The module is built on the meta device and takes the tensors as its
    parameters (no allocation, no copy: at ``bge-m3``'s 568M parameters a
    copy takes seconds, at ``e5-mistral-7b-instruct``'s 7.11B tens of
    seconds and 28 GB); every parameter must be in ``state_dict``, which
    may hold views (a decoder's transposed Dense kernels).  (A buffer made
    from NumPy, DistilBERT's sinusoidal table, stays on the CPU under the
    meta device.)"""
    with torch.device("meta"):
        encoder = build_encoder(config)
    encoder.load_state_dict(state_dict, strict=True, assign=True)
    return encoder
