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
- ``big_bird`` (full or block-sparse attention): :mod:`.big_bird`.

``FlaxAutoModel`` also loads ``roformer``, which is not ported (its
tokenizer needs ``rjieba``, so ``svs_tpu``'s provider fails before its
encoder runs): it raises ``NotImplementedError`` naming the type
(:data:`UNPORTED`), as does every other type and every ``hidden_act`` /
``activation``, ``position_embedding_type`` or BigBird
``attention_type`` the encoders do not compute.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from . import albert, bert, big_bird, distilbert

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
}
MODEL_TYPES = tuple(BASE_MODEL_PREFIX)
#: Encoder-only types that ``FlaxAutoModel`` loads and the port does not
#: run, with what they would need.
UNPORTED = {
    "roformer": "rotary position embeddings, and a tokenizer that needs rjieba",
}
#: The encoder class and config check of each type (the rest: :mod:`.bert`).
_ENCODERS = {
    "distilbert": (distilbert.DistilBertEncoder, distilbert.check_config),
    "albert": (albert.AlbertEncoder, albert.check_config),
    "big_bird": (big_bird.BigBirdEncoder, big_bird.check_config),
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
    copy takes seconds); every parameter must be in ``state_dict``.  (A
    buffer made from NumPy, DistilBERT's sinusoidal table, stays on the
    CPU under the meta device.)"""
    with torch.device("meta"):
        encoder = build_encoder(config)
    encoder.load_state_dict(state_dict, strict=True, assign=True)
    return encoder
