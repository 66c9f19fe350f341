"""Which encoder runs a checkpoint: :func:`check_config` refuses, by name,
what the port does not compute, and :func:`build_encoder` builds the one
that does, by the ``model_type`` of ``config.json``.

Ported (``FlaxAutoModel``'s encoder-only types that ``svs_tpu``'s local
provider runs with ``input_ids`` and ``attention_mask`` alone):

- ``bert``, ``roberta``, ``xlm-roberta``, ``electra``: :mod:`.bert`;
- ``distilbert``: :mod:`.distilbert`.

``FlaxAutoModel`` also loads ``albert``, ``roformer``, ``big_bird`` and
``roberta-prelayernorm``; they are not ported and raise
``NotImplementedError`` naming the type (:data:`UNPORTED`), as does every
other type and every ``hidden_act`` / ``activation`` or
``position_embedding_type`` the encoders do not compute.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from . import bert, distilbert

#: ``model_type`` -> the key under which a head model's Flax checkpoint
#: holds the base model (``transformers``' ``base_model_prefix``).
BASE_MODEL_PREFIX = {
    "bert": "bert",
    "roberta": "roberta",
    "xlm-roberta": "xlm-roberta",
    "electra": "electra",
    "distilbert": "distilbert",
}
MODEL_TYPES = tuple(BASE_MODEL_PREFIX)
#: Encoder-only types that ``FlaxAutoModel`` loads and the port does not
#: run, with what they would need.
UNPORTED = {
    "albert": "factorised embeddings and one layer shared across the depth",
    "roformer": "rotary position embeddings",
    "big_bird": "block-sparse attention",
    "roberta-prelayernorm": "pre-LayerNorm layers",
}


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
    if model_type == "distilbert":
        distilbert.check_config(config)
    else:
        bert.check_config(config)


def build_encoder(config: Dict[str, Any]) -> nn.Module:
    """The port's encoder for ``config`` (f32 parameters, uninitialised
    until a state dict is loaded)."""
    check_config(config)
    if config["model_type"] == "distilbert":
        return distilbert.DistilBertEncoder(config)
    return bert.BertEncoder(config)


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
