"""An ALBERT encoder (``model_type: "albert"``) in plain PyTorch: the
forward pass of ``transformers``' ``FlaxAlbertModel`` up to
``last_hidden_state`` (``modeling_flax_albert.py:327``, ``:397-420``).

It differs from :mod:`.bert`'s stack in:

- factorised embeddings: word, position (0, 1, ...) and token type (all
  0) tables of width ``embedding_size`` and LayerNorm at that width, then
  ``encoder.embedding_hidden_mapping_in`` projects to ``hidden_size``;
- shared layers: ``num_hidden_groups`` groups of ``inner_group_num``
  layers each hold all the weights, and layer ``i`` of
  ``num_hidden_layers`` runs group ``int(i / (num_hidden_layers /
  num_hidden_groups))``, so one group's weights serve several depths;
- a layer is attention (``query`` / ``key`` / ``value``, BERT's product
  and mask, then ``dense``, the residual and ``LayerNorm``, all at the
  attention's level), then ``ffn`` with ``hidden_act`` (``gelu_new`` in
  every published ALBERT), ``ffn_output``, the residual and
  ``full_layer_layer_norm``.

Parameter names are the Flax tree's
(``encoder.albert_layer_groups.G.albert_layers.I.attention.query`` ...),
which ``svs_tpu_torch.convert.encoder_state_dict_from_flax`` maps onto it.
Precision is the caller's, as for :mod:`.bert`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from .bert import Embedding, LayerNorm, Linear, _SelfAttention, activation, attention_bias


def check_config(config: Dict[str, Any]) -> None:
    """Refuse what this encoder does not compute, naming it."""
    if config.get("model_type") != "albert":
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not albert")
    activation(config.get("hidden_act", "gelu_new"))
    pos = config.get("position_embedding_type", "absolute")
    if pos != "absolute":
        raise NotImplementedError(f"position_embedding_type {pos!r} is not ported")


def _eps(c: Dict[str, Any]) -> float:
    return c.get("layer_norm_eps", 1e-12)


class _Embeddings(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        e = c.get("embedding_size", 128)
        self.word_embeddings = Embedding(c["vocab_size"], e)
        self.position_embeddings = Embedding(c["max_position_embeddings"], e)
        self.token_type_embeddings = Embedding(c.get("type_vocab_size", 2), e)
        self.LayerNorm = LayerNorm(e, _eps(c))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = (
            self.word_embeddings(ids)
            + self.token_type_embeddings(torch.zeros_like(ids))
            + self.position_embeddings(pos)
        )
        return self.LayerNorm(x)


class _Attention(_SelfAttention):
    """``FlaxAlbertSelfAttention``: BERT's attention with the output
    projection and its LayerNorm on the same module."""

    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__(c)
        self.dense = Linear(c["hidden_size"], c["hidden_size"])
        self.LayerNorm = LayerNorm(c["hidden_size"], _eps(c))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(super().forward(x, bias)) + x)


class _Layer(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.attention = _Attention(c)
        self.ffn = Linear(c["hidden_size"], c["intermediate_size"])
        self.act = activation(c.get("hidden_act", "gelu_new"))
        self.ffn_output = Linear(c["intermediate_size"], c["hidden_size"])
        self.full_layer_layer_norm = LayerNorm(c["hidden_size"], _eps(c))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        a = self.attention(x, bias)
        return self.full_layer_layer_norm(self.ffn_output(self.act(self.ffn(a))) + a)


class _Group(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.albert_layers = nn.ModuleList(_Layer(c) for _ in range(c.get("inner_group_num", 1)))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        for layer in self.albert_layers:
            x = layer(x, bias)
        return x


class _Encoder(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.embedding_hidden_mapping_in = Linear(c.get("embedding_size", 128), c["hidden_size"])
        self.albert_layer_groups = nn.ModuleList(
            _Group(c) for _ in range(c.get("num_hidden_groups", 1))
        )


class AlbertEncoder(nn.Module):
    """``FlaxAlbertModel``'s ``last_hidden_state`` for a ``config.json``."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        self.config = dict(config)
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        # the group each layer runs, as FlaxAlbertLayerGroups picks it (in floats)
        layers, groups = config["num_hidden_layers"], config.get("num_hidden_groups", 1)
        self.order = [int(i / (layers / groups)) for i in range(layers)]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, hidden]``."""
        x = self.encoder.embedding_hidden_mapping_in(self.embeddings(input_ids))
        bias = attention_bias(attention_mask)
        for g in self.order:
            x = self.encoder.albert_layer_groups[g](x, bias)
        return x
