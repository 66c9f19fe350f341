"""A DistilBERT encoder (``model_type: "distilbert"``) in plain PyTorch:
the forward pass of ``transformers``' ``FlaxDistilBertModel`` up to
``last_hidden_state``.

It differs from :mod:`.bert`'s stack in its config keys (``dim``,
``n_layers``, ``n_heads``, ``hidden_dim``, ``activation``) and in:

- embeddings: word + position only (no token types), learned positions or,
  with ``sinusoidal_pos_embds``, the fixed sin/cos table that
  ``positional_encoding`` computes (in float64, then f32; not a parameter,
  so the checkpoint holds none);
- every LayerNorm's eps is 1e-12 whatever the config says;
- the attention mask is ``scores - 1e30 * (1 - mask)``, not an additive
  f32 minimum;
- a layer is attention -> ``sa_layer_norm(out + x)`` -> ``ffn.lin1`` ->
  activation -> ``ffn.lin2`` -> ``output_layer_norm(ffn + sa)``.

Parameter names are the Flax tree's (``transformer.layer.N.attention.
q_lin`` ...), which ``svs_tpu_torch.convert.encoder_state_dict_from_flax``
maps onto it.  Precision is the caller's, as for :mod:`.bert`.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .bert import Embedding, LayerNorm, Linear, activation

#: ``FlaxDistilBertModel`` fixes every LayerNorm's epsilon.
LAYER_NORM_EPS = 1e-12


def check_config(config: Dict[str, Any]) -> None:
    """Refuse what this encoder does not compute, naming it."""
    if config.get("model_type") != "distilbert":
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not distilbert")
    activation(config.get("activation", "gelu"))


def sinusoidal_positions(n: int, dim: int) -> torch.Tensor:
    """``[n, dim]`` f32: ``transformers``' ``positional_encoding``
    (angles in float64, sin on even columns, cos on odd ones)."""
    pos = np.arange(n)[:, np.newaxis]
    i = np.arange(dim)[np.newaxis, :]
    angles = pos * (1 / np.power(10000, (2 * (i // 2)) / np.float32(dim)))
    angles[:, 0::2] = np.sin(angles[:, 0::2])
    angles[:, 1::2] = np.cos(angles[:, 1::2])
    return torch.from_numpy(angles.astype(np.float32))


class _Embeddings(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        dim = c["dim"]
        self.word_embeddings = Embedding(c["vocab_size"], dim)
        self.sinusoidal = bool(c.get("sinusoidal_pos_embds", False))
        if self.sinusoidal:
            self.register_buffer(
                "pos_encoding", sinusoidal_positions(c["max_position_embeddings"], dim),
                persistent=False,
            )
        else:
            self.position_embeddings = Embedding(c["max_position_embeddings"], dim)
        self.LayerNorm = LayerNorm(dim, LAYER_NORM_EPS)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        n = ids.shape[1]
        if self.sinusoidal:
            pos = self.pos_encoding[:n][None]
        else:
            pos = self.position_embeddings(torch.arange(n, device=ids.device))[None]
        return self.LayerNorm(self.word_embeddings(ids) + pos)


class _Attention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        dim = c["dim"]
        self.heads = c["n_heads"]
        self.head_dim = dim // self.heads
        self.q_lin = Linear(dim, dim)
        self.k_lin = Linear(dim, dim)
        self.v_lin = Linear(dim, dim)
        self.out_lin = Linear(dim, dim)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, n, self.heads, self.head_dim).transpose(1, 2)

        q = heads(self.q_lin(x)) / math.sqrt(self.head_dim)
        k, v = heads(self.k_lin(x)), heads(self.v_lin(x))
        scores = q @ k.transpose(-1, -2) - 1e30 * (1.0 - keep)
        ctx = torch.softmax(scores, dim=-1).to(v.dtype) @ v
        return self.out_lin(ctx.transpose(1, 2).reshape(b, n, dim))


class _FFN(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.lin1 = Linear(c["dim"], c["hidden_dim"])
        self.lin2 = Linear(c["hidden_dim"], c["dim"])
        self.act = activation(c.get("activation", "gelu"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class _Block(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.attention = _Attention(c)
        self.sa_layer_norm = LayerNorm(c["dim"], LAYER_NORM_EPS)
        self.ffn = _FFN(c)
        self.output_layer_norm = LayerNorm(c["dim"], LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        sa = self.sa_layer_norm(self.attention(x, keep) + x)
        return self.output_layer_norm(self.ffn(sa) + sa)


class _Transformer(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.layer = nn.ModuleList(_Block(c) for _ in range(c["n_layers"]))


class DistilBertEncoder(nn.Module):
    """``FlaxDistilBertModel``'s ``last_hidden_state`` for a ``config.json``."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        self.config = dict(config)
        self.embeddings = _Embeddings(config)
        self.transformer = _Transformer(config)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, dim]``."""
        x = self.embeddings(input_ids)
        keep = attention_mask.to(torch.float32)[:, None, None, :]
        for block in self.transformer.layer:
            x = block(x, keep)
        return x
