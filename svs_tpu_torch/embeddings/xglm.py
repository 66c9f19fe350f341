"""The XGLM decoder in plain PyTorch: the forward pass of ``transformers``'
``FlaxXGLMModel`` that ``svs_tpu``'s local provider runs, up to
``last_hidden_state``.

``embed_tokens`` (times ``sqrt(d_model)`` with ``scale_embedding``) plus
sinusoidal positions, then each layer: ``self_attn_layer_norm``, causal
self-attention (``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``, with
biases), the residual; ``final_layer_norm``, ``fc2(act(fc1(x)))``, the
residual; and a final ``layer_norm``.  What Flax computes, kept as it is:

- the positions are ``arange(L) + 2`` whatever the padding (XGLM's
  tokenizer pads on the right, so a right-padded text's tokens sit at
  ``2 ..``; a left-padded one's would not);
- the table is ``create_sinusoidal_positions``: ``[sin | cos]`` halves at
  frequencies ``exp(-i log(10000) / (d_model/2 - 1))``, in float64, then
  f32, row ``padding_idx`` = 1 zeroed (no position reaches it);
- every LayerNorm's epsilon is 1e-5, whatever the config says.

Parameter names are those of the Flax tree; its Dense kernels are
transposed on the way in (``svs_tpu_torch.convert``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .bert import Embedding, LayerNorm, Linear, activation
from .gpt2 import attend, causal_allowed, check_length, check_widths, config_of

MODEL_TYPES = ("xglm",)
#: ``XGLMConfig``'s defaults for the keys read here (facebook/xglm-564M's
#: widths).
DEFAULTS: Dict[str, Any] = {
    "vocab_size": 256008, "max_position_embeddings": 2048, "d_model": 1024, "ffn_dim": 4096,
    "num_layers": 24, "attention_heads": 16, "activation_function": "gelu",
    "scale_embedding": True, "add_cross_attention": False,
}
ALIASES = {"num_attention_heads": "attention_heads", "hidden_size": "d_model",
           "num_hidden_layers": "num_layers"}
#: ``nn.LayerNorm(epsilon=1e-05)`` in every Flax XGLM layer norm.
EPS = 1e-5
#: ``create_sinusoidal_positions``' default, and Flax's position offset.
PADDING_IDX = 1
OFFSET = 2


def _cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    return config_of(config, DEFAULTS, ALIASES)


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    if config.get("model_type") not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not xglm")
    c = _cfg(config)
    d = int(c["d_model"])
    check_widths("xglm", d, int(c["attention_heads"]))
    activation(c["activation_function"])
    if d % 2 or d < 4:
        raise NotImplementedError(
            f"d_model {d}: Flax's sinusoidal table needs an even width of at least 4"
        )
    if c.get("add_cross_attention"):
        raise NotImplementedError(
            "add_cross_attention: an XGLM with cross-attention layers is not ported"
        )


def sinusoidal_positions(positions: int, width: int) -> torch.Tensor:
    """Rows ``0 .. positions-1`` of Flax's ``create_sinusoidal_positions``
    (``[sin | cos]``, row :data:`PADDING_IDX` zeroed), f32."""
    half = width // 2
    freq = np.exp(np.arange(half) * -(math.log(10000) / (half - 1)))
    angles = np.arange(positions)[:, None] * freq[None]
    table = np.concatenate([np.sin(angles), np.cos(angles)], 1).reshape(positions, width)
    if positions > PADDING_IDX:
        table[PADDING_IDX, :] = 0
    return torch.from_numpy(table.astype(np.float32))


class _Attention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        d, self.heads = int(c["d_model"]), int(c["attention_heads"])
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)

    def forward(self, x: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        shape = (b, n, self.heads, d // self.heads)
        q, k, v = self.q_proj(x).view(shape), self.k_proj(x).view(shape), self.v_proj(x).view(shape)
        return self.out_proj(attend(q, k, v, allowed))


class _Layer(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        d = int(c["d_model"])
        self.self_attn_layer_norm = LayerNorm(d, EPS)
        self.self_attn = _Attention(c)
        self.final_layer_norm = LayerNorm(d, EPS)
        self.fc1 = Linear(d, int(c["ffn_dim"]))
        self.fc2 = Linear(int(c["ffn_dim"]), d)
        self.act = activation(c["activation_function"])

    def forward(self, x: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), allowed)
        return x + self.fc2(self.act(self.fc1(self.final_layer_norm(x))))


class XGLMEncoder(nn.Module):
    """``last_hidden_state`` of an ``xglm`` ``config.json`` (see the module
    docstring for what Flax computes)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        c = self.c = _cfg(config)
        self.config = dict(config)
        d = int(c["d_model"])
        self.embed_tokens = Embedding(c["vocab_size"], d)
        self.layers = nn.ModuleList(_Layer(c) for _ in range(int(c["num_layers"])))
        self.layer_norm = LayerNorm(d, EPS)
        self.embed_scale = math.sqrt(d) if c["scale_embedding"] else 1.0

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, d_model]``."""
        n = input_ids.shape[1]
        check_length(n, int(self.c["max_position_embeddings"]), "max_position_embeddings")
        table = sinusoidal_positions(n + OFFSET, int(self.c["d_model"]))[OFFSET:]
        x = self.embed_tokens(input_ids) * self.embed_scale + table.to(input_ids.device)
        allowed = causal_allowed(attention_mask)
        for layer in self.layers:
            x = layer(x, allowed)
        return self.layer_norm(x)
