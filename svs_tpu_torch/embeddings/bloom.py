"""The BLOOM decoder in plain PyTorch: the forward pass of ``transformers``'
``FlaxBloomModel`` that ``svs_tpu``'s local provider runs, up to
``last_hidden_state``.

``word_embeddings`` then ``word_embeddings_layernorm``, then each block:
``input_layernorm``, causal self-attention with ALiBi, ``dense`` plus the
residual; ``post_attention_layernorm``, the MLP ``dense_4h_to_h(gelu(
dense_h_to_4h(x)))`` plus the residual (the residual is the block's input
and the attention's output, or, with
``apply_residual_connection_post_layernorm``, their layer norms); and
``ln_f``.  What Flax computes, kept as it is:

- the fused ``query_key_value`` is laid out per head, ``[heads, 3 x
  head_dim]`` (q, k, v of a head side by side), not q | k | v;
- ALiBi: a slope per head (``2^(-8/n_head)`` to the powers ``1 ..
  n_head``, f32) times each key's position ``cumsum(mask) - 1`` (zero on
  pads), so left and right padding both hold; the tensor is cast to the
  hidden states' dtype (rounded to bf16 under autocast) before it is added
  to the scores;
- the scores and softmax are f32 (in bf16 runs too: Flax's
  ``attention_softmax_in_fp32``), the probabilities back in the products'
  dtype; a masked key takes the minimum, as a bias;
- the GELU is ``BloomGELU``: ``x/2 (1 + tanh(0.79788456 x (1 + 0.044715
  x^2)))``;
- Flax's slopes fail (``jnp.cat``) for a head count that is not a power of
  two: the port refuses such a config, naming ``n_head``.

Parameter names are those of the Flax tree; its Dense kernels are
transposed on the way in (``svs_tpu_torch.convert``), the fused layout
kept.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from .bert import Embedding, LayerNorm, Linear
from .gpt2 import attend, causal_allowed, check_widths, config_of

MODEL_TYPES = ("bloom",)
#: ``BloomConfig``'s defaults for the keys read here.
DEFAULTS: Dict[str, Any] = {
    "vocab_size": 250880, "hidden_size": 64, "n_layer": 2, "n_head": 8,
    "layer_norm_epsilon": 1e-5, "apply_residual_connection_post_layernorm": False,
}
#: ``BloomConfig.attribute_map``, and its ``n_embed`` (an older name of
#: ``hidden_size`` that the config class still reads).
ALIASES = {"num_hidden_layers": "n_layer", "num_attention_heads": "n_head",
           "n_embed": "hidden_size"}


def _cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    return config_of(config, DEFAULTS, ALIASES)


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    if config.get("model_type") not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not bloom")
    c = _cfg(config)
    heads = int(c["n_head"])
    check_widths("bloom", int(c["hidden_size"]), heads)
    if heads & (heads - 1):
        raise NotImplementedError(
            f"n_head {heads} is not a power of two: Flax's ALiBi slopes fail on it "
            "(jnp.cat)"
        )


def alibi_slopes(heads: int) -> torch.Tensor:
    """Flax's ``build_alibi_tensor`` slopes for a power-of-two head count:
    ``base ** (1 .. heads)`` in f32, ``base = 2^(-8/heads)``."""
    base = torch.tensor(2 ** (-(2 ** -(math.log2(heads) - 3))), dtype=torch.float32)
    return torch.pow(base, torch.arange(1, 1 + heads, dtype=torch.float32))


def alibi(mask: torch.Tensor, heads: int, dtype: torch.dtype) -> torch.Tensor:
    """``[B, L]`` 0/1 mask -> ``[B, heads, 1, L]``: each head's slope times
    each key's position ``cumsum(mask) - 1`` (0 on pads), in ``dtype``."""
    positions = ((mask.cumsum(dim=-1) - 1) * mask)[:, None, :]
    slopes = alibi_slopes(heads).to(mask.device)
    return (slopes[:, None] * positions).to(dtype)[:, :, None, :]


def bloom_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * x * (1 + 0.044715 * x * x)))


class _Attention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h, self.heads = int(c["hidden_size"]), int(c["n_head"])
        self.query_key_value = Linear(h, 3 * h)
        self.dense = Linear(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        b, n, h = x.shape
        q, k, v = self.query_key_value(x).view(b, n, self.heads, 3, h // self.heads).unbind(3)
        return self.dense(attend(q, k, v, allowed, bias))


class _MLP(nn.Module):
    def __init__(self, hidden: int) -> None:
        super().__init__()
        self.dense_h_to_4h = Linear(hidden, 4 * hidden)
        self.dense_4h_to_h = Linear(4 * hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_4h_to_h(bloom_gelu(self.dense_h_to_4h(x)))


class _Block(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h, eps = int(c["hidden_size"]), float(c["layer_norm_epsilon"])
        self.post_ln_residual = bool(c["apply_residual_connection_post_layernorm"])
        self.input_layernorm = LayerNorm(h, eps)
        self.self_attention = _Attention(c)
        self.post_attention_layernorm = LayerNorm(h, eps)
        self.mlp = _MLP(h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        y = self.input_layernorm(x)
        attn = self.self_attention(y, bias, allowed) + (y if self.post_ln_residual else x)
        z = self.post_attention_layernorm(attn)
        return self.mlp(z) + (z if self.post_ln_residual else attn)


class BloomEncoder(nn.Module):
    """``last_hidden_state`` of a ``bloom`` ``config.json`` (see the module
    docstring for what Flax computes)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        c = self.c = _cfg(config)
        self.config = dict(config)
        h, eps = int(c["hidden_size"]), float(c["layer_norm_epsilon"])
        self.word_embeddings = Embedding(c["vocab_size"], h)
        self.word_embeddings_layernorm = LayerNorm(h, eps)
        self.h = nn.ModuleList(_Block(c) for _ in range(int(c["n_layer"])))
        self.ln_f = LayerNorm(h, eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, hidden_size]``."""
        device = input_ids.device.type
        # the hidden states' dtype in Flax: the compute dtype (bf16 under autocast)
        dtype = (torch.get_autocast_dtype(device) if torch.is_autocast_enabled(device)
                 else torch.float32)
        x = self.word_embeddings_layernorm(self.word_embeddings(input_ids))
        bias = alibi(attention_mask, int(self.c["n_head"]), dtype)
        allowed = causal_allowed(attention_mask)
        for block in self.h:
            x = block(x, bias, allowed)
        return self.ln_f(x)
