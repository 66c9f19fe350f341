"""The GPT-2 decoder in plain PyTorch: the forward pass of ``transformers``'
``FlaxGPT2Model`` that ``svs_tpu``'s local provider runs, up to
``last_hidden_state``; and the pieces the other decoders of this kind
share (:func:`config_of`, :func:`causal_allowed`, :func:`attend`).

The token embeddings ``wte`` plus the learned positions ``wpe``, then
each block: ``ln_1``, causal self-attention (the fused ``c_attn`` split
into q | k | v, ``c_proj``), the residual; ``ln_2``, the MLP ``c_proj(
act(c_fc(x)))``, the residual; and ``ln_f``.  What Flax computes, kept as
it is (``ROADMAP.md`` lists these under the defects inherited from the
reference):

- positions are ``0 .. L-1`` whatever the padding (GPT-2's tokenizer pads
  on the right unless its config says otherwise);
- the query is always scaled by ``1/sqrt(head width)``: Flax ignores
  ``scale_attn_weights``, ``scale_attn_by_inverse_layer_idx`` and
  ``reorder_and_upcast_attn``;
- a key a query may not see (a pad, a later token) takes the minimum of
  the scores' dtype (Flax adds that minimum as a bias); a query whose keys
  are all masked gets a uniform softmax over the row, as in Flax;
- ``n_inner`` null means ``4 x n_embd``; ``activation_function``
  ``gelu_new`` is the tanh GELU.

``FlaxConv1D`` stores its kernel as ``[features, in]``, which is already
PyTorch's ``[out, in]``: ``svs_tpu_torch.convert`` takes GPT-2's kernels
as they are (every other Flax Dense kernel is transposed).  Parameter
names are those of the Flax tree; the products are PyTorch's (the JAX
package leaves them to XLA outside any Pallas kernel).  Under
``torch.autocast`` the attention scores and softmax are bf16, as Flax's
``dtype=bfloat16`` computes them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from .bert import Embedding, LayerNorm, Linear, activation

#: The ``model_type``s this module computes.
MODEL_TYPES = ("gpt2",)
#: ``GPT2Config``'s defaults for the keys read here.
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "gpt2": {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768, "n_layer": 12,
             "n_head": 12, "n_inner": None, "activation_function": "gelu_new",
             "layer_norm_epsilon": 1e-5, "add_cross_attention": False},
}
#: ``GPT2Config.attribute_map``: a ``config.json`` key on the left sets
#: the attribute on the right.
ALIASES = {"hidden_size": "n_embd", "max_position_embeddings": "n_positions",
           "num_attention_heads": "n_head", "num_hidden_layers": "n_layer"}


def config_of(config: Mapping[str, Any], defaults: Mapping[str, Any],
              aliases: Mapping[str, str]) -> Dict[str, Any]:
    """``config`` over ``defaults``, each key of ``aliases`` that
    ``config`` holds written over its attribute (``PretrainedConfig``'s
    ``attribute_map``)."""
    c = {**defaults, **config}
    for alias, key in aliases.items():
        if alias in config:
            c[key] = config[alias]
    return c


def _cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    return config_of(config, DEFAULTS["gpt2"], ALIASES)


def check_widths(model_type: str, hidden: int, heads: int) -> None:
    if heads < 1 or hidden % heads:
        raise NotImplementedError(
            f"the hidden width {hidden} is not a multiple of the head count {heads} "
            f"(Flax's {model_type} fails on it)"
        )


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    if config.get("model_type") not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not gpt2")
    c = _cfg(config)
    check_widths("gpt2", int(c["n_embd"]), int(c["n_head"]))
    activation(c["activation_function"])
    if c.get("add_cross_attention"):
        raise NotImplementedError(
            "add_cross_attention: a GPT-2 with cross-attention layers is not ported"
        )


def causal_allowed(mask: torch.Tensor, back: Optional[int] = None) -> torch.Tensor:
    """``[B, L]`` 0/1 mask -> ``[B, 1, L, L]`` bool: query ``i`` may see
    key ``j`` when ``j`` is a token, ``j <= i`` and, with ``back``, ``j >=
    i - back``."""
    i = torch.arange(mask.shape[1], device=mask.device)
    allowed = i[None, :] <= i[:, None]
    if back is not None:
        allowed = allowed & (i[None, :] >= i[:, None] - back)
    return (allowed[None] & (mask[:, None, :] > 0))[:, None]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, allowed: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flax's ``dot_product_attention_weights`` then the product with the
    values: ``[B, L, H, D]`` each -> ``[B, L, H * D]``.  The query is
    divided by ``sqrt(D)`` rounded to its own dtype; the scores take the
    queries' dtype (bf16 under autocast), a masked key that dtype's
    minimum.  With ``bias`` (BLOOM's ALiBi, ``[B, H, 1, L]``) the scores
    and softmax are f32 instead, as BLOOM's Flax attention computes them."""
    b, n, heads, d = q.shape
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if bias is None:
        q = q / torch.tensor(math.sqrt(d), dtype=q.dtype)
        scores = q @ k.transpose(-1, -2)
    else:
        with torch.autocast(device_type=q.device.type, enabled=False):
            q = q.float() / math.sqrt(d)
            scores = q @ k.float().transpose(-1, -2) + bias.float()
    scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    ctx = probs.to(v.dtype) @ v
    return ctx.transpose(1, 2).reshape(b, n, heads * d)


class _Attention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h, self.heads = int(c["n_embd"]), int(c["n_head"])
        self.c_attn = Linear(h, 3 * h)
        self.c_proj = Linear(h, h)

    def forward(self, x: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        b, n, h = x.shape
        q, k, v = self.c_attn(x).view(b, n, 3, self.heads, h // self.heads).unbind(2)
        return self.c_proj(attend(q, k, v, allowed))


class MLP(nn.Module):
    """``c_proj(act(c_fc(x)))`` (GPT-2, GPT-Neo)."""

    def __init__(self, hidden: int, inner: int, act: str) -> None:
        super().__init__()
        self.c_fc = Linear(hidden, inner)
        self.c_proj = Linear(inner, hidden)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class Block(nn.Module):
    """A pre-LN block: ``x + attn(ln_1(x))``, then ``+ mlp(ln_2(.))``
    (GPT-2, GPT-Neo)."""

    def __init__(self, hidden: int, eps: float, attn: nn.Module, mlp: nn.Module) -> None:
        super().__init__()
        self.ln_1 = LayerNorm(hidden, eps)
        self.attn = attn
        self.ln_2 = LayerNorm(hidden, eps)
        self.mlp = mlp

    def forward(self, x: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        x = self.attn(self.ln_1(x), allowed) + x
        return x + self.mlp(self.ln_2(x))


def check_length(n: int, limit: int, key: str) -> None:
    if n > limit:
        raise ValueError(f"{n} tokens pass {key} {limit} (Flax fails on them too)")


class GPT2Encoder(nn.Module):
    """``last_hidden_state`` of a ``gpt2`` ``config.json`` (see the module
    docstring for what Flax computes)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        c = self.c = _cfg(config)
        self.config = dict(config)
        h, eps = int(c["n_embd"]), float(c["layer_norm_epsilon"])
        inner = int(c["n_inner"] or 4 * h)
        self.wte = Embedding(c["vocab_size"], h)
        self.wpe = Embedding(c["n_positions"], h)
        self.h = nn.ModuleList(
            Block(h, eps, _Attention(c), MLP(h, inner, c["activation_function"]))
            for _ in range(int(c["n_layer"]))
        )
        self.ln_f = LayerNorm(h, eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, n_embd]``."""
        n = input_ids.shape[1]
        check_length(n, int(self.c["n_positions"]), "n_positions")
        x = self.wte(input_ids) + self.wpe(torch.arange(n, device=input_ids.device))
        allowed = causal_allowed(attention_mask)
        for block in self.h:
            x = block(x, allowed)
        return self.ln_f(x)
