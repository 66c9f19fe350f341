"""The GPT-Neo decoder in plain PyTorch: the forward pass of
``transformers``' ``FlaxGPTNeoModel`` that ``svs_tpu``'s local provider
runs, up to ``last_hidden_state``.

GPT-2's stack (:mod:`.gpt2`: learned ``wte`` + ``wpe`` at positions ``0 ..
L-1``, pre-LN blocks, ``ln_f``, the MLP ``c_fc`` / ``c_proj``) with its own
attention: ``q_proj``, ``k_proj`` and ``v_proj`` without biases,
``out_proj`` with one; the layers alternate as ``attention_layers`` says
(``[[["global", "local"], 12]]`` expands to 24 layers), and a ``local``
layer's query sees the last ``window_size`` keys, itself included
(``causal ^ tril(causal, -window_size)``).  Flax multiplies the query by
``sqrt(head width)`` and then divides it back out in the attention: both
steps round (in bf16 under autocast), so the port keeps that order.
Parameter names are those of the Flax tree; the kernels are Flax Dense
kernels, transposed on the way in (``svs_tpu_torch.convert``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn

from .bert import Embedding, LayerNorm, Linear, activation
from .gpt2 import MLP, Block, attend, causal_allowed, check_length, check_widths, config_of

MODEL_TYPES = ("gpt_neo",)
#: ``GPTNeoConfig``'s defaults for the keys read here.
DEFAULTS: Dict[str, Any] = {
    "vocab_size": 50257, "max_position_embeddings": 2048, "hidden_size": 2048,
    "num_layers": 24, "attention_types": [[["global", "local"], 12]], "num_heads": 16,
    "intermediate_size": None, "window_size": 256, "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-5,
}
ALIASES = {"num_attention_heads": "num_heads", "num_hidden_layers": "num_layers"}


def expand_attention_types(attention_types: List[Any]) -> List[str]:
    """``GPTNeoConfig.expand_attention_types_params``: ``[[kinds, n], ...]``
    -> ``kinds`` repeated ``n`` times, in order."""
    out: List[str] = []
    for kinds, repeat in attention_types:
        for _ in range(int(repeat)):
            out.extend(kinds)
    return out


def _cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    """``config`` over the defaults, with ``attention_layers`` (the
    file's, else the expansion of ``attention_types``, as the config
    class leaves it)."""
    c = config_of(config, DEFAULTS, ALIASES)
    c["attention_layers"] = list(config.get("attention_layers")
                                 or expand_attention_types(c["attention_types"]))
    return c


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    if config.get("model_type") not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not gpt_neo")
    c = _cfg(config)
    layers = int(c["num_layers"])
    check_widths("gpt_neo", int(c["hidden_size"]), int(c["num_heads"]))
    activation(c["activation_function"])
    expanded = expand_attention_types(c["attention_types"])
    if len(expanded) != layers:
        raise NotImplementedError(
            f"attention_types expand to {len(expanded)} layers, not num_layers {layers} "
            "(GPTNeoConfig refuses it)"
        )
    if len(c["attention_layers"]) < layers:
        raise NotImplementedError(
            f"attention_layers names {len(c['attention_layers'])} layers of {layers} "
            "(Flax's gpt_neo fails on it)"
        )


class _SelfAttention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h, self.heads = int(c["hidden_size"]), int(c["num_heads"])
        self.q_proj = Linear(h, h, bias=False)
        self.k_proj = Linear(h, h, bias=False)
        self.v_proj = Linear(h, h, bias=False)
        self.out_proj = Linear(h, h)

    def forward(self, x: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        b, n, h = x.shape
        d = h // self.heads
        q = self.q_proj(x)
        q = q * torch.tensor(math.sqrt(d), dtype=q.dtype)
        k, v = self.k_proj(x), self.v_proj(x)
        shape = (b, n, self.heads, d)
        return self.out_proj(attend(q.view(shape), k.view(shape), v.view(shape), allowed))


class _Attention(nn.Module):
    """Flax's ``FlaxGPTNeoAttention``: a wrapper whose one child is
    ``attention``; ``local`` layers take the windowed mask."""

    def __init__(self, c: Dict[str, Any], local: bool) -> None:
        super().__init__()
        self.local = local
        self.attention = _SelfAttention(c)

    def forward(self, x: torch.Tensor, masks: Dict[bool, torch.Tensor]) -> torch.Tensor:
        return self.attention(x, masks[self.local])


class GPTNeoEncoder(nn.Module):
    """``last_hidden_state`` of a ``gpt_neo`` ``config.json`` (see the
    module docstring for what Flax computes)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        c = self.c = _cfg(config)
        self.config = dict(config)
        h, eps = int(c["hidden_size"]), float(c["layer_norm_epsilon"])
        inner = int(c["intermediate_size"] or 4 * h)
        self.wte = Embedding(c["vocab_size"], h)
        self.wpe = Embedding(c["max_position_embeddings"], h)
        self.h = nn.ModuleList(
            Block(h, eps, _Attention(c, c["attention_layers"][i] == "local"),
                  MLP(h, inner, c["activation_function"]))
            for i in range(int(c["num_layers"]))
        )
        self.ln_f = LayerNorm(h, eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, hidden_size]``."""
        n = input_ids.shape[1]
        check_length(n, int(self.c["max_position_embeddings"]), "max_position_embeddings")
        x = self.wte(input_ids) + self.wpe(torch.arange(n, device=input_ids.device))
        # a local query sees window_size keys: itself and window_size - 1 back
        masks = {False: causal_allowed(attention_mask),
                 True: causal_allowed(attention_mask, int(self.c["window_size"]) - 1)}
        for block in self.h:
            x = block(x, masks)
        return self.ln_f(x)
