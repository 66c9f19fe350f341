"""The Llama-family decoders in plain PyTorch: the forward pass of
``transformers``' ``FlaxLlamaModel``, ``FlaxMistralModel`` and
``FlaxGemmaModel`` that ``svs_tpu``'s local provider runs, up to
``last_hidden_state``.

One stack serves the three ``model_type``s: the token embeddings (times
``sqrt(hidden_size)`` for ``gemma``), then each layer: RMSNorm, causal
self-attention with rotary positions and grouped-query attention, the
residual; RMSNorm, the gated MLP ``down(up(x) * act(gate(x)))`` with no
biases, the residual; and a final RMSNorm.  What Flax computes, kept as
it is (``ROADMAP.md`` lists these under the defects inherited from the
reference):

- positions are ``0 .. L-1`` whatever the padding; Llama's and Gemma's
  tokenizers pad on the left, so a text's tokens sit at ``L - len ..``;
- the rotary table is Flax's ``create_sinusoidal_positions``: base 10,000
  whatever ``rope_theta`` says, no ``rope_scaling``, computed in float64
  then rounded to f32 by NumPy; the head width is ``hidden_size //
  num_attention_heads`` (``llama``, ``mistral``) or ``head_dim``
  (``gemma``);
- the mask is an additive bias of the f32 minimum (not ``-inf``) over the
  keys a query may not see: padded keys, later keys, and for ``mistral``
  keys more than ``sliding_window`` back (``jnp.triu(causal,
  k=-(sliding_window or 0))``: a query sees ``w + 1`` keys, and with
  ``sliding_window: null`` only itself).  A query whose keys are all masked
  (a left pad) gets a uniform softmax over the whole row, as in Flax;
- RMSNorm takes the variance in f32 and divides by its ``sqrt``; Gemma's
  multiplies by ``1 + w``;
- a key/value head serves ``num_attention_heads // num_key_value_heads``
  consecutive query heads (``jnp.repeat(..., axis=2)``);
- the MLP has no biases whatever ``mlp_bias`` says; the projections of
  the attention have them when ``attention_bias`` is true (``llama``,
  ``gemma``);
- Gemma's activation is ``hidden_activation``, ``gelu_pytorch_tanh`` when
  that is null (whatever ``hidden_act`` says).

Parameter names are those of the Flax tree, so
``svs_tpu_torch.convert.encoder_state_dict_from_flax`` maps a checkpoint
onto it.  The products are PyTorch's (the JAX package leaves them to XLA
outside any Pallas kernel).  Under ``torch.autocast`` the attention
scores and softmax are f32, as Flax's ``dtype=bfloat16`` computes them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .bert import Embedding, Linear, activation

#: The ``model_type``s this module computes.
MODEL_TYPES = ("llama", "mistral", "gemma")
#: Each type's ``transformers`` config defaults for the keys read here
#: (a ``config.json`` may leave them out).
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "llama": {"vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
              "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": None,
              "hidden_act": "silu", "max_position_embeddings": 2048, "rms_norm_eps": 1e-6,
              "attention_bias": False, "head_dim": None},
    "mistral": {"vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
                "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
                "hidden_act": "silu", "max_position_embeddings": 4096 * 32,
                "rms_norm_eps": 1e-6, "sliding_window": 4096, "head_dim": None},
    "gemma": {"vocab_size": 256000, "hidden_size": 3072, "intermediate_size": 24576,
              "num_hidden_layers": 28, "num_attention_heads": 16, "num_key_value_heads": 16,
              "head_dim": 256, "hidden_activation": None, "max_position_embeddings": 8192,
              "rms_norm_eps": 1e-6, "attention_bias": False},
}


def _cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    """``config`` over its type's defaults, with the derived widths:
    ``kv_heads``, ``head_width`` (what Flax uses), ``act``, ``window``."""
    model_type = config.get("model_type")
    c = {**DEFAULTS[model_type], **config}
    heads = int(c["num_attention_heads"])
    c["kv_heads"] = int(c["num_key_value_heads"] or heads)
    if model_type == "gemma":
        c["head_width"] = int(c["head_dim"])
        c["act"] = c.get("hidden_activation") or "gelu_pytorch_tanh"
    else:
        c["head_width"] = int(c["hidden_size"]) // heads
        c["act"] = c.get("hidden_act", "silu")
    c["bias"] = model_type != "mistral" and bool(c.get("attention_bias"))
    # Mistral's window (None: each query sees itself only); the others none
    c["window"] = (int(c.get("sliding_window") or 0)) if model_type == "mistral" else None
    return c


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on; return
    quietly for what :class:`LlamaEncoder` runs as Flax does."""
    model_type = config.get("model_type")
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not a Llama-family decoder "
            f"(this module runs {MODEL_TYPES})"
        )
    c = _cfg(config)
    hidden, heads, kv = int(c["hidden_size"]), int(c["num_attention_heads"]), c["kv_heads"]
    activation(c["act"])
    if model_type != "gemma":
        if hidden % heads:
            raise NotImplementedError(
                f"hidden_size {hidden} is not a multiple of num_attention_heads {heads} "
                f"(Flax's {model_type} fails on it)"
            )
        if c.get("head_dim") not in (None, hidden // heads):
            raise NotImplementedError(
                f"head_dim {c['head_dim']} differs from hidden_size // num_attention_heads "
                f"= {hidden // heads}: Flax's {model_type} ignores head_dim, so its weights "
                "do not have the shapes of such a checkpoint"
            )
    if c["head_width"] % 2:
        raise NotImplementedError(
            f"an odd head width {c['head_width']}: Flax's rotary table does not fit it"
        )
    if heads % kv:
        raise NotImplementedError(
            f"num_attention_heads {heads} is not a multiple of num_key_value_heads {kv}"
        )
    if int(c["max_position_embeddings"]) < 2 * c["head_width"]:
        raise NotImplementedError(
            f"max_position_embeddings {c['max_position_embeddings']} < 2 x the head width "
            f"{c['head_width']}: Flax's rotary table is cut to max_position_embeddings "
            "columns and its product fails"
        )


def rotary_table(positions: int, width: int) -> torch.Tensor:
    """Flax's ``create_sinusoidal_positions`` rows ``0 .. positions-1``:
    ``[positions, 2 * width]``, sin then cos (base 10,000)."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, width, 2)[: width // 2] / width))
    freqs = np.einsum("i , j -> i j", np.arange(positions), inv_freq).astype("float32")
    emb = np.concatenate((freqs, freqs), axis=-1)
    return torch.from_numpy(np.concatenate((np.sin(emb), np.cos(emb)), axis=-1))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


class RMSNorm(nn.Module):
    """Flax's RMSNorm: ``w * x / sqrt(mean(x^2) + eps)``, the variance in
    f32; ``(1 + w)`` for Gemma."""

    def __init__(self, width: int, eps: float, plus_one: bool) -> None:
        super().__init__()
        self.eps, self.plus_one = float(eps), plus_one
        self.weight = nn.Parameter(torch.empty(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        variance = x.float().pow(2).mean(-1, keepdim=True)
        x = x / torch.sqrt(variance + self.eps)
        return ((1 + self.weight) if self.plus_one else self.weight) * x


class _Attention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h, self.heads, self.kv_heads = c["hidden_size"], c["num_attention_heads"], c["kv_heads"]
        self.width = c["head_width"]
        self.q_proj = Linear(h, self.heads * self.width, c["bias"])
        self.k_proj = Linear(h, self.kv_heads * self.width, c["bias"])
        self.v_proj = Linear(h, self.kv_heads * self.width, c["bias"])
        self.o_proj = Linear(self.heads * self.width, h, c["bias"])

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q = self.q_proj(x).view(b, n, self.heads, self.width)
        k = self.k_proj(x).view(b, n, self.kv_heads, self.width)
        v = self.v_proj(x).view(b, n, self.kv_heads, self.width)
        # the rotated query and key back in the products' dtype, as Flax
        q = (q * cos + _rotate_half(q) * sin).to(q.dtype)
        k = (k * cos + _rotate_half(k) * sin).to(k.dtype)
        # [B, KV, G, L, D]: query head kv * G + g reads key/value head kv
        group = self.heads // self.kv_heads
        q = q.float().transpose(1, 2).reshape(b, self.kv_heads, group, n, self.width)
        k = k.float().transpose(1, 2)[:, :, None]
        q = q / math.sqrt(self.width)
        with torch.autocast(device_type=x.device.type, enabled=False):
            scores = q @ k.transpose(-1, -2) + bias[:, :, None]
            probs = torch.softmax(scores, dim=-1)
        vt = v.transpose(1, 2)[:, :, None]
        ctx = probs.to(vt.dtype) @ vt  # [B, KV, G, L, D]
        return self.o_proj(ctx.reshape(b, self.heads, n, self.width).transpose(1, 2)
                           .reshape(b, n, self.heads * self.width))


class _MLP(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h, inner = c["hidden_size"], c["intermediate_size"] or 4 * c["hidden_size"]
        self.gate_proj = Linear(h, inner, bias=False)
        self.up_proj = Linear(h, inner, bias=False)
        self.down_proj = Linear(inner, h, bias=False)
        self.act = activation(c["act"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.up_proj(x) * self.act(self.gate_proj(x)))


class _Layer(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        gemma = c["model_type"] == "gemma"
        self.input_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"], gemma)
        self.self_attn = _Attention(c)
        self.post_attention_layernorm = RMSNorm(c["hidden_size"], c["rms_norm_eps"], gemma)
        self.mlp = _MLP(c)

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), sin, cos, bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaEncoder(nn.Module):
    """``last_hidden_state`` of a ``llama``, ``mistral`` or ``gemma``
    ``config.json`` (see the module docstring for what Flax computes)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        c = self.c = _cfg(config)
        self.config = dict(config)
        self.embed_tokens = Embedding(c["vocab_size"], c["hidden_size"])
        self.layers = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(c["hidden_size"], c["rms_norm_eps"], c["model_type"] == "gemma")
        self.embed_scale: Optional[float] = (
            float(c["hidden_size"]) ** 0.5 if c["model_type"] == "gemma" else None
        )

    def attention_bias(self, mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` 0/1 mask -> ``[B, 1, L, L]`` f32 bias: 0 where query
        ``i`` may see key ``j`` (``j`` a token, ``j <= i``, and for Mistral
        ``j >= i - sliding_window``), the f32 minimum elsewhere."""
        n = mask.shape[1]
        i = torch.arange(n, device=mask.device)
        allowed = i[None, :] <= i[:, None]
        if self.c["window"] is not None:
            allowed = allowed & (i[None, :] >= i[:, None] - self.c["window"])
        allowed = allowed[None] & (mask[:, None, :] > 0)
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        neg = torch.full((), torch.finfo(torch.float32).min, dtype=torch.float32,
                         device=mask.device)
        return torch.where(allowed, zero, neg)[:, None]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, hidden]``."""
        n = input_ids.shape[1]
        if n > int(self.c["max_position_embeddings"]):
            raise ValueError(
                f"{n} tokens pass max_position_embeddings "
                f"{self.c['max_position_embeddings']} (Flax fails on them too)"
            )
        x = self.embed_tokens(input_ids)
        if self.embed_scale is not None:
            x = x * self.embed_scale
        width = self.c["head_width"]
        table = rotary_table(n, width).to(input_ids.device)
        # [L, 1, D]: broadcast over the batch and the heads of [B, L, H, D]
        sin, cos = table[:, None, :width], table[:, None, width:]
        bias = self.attention_bias(attention_mask)
        for layer in self.layers:
            x = layer(x, sin, cos, bias)
        return self.norm(x)
