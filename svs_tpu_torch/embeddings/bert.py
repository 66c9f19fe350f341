"""The BERT encoder family in plain PyTorch: the forward pass of
``transformers``' ``FlaxBertModel``, ``FlaxRobertaModel``,
``FlaxXLMRobertaModel``, ``FlaxElectraModel``,
``FlaxRobertaPreLayerNormModel`` and ``FlaxBigBirdModel`` that
``svs_tpu``'s local provider runs, up to ``last_hidden_state``.

One stack serves the six ``model_type``s; the embeddings differ:

- ``bert``: word + token type (all 0) + absolute position (0, 1, ...);
- ``roberta`` / ``xlm-roberta`` / ``roberta-prelayernorm``: positions
  count the real tokens from ``pad_token_id + 1`` and a pad sits at
  ``pad_token_id`` (``cumsum(ids != pad) * (ids != pad) + pad``, as
  ``create_position_ids_from_input_ids``); ``type_vocab_size`` may be 1;
- ``electra``: word, position and token type tables of width
  ``embedding_size``, the token types all 1 (``FlaxElectraModel``'s
  default when none are passed), and an ``embeddings_project`` Dense layer
  to ``hidden_size`` when the two widths differ;
- ``big_bird``: as ``bert`` (positions 0, 1, ... whatever the pad id),
  the word embeddings times ``sqrt(hidden_size)`` with
  ``rescale_embeddings``; its attention is :mod:`.big_bird`'s when
  ``attention_type`` is ``block_sparse``.

Then LayerNorm with the config's eps, and each layer: self-attention (the
query scaled by 1/sqrt(head dim), an additive mask of 0 / the f32 minimum
over padded keys, softmax), the output projection, residual and
LayerNorm; the intermediate projection with the config's ``hidden_act``
(:data:`ACTIVATIONS`); the output projection, residual and LayerNorm.
``roberta-prelayernorm``'s layers are pre-LN instead: LayerNorm before the
attention and before the intermediate projection, the residuals added
with no norm after them, and one final ``LayerNorm`` after the stack.

Parameter names are those of the Flax tree (less the pooler, which
``last_hidden_state`` does not use), so
``svs_tpu_torch.convert.encoder_state_dict_from_flax`` maps a checkpoint
onto it.  The encoder is dense matrix products, which the JAX package
leaves to XLA outside any Pallas kernel; here they are PyTorch's (no
kernel of this repository).  Precision is the caller's:
``svs_tpu_torch.embeddings.local`` runs it in f32 (TF32 off) or under
``torch.autocast`` in bf16 with f32 parameters, as Flax's ``dtype=`` keeps
them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
from torch import nn
from torch.nn import functional as F

#: The ``model_type``s this module's encoder computes.
MODEL_TYPES = ("bert", "roberta", "xlm-roberta", "electra", "roberta-prelayernorm", "big_bird")
#: The types whose positions count from ``pad_token_id + 1``.
PAD_OFFSET_TYPES = ("roberta", "xlm-roberta", "roberta-prelayernorm")
#: ``transformers``' Flax ``ACT2FN`` entries that are ported (``gelu`` is
#: the exact erf form, ``gelu_new`` / ``gelu_pytorch_tanh`` the tanh one).
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
}


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    fn = ACTIVATIONS.get(name)
    if fn is None:
        raise NotImplementedError(
            f"activation {name!r} is not ported (ported: {sorted(ACTIVATIONS)})"
        )
    return fn


def check_config(config: Dict[str, Any]) -> None:
    """Refuse what this encoder does not compute, naming it."""
    model_type = config.get("model_type")
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not a BERT-family encoder "
            f"(this module runs {MODEL_TYPES})"
        )
    activation(config.get("hidden_act", "gelu"))
    pos = config.get("position_embedding_type", "absolute")
    if pos != "absolute":
        raise NotImplementedError(f"position_embedding_type {pos!r} is not ported")


class Linear(nn.Module):
    """``nn.Linear``'s parameters and product, left uninitialised: the
    weights always come from a checkpoint, and an encoder of hundreds of
    millions of parameters builds on the meta device in no time."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """``nn.Embedding``'s table and lookup, left uninitialised."""

    def __init__(self, n: int, width: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, width))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` over the last axis, left uninitialised."""

    def __init__(self, width: int, eps: float) -> None:
        super().__init__()
        self.width, self.eps = width, float(eps)
        self.weight = nn.Parameter(torch.empty(width))
        self.bias = nn.Parameter(torch.empty(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.width,), self.weight, self.bias, self.eps)


def attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` 0/1 mask -> ``[B, 1, 1, L]`` f32 additive bias: 0 over
    real keys, the f32 minimum over padded ones (Flax's ``lax.select``)."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), torch.finfo(torch.float32).min, dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :] > 0, zero, neg)


class _Embeddings(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.model_type = c["model_type"]
        width = c["hidden_size"]
        if self.model_type == "electra":
            width = c.get("embedding_size", width)
        self.word_embeddings = Embedding(c["vocab_size"], width)
        self.position_embeddings = Embedding(c["max_position_embeddings"], width)
        self.token_type_embeddings = Embedding(c.get("type_vocab_size", 2), width)
        self.LayerNorm = LayerNorm(width, c.get("layer_norm_eps", 1e-12))
        default_pad = 1 if self.model_type in PAD_OFFSET_TYPES else 0
        self.pad_token_id = int(c.get("pad_token_id", default_pad))
        self.token_type = 1 if self.model_type == "electra" else 0
        # BigBird's rescale_embeddings: the word embeddings x sqrt(hidden)
        self.word_scale = float(c["hidden_size"]) ** 0.5 if c.get("rescale_embeddings") else None

    def positions(self, ids: torch.Tensor) -> torch.Tensor:
        if self.model_type in PAD_OFFSET_TYPES:
            real = (ids != self.pad_token_id).to(torch.int64)
            return torch.cumsum(real, dim=1) * real + self.pad_token_id
        return torch.arange(ids.shape[1], device=ids.device)[None]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        words = self.word_embeddings(ids)
        if self.word_scale is not None:
            words = words * self.word_scale
        x = (
            words
            + self.token_type_embeddings(torch.full_like(ids, self.token_type))
            + self.position_embeddings(self.positions(ids))
        )
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.head_dim = h // self.heads
        self.query = Linear(h, h)
        self.key = Linear(h, h)
        self.value = Linear(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, h = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, n, self.heads, self.head_dim).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(self.head_dim)
        k, v = heads(self.key(x)), heads(self.value(x))
        probs = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        ctx = probs.to(v.dtype) @ v
        return ctx.transpose(1, 2).reshape(b, n, h)


def _norm(c: Dict[str, Any]) -> LayerNorm:
    return LayerNorm(c["hidden_size"], c.get("layer_norm_eps", 1e-12))


class _DenseNorm(nn.Module):
    """A projection plus the residual, then LayerNorm of the sum (no norm
    in a pre-LN layer)."""

    def __init__(self, d_in: int, c: Dict[str, Any], pre_ln: bool) -> None:
        super().__init__()
        self.dense = Linear(d_in, c["hidden_size"])
        self.LayerNorm = None if pre_ln else _norm(c)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        x = self.dense(x) + residual
        return x if self.LayerNorm is None else self.LayerNorm(x)


class _Attention(nn.Module):
    def __init__(self, c: Dict[str, Any], self_attention: type, pre_ln: bool) -> None:
        super().__init__()
        self.LayerNorm = _norm(c) if pre_ln else None
        self.self = self_attention(c)
        self.output = _DenseNorm(c["hidden_size"], c, pre_ln)

    def forward(self, x: torch.Tensor, mask: Any) -> torch.Tensor:
        a = x if self.LayerNorm is None else self.LayerNorm(x)
        return self.output(self.self(a, mask), x)


class _Intermediate(nn.Module):
    def __init__(self, c: Dict[str, Any], pre_ln: bool) -> None:
        super().__init__()
        self.LayerNorm = _norm(c) if pre_ln else None
        self.dense = Linear(c["hidden_size"], c["intermediate_size"])
        self.act = activation(c.get("hidden_act", "gelu"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.LayerNorm is not None:
            x = self.LayerNorm(x)
        return self.act(self.dense(x))


class _Layer(nn.Module):
    def __init__(self, c: Dict[str, Any], self_attention: type, pre_ln: bool) -> None:
        super().__init__()
        self.attention = _Attention(c, self_attention, pre_ln)
        self.intermediate = _Intermediate(c, pre_ln)
        self.output = _DenseNorm(c["intermediate_size"], c, pre_ln)

    def forward(self, x: torch.Tensor, mask: Any) -> torch.Tensor:
        a = self.attention(x, mask)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, c: Dict[str, Any], self_attention: type, pre_ln: bool) -> None:
        super().__init__()
        self.layer = nn.ModuleList(
            _Layer(c, self_attention, pre_ln) for _ in range(c["num_hidden_layers"])
        )


class BertEncoder(nn.Module):
    """``last_hidden_state`` of a BERT, RoBERTa, XLM-RoBERTa, ELECTRA,
    RoBERTa-PreLayerNorm or (full attention) BigBird ``config.json`` (see
    the module docstring for how they differ).  ``self_attention`` is the
    class of each layer's ``attention.self`` (:mod:`.big_bird` passes its
    block-sparse one); it takes the hidden states and what
    :meth:`attention_mask` makes of the 0/1 mask."""

    def __init__(self, config: Dict[str, Any], self_attention: type = _SelfAttention) -> None:
        super().__init__()
        check_config(config)
        self.config = dict(config)
        self.embeddings = _Embeddings(config)
        if self.embeddings.LayerNorm.width != config["hidden_size"]:
            self.embeddings_project = Linear(
                self.embeddings.LayerNorm.width, config["hidden_size"]
            )
        pre_ln = config["model_type"] == "roberta-prelayernorm"
        self.encoder = _Encoder(config, self_attention, pre_ln)
        self.LayerNorm = _norm(config) if pre_ln else None

    def attention_mask(self, mask: torch.Tensor) -> Any:
        """What each layer's attention takes: the additive bias."""
        return attention_bias(mask)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, hidden]``."""
        x = self.embeddings(input_ids)
        if hasattr(self, "embeddings_project"):
            x = self.embeddings_project(x)
        mask = self.attention_mask(attention_mask)
        for layer in self.encoder.layer:
            x = layer(x, mask)
        if self.LayerNorm is not None:
            x = self.LayerNorm(x)
        return x
