"""A BERT encoder (``model_type: "bert"``) in plain PyTorch: the forward
pass of ``transformers``' ``FlaxBertModel`` that ``svs_tpu``'s local
provider runs, up to ``last_hidden_state``.

- embeddings: word + token type (all 0) + absolute position, then
  LayerNorm with the config's eps;
- each layer: self-attention (the query scaled by 1/sqrt(head dim), an
  additive mask of 0 / the f32 minimum over padded keys, softmax), the
  output projection, residual and LayerNorm; the intermediate projection
  with exact-erf GELU (``hidden_act: "gelu"``); the output
  projection, residual and LayerNorm.

Parameter names are those of ``transformers``' PyTorch ``BertModel`` (less
the pooler, which ``last_hidden_state`` does not use), so
``svs_tpu_torch.convert.bert_state_dict_from_flax`` maps a Flax tree onto
it.  The encoder is dense matrix products, which the JAX package leaves to
XLA outside any Pallas kernel; here they are PyTorch's (no kernel of this
repository).  Precision is the caller's: ``svs_tpu_torch.embeddings.local``
runs it in f32 (TF32 off) or under ``torch.autocast`` in bf16 with f32
parameters, as Flax's ``dtype=`` keeps them.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn
from torch.nn import functional as F



def check_config(config: Dict[str, Any]) -> None:
    """Refuse what this encoder does not compute, naming it."""
    model_type = config.get("model_type")
    if model_type != "bert":
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported: svs_tpu_torch's local "
            "provider runs BERT encoders (model_type 'bert') only"
        )
    act = config.get("hidden_act", "gelu")
    if act != "gelu":  # exact erf, as bge-*-en-v1.5 and all-MiniLM-L6-v2 use
        raise NotImplementedError(f"hidden_act {act!r} is not ported")
    pos = config.get("position_embedding_type", "absolute")
    if pos != "absolute":
        raise NotImplementedError(f"position_embedding_type {pos!r} is not ported")


class _Embeddings(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h = c["hidden_size"]
        self.word_embeddings = nn.Embedding(c["vocab_size"], h)
        self.position_embeddings = nn.Embedding(c["max_position_embeddings"], h)
        self.token_type_embeddings = nn.Embedding(c.get("type_vocab_size", 2), h)
        self.LayerNorm = nn.LayerNorm(h, eps=c.get("layer_norm_eps", 1e-12))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        token_type = torch.zeros_like(ids)
        x = (
            self.word_embeddings(ids)
            + self.token_type_embeddings(token_type)
            + self.position_embeddings(pos)[None]
        )
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.head_dim = h // self.heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, h = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, n, self.heads, self.head_dim).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(self.head_dim)
        k, v = heads(self.key(x)), heads(self.value(x))
        probs = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        ctx = probs.to(v.dtype) @ v
        return ctx.transpose(1, 2).reshape(b, n, h)


class _DenseNorm(nn.Module):
    """A projection, then LayerNorm of it plus the residual."""

    def __init__(self, d_in: int, c: Dict[str, Any]) -> None:
        super().__init__()
        h = c["hidden_size"]
        self.dense = nn.Linear(d_in, h)
        self.LayerNorm = nn.LayerNorm(h, eps=c.get("layer_norm_eps", 1e-12))

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _DenseNorm(c["hidden_size"], c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class _Intermediate(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["intermediate_size"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))


class _Layer(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _DenseNorm(c["intermediate_size"], c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        a = self.attention(x, bias)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))


class BertEncoder(nn.Module):
    """``FlaxBertModel``'s ``last_hidden_state`` for a ``config.json``."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        self.config = dict(config)
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, hidden]``."""
        x = self.embeddings(input_ids)
        neg = torch.finfo(torch.float32).min
        bias = torch.where(
            attention_mask[:, None, None, :] > 0,
            torch.zeros((), dtype=torch.float32, device=x.device),
            torch.full((), neg, dtype=torch.float32, device=x.device),
        )
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
