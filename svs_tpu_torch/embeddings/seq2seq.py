"""The encoder-decoder stack in plain PyTorch that ``transformers``'
``FlaxBartModel``, ``FlaxMBartModel``, ``FlaxPegasusModel``,
``FlaxBlenderbotModel`` and ``FlaxBlenderbotSmallModel`` share, up to the
decoder's ``last_hidden_state``: what ``svs_tpu``'s local provider pools
when it calls such a model with ``input_ids`` and ``attention_mask`` alone.

``Flax*Model.__call__`` then makes the decoder's inputs itself
(``modeling_flax_bart.py:1206-1216``):

- ``decoder_input_ids`` are ``input_ids`` shifted one place right, the
  first ``decoder_start_token_id`` (:func:`shift_right`); mBART has no start
  token and wraps each row's token at ``(count of non-pad tokens) - 1`` to
  position 0 (:func:`shift_right_wrapped`, ``modeling_flax_mbart.py:220-240``);
- the decoder's own mask is all ones: its self-attention is causal only,
  pads included, and only the cross-attention sees the encoder's mask;
- both stacks read positions ``0 .. L-1`` whatever the padding.

Each stack: the shared token embeddings (times ``sqrt(d_model)`` with
``scale_embedding``) plus positions (a learned table read at ``position +
offset``, or Marian's fixed sinusoidal table, :func:`sinusoidal_positions`),
``layernorm_embedding`` where the family has it (after the positions, or,
in Blenderbot-small's decoder, on the token embeddings before them), then
the layers, post-LN (BART, Blenderbot-small) or pre-LN with a final
``layer_norm`` (mBART, Pegasus, Blenderbot).  A layer is self-attention,
in the decoder causal self-attention and cross-attention over the
encoder's states (keys and values projected from them), and
``fc2(act(fc1(x)))``; every LayerNorm's epsilon is 1e-5.  The attention is
:func:`.gpt2.attend`: Flax's ``dot_product_attention_weights`` in the
compute dtype, a masked key at that dtype's minimum (a query with every key
masked, an empty text's, gets a uniform softmax, as in Flax).

A family is a :class:`Layout`; :mod:`.bart`, :mod:`.pegasus` and
:mod:`.blenderbot` hold each type's layout and ``config.json`` defaults.
Parameter names are those of the Flax tree (``shared``, ``encoder``,
``decoder``), Dense kernels transposed on the way in
(``svs_tpu_torch.convert``); the products are PyTorch's (the JAX package
leaves them to XLA outside any Pallas kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .bert import Embedding, LayerNorm, Linear, activation
from .gpt2 import attend, check_length, check_widths, config_of

#: ``nn.LayerNorm(epsilon=1e-05)`` in every Flax LayerNorm of these types.
EPS = 1e-5
#: ``PretrainedConfig.attribute_map`` of the five configs.
ALIASES = {"hidden_size": "d_model", "num_attention_heads": "encoder_attention_heads"}


@dataclasses.dataclass(frozen=True)
class Layout:
    """What one family's Flax stacks compute beyond the shared layer.

    ``positions``: ``"learned"`` (``embed_positions`` of
    ``max_position_embeddings + offset`` rows) or ``"sinusoidal"``;
    ``pre_ln``: LayerNorm before each block and a final ``layer_norm`` on
    each stack, else after each residual; ``embedding_norm``: where
    ``layernorm_embedding`` sits (``None``, ``"after_positions"``, or
    ``"encoder_after_decoder_before"``: Blenderbot-small's encoder after
    the positions, its decoder on the token embeddings before them);
    ``wrapped_shift``: mBART's :func:`shift_right_wrapped`."""

    positions: str = "learned"
    offset: int = 0
    pre_ln: bool = False
    embedding_norm: Optional[str] = None
    wrapped_shift: bool = False


def cfg_of(config: Mapping[str, Any], defaults: Mapping[str, Any]) -> Dict[str, Any]:
    """``config`` over the type's class defaults, ``attribute_map``'s
    aliases written over what they name."""
    return config_of(config, defaults, ALIASES)


def check(model_type: str, c: Dict[str, Any], layout: Layout) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    d = int(c["d_model"])
    for key in ("encoder_attention_heads", "decoder_attention_heads"):
        check_widths(model_type, d, int(c[key]))
    activation(c["activation_function"])
    if c.get("pad_token_id") is None:
        raise NotImplementedError(
            f"pad_token_id null: Flax's {model_type} shift of the decoder inputs fails on it")
    if not layout.wrapped_shift and c.get("decoder_start_token_id") is None:
        raise NotImplementedError(
            f"decoder_start_token_id null: Flax's {model_type} shift of the decoder inputs "
            "fails on it")


def shift_right(ids: torch.Tensor, start: int) -> torch.Tensor:
    """``shift_tokens_right`` of BART, Pegasus and Blenderbot: ``ids``
    one place right, ``start`` first (no id is -100, so the pad id
    replaces nothing)."""
    out = torch.empty_like(ids)
    out[:, 1:] = ids[:, :-1]
    out[:, 0] = start
    return out


def shift_right_wrapped(ids: torch.Tensor, pad: int) -> torch.Tensor:
    """mBART's ``shift_tokens_right``: ``ids`` one place right, and first
    the token at index (count of non-pad tokens - 1) of the row, the
    language code of a right-padded ``$A </s> en_XX`` row; an all-pad row
    takes index -1, its last token."""
    last = ((ids != pad).sum(dim=1) - 1) % ids.shape[1]
    out = torch.empty_like(ids)
    out[:, 1:] = ids[:, :-1]
    out[:, 0] = ids.gather(1, last[:, None])[:, 0]
    return out


def sinusoidal_positions(positions: int, width: int) -> torch.Tensor:
    """Marian's ``create_sinusoidal_positions`` (Pegasus's): column ``j``
    of row ``p`` is ``p / 10000^(2 (j // 2) / width)``; the sines of the
    even columns fill the first ``ceil(width / 2)`` columns, the cosines of
    the odd ones the rest.  float64 (each power a scalar ``np.power``, as
    Flax's list computes it), then f32."""
    denom = np.array([np.power(10000, 2 * (j // 2) / width) for j in range(width)])
    enc = np.arange(positions)[:, None] / denom[None, :]
    sentinel = width // 2 + width % 2
    out = np.zeros_like(enc)
    out[:, :sentinel] = np.sin(enc[:, 0::2])
    out[:, sentinel:] = np.cos(enc[:, 1::2])
    return torch.from_numpy(out.astype(np.float32))


class Attention(nn.Module):
    """``Flax*Attention``: ``q_proj`` of the queries' states, ``k_proj`` /
    ``v_proj`` of the keys' (the encoder's for cross-attention), biases
    everywhere, ``out_proj``."""

    def __init__(self, d: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)

    def forward(self, x: torch.Tensor, kv: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        width = d // self.heads
        q = self.q_proj(x).view(b, n, self.heads, width)
        k = self.k_proj(kv).view(b, kv.shape[1], self.heads, width)
        v = self.v_proj(kv).view(b, kv.shape[1], self.heads, width)
        return self.out_proj(attend(q, k, v, allowed))


class Layer(nn.Module):
    """An encoder layer, or with ``cross`` a decoder layer: each block
    ``x + f(ln(x))`` (pre-LN) or ``ln(x + f(x))`` (post-LN)."""

    def __init__(self, c: Dict[str, Any], side: str, pre_ln: bool, cross: bool) -> None:
        super().__init__()
        d, heads = int(c["d_model"]), int(c[f"{side}_attention_heads"])
        ffn = int(c[f"{side}_ffn_dim"])
        self.pre_ln = pre_ln
        self.self_attn = Attention(d, heads)
        self.self_attn_layer_norm = LayerNorm(d, EPS)
        if cross:
            self.encoder_attn = Attention(d, heads)
            self.encoder_attn_layer_norm = LayerNorm(d, EPS)
        self.fc1 = Linear(d, ffn)
        self.fc2 = Linear(ffn, d)
        self.final_layer_norm = LayerNorm(d, EPS)
        self.act = activation(c["activation_function"])

    def _block(self, x: torch.Tensor, ln: nn.Module, f: Any) -> torch.Tensor:
        if self.pre_ln:
            return x + f(ln(x))
        return ln(x + f(x))

    def forward(self, x: torch.Tensor, allowed: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                memory_allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._block(x, self.self_attn_layer_norm, lambda h: self.self_attn(h, h, allowed))
        if memory is not None:
            x = self._block(x, self.encoder_attn_layer_norm,
                            lambda h: self.encoder_attn(h, memory, memory_allowed))
        return self._block(x, self.final_layer_norm, lambda h: self.fc2(self.act(self.fc1(h))))


class Stack(nn.Module):
    """``Flax*Encoder`` or, with ``side="decoder"``, ``Flax*Decoder``: the
    embeddings (the shared table is the caller's), the layers and the final
    LayerNorm of a pre-LN layout."""

    def __init__(self, c: Dict[str, Any], layout: Layout, side: str) -> None:
        super().__init__()
        d = int(c["d_model"])
        self.layout, self.side = layout, side
        self.limit = int(c["max_position_embeddings"])
        if layout.positions == "learned":
            self.embed_positions = Embedding(self.limit + layout.offset, d)
        else:  # Pegasus: no parameter; built on the CPU under the meta device too
            self.register_buffer("sinusoidal", sinusoidal_positions(self.limit, d), persistent=False)
        if layout.embedding_norm is not None:
            self.layernorm_embedding = LayerNorm(d, EPS)
        self.layers = nn.ModuleList(
            Layer(c, side, layout.pre_ln, side == "decoder")
            for _ in range(int(c[f"{side}_layers"]))
        )
        if layout.pre_ln:
            self.layer_norm = LayerNorm(d, EPS)

    def forward(self, tokens: torch.Tensor, allowed: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                memory_allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``tokens``: the scaled token embeddings ``[B, L, d]``."""
        n, layout = tokens.shape[1], self.layout
        if layout.positions == "learned":
            idx = torch.arange(layout.offset, n + layout.offset, device=tokens.device)
            positions = self.embed_positions(idx)
        else:
            positions = self.sinusoidal[:n].to(tokens.dtype)
        if layout.embedding_norm == "encoder_after_decoder_before" and self.side == "decoder":
            x = self.layernorm_embedding(tokens) + positions
        else:
            x = tokens + positions
            if layout.embedding_norm is not None:
                x = self.layernorm_embedding(x)
        for layer in self.layers:
            x = layer(x, allowed, memory, memory_allowed)
        return self.layer_norm(x) if layout.pre_ln else x


class Seq2SeqEncoder(nn.Module):
    """The decoder's ``last_hidden_state`` of an encoder-decoder
    ``config.json`` whose type's class defaults and layout the caller gives
    (see the module docstring for what Flax computes)."""

    def __init__(self, config: Dict[str, Any], defaults: Mapping[str, Any], layout: Layout) -> None:
        super().__init__()
        c = self.c = cfg_of(config, defaults)
        check(str(config.get("model_type")), c, layout)
        self.config, self.layout = dict(config), layout
        d = int(c["d_model"])
        self.shared = Embedding(int(c["vocab_size"]), d)
        self.encoder = Stack(c, layout, "encoder")
        self.decoder = Stack(c, layout, "decoder")
        self.embed_scale = math.sqrt(d) if c["scale_embedding"] else 1.0

    def decoder_inputs(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.layout.wrapped_shift:
            return shift_right_wrapped(input_ids, int(self.c["pad_token_id"]))
        return shift_right(input_ids, int(self.c["decoder_start_token_id"]))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, d_model]``."""
        n = input_ids.shape[1]
        check_length(n, int(self.c["max_position_embeddings"]), "max_position_embeddings")
        keys = (attention_mask > 0)[:, None, None, :]
        memory = self.encoder(self.shared(input_ids) * self.embed_scale, keys)
        i = torch.arange(n, device=input_ids.device)
        causal = (i[None, :] <= i[:, None])[None, None]
        tokens = self.shared(self.decoder_inputs(input_ids)) * self.embed_scale
        return self.decoder(tokens, causal, memory, keys)
