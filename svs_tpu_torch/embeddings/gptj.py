"""The GPT-J decoder in plain PyTorch: the forward pass of ``transformers``'
``FlaxGPTJModel`` that ``svs_tpu``'s local provider runs, up to
``last_hidden_state``.

The token embeddings ``wte`` (no learned positions), then each block
in parallel: ``x + attn(ln_1(x)) + mlp(ln_1(x))`` (Flax adds the attention
and the MLP first, then the residual), and ``ln_f``.  The attention's
``q_proj``, ``k_proj``, ``v_proj`` and ``out_proj`` have no biases, the
MLP's ``fc_in`` / ``fc_out`` do.  Rotary positions ``0 .. L-1`` (whatever
the padding) turn the first ``rotary_dim`` lanes of each query and key
head only, interleaved (``rotate_every_two``: lane pairs ``(0, 1), (2,
3), ...``, not Llama's halves), with Flax's ``create_sinusoidal_positions``
table (NumPy: the angles in f32, their sine and cosine in f32).  The
rotated lanes are f32 (a bf16 query times the f32 table), then the query
and key go back to the products' dtype.  ``rotary_dim: null`` turns a
table as wide as the whole hidden state, which Flax can apply only with
one head: with more it fails, and the port refuses it by name.  Parameter
names are those of the Flax tree; its Dense kernels are transposed on the
way in (``svs_tpu_torch.convert``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .bert import Embedding, LayerNorm, Linear, activation
from .gpt2 import attend, causal_allowed, check_length, check_widths, config_of

MODEL_TYPES = ("gptj",)
#: ``GPTJConfig``'s defaults for the keys read here (EleutherAI/gpt-j-6b's
#: widths).
DEFAULTS: Dict[str, Any] = {
    "vocab_size": 50400, "n_positions": 2048, "n_embd": 4096, "n_layer": 28, "n_head": 16,
    "rotary_dim": 64, "n_inner": None, "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-5,
}
ALIASES = {"max_position_embeddings": "n_positions", "hidden_size": "n_embd",
           "num_attention_heads": "n_head", "num_hidden_layers": "n_layer"}


def _cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    return config_of(config, DEFAULTS, ALIASES)


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    if config.get("model_type") not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not gptj")
    c = _cfg(config)
    h, heads = int(c["n_embd"]), int(c["n_head"])
    check_widths("gptj", h, heads)
    activation(c["activation_function"])
    rd = c["rotary_dim"]
    if rd is None:
        if heads != 1:
            raise NotImplementedError(
                f"rotary_dim null with n_head {heads}: Flax's table is n_embd wide and "
                "its product with a head fails"
            )
    elif int(rd) % 2 or not 0 < int(rd) <= h // heads:
        raise NotImplementedError(
            f"rotary_dim {rd} is not an even width of at most the head width {h // heads} "
            "(Flax's gptj fails on it)"
        )


def sinusoidal_positions(positions: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``0 .. positions-1`` of Flax's ``create_sinusoidal_positions``:
    ``(sin, cos)``, each ``[positions, width // 2]`` f32."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, width, 2) / width))
    angles = np.einsum("i , j -> i j", np.arange(positions), inv_freq).astype("float32")
    return torch.from_numpy(np.sin(angles)), torch.from_numpy(np.cos(angles))


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    return torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).flatten(-2)


class _Attention(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h, self.heads = int(c["n_embd"]), int(c["n_head"])
        self.rotary = int(c["rotary_dim"] or h)
        self.q_proj = Linear(h, h, bias=False)
        self.k_proj = Linear(h, h, bias=False)
        self.v_proj = Linear(h, h, bias=False)
        self.out_proj = Linear(h, h, bias=False)

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                allowed: torch.Tensor) -> torch.Tensor:
        b, n, h = x.shape
        shape = (b, n, self.heads, h // self.heads)
        q, k, v = self.q_proj(x).view(shape), self.k_proj(x).view(shape), self.v_proj(x).view(shape)
        r = self.rotary

        def turn(t: torch.Tensor) -> torch.Tensor:
            head = t[..., :r]
            turned = head * cos + _rotate_every_two(head) * sin  # f32, as Flax promotes
            return torch.cat([turned, t[..., r:].to(turned.dtype)], dim=-1).to(v.dtype)

        return self.out_proj(attend(turn(q), turn(k), v, allowed))


class _MLP(nn.Module):
    def __init__(self, hidden: int, inner: int, act: str) -> None:
        super().__init__()
        self.fc_in = Linear(hidden, inner)
        self.fc_out = Linear(inner, hidden)
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.act(self.fc_in(x)))


class _Block(nn.Module):
    def __init__(self, c: Dict[str, Any]) -> None:
        super().__init__()
        h = int(c["n_embd"])
        self.ln_1 = LayerNorm(h, float(c["layer_norm_epsilon"]))
        self.attn = _Attention(c)
        self.mlp = _MLP(h, int(c["n_inner"] or 4 * h), c["activation_function"])

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                allowed: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x)
        return self.attn(y, sin, cos, allowed) + self.mlp(y) + x


class GPTJEncoder(nn.Module):
    """``last_hidden_state`` of a ``gptj`` ``config.json`` (see the module
    docstring for what Flax computes)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        check_config(config)
        c = self.c = _cfg(config)
        self.config = dict(config)
        h = int(c["n_embd"])
        self.wte = Embedding(c["vocab_size"], h)
        self.h = nn.ModuleList(_Block(c) for _ in range(int(c["n_layer"])))
        self.ln_f = LayerNorm(h, float(c["layer_norm_epsilon"]))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` ids and 0/1 mask -> ``[B, L, n_embd]``."""
        n = input_ids.shape[1]
        check_length(n, int(self.c["n_positions"]), "n_positions")
        sin, cos = sinusoidal_positions(n, int(self.c["rotary_dim"] or self.c["n_embd"]))
        # [L, 1, rotary]: each angle on its lane pair, broadcast over the heads
        sin = sin.repeat_interleave(2, dim=-1)[:, None].to(input_ids.device)
        cos = cos.repeat_interleave(2, dim=-1)[:, None].to(input_ids.device)
        x = self.wte(input_ids)
        allowed = causal_allowed(attention_mask)
        for block in self.h:
            x = block(x, sin, cos, allowed)
        return self.ln_f(x)
