"""Blenderbot and Blenderbot-small (``transformers``'
``FlaxBlenderbotModel``, ``FlaxBlenderbotSmallModel``) on
:mod:`.seq2seq`'s stack.

Both read learned positions from row 0 (no offset) and start the decoder
from ``decoder_start_token_id`` (1, ``<s>`` / ``__start__``).  Blenderbot's
layers are pre-LN with a final ``layer_norm`` on each stack and no
``layernorm_embedding`` (``modeling_flax_blenderbot.py:664-700``).
Blenderbot-small's are post-LN; its encoder applies
``layernorm_embedding`` to the embeddings plus positions, its decoder to
the token embeddings before the positions are added
(``modeling_flax_blenderbot_small.py:766-778``).
"""

from __future__ import annotations

from typing import Any, Dict

from .seq2seq import Layout, Seq2SeqEncoder, cfg_of, check

MODEL_TYPES = ("blenderbot", "blenderbot-small")
#: ``BlenderbotConfig``'s defaults (facebook/blenderbot-3B's widths and
#: depth) and ``BlenderbotSmallConfig``'s, for the keys read here.
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "blenderbot": {
        "vocab_size": 8008, "max_position_embeddings": 128, "d_model": 2560,
        "encoder_layers": 2, "decoder_layers": 24, "encoder_attention_heads": 32,
        "decoder_attention_heads": 32, "encoder_ffn_dim": 10240, "decoder_ffn_dim": 10240,
        "activation_function": "gelu", "scale_embedding": False, "pad_token_id": 0,
        "decoder_start_token_id": 1,
    },
    "blenderbot-small": {
        "vocab_size": 50265, "max_position_embeddings": 512, "d_model": 512,
        "encoder_layers": 8, "decoder_layers": 8, "encoder_attention_heads": 16,
        "decoder_attention_heads": 16, "encoder_ffn_dim": 2048, "decoder_ffn_dim": 2048,
        "activation_function": "gelu", "scale_embedding": False, "pad_token_id": 0,
        "decoder_start_token_id": 1,
    },
}
LAYOUTS = {
    "blenderbot": Layout(pre_ln=True),
    "blenderbot-small": Layout(embedding_norm="encoder_after_decoder_before"),
}


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    kind = config.get("model_type")
    if kind not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {kind!r} is not blenderbot or blenderbot-small")
    check(kind, cfg_of(config, DEFAULTS[kind]), LAYOUTS[kind])


class BlenderbotEncoder(Seq2SeqEncoder):
    """The decoder's ``last_hidden_state`` of a ``blenderbot`` or
    ``blenderbot-small`` ``config.json``."""

    def __init__(self, config: Dict[str, Any]) -> None:
        check_config(config)
        kind = config["model_type"]
        super().__init__(config, DEFAULTS[kind], LAYOUTS[kind])
