"""Pegasus (``transformers``' ``FlaxPegasusModel``) on :mod:`.seq2seq`'s
stack.

Positions come from Marian's fixed sinusoidal table
(:func:`.seq2seq.sinusoidal_positions`: the sines in the first half, the
cosines in the second, ``modeling_flax_pegasus.py:224-233``; not XGLM's
table), read from row 0 with no offset and cast to the embeddings' dtype;
there is no position parameter and no ``layernorm_embedding``.  The layers
are pre-LN with a final ``layer_norm`` on each stack, and the decoder
starts from ``decoder_start_token_id`` 0, the pad id.
"""

from __future__ import annotations

from typing import Any, Dict

from .seq2seq import Layout, Seq2SeqEncoder, cfg_of, check

MODEL_TYPES = ("pegasus",)
#: ``PegasusConfig``'s defaults for the keys read here.
DEFAULTS: Dict[str, Any] = {
    "vocab_size": 50265, "max_position_embeddings": 1024, "d_model": 1024,
    "encoder_layers": 12, "decoder_layers": 12, "encoder_attention_heads": 16,
    "decoder_attention_heads": 16, "encoder_ffn_dim": 4096, "decoder_ffn_dim": 4096,
    "activation_function": "gelu", "scale_embedding": False, "pad_token_id": 0,
    "decoder_start_token_id": 0,
}
LAYOUT = Layout(positions="sinusoidal", pre_ln=True)


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    if config.get("model_type") not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {config.get('model_type')!r} is not pegasus")
    check("pegasus", cfg_of(config, DEFAULTS), LAYOUT)


class PegasusEncoder(Seq2SeqEncoder):
    """The decoder's ``last_hidden_state`` of a ``pegasus``
    ``config.json``."""

    def __init__(self, config: Dict[str, Any]) -> None:
        check_config(config)
        super().__init__(config, DEFAULTS, LAYOUT)
