"""BART and mBART (``transformers``' ``FlaxBartModel``,
``FlaxMBartModel``) on :mod:`.seq2seq`'s stack.

Both read learned positions at ``position + 2`` (Flax's ``offset``: the
tables have ``max_position_embeddings + 2`` rows, ``modeling_flax_bart.py:
708-712``) and apply ``layernorm_embedding`` to the embeddings plus
positions.  BART's layers are post-LN and its decoder starts from
``decoder_start_token_id`` (2, ``</s>``); mBART's are pre-LN with a final
``layer_norm`` on each stack (``modeling_flax_mbart.py:733-734``) and its
decoder starts from each row's own language code
(:func:`.seq2seq.shift_right_wrapped`).  ``scale_embedding`` (false by
default, true in ``facebook/mbart-large-*``) multiplies the token
embeddings by ``sqrt(d_model)``.
"""

from __future__ import annotations

from typing import Any, Dict

from .seq2seq import Layout, Seq2SeqEncoder, cfg_of, check

MODEL_TYPES = ("bart", "mbart")
#: ``BartConfig``'s and ``MBartConfig``'s defaults for the keys read here
#: (facebook/bart-large's widths).
_COMMON = {
    "vocab_size": 50265, "max_position_embeddings": 1024, "d_model": 1024,
    "encoder_layers": 12, "decoder_layers": 12, "encoder_attention_heads": 16,
    "decoder_attention_heads": 16, "encoder_ffn_dim": 4096, "decoder_ffn_dim": 4096,
    "activation_function": "gelu", "scale_embedding": False, "pad_token_id": 1,
}
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "bart": {**_COMMON, "decoder_start_token_id": 2},
    "mbart": {**_COMMON, "decoder_start_token_id": None},
}
LAYOUTS = {
    "bart": Layout(offset=2, embedding_norm="after_positions"),
    "mbart": Layout(offset=2, pre_ln=True, embedding_norm="after_positions", wrapped_shift=True),
}


def check_config(config: Dict[str, Any]) -> None:
    """Refuse, naming it, what Flax does not compute or fails on."""
    kind = config.get("model_type")
    if kind not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {kind!r} is not bart or mbart")
    check(kind, cfg_of(config, DEFAULTS[kind]), LAYOUTS[kind])


class BartEncoder(Seq2SeqEncoder):
    """The decoder's ``last_hidden_state`` of a ``bart`` or ``mbart``
    ``config.json``."""

    def __init__(self, config: Dict[str, Any]) -> None:
        check_config(config)
        kind = config["model_type"]
        super().__init__(config, DEFAULTS[kind], LAYOUTS[kind])
