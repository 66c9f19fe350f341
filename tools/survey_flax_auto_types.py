"""Which of ``FlaxAutoModel``'s decoder-only and encoder-decoder model
types ``svs_tpu``'s local provider embeds with, on the CPU.

For each type: a tiny seeded Flax checkpoint (``FlaxAutoModel.from_config``)
and a byte-level BPE ``tokenizer.json`` saved by the type's own fast
tokenizer class, first with the class's default special tokens and then
with a pad token set (``AutoTokenizer(..., padding='max_length')`` needs
one); then ``svs_tpu.embeddings.make_local_embeddings_func`` on two texts.
Prints one line per type: ``ok`` or the exception that stopped it, for
each tokenizer.

    JAX_PLATFORMS=cpu python3 tools/survey_flax_auto_types.py

Needs ``transformers``, ``tokenizers``, ``flax`` and ``svs_tpu``'s
dependencies (the CPU test environment, not the machine with the card).
"""

import asyncio
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

W = 32  # every width of the tiny checkpoints
#: type -> (config keywords, fast tokenizer class)
TYPES = {
    "gpt2": (dict(n_embd=W, n_layer=1, n_head=2), "GPT2TokenizerFast"),
    "gpt_neo": (dict(hidden_size=W, num_layers=1, num_heads=2, attention_types=[[["global"], 1]]),
                "GPT2TokenizerFast"),
    "gptj": (dict(n_embd=W, n_layer=1, n_head=2, rotary_dim=8), "GPT2TokenizerFast"),
    "opt": (dict(hidden_size=W, num_hidden_layers=1, num_attention_heads=2, ffn_dim=64,
                 word_embed_proj_dim=W), "GPT2TokenizerFast"),
    "bloom": (dict(hidden_size=W, n_layer=1, n_head=2), "BloomTokenizerFast"),
    "xglm": (dict(d_model=W, num_layers=1, attention_heads=2, ffn_dim=64), "XGLMTokenizerFast"),
    "llama": (dict(hidden_size=W, intermediate_size=64, num_hidden_layers=1,
                   num_attention_heads=2, num_key_value_heads=2), "LlamaTokenizerFast"),
    "mistral": (dict(hidden_size=W, intermediate_size=64, num_hidden_layers=1,
                     num_attention_heads=2, num_key_value_heads=2), "LlamaTokenizerFast"),
    "gemma": (dict(hidden_size=W, intermediate_size=64, num_hidden_layers=1,
                   num_attention_heads=2, num_key_value_heads=2, head_dim=16),
              "GemmaTokenizerFast"),
    "t5": (dict(d_model=W, d_ff=64, num_layers=1, num_heads=2, d_kv=16), "T5TokenizerFast"),
    "mt5": (dict(d_model=W, d_ff=64, num_layers=1, num_heads=2, d_kv=16), "T5TokenizerFast"),
    "longt5": (dict(d_model=W, d_ff=64, num_layers=1, num_heads=2, d_kv=16), "T5TokenizerFast"),
}
_SEQ2SEQ = dict(d_model=W, encoder_layers=1, decoder_layers=1, encoder_attention_heads=2,
                decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64)
for name, tok in (("bart", "BartTokenizerFast"), ("mbart", "MBartTokenizerFast"),
                  ("marian", "PreTrainedTokenizerFast"), ("pegasus", "PegasusTokenizerFast"),
                  ("blenderbot", "BlenderbotTokenizerFast"),
                  ("blenderbot-small", "BlenderbotSmallTokenizerFast")):
    TYPES[name] = (dict(_SEQ2SEQ), tok)


def tokenizer_object():
    from tokenizers import ByteLevelBPETokenizer

    bt = ByteLevelBPETokenizer()
    specials = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    bt.train_from_iterator(["the cat sat on the mat", "a dog ran fast"] * 20, vocab_size=300,
                           min_frequency=1, special_tokens=specials, show_progress=False)
    return bt._tokenizer


def survey(name: str, root: Path) -> list:
    import transformers as T

    from svs_tpu.embeddings import make_local_embeddings_func

    kw, tok_class = TYPES[name]
    out = []
    for pad in (None, "<pad>"):
        path = root / f"{name}-{pad is not None}"
        tok_kw = {} if pad is None else {"pad_token": pad}
        try:
            tok = getattr(T, tok_class)(tokenizer_object=tokenizer_object(), **tok_kw)
            tok.save_pretrained(str(path), legacy_format=False)
            config = T.AutoConfig.for_model(name, vocab_size=len(tok), pad_token_id=1, **kw)
            T.FlaxAutoModel.from_config(config, seed=0).save_pretrained(str(path))
            fn = make_local_embeddings_func(str(path), max_length=8, compute_dtype="float32")
            vecs = asyncio.run(fn(["the cat", "a dog ran"]))
            out.append(f"ok ({len(vecs)} x {len(vecs[0])})")
        except Exception as exc:  # the survey reports what stopped each type
            first = (str(exc).splitlines() or [""])[0]
            out.append(f"{type(exc).__name__}: {first[:90]}")
    return out


def main() -> int:
    import transformers as T

    T.logging.set_verbosity_error()
    with tempfile.TemporaryDirectory() as tmp:
        for name in sys.argv[1:] or TYPES:
            default, padded = survey(name, Path(tmp))
            print(f"{name}: class defaults: {default} | with a pad token: {padded}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
