"""The port's BigBird encoder (``svs_tpu_torch.embeddings.big_bird``)
against ``transformers``' Flax BigBird, which ``svs_tpu``'s local provider
runs, on the CPU.

At a width of 32 (2 heads), ``block_size`` 16 and ``num_random_blocks``
1-3: the block-sparse attention layer alone, with the same weights,
against ``FlaxBigBirdBlockSparseAttention`` at L = 64, 128, 512 and 1,024
(the paper's plan) with padded rows, within 1e-5; the whole provider
(2 layers, a SentencePiece ``tokenizer.json`` in BigBird's layout) in f32
(within 1e-5) and bf16 (within ``BF16_ATOL``), block-sparse and
``original_full`` (with ``rescale_embeddings``); the shapes the reference
refuses (under four blocks, for every ``num_random_blocks``; a length that
is not a multiple of the block) raise in the port exactly there, and every
other shape runs; a head model's checkpoint unwraps from ``bert``; the
smoke's random-checkpoint writer; and a store that ``svs_tpu.KB`` wrote
with a BigBird provider reopens in the port with no function and returns
the same ids."""

import asyncio
import json
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

import svs_tpu
from svs_tpu.embeddings import make_local_embeddings_func as ref_local
from svs_tpu_torch import KB
from svs_tpu_torch.convert import bert_state_dict_from_flax, encoder_state_dict_from_flax
from svs_tpu_torch.embeddings import big_bird, checkpoint
from svs_tpu_torch.embeddings.local import make_local_embeddings_func

from torch_tokenizer_helpers import write_sentencepiece_tokenizer

torch.set_num_threads(2)

F32_ATOL = 1e-5
#: as ``tests/test_torch_local_encoders.py``'s: bf16 on both sides, each
#: rounding its products at its own places.
BF16_ATOL = {True: 1e-2, False: 5e-2}
BLOCK = 16
WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "fast", "hello", "world",
         "мир", "κόσμε", "中文", "café", "big", "small"]


def _texts(n=6, seed=0):
    """Short and long texts: some fill a block or two, one passes 512
    tokens, one is empty (a padded row of two tokens)."""
    rng = np.random.default_rng(seed)
    out = ["", "the cat sat on the mat"]
    for k in (30, 90, 250, 700)[: n - 2]:
        out.append(" ".join(rng.choice(WORDS, k)))
    return out


def _config(**kw):
    import transformers as T

    base = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, max_position_embeddings=1024, block_size=BLOCK,
                num_random_blocks=3, attention_type="block_sparse")
    return T.BigBirdConfig(**{**base, **kw})


def _seeded(cls, config, seed):
    """``cls`` from a seed.  Both attention types hold the same parameters,
    so the model is initialised with full attention (block-sparse
    initialisation traces a 12-block input, seconds on the CPU) and saved
    with the config's own type."""
    kind = config.attention_type
    config.attention_type = "original_full"
    model = cls(config, seed=seed)
    model.config.attention_type = kind
    return model


def _write(path, seed=7, **kw):
    import transformers as T

    T.logging.set_verbosity_error()
    vocab = write_sentencepiece_tokenizer(path, "big_bird", seed=5)
    _seeded(T.FlaxBigBirdModel, _config(vocab_size=vocab, **kw), seed).save_pretrained(str(path))
    return path


@pytest.fixture(scope="module")
def sparse(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("bigbird_sparse"))


def _embed(factory, path, texts, **kw):
    fn = factory(str(path), **kw)
    return np.asarray(asyncio.run(fn(list(texts))), np.float32)


# -- the attention layer alone ---------------------------------------------------


def _flax_layer(n_rand, seed):
    """A ``FlaxBigBirdBlockSparseAttention``, seeded parameters for it
    (query / key / value Dense layers) and the port's layer holding the
    same weights."""
    from transformers.models.big_bird.modeling_flax_big_bird import (
        FlaxBigBirdBlockSparseAttention,
    )

    cfg = _config(vocab_size=10, num_random_blocks=n_rand)
    rng = np.random.default_rng(seed)
    params = {name: {"kernel": rng.standard_normal((32, 32)).astype(np.float32) * 0.3,
                     "bias": rng.standard_normal(32).astype(np.float32) * 0.1}
              for name in ("query", "key", "value")}
    port = big_bird.BlockSparseSelfAttention(cfg.to_dict())
    port.load_state_dict(bert_state_dict_from_flax(params), strict=True)
    return FlaxBigBirdBlockSparseAttention(cfg), params, port


@pytest.mark.parametrize("n_rand", [1, 2, 3])
@pytest.mark.parametrize("seq_len", [64, 128, 512, 1024])
def test_block_sparse_layer_equals_flax(seq_len, n_rand):
    """The attention output, padded rows included (zero in both), within
    1e-5 of Flax's; L = 1,024 takes the paper's plan."""
    layer, params, port = _flax_layer(n_rand, seed=seq_len + n_rand)
    rng = np.random.default_rng(seq_len * 10 + n_rand)
    x = rng.standard_normal((3, seq_len, 32)).astype(np.float32)
    mask = np.ones((3, seq_len), np.int32)
    mask[1, int(seq_len * 0.6):] = 0  # a padded row, cut inside a block
    mask[2, 2:] = 0  # two real tokens, as an empty text
    import jax

    apply = jax.jit(lambda p, x, m: layer.apply({"params": p}, x, m, deterministic=True)[0])
    want = np.asarray(apply(params, x, mask))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask).float()).numpy()
    assert got.shape == want.shape == (3, seq_len, 32)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    assert not got[1, int(seq_len * 0.6):].any() and not got[2, 2:].any()


def test_random_blocks_are_block_zero_in_inference():
    """Both of Flax's plans are zeros when deterministic: every random
    block is key block 0 (at the paper's lengths and off them)."""
    for seq_len in (128, 512, 1024, 4096):
        plan = big_bird.random_plan(seq_len, 64 if seq_len >= 1024 else BLOCK, 3, 4096)
        assert plan.shape[1] == 3 and not plan.any()
    with pytest.raises(NotImplementedError, match="blocks"):
        big_bird.random_plan(1024, BLOCK, 3, 512)  # a paper plan too short for 64 blocks


# -- the provider ------------------------------------------------------------------


@pytest.mark.parametrize("max_length", [64, 512, 1024])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_f32_block_sparse_provider_matches_svs_tpu(sparse, max_length, pooling):
    kw = dict(pooling=pooling, max_length=max_length, compute_dtype="float32")
    want = _embed(ref_local, sparse, _texts(), **kw)
    got = _embed(make_local_embeddings_func, sparse, _texts(), device="cpu", **kw)
    assert got.shape == want.shape == (6, 32)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
def test_bf16_block_sparse_provider_matches_svs_tpu(sparse, normalize):
    kw = dict(max_length=512, normalize=normalize)
    want = _embed(ref_local, sparse, _texts(), **kw)
    got = _embed(make_local_embeddings_func, sparse, _texts(), device="cpu", **kw)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL[normalize], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_original_full_provider_matches_svs_tpu(tmp_path, dtype):
    """``attention_type='original_full'`` is BERT's attention over BigBird's
    embeddings (positions from 0 whatever the pad id, the word embeddings
    rescaled by sqrt(hidden))."""
    path = _write(tmp_path / "full", seed=9, attention_type="original_full",
                  rescale_embeddings=True)
    kw = dict(max_length=48, compute_dtype=dtype, pooling="mean")
    want = _embed(ref_local, path, _texts(), **kw)
    got = _embed(make_local_embeddings_func, path, _texts(), device="cpu", **kw)
    np.testing.assert_allclose(got, want, atol=F32_ATOL if dtype == "float32" else BF16_ATOL[True],
                               rtol=0)


@pytest.mark.parametrize("n_rand", [1, 2, 3])
def test_block_counts_the_reference_refuses_raise_in_the_port(tmp_path, n_rand):
    """Over 2-5 blocks of 16 tokens (``max_length`` 32-80): where
    ``svs_tpu``'s provider fails (under four blocks, whatever
    ``num_random_blocks``; its layer alone runs every count from 4 up, as
    above), the port raises ``NotImplementedError`` naming the block count;
    at four and five blocks both run and agree."""
    path = _write(tmp_path / f"r{n_rand}", seed=11 + n_rand, num_hidden_layers=1,
                  num_random_blocks=n_rand)
    texts = _texts(5, seed=n_rand)
    refused = []
    for blocks in range(2, 6):
        kw = dict(max_length=blocks * BLOCK, compute_dtype="float32", batch_size=8)
        try:
            want = _embed(ref_local, path, texts, **kw)
        except (ZeroDivisionError, TypeError):
            refused.append(blocks)
            with pytest.raises(NotImplementedError, match=f"over {blocks} blocks of block_size 16"):
                _embed(make_local_embeddings_func, path, texts, device="cpu", **kw)
            continue
        got = _embed(make_local_embeddings_func, path, texts, device="cpu", **kw)
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    assert refused == [2, 3]
    if n_rand > 1:
        return
    with pytest.raises(ValueError, match="multiple of block size"):
        _embed(ref_local, path, texts, max_length=72)
    with pytest.raises(ValueError, match="multiple of block size"):
        _embed(make_local_embeddings_func, path, texts, device="cpu", max_length=72)


def test_head_checkpoint_unwraps_from_bert(sparse, tmp_path):
    """A head model's checkpoint holds BigBird under ``bert`` (its
    ``base_model_prefix``): the port reads the base model that
    ``FlaxAutoModel`` reads."""
    import transformers as T

    cfg = json.loads((sparse / "config.json").read_text())
    head = _seeded(T.FlaxBigBirdForMaskedLM, _config(vocab_size=cfg["vocab_size"]), 3)
    path = tmp_path / "head"
    shutil.copytree(sparse, path)
    (path / "flax_model.msgpack").unlink()
    head.save_pretrained(str(path))
    config, params = checkpoint.load_checkpoint(path)
    assert "embeddings" in params
    sd = encoder_state_dict_from_flax(config, params)
    np.testing.assert_array_equal(
        sd["encoder.layer.1.attention.self.query.weight"].numpy(),
        np.asarray(head.params["bert"]["encoder"]["layer"]["1"]["attention"]["self"]["query"]["kernel"]).T)
    kw = dict(compute_dtype="float32", pooling="cls", max_length=64)
    np.testing.assert_allclose(_embed(make_local_embeddings_func, path, _texts(), device="cpu", **kw),
                               _embed(ref_local, path, _texts(), **kw), atol=F32_ATOL, rtol=0)


def test_smoke_checkpoint_writer_reads_in_transformers(sparse, tmp_path):
    """``chip_smoke.write_random_encoder`` writes a BigBird tree (the
    pooler a flat Dense) that ``FlaxAutoModel`` reads as the port does."""
    import chip_smoke

    path = tmp_path / "smoke"
    shutil.copytree(sparse, path)
    (path / "flax_model.msgpack").unlink()
    cfg = {k: v for k, v in json.loads((sparse / "config.json").read_text()).items()
           if k != "architectures"}
    chip_smoke.write_random_encoder(path, cfg, seed=5)
    kw = dict(compute_dtype="float32", pooling="mean", max_length=128)
    np.testing.assert_allclose(_embed(make_local_embeddings_func, path, _texts(), device="cpu", **kw),
                               _embed(ref_local, path, _texts(), **kw), atol=F32_ATOL, rtol=0)


def test_svs_tpu_big_bird_store_reopens_in_the_port(sparse, tmp_path):
    """A store written by ``svs_tpu.KB`` with a block-sparse BigBird
    provider (f32, ``max_length`` 128) opens in the port with NO function
    and returns the reference's ids and scores."""
    db = tmp_path / "bigbird.sqlite"
    kb = svs_tpu.KB(db, ref_local(str(sparse), max_length=128, compute_dtype="float32"))
    docs = _texts(6, seed=1) + ["happy cat", "big small dog", "мир κόσμε", "中文 café"]
    with kb.bulk_add_docs() as add:
        for d in docs:
            add(d)
    queries = ["cat", "мир", "dog ran", "中文"]
    want = kb.retrieve_batch(queries, 4)
    kb.close()
    port = KB(db, device="cpu")
    try:
        assert port.embedding_func.__embedding_func_params__["max_length"] == 128
        got = port.retrieve_batch(queries, 4)
    finally:
        port.close()
    assert [[h["doc"]["id"] for h in r] for r in got] == [[h["doc"]["id"] for h in r] for r in want]
    np.testing.assert_allclose([[h["score"] for h in r] for r in got],
                               [[h["score"] for h in r] for r in want], atol=F32_ATOL)
