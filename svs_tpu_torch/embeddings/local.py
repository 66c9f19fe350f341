"""Local embedding provider: run an encoder on this machine's card (port
of ``svs_tpu.embeddings.local``).

``svs_tpu`` loads a Flax checkpoint through ``transformers``
(``AutoTokenizer``, ``FlaxAutoModel``) and runs it under ``jax.jit``.  The
port reads the same files with no ``transformers``, ``tokenizers`` or
``flax`` (the machine with the card has none of them):

- the tokenizer, in the order ``AutoTokenizer`` finds one
  (:func:`.tokenizer_json.load_tokenizer`): ``tokenizer.json`` through
  :mod:`.tokenizer_json` (WordPiece, byte-level BPE, SentencePiece-style
  BPE with byte fallback, or Unigram, with the ``Precompiled``
  normalizer; Llama's and Gemma's left padding; the GPT-2, BLOOM, XGLM,
  BART, mBART, Pegasus and Blenderbot classes' special tokens), else
  ``vocab.txt`` through :mod:`.wordpiece`, else ``vocab.json`` +
  ``merges.txt`` through :mod:`.bpe` (RoBERTa's, BART's, Blenderbot's); a
  SentencePiece model alone is refused;
- the weights from ``flax_model.msgpack``, or from the shards of a
  ``flax_model.msgpack.index.json`` read one at a time, through
  :mod:`.checkpoint` and ``convert.encoder_state_dict_from_flax``;
- the encoder by ``model_type`` (:func:`.encoders.build_encoder`):
  ``bert`` (``bge-*-en-v1.5``, ``all-MiniLM-L6-v2``), ``xlm-roberta``
  (``bge-m3``, ``multilingual-e5-*``), ``roberta``
  (``all-distilroberta-v1``), ``distilbert`` (``msmarco-distilbert-*``),
  ``electra``, ``albert``, ``roberta-prelayernorm``, ``big_bird``, and
  the decoders ``llama``, ``mistral`` (``e5-mistral-7b-instruct``),
  ``gemma``, ``gpt2``, ``gpt_neo`` (SGPT-1.3B / 2.7B), ``gptj``
  (SGPT-5.8B), ``bloom`` (``sgpt-bloom-7b1-msmarco``) and ``xglm`` (their
  last hidden state pooled as an encoder's, CLS being position 0, a pad on
  a left-padded row, as in the reference), and the encoder-decoders
  ``bart``, ``mbart``, ``pegasus``, ``blenderbot`` and ``blenderbot-small``
  (the decoder's last hidden state, its inputs the ids shifted right,
  pooled under the encoder's mask); any other type raises
  ``NotImplementedError`` naming it, before the weights are read.

Kept from the reference: the factory's signature and validation, the
persisted params (``provider``, ``model``, ``pooling``, ``max_length``,
``compute_dtype``, ``normalize``), the power-of-two batch buckets (each
chunk padded with empty texts to its bucket, ``padding='max_length'``),
mask-weighted mean or CLS pooling then L2 normalisation in f32, and the
result LRU on the encoder (single-flight under its lock).

``compute_dtype='bfloat16'`` runs under ``torch.autocast`` in bf16 with
the parameters kept in f32 (as Flax's ``dtype=`` keeps them);
``'float32'`` runs in true f32 (TF32 off).  ``device=`` (default
``'cuda'``; the CPU only when asked for) is not persisted: the port's
``KB`` passes its own device when it rebuilds the provider from a
database's params.  A ``model`` that is not a directory resolves only
through the local Hugging Face cache; nothing is downloaded.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..types import EmbeddingFunc
from .base import EMBEDDINGS_MAX_CACHE_SIZE

_POOLINGS = ("mean", "cls")


def _buckets(batch_size: int) -> List[int]:
    """Power-of-two padding buckets up to ``batch_size`` (ascending);
    the last bucket always equals ``batch_size`` so every chunk fits."""
    out = [1]
    while out[-1] < batch_size:
        out.append(min(out[-1] * 2, batch_size))
    return out


class _LocalEncoder:
    """Lazily-loaded tokenizer + encoder with a bucketed forward pass.
    One instance per provider factory call; the checkpoint is read on the
    first ``embed``."""

    def __init__(
        self,
        model: str,
        pooling: str,
        max_length: int,
        compute_dtype: str,
        normalize: bool,
        batch_size: int,
        device: torch.device,
    ) -> None:
        self.model_name = model
        self.pooling = pooling
        self.max_length = max_length
        self.compute_dtype = compute_dtype
        self.normalize = normalize
        self.batch_size = batch_size
        self.device = device
        self._loaded: Optional[Tuple[Any, torch.nn.Module]] = None
        # a threading lock: one provider may serve several KBs on several
        # event loops, and embed() runs in an executor.  The result LRU
        # lives here, so the weights and the cache die with the provider.
        self._lock = threading.Lock()
        self._cache: "OrderedDict[Tuple[str, ...], np.ndarray]" = OrderedDict()
        #: Host-clock seconds spent tokenizing and in the forward pass
        #: (launch to result on the host), and the texts embedded; the
        #: load's reading of the checkpoint (and its conversion to the
        #: encoder's tensors) and its upload to the device.
        self.stats: Dict[str, float] = {"tokenize_s": 0.0, "forward_s": 0.0, "texts": 0,
                                        "read_s": 0.0, "upload_s": 0.0}

    def _load(self) -> Tuple[Any, torch.nn.Module]:
        if self._loaded is not None:
            return self._loaded
        from ..convert import encoder_state_dict_from_flax
        from .checkpoint import load_checkpoint, read_config, resolve_model_dir
        from .encoders import check_config, load_encoder
        from .tokenizer_json import load_tokenizer

        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the local embedding provider runs on a CUDA device and none "
                "is available; pass device='cpu' explicitly for a CPU run"
            )
        model_dir = resolve_model_dir(self.model_name)
        config = read_config(model_dir)
        check_config(config)  # before reading the weights
        tokenizer = load_tokenizer(model_dir, config.get("model_type"))
        t = time.perf_counter()
        config, params = load_checkpoint(model_dir)
        encoder = load_encoder(config, encoder_state_dict_from_flax(config, params))
        del params
        t1 = time.perf_counter()
        encoder = encoder.to(self.device).eval()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["read_s"] = t1 - t
        self.stats["upload_s"] = time.perf_counter() - t1
        self._loaded = (tokenizer, encoder)
        return self._loaded

    def embed(self, texts: Tuple[str, ...]) -> np.ndarray:
        """Tokenize + forward ``texts`` in bucketed batches; returns
        ``[len(texts), dim]`` float32.  Synchronous — callers run it in an
        executor; the lock serializes load + forward per encoder and makes
        identical concurrent requests single-flight through the LRU."""
        with self._lock:
            hit = self._cache.get(texts)
            if hit is not None:
                self._cache.move_to_end(texts)
                return hit
            out = self._embed_locked(texts)
            self._cache[texts] = out
            while len(self._cache) > EMBEDDINGS_MAX_CACHE_SIZE:
                self._cache.popitem(last=False)
            return out

    def _precision(self) -> contextlib.AbstractContextManager:
        if self.compute_dtype == "bfloat16":
            return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16)
        from ..ops.topk import exact_f32

        return exact_f32()

    def forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Pooled (and normalised) f32 vectors ``[B, hidden]`` on the
        device for one tokenized batch."""
        _, encoder = self._load()
        ids_t = torch.from_numpy(ids).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        with torch.inference_mode():
            with self._precision():
                hidden = encoder(ids_t, mask_t)
            hidden = hidden.float()
            if self.pooling == "cls":
                vec = hidden[:, 0, :]
            else:  # mask-weighted mean over real tokens
                m = mask_t.to(torch.float32)[:, :, None]
                vec = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
            if self.normalize:
                vec = vec / torch.linalg.vector_norm(vec, dim=1, keepdim=True).clamp_min(1e-12)
        return vec

    def _embed_locked(self, texts: Tuple[str, ...]) -> np.ndarray:
        tokenizer, _ = self._load()
        vecs: List[np.ndarray] = []
        buckets = _buckets(self.batch_size)
        i = 0
        while i < len(texts):
            chunk = list(texts[i : i + self.batch_size])
            i += len(chunk)
            bucket = next(b for b in buckets if b >= len(chunk))
            t = time.perf_counter()
            ids, mask = tokenizer.batch(chunk + [""] * (bucket - len(chunk)), self.max_length)
            t1 = time.perf_counter()
            vecs.append(self.forward(ids, mask)[: len(chunk)].cpu().numpy())
            self.stats["tokenize_s"] += t1 - t
            self.stats["forward_s"] += time.perf_counter() - t1
            self.stats["texts"] += len(chunk)
        if not vecs:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(vecs, axis=0)


def make_local_embeddings_func(
    model: str,
    pooling: str = "mean",
    max_length: int = 128,
    compute_dtype: str = "bfloat16",
    normalize: bool = True,
    batch_size: int = 128,
    *,
    device: Union[str, torch.device] = "cuda",
) -> EmbeddingFunc:
    """Build an on-device embedding function from a Flax encoder
    checkpoint (see the module docstring for the model types and
    tokenizer files).

    ``model`` is a local directory holding ``config.json``,
    ``flax_model.msgpack`` (or ``flax_model.msgpack.index.json`` and its
    shards) and a tokenizer (``tokenizer.json``, or
    ``vocab.txt``, or ``vocab.json`` + ``merges.txt``, with
    ``tokenizer_config.json``), or a hub name already in the local Hugging
    Face cache.  ``pooling`` is
    ``'mean'`` (mask-weighted token mean) or ``'cls'``.  ``compute_dtype``
    selects the forward pass's precision (``'bfloat16'`` for the tensor
    cores' rate, ``'float32'`` for exactness) and is part of the provider
    identity — it changes the produced vectors.  ``batch_size`` and the
    power-of-two padding buckets only affect throughput.  ``device`` is
    where the encoder runs; it is not persisted.
    """
    if pooling not in _POOLINGS:
        raise ValueError(
            f"pooling must be one of {_POOLINGS}, got {pooling!r}"
        )
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(
            "compute_dtype must be 'bfloat16' or 'float32', got "
            f"{compute_dtype!r}"
        )
    if max_length < 1:
        raise ValueError("max_length must be >= 1")
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")

    encoder = _LocalEncoder(
        model, pooling, max_length, compute_dtype, normalize, batch_size,
        torch.device(device),
    )
    params: Dict[str, Any] = {
        "provider": "local",
        "model": model,
        "pooling": pooling,
        "max_length": max_length,
        "compute_dtype": compute_dtype,
        "normalize": normalize,
    }

    async def local_embeddings(
        list_of_strings: List[str],
    ) -> List[List[float]]:
        assert isinstance(list_of_strings, list)
        assert all(isinstance(s, str) for s in list_of_strings)
        if not list_of_strings:
            return []
        # device work runs in an executor so the event loop stays
        # responsive; caching + single-flight live on the encoder
        loop = asyncio.get_running_loop()
        matrix = await loop.run_in_executor(
            None, encoder.embed, tuple(list_of_strings)
        )
        return [row.tolist() for row in matrix]

    setattr(local_embeddings, "__embedding_func_params__", params)
    setattr(local_embeddings, "encoder", encoder)
    return local_embeddings
