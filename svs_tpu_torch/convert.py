"""Build the port's :class:`~svs_tpu_torch.engine.packing.PackedCorpus`
from a host pack given as NumPy arrays — the port's own ``pack_host``
output, or ``svs_tpu.engine.packing.pack_host``'s (the parity tests use
that to search the identical pack with both packages); and a Flax BERT
parameter tree of a BERT-family or DistilBERT encoder as the port's
encoder's state dict (:func:`encoder_state_dict_from_flax`).  This module imports neither
package's JAX side: it only takes arrays."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .engine.packing import PackedCorpus, _is_mmap_backed, staged_device_put


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``.  A memory-mapped source (a sidecar's pack or
    f32 cache) goes through :func:`~svs_tpu_torch.engine.packing.
    staged_device_put`, so the file reads sequentially and no torch tensor
    aliases the read-only mapping."""
    if not _is_mmap_backed(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return staged_device_put(arr, device)


def _upload_data(
    host_data: np.ndarray, precision: str, device: torch.device
) -> torch.Tensor:
    """The packed matrix on ``device`` in its storage dtype.  bf16 arrives
    as 16-bit words (``uint16`` bits, or the JAX package's ``ml_dtypes``
    array) and is viewed as ``torch.bfloat16`` without a conversion."""
    arr = np.asarray(host_data)
    if precision == "bf16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bf16 pack needs 16-bit words, got {arr.dtype}")
        return upload(arr.view(np.int16), device).view(torch.bfloat16)
    dtype = np.int8 if precision == "int8" else np.float32
    if arr.dtype != dtype:
        arr = arr.astype(dtype)
    return upload(arr, device)


def packed_from_numpy(
    host_data: np.ndarray,
    host_scales: Optional[np.ndarray],
    emb_ids: np.ndarray,
    n_valid: int,
    dim: int,
    version: int,
    precision: str,
    scale_max: float,
    host_f32: Optional[np.ndarray],
    host_row_map: Optional[np.ndarray],
    device: Union[str, torch.device],
    mirror: bool = True,
) -> PackedCorpus:
    """Upload a host pack and its f32 rescore mirror to ``device``.

    ``host_data`` ``[n_padded, dim_padded]`` is the packed matrix: int8
    with f32 ``host_scales`` ``[n_padded]``, or bf16 / f32 with
    ``host_scales=None``.  ``emb_ids`` int64 ``[n_valid]`` maps pack rows
    to embedding ids; ``host_f32`` ``[n_valid, dim]`` are the exact rows in
    cache order (the host rescore cache; ``None`` keeps none) and
    ``host_row_map`` the pack-row -> cache-row map (``None`` = identity).
    With ``mirror`` the corpus gets a device mirror for the exact rescore:
    for an f32 pack the pack itself, else an upload of ``host_f32`` (none
    without it).  Without a mirror the engine rescores on the host.
    """
    if precision not in ("int8", "bf16", "f32"):
        raise ValueError(f"unknown precision: {precision!r}")
    if (precision == "int8") != (host_scales is not None):
        raise ValueError("row scales come with an int8 pack and only with one")
    device = torch.device(device)
    emb_ids = np.asarray(emb_ids, dtype=np.int64)
    data = _upload_data(host_data, precision, device)
    row_scales = None
    if host_scales is not None:
        row_scales = torch.from_numpy(
            np.ascontiguousarray(host_scales, np.float32)
        ).to(device)
    host_cache = None
    if host_f32 is not None:
        host_cache = (np.asarray(host_f32, dtype=np.float32), host_row_map)
    dev_rescore, dev_emb = (
        device_mirror(data, precision, host_cache, emb_ids, n_valid)
        if mirror
        else (None, None)
    )
    return PackedCorpus(
        data=data,
        row_scales=row_scales,
        emb_ids=emb_ids,
        n_valid=int(n_valid),
        dim=int(dim),
        version=int(version),
        precision=precision,
        scale_max=float(scale_max),
        host_cache=host_cache,
        dev_rescore=dev_rescore,
        dev_emb=dev_emb,
    )


def device_mirror(
    data: torch.Tensor,
    precision: str,
    host_cache: Optional[Tuple[np.ndarray, Optional[np.ndarray]]],
    emb_ids: np.ndarray,
    n_valid: int,
) -> Tuple[
    Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]], Optional[torch.Tensor]
]:
    """The exact-rescore mirrors of a pack on ``data``'s device:
    ``(dev_rescore, dev_emb)``.  An f32 pack is its own mirror; else the
    host f32 cache and its row map upload (none without a cache).  The
    int32 emb-id mirror comes with a rescore mirror when every id fits."""
    dev_rescore = None
    if precision == "f32":
        dev_rescore = (data, None)
    elif host_cache is not None:
        cache_f32, row_map = host_cache
        dev_map = (
            upload(np.asarray(row_map, dtype=np.int64), data.device)
            if row_map is not None
            else None
        )
        dev_rescore = (upload(cache_f32, data.device), dev_map)
    dev_emb = None
    if dev_rescore is not None:
        dev_emb = emb_mirror(emb_ids, n_valid, data.device)
    return dev_rescore, dev_emb


def emb_mirror(
    emb_ids: np.ndarray, n_valid: int, device: torch.device
) -> Optional[torch.Tensor]:
    """``emb_ids`` as int32 on ``device`` (the final selection's tie-rule
    input), or ``None`` when an id does not fit int32."""
    if n_valid and int(emb_ids.max()) >= 2**31:
        return None
    return torch.from_numpy(emb_ids.astype(np.int32)).to(device)


def bert_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax BERT parameter tree (nested dicts of NumPy arrays, as
    ``flax_model.msgpack`` holds it) as the state dict of
    :class:`svs_tpu_torch.embeddings.bert.BertEncoder`: Dense ``kernel
    [in, out]`` becomes ``weight [out, in]``, LayerNorm ``scale`` becomes
    ``weight``, Embed ``embedding`` becomes ``weight``; names join with
    ``.`` (``encoder.layer.0.attention.self.query.weight``).  The pooler,
    which ``last_hidden_state`` does not use, is dropped; bf16 leaves
    arrive as f32."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Dict[str, Any], prefix: str) -> None:
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{name}.")
                continue
            if name == "kernel":
                if np.ndim(value) != 2:
                    raise ValueError(f"{prefix}kernel: expected a 2-D Dense kernel, got {np.shape(value)}")
                # one writable copy, transposed on the way
                arr, name = np.ascontiguousarray(np.asarray(value).T, dtype=np.float32), "weight"
                out[prefix + name] = torch.from_numpy(arr)
                continue
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if name in ("scale", "embedding"):
                name = "weight"
            elif name != "bias":
                raise ValueError(f"unexpected Flax parameter {prefix}{name}")
            out[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk({k: v for k, v in params.items() if k != "pooler"}, "")
    return out


#: The top-level subtrees of each family's Flax base model (the pooler,
#: where a family has one, is dropped).
_FLAX_TOP = {
    "bert": ("embeddings", "encoder"),
    "roberta": ("embeddings", "encoder"),
    "xlm-roberta": ("embeddings", "encoder"),
    "electra": ("embeddings", "embeddings_project", "encoder"),
    "distilbert": ("embeddings", "transformer"),
    "albert": ("embeddings", "encoder"),
    "roberta-prelayernorm": ("embeddings", "encoder", "LayerNorm"),
    "big_bird": ("embeddings", "encoder"),
    "llama": ("embed_tokens", "layers", "norm"),
    "mistral": ("embed_tokens", "layers", "norm"),
    "gemma": ("embed_tokens", "layers", "norm"),
    "gpt2": ("wte", "wpe", "h", "ln_f"),
    "gpt_neo": ("wte", "wpe", "h", "ln_f"),
    "gptj": ("wte", "h", "ln_f"),
    "bloom": ("word_embeddings", "word_embeddings_layernorm", "h", "ln_f"),
    "xglm": ("embed_tokens", "layers", "layer_norm"),
    **{t: ("shared", "encoder", "decoder")
       for t in ("bart", "mbart", "pegasus", "blenderbot", "blenderbot-small")},
}
#: The families whose kernels are ``FlaxConv1D``'s ``[out, in]`` (GPT-2's),
#: taken as they are.
_CONV1D = ("gpt2",)


def _tensor(arr: Any) -> torch.Tensor:
    """``arr`` as an f32 tensor sharing its memory when it is a writable
    f32 array (a checkpoint read into a writable buffer), else a copy."""
    a = np.asarray(arr)
    if a.dtype != np.float32 or not a.flags.writeable:
        a = np.array(a, dtype=np.float32)
    return torch.from_numpy(a)


def decoder_state_dict_from_flax(params: Dict[str, Any], conv1d: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """A Flax decoder's base tree as the state dict of the port's decoder
    (:mod:`svs_tpu_torch.embeddings.llama`, ``gpt2``, ``gpt_neo``,
    ``gptj``, ``bloom``, ``xglm``) or encoder-decoder
    (:mod:`svs_tpu_torch.embeddings.seq2seq`: ``shared`` read once, the one
    table both stacks look up), leaf by leaf under the same names.
    Nothing is copied: a Dense ``kernel [in, out]`` becomes the transposed
    view ``weight [out, in]`` (moved to the card with its strides, one
    contiguous copy); with ``conv1d`` (GPT-2's ``FlaxConv1D``, whose kernel
    is ``[out, in]`` already) a kernel is taken as it is; ``embedding``,
    a LayerNorm's ``scale`` and a norm's ``weight`` become ``weight``,
    ``bias`` stays.  BLOOM's fused ``query_key_value`` keeps its per-head
    layout.  At 7.11B parameters a copy costs seconds and 28 GB."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Dict[str, Any], prefix: str) -> None:
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{name}.")
            elif name == "kernel":
                if np.ndim(value) != 2:
                    raise ValueError(f"{prefix}kernel: expected a 2-D Dense kernel, got {np.shape(value)}")
                out[prefix + "weight"] = _tensor(value) if conv1d else _tensor(value).T
            elif name in ("embedding", "scale", "weight", "bias"):
                out[prefix + ("bias" if name == "bias" else "weight")] = _tensor(value)
            else:
                raise ValueError(f"unexpected Flax parameter {prefix}{name}")

    walk(params, "")
    return out


def encoder_state_dict_from_flax(
    config: Dict[str, Any], params: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    """The Flax base-model tree of ``config``'s ``model_type`` as the state
    dict of the port's encoder (:func:`svs_tpu_torch.embeddings.encoders.
    build_encoder`), leaf by leaf as :func:`bert_state_dict_from_flax`:
    BERT, RoBERTa and XLM-R trees are ``embeddings`` + ``encoder.layer.N``;
    ELECTRA's adds ``embeddings_project`` (when ``embedding_size`` differs
    from ``hidden_size``); DistilBERT's is ``embeddings`` +
    ``transformer.layer.N.{attention.{q,k,v,out}_lin, sa_layer_norm,
    ffn.lin1, ffn.lin2, output_layer_norm}``; ALBERT's ``embeddings`` +
    ``encoder.{embedding_hidden_mapping_in, albert_layer_groups.G.
    albert_layers.I.{attention.{query,key,value,dense,LayerNorm}, ffn,
    ffn_output, full_layer_layer_norm}}``; RoBERTa-PreLayerNorm's adds the
    final ``LayerNorm``; BigBird's is BERT's.  The pooler (a subtree, or
    ALBERT's and BigBird's flat Dense) is dropped.  The decoders' trees
    (Llama / Mistral / Gemma ``embed_tokens``, ``layers``, ``norm``;
    GPT-2 / GPT-Neo ``wte``, ``wpe``, ``h``, ``ln_f``; GPT-J's without
    ``wpe``; BLOOM ``word_embeddings``, ``word_embeddings_layernorm``,
    ``h``, ``ln_f``; XGLM ``embed_tokens``, ``layers``, ``layer_norm``) and
    the encoder-decoders' (``shared``, ``encoder``, ``decoder``: each
    stack's ``embed_positions``, BART's and mBART's of
    ``max_position_embeddings + 2`` rows, none in Pegasus's; its
    ``layers``, ``layernorm_embedding`` and ``layer_norm`` where the family
    has them) go through :func:`decoder_state_dict_from_flax`.  A subtree
    the family does not have raises ``ValueError``."""
    model_type = config.get("model_type")
    if model_type not in _FLAX_TOP:
        raise NotImplementedError(f"model_type {model_type!r} has no weight conversion")
    from .embeddings.encoders import DECODER_TYPES, SEQ2SEQ_TYPES

    decoder = model_type in DECODER_TYPES + SEQ2SEQ_TYPES
    extra = sorted(set(params) - set(_FLAX_TOP[model_type]) - (set() if decoder else {"pooler"}))
    if extra:
        raise ValueError(f"unexpected subtrees {extra} in a {model_type} checkpoint")
    if decoder:
        return decoder_state_dict_from_flax(params, conv1d=model_type in _CONV1D)
    return bert_state_dict_from_flax(params)
