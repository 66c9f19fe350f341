"""Build the port's :class:`~svs_tpu_torch.engine.packing.PackedCorpus`
from a host pack given as NumPy arrays — the port's own ``pack_host``
output, or ``svs_tpu.engine.packing.pack_host``'s (the parity tests use
that to search the identical pack with both packages).  This module
imports neither package's JAX side: it only takes arrays."""

from __future__ import annotations

from typing import Optional, Tuple, Union

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
