"""Build the port's :class:`~svs_tpu_torch.engine.packing.PackedCorpus`
from a host pack given as NumPy arrays — the port's own ``pack_host``
output, or ``svs_tpu.engine.packing.pack_host``'s (the parity tests use
that to search the identical pack with both packages).  This module
imports neither package's JAX side: it only takes arrays."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .engine.packing import PackedCorpus


def packed_from_numpy(
    host_data: np.ndarray,
    host_scales: np.ndarray,
    emb_ids: np.ndarray,
    n_valid: int,
    dim: int,
    version: int,
    precision: str,
    scale_max: float,
    host_f32: Optional[np.ndarray],
    host_row_map: Optional[np.ndarray],
    device: Union[str, torch.device],
) -> PackedCorpus:
    """Upload a host int8 pack and its f32 rescore mirror to ``device``.

    ``host_data`` int8 ``[n_padded, dim_padded]`` and ``host_scales`` f32
    ``[n_padded]`` are the packed arrays; ``emb_ids`` int64 ``[n_valid]``
    maps pack rows to embedding ids; ``host_f32`` ``[n_valid, dim]`` are
    the exact rows in cache order and ``host_row_map`` the pack-row ->
    cache-row map (``None`` = identity).  Without ``host_f32`` the corpus
    has no device mirror, which the engine refuses to search.
    """
    if precision != "int8":
        raise NotImplementedError(
            f"precision {precision!r} is not ported to svs_tpu_torch yet"
        )
    device = torch.device(device)
    emb_ids = np.asarray(emb_ids, dtype=np.int64)
    dev_rescore = None
    dev_emb = None
    host_cache = None
    if host_f32 is not None:
        host_f32 = np.asarray(host_f32, dtype=np.float32)
        host_cache = (host_f32, host_row_map)
        dev_f32 = torch.from_numpy(np.ascontiguousarray(host_f32)).to(device)
        dev_map = (
            torch.from_numpy(np.asarray(host_row_map, dtype=np.int64)).to(device)
            if host_row_map is not None
            else None
        )
        dev_rescore = (dev_f32, dev_map)
        if n_valid == 0 or int(emb_ids.max()) < 2**31:
            dev_emb = torch.from_numpy(emb_ids.astype(np.int32)).to(device)
    return PackedCorpus(
        data=torch.from_numpy(np.ascontiguousarray(host_data, np.int8)).to(device),
        row_scales=torch.from_numpy(
            np.ascontiguousarray(host_scales, np.float32)
        ).to(device),
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
