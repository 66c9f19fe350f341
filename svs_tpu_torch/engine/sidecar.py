"""Sidecar cold-start cache: the packed corpus persisted next to the DB
(port of ``svs_tpu.engine.sidecar``, the same file format).

A cold open otherwise pays a full BLOB rescan (about 40 s at 1M x 1536).
The packed matrix (already padded, already in its storage dtype) is
written once to ``<db>.svsx`` and memory-mapped onto the device on the
next open.  Staleness is exact: the header records the store's
``(matrix_version, count, max id, generation)`` fingerprint, and any
embedding write moves it, so a stale sidecar is ignored and rebuilt.

Layout (little-endian):

    8 bytes   magic ``SVSTPUSC``
    4 bytes   u32 JSON header length L
    L bytes   JSON: {format, n_valid, dim, n_padded, dim_padded,
                      precision, matrix_version, fingerprint,
                      f32_cache, f32_row_map}
    n_valid*8 emb_ids (int64)
    [n_padded*4 row_scales (f32) — int8 precision only]
    n_padded*dim_padded*itemsize packed matrix (row-major)
    [n_valid*8 f32_row_map (int64) — when header.f32_row_map]
    [n_valid*dim*4 f32 rescore cache (row-major) — when header.f32_cache]

The trailing f32 sections (reduced-precision packs) carry the exact rows
the pack was built from, so a consumer of a published KB cold-starts with
no store scan at all.  bf16 packs are read and written as their 16-bit
words (``<u2``), the bytes ``svs_tpu`` writes through ``ml_dtypes``: both
packages open the same SQLite file, and each reads the other's sidecar.

All writes go through a ``.tmp`` + ``os.replace`` so a crash never leaves a
torn sidecar.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from pathlib import Path
from typing import (
    TYPE_CHECKING,
    Any,
    BinaryIO,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

if TYPE_CHECKING:
    from .packing import PackedCorpus

log = logging.getLogger(__name__)

_MAGIC = b"SVSTPUSC"
_FORMAT = 1

_NP_DTYPES = {
    "f32": np.dtype("<f4"),
    "bf16": np.dtype("<u2"),
    "int8": np.dtype(np.int8),
}

#: Rows gathered per write when a compacted cache is put in pack order.
_WRITE_CHUNK_ROWS = 1 << 16


def sidecar_path_for(db_path: Union[str, Path]) -> Path:
    return Path(f"{db_path}.svsx")


def save_sidecar(
    path: Union[str, Path],
    corpus: "PackedCorpus",
    fingerprint: Optional[Sequence[int]] = None,
) -> None:
    """Persist a :class:`~svs_tpu_torch.engine.packing.PackedCorpus` to
    ``path``, reading the pack back from its device (about 0.1 s for the
    1.56 GB int8 pack of 1M x 1536 on an H100), or writing its host arrays
    when the pack holds those (a failed upload).  ``fingerprint`` is the
    store's fingerprint at pack time, the staleness key."""
    import torch

    def host(a: Any) -> Any:
        if not isinstance(a, torch.Tensor):
            return a
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).cpu().numpy().view(np.uint16)
        return a.cpu().numpy()

    data_np = host(corpus.data)
    scales_np = host(corpus.row_scales)
    cache = corpus.host_cache
    save_sidecar_arrays(
        path,
        n_valid=corpus.n_valid,
        dim=corpus.dim,
        precision=corpus.precision,
        matrix_version=corpus.version,
        fingerprint=fingerprint,
        emb_ids=corpus.emb_ids,
        row_scales=scales_np,
        data=data_np,
        f32_cache=cache[0] if cache is not None else None,
        f32_row_map=cache[1] if cache is not None else None,
    )


def _write(f: BinaryIO, a: np.ndarray, dtype: str) -> None:
    f.write(np.ascontiguousarray(a, dtype=dtype).data)


def save_sidecar_arrays(
    path: Union[str, Path],
    *,
    n_valid: int,
    dim: int,
    precision: str,
    matrix_version: int,
    fingerprint: Optional[Sequence[int]],
    emb_ids: np.ndarray,
    row_scales: Optional[np.ndarray],
    data: np.ndarray,
    f32_cache: Optional[np.ndarray] = None,
    f32_row_map: Optional[np.ndarray] = None,
) -> None:
    """Raw-array sidecar write — the core of :func:`save_sidecar`, also
    used by publish-time writes from a host-only pack
    (``RetrievalEngine.write_sidecar_from_store``).

    ``f32_cache``/``f32_row_map`` (the engine's host rescore cache pair)
    append the zero-scan sections; skipped for f32 precision, where the
    pack already is the exact bytes.  A cache that an incremental delete
    has compacted (more rows than ``n_valid``, reached through the map)
    is written in pack order, without a map, as the format's sections are
    ``n_valid`` rows."""
    n_padded, dim_padded = data.shape
    if precision == "f32":
        f32_cache = f32_row_map = None
    if f32_cache is None:
        f32_row_map = None  # a map without a cache is meaningless
    gather = f32_row_map is not None and len(f32_cache) != n_valid
    header = {
        "format": _FORMAT,
        "n_valid": int(n_valid),
        "dim": int(dim),
        "n_padded": int(n_padded),
        "dim_padded": int(dim_padded),
        "precision": precision,
        "matrix_version": int(matrix_version),
        "fingerprint": list(fingerprint) if fingerprint is not None else None,
        "f32_cache": f32_cache is not None,
        "f32_row_map": f32_row_map is not None and not gather,
    }
    header_bytes = json.dumps(header).encode()
    tmp = Path(f"{path}.tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header_bytes)))
        f.write(header_bytes)
        _write(f, emb_ids, "<i8")
        if row_scales is not None:
            _write(f, row_scales, "<f4")
        _write(f, data, _NP_DTYPES[precision].str)
        if f32_cache is not None and gather:
            assert f32_row_map is not None and len(f32_row_map) == n_valid
            for lo in range(0, n_valid, _WRITE_CHUNK_ROWS):
                rows = f32_row_map[lo : lo + _WRITE_CHUNK_ROWS]
                _write(f, f32_cache[rows], "<f4")
        elif f32_cache is not None:
            if f32_row_map is not None:
                _write(f, f32_row_map, "<i8")
            assert f32_cache.shape == (n_valid, dim), f32_cache.shape
            _write(f, f32_cache, "<f4")
    os.replace(tmp, path)
    log.info(
        "wrote sidecar %s (%d docs, %s%s)",
        path, n_valid, precision,
        ", +f32 cache" if f32_cache is not None else "",
    )


def sidecar_fingerprint(path: Union[str, Path]) -> "Optional[List[int]]":
    """The stored fingerprint of the sidecar at ``path`` (header-only
    read), or ``None`` when missing/unreadable."""
    try:
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                return None
            (header_len,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(header_len))
    except (OSError, ValueError, struct.error):
        return None
    if header.get("format") != _FORMAT:
        return None
    stored = header.get("fingerprint")
    return list(stored) if stored is not None else None


def load_sidecar(
    path: Union[str, Path],
    expected_version: Union[int, Sequence[int], None] = None,
) -> "Optional[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, Dict[str, Any]]]":
    """Load a sidecar as memory-mapped arrays.

    Returns ``(data, row_scales, emb_ids, header)`` or ``None`` when the
    file is missing, unreadable, truncated, of another format, or stale
    versus ``expected_version``.  The optional f32 sections ride in the
    header as ``_f32_row_map`` (int64) and ``_f32_cache`` (a memmap).
    """
    path = Path(path)
    try:
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                log.warning("sidecar %s: bad magic; ignoring", path)
                return None
            (header_len,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(header_len))
            base = f.tell()
    except (OSError, ValueError, struct.error):
        return None
    if header.get("format") != _FORMAT:
        log.warning("sidecar %s: unsupported format; ignoring", path)
        return None
    stored = header.get("fingerprint")
    if expected_version is not None:
        expected = (
            list(expected_version)
            if isinstance(expected_version, (tuple, list))
            else [expected_version]
        )
        have = stored if stored is not None else [header["matrix_version"]]
        if have[: len(expected)] != expected:
            log.info(
                "sidecar %s is stale (has %s, store at %s); rebuilding",
                path, have, expected,
            )
            return None

    dtype = _NP_DTYPES[header["precision"]]
    n_valid = header["n_valid"]
    n_padded, dim_padded = header["n_padded"], header["dim_padded"]

    offset = base
    emb_ids = np.fromfile(path, dtype="<i8", count=n_valid, offset=offset)
    offset += n_valid * 8
    row_scales = None
    if header["precision"] == "int8":
        row_scales = np.fromfile(path, dtype="<f4", count=n_padded, offset=offset)
        offset += n_padded * 4
    data_bytes = n_padded * dim_padded * dtype.itemsize
    dim = header["dim"]
    expected_bytes = offset + data_bytes
    if header.get("f32_row_map"):
        expected_bytes += n_valid * 8
    if header.get("f32_cache"):
        expected_bytes += n_valid * dim * 4
    if path.stat().st_size < expected_bytes:
        log.warning("sidecar %s: truncated; ignoring", path)
        return None
    data = np.memmap(
        path, dtype=dtype, mode="r", offset=offset, shape=(n_padded, dim_padded)
    )
    tail = offset + data_bytes
    if header.get("f32_row_map"):
        header["_f32_row_map"] = np.fromfile(
            path, dtype="<i8", count=n_valid, offset=tail
        )
        tail += n_valid * 8
    if header.get("f32_cache"):
        header["_f32_cache"] = np.memmap(
            path, dtype="<f4", mode="r", offset=tail, shape=(n_valid, dim)
        )
    return data, row_scales, emb_ids, header
