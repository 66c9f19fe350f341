"""Corpus packing: host float32 matrix -> device-resident search layout,
int8, bf16 or f32 (port of ``svs_tpu.engine.packing``).

Padding rules are the reference's, so every kernel sees the same
tile-aligned shapes and the pack's bytes are identical to the reference's:

- rows padded up to ``row_multiple`` (256, or 16384 for large corpora)
  with zero vectors, masked out of every search by ``n_valid``;
- the embedding dim padded up to a multiple of 128 with zero columns;
- corpora of 16384 rows and more are permuted by the same seeded
  permutation, so per-subtile top-k occupancy stays binomial whatever the
  insertion order.

bf16 is carried on the host as its raw ``uint16`` bits (no ``ml_dtypes``)
and viewed as ``torch.bfloat16`` on upload.  The host pack is one fused
native pass (``native.permute_cast_pack``) when the native library is
there, else the chunked NumPy path below: the same bytes.

A pack of ``DEFER_MIN_BYTES`` and more whose host f32 rows are kept may
publish before its upload (``PackedCorpus.device_ready`` false,
``data``/``row_scales`` the host arrays): the engine uploads it in the
background through :func:`staged_device_put` and answers queries from
the host meanwhile.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

ROW_MULTIPLE = 256
DIM_MULTIPLE = 128
#: Large corpora pad (and the engine aligns) to the fused kernels' block
#: multiple so the fused selection path applies.
LARGE_ROW_MULTIPLE = 16384
#: At this size rows are shuffled at pack time (see the module docstring).
PERMUTE_MIN_ROWS = LARGE_ROW_MULTIPLE
_PERMUTE_SEED = 0xC0FFEE

#: Rows quantized per step of :func:`quantize_int8` (bounds the f32
#: temporaries at ~400 MB for d = 1536).
_QUANT_CHUNK_ROWS = 1 << 16

#: Keep the f32 scan matrix on the host (the rescore's gather source) up to
#: this many bytes; beyond it the rescore fetches rows from the store.  The
#: default (16 GB ~ 2.6M docs at dim 1536) is the reference's.
_RESCORE_CACHE_DEFAULT = 16_000_000_000


def rescore_cache_limit() -> int:
    """``SVS_TPU_RESCORE_CACHE_MAX_BYTES``, default 16 GB."""
    from ..utils.env import env_int

    return env_int("SVS_TPU_RESCORE_CACHE_MAX_BYTES", _RESCORE_CACHE_DEFAULT)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_queries(queries: np.ndarray, dim_padded: int) -> np.ndarray:
    """Zero-pad query vectors ``[B, d]`` to the corpus's padded dim."""
    b, d = queries.shape
    if d == dim_padded:
        return np.ascontiguousarray(queries, dtype=np.float32)
    out = np.zeros((b, dim_padded), dtype=np.float32)
    out[:, :d] = queries
    return out


def quantize_int8(
    matrix: np.ndarray, n_pad: int, d_pad: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization on the host into a zero-padded
    ``[n_pad, d_pad]`` array — bit-identical to ``svs_tpu``'s host
    quantizer (``native.quantize_int8`` / its NumPy fallback) on the
    padded matrix: zero padding never changes a row's max and quantizes to
    0, and zero rows get the scale ``1e-30 / 127``."""
    n, d = matrix.shape
    q = np.zeros((n_pad, d_pad), dtype=np.int8)
    scales = np.full(
        (n_pad,), np.float32(1e-30) / np.float32(127.0), dtype=np.float32
    )
    for lo in range(0, n, _QUANT_CHUNK_ROWS):
        rows = np.ascontiguousarray(
            matrix[lo : lo + _QUANT_CHUNK_ROWS], dtype=np.float32
        )
        absmax = np.abs(rows).max(axis=1) if d else np.zeros(len(rows), np.float32)
        s = np.maximum(absmax, np.float32(1e-30)) / np.float32(127.0)
        scaled = rows / s[:, None]
        np.rint(scaled, out=scaled)
        np.clip(scaled, -127, 127, out=scaled)
        q[lo : lo + len(rows), :d] = scaled.astype(np.int8)
        scales[lo : lo + len(rows)] = s
    return q, scales


def _bf16_rne_bits(bits: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 bits -> bf16 bits, bit for bit as
    ``svs_tpu``'s native cast: a NaN keeps its sign and top payload bits
    and is made quiet."""
    bits = bits.astype(np.uint32)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    lsb = (bits >> np.uint32(16)) & np.uint32(1)
    rounded = (bits + np.uint32(0x7FFF) + lsb) >> np.uint32(16)
    quiet = (bits >> np.uint32(16)) | np.uint32(0x0040)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def f32_to_bf16_bits(matrix: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 as ``uint16`` bits: the same bytes
    as ``svs_tpu.native.f32_to_bf16``.  torch's multithreaded cast does the
    bulk; entries with an all-zero or all-one exponent (zeros, subnormals,
    infinities, NaNs), where a vectorised cast may flush or canonicalise,
    are redone by the exact bit formula."""
    rows = torch.from_numpy(np.ascontiguousarray(matrix, dtype=np.float32))
    out = rows.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    exp = rows.view(torch.int32) & 0x7F800000
    special = torch.nonzero(
        (exp == 0) | (exp == 0x7F800000), as_tuple=True
    )
    if special[0].numel():
        at = tuple(i.numpy() for i in special)
        bits = rows.numpy().view(np.uint32)[at]
        out[at] = _bf16_rne_bits(bits)
    return out


def _cast_padded(
    matrix: "np.ndarray | _PermutedRows", n_pad: int, d_pad: int, precision: str
) -> np.ndarray:
    """The zero-padded ``[n_pad, d_pad]`` f32 matrix (``precision='f32'``)
    or its bf16 bits (``'bf16'``), filled one row chunk at a time."""
    n, d = matrix.shape
    dtype = np.float32 if precision == "f32" else np.uint16
    out = np.zeros((n_pad, d_pad), dtype=dtype)
    for lo in range(0, n, _QUANT_CHUNK_ROWS):
        rows = np.asarray(matrix[lo : lo + _QUANT_CHUNK_ROWS], dtype=np.float32)
        out[lo : lo + len(rows), :d] = (
            rows if precision == "f32" else f32_to_bf16_bits(rows)
        )
    return out


def pack_host(
    matrix: np.ndarray,
    emb_ids: np.ndarray,
    precision: str,
    row_multiple: int = ROW_MULTIPLE,
    dim_multiple: int = DIM_MULTIPLE,
) -> Tuple[
    np.ndarray,
    Optional[np.ndarray],
    np.ndarray,
    np.ndarray,
    Optional[np.ndarray],
    int,
    int,
]:
    """Permute + pad + cast/quantize on the HOST only.

    Same contract as ``svs_tpu.engine.packing.pack_host`` and the same
    bytes: returns ``(host_data, host_scales, emb_ids, cache_f32,
    host_row_map, n, d)``.  ``host_data`` is int8 (with f32 per-row
    ``host_scales``), bf16 as ``uint16`` bits, or f32 (both float packs
    have ``host_scales=None``).  ``cache_f32`` is the f32 matrix in its
    ORIGINAL (scan) order and ``host_row_map`` the pack-row -> cache row
    map (``None`` = identity), so no permuted copy of the f32 matrix is
    made beyond the f32 pack itself.
    """
    assert matrix.ndim == 2
    n, d = matrix.shape
    if precision not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown precision: {precision!r}")
    emb_ids = np.asarray(emb_ids, dtype=np.int64)
    perm = None
    if n >= PERMUTE_MIN_ROWS:
        perm = np.random.default_rng(_PERMUTE_SEED).permutation(n)
        emb_ids = emb_ids[perm]
    n_pad = max(_round_up(n, row_multiple), row_multiple)
    d_pad = max(_round_up(d, dim_multiple), dim_multiple)
    from ..native import permute_cast_pack

    # one multithreaded native pass (permute + pad + cast / quantize), or
    # the chunked path: the same bytes
    fused = permute_cast_pack(
        matrix,
        perm if perm is not None else np.arange(n, dtype=np.int64),
        precision,
        n_pad,
        d_pad,
    )
    if fused is not None:
        host_data, host_scales = fused
        return host_data, host_scales, emb_ids, matrix, perm, n, d
    rows = matrix if perm is None else _PermutedRows(matrix, perm)
    if precision == "int8":
        host_data, host_scales = quantize_int8(rows, n_pad, d_pad)
    else:
        host_data, host_scales = _cast_padded(rows, n_pad, d_pad, precision), None
    return host_data, host_scales, emb_ids, matrix, perm, n, d


def _is_mmap_backed(a: np.ndarray) -> bool:
    """True when ``a`` is (a view chain over) a ``np.memmap``."""
    seen: object = a
    while isinstance(seen, np.ndarray):
        if isinstance(seen, np.memmap):
            return True
        seen = seen.base
    return False


#: Staged-upload granularity (see :func:`staged_device_put`): big enough to
#: amortize a transfer's overhead, small enough that a background upload
#: yields to live queries between chunks.
STAGE_CHUNK_BYTES = 64 * 1024 * 1024

#: Packs of at least this many bytes may defer their upload to a
#: background thread (``RetrievalEngine._spawn_pack_upload``): the corpus
#: publishes at once with its HOST arrays, queries answer exactly from the
#: host f32 rows meanwhile, and the device copies swap in when they land.
#: Below it the upload is cheaper than the machinery.
DEFER_MIN_BYTES = STAGE_CHUNK_BYTES


def staged_device_put(
    host: np.ndarray,
    device: Union[str, torch.device],
    chunk_bytes: Optional[int] = None,
    throttle: Optional[Callable[[], None]] = None,
) -> torch.Tensor:
    """``host`` (any NumPy dtype torch takes: bf16 goes as its ``int16``
    view) on ``device``, one ``chunk_bytes`` slice of rows at a time.

    The device buffer is allocated once, on the calling thread's current
    stream.  Each chunk is first copied from ``host`` (RAM, or a sidecar
    ``np.memmap``) into one of two pinned staging buffers, then
    ``copy_(non_blocking=True)`` on an uploader ``torch.cuda.Stream``: a
    device copy that reads a memmap directly interleaves page faults with
    the link (a 40x cliff in the reference's measurements), and the
    staging keeps the disk read sequential.  ``throttle`` (background
    callers) runs before each chunk.  The uploader stream is synchronized
    before the buffer is returned (also on an exception), so a reader on
    any stream sees the whole array.  On the CPU the chunks are plain
    copies."""
    device = torch.device(device)
    chunk = STAGE_CHUNK_BYTES if chunk_bytes is None else chunk_bytes
    n = host.shape[0]
    row_bytes = max(1, host.nbytes // max(1, n))
    rows = max(1, chunk // row_bytes)
    dtype = torch.from_numpy(np.zeros(0, dtype=host.dtype)).dtype
    if device.type != "cuda":
        out = torch.empty(host.shape, dtype=dtype, device=device)
        for lo in range(0, n, rows):
            if throttle is not None:
                throttle()
            out[lo : lo + rows] = torch.from_numpy(np.array(host[lo : lo + rows]))
        return out
    out = torch.empty(host.shape, dtype=dtype, device=device)
    stream = torch.cuda.Stream(device)
    # the copies are ordered after the allocation on the current stream
    stream.wait_stream(torch.cuda.current_stream(device))
    staging = [
        torch.empty((min(rows, n),) + tuple(host.shape[1:]), dtype=dtype, pin_memory=True)
        for _ in range(2 if n > rows else 1)
    ]
    landed: list = [None] * len(staging)
    try:
        for i, lo in enumerate(range(0, n, rows)):
            if throttle is not None:
                throttle()
            hi = min(n, lo + rows)
            slot = i % len(staging)
            if landed[slot] is not None:
                landed[slot].synchronize()  # its previous copy has left
            buf = staging[slot][: hi - lo]
            buf.numpy()[...] = host[lo:hi]
            with torch.cuda.stream(stream):
                out[lo:hi].copy_(buf, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            landed[slot] = ev
    finally:
        stream.synchronize()
    return out


def _grow_rows(
    old: torch.Tensor, new: torch.Tensor, n0: int, row_multiple: int
) -> torch.Tensor:
    """``old`` with ``new`` written at row ``n0`` (leading axis), grown
    with zero rows to the next ``row_multiple`` when it does not fit.
    Functional: the result is a new buffer, so a search holding ``old``
    keeps exactly the rows it started with."""
    needed = n0 + new.shape[0]
    if needed > old.shape[0]:
        grown_rows = _round_up(needed, row_multiple)
        out = torch.zeros(
            (grown_rows,) + tuple(old.shape[1:]), dtype=old.dtype, device=old.device
        )
        out[: old.shape[0]] = old
    else:
        out = old.clone()
    out[n0:needed] = new
    return out


def _move_rows(buf: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` with rows ``src`` written over rows ``dst`` — the
    compaction step of an incremental delete.  Functional, as
    :func:`_grow_rows`."""
    out = buf.clone()
    out[dst] = buf[src]
    return out


class _PermutedRows:
    """Row-sliceable view ``matrix[perm]`` that gathers one slice at a
    time (the full permuted copy would double the f32 footprint)."""

    def __init__(self, matrix: np.ndarray, perm: np.ndarray) -> None:
        self._m = matrix
        self._perm = perm
        self.shape = matrix.shape

    def __getitem__(self, sl: slice) -> np.ndarray:
        return self._m[self._perm[sl]]


@dataclasses.dataclass(frozen=True)
class PackedCorpus:
    """Device-resident packed corpus plus host-side id mapping."""

    #: ``[n_padded, dim_padded]`` int8, bf16 or f32 (host arrays while a
    #: deferred upload runs, see ``_device_ready``)
    data: torch.Tensor
    row_scales: Optional[torch.Tensor]  # [n_padded] f32 (int8 only)
    emb_ids: np.ndarray  # [n_valid] int64: pack row -> embeddings.id
    n_valid: int
    dim: int  # true (unpadded) embedding dim
    version: int  # store matrix_version this pack reflects
    precision: str
    #: Largest per-row quantization scale — input to the engine's sound
    #: prescore-error bound.
    scale_max: float = 0.0
    #: Host f32 rows (``[n_valid, dim]``) and the pack-row -> row map
    #: (``None`` = identity), published as one tuple.
    host_cache: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = (
        dataclasses.field(default=None, repr=False, compare=False)
    )
    #: Device mirror of the f32 rows, ``(dev_f32 [n_valid, dim], dev_row_map
    #: int64 [n_valid] | None)``: the exact-rescore gather source.  An f32
    #: pack is its own mirror, ``(data, None)`` at the padded width.
    dev_rescore: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = (
        dataclasses.field(default=None, repr=False, compare=False)
    )
    #: Device mirror of ``emb_ids`` as int32 in pack-row order (the final
    #: selection's tie-rule input).
    dev_emb: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _emb_sort: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: Deferred-upload gate: ``None`` = the pack was born on its device; an
    #: Event = ``data``/``row_scales`` are HOST arrays (NumPy; bf16 as
    #: ``uint16`` bits) until the engine's uploader publishes the device
    #: copies and sets it.  Meanwhile the engine answers from the host f32
    #: rows (``RetrievalEngine.host_route``).
    _device_ready: Optional[threading.Event] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: Host int8 prescore arrays ``(docs_i8, scales, row_sums)`` in
    #: host-cache row order: the first pass of the host two-pass search,
    #: built lazily from ``host_cache`` and attached in one store.
    host_i8: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = (
        dataclasses.field(default=None, repr=False, compare=False)
    )

    @property
    def device_ready(self) -> bool:
        """Whether ``data``/``row_scales`` are published (True for every
        pack that was not deferred)."""
        ev = self._device_ready
        return ev is None or ev.is_set()

    def wait_device(self, timeout: Optional[float] = None) -> bool:
        """Block until the background upload publishes the pack."""
        ev = self._device_ready
        return True if ev is None else bool(ev.wait(timeout))

    def publish_device(
        self,
        data: "Union[torch.Tensor, np.ndarray]",
        row_scales: "Optional[Union[torch.Tensor, np.ndarray]]",
    ) -> None:
        """Swap in the device copies (or, after a failed upload, keep the
        host arrays) and release the waiters; called once, by the engine's
        uploader thread, after its stream has synchronized."""
        object.__setattr__(self, "data", data)
        object.__setattr__(self, "row_scales", row_scales)
        ev = self._device_ready
        if ev is not None:
            ev.set()

    @property
    def host_f32(self) -> Optional[np.ndarray]:
        cache = self.host_cache
        return cache[0] if cache is not None else None

    @property
    def host_row_map(self) -> Optional[np.ndarray]:
        cache = self.host_cache
        return cache[1] if cache is not None else None

    def rows_for_emb_ids(
        self, ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Inverse of ``emb_ids``: ``(rows int64, present bool)`` aligned
        with ``ids`` (absent ids map to row 0, masked off)."""
        if self._emb_sort is None:
            order = np.argsort(self.emb_ids, kind="stable")
            object.__setattr__(
                self, "_emb_sort", (self.emb_ids[order], order)
            )
        sorted_ids, order = self._emb_sort  # type: ignore[misc]
        ids = np.asarray(ids, dtype=np.int64)
        if not len(sorted_ids):
            return np.zeros(len(ids), np.int64), np.zeros(len(ids), bool)
        pos = np.searchsorted(sorted_ids, ids)
        pos_c = np.minimum(pos, len(sorted_ids) - 1)
        present = sorted_ids[pos_c] == ids
        rows = np.where(present, order[pos_c], 0).astype(np.int64)
        return rows, present

    def emb_ids_fit_int32(self) -> bool:
        """Whether every emb id fits the int32 device mirror."""
        return self.n_valid == 0 or int(self.emb_ids.max()) < 2**31

    @property
    def n_padded(self) -> int:
        return int(self.data.shape[0])

    @property
    def dim_padded(self) -> int:
        return int(self.data.shape[1])
