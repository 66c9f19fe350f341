"""Device meshes for one process (port of ``svs_tpu.parallel.mesh``), the
array that lives on one, and the mesh's cross-shard exchanges.

A :class:`Mesh` is a grid of ``torch.device`` entries with axis names:
``('data',)``, or ``('data', 'model')`` for a mesh that also shards the
embedding dim.  Each entry is one shard, and an entry may repeat: ``[cpu]
* 8`` gives the CPU tests eight shards, and ``[cuda:0] * 2`` gives one
card two (shards that share a device are views of one tensor there,
:func:`place`).

Every movement of data between shards goes through the mesh's methods:

- :meth:`Mesh.gather` — the per-shard candidate lists (or column blocks)
  to one device, for the merge;
- :meth:`Mesh.sum` — per-shard partial dot products summed on one device;
- :meth:`Mesh.shift` — one hop of the pairwise ring;
- :meth:`Mesh.replicate` — a tensor of the merging device (the queries,
  the merged candidate rows) on every shard's device.

In one process each is a device copy with ``non_blocking=True`` (a
no-op between shards of one device).  A mesh across processes replaces
these four methods and nothing else: ``gather`` becomes an all-gather,
so every process merges the same lists and ``replicate`` stays local.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """``devices`` (nested sequences, one level per axis) with one name per
    axis; ``shape`` maps each axis name to its size, as a JAX mesh's."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str]) -> None:
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for at in np.ndindex(given.shape):
            grid[at] = _device(given[at])
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of {grid.ndim} axes needs {grid.ndim} names, got {tuple(axis_names)}"
            )
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"

    @property
    def primary(self) -> torch.device:
        """The device of the first shard: where merges and the final
        selection run."""
        return self.devices.flat[0]

    def grid(self, data_axis: str, model_axis: Optional[str] = None) -> List[List[torch.device]]:
        """The devices as ``[data][model]`` rows (one column without a
        model axis; a mesh's other axes hold copies, and their first
        entry is used)."""
        if data_axis not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, expected a {data_axis!r} axis")
        order = [self.axis_names.index(data_axis)]
        if model_axis is not None:
            order.append(self.axis_names.index(model_axis))
        rest = [a for a in range(self.devices.ndim) if a not in order]
        g = np.transpose(self.devices, order + rest).reshape(
            self.devices.shape[order[0]],
            self.devices.shape[order[1]] if model_axis is not None else 1,
            -1,
        )
        return [[g[i, j, 0] for j in range(g.shape[1])] for i in range(g.shape[0])]

    def distinct_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    # -- the exchanges ---------------------------------------------------------

    def gather(
        self, parts: Sequence[torch.Tensor], device: Optional[torch.device] = None
    ) -> List[torch.Tensor]:
        """Per-shard ``parts`` on ``device`` (default: the primary), in
        shard order."""
        dev = self.primary if device is None else device
        return [p.to(dev, non_blocking=True) for p in parts]

    def sum(
        self, parts: Sequence[torch.Tensor], device: Optional[torch.device] = None
    ) -> torch.Tensor:
        """The sum of per-shard partials ``parts`` on ``device`` (default:
        the primary), added in shard order."""
        dev = self.primary if device is None else device
        out = parts[0].to(dev, non_blocking=True)
        for p in parts[1:]:
            out = out + p.to(dev, non_blocking=True)
        return out

    def shift(self, blocks: Sequence[torch.Tensor], data_axis: str = "data") -> List[torch.Tensor]:
        """One ring hop along ``data_axis``: shard ``i`` receives the block
        shard ``i + 1`` held (the reference's ``ppermute`` with ``j ->
        j - 1``)."""
        devs = [row[0] for row in self.grid(data_axis)]
        n = len(devs)
        return [blocks[(i + 1) % n].to(devs[i], non_blocking=True) for i in range(n)]

    def replicate(self, x: torch.Tensor) -> Dict[torch.device, torch.Tensor]:
        """``x`` on every distinct device of the mesh (``x`` itself where it
        already is)."""
        return {d: x.to(d, non_blocking=True) for d in self.distinct_devices()}


def _device(d: DeviceLike) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index (so that
    ``cuda`` and ``cuda:0`` are one entry)."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_mesh(
    n_devices: Optional[int] = None,
    data_axis: str = "data",
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: every CUDA device), with the
    corpus sharded along ``data_axis``.  ``devices`` may repeat a device."""
    devs = list(devices) if devices is not None else _cuda_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (data_axis,))


def mesh_2d(
    data: int,
    model: int,
    data_axis: str = "data",
    model_axis: str = "model",
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A ``data x model`` mesh: corpus rows sharded over ``data_axis`` and
    the embedding dim over ``model_axis`` (partial dot products summed by
    :meth:`Mesh.sum`)."""
    devs = list(devices) if devices is not None else _cuda_devices()
    if data * model > len(devs):
        raise ValueError(f"need {data * model} devices, have {len(devs)}")
    grid = [devs[i * model : (i + 1) * model] for i in range(data)]
    return Mesh(grid, (data_axis, model_axis))


class ShardedArray:
    """A ``[rows, cols]`` (or ``[rows]``) array over a mesh: row block ``i``
    (and column block ``j`` on a dim-sharded mesh) is ``blocks[i][j]``, on
    the mesh's device ``(i, j)``.  ``shape`` and ``dtype`` are the global
    array's."""

    def __init__(
        self,
        mesh: Mesh,
        blocks: List[List[torch.Tensor]],
        shape: Tuple[int, ...],
    ) -> None:
        self.mesh = mesh
        self.blocks = blocks
        self.shape = tuple(int(s) for s in shape)
        self.dtype = blocks[0][0].dtype

    def __repr__(self) -> str:
        return (
            f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
            f"blocks={len(self.blocks)}x{len(self.blocks[0])})"
        )

    def block(self, i: int, j: int = 0) -> torch.Tensor:
        return self.blocks[i][j]

    def row_blocks(self) -> List[torch.Tensor]:
        """Row block ``i`` of a row-sharded array (one column block)."""
        if len(self.blocks[0]) != 1:
            raise ValueError("row_blocks() of an array split over its columns")
        return [row[0] for row in self.blocks]

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for row in self.blocks for b in row)

    def cpu(self) -> torch.Tensor:
        """The global array on the host."""
        rows = [torch.cat([b.cpu() for b in row], dim=-1) if len(row) > 1 else row[0].cpu()
                for row in self.blocks]
        return torch.cat(rows, dim=0)


def place(
    host: np.ndarray,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: Optional[str] = None,
    bf16: bool = False,
) -> ShardedArray:
    """``host`` (``[rows, cols]`` or ``[rows]``; a sidecar's memory map
    reads sequentially) on the mesh: rows split over ``data_axis``, and
    the columns of a 2-D array over ``model_axis`` when one is given.
    ``bf16`` takes ``host`` as bf16 bit words (16-bit integers)."""
    if bf16:
        host = np.asarray(host).view(np.int16)
    grid = mesh.grid(data_axis, model_axis)
    n_cols = len(grid[0]) if host.ndim == 2 else 1
    if host.shape[0] % len(grid) or (host.ndim == 2 and host.shape[1] % n_cols):
        raise ValueError(
            f"an array of shape {host.shape} does not split into "
            f"{len(grid)} x {n_cols} blocks"
        )
    r = host.shape[0] // len(grid)
    c = host.shape[1] // n_cols if host.ndim == 2 else 0

    def source(i: int, j: int) -> np.ndarray:
        rows = host[i * r : (i + 1) * r]
        return rows if host.ndim == 1 else rows[:, j * c : (j + 1) * c]

    return _place(host.shape, host.dtype, source, mesh, grid, bf16)


def place_rows(
    shape: Tuple[int, int],
    dtype: np.dtype,
    rows: Callable[[int, int], np.ndarray],
    mesh: Mesh,
    data_axis: str = "data",
) -> ShardedArray:
    """A ``shape`` array split by rows over ``data_axis`` whose row block
    ``[r0, r1)`` is ``rows(r0, r1)``, made on the host one block at a
    time (the whole array never is)."""
    grid = mesh.grid(data_axis)
    if shape[0] % len(grid):
        raise ValueError(f"{shape[0]} rows do not split into {len(grid)} blocks")
    r = shape[0] // len(grid)
    return _place(shape, np.dtype(dtype), lambda i, j: rows(i * r, (i + 1) * r),
                  mesh, grid, False)


def _place(
    shape: Tuple[int, ...],
    dtype: np.dtype,
    source: Callable[[int, int], np.ndarray],
    mesh: Mesh,
    grid: List[List[torch.device]],
    bf16: bool,
) -> ShardedArray:
    """Upload block ``(i, j)`` = ``source(i, j)`` from the host straight
    to its device (``packing.staged_device_put``): nothing is staged on
    the primary.  The blocks of one device are consecutive views of one
    buffer there."""
    from ..engine.packing import staged_device_put

    n_rows, n_cols = len(grid), len(grid[0]) if len(shape) == 2 else 1
    block_shape = (shape[0] // n_rows,) + ((shape[1] // n_cols,) if len(shape) == 2 else ())
    r = block_shape[0]
    tdtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    cells = [(i, j) for i in range(n_rows) for j in range(n_cols)]
    views: Dict[Tuple[int, int], torch.Tensor] = {}
    for dev in mesh.distinct_devices():
        mine = [cell for cell in cells if grid[cell[0]][cell[1]] == dev]
        if not mine:
            continue
        buf = torch.empty((len(mine) * r,) + block_shape[1:], dtype=tdtype, device=dev)
        for slot, (i, j) in enumerate(mine):
            view = buf[slot * r : (slot + 1) * r]
            staged_device_put(source(i, j), dev, out=view)
            views[(i, j)] = view.view(torch.bfloat16) if bf16 else view
    blocks = [[views[(i, j)] for j in range(n_cols)] for i in range(n_rows)]
    return ShardedArray(mesh, blocks, shape)


def run_interleaved(steps: Sequence) -> list:
    """Drive per-shard generators in turns: each runs up to its next
    ``yield`` (placed just before a host sync) before any is resumed, so
    every shard's launches are queued before the first sync waits.
    Returns each generator's return value, in order."""
    results: list = [None] * len(steps)
    live = list(range(len(steps)))
    while live:
        still = []
        for i in live:
            try:
                next(steps[i])
                still.append(i)
            except StopIteration as stop:
                results[i] = stop.value
        live = still
    return results


__all__ = [
    "Mesh",
    "ShardedArray",
    "default_mesh",
    "mesh_2d",
    "place",
    "place_rows",
    "run_interleaved",
]
