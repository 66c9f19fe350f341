"""One mesh across processes (``svs_tpu.parallel.multihost``): not
ported yet.

The reference runs one mesh over every host's devices through
``jax.distributed``.  The port's counterpart is ``torch.distributed``
(gloo on the CPU, NCCL on the card), with the mesh's exchanges
(``Mesh.gather``, ``Mesh.sum``, ``Mesh.shift``) as collectives between
processes; that is the next slice of the port.
"""

from __future__ import annotations

from typing import Optional

from .mesh import Mesh


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    data_axis: str = "data",
) -> Mesh:
    """Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(
        "svs_tpu_torch.parallel.multihost.initialize (a mesh across "
        "processes over torch.distributed) is not ported to svs_tpu_torch "
        "yet; single-process meshes: parallel.default_mesh / mesh_2d"
    )
