"""Scaling past one device (port of ``svs_tpu.parallel``), along two
axes:

- **Sharding** (``sharded``, ``pairwise_sharded``): the corpus splits
  row-wise over a :class:`~svs_tpu_torch.parallel.mesh.Mesh`: capacity
  (corpora past one device's memory).  Each shard scores its rows and
  selects a local top-k; only ``k`` candidates per shard reach the merge.
- **Replication** (``replicas``): every device holds a full copy of a
  corpus that fits one, and query batches split across them: throughput,
  with no merge at all.

A mesh or a replica list may repeat a device, so one card (or the CPU)
runs several shards or replicas.
"""

from . import multihost
from .mesh import Mesh, default_mesh, mesh_2d
from .pairwise_sharded import sharded_pairwise_topk
from .replicas import ReplicaEngine
from .sharded import sharded_score_topk

__all__ = [
    "Mesh",
    "default_mesh",
    "mesh_2d",
    "sharded_score_topk",
    "sharded_pairwise_topk",
    "ReplicaEngine",
    "multihost",
]
