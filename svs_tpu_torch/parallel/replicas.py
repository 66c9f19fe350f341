"""Corpus replication: N single-device replicas, query batches split
across them (port of ``svs_tpu.parallel.replicas``).

The mesh (``parallel.sharded``) shards the corpus: capacity.  Replication
is the other trade, for a corpus that fits one device: every device holds
a full copy of the pack, a batch splits into per-device slices, and each
replica runs the unmodified single-device pipeline (prescore kernels,
device rescore, final tie-rule selection) on its slice.  No merge: the
results concatenate, so throughput grows with the devices while each
query sees single-device latency.

- The PRIMARY engine (``devices[0]``) owns the store: packing, sidecar
  reads and writes, incremental writes, width hints.  Secondaries never
  touch SQLite; they get copies of the primary's device arrays (``.to(dev,
  copy=True)``: distinct tensors even when a device repeats), attached to
  the pack once (``PackedCorpus.replica_clones``), so a store change
  clones again and a search pinned to an old snapshot keeps its clones.
- Host state (``emb_ids``, the f32 rows) is shared by reference; each
  clone's device mirrors are copies of the primary's, made once the
  primary has them (a mirror that uploads in the background follows on a
  later call).
- Slices differ in size by at most one query (``np.array_split``); the
  kernel dispatch and the prescore error bound are both evaluated at the
  slice's batch size by the engine that runs it, so the margin proof
  stays sound when a split crosses a dispatch boundary (the guarded
  kernels' minimum batch).
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..engine.index import RetrievalEngine
from ..engine.packing import PackedCorpus
from ..store.db import Database

log = logging.getLogger(__name__)


class ReplicaEngine(RetrievalEngine):
    """A :class:`RetrievalEngine` whose corpus is replicated over
    ``devices`` and whose batched searches fan out across them.

    A single query runs on the primary exactly as on a plain engine; a
    batch of ``B`` queries splits into ``min(B, n_devices)`` contiguous
    slices, the secondaries' on a thread pool and the primary's on the
    calling thread.  Pairwise scoring (no query batch to split) runs on
    the primary, inherited unchanged.  ``devices`` may repeat a device
    (every replica on one card); the default is every CUDA device."""

    def __init__(
        self,
        precision: str = "auto",
        rescore: Optional[bool] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        n_replicas: Optional[int] = None,
        kernel: str = "auto",
        device_rescore: str = "auto",
    ) -> None:
        devs = (
            [torch.device(d) for d in devices]
            if devices is not None
            else [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        )
        if n_replicas is not None:
            if n_replicas < 1:
                raise ValueError("n_replicas must be >= 1")
            if n_replicas > len(devs):
                raise ValueError(
                    f"n_replicas={n_replicas} but only {len(devs)} "
                    "devices available"
                )
            devs = devs[:n_replicas]
        if not devs:
            raise ValueError("no devices for replication")
        super().__init__(
            precision=precision,
            rescore=rescore,
            device=devs[0],
            kernel=kernel,
            device_rescore=device_rescore,
        )
        self.devices: List[torch.device] = devs
        #: Secondary engines, one per other device: stateless compute
        #: endpoints (the clones ride the corpus snapshot, and every engine
        #: method takes the corpus explicitly).
        self._secondaries: List[RetrievalEngine] = [
            RetrievalEngine(
                precision=precision,
                rescore=rescore,
                device=d,
                kernel=kernel,
                device_rescore=device_rescore,
            )
            for d in devs[1:]
        ]
        self._clone_lock = threading.Lock()
        # an eager pool (no check-then-set race); shut down by shutdown()
        # and made again by ensure_fresh after a reopen
        self._pool: Optional[ThreadPoolExecutor] = (
            self._make_pool() if len(devs) > 1 else None
        )

    # -- replication -----------------------------------------------------------

    def _make_pool(self) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(
            max_workers=max(1, len(self.devices) - 1),
            thread_name_prefix="svs-tpu-replica",
        )

    def shutdown(self) -> None:
        """Release the fan-out threads (``KB.close()`` calls this) and the
        engines' background work.  A search racing the shutdown runs its
        slices inline (:meth:`_run`); :meth:`ensure_fresh` makes a new
        pool when the KB reopens."""
        super().shutdown()
        for eng in self._secondaries:
            eng.shutdown()
        with self._clone_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def join_dispatch_probes(self, timeout: Optional[float] = None) -> bool:
        ok = super().join_dispatch_probes(timeout)
        for eng in self._secondaries:
            ok = eng.join_dispatch_probes(timeout) and ok
        return ok

    def _clone_corpus(self, corpus: PackedCorpus, dev: torch.device) -> PackedCorpus:
        data, scales = self._pack_arrays(corpus)
        return PackedCorpus(
            data=data.to(dev, copy=True),
            row_scales=None if scales is None else scales.to(dev, copy=True),
            emb_ids=corpus.emb_ids,  # host state: shared by reference
            n_valid=corpus.n_valid,
            dim=corpus.dim,
            version=corpus.version,
            precision=corpus.precision,
            scale_max=corpus.scale_max,
            host_cache=corpus.host_cache,
        )

    def _sync_replicas(self, corpus: PackedCorpus) -> None:
        """Attach one clone per secondary to ``corpus`` (once per pack),
        and on every call let the clones catch up with state that attaches
        late: the host f32 rows (the background cache rebuild) and the
        primary's device mirrors (a background mirror upload)."""
        if not self._secondaries:
            return
        with self._clone_lock:
            clones = corpus.replica_clones
            if clones is None:
                # a deferred cold-start pack lands on the primary first
                self._await_pack_device(corpus)
                log.info("cloning pack to %d replica device(s)", len(self._secondaries))
                clones = tuple(
                    self._clone_corpus(corpus, eng.device) for eng in self._secondaries
                )
                # one store: readers see all clones or none
                object.__setattr__(corpus, "replica_clones", clones)
            for eng, c in zip(self._secondaries, clones):
                if c.host_cache is None and corpus.host_cache is not None:
                    object.__setattr__(c, "host_cache", corpus.host_cache)
                mirror = corpus.dev_rescore
                if c.dev_rescore is None and mirror is not None and corpus.dev_emb is not None:
                    dev = eng.device
                    dev_f32 = (
                        c.data if corpus.precision == "f32"  # the pack is its own mirror
                        else mirror[0].to(dev, copy=True)
                    )
                    dev_map = None if mirror[1] is None else mirror[1].to(dev, copy=True)
                    # the emb-id mirror first: a reader of dev_rescore reads it
                    object.__setattr__(c, "dev_emb", corpus.dev_emb.to(dev, copy=True))
                    object.__setattr__(c, "dev_rescore", (dev_f32, dev_map))

    def ensure_fresh(
        self,
        db: Database,
        sidecar_path: Union[str, Path, None] = None,
    ) -> PackedCorpus:
        corpus = super().ensure_fresh(db, sidecar_path=sidecar_path)
        if self._secondaries:
            with self._clone_lock:
                if self._pool is None:  # reopened after close()
                    self._pool = self._make_pool()
        self._sync_replicas(corpus)
        return corpus

    # -- fan-out ---------------------------------------------------------------

    def _plan(
        self, corpus: PackedCorpus, queries: np.ndarray
    ) -> List[Tuple[RetrievalEngine, PackedCorpus, np.ndarray]]:
        """Split a batch into ``(engine, clone, slice)`` work items
        (contiguous slices within one query of each other); fewer queries
        than replicas run on the first ``B``.  The clones come from the
        CALLER's snapshot; a corpus never synced runs on the primary."""
        b = queries.shape[0]
        clones = corpus.replica_clones
        if clones is None or b <= 1 or not self._secondaries:
            return [(self, corpus, queries)]
        pairs: List[Tuple[RetrievalEngine, PackedCorpus]] = [
            (self, corpus),
            *zip(self._secondaries, clones),
        ]
        r = min(len(pairs), b)
        return [
            (eng, c, q)
            for (eng, c), q in zip(pairs[:r], np.array_split(queries, r))
        ]

    def topk(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        plan = self._plan(corpus, queries)
        if len(plan) == 1:
            return super().topk(corpus, queries, k)
        outs = self._run(plan, lambda eng, c, q: RetrievalEngine.topk(eng, c, q, k))
        return (
            np.concatenate([o[0] for o in outs], axis=0),
            np.concatenate([o[1] for o in outs], axis=0),
        )

    def topk_with_rescore(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        plan = self._plan(corpus, queries)
        if len(plan) == 1:
            return super().topk_with_rescore(corpus, queries, k)
        outs = self._run(
            plan,
            lambda eng, c, q: RetrievalEngine.topk_with_rescore(eng, c, q, k),
        )
        vals = np.concatenate([o[0] for o in outs], axis=0)
        rows = np.concatenate([o[1] for o in outs], axis=0)
        if any(o[2] is None for o in outs):
            # a replica without a device rescore: the whole batch takes the
            # host rescore rather than mixing exact sources
            return vals, rows, None
        return vals, rows, np.concatenate([o[2] for o in outs], axis=0)

    def topk_final(
        self, corpus: PackedCorpus, queries: np.ndarray, n: int, c: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        plan = self._plan(corpus, queries)
        if len(plan) == 1:
            return super().topk_final(corpus, queries, n, c)
        outs = self._run(
            plan, lambda eng, cl, q: RetrievalEngine.topk_final(eng, cl, q, n, c)
        )
        if any(o is None for o in outs):
            return None  # the caller falls back to topk_with_rescore
        return (
            np.concatenate([o[0] for o in outs], axis=0),
            np.concatenate([o[1] for o in outs], axis=0),
            np.concatenate([o[2] for o in outs], axis=0),
        )

    def prescore_eps(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> np.ndarray:
        """Per-query error bounds at the REPLICA batch size, from the
        engine that runs each slice: the dispatch inside a replica sees
        its slice's ``b``, and the bound must be the bound of the kernel
        that ran."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        plan = self._plan(corpus, queries)
        if len(plan) == 1:
            return super().prescore_eps(corpus, queries, k)
        return np.concatenate(
            [RetrievalEngine.prescore_eps(eng, c, q, k) for eng, c, q in plan]
        )

    def _run(
        self,
        plan: List[Tuple[RetrievalEngine, PackedCorpus, np.ndarray]],
        fn: Callable[[RetrievalEngine, PackedCorpus, np.ndarray], Any],
    ) -> List[Any]:
        """``fn(engine, clone, slice)`` for every entry: the secondaries'
        on the pool, the primary's on the calling thread.  A ``close()``
        racing the search (the pool gone between planning and here) runs
        the slices inline: slower, never wrong."""
        pool = self._pool
        futures: List[Tuple[bool, Any]] = []
        for entry in plan[1:]:
            try:
                if pool is None:
                    raise RuntimeError("no pool")
                futures.append((True, pool.submit(fn, *entry)))
            except RuntimeError:  # shut down mid-flight
                pool = None
                futures.append((False, entry))
        out = [fn(*plan[0])]
        for ok, item in futures:
            out.append(item.result() if ok else fn(*item))
        return out
