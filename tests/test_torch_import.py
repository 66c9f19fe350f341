"""The PyTorch port stands alone: it imports with JAX and the JAX
package's optional dependencies blocked (int8 and bf16 storage, batches
above 256, top document pairs, metadata filters and ``AsyncKB``, the
deferred upload, the host route and the native library), never
imports ``svs_tpu``, and refuses to fall back to the CPU when no device
was named."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import svs_tpu_torch

_BLOCKED_ROUND_TRIP = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import svs_tpu_torch
    from svs_tpu_torch import KB, make_mock_embeddings_func

    path = sys.argv[1]
    kb = KB(path, make_mock_embeddings_func(), force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(5)]
    hits = kb.retrieve("anything", 3)
    assert len(hits) == 3, hits
    # the mock embeds every text alike: all scores tie at 1.0 and the
    # reference tie rule returns the largest embedding ids first
    assert [h["doc"]["id"] for h in hits] == ids[::-1][:3], hits
    assert all(abs(h["score"] - 1.0) < 1e-6 for h in hits)
    kb.close()
    # reopen: the embedding function is restored from the database
    kb = KB(path, device="cpu")
    assert len(kb) == 5
    kb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_BF16_WIDE_BATCH = textwrap.dedent(
    """
    import sys, zlib

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import KB

    def vec(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(32).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vec(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, precision="bf16", device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(300)]
    queries = [f"query {i}" for i in range(300)]
    hits = kb.retrieve_batch(queries, 5)
    assert kb.engine.precision == "bf16"
    kb.close()
    # exact: the f32 top-5 of every query, ties to the larger id
    m = np.stack([vec(f"doc {i}") for i in range(300)])
    for q, got in zip(queries, hits):
        s = m @ vec(q)
        want = sorted(range(300), key=lambda j: (-s[j], -ids[j]))[:5]
        assert [h["doc"]["id"] for h in got] == [ids[j] for j in want], got
    kb = KB(path, embed, precision="bf16", device="cpu")
    assert len(kb) == 300
    kb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_PAIRWISE = textwrap.dedent(
    """
    import sys, zlib

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import KB
    from svs_tpu_torch.utils.topk_np import top_pairs_numpy

    def vec(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(24).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vec(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(4000)]
    pairs = kb.document_top_pairwise_scores(15)
    kb.close()
    # exact: the brute-force f32 top-15 pairs (the 4096-row pack takes the
    # keyed route, then the f32 rescore and the margin check)
    m = np.stack([vec(f"doc {i}") for i in range(4000)])
    want = top_pairs_numpy(m @ m.T, 15)
    assert [(a["id"], b["id"]) for _, a, b in pairs] == [
        (ids[r], ids[c]) for _, r, c in want
    ], pairs
    assert max(abs(s - w[0]) for (s, _, _), w in zip(pairs, want)) < 1e-6
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_FILTERS_ASYNC = textwrap.dedent(
    """
    import asyncio, sys, zlib

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    from svs_tpu_torch import AsyncKB, KB, meta_filter_predicate

    def vec(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(12).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vec(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, device="cpu")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}", meta={"g": i % 10}) for i in range(500)]
    hits = kb.retrieve("query", 5, where={"g": 3})
    pairs = kb.document_top_pairwise_scores(4, where=meta_filter_predicate({"g": 3}))
    kb.close()
    # exact: the f32 top-5 of the 50 matching docs, and their top-4 pairs
    m = np.stack([vec(f"doc {i}") for i in range(500)])
    match = [i for i in range(500) if i % 10 == 3]
    s = m[match] @ vec("query")
    assert [h["doc"]["id"] for h in hits] == [
        ids[match[j]] for j in np.argsort(-s, kind="stable")[:5]
    ], hits
    g = m[match] @ m[match].T
    iu = np.triu_indices(len(match), 1)
    top = np.argsort(-g[iu], kind="stable")[:4]
    assert [(a["id"], b["id"]) for _, a, b in pairs] == [
        (ids[match[iu[0][t]]], ids[match[iu[1][t]]]) for t in top
    ], pairs

    async def run():
        akb = AsyncKB(path, embed, device="cpu")
        try:
            return await akb.retrieve("query", 5, where={"g": 3})
        finally:
            await akb.close()

    assert asyncio.run(run()) == hits
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


_BLOCKED_HOST_ROUTE = textwrap.dedent(
    """
    import os, sys, zlib

    BLOCKED = ("jax", "jaxlib", "networkx", "ml_dtypes", "aiohttp", "dotenv")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    import svs_tpu_torch.engine.packing as packing
    from svs_tpu_torch import KB, native
    from svs_tpu_torch.engine import RetrievalEngine

    packing.DEFER_MIN_BYTES = 0  # every pack uploads in the background
    RetrievalEngine.HOST_TWOPASS_MIN_ROWS = 64

    def vec(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(20).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vec(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, device="cpu")
    kb.engine.host_dispatch = "auto"
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(800)]
    cold = kb.retrieve("query", 5)  # the host route while the pack uploads
    assert kb.stats()["host_search"]["count"] == 1
    assert kb.engine.wait_for_mirror(timeout=60)
    assert kb.engine.corpus.dev_rescore is not None
    def same(hits):
        assert [h["doc"]["id"] for h in hits] == [h["doc"]["id"] for h in cold]
        assert max(abs(a["score"] - b["score"]) for a, b in zip(hits, cold)) < 1e-6

    kb.engine.host_dispatch = "off"
    same(kb.retrieve("query", 5))
    kb.engine.host_dispatch = "force"
    same(kb.retrieve("query", 5))  # the two-pass, when native
    kb.warmup((1,), n=5, routes="both")
    m = np.stack([vec(f"doc {i}") for i in range(800)])
    s = m @ vec("query")
    assert [h["doc"]["id"] for h in cold] == [ids[j] for j in np.argsort(-s)[:5]]
    assert kb.engine.last_scan == ("native" if native.native_available() else "stream")
    kb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


def _run_blocked(script: str, tmp_path: Path) -> None:
    repo = Path(svs_tpu_torch.__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "kb.sqlite")],
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ROUND_TRIP_OK" in proc.stdout


def test_imports_and_round_trips_without_jax(tmp_path):
    _run_blocked(_BLOCKED_ROUND_TRIP, tmp_path)


def test_bf16_round_trip_and_batch_of_300_without_jax(tmp_path):
    _run_blocked(_BLOCKED_BF16_WIDE_BATCH, tmp_path)


def test_pairwise_without_jax(tmp_path):
    _run_blocked(_BLOCKED_PAIRWISE, tmp_path)


def test_filters_and_async_kb_without_jax(tmp_path):
    _run_blocked(_BLOCKED_FILTERS_ASYNC, tmp_path)


def test_host_route_and_deferred_upload_without_jax(tmp_path):
    _run_blocked(_BLOCKED_HOST_ROUTE, tmp_path)


def test_kb_without_device_refuses_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: KB() legitimately uses it")
    with pytest.raises(RuntimeError, match="CUDA"):
        svs_tpu_torch.KB(
            tmp_path / "kb.sqlite",
            svs_tpu_torch.make_mock_embeddings_func(),
            force_fresh_db=True,
        )
    assert not (tmp_path / "kb.sqlite").exists()
