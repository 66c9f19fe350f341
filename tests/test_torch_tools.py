"""The port's maintenance tools (``svs_tpu_torch.tools``), its
reference-name alias module (``svs_tpu_torch.util``) and its ``.env``
loader against ``svs_tpu``'s on the CPU.

The cases of the reference's ``tests/test_tools.py`` run as parity cases:
each package's tool runs on its own copy of one store (the port's with
``device='cpu'``) and the results must be equal: the re-embedded stores
row for row, the near-duplicate pairs (scores within ``SCORE_ATOL``), and
``selfcheck``'s reports (paths aside).  The cases of
``tests/test_util_alias.py`` hold ``svs_tpu_torch.util`` to
``svs_tpu.util``; ``load_env``'s built-in parser runs with ``dotenv``
blocked."""

import asyncio
import math
import shutil
import sqlite3

import numpy as np
import pytest
import torch

import svs_tpu
import svs_tpu.tools as ref_tools
import svs_tpu.util as ref_util
import svs_tpu_torch
import svs_tpu_torch.tools as port_tools
import svs_tpu_torch.util as port_util
from svs_tpu.store import Database as RefDatabase
from svs_tpu_torch.store.blob import embedding_to_bytes
from svs_tpu_torch.store.db import Database

from kb_helpers import make_angle_embedder

torch.set_num_threads(2)

SCORE_ATOL = 2e-6


def _angle16(deg_dim=16):
    """A second, distinguishable deterministic provider (2-D rotations
    padded to 16 dims) tagged as storable."""

    async def embed(texts):
        out = []
        for t in texts:
            deg = float(t.split(":")[1]) if t.startswith("angle:") else 0.0
            rad = math.radians(deg)
            out.append([math.cos(rad), math.sin(rad)] + [0.0] * (deg_dim - 2))
        return out

    embed.__embedding_func_params__ = {"provider": "mock"}
    return embed


def _copies(src):
    """Two copies of the store ``src``: svs_tpu's and the port's."""
    out = []
    for name in ("ref", "port"):
        d = src.parent / name
        d.mkdir(exist_ok=True)
        shutil.copy(src, d / src.name)
        out.append(d / src.name)
    return out


def _dump(path):
    """Everything a store holds, by the port's store layer: docs (DFS, with
    embeddings), edges as rows, user keys."""
    kb = svs_tpu_torch.KB(path, _angle16(), device="cpu")
    try:
        with kb.bulk_query_docs() as q:
            docs = list(q.dfs_traversal(include_embedding=True))
        with kb.db.transaction() as tx:
            edges = list(tx.iter_edges())
        with kb.bulk_keyval_update() as kv:
            items = sorted(kv.items())
        return docs, edges, items
    finally:
        kb.close()


def test_reembed_preserves_everything(tmp_path):
    src_path = tmp_path / "src.sqlite"
    src = svs_tpu.KB(src_path, make_angle_embedder())
    with src.bulk_add_docs() as add:
        root = add("angle:0", meta={"kind": "root"})
        kid = add("angle:10", parent_id=root)
        add("angle:20", no_embedding=True)
    with src.bulk_graph_update() as g:
        g.add_edge(root, kid, root, weight=1.25)
    with src.bulk_keyval_update() as kv:
        kv["source"] = "unit-test"
    src.close()
    ref_src, port_src = _copies(src_path)
    assert ref_tools.reembed(ref_src, ref_src.with_name("dest.sqlite"), _angle16()) == 3
    assert port_tools.reembed(port_src, port_src.with_name("dest.sqlite"), _angle16(),
                              device="cpu") == 3
    want = _dump(ref_src.with_name("dest.sqlite"))
    got = _dump(port_src.with_name("dest.sqlite"))
    assert got == want
    docs, edges, items = got
    by_text = {d["text"]: d for d in docs}
    assert by_text["angle:10"]["parent_id"] == by_text["angle:0"]["id"]
    assert by_text["angle:0"]["meta"] == {"kind": "root"}
    assert len(by_text["angle:0"]["embedding"]) == 16
    assert by_text["angle:20"]["embedding"] is None
    assert len(edges) == 1 and items == [("source", "unit-test")]
    dest = svs_tpu_torch.KB(port_src.with_name("dest.sqlite"), _angle16(), device="cpu")
    assert dest.retrieve("angle:9", 1)[0]["doc"]["text"] == "angle:10"
    dest.close()


def test_reembed_faithful_with_mixed_edges(tmp_path):
    """With directed AND undirected edges each undirected edge stays ONE
    row with d=0."""
    src_path = tmp_path / "src.sqlite"
    src = svs_tpu.KB(src_path, make_angle_embedder())
    with src.bulk_add_docs() as add:
        a, b, c = add("angle:0"), add("angle:10"), add("angle:20")
    with src.bulk_graph_update() as g:
        g.add_edge(a, b, c, weight=0.5)
        g.add_directed_edge(b, c, a, weight=2.0)
    src.close()
    ref_src, port_src = _copies(src_path)
    ref_tools.reembed(ref_src, ref_src.with_name("dest.sqlite"), make_angle_embedder())
    port_tools.reembed(port_src, port_src.with_name("dest.sqlite"), make_angle_embedder(),
                       device="cpu")
    rows = []
    for path, db_cls in ((ref_src.with_name("dest.sqlite"), RefDatabase),
                         (port_src.with_name("dest.sqlite"), Database)):
        db = db_cls(path)
        with db.transaction() as tx:
            rows.append([(w, d) for _, _, _, w, d in tx.iter_edges()])
        db.close()
    assert rows[0] == rows[1] == [(0.5, False), (2.0, True)]


def test_find_near_duplicates(tmp_path):
    got = []
    for name, kb_cls, kw, tools in (("ref", svs_tpu.KB, {}, ref_tools),
                                    ("port", svs_tpu_torch.KB, {"device": "cpu"},
                                     port_tools)):
        kb = kb_cls(tmp_path / f"{name}.sqlite", make_angle_embedder(), **kw)
        with kb.bulk_add_docs() as add:
            for deg in [0, 1, 90, 180, 179.5, 45]:
                add(f"angle:{deg}")
        got.append((tools.find_near_duplicates(kb, threshold=0.999),
                    tools.find_near_duplicates(kb, threshold=-1.0, max_pairs=7)))
        kb.close()
    for ref, port in zip(got[0], got[1]):
        assert [(a, b) for _, a, b in port] == [(a, b) for _, a, b in ref]
        np.testing.assert_allclose([s for s, _, _ in port], [s for s, _, _ in ref],
                                   rtol=0, atol=SCORE_ATOL)
    assert len(got[1][0]) == 2  # 0/1 and 180/179.5 degrees
    assert got[1][0][0][0] == pytest.approx(math.cos(math.radians(0.5)), abs=1e-6)
    assert len(got[1][1]) == 7


# -- selfcheck --------------------------------------------------------------


def _build_kb(tmp_path, n_docs=30):
    path = tmp_path / "check.sqlite"
    kb = svs_tpu.KB(path, make_angle_embedder())
    with kb.bulk_add_docs() as add:
        root = add("angle:0", meta={"kind": "root"})
        for i in range(1, n_docs):
            add(f"angle:{i * 7 % 360}", parent_id=root if i % 3 else None)
    kb.close()
    return path


def _reports(path, corrupt=None, **kw):
    """``selfcheck`` of svs_tpu and of the port, each on its own copy of
    ``path`` (``corrupt(copy)`` applied to each first), with the paths
    taken out; they must be equal."""
    out = []
    for copy, run in zip(_copies(path), (
        lambda p: ref_tools.selfcheck(p, **kw),
        lambda p: port_tools.selfcheck(p, device="cpu", **kw),
    )):
        if corrupt is not None:
            corrupt(copy)
        report = run(copy)
        assert report.pop("path") == str(copy)
        report["checks"]["sidecar"].pop("path", None)
        out.append(report)
    assert out[1] == out[0]
    return out[1]


@pytest.mark.parametrize("precision", ["bf16", "int8", "f32"])
def test_selfcheck_clean_kb_passes(tmp_path, precision):
    report = _reports(_build_kb(tmp_path), queries=4, n=5, precision=precision)
    assert report["ok"], report
    assert set(report["checks"]) == {
        "sqlite", "schema", "counts", "levels", "embeddings", "sidecar", "retrieval",
    }
    assert report["checks"]["retrieval"]["mismatches"] == []
    assert report["checks"]["retrieval"]["queries"] == 4


def _sql(*statements, params=()):
    def corrupt(path):
        conn = sqlite3.connect(path)
        for st in statements:
            conn.execute(st, params) if "?" in st else conn.execute(st)
        conn.commit()
        conn.close()

    return corrupt


def test_selfcheck_catches_orphan_embedding(tmp_path):
    report = _reports(
        _build_kb(tmp_path),
        _sql("INSERT INTO embeddings (embedding) VALUES (?);",
             params=(embedding_to_bytes([1.0, 0.0]),)),
        queries=2, n=3,
    )
    assert not report["ok"] and not report["checks"]["counts"]["ok"]
    assert report["checks"]["counts"]["orphan_embeddings"] == 1


def test_selfcheck_catches_level_and_magnitude_corruption(tmp_path):
    def corrupt(path):
        conn = sqlite3.connect(path)
        conn.execute("UPDATE docs SET level = 5 WHERE parent_id IS NULL;")
        conn.execute("UPDATE embeddings SET embedding = ? WHERE id = 1;",
                     (embedding_to_bytes([2.0, 0.0]),))
        conn.commit()
        conn.close()

    report = _reports(_build_kb(tmp_path), corrupt, queries=0)
    assert not report["ok"] and report["checks"]["levels"]["bad_roots"] > 0
    assert report["checks"]["embeddings"]["max_magnitude_deviation"] > 0.5


def test_selfcheck_catches_dangling_refs_and_bad_maintained_count(tmp_path):
    report = _reports(_build_kb(tmp_path), _sql(
        "DROP TRIGGER svs_tpu_emb_cnt_insert;",
        "DROP TRIGGER svs_tpu_emb_cnt_delete;",
        "UPDATE keyval SET val = val + 7 WHERE key = 'svs_tpu_emb_count';",
        "UPDATE docs SET embedding = 999999 WHERE id = "
        "(SELECT MAX(id) FROM docs WHERE embedding IS NOT NULL);",
    ), queries=0)
    assert not report["ok"]
    assert report["checks"]["sqlite"]["dangling_embedding_refs"] == 1
    assert not report["checks"]["counts"]["ok"]


def test_selfcheck_fails_when_retrieval_pipeline_crashes(tmp_path, monkeypatch):
    """A retrieve_batch crash surfaces as ok=False with the error."""
    def boom(self, queries, n=10, **kw):
        raise RuntimeError("hydration failed on corrupt row")

    monkeypatch.setattr(svs_tpu.KB, "retrieve_batch", boom)
    monkeypatch.setattr(svs_tpu_torch.KB, "retrieve_batch", boom)
    report = _reports(_build_kb(tmp_path), queries=2, n=3)
    assert not report["ok"] and not report["checks"]["retrieval"]["ok"]
    assert "hydration failed" in report["checks"]["retrieval"]["error"]


def test_selfcheck_tie_cluster_reorder_is_not_a_mismatch(tmp_path):
    eps = math.acos(1 - 1.5e-5)

    async def embed(batch):
        return [[math.cos(eps if t.endswith("b") else 0.0),
                 math.sin(eps if t.endswith("b") else 0.0)] for t in batch]

    path = tmp_path / "ties.sqlite"
    kb = svs_tpu.KB(path, embed)
    with kb.bulk_add_docs() as add:
        add("doc a"), add("doc b"), add("doc a2")
    kb.close()
    report = _reports(path, queries=3, n=3)
    assert report["ok"], report["checks"]["retrieval"]


def test_selfcheck_sidecar_states(tmp_path):
    path = _build_kb(tmp_path)
    assert _reports(path, queries=0)["checks"]["sidecar"]["status"] == "absent"
    # each package writes its own sidecar: the port reports it fresh
    ref_copy, port_copy = _copies(path)
    kb = svs_tpu.KB(ref_copy, make_angle_embedder(), sidecar=True)
    kb.load()
    kb.close()
    kb = svs_tpu_torch.KB(port_copy, make_angle_embedder(), sidecar=True, device="cpu")
    kb.load()
    kb.close()
    for copy, tools, kw in ((ref_copy, ref_tools, {}), (port_copy, port_tools,
                                                         {"device": "cpu"})):
        assert tools.selfcheck(copy, queries=0, **kw)["checks"]["sidecar"]["status"] == "fresh"
    # a foreign write moves the fingerprint on: stale, which is no failure
    # (the copies are made anew; each keeps the sidecar its package wrote)
    report = _reports(path, _sql(
        "INSERT INTO embeddings (embedding) VALUES (X'0000803F00000000');",
        "INSERT INTO docs (parent_id, level, text, embedding, meta) "
        "VALUES (NULL, 0, 'foreign', last_insert_rowid(), NULL);",
    ), queries=0)
    assert report["checks"]["sidecar"] == {"ok": True, "status": "stale"}
    assert report["ok"]


def test_selfcheck_defaults_to_the_cuda_device(tmp_path):
    """Like ``KB``, the replay runs on the card unless ``device`` names
    another: with no card here it refuses instead of running on the CPU."""
    path = _build_kb(tmp_path)
    assert port_tools.selfcheck(path, queries=0)["ok"]  # no KB opened
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the replay legitimately uses it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tools.selfcheck(path, queries=2)


# -- the alias module ------------------------------------------------------------


def test_alias_surface():
    from svs_tpu_torch.util import (  # noqa: F401
        cached,
        chunkify,
        delete_file_if_exists,
        file_cached_wget,
        get_top_k,
        get_top_pairs,
        locked,
        resolve_to_local_uncompressed_file,
    )

    assert sorted(port_util.__all__) == sorted(ref_util.__all__)


def test_get_top_k_matches_svs_tpu_bitwise():
    rng = np.random.default_rng(7)
    for n, k in [(100, 10), (50, 50), (10, 99), (1000, 1)]:
        scores = rng.standard_normal(n).astype(np.float32)
        scores[::7] = scores[0]  # ties, at the boundary too
        assert port_util.get_top_k(scores, k) == ref_util.get_top_k(scores, k)
    assert port_util.get_top_k(np.zeros(5, np.float32), 0) == []


def test_get_top_pairs_matches_svs_tpu_bitwise():
    rng = np.random.default_rng(11)
    m = rng.standard_normal((40, 40)).astype(np.float32)
    m[3, 9] = m[5, 21] = m[0, 1]
    for k in (1, 10, 2000):
        assert port_util.get_top_pairs(m, k) == ref_util.get_top_pairs(m, k)


@pytest.mark.parametrize("util", [ref_util, port_util], ids=["svs_tpu", "port"])
def test_locked_honors_caller_lock(util):
    async def main():
        lock = asyncio.Lock()
        order = []

        @util.locked(lock)
        async def a():
            order.append("a0")
            await asyncio.sleep(0.02)
            order.append("a1")

        @util.locked(lock)
        async def b():
            order.append("b0")
            await asyncio.sleep(0)
            order.append("b1")

        await asyncio.gather(a(), b())
        return order

    assert asyncio.run(main()) == ["a0", "a1", "b0", "b1"]


@pytest.mark.parametrize("util", [ref_util, port_util], ids=["svs_tpu", "port"])
def test_cached_single_flight(util):
    """Concurrent identical calls share one computation; a failure is not
    cached; the LRU bound evicts the oldest."""
    calls = []

    @util.cached(maxsize=2)
    async def f(x):
        calls.append(x)
        await asyncio.sleep(0.01)
        if x < 0:
            raise ValueError(x)
        return x * 2

    async def main():
        assert await asyncio.gather(f(1), f(1), f(1)) == [2, 2, 2]
        assert calls == [1]
        for _ in range(2):
            with pytest.raises(ValueError):
                await f(-1)
        await f(2), await f(3), await f(1)  # 1 was evicted
        return list(calls)

    assert asyncio.run(main()) == [1, -1, -1, 2, 3, 1]


def test_chunkify_matches_svs_tpu():
    for n in (1, 3, 7):
        assert port_util.chunkify(list(range(10)), n) == ref_util.chunkify(list(range(10)), n)
    with pytest.raises(ValueError):
        port_util.chunkify([1], 0)


# -- load_env -----------------------------------------------------------------------


_ENV = """
# a comment
PLAIN=value
export EXPORTED = spaced
QUOTED="a # not a comment"
SINGLE='x=1'
INLINE=v # trailing comment
EMPTY=
PRESET=from-file
no_equals_line
"""


@pytest.mark.parametrize("env", [
    __import__("svs_tpu.utils.env", fromlist=["load_env"]),
    __import__("svs_tpu_torch.utils.env", fromlist=["load_env"]),
], ids=["svs_tpu", "port"])
def test_load_env_builtin_parser(tmp_path, monkeypatch, env):
    """With ``python-dotenv`` blocked both packages parse alike and never
    override a variable already set."""
    monkeypatch.setitem(__import__("sys").modules, "dotenv", None)  # import fails
    keys = ("PLAIN", "EXPORTED", "QUOTED", "SINGLE", "INLINE", "EMPTY", "PRESET")
    for k in keys:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PRESET", "from-env")
    (tmp_path / ".env").write_text(_ENV)
    assert env.load_env(tmp_path / ".env") is True
    import os

    assert {k: os.environ[k] for k in keys} == {
        "PLAIN": "value", "EXPORTED": "spaced", "QUOTED": "a # not a comment",
        "SINGLE": "x=1", "INLINE": "v", "EMPTY": "", "PRESET": "from-env",
    }
    assert env.load_env(tmp_path / "missing.env") is False


def test_load_env_is_exported_from_utils():
    from svs_tpu_torch.utils import load_env
    from svs_tpu_torch.utils.env import load_env as direct

    assert load_env is direct
