"""``svs_tpu_torch.KB(mesh=...)`` against ``svs_tpu.KB(mesh=...)`` on the
CPU: the cases of ``tests/test_kb_mesh.py`` (1-D, 2-D, int8, ``AsyncKB``,
pairwise, the filtered pre-filter route) plus filtered pairwise, which a
mesh answers by post-filtering the exact global pair prefix.  Both
packages open the same store file (written by ``svs_tpu.KB``): the JAX
package on its 8 virtual CPU devices, the port on ``[cpu] * D``.  Ids
must match (except between scores closer than 1e-6, which the two
packages' f32 sums may order either way), scores within 1e-6 (the JAX
tests' own tolerance)."""

import shutil

import jax
import pytest
import torch

import svs_tpu
import svs_tpu_torch
from svs_tpu.parallel import default_mesh as j_default_mesh
from svs_tpu.parallel import mesh_2d as j_mesh_2d
from svs_tpu_torch.parallel import default_mesh, mesh_2d

from kb_helpers import make_angle_embedder

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def need_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _store(path, n=40, meta=None):
    kb = svs_tpu.KB(path, make_angle_embedder())
    with kb.bulk_add_docs() as add:
        for i in range(n):
            add(f"angle:{(i * 7) % 360}", meta=None if meta is None else meta(i))
    kb.close()
    return path


def _open_both(tmp_path, src, j_mesh, t_mesh, **options):
    """``svs_tpu.KB`` and ``svs_tpu_torch.KB`` on copies of one store."""
    paths = []
    for name in ("jax", "port"):
        p = tmp_path / f"{name}.sqlite"
        shutil.copy(src, p)
        paths.append(p)
    return (
        svs_tpu.KB(paths[0], make_angle_embedder(), mesh=j_mesh, **options),
        svs_tpu_torch.KB(paths[1], make_angle_embedder(), mesh=t_mesh, **options),
    )


def _key(hits):
    return [h["doc"]["text"] for h in hits], [h["score"] for h in hits]


#: XLA and torch sum f32 products in other orders: hits whose scores lie
#: closer than this may trade places.
NEAR_TIE = 1e-6


def _same(got, want):
    """Scores within NEAR_TIE rank by rank, and the same hits wherever the
    reference's score at that rank is not tied (within NEAR_TIE) with a
    neighbour's (a tie at the cut may keep either document)."""
    (g_ids, g_s), (w_ids, w_s) = _key(got), _key(want)
    assert len(g_ids) == len(w_ids)
    assert g_s == pytest.approx(w_s, abs=NEAR_TIE)
    for i, (g, w) in enumerate(zip(g_ids, w_ids)):
        if g != w:
            assert abs(g_s[i] - w_s[i]) < NEAR_TIE, (g_ids, w_ids)


def _cpus(n):
    return ["cpu"] * n


@pytest.mark.parametrize("d_shards", [2, 8])
def test_kb_retrieve_on_1d_mesh_matches_jax(tmp_path, d_shards):
    src = _store(tmp_path / "src.sqlite")
    jkb, tkb = _open_both(
        tmp_path, src, j_default_mesh(devices=jax.devices()[:d_shards]),
        default_mesh(devices=_cpus(d_shards)),
    )
    plain = svs_tpu_torch.KB(src, make_angle_embedder(), device="cpu")
    try:
        want = jkb.retrieve("angle:33", 5)
        _same(tkb.retrieve("angle:33", 5), want)
        _same(plain.retrieve("angle:33", 5), want)
        assert tkb.engine.precision == "int8"
        assert len(tkb.engine.corpus.data.row_blocks()) == d_shards
    finally:
        jkb.close()
        tkb.close()
        plain.close()


def test_kb_retrieve_on_2d_mesh_matches_jax(tmp_path):
    """A 'model' axis shards the dim (auto-detected); f32 storage."""
    src = _store(tmp_path / "src.sqlite", n=30)
    jkb, tkb = _open_both(
        tmp_path, src, j_mesh_2d(4, 2), mesh_2d(4, 2, devices=_cpus(8)), precision="f32"
    )
    try:
        got = tkb.retrieve("angle:0", 3)
        _same(got, jkb.retrieve("angle:0", 3))
        assert got[0]["doc"]["text"] == "angle:0"
        assert tkb.engine.model_axis == "model"
    finally:
        jkb.close()
        tkb.close()


def test_kb_2d_mesh_auto_precision_is_bf16(tmp_path):
    """int8 needs whole rows: 'auto' on a dim-sharded mesh stores bf16, as
    the reference's does."""
    src = _store(tmp_path / "src.sqlite", n=30)
    jkb, tkb = _open_both(tmp_path, src, j_mesh_2d(4, 2), mesh_2d(4, 2, devices=_cpus(8)))
    try:
        assert tkb.engine.precision == jkb.engine.precision == "bf16"
        _same(tkb.retrieve("angle:90", 4), jkb.retrieve("angle:90", 4))
    finally:
        jkb.close()
        tkb.close()


def test_kb_int8_on_mesh_matches_jax(tmp_path):
    src = _store(tmp_path / "src.sqlite")
    jkb, tkb = _open_both(
        tmp_path, src, j_default_mesh(), default_mesh(devices=_cpus(8)), precision="int8"
    )
    try:
        got = tkb.retrieve("angle:77", 3)
        _same(got, jkb.retrieve("angle:77", 3))
        assert got[0]["doc"]["text"] == "angle:77"  # exact via the f32 rescore
        assert tkb.engine.corpus.dev_rescore is not None
    finally:
        jkb.close()
        tkb.close()


async def test_async_kb_batch_on_mesh_matches_jax(tmp_path):
    paths = [tmp_path / "jax.sqlite", tmp_path / "port.sqlite"]
    kbs = [
        svs_tpu.AsyncKB(paths[0], make_angle_embedder(), mesh=j_default_mesh()),
        svs_tpu_torch.AsyncKB(paths[1], make_angle_embedder(), mesh=default_mesh(devices=_cpus(8))),
    ]
    res = []
    for kb in kbs:
        async with kb.bulk_add_docs() as add:
            for deg in range(0, 360, 9):
                await add(f"angle:{deg}")
        res.append(await kb.retrieve_batch(["angle:45", "angle:180"], 2))
        await kb.close()
    for got, want in zip(res[1], res[0]):
        _same(got, want)
    assert res[1][0][0]["doc"]["text"] == "angle:45"
    assert res[1][1][0]["doc"]["text"] == "angle:180"


@pytest.mark.parametrize("d_shards", [2, 8, "2x2"])
def test_kb_pairwise_on_mesh_matches_jax(tmp_path, d_shards):
    """The ring on the KB: the top pairs of the JAX mesh KB (on a 2 x 2
    mesh each row block's dim blocks gathered onto its row first)."""
    src = _store(tmp_path / "src.sqlite")
    if d_shards == "2x2":
        meshes = j_mesh_2d(2, 2), mesh_2d(2, 2, devices=_cpus(4))
    else:
        meshes = (j_default_mesh(devices=jax.devices()[:d_shards]),
                  default_mesh(devices=_cpus(d_shards)))
    jkb, tkb = _open_both(tmp_path, src, *meshes)
    try:
        for n in (1, 12):
            want = jkb.document_top_pairwise_scores(n)
            got = tkb.document_top_pairwise_scores(n)
            assert [(d1["text"], d2["text"]) for _, d1, d2 in got] == [
                (d1["text"], d2["text"]) for _, d1, d2 in want
            ]
            assert [s for s, _, _ in got] == pytest.approx([s for s, _, _ in want], abs=1e-6)
    finally:
        jkb.close()
        tkb.close()


def test_kb_filtered_prefilter_on_mesh_matches_jax(tmp_path):
    """A declarative filter on a mesh takes the sharded subset route
    (``subset_topk`` does not decline), agrees with the JAX mesh KB, with
    the post-filter ladder, and again on the cached second call."""
    src = _store(tmp_path / "src.sqlite", n=64, meta=lambda i: {"bucket": i % 8})
    jkb, tkb = _open_both(tmp_path, src, j_default_mesh(), default_mesh(devices=_cpus(8)))
    try:
        calls = []
        real = tkb.engine.subset_topk

        def spy(corpus, vectors, ids, n, key=None):
            res = real(corpus, vectors, ids, n, key)
            calls.append(res is not None)
            return res

        tkb.engine.subset_topk = spy
        got = tkb.retrieve("angle:33", 4, where={"bucket": 3})
        assert calls == [True], "mesh subset route did not engage"
        _same(got, jkb.retrieve("angle:33", 4, where={"bucket": 3}))
        ladder = tkb.retrieve("angle:33", 4, where=lambda d: d["meta"] == {"bucket": 3})
        assert [h["doc"]["id"] for h in ladder] == [h["doc"]["id"] for h in got]
        again = tkb.retrieve("angle:33", 4, where={"bucket": 3})
        assert [h["doc"]["id"] for h in again] == [h["doc"]["id"] for h in got]
        assert calls == [True, True]
    finally:
        jkb.close()
        tkb.close()


@pytest.mark.parametrize("kind", ["dict", "predicate"])
async def test_filtered_pairwise_on_mesh_postfilters(tmp_path, kind):
    """Filtered pairwise on a mesh: no subset corpus, so both facades
    post-filter the exact global pair prefix (widening it 4x while under
    filled); the pairs are the JAX mesh KB's and those of an unsharded
    port KB's subset route."""
    src = _store(tmp_path / "src.sqlite", n=64, meta=lambda i: {"bucket": i % 8})
    where = {"bucket": 3} if kind == "dict" else (lambda d: d["meta"]["bucket"] == 3)
    jkb, tkb = _open_both(tmp_path, src, j_default_mesh(), default_mesh(devices=_cpus(8)))
    plain = svs_tpu_torch.KB(src, make_angle_embedder(), device="cpu")
    try:
        rounds = []
        real = tkb._search.top_pairs

        def spy(corpus, n, where_):
            rounds.append((n, where_ is None))
            return real(corpus, n, where_)

        tkb._search.top_pairs = spy
        got = tkb.document_top_pairwise_scores(5, where=where)
        # the filtered call, then the unfiltered prefixes of the post-filter
        assert rounds[0] == (5, False) and all(unf for _, unf in rounds[1:]) and len(rounds) > 1
        want = jkb.document_top_pairwise_scores(5, where=where)
        subset = plain.document_top_pairwise_scores(5, where=where)

        def key(pairs):
            return [(d1["text"], d2["text"]) for _, d1, d2 in pairs]

        assert key(got) == key(want) == key(subset)
        assert [s for s, _, _ in got] == pytest.approx([s for s, _, _ in want], abs=1e-6)
        assert all(d["meta"]["bucket"] == 3 for _, d1, d2 in got for d in (d1, d2))
    finally:
        jkb.close()
        tkb.close()
        plain.close()
    akb = svs_tpu_torch.AsyncKB(tmp_path / "port.sqlite", make_angle_embedder(),
                                mesh=default_mesh(devices=_cpus(4)))
    try:
        assert key(await akb.document_top_pairwise_scores(5, where=where)) == key(want)
    finally:
        await akb.close()
