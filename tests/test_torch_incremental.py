"""The PyTorch port's incremental repacks against the JAX package on the
CPU: after each write to one store, both engines refresh from the same
file and their packs (bytes, scales, ``emb_ids``, ``n_valid``,
``scale_max``, the host f32 cache and its row map), their device mirrors
and their ``pack_events`` must agree; then both ``KB``s search one file
after the same writes and return the same hits."""

import zlib

import numpy as np
import pytest
import torch

import svs_tpu
from svs_tpu.engine import RetrievalEngine as JaxEngine
from svs_tpu.store import Database as JaxDatabase
from svs_tpu.store import embedding_to_bytes
import svs_tpu_torch
from svs_tpu_torch.engine import RetrievalEngine
from svs_tpu_torch.store.db import Database

torch.set_num_threads(2)

DIM = 32
N_DOCS = 300
#: f32 dots accumulate in another order in XLA and torch
SCORE_ATOL = 2e-6
PRECISIONS = ["int8", "bf16", "f32"]


def _words(a) -> np.ndarray:
    """A pack of either package as NumPy (bf16 as its 16-bit words)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.cpu().numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def assert_same_pack(ref, got) -> None:
    """``got`` (the port's corpus) holds ``ref``'s (the JAX package's) pack,
    and its device mirrors are its host cache, as a rebuild uploads it."""
    np.testing.assert_array_equal(_words(got.data), _words(ref.data))
    assert (got.row_scales is None) == (ref.row_scales is None)
    if ref.row_scales is not None:
        np.testing.assert_array_equal(_words(got.row_scales), _words(ref.row_scales))
    np.testing.assert_array_equal(got.emb_ids, ref.emb_ids)
    assert (got.n_valid, got.dim, got.version, got.precision) == (
        ref.n_valid, ref.dim, ref.version, ref.precision,
    )
    assert got.scale_max == ref.scale_max
    assert (got.host_cache is None) == (ref.host_cache is None)
    if ref.host_cache is not None:
        np.testing.assert_array_equal(got.host_f32, ref.host_f32)
        assert (got.host_row_map is None) == (ref.host_row_map is None)
        if ref.host_row_map is not None:
            np.testing.assert_array_equal(got.host_row_map, ref.host_row_map)
    assert (got.dev_rescore is None) == (ref.dev_rescore is None)
    if got.dev_rescore is not None:
        dev_f32, dev_map = got.dev_rescore
        if got.precision == "f32":
            assert dev_f32 is got.data and dev_map is None
        else:
            np.testing.assert_array_equal(dev_f32.numpy(), got.host_f32)
            assert (dev_map is None) == (got.host_row_map is None)
            if dev_map is not None:
                np.testing.assert_array_equal(dev_map.numpy(), got.host_row_map)
                np.testing.assert_array_equal(
                    dev_map.numpy(), np.asarray(ref.dev_rescore[1])
                )
        np.testing.assert_array_equal(got.dev_emb.numpy(), got.emb_ids)


def unit_rows(rng, n: int) -> np.ndarray:
    m = rng.standard_normal((n, DIM)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


class Pair:
    """One store, the JAX engine and the port's on it, refreshed in turn."""

    def __init__(self, path, precision: str, n_docs: int = N_DOCS) -> None:
        self.rng = np.random.default_rng(7)
        self.jdb = JaxDatabase(path)
        self.tdb = Database(path)
        self.ref = JaxEngine(precision=precision)
        self.port = RetrievalEngine(precision=precision, device="cpu")
        if n_docs:
            self.add(n_docs)

    def add(self, n: int) -> None:
        with self.jdb.transaction() as tx:
            for v in unit_rows(self.rng, n):
                tx.add_doc("d", None, None, embedding_to_bytes(v.tolist()))
            tx.bump_matrix_version()

    def delete_rows(self, rows) -> None:
        """Delete the docs at the port's current pack rows ``rows``."""
        ids = self.port.corpus.emb_ids[np.asarray(rows)]
        with self.jdb.transaction() as tx:
            for emb_id in ids:
                tx.del_doc(tx.doc_id_for_emb_id(int(emb_id)))
            tx.bump_matrix_version()

    def refresh(self, sidecar=None):
        """Both engines' ``ensure_fresh``; checks the packs and events agree
        and returns the port's corpus."""
        ref = self.ref.ensure_fresh(self.jdb, sidecar)
        got = self.port.ensure_fresh(self.tdb, sidecar)
        assert_same_pack(ref, got)
        assert self.port.pack_events == self.ref.pack_events
        return got

    def close(self) -> None:
        self.port.shutdown()
        self.ref.shutdown()
        self.jdb.close()
        self.tdb.close()


@pytest.fixture
def pair(tmp_path, request):
    p = Pair(tmp_path / "s.sqlite", request.param)
    yield p
    p.close()


def _events(pair):
    return {k: v for k, v in pair.port.pack_events.items() if v}


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
def test_append_that_fits_the_padding(pair):
    first = pair.refresh()
    pair.add(50)
    got = pair.refresh()
    assert got.n_valid == N_DOCS + 50 and got.n_padded == first.n_padded == 512
    assert _events(pair) == {"scan": 1, "append": 1}


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
def test_append_that_grows_the_pack(pair):
    pair.refresh()
    pair.add(300)
    got = pair.refresh()
    assert got.n_valid == 600 and got.n_padded == 768
    pair.add(200)  # grows again from an appended pack
    assert pair.refresh().n_padded == 1024
    assert _events(pair) == {"scan": 1, "append": 2}


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
def test_tail_delete_moves_nothing(pair):
    first = pair.refresh()
    pair.delete_rows([N_DOCS - 3, N_DOCS - 2, N_DOCS - 1])
    got = pair.refresh()
    assert got.data is first.data  # only the mask boundary moved
    assert got.n_valid == N_DOCS - 3
    assert _events(pair) == {"scan": 1, "delete": 1}


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
def test_delete_then_append_then_delete(pair):
    pair.refresh()
    pair.delete_rows([0, 150, 151, 298])
    got = pair.refresh()
    assert got.host_row_map is not None  # made explicit by the compaction
    pair.add(40)
    got = pair.refresh()
    pair.delete_rows([1, got.n_valid - 20, got.n_valid - 1])
    got = pair.refresh()
    assert got.n_valid == N_DOCS - 4 + 40 - 3
    assert _events(pair) == {"scan": 1, "delete": 2, "append": 1}


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
@pytest.mark.parametrize("write", ["bulk_wipe", "delete_everything", "mixed"])
def test_writes_that_fall_back_to_a_scan(pair, write):
    pair.refresh()
    if write == "bulk_wipe":  # half the pack: a repack reclaims the buffer
        pair.delete_rows(np.arange(0, N_DOCS, 2))
    elif write == "delete_everything":
        pair.delete_rows(np.arange(N_DOCS))
    else:  # a delete and an add in one transaction
        ids = pair.port.corpus.emb_ids[:5]
        with pair.jdb.transaction() as tx:
            for emb_id in ids:
                tx.del_doc(tx.doc_id_for_emb_id(int(emb_id)))
            for v in unit_rows(pair.rng, 5):
                tx.add_doc("d", None, None, embedding_to_bytes(v.tolist()))
            tx.bump_matrix_version()
    pair.refresh()
    assert _events(pair) == {"scan": 2}


@pytest.mark.parametrize("precision", PRECISIONS)
def test_append_onto_an_empty_pack_scans(tmp_path, precision):
    pair = Pair(tmp_path / "s.sqlite", precision, n_docs=0)
    try:
        assert pair.refresh().n_valid == 0
        pair.add(10)
        assert pair.refresh().n_valid == 10
        assert _events(pair) == {"scan": 2}
    finally:
        pair.close()


@pytest.mark.parametrize("precision", ["int8", "f32"])
def test_permuted_pack_appends_and_deletes_like_reference(tmp_path, precision):
    """A pack of 16,384 rows and more is permuted (cache in scan order,
    the permutation as its row map): the append extends the map and the
    delete re-points it, as the reference does."""
    pair = Pair(tmp_path / "s.sqlite", precision, n_docs=16_400)
    try:
        got = pair.refresh()
        assert got.host_row_map is not None or precision == "f32"
        pair.add(100)
        pair.refresh()
        pair.delete_rows([3, 9000, 16_450])
        got = pair.refresh()
        assert got.n_padded == 32_768
        assert _events(pair) == {"scan": 1, "append": 1, "delete": 1}
    finally:
        pair.close()


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
@pytest.mark.parametrize("write", ["append", "delete"])
def test_held_corpus_keeps_its_bytes(pair, write):
    """A search holding the previous corpus reads exactly the rows it
    started with: the repack writes new buffers."""
    old = pair.refresh()
    data = _words(old.data).copy()
    scales = None if old.row_scales is None else old.row_scales.clone()
    mirror = old.dev_rescore[0].clone()
    emb_ids = old.emb_ids.copy()
    if write == "append":
        pair.add(20)
    else:
        pair.delete_rows([0, 10, 20])
    new = pair.refresh()
    assert new is not old
    np.testing.assert_array_equal(_words(old.data), data)
    if scales is not None:
        assert torch.equal(old.row_scales, scales)
    assert torch.equal(old.dev_rescore[0], mirror)
    np.testing.assert_array_equal(old.emb_ids, emb_ids)
    assert old.n_valid == N_DOCS


# -- the KB facades ----------------------------------------------------------


def _vector(text: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    v = rng.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


async def _embed(texts):
    return [_vector(t).tolist() for t in texts]


def _ids(results):
    return [[h["doc"]["id"] for h in hits] for hits in results]


def _assert_same_hits(ref, got):
    assert _ids(got) == _ids(ref)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(
            [h["score"] for h in g], [h["score"] for h in r], rtol=0, atol=SCORE_ATOL
        )


@pytest.fixture
def kbs(tmp_path, request):
    """The reference's ``KB`` and the port's on one store of ``N_DOCS``."""
    path = tmp_path / "kb.sqlite"
    ref = svs_tpu.KB(path, _embed, force_fresh_db=True, precision=request.param)
    with ref.bulk_add_docs() as add:
        for i in range(N_DOCS):
            add(f"doc {i}")
    port = svs_tpu_torch.KB(path, _embed, device="cpu", precision=request.param)
    yield ref, port
    port.close()
    ref.close()


def _both(kbs, queries, n=10):
    ref, port = kbs
    got = port.retrieve_batch(queries, n)
    want = ref.retrieve_batch(queries, n)
    _assert_same_hits(want, got)
    assert port.stats()["pack_events"] == ref.stats()["pack_events"]
    return got


@pytest.mark.parametrize("kbs", PRECISIONS, indirect=True)
def test_kb_appends_and_deletes_match_reference(kbs):
    """Writes through the port's ``KB`` on a store both have packed: both
    repack incrementally and return the same hits; new docs come back
    first for their own text, deleted ones never."""
    _, port = kbs
    _both(kbs, [f"doc {i}" for i in range(8)])
    with port.bulk_add_docs() as add:
        new = [add(f"new doc {i}") for i in range(30)]
    got = _both(kbs, [f"new doc {i}" for i in range(30)])
    assert [hits[0]["doc"]["id"] for hits in got] == new
    with port.bulk_del_docs() as delete:
        for doc_id in new[::3]:
            delete(doc_id)
    got = _both(kbs, [f"new doc {i}" for i in range(30)])
    assert not set(new[::3]) & {i for row in _ids(got) for i in row}
    events = port.stats()["pack_events"]
    assert (events["scan"], events["append"], events["delete"]) == (1, 1, 1)


@pytest.mark.parametrize("kbs", PRECISIONS, indirect=True)
def test_kb_random_deletes_never_surface(kbs):
    """Rounds of random deletes, each followed by a search for the deleted
    docs' own texts: no deleted doc comes back, and the hits are the
    reference's."""
    _, port = kbs
    rng = np.random.default_rng(11)
    _both(kbs, ["doc 0"])
    with port.bulk_query_docs() as q:
        live = {d["text"]: d["id"] for d in q.query_level(0)}
    gone = set()
    for _ in range(4):
        texts = sorted(rng.choice(sorted(live), 12, replace=False))
        with port.bulk_del_docs() as delete:
            for t in texts:
                delete(live.pop(t))
                gone.add(t)
        got = _both(kbs, texts, n=20)
        assert not gone & {h["doc"]["text"] for hits in got for h in hits}
    assert port.stats()["pack_events"]["delete"] == 4


@pytest.mark.parametrize("kbs", ["int8", "f32"], indirect=True)
def test_kb_pairwise_after_incremental_repacks(kbs):
    """Top pairs after an append and a compacting delete: the stale rows
    past ``n_valid`` are never paired."""
    ref, port = kbs
    _both(kbs, ["doc 1"])
    with port.bulk_add_docs() as add:
        for i in range(5):
            add(f"doc {i}")  # exact duplicates of five docs: the top pairs
    _both(kbs, ["doc 2"])
    with port.bulk_query_docs() as q:
        roots = q.query_level(0)
    with port.bulk_del_docs() as delete:
        for d in roots[10:30]:
            delete(d["id"])
    got = port.document_top_pairwise_scores(10)
    want = ref.document_top_pairwise_scores(10)
    assert [(a["id"], b["id"]) for _, a, b in got] == [
        (a["id"], b["id"]) for _, a, b in want
    ]
    np.testing.assert_allclose(
        [s for s, _, _ in got], [s for s, _, _ in want], rtol=0, atol=SCORE_ATOL
    )
    events = port.stats()["pack_events"]
    assert (events["scan"], events["append"], events["delete"]) == (1, 1, 1)
