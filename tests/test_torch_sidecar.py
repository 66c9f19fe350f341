"""The PyTorch port's ``.svsx`` sidecar against the JAX package on the CPU:
the file round-trips in each package and across them (int8, bf16, f32),
is refused when stale, corrupt, truncated or of another precision, is not
rewritten over itself, carries a loaded pack through later appends and
deletes as the reference does, and serves the publish flow (a consumer's
open scans nothing, a remote sibling is fetched, a pack without f32
sections gets its rescore cache from a background rebuild)."""

import json
import shutil
import struct
import subprocess
import sys
import textwrap
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import svs_tpu
from svs_tpu.engine import RetrievalEngine as JaxEngine
from svs_tpu.store import embedding_to_bytes
import svs_tpu_torch
from svs_tpu_torch import kb as kb_module
from svs_tpu_torch.engine import RetrievalEngine
from svs_tpu_torch.engine.packing import _is_mmap_backed, pack_host
from svs_tpu_torch.engine.sidecar import (
    load_sidecar,
    save_sidecar_arrays,
    sidecar_fingerprint,
    sidecar_path_for,
)
from svs_tpu_torch.store import tx as tx_module
from svs_tpu_torch.store.db import Database
from svs_tpu_torch.utils import files as files_module

from test_torch_incremental import (
    DIM,
    N_DOCS,
    PRECISIONS,
    SCORE_ATOL,
    Pair,
    _events,
    _words,
    assert_same_pack,
)

torch.set_num_threads(2)


@pytest.fixture
def pair(tmp_path, request):
    p = Pair(tmp_path / "s.sqlite", request.param)
    yield p
    p.close()


def _sidecar(pair) -> Path:
    return sidecar_path_for(pair.tdb.path)


def _fresh_port(pair, path=None):
    """A new port engine on the pair's store: ``(engine, corpus)``."""
    eng = RetrievalEngine(precision=pair.port.precision, device="cpu")
    return eng, eng.ensure_fresh(pair.tdb, path)


def _fresh_ref(pair, path=None):
    eng = JaxEngine(precision=pair.port.precision)
    return eng, eng.ensure_fresh(pair.jdb, path)


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
def test_port_sidecar_round_trips_and_loads_in_reference(pair):
    """The port writes its scanned pack; a new port engine and the JAX
    package's engine each load it without a scan, to the same pack."""
    scanned = pair.refresh()
    pair.port.write_sidecar(_sidecar(pair))
    eng, got = _fresh_port(pair, _sidecar(pair))
    assert eng.pack_events["sidecar"] == 1 and eng.pack_events["scan"] == 0
    np.testing.assert_array_equal(_words(got.data), _words(scanned.data))
    ref_eng, ref = _fresh_ref(pair, _sidecar(pair))
    assert ref_eng.pack_events["sidecar"] == 1 and ref_eng.pack_events["scan"] == 0
    assert_same_pack(ref, got)


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
def test_reference_sidecar_loads_in_port(pair):
    """A file written by ``svs_tpu`` loads in the port with no scan, to the
    bytes of the port's own scan."""
    scanned = pair.refresh()
    pair.ref.write_sidecar(_sidecar(pair))
    eng, got = _fresh_port(pair, _sidecar(pair))
    assert eng.pack_events == {
        "reuse": 0, "append": 0, "delete": 0, "sidecar": 1, "scan": 0,
    }
    assert_same_pack(pair.ref.corpus, got)
    np.testing.assert_array_equal(_words(got.data), _words(scanned.data))
    if got.row_scales is not None:
        assert torch.equal(got.row_scales, scanned.row_scales)
    np.testing.assert_array_equal(got.host_f32, scanned.host_f32)


@pytest.mark.parametrize("pair", ["int8"], indirect=True)
@pytest.mark.parametrize("write", ["version", "fingerprint"])
def test_stale_sidecar_is_ignored(pair, write):
    """A write after the sidecar makes it stale: with a version bump, and
    without one (a tool that does not know the counter): the count, the
    max id and the generation still move the fingerprint."""
    pair.refresh()
    pair.port.write_sidecar(_sidecar(pair))
    with pair.jdb.transaction() as tx:
        tx.add_doc("late", None, None, embedding_to_bytes([1.0] + [0.0] * (DIM - 1)))
        if write == "version":
            tx.bump_matrix_version()
    assert load_sidecar(_sidecar(pair), pair.port._store_fingerprint(pair.tdb)) is None
    eng, got = _fresh_port(pair, _sidecar(pair))
    assert eng.pack_events["scan"] == 1 and eng.pack_events["sidecar"] == 0
    assert got.n_valid == N_DOCS + 1


@pytest.mark.parametrize("pair", ["int8"], indirect=True)
def test_sidecar_of_another_precision_is_ignored(pair):
    pair.refresh()
    pair.port.write_sidecar(_sidecar(pair))
    eng = RetrievalEngine(precision="bf16", device="cpu")
    eng.ensure_fresh(pair.tdb, _sidecar(pair))
    assert eng.pack_events["scan"] == 1 and eng.pack_events["sidecar"] == 0


@pytest.mark.parametrize("pair", ["int8"], indirect=True)
@pytest.mark.parametrize("damage", ["magic", "format", "truncated"])
def test_corrupt_sidecar_is_ignored(pair, damage):
    pair.refresh()
    path = _sidecar(pair)
    pair.port.write_sidecar(path)
    raw = path.read_bytes()
    if damage == "magic":
        raw = b"NOTASIDE" + raw[8:]
    elif damage == "format":
        (n,) = struct.unpack("<I", raw[8:12])
        header = json.loads(raw[12 : 12 + n])
        header["format"] = 99
        body = json.dumps(header).encode()
        raw = raw[:8] + struct.pack("<I", len(body)) + body + raw[12 + n :]
    else:
        raw = raw[: len(raw) - 100]
    path.write_bytes(raw)
    assert load_sidecar(path) is None
    eng, got = _fresh_port(pair, path)
    assert eng.pack_events["scan"] == 1 and eng.pack_events["sidecar"] == 0
    assert got.n_valid == N_DOCS


@pytest.mark.parametrize("pair", ["int8"], indirect=True)
def test_rewrite_skipped_when_loaded_from_that_file(pair):
    pair.refresh()
    path = _sidecar(pair)
    pair.port.write_sidecar(path)
    before = path.stat().st_mtime_ns
    eng, _ = _fresh_port(pair, path)
    eng.write_sidecar(path)
    assert path.stat().st_mtime_ns == before
    other = path.with_name("other.svsx")
    eng.write_sidecar(other)  # another path is written
    assert sidecar_fingerprint(other) == sidecar_fingerprint(path)


@pytest.mark.parametrize("pair", PRECISIONS, indirect=True)
@pytest.mark.parametrize("cache", ["ram", "mapped"])
def test_sidecar_loaded_pack_appends_and_compacts_like_reference(
    pair, cache, monkeypatch
):
    """Both engines start from one sidecar, then take the same append and
    delete: their packs agree at every step, with the f32 cache copied
    into RAM or left on the file's mapping (as a cache past
    ``SVS_TPU_HOST_CACHE_RAM_MAX`` is)."""
    if cache == "mapped":
        monkeypatch.setenv("SVS_TPU_HOST_CACHE_RAM_MAX", "0")
    pair.refresh()
    pair.port.write_sidecar(_sidecar(pair))
    pair.ref = JaxEngine(precision=pair.port.precision)
    pair.port = RetrievalEngine(precision=pair.port.precision, device="cpu")
    got = pair.refresh(_sidecar(pair))
    assert _is_mmap_backed(got.host_f32) == (cache == "mapped")
    pair.add(60)
    pair.refresh(_sidecar(pair))
    pair.delete_rows([0, 5, 299, 350])
    got = pair.refresh(_sidecar(pair))
    assert got.n_valid == N_DOCS + 60 - 4
    assert _events(pair) == {"sidecar": 1, "append": 1, "delete": 1}


@pytest.mark.parametrize("pair", ["int8", "bf16"], indirect=True)
def test_background_rescore_cache_rebuild(pair, monkeypatch):
    """A sidecar without f32 sections loads with no host cache and no
    device mirror; a background scan attaches the cache, and the next
    reuse builds the mirror, as the reference does."""
    pair.refresh()
    with pair.tdb.transaction() as tx:
        matrix, ids = tx.build_embeddings_matrix()
    data, scales, ids, _, _, n, d = pack_host(matrix, ids, pair.port.precision)
    fp = pair.port._store_fingerprint(pair.tdb)
    save_sidecar_arrays(
        _sidecar(pair), n_valid=n, dim=d, precision=pair.port.precision,
        matrix_version=fp[0], fingerprint=fp, emb_ids=ids, row_scales=scales,
        data=data,
    )
    release = threading.Event()
    scan = tx_module.Tx.build_embeddings_matrix

    def held_scan(self):
        assert release.wait(60)  # the rebuild thread waits here
        return scan(self)

    monkeypatch.setattr(tx_module.Tx, "build_embeddings_matrix", held_scan)
    pair.ref = JaxEngine(precision=pair.port.precision)
    pair.port = RetrievalEngine(precision=pair.port.precision, device="cpu")
    ref = pair.ref.ensure_fresh(pair.jdb, _sidecar(pair))
    got = pair.port.ensure_fresh(pair.tdb, _sidecar(pair))
    assert got.host_cache is None and got.dev_rescore is None
    release.set()
    for eng in (pair.port, pair.ref):
        eng._cache_rebuild_thread.join(timeout=60)
        assert not eng._cache_rebuild_thread.is_alive()
    assert got.dev_rescore is None and ref.dev_rescore is None
    np.testing.assert_array_equal(got.host_f32, matrix)
    got = pair.refresh(_sidecar(pair))  # reuse: the mirror is built now
    assert got.dev_rescore is not None
    assert _events(pair) == {"sidecar": 1, "reuse": 1}


# -- the KB facades ----------------------------------------------------------


def _vector(text: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(text.encode()))
    v = rng.standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


async def _embed(texts):
    return [_vector(t).tolist() for t in texts]


QUERIES = [f"doc {i}" for i in range(0, 60, 5)]


def _build(path, n=N_DOCS, **options):
    kb = svs_tpu_torch.KB(path, _embed, force_fresh_db=True, device="cpu", **options)
    with kb.bulk_add_docs() as add:
        for i in range(n):
            add(f"doc {i}")
    return kb


@pytest.fixture
def scans(monkeypatch):
    """Counts the port's full store scans (``Tx.build_embeddings_matrix``)."""
    calls = []
    orig = tx_module.Tx.build_embeddings_matrix

    def counting(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(tx_module.Tx, "build_embeddings_matrix", counting)
    return calls


def _assert_same_hits(ref, got):
    assert [[h["doc"]["id"] for h in r] for r in got] == [
        [h["doc"]["id"] for h in r] for r in ref
    ]
    for r, g in zip(ref, got):
        np.testing.assert_allclose(
            [h["score"] for h in g], [h["score"] for h in r], rtol=0, atol=SCORE_ATOL
        )


@pytest.mark.parametrize("precision", PRECISIONS)
def test_published_kb_opens_with_zero_scans(tmp_path, scans, precision):
    """The publisher's ``close(write_sidecar=True)`` leaves a sidecar; a
    consumer's open scans nothing and returns the hits that
    ``svs_tpu.KB`` reads from the same sidecar."""
    path = tmp_path / "pub.sqlite"
    _build(path, precision=precision).close(write_sidecar=True)
    assert scans, "the publisher pays the scan once"
    scans.clear()
    kb = svs_tpu_torch.KB(path, _embed, device="cpu", precision=precision)
    try:
        got = kb.retrieve_batch(QUERIES, 10)
        assert scans == []
        assert kb.stats()["pack_events"]["sidecar"] == 1.0
    finally:
        kb.close()
    ref_kb = svs_tpu.KB(path, _embed, precision=precision)
    try:
        want = ref_kb.retrieve_batch(QUERIES, 10)
        assert ref_kb.stats()["pack_events"]["sidecar"] == 1.0
    finally:
        ref_kb.close()
    _assert_same_hits(want, got)


def test_reference_published_kb_opens_in_port_with_zero_scans(tmp_path, scans):
    path = tmp_path / "pub.sqlite"
    ref_kb = svs_tpu.KB(path, _embed, force_fresh_db=True)
    with ref_kb.bulk_add_docs() as add:
        for i in range(N_DOCS):
            add(f"doc {i}")
    want = ref_kb.retrieve_batch(QUERIES, 10)
    ref_kb.close(write_sidecar=True)
    kb = svs_tpu_torch.KB(path, _embed, device="cpu")
    try:
        _assert_same_hits(want, kb.retrieve_batch(QUERIES, 10))
        assert scans == [] and kb.stats()["pack_events"]["sidecar"] == 1.0
    finally:
        kb.close()


def test_close_policy(tmp_path, scans):
    """``'auto'`` skips stores under ``SIDECAR_AUTO_MIN_DOCS``; ``False``
    writes nothing unless ``close(write_sidecar=True)`` overrides it, and
    ``write_sidecar=False`` wins over ``True``; a close reuses the live
    pack (no second scan) and skips a file that is current."""
    path = tmp_path / "p.sqlite"
    sc = sidecar_path_for(path)
    _build(path).close()
    assert not sc.exists()
    _build(path, sidecar=False).close()
    assert not sc.exists()
    kb = svs_tpu_torch.KB(path, _embed, device="cpu", sidecar=False)
    kb.close(write_sidecar=True)
    assert sc.exists()
    kb = svs_tpu_torch.KB(path, _embed, device="cpu", sidecar=True)
    sc.unlink()
    kb.close(write_sidecar=False)
    assert not sc.exists()
    kb = _build(path, sidecar=True)
    kb.retrieve_batch(QUERIES[:1], 3)
    scans.clear()
    kb.close(write_sidecar=True)
    assert sc.exists() and scans == []
    before = sc.stat().st_mtime_ns
    kb = svs_tpu_torch.KB(path, _embed, device="cpu", sidecar=True)
    kb.retrieve_batch(QUERIES[:1], 3)
    kb.close(write_sidecar=True)
    assert sc.stat().st_mtime_ns == before
    svs_tpu_torch.KB(path, _embed, force_fresh_db=True, device="cpu").close()
    assert not sc.exists()  # force_fresh_db drops the sidecar too


def test_load_writes_per_policy(tmp_path, monkeypatch):
    path = tmp_path / "l.sqlite"
    sc = sidecar_path_for(path)
    kb = _build(path)
    kb.load()  # 'auto', under the threshold
    assert not sc.exists()
    monkeypatch.setattr(kb_module, "SIDECAR_AUTO_MIN_DOCS", N_DOCS)
    kb.load()
    assert sidecar_fingerprint(sc) is not None
    kb.close()
    kb = svs_tpu_torch.KB(path, _embed, device="cpu", sidecar=True)
    before = sc.stat().st_mtime_ns
    kb.load()  # loaded from that file: not rewritten
    assert kb.stats()["pack_events"]["sidecar"] == 1.0
    assert sc.stat().st_mtime_ns == before
    kb.close()


def test_publish_after_a_delete_writes_the_compacted_pack(tmp_path, scans):
    """After an incremental delete the pack in hand is current: ``close``
    publishes it (the f32 cache in pack order) without a scan, and both
    packages load it to the same hits."""
    path = tmp_path / "d.sqlite"
    kb = _build(path)
    kb.retrieve_batch(QUERIES, 10)
    with kb.bulk_query_docs() as q:
        docs = q.query_level(0)
    with kb.bulk_del_docs() as delete:
        for d in docs[:40:3]:
            delete(d["id"])
    got = kb.retrieve_batch(QUERIES, 10)
    assert kb.stats()["pack_events"]["delete"] == 1.0
    scans.clear()
    kb.close(write_sidecar=True)
    assert scans == []
    loaded = load_sidecar(sidecar_path_for(path))
    assert loaded is not None and "_f32_row_map" not in loaded[3]
    _, _, emb_ids, header = loaded
    db = Database(path)
    try:
        with db.transaction() as tx:
            rows = tx.fetch_embedding_rows(emb_ids.tolist())
    finally:
        db.close()
    np.testing.assert_array_equal(header["_f32_cache"], rows)
    for package in (svs_tpu, svs_tpu_torch):
        options = {"device": "cpu"} if package is svs_tpu_torch else {}
        k = package.KB(path, _embed, **options)
        try:
            _assert_same_hits(got, k.retrieve_batch(QUERIES, 10))
            assert k.stats()["pack_events"]["sidecar"] == 1.0
        finally:
            k.close()


def test_remote_consumer_fetches_the_published_sidecar(tmp_path, monkeypatch, scans):
    """A KB opened from a URL fetches ``<db>.svsx`` beside ``<db>.gz`` (the
    download is ``file_cached_wget``, stubbed here to serve local files)
    and opens with zero scans; without a sibling it rescans."""
    monkeypatch.chdir(tmp_path)
    pub = tmp_path / "pub.sqlite"
    _build(pub).close(vacuum=True, also_gzip=True, write_sidecar=True)
    served = {
        "http://kb.invalid/pub.sqlite.gz": pub.with_name("pub.sqlite.gz"),
        "http://kb.invalid/pub.sqlite.svsx": sidecar_path_for(pub),
    }
    fetched = []

    async def fake_wget(url):
        if url not in served:
            raise FileNotFoundError(url)
        fetched.append(url)
        dest = tmp_path / "cache" / Path(url).name
        dest.parent.mkdir(exist_ok=True)
        shutil.copy(served[url], dest)
        return dest

    monkeypatch.setattr(files_module, "file_cached_wget", fake_wget)
    scans.clear()
    kb = svs_tpu_torch.KB("http://kb.invalid/pub.sqlite.gz", _embed, device="cpu")
    try:
        assert kb.retrieve("doc 7", 1)[0]["doc"]["text"] == "doc 7"
        assert scans == [] and "http://kb.invalid/pub.sqlite.svsx" in fetched
    finally:
        kb.close()
    del served["http://kb.invalid/pub.sqlite.svsx"]
    shutil.rmtree(tmp_path / "cache")
    kb = svs_tpu_torch.KB("http://kb.invalid/pub.sqlite.gz", _embed, device="cpu")
    try:
        assert kb.retrieve("doc 7", 1)[0]["doc"]["text"] == "doc 7"
        assert kb.stats()["pack_events"]["scan"] == 1.0
    finally:
        kb.close()


_BLOCKED_BF16_SIDECAR = textwrap.dedent(
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

    def vector(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        v = rng.standard_normal(32).astype(np.float32)
        return v / np.linalg.norm(v)

    async def embed(texts):
        return [vector(t).tolist() for t in texts]

    path = sys.argv[1]
    kb = KB(path, embed, force_fresh_db=True, device="cpu", precision="bf16")
    with kb.bulk_add_docs() as add:
        ids = [add(f"doc {i}") for i in range(200)]
    want = kb.retrieve_batch(["doc 3", "doc 150"], 5)
    kb.close(write_sidecar=True)
    kb = KB(path, embed, device="cpu", precision="bf16")
    got = kb.retrieve_batch(["doc 3", "doc 150"], 5)
    events = kb.stats()["pack_events"]
    assert events["sidecar"] == 1 and events["scan"] == 0, events
    assert [[h["doc"]["id"] for h in r] for r in got] == [
        [h["doc"]["id"] for h in r] for r in want
    ]
    assert got[0][0]["doc"]["id"] == ids[3] and got[1][0]["doc"]["id"] == ids[150]
    kb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("svs_tpu",))
    assert not loaded, loaded
    print("ROUND_TRIP_OK")
    """
)


def test_bf16_sidecar_without_ml_dtypes(tmp_path):
    repo = Path(svs_tpu_torch.__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_BF16_SIDECAR, str(tmp_path / "kb.sqlite")],
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ROUND_TRIP_OK" in proc.stdout
