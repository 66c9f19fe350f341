"""The port's native host library (``svs_tpu_torch.native``) against
``svs_tpu.native`` and against its own NumPy fallbacks on the CPU: every
entry point gives the same bits (bf16 special values, int8 scales, top-k
ties), the native SQLite scan equals the streaming scan with the
reference's gates (uncommitted writes, WAL), and ``pack_host`` writes the
same bytes with and without the native library."""

import os

import numpy as np
import pytest

from svs_tpu import native as jnative
from svs_tpu.engine.packing import pack_host as jax_pack_host
from svs_tpu_torch import native
from svs_tpu_torch.engine.packing import pack_host
from svs_tpu_torch.store.blob import embedding_to_bytes
from svs_tpu_torch.store.db import Database

pytestmark = pytest.mark.skipif(
    not (native.native_available() and jnative.native_available()),
    reason="no C++ toolchain: the native library did not build",
)


@pytest.fixture
def no_native(monkeypatch):
    """Run the port's NumPy fallbacks (the library is read per call)."""
    monkeypatch.setenv("SVS_TPU_NO_NATIVE", "1")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


SPECIALS = np.array(
    [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40,
     3.4e38, -3.4e38, 1.00390625, 1.01171875, 65504.0],
    dtype=np.float32,
).reshape(1, -1)


@pytest.mark.parametrize("which", ["random", "specials"])
def test_f32_to_bf16_bits(unit_rows, monkeypatch, which):
    m = unit_rows(500, 64) * 3.7 if which == "random" else SPECIALS
    got = native.f32_to_bf16(m)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, _bits(jnative.f32_to_bf16(m)))
    monkeypatch.setenv("SVS_TPU_NO_NATIVE", "1")
    np.testing.assert_array_equal(native.f32_to_bf16(m), got)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 250.0])
def test_quantize_int8_bits(unit_rows, monkeypatch, scale):
    m = unit_rows(300, 96) * scale
    m[7] = 0.0  # a zero row: scale 1e-30 / 127
    q, s = native.quantize_int8(m)
    qr, sr = jnative.quantize_int8(m)
    np.testing.assert_array_equal(q, qr)
    np.testing.assert_array_equal(s, sr)
    monkeypatch.setenv("SVS_TPU_NO_NATIVE", "1")
    qf, sf = native.quantize_int8(m)
    np.testing.assert_array_equal(qf, q)
    np.testing.assert_array_equal(sf, s)


def test_normalize_rows(unit_rows, monkeypatch):
    m = unit_rows(50, 16) * 9.0
    m[3] = 0.0
    got = native.normalize_rows(m)
    np.testing.assert_array_equal(got, jnative.normalize_rows(m))
    np.testing.assert_array_equal(got[3], 0.0)
    monkeypatch.setenv("SVS_TPU_NO_NATIVE", "1")
    np.testing.assert_allclose(native.normalize_rows(m), got, atol=1e-6)


def test_topk_ties(rng, monkeypatch):
    scores = rng.standard_normal(10_000).astype(np.float32)
    scores[100:110] = scores[50]
    scores[200:260] = scores.max()  # more ties than k at the top
    for k in (0, 1, 25, 70, 10_000, 20_000):
        got = native.topk_f32(scores, k)
        assert got == jnative.topk_f32(scores, k)
    monkeypatch.setenv("SVS_TPU_NO_NATIVE", "1")
    assert native.topk_f32(scores, 25) == jnative.topk_f32(scores, 25)


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("n", [300, 17_000])
def test_permute_cast_pack_bits(rng, precision, n):
    d = 40 if n < 1000 else 8
    m = rng.standard_normal((n, d)).astype(np.float32)
    perm = rng.permutation(n)
    n_pad, d_pad = -(-n // 256) * 256, 128
    got = native.permute_cast_pack(m, perm, precision, n_pad, d_pad)
    want = jnative.permute_cast_pack(m, perm, precision, n_pad, d_pad)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        np.testing.assert_array_equal(got[1], want[1])


def test_int8_topc_prescore(rng):
    docs = rng.standard_normal((5000, 70)).astype(np.float32)
    docs[100:140] = docs[99]  # tied reconstruction scores
    di8, scales = native.quantize_int8(docs)
    sums = di8.sum(axis=1, dtype=np.int32)
    q = rng.standard_normal((3, 70)).astype(np.float32)
    q[1] = docs[99]
    s_q = (np.maximum(np.abs(q).max(axis=1), 1e-30) / 127.0).astype(np.float32)
    q_i8 = np.clip(np.rint(q / s_q[:, None]), -127, 127).astype(np.int8)
    for c in (10, 64, 6000):
        got = native.int8_topc_prescore(di8, scales, sums, q_i8, s_q, c)
        want = jnative.int8_topc_prescore(di8, scales, sums, q_i8, s_q, c)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_fallbacks_report_no_native(no_native, rng):
    assert not native.native_available()
    assert native.int8_topc_prescore(
        np.zeros((4, 4), np.int8), np.ones(4, np.float32), None,
        np.zeros((1, 4), np.int8), np.ones(1, np.float32), 2,
    ) is None
    assert native.permute_cast_pack(
        np.zeros((4, 4), np.float32), np.arange(4), "f32", 256, 128
    ) is None
    assert native.scan_embeddings("x.sqlite", -1, 4, 4) is None


def _write_store(path, m, journal=None):
    db = Database(path)
    if journal is not None:
        db.conn.execute(f"PRAGMA journal_mode={journal};")
    with db.transaction() as tx:
        tx.add_docs_bulk([f"d{i}" for i in range(len(m))],
                         [embedding_to_bytes(v) for v in m])
        tx.bump_matrix_version()
    return db


def test_native_scan_matches_streaming_scan(tmp_path, unit_rows, monkeypatch):
    m = unit_rows(300, 24)
    db = _write_store(tmp_path / "scan.sqlite", m)
    try:
        got = native.scan_embeddings(str(db.path), -1, 300, 24)
        nm, nids = got
        np.testing.assert_array_equal(nm, m)
        assert list(nids) == sorted(nids)
        part = native.scan_embeddings(str(db.path), int(nids[99]), 200, 24)
        np.testing.assert_array_equal(part[0], m[100:])
        assert native.scan_embeddings(str(db.path), -1, 299, 24) is None
        assert native.scan_embeddings(str(db.path), -1, 300, 23) is None
        ranges = [(-1, int(nids[149]), 150), (int(nids[149]), int(nids[-1]), 150)]
        par = native.scan_embeddings_parallel(str(db.path), ranges, 300, 24)
        np.testing.assert_array_equal(par[0], m)
        np.testing.assert_array_equal(par[1], nids)
        with db.transaction() as tx:
            tm, tids = tx.build_embeddings_matrix()
            assert tx.last_scan == "native"
            am, aids = tx.fetch_embeddings_after(int(nids[99]))
            assert tx.last_scan == "native"
        np.testing.assert_array_equal(tm, m)
        np.testing.assert_array_equal(tids, nids)
        np.testing.assert_array_equal(am, m[100:])
        # the parallel route from its threshold on
        import svs_tpu_torch.store.tx as txmod

        monkeypatch.setattr(txmod, "_PARALLEL_SCAN_MIN_ROWS", 100)
        with db.transaction() as tx:
            pm, pids = tx.build_embeddings_matrix()
            want = "native_parallel" if (os.cpu_count() or 1) > 1 else "native"
            assert tx.last_scan == want
        np.testing.assert_array_equal(pm, m)
        np.testing.assert_array_equal(pids, nids)
        # ids with gaps: the ranges take the reference's COUNT(*) queries
        with db.transaction() as tx:
            for doc in (5, 150, 151, 299):
                tx.del_doc(doc)
            tx.bump_matrix_version()
        keep = np.ones(300, bool)
        keep[[4, 149, 150, 298]] = False
        with db.transaction() as tx:
            gm, gids = tx.build_embeddings_matrix()
            assert tx.last_scan == want
        np.testing.assert_array_equal(gm, m[keep])
        np.testing.assert_array_equal(gids, nids[keep])
        monkeypatch.setenv("SVS_TPU_NO_NATIVE", "1")
        with db.transaction() as tx:
            sm, sids = tx.build_embeddings_matrix()
            assert tx.last_scan == "stream"
        np.testing.assert_array_equal(sm, m[keep])
        np.testing.assert_array_equal(sids, nids[keep])
    finally:
        db.close()


def test_native_scan_gates(tmp_path, unit_rows):
    """Uncommitted writes of the transaction itself and WAL journals take
    the in-transaction streaming scan."""
    m = unit_rows(64, 8)
    db = _write_store(tmp_path / "gate.sqlite", m)
    try:
        with db.transaction() as tx:
            tx.add_doc("new", None, None, embedding_to_bytes([1.0] + [0.0] * 7))
            got, ids = tx.build_embeddings_matrix()
            assert tx.last_scan == "stream"
            assert got.shape == (65, 8)
            np.testing.assert_array_equal(got[-1], [1.0] + [0.0] * 7)
            tail, _ = tx.fetch_embeddings_after(int(ids[-2]))
            assert tx.last_scan == "stream"
            np.testing.assert_array_equal(tail, got[-1:])
    finally:
        db.close()
    wal = _write_store(tmp_path / "wal.sqlite", m, journal="WAL")
    try:
        with wal.transaction() as tx:
            got, _ = tx.build_embeddings_matrix()
            assert tx.last_scan == "stream"
        np.testing.assert_array_equal(got, m)
    finally:
        wal.close()


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("n", [500, 16_500])
def test_pack_host_same_bytes_with_and_without_native(
    rng, monkeypatch, precision, n
):
    m = rng.standard_normal((n, 20)).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.int64) * 3
    mult = 16384 if n >= 16384 else 256
    fused = pack_host(m, ids, precision, row_multiple=mult)
    ref = jax_pack_host(m, ids, precision, row_multiple=mult)
    monkeypatch.setenv("SVS_TPU_NO_NATIVE", "1")
    plain = pack_host(m, ids, precision, row_multiple=mult)
    for got in (fused, plain):
        np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
        if ref[1] is None:
            assert got[1] is None
        else:
            np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])  # permuted emb ids
        np.testing.assert_array_equal(got[3], ref[3])  # the unpermuted rows
        assert (got[4] is None) == (ref[4] is None)
        if ref[4] is not None:
            np.testing.assert_array_equal(got[4], ref[4])
        assert got[5:] == ref[5:]


def test_build_lands_in_build_dir():
    """The library is built from the package's source into the ignored
    ``build/`` tree, never next to the source, tagged with its ISA."""
    so = native.library_path()
    assert so.exists()
    assert so.parent.parent.name == "native"
    assert so.parent.parent.parent.name == "svs_tpu_torch"
    assert so.parent.parent.parent.parent.name == "build"
    tag = so.with_name(so.name + ".host").read_text().strip()
    assert tag in ("portable", native._host_fingerprint())
    assert not list(native._HERE.glob("*.so"))
