"""The port's benchmark probes (``svs_tpu_torch.probes``) against the Pallas
probes of ``benchmarks/`` in interpret mode on the CPU, on the same seeded
inputs at small shapes: P9 (``tpu_int8_opt.py``), P8 (``tpu_bf16_opt.py``)
and P7 (``tpu_select11.py``).  On the CPU each probe wrapper runs its
kernel's plain version, so these tests hold the plain versions; the smoke
holds the CUDA kernels to them on the card.

The scripts are loaded from their files, unchanged.  P9's and P8's ``run``
fixes the probe's full shape and has no interpret switch, so their own
``make_kern`` bodies go through a ``pl.pallas_call`` here with ``run``'s
block specs; P7 runs its own ``extract4096`` in interpret mode through its
``SVS_SELECT11_SMOKE`` switch.  Only the lanes a probe writes are compared
(P9 and P8 leave the lanes past the guard unwritten).

int8 keys are bit-identical except where XLA on the CPU contracts a product
and the add after it into one fused multiply-add (the Pallas source writes
them apart; the port rounds each step): each mismatch is shown to be
exactly that.  bf16 keys are bit-identical on lattice data, where every
partial sum is exact, and within one grid step at a grid edge on random
unit rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from svs_tpu_torch.probes import bf16_opt, int8_opt, select11
from svs_tpu_torch.probes import common as C
from torch_probe_helpers import bits, lattice_rows, load_script, unit_rows, written

torch.set_num_threads(2)

N = 3 * 8192  # three 8,192-doc blocks, six of 4,096
D = 256
B = 16
N_VALID = N - 100  # a partial last subtile

# P7 needs more than its 4 subtiles' worth of contraction steps (d > 512)
# and a multiple of 8,192 docs for the floor at 8,192
N7 = 4 * 8192
D7 = 640
N7_VALID = N7 - 100


@pytest.fixture(scope="module")
def p9():
    return load_script("tpu_int8_opt")


@pytest.fixture(scope="module")
def p8():
    return load_script("tpu_bf16_opt")


@pytest.fixture(scope="module")
def p7():
    return load_script("tpu_select11", SVS_SELECT11_SMOKE="1")


# --- P9: int8 -------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_data():
    rng = np.random.default_rng(2109)
    docs, rs = C.quantize_docs(torch.from_numpy(unit_rows(rng, N, D)))
    qz = C.quantize_queries(unit_rows(rng, B, D))
    return {"docs": docs.numpy(), "rs": rs.numpy(), **qz}


def _p9_pallas(p9, data, variant: str, chunk: int) -> np.ndarray:
    """``make_kern(variant)`` through ``run``'s specs at this test's shape,
    in interpret mode."""
    return np.asarray(
        pl.pallas_call(
            p9.make_kern(variant),
            grid=(N // p9.BLOCK_N, D // chunk),
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.SMEM),
                pl.BlockSpec((B, chunk), lambda j, c: (0, c)),
                pl.BlockSpec((B, 1), lambda j, c: (0, 0)),
                pl.BlockSpec((B, 1), lambda j, c: (0, 0)),
                pl.BlockSpec((B, 1), lambda j, c: (0, 0)),
                pl.BlockSpec((p9.BLOCK_N, chunk), lambda j, c: (j, c)),
                pl.BlockSpec((1, p9.BLOCK_N), lambda j, c: (0, j)),
            ],
            out_specs=pl.BlockSpec((B, p9.OUT_LANES), lambda j, c: (0, j)),
            out_shape=jax.ShapeDtypeStruct((B, (N // p9.BLOCK_N) * p9.OUT_LANES), jnp.float32),
            scratch_shapes=[pltpu.VMEM((B, p9.BLOCK_N), jnp.int32)],
            interpret=True,
        )(
            jnp.asarray([N_VALID], jnp.int32), data["qi"], data["qs"][:, None],
            data["qb"][:, None], data["qq"][:, None], data["docs"], data["rs"][None, :],
        )
    )


def _p9_port(data, variant: str, chunk: int) -> np.ndarray:
    t = {k: torch.from_numpy(np.array(data[k], copy=True)) for k in ("docs", "rs", "qi", "qs", "qb", "qq")}
    return int8_opt.extract(
        t["docs"], t["qi"], t["qs"], t["qb"], t["qq"], t["rs"], N_VALID, variant, chunk
    ).numpy()


def _p9_subtile_keys(data, row: int, sub: int, variant: str, fused: bool) -> np.ndarray:
    """The top-4 keys of one 1024-doc subtile, emulated in NumPy with the
    key's product and add either rounded apart (as written) or contracted
    into one fused multiply-add (an exact product, one rounding)."""
    lanes = np.arange(C.SUBTILE)
    rows = sub * C.SUBTILE + lanes
    acc = (data["docs"][rows].astype(np.int64) @ data["qi"][row].astype(np.int64)).astype(np.float32)
    rs = data["rs"][rows]
    if variant == "v3":
        prod = (acc * rs).astype(np.float32)
        if fused:
            t = (prod.astype(np.float64) * np.float64(data["qs"][row]) + C.KEY_BIAS).astype(np.float32)
        else:
            t = (prod * data["qs"][row]).astype(np.float32) + np.float32(C.KEY_BIAS)
        x = t * np.float32(C.QS3)
    else:  # v3dq: (acc * rs + qb) * qq
        if fused:
            t = (acc.astype(np.float64) * rs.astype(np.float64) + np.float64(data["qb"][row])).astype(np.float32)
        else:
            t = (acc * rs).astype(np.float32) + data["qb"][row]
        x = t * data["qq"][row]
    keys = np.floor(x) * np.float32(C.SUBTILE) + lanes
    keys = np.where(rows < N_VALID, keys, C.KEY_DEAD).astype(np.float32)
    return np.unique(keys)[::-1][: C.H]


@pytest.mark.parametrize("chunk", int8_opt.CHUNKS)
@pytest.mark.parametrize("variant", ["mm", "v3", "v3dq"])
def test_p9_plain_matches_pallas(p9, int8_data, variant, chunk):
    """mm bit for bit; v3 and v3dq bit for bit on the written lanes, but
    for subtiles where XLA contracted the key's product and add into an
    FMA: there a NumPy emulation of the FMA gives the reference's keys and
    the as-written one the port's, and each tile's guard is the max of its
    own subtiles' 4th keys."""
    ref = _p9_pallas(p9, int8_data, variant, chunk)
    got = _p9_port(int8_data, variant, chunk)
    assert got.shape == ref.shape
    if variant == "mm":
        np.testing.assert_array_equal(bits(got), bits(ref))
        return
    nk = 8 * C.H
    ref = written(ref, nk)
    diff = np.argwhere(bits(ref) != bits(got))
    subtiles = sorted({(r, (c // C.OUT_LANES) * 8 + (c % C.OUT_LANES) // C.H)
                       for r, c in diff if c % C.OUT_LANES < nk})
    assert len(subtiles) <= 4, f"{len(subtiles)} subtiles differ"

    def cols(sub):
        return slice((sub // 8) * C.OUT_LANES + (sub % 8) * C.H,
                     (sub // 8) * C.OUT_LANES + (sub % 8 + 1) * C.H)

    for row, sub in subtiles:
        np.testing.assert_array_equal(ref[row, cols(sub)], _p9_subtile_keys(int8_data, row, sub, variant, True))
        np.testing.assert_array_equal(got[row, cols(sub)], _p9_subtile_keys(int8_data, row, sub, variant, False))
    # the emulation itself: as written, it is the port (the last subtile partial)
    for row, sub in ((0, 0), (B - 1, 13), (3, N // C.SUBTILE - 1)):
        np.testing.assert_array_equal(got[row, cols(sub)], _p9_subtile_keys(int8_data, row, sub, variant, False))
    for t in (ref, got):
        t3 = t.reshape(B, -1, C.OUT_LANES)
        np.testing.assert_array_equal(t3[:, :, nk], t3[:, :, C.H - 1 : nk : C.H].max(axis=2))


def test_p9_v3dq_agreement_as_the_probe_reports_it(p9, int8_data):
    """The share of v3's written lanes that v3dq reproduces: the port's
    report against the same share of the Pallas probe's outputs (equal but
    for the FMA subtiles the test above explains, one lane's worth of
    difference per differing key)."""
    t = {k: torch.from_numpy(np.array(int8_data[k], copy=True)) for k in ("docs", "rs", "qi", "qs", "qb", "qq")}
    qv = {"q": t["qi"], "qs": t["qs"], "qb": t["qb"], "qq": t["qq"]}
    got = int8_opt.agreement(t["docs"], t["rs"], qv, N_VALID)
    nk = 8 * C.H
    a = written(_p9_pallas(p9, int8_data, "v3", 128), nk).reshape(B, -1, C.OUT_LANES)[:, :, : nk + 1]
    bq = written(_p9_pallas(p9, int8_data, "v3dq", 128), nk).reshape(B, -1, C.OUT_LANES)[:, :, : nk + 1]
    ref = float(np.mean(a == bq))
    assert 0.99 <= got <= 1.0
    assert abs(got - ref) <= 8 / a.size


# --- P8: bf16 -------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_data():
    rng = np.random.default_rng(2108)
    out = {}
    for kind, make in (("lattice", lattice_rows), ("random", unit_rows)):
        docs = jnp.asarray(make(rng, N, D)).astype(jnp.bfloat16)
        q = jnp.asarray(make(rng, B, D)).astype(jnp.bfloat16)
        out[kind] = {
            "jax": (docs, q),
            "torch": (torch.from_numpy(np.asarray(docs, np.float32)).to(torch.bfloat16),
                      torch.from_numpy(np.asarray(q, np.float32)).to(torch.bfloat16)),
        }
    return out


def _p8_pallas(p8, docs, q, variant: str, chunk: int, block_n: int) -> np.ndarray:
    return np.asarray(
        pl.pallas_call(
            p8.make_kern(variant, block_n),
            grid=(N // block_n, D // chunk),
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.SMEM),
                pl.BlockSpec((B, chunk), lambda j, c: (0, c)),
                pl.BlockSpec((block_n, chunk), lambda j, c: (j, c)),
            ],
            out_specs=pl.BlockSpec((B, p8.OUT_LANES), lambda j, c: (0, j)),
            out_shape=jax.ShapeDtypeStruct((B, (N // block_n) * p8.OUT_LANES), jnp.float32),
            scratch_shapes=[pltpu.VMEM((B, block_n), jnp.float32)],
            interpret=True,
        )(jnp.asarray([N_VALID], jnp.int32), q, docs)
    )


@pytest.mark.parametrize("data", ["lattice", "random"])
@pytest.mark.parametrize("block_n", bf16_opt.BLOCKS)
@pytest.mark.parametrize("chunk", bf16_opt.CHUNKS)
@pytest.mark.parametrize("variant", ["mm", "v3"])
def test_p8_plain_matches_pallas(p8, bf16_data, variant, chunk, block_n, data):
    docs_j, q_j = bf16_data[data]["jax"]
    docs_t, q_t = bf16_data[data]["torch"]
    ref = _p8_pallas(p8, docs_j, q_j, variant, chunk, block_n)
    got = bf16_opt.extract(docs_t, q_t, N_VALID, variant, chunk, block_n).numpy()
    assert got.shape == ref.shape
    nk = (block_n // C.SUBTILE) * C.H
    if variant == "v3":
        ref = written(ref, nk)
    if data == "lattice":
        np.testing.assert_array_equal(bits(got), bits(ref))
    elif variant == "mm":
        np.testing.assert_allclose(got, ref, rtol=0, atol=C.SCORE_TOL)
    else:
        scores = C.chunked_scores(docs_t, q_t, chunk)
        C.check_keys_close("P8", torch.from_numpy(ref), torch.from_numpy(got), scores, block_n, clip=False)


# --- P7: same-step, deferred, the floors, the candidate path ---------------


@pytest.fixture(scope="module")
def p7_data():
    rng = np.random.default_rng(2107)
    out = {}
    for kind, make in (("lattice", lattice_rows), ("random", unit_rows)):
        docs = jnp.asarray(make(rng, N7, D7)).astype(jnp.bfloat16)
        q = jnp.asarray(make(rng, B, D7)).astype(jnp.bfloat16)
        out[kind] = {
            "jax": (docs, q),
            "torch": (torch.from_numpy(np.asarray(docs, np.float32)).to(torch.bfloat16),
                      torch.from_numpy(np.asarray(q, np.float32)).to(torch.bfloat16)),
        }
    return out


@pytest.mark.parametrize("data", ["lattice", "random"])
@pytest.mark.parametrize("deferred_emit", [False, True], ids=["same_step", "deferred"])
def test_p7_emit_matches_pallas(p7, p7_data, deferred_emit, data):
    """The port's same-step and deferred wrappers against the probe's
    ``extract4096`` (its deferred kernel when ``deferred_emit``): bit for
    bit on lattice data, one grid step at an edge on random rows; the
    port's two wrappers give one tile."""
    docs_j, q_j = p7_data[data]["jax"]
    docs_t, q_t = p7_data[data]["torch"]
    ref = np.asarray(p7.extract4096(docs_j, q_j, jnp.int32(N7_VALID), deferred_emit))
    got = select11.extract4096(docs_t, q_t, N7_VALID, deferred_emit)
    np.testing.assert_array_equal(bits(got.numpy()), bits(select11.extract4096(docs_t, q_t, N7_VALID, not deferred_emit).numpy()))
    if data == "lattice":
        np.testing.assert_array_equal(bits(got.numpy()), bits(ref))
    else:
        scores = C.chunked_scores(docs_t, q_t, select11.DIM_CHUNK)
        C.check_keys_close("P7", torch.from_numpy(ref), got, scores, select11.BLK, clip=True)


@pytest.mark.parametrize("data", ["lattice", "random"])
@pytest.mark.parametrize("block_n", [8192, 4096])
def test_p7_floor_matches_pallas(p7, p7_data, block_n, data):
    docs_j, q_j = p7_data[data]["jax"]
    docs_t, q_t = p7_data[data]["torch"]
    ref = np.asarray(p7.matmul_floor_blocked(docs_j, q_j, jnp.int32(N7_VALID), block_n))
    got = select11.floor(docs_t, q_t, block_n).numpy()
    assert got.shape == ref.shape
    if data == "lattice":
        np.testing.assert_array_equal(bits(got), bits(ref))
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=C.SCORE_TOL)


@pytest.mark.parametrize("deferred_emit", [False, True], ids=["same_step", "deferred"])
def test_p7_packed4096_decode_and_bound_match(p7, p7_data, deferred_emit):
    """``packed4096``'s merge, decode and bound on lattice data, where the
    tiles agree bit for bit: the same values, rows and bound."""
    docs_j, q_j = p7_data["lattice"]["jax"]
    docs_t, q_t = p7_data["lattice"]["torch"]
    c = 50
    ref = np.asarray(p7.packed4096(docs_j, q_j, jnp.int32(N7_VALID), c, deferred_emit))
    got = select11.packed4096(docs_t, q_t, N7_VALID, c, deferred_emit).numpy()
    np.testing.assert_array_equal(bits(got), bits(ref))


def test_p7_candidates_sound_against_the_scan(p7_data):
    """The probe's second check on the port: every query's candidates are
    distinct live rows, and each top row they miss scores at most the
    bound + 2e-3; and a starved pool (more candidates than live keys)
    bounds at +inf."""
    docs_t, q_t = p7_data["random"]["torch"]
    select11.check_sound(docs_t, q_t[:8], N7_VALID, 50)
    c = (N7 // select11.BLK) * select11.KEYS_PB
    vals = select11.packed4096(docs_t, q_t[:2], 3000, c, True)[:, 0, :]
    assert torch.isinf(vals[:, -1]).all()


# --- the shared pieces -------------------------------------------------------


def test_synth_rows_and_quantisation():
    """The sin-hash corpus made in torch: unit rows, the same rows from any
    starting row, and P9's quantisation of them as the script writes it in
    ``synth`` (absmax / 127, round half to even, clip).  (Its bits are not
    held against XLA's: the hash multiplies sin's last-ulp differences
    between libraries by 43758.)"""
    n, d = 96, 128
    rows = C.synth_rows(0, n, d, "cpu")
    np.testing.assert_allclose(torch.linalg.vector_norm(rows, dim=1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(C.synth_rows(32, 64, d, "cpu").numpy(), rows[32:64].numpy())
    docs, scales = C.synth_int8(n, d, "cpu")
    x = rows.numpy()
    ref_scales = (np.maximum(np.abs(x).max(axis=1), np.float32(1e-12)) / np.float32(127.0)).astype(np.float32)
    ref = np.clip(np.round(x / ref_scales[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(scales.numpy(), ref_scales)
    np.testing.assert_array_equal(docs.numpy(), ref)
    np.testing.assert_array_equal(
        C.synth_bf16(n, d, "cpu").to(torch.float32).numpy(),
        rows.to(torch.bfloat16).to(torch.float32).numpy(),
    )


@pytest.mark.parametrize("mod", [int8_opt, bf16_opt, select11], ids=lambda m: m.__name__.split(".")[-1])
def test_main_runs_the_plain_versions_on_the_cpu(mod, monkeypatch, capsys):
    """``--device cpu``: a probe's main runs its checks and prints every
    case of its script, on the host clock (at a small corpus, batch and
    width, one launch a case)."""
    monkeypatch.setattr(C, "B", 16)
    monkeypatch.setattr(C, "D", 256)
    timed = C.time_case
    monkeypatch.setattr(C, "time_case", lambda fn, windows=5, launches=20, host=False: timed(fn, 1, 1, host))
    assert mod.main(["--device", "cpu", "--docs", str(4 * 8192)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    labels = [c[0] for c in getattr(mod, "CASES", ())] or ["floor 8192", "deferred", "v3 (prod)"]
    for label in labels:
        assert f"{label}: host" in out or f"{label} " in out, label


def test_probe_library_units_and_hash():
    """The probes' build: every source of ``csrc/probes`` is one ``nvcc``
    unit but those of ``DEFINES``, one per ``-D`` set; the defines join the
    library's hash, and an empty mapping adds nothing to it."""
    from svs_tpu_torch.ops import kernels

    units = kernels._units(C.PROBE_CSRC, C.DEFINES)
    cu = sorted(p.name for p in C.PROBE_CSRC.glob("*.cu"))
    assert set(C.DEFINES) <= set(cu)
    for name in cu:
        got = [flags for src, flags, _ in units if src.name == name]
        assert got == list(C.DEFINES.get(name, ((),))), name
    assert len({stem for _, _, stem in units}) == len(units)  # one object each
    with_defines = kernels.library_path(C.PROBE_CSRC, (C.PROBE_CSRC.parent,), C.DEFINES)
    without = kernels.library_path(C.PROBE_CSRC, (C.PROBE_CSRC.parent,))
    assert with_defines != without
    assert kernels.library_path(C.PROBE_CSRC.parent, (), {}) == kernels.library_path()
