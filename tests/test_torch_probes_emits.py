"""The emit-shape probes of ``svs_tpu_torch.probes`` against the Pallas
probes of ``benchmarks/`` in interpret mode on the CPU, on the same seeded
inputs at small shapes: P6 (``tpu_select10.py``), P5 (``tpu_select9.py``)
and P4 (``tpu_select8.py``).  On the CPU each probe wrapper runs its
kernel's plain version, so these tests hold the plain versions; the smoke
holds the CUDA kernels to them on the card.

The scripts are loaded from their files, unchanged.  P5's and P4's ``run``
fixes the probe's full shape and has no interpret switch, so their own
kernel bodies (``KERNS``, ``make_kernel``) go through a ``pl.pallas_call``
here with ``run``'s block specs; P6 runs its own ``make_variant``'s
``extract`` and ``finish`` (the closure of the ``candidates`` it returns)
in interpret mode through its ``SVS_SELECT10_SMOKE`` switch.  Only the
lanes a probe writes are compared (P5's ``kern_v3`` leaves the lanes past
its guard unwritten; the port fills them with ``KEY_DEAD``).

Keys are bit-identical on lattice data, where every partial sum is exact,
and within one grid step at a grid edge on random unit rows; the floors'
sums within ``SCORE_TOL`` there.
"""

import importlib.util
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from svs_tpu_torch.probes import bf16_opt, select8, select9, select10
from svs_tpu_torch.probes import common as C
from torch_probe_helpers import ROOT, bits, lattice_rows, load_script, unit_rows, written

torch.set_num_threads(2)

N = 3 * 8192  # three 8,192-doc blocks
D = 256
B = 16
N_VALID = N - 100  # a partial last subtile
CHUNK = 128


@pytest.fixture(scope="module")
def p4():
    return load_script("tpu_select8")


@pytest.fixture(scope="module")
def p5():
    return load_script("tpu_select9")


@pytest.fixture(scope="module")
def p6():
    return load_script("tpu_select10", SVS_SELECT10_SMOKE="1")


@pytest.fixture(scope="module")
def p8():
    return load_script("tpu_bf16_opt")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2205)
    out = {}
    for kind, make in (("lattice", lattice_rows), ("random", unit_rows)):
        docs = jnp.asarray(make(rng, N, D)).astype(jnp.bfloat16)
        q = jnp.asarray(make(rng, B, D)).astype(jnp.bfloat16)
        dt = torch.from_numpy(np.asarray(docs, np.float32)).to(torch.bfloat16)
        qt = torch.from_numpy(np.asarray(q, np.float32)).to(torch.bfloat16)
        out[kind] = {"jax": (docs, q), "torch": (dt, qt), "scores": C.chunked_scores(dt, qt, CHUNK)}
    return out


def _pallas(kern, docs, q, out_block: int) -> np.ndarray:
    """A probe body through ``run``'s block specs at this test's shape, in
    interpret mode (grid: 8,192-doc blocks x contraction chunks of 128)."""
    return np.array(
        pl.pallas_call(
            kern,
            grid=(N // 8192, D // CHUNK),
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.SMEM),
                pl.BlockSpec((B, CHUNK), lambda j, c: (0, c)),
                pl.BlockSpec((8192, CHUNK), lambda j, c: (j, c)),
            ],
            out_specs=pl.BlockSpec((B, out_block), lambda j, c: (0, j)),
            out_shape=jax.ShapeDtypeStruct((B, (N // 8192) * out_block), jnp.float32),
            scratch_shapes=[pltpu.VMEM((B, 8192), jnp.float32)],
            interpret=True,
        )(jnp.asarray([N_VALID], jnp.int32), q, docs)
    )


def _cell(fn, name: str):
    """What ``name`` is bound to in ``fn``'s closure (``make_variant``'s
    ``extract`` and ``finish`` behind its ``candidates``)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


# --- P5: tpu_select9.py -------------------------------------------------------


@pytest.mark.parametrize("kind", ["lattice", "random"])
@pytest.mark.parametrize("variant", ["v3", "v2", "mm"])
def test_p5_plain_matches_pallas(p5, data, variant, kind):
    """``kern_v3`` / ``kern_v2`` / ``kern_mm`` against the port's
    ``select9.extract``: bit for bit on lattice rows; on random rows keys
    within one grid step at an edge (v3: 2^12 x 1024, v2: 2^13 x 512), the
    floor's sums within ``SCORE_TOL``."""
    docs_j, q_j = data[kind]["jax"]
    docs_t, q_t = data[kind]["torch"]
    ref = _pallas(p5.KERNS[variant], docs_j, q_j, p5.OUT_LANES)
    got = select9.extract(docs_t, q_t, N_VALID, variant).numpy()
    assert got.shape == ref.shape == (B, (N // 8192) * 128)
    if variant == "v3":
        ref = written(ref, p5.NSUB3 * p5.H3)
    if kind == "lattice":
        np.testing.assert_array_equal(bits(got), bits(ref))
    elif variant == "mm":
        np.testing.assert_allclose(got, ref, rtol=0, atol=C.SCORE_TOL)
    elif variant == "v3":
        C.check_keys_close("P5 v3", torch.from_numpy(ref), torch.from_numpy(got),
                           data[kind]["scores"], 8192, clip=False)
    else:
        select9.V2.check_close("P5 v2", torch.from_numpy(ref), torch.from_numpy(got), data[kind]["scores"])


def test_p5_v3_and_mm_are_p8s(p5, p8, data):
    """``kern_v3`` and ``kern_mm`` compute P8's ``v3`` and ``mm128`` (chunk
    128, block 8192): the two scripts' Pallas bodies agree bit for bit on
    the lanes both write, and the port's P5 wrappers give P8's tiles."""
    docs_j, q_j = data["random"]["jax"]
    docs_t, q_t = data["random"]["torch"]
    for v5, v8 in (("v3", "v3"), ("mm", "mm")):
        a = _pallas(p5.KERNS[v5], docs_j, q_j, 128)
        b8 = _pallas(p8.make_kern(v8, 8192), docs_j, q_j, 128)
        if v5 == "v3":
            a, b8 = written(a, 32), written(b8, 32)
        np.testing.assert_array_equal(bits(a), bits(b8))
        np.testing.assert_array_equal(
            bits(select9.extract(docs_t, q_t, N_VALID, v5).numpy()),
            bits(bf16_opt.extract(docs_t, q_t, N_VALID, v8, 128, 8192).numpy()),
        )


def test_p5_merge_v3_matches(p5, data, monkeypatch):
    """The port's ``merge_v3`` against the script's on the same tiles (the
    script's module shape set to this test's): values, rows and bound bit
    for bit."""
    monkeypatch.setattr(p5, "N", N)
    monkeypatch.setattr(p5, "B", B)
    docs_t, q_t = data["lattice"]["torch"]
    tiles = select9.extract(docs_t, q_t, N_VALID, "v3")
    k = 50
    ref = p5.merge_v3(jnp.asarray(tiles.numpy()), k)
    got = select9.merge_v3(tiles, k)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r, np.float64), g.numpy().astype(np.float64))


# --- P4: tpu_select8.py -------------------------------------------------------


def _p4_out_block(p4, emit: str) -> int:
    _, sub_lanes, _ = p4.EMIT_META[emit]
    return 128 if emit == "h8g1024" else sub_lanes * (p4.FUSED_BLOCK_N // p4.FUSED_SUBTILE)


@pytest.fixture(scope="module")
def p4_ref(p4, data):
    """Every emit's Pallas tiles on both data sets."""
    return {
        (emit, kind): _pallas(p4.make_kernel(emit), *data[kind]["jax"], _p4_out_block(p4, emit))
        for emit in p4.EMIT_META
        for kind in ("lattice", "random")
    }


@pytest.mark.parametrize("kind", ["lattice", "random"])
@pytest.mark.parametrize("emit", ["matmul", "current", "hier", "h6g128", "h8g256", "h8g1024"])
def test_p4_plain_matches_pallas(p4, p4_ref, data, emit, kind):
    """Each emit of ``make_kernel`` against the port's ``select8.extract``
    (every lane is written by both): bit for bit on lattice rows; on random
    rows keys within one grid step at an edge of the emit's own grid and
    field, the floor's sums within ``SCORE_TOL``."""
    docs_t, q_t = data[kind]["torch"]
    ref = p4_ref[emit, kind]
    got = select8.extract(docs_t, q_t, N_VALID, emit).numpy()
    assert got.shape == ref.shape == (B, (N // 8192) * select8.out_lanes(emit))
    if kind == "lattice":
        np.testing.assert_array_equal(bits(got), bits(ref))
    elif emit == "matmul":
        np.testing.assert_allclose(got, ref, rtol=0, atol=C.SCORE_TOL)
    else:
        select8.EMITS[emit].check_close(f"P4 {emit}", torch.from_numpy(ref), torch.from_numpy(got),
                                        data[kind]["scores"])


@pytest.mark.parametrize("kind", ["lattice", "random"])
def test_p4_hier_equals_current(p4_ref, data, kind):
    """``hier`` gives ``current``'s keys bit for bit: in the script and in
    the port (whose plain ``hier`` folds the quarters, ``fold_keys``)."""
    docs_t, q_t = data[kind]["torch"]
    np.testing.assert_array_equal(bits(p4_ref["hier", kind]), bits(p4_ref["current", kind]))
    np.testing.assert_array_equal(
        bits(select8.extract(docs_t, q_t, N_VALID, "hier").numpy()),
        bits(select8.extract(docs_t, q_t, N_VALID, "current").numpy()),
    )


def test_p4_h8g1024_padding_is_dead(p4_ref, data):
    """``h8g1024``: 8 keys then 8 ``KEY_DEAD`` lanes per 1024-doc group, in
    the script and in the port; the keys live but past n_valid."""
    docs_t, q_t = data["random"]["torch"]
    for tiles in (p4_ref["h8g1024", "random"], select8.extract(docs_t, q_t, N_VALID, "h8g1024").numpy()):
        g = tiles.reshape(B, -1, 16)
        assert (g[:, :, 8:] == C.KEY_DEAD).all()
        assert (g[:, :-1, :8] > C.KEY_DEAD).all()


def test_fold_keys_is_extract_keys():
    """The plain fold (a max over each position's four 128-lane quarters,
    the max of those, a clear over all 512) keeps the same distinct top-H
    keys as the plain max-and-clear rounds, ties and dead lanes included."""
    from svs_tpu_torch.ops.pallas_extract import _extract_keys

    rng = np.random.default_rng(2204)
    keys = torch.from_numpy(rng.integers(-40, 40, (6, 5, 512)).astype(np.float32))
    keys[0, 1] = C.KEY_DEAD
    keys[1, 2, 300:] = C.KEY_DEAD
    for h in (1, 3, 8):
        np.testing.assert_array_equal(C.fold_keys(keys, h).numpy(), _extract_keys(keys, h).numpy())


# --- P6: tpu_select10.py ------------------------------------------------------


@pytest.fixture(scope="module")
def p6_variants(p6):
    return {h: p6.make_variant(512, h, float(1 << 13)) for h in (2, 3)}


@pytest.mark.parametrize("kind", ["lattice", "random"])
@pytest.mark.parametrize("h", [2, 3])
def test_p6_tiles_match_pallas(p6_variants, data, h, kind):
    """``make_variant(512, h, 2^13)``'s own ``extract`` (interpret mode)
    against the port's ``select10.extract``: every lane (keys, guard at lane
    16 h, ``KEY_DEAD`` after) bit for bit on lattice rows; on random rows
    keys within one grid step at an edge, the guard the max of the tails."""
    docs_j, q_j = data[kind]["jax"]
    docs_t, q_t = data[kind]["torch"]
    cand, _, key_eps = p6_variants[h]
    assert key_eps == select10.KEY_EPS
    ref = np.array(_cell(cand, "extract")(docs_j, q_j, jnp.int32(N_VALID)))
    got = select10.extract(docs_t, q_t, N_VALID, h).numpy()
    assert got.shape == ref.shape == (B, (N // 8192) * 128)
    if kind == "lattice":
        np.testing.assert_array_equal(bits(got), bits(ref))
    else:
        select10.EMITS[h].check_close(f"P6 512/{h}", torch.from_numpy(ref), torch.from_numpy(got),
                                      data[kind]["scores"])


@pytest.mark.parametrize("h", [2, 3])
def test_p6_candidates_match_pallas(p6_variants, data, h):
    """``candidates`` on lattice data at a batch that pads (12 -> 16 rows):
    the script's and the port's values, rows and bounds bit for bit."""
    docs_j, q_j = data["lattice"]["jax"]
    docs_t, q_t = data["lattice"]["torch"]
    cand = p6_variants[h][0]
    c = 60
    ref = cand(docs_j, q_j[:12].astype(jnp.float32), jnp.int32(N_VALID), c)
    got = select10.candidates(docs_t, q_t[:12].to(torch.float32), N_VALID, c, h)
    for r, g in zip(ref, got):
        assert g.shape[0] == 12
        np.testing.assert_array_equal(np.asarray(r, np.float64), g.numpy().astype(np.float64))


@pytest.mark.parametrize("h", [2, 3])
def test_p6_finish_matches_script(p6_variants, data, h):
    """The port's ``finish`` against the script's on the same tiles: as the
    kernel gives them, with one row's top key at the saturation key (bound
    +inf) and with rows whose keys run dead before the c-th (bound +inf)."""
    docs_t, q_t = data["random"]["torch"]
    fin = _cell(p6_variants[h][0], "finish")
    tiles = select10.extract(docs_t, q_t, N_VALID, h)
    keys_pb = 16 * h
    sat = tiles.clone()
    sat[3, 5] = select10.SAT_KEY + 7.0
    dead = tiles.clone().view(B, -1, 128)
    dead[[1, 6], :, 4:keys_pb] = C.KEY_DEAD
    c = 40
    for t in (tiles, sat, dead.view(B, -1)):
        ref = fin(jnp.asarray(t.numpy()), c)
        got = select10.finish(t, c, h)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r, np.float64), g.numpy().astype(np.float64))
    assert torch.isinf(select10.finish(sat, c, h)[2][3])
    assert torch.isinf(select10.finish(dead.view(B, -1), c, h)[2][[1, 6]]).all()


def test_p6_candidates_sound_on_random_and_hot_corpus():
    """The script's soundness on the port: a random unit corpus and the
    same corpus with 100 jittered copies of one row planted in a 512-doc
    span (in place, restored after): every query's candidates distinct live
    rows, every scan row they miss at most the bound + ``KEY_EPS`` + 1e-6;
    the hot span pushes rows out of the candidates and leaves the bound
    tight."""
    n = 4 * 8192
    docs = C.synth_bf16(n, D, "cpu")
    before = docs.clone()
    qf, rng = select10.queries(B, D, "cpu")
    res = select10.check_soundness(docs, qf, rng, n - 100, 50)
    assert torch.equal(docs, before)
    assert set(res) == {"rand 512/H=2", "rand 512/H=3", "hot  512/H=2", "hot  512/H=3"}
    for label, r in res.items():
        assert r["of"] == 8 * 50 and r["worst_excess"] <= select10.KEY_EPS + 1e-6, label
    assert res["hot  512/H=2"]["missing"] > res["rand 512/H=2"]["missing"]
    assert res["rand 512/H=3"]["missing"] <= res["rand 512/H=2"]["missing"]


def test_p6_hot_span_is_planted_in_place():
    """``planted_hot`` writes 100 jittered unit copies of row N / 3 at block
    ``hot_block``, offset 1024, and restores the rows on exit."""
    n = 4 * 8192
    docs = C.synth_bf16(n, D, "cpu")
    before = docs.clone()
    rng = np.random.default_rng(0)
    with select10.planted_hot(docs, rng, 2) as q_hot:
        lo = 2 * 8192 + 1024
        hot = q_hot[0]
        cos = docs[lo : lo + 100].to(torch.float32) @ hot
        assert q_hot.shape == (8, D) and (cos > 0.99).all()
        assert torch.equal(docs[: lo], before[: lo]) and torch.equal(docs[lo + 100 :], before[lo + 100 :])
    assert torch.equal(docs, before)


# --- the mains --------------------------------------------------------------


@pytest.mark.parametrize("mod", [select10, select9, select8], ids=lambda m: m.__name__.split(".")[-1])
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
    if mod is select10:
        labels = ["rand 512/H=2", "hot  512/H=3", "bf16 b=16 floor", "bf16 b=16 v3 1024/4",
                  "bf16 b=16    512/3", "bf16 b=128 512/2", "us/query"]
    else:
        labels = [c[0] for c in mod.CASES]
    for label in labels:
        assert f"{label} " in out or f"{label}:" in out, label
    if mod is select8:
        assert "hier == current (bitwise) OK" in out


# --- the emits' same-window comparison (tools/emit_ab.py) -------------------


@pytest.fixture(scope="module")
def emit_ab():
    spec = importlib.util.spec_from_file_location("emit_ab", ROOT / "tools" / "emit_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_emit_ab_turns_alternate(emit_ab):
    """Every case once a turn, in order, then reversed."""
    calls = []

    def timer(fn, launches):
        calls.append(fn())
        return float(len(calls))

    fns = {name: (lambda name=name: name) for name in "abc"}
    times = emit_ab.turns_of(fns, 3, 20, timer)
    assert calls == list("abccbaabc")
    assert times == {"a": [1.0, 6.0, 7.0], "b": [2.0, 5.0, 8.0], "c": [3.0, 4.0, 9.0]}


def test_emit_ab_spread_is_the_largest_copy_gap(emit_ab):
    times = {"x": [1.0, 2.0], "x copy": [1.01, 1.9], "y": [4.0, 4.0], "y copy": [4.0, 4.08]}
    assert emit_ab.spread(times, {"x copy": "x", "y copy": "y"}) == pytest.approx(0.05)


@pytest.mark.parametrize(
    "b, resolved",
    [
        ([1.05, 2.10, 3.12], True),  # +4-5% every turn, past a 1% spread
        ([0.95, 1.90, 2.85], True),  # -5% every turn
        ([1.05, 1.98, 3.15], False),  # one turn the other way
        ([1.005, 2.01, 3.015], False),  # +0.5% every turn: inside the spread
    ],
)
def test_emit_ab_verdict(emit_ab, b, resolved):
    """A pair is resolved only when every turn's difference has one sign
    and is past the same-instance spread."""
    v = emit_ab.verdict([1.0, 2.0, 3.0], b, 0.01)
    assert v["resolved"] is resolved
    assert v["diff_lo_ms"] <= v["diff_ms"] <= v["diff_hi_ms"]
    assert v["rel_lo"] <= v["rel"] <= v["rel_hi"]


def test_emit_ab_needs_a_card(emit_ab, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["emit_ab.py"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert emit_ab.main() == 2


def test_keyed_emits_fix_block_and_chunk():
    """Every keyed emit runs at the one block and chunk the kernel is built
    for: its lanes and its plain version take them from the module."""
    assert not {"block_n", "chunk"} & set(C.Keyed.__dataclass_fields__)
    assert (select9.BLOCK_N, select9.DIM_CHUNK, select10.BLOCK_N) == (C.KEYED_BLOCK_N, C.KEYED_CHUNK, C.KEYED_BLOCK_N)
    assert select8.EMITS["h6g128"].lanes == C.tile_lanes(C.KEYED_BLOCK_N, 128, 6, False) == 384
