"""What the probes share: the constants of the Pallas probes (copied here:
the package imports nothing of ``benchmarks/`` or ``svs_tpu``), their
sin-hash corpus and query quantisation, the keyed tile layout (v3's by
default; any subtile width, list length, key grid, padding and guard) with
its plain emit, key decode and merge, the probes' kernel library, a device
timer and the checks of a kernel against its plain version."""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.pallas_extract import _extract_keys, _live_lanes

#: Bias making cosine scores positive before the key grid (``KEY_BIAS``).
KEY_BIAS = 1.0625
#: Dead-lane marker, below every live key (``KEY_DEAD``).
KEY_DEAD = -float(1 << 24)
#: v3: 1024-doc subtiles, 4 keys each, a 2^12 score grid (the defaults of
#: the keyed helpers below).
SUBTILE = 1024
H = 4
QS3 = float(1 << 12)
#: v2's (and the other probes'): a 2^13 score grid.
QS2 = float(1 << 13)
#: Lanes of a v3 output tile: the keys, the guard lane, then dead padding
#: (a keyed tile is its keys and guard rounded up to a multiple of this).
OUT_LANES = 128
#: The output block and contraction chunk of every keyed emit of
#: ``svs_probe_keyed`` (the ``KeyedVariant`` instances of
#: ``csrc/probes/select8.cu``, ``select9.cu``, ``select10.cu``).
KEYED_BLOCK_N = 8192
KEYED_CHUNK = 128
#: The probes' corpus and batch (``N, D, B`` of the three scripts).
N, D, B = 1_015_808, 1536, 256
#: A float kernel's keys may sit one grid step from the plain version's
#: where the score is this close to a grid edge (chip_smoke's SCORE_TOL).
SCORE_TOL = 2e-6

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: The probes' CUDA sources: a library of their own, never linked into the
#: production one (``ops/kernels.py`` builds the top level of ``csrc`` only).
PROBE_CSRC = _CSRC / "probes"
#: The probe sources compiled once per instance (``csrc/probes/probes.cuh``):
#: P9 per contraction chunk's wgmma group, P8 per output block.
DEFINES = {
    "int8_opt.cu": (("-DPROBE_GROUP=1",), ("-DPROBE_GROUP=2",)),
    "bf16_opt.cu": (("-DPROBE_BLOCK_N=8192",), ("-DPROBE_BLOCK_N=4096",)),
}
_vp, _i = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "svs_probe_int8": ([_i, _i, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp, _vp], _i),
    "svs_probe_bf16": ([_i, _i, _i, _vp, _vp, _i, _i, _i, _i, _vp, _vp], _i),
    "svs_probe_select11": ([_i, _i, _vp, _vp, _i, _i, _i, _i, _vp, _vp], _i),
    "svs_probe_keyed": ([_i, _vp, _vp, _i, _i, _i, _i, _vp, _vp], _i),
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build_library() -> Path:
    """Build the probes' library if it is not built (``csrc/probes`` with
    the headers of ``csrc``: one ``nvcc`` per unit of :data:`DEFINES`'
    sources and per other source, all at once)."""
    return kernels.build(PROBE_CSRC, include=(_CSRC,), defines=DEFINES)


def library() -> ctypes.CDLL:
    """The probes' kernel library, built at first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = kernels.load(
                    PROBE_CSRC, include=(_CSRC,), signatures=SIGNATURES, defines=DEFINES
                )
    return _lib


def launch(name: str, what: str, device: torch.device, *args) -> None:
    """Call launcher ``name`` of the probes' library on ``device``'s current
    stream (the stream is the last argument); raise on a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    kernels.check(rc, what)


def resolve_device(device=None) -> torch.device:
    """``device`` (default: the card).  Without a card only ``"cpu"``,
    named, runs: the probes never fall back to the CPU by themselves."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the probes run on a CUDA device and none is available; pass "
            "device='cpu' to run their plain versions on the CPU"
        )
    return dev


def check_operand(x: torch.Tensor, dtype, shape: tuple, name: str) -> None:
    """A kernel trusts its operands: the dtype, the shape, contiguous and
    16-byte aligned (the tensor maps' and the bulk copies' rule)."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


# --- data ---------------------------------------------------------------


def synth_rows(lo: int, hi: int, d: int, device) -> torch.Tensor:
    """Rows ``lo:hi`` of the probes' sin-hash corpus, f32 unit rows
    (``tpu_int8_opt.py:151-157``, ``tpu_select11.py:304-310``)."""
    r = torch.arange(lo, hi, device=device, dtype=torch.float32)[:, None]
    c = torch.arange(d, device=device, dtype=torch.float32)[None, :]
    x = torch.sin(r * 12.9898 + c * 78.233) * 43758.5453
    x = x - torch.floor(x) - 0.5
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


def quantize_docs(x: torch.Tensor) -> tuple:
    """``(int8 rows, f32 scales)`` of f32 rows as P9's ``synth`` quantises
    them (``tpu_int8_opt.py:158-163``): absmax / 127, round half to even,
    clip to +-127."""
    scales = torch.clamp_min(x.abs().amax(dim=1), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    return q, scales


_SYNTH_ROWS = 1 << 16


def synth_int8(n: int = N, d: int = D, device=None) -> tuple:
    """P9's corpus: ``(int8 docs [n, d], f32 row scales [n])``, made on
    ``device`` (default the card) in row blocks."""
    dev = resolve_device(device)
    docs = torch.empty((n, d), dtype=torch.int8, device=dev)
    scales = torch.empty((n,), dtype=torch.float32, device=dev)
    for lo in range(0, n, _SYNTH_ROWS):
        hi = min(n, lo + _SYNTH_ROWS)
        docs[lo:hi], scales[lo:hi] = quantize_docs(synth_rows(lo, hi, d, dev))
    return docs, scales


def synth_bf16(n: int = N, d: int = D, device=None) -> torch.Tensor:
    """P8's and P7's corpus: bf16 docs [n, d] on ``device``."""
    dev = resolve_device(device)
    docs = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for lo in range(0, n, _SYNTH_ROWS):
        hi = min(n, lo + _SYNTH_ROWS)
        docs[lo:hi] = synth_rows(lo, hi, d, dev).to(torch.bfloat16)
    return docs


def unit_queries(b: int = B, d: int = D, seed: int = 0) -> np.ndarray:
    """The scripts' queries: f32 unit rows from ``default_rng(seed)``."""
    q = np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def quantize_queries(qf: np.ndarray) -> dict:
    """P9's query quantisation (``tpu_int8_opt.py:167-177``): int8 rows
    ``qi``, their scales ``qs`` and the v3dq grid constants ``qb = KEY_BIAS
    / qs`` and ``qq = QS3 * qs``, each f32 [b], as NumPy arrays."""
    sq = (np.maximum(np.abs(qf).max(axis=1), 1e-30) / 127.0).astype(np.float32)
    qi = np.clip(np.rint(qf / sq[:, None]), -127, 127).astype(np.int8)
    return {
        "qi": qi,
        "qs": sq,
        "qb": (KEY_BIAS / sq).astype(np.float32),
        "qq": (QS3 * sq).astype(np.float32),
    }


# --- the keyed tile layout and its plain emit ------------------------------


def tile_lanes(block_n: int = 8192, sub: int = SUBTILE, h: int = H, guard: bool = True,
               pad: int = 0) -> int:
    """Lanes of one ``block_n``-doc output tile of a keyed emit: ``h`` keys
    and ``pad`` dead lanes per ``sub``-doc subtile, then the guard lane,
    rounded up to a multiple of 128 (v3: 128)."""
    keyed = (block_n // sub) * (h + pad) + int(guard)
    return -(-keyed // OUT_LANES) * OUT_LANES


def tile_cols(n: int, block_n: int, lanes: int = OUT_LANES) -> int:
    return (n // block_n) * lanes


def fold_keys(keys: torch.Tensor, h: int, dead: float = KEY_DEAD) -> torch.Tensor:
    """``tpu_select8.py``'s "hier" over the last axis (512 keys): ``h``
    passes of a fold of the 128-lane quarters by elementwise max, a max
    over the 128 folded lanes and a clear of every key equal to it (the
    keys of :func:`_extract_keys`, by another road)."""
    out = []
    for _ in range(h):
        folded = keys.unflatten(-1, (-1, OUT_LANES)).amax(dim=-2)
        mkey = folded.amax(dim=-1, keepdim=True)
        out.append(mkey)
        keys = torch.where(keys == mkey, dead, keys)
    return torch.cat(out, dim=-1)


def v3_tiles(keys: torch.Tensor, n_valid: int, block_n: int, sub: int = SUBTILE,
             h: int = H, guard: bool = True, pad: int = 0, fold: bool = False) -> torch.Tensor:
    """The keyed emit of a probe on keys ``[B, N]`` (``floor(...) * sub +
    lane``, computed as the probe computes them): lanes at or past
    ``n_valid`` dead, then per ``sub``-doc subtile ``h`` rounds of max and
    clear every equal key (``fold``: :func:`fold_keys`), at lanes ``s *
    (h + pad) + i`` of the subtile's ``block_n``-doc tile; with ``guard``
    the lane after the keys the max of the subtiles' ``h``-th keys; the
    other lanes ``KEY_DEAD`` (the Pallas probes leave some unwritten).  The
    defaults: v3's (1024-doc subtiles, 4 keys, a guard)."""
    b, n = keys.shape
    nb, nsub = n // block_n, block_n // sub
    stride = h + pad
    live = _live_lanes(n, sub, n_valid, keys.device)
    lane = torch.arange(sub, device=keys.device).to(torch.float32)
    k = torch.where(lane < live[:, None], keys.view(b, n // sub, sub), KEY_DEAD)
    ext = (fold_keys if fold else _extract_keys)(k, h).view(b, nb, nsub, h)
    keyed = torch.full((b, nb, nsub, stride), KEY_DEAD, dtype=torch.float32, device=keys.device)
    keyed[..., :h] = ext
    out = torch.full((b, nb, tile_lanes(block_n, sub, h, guard, pad)), KEY_DEAD,
                     dtype=torch.float32, device=keys.device)
    out[:, :, : nsub * stride] = keyed.view(b, nb, nsub * stride)
    if guard:
        out[:, :, nsub * stride] = ext[..., h - 1].amax(dim=2)
    return out.view(b, -1)


def grid_keys(x: torch.Tensor, sub: int = SUBTILE) -> torch.Tensor:
    """``floor(x) * sub + lane`` over the ``sub``-doc subtiles of ``x`` ``[B,
    N]`` (``x`` already on the grid's scale)."""
    b, n = x.shape
    lane = torch.arange(sub, device=x.device).to(torch.float32)
    return (torch.floor(x).view(b, n // sub, sub) * float(sub) + lane).view(b, n)


def v3_keys(scores: torch.Tensor, clip: bool, qs: float = QS3, sub: int = SUBTILE) -> torch.Tensor:
    """``floor((s + KEY_BIAS) * qs) * sub + lane``, the score clipped to
    [-3, 3] first when ``clip`` (``tpu_select11.py:81-85``,
    ``tpu_select10.py:92-96``) and not otherwise (``tpu_int8_opt.py:85-88``,
    ``tpu_bf16_opt.py:70-74``, ``tpu_select9.py``, ``tpu_select8.py``)."""
    s = torch.clamp(scores, -3.0, 3.0) if clip else scores
    return grid_keys((s + KEY_BIAS) * qs, sub)


def key_vals(keys: torch.Tensor, sub: int = SUBTILE, qs: float = QS3) -> torch.Tensor:
    """The score level of packed keys: ``(key // sub) / qs - KEY_BIAS``
    (``tpu_select10.py:171``, ``tpu_select9.py:183``)."""
    vq = torch.div(keys.to(torch.int32), sub, rounding_mode="floor")
    return vq.to(torch.float32) / qs - KEY_BIAS


def top_keys(out: torch.Tensor, c: int, block_n: int, sub: int = SUBTILE, h: int = H,
             qs: float = QS3) -> tuple:
    """The probes' merge of guarded tiles (``out`` ``[B, nb * lanes]``):
    the top ``c`` keys of the key lanes in ``lax.top_k``'s order, their
    levels, their rows (block, subtile, lane), and the level of the
    tiles' largest guard.  Returns ``(keys, vals, rows, guard)``."""
    from ..ops.topk import top_k

    b = out.shape[0]
    keys_pb = (block_n // sub) * h
    o3 = out.view(b, -1, tile_lanes(block_n, sub, h))
    sel, cols = top_k(o3[:, :, :keys_pb].reshape(b, -1), c)
    ki = sel.to(torch.int32)
    lane = ki - torch.div(ki, sub, rounding_mode="floor") * sub
    jb = torch.div(cols, keys_pb, rounding_mode="floor")
    s = torch.div(cols - jb * keys_pb, h, rounding_mode="floor")
    rows = jb * block_n + s * sub + lane
    guard = key_vals(o3[:, :, keys_pb].amax(dim=1), sub, qs)
    return sel, key_vals(sel, sub, qs), rows, guard


@dataclass(frozen=True)
class Keyed:
    """One keyed emit of ``svs_probe_keyed`` (``csrc/probes/probes.cu``:
    ``fused3::KeyedVariant``, bf16 at ``KEYED_CHUNK`` and ``KEYED_BLOCK_N``,
    which the kernel fixes): the launcher's ``variant`` and the tile layout
    its plain version writes (``v3_tiles``' arguments)."""

    variant: int
    sub: int
    h: int
    qs: float = QS2
    clip: bool = False
    guard: bool = False
    pad: int = 0
    fold: bool = False

    @property
    def lanes(self) -> int:
        return tile_lanes(KEYED_BLOCK_N, self.sub, self.h, self.guard, self.pad)

    def plain(self, docs, q, n_valid: int) -> torch.Tensor:
        """The plain version: the chunked f32 sum, the keys, the tiles."""
        acc = chunked_scores(docs, q, KEYED_CHUNK)
        return v3_tiles(v3_keys(acc, self.clip, self.qs, self.sub), n_valid, KEYED_BLOCK_N,
                        self.sub, self.h, self.guard, self.pad, self.fold)

    def launch(self, docs, q, n_valid: int, what: str) -> torch.Tensor:
        """One launch of the kernel on CUDA tensors (the wrapper counts it):
        tiles ``[B, (N / 8192) * lanes]``, pre-filled with ``KEY_DEAD``
        where the kernel leaves lanes (guard, padding)."""
        n, d = docs.shape
        b = q.shape[0]
        check_operand(docs, torch.bfloat16, (n, d), "docs")
        check_operand(q, torch.bfloat16, (b, d), "queries")
        if not (0 < b <= 256 and n % KEYED_BLOCK_N == 0 and d % KEYED_CHUNK == 0
                and 0 <= n_valid <= n):
            raise ValueError(f"{what} needs 0 < b <= 256, n % {KEYED_BLOCK_N} == 0, "
                             f"d % {KEYED_CHUNK} == 0; got {b}, {n}, {d}")
        shape = (b, tile_cols(n, KEYED_BLOCK_N, self.lanes))
        if self.lanes > (KEYED_BLOCK_N // self.sub) * self.h:  # a guard, padding
            out = torch.full(shape, KEY_DEAD, dtype=torch.float32, device=docs.device)
        else:  # every lane written
            out = torch.empty(shape, dtype=torch.float32, device=docs.device)
        launch("svs_probe_keyed", what, docs.device, self.variant, q.data_ptr(), docs.data_ptr(),
               b, n, d, int(n_valid), out.data_ptr())
        return out

    def check_close(self, name: str, got, ref, scores) -> float:
        """:func:`check_keys_close` at this emit's grid and layout."""
        return check_keys_close(name, got, ref, scores, KEYED_BLOCK_N, self.clip, sub=self.sub,
                                h=self.h, qs=self.qs, guard=self.guard, pad=self.pad)


def first_sums(acc: torch.Tensor, block_n: int) -> torch.Tensor:
    """The floor "mm": the first 128 sums of every ``block_n``-doc block,
    as f32 (``acc_ref[:, :OUT_LANES]`` of each block)."""
    b, n = acc.shape
    nb = n // block_n
    return acc.to(torch.float32).view(b, nb, block_n)[:, :, :OUT_LANES].reshape(b, nb * OUT_LANES)


def chunked_scores(docs: torch.Tensor, q: torch.Tensor, chunk: int) -> torch.Tensor:
    """The f32 scores of bf16 (or f32) ``q`` against ``docs`` as the Pallas
    probes sum them: per contraction chunk of ``chunk`` columns one f32
    product, added to the accumulator in column order (``acc_ref[:] +=
    dot(...)``), true f32 (TF32 off)."""
    from ..ops.topk import exact_f32

    qf = q.to(torch.float32)
    acc = torch.zeros((q.shape[0], docs.shape[0]), dtype=torch.float32, device=docs.device)
    with exact_f32():
        for c0 in range(0, docs.shape[1], chunk):
            acc = acc + qf[:, c0 : c0 + chunk] @ docs[:, c0 : c0 + chunk].to(torch.float32).t()
    return acc


# --- timing -------------------------------------------------------------

#: Cycles per second that ``torch.cuda._sleep`` spins at, rounded up from
#: an H100's top SM clock (1.98 GHz), so a hold is never shorter than asked.
SPIN_HZ = 2.0e9


def time_ms(fn: Callable[[], object], launches: int) -> float:
    """Device time per call of ``fn``: one CUDA event pair around
    ``launches`` calls, after a warm-up call, divided by the count.  A spin
    kernel queued first (``torch.cuda._sleep``) holds the device while the
    host enqueues the calls, so the window holds them back to back on the
    device and not the host's launch gaps (a note on stderr says when the
    host took longer than the hold).  ``fn`` must not synchronise.  The
    port's other measuring scripts (``chip_smoke.py``, ``kernel_ab.py``)
    time with this too."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t  # enqueue time of one call
    torch.cuda.synchronize()
    hold_s = min(1.0, 3.0 * launches * host_s + 1e-3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SPIN_HZ))
    t = time.perf_counter()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    enqueue_s = time.perf_counter() - t
    end.synchronize()
    if enqueue_s > hold_s:
        print(f"  time_ms: the host took {enqueue_s * 1e3:.2f} ms to enqueue "
              f"{launches} calls, past the {hold_s * 1e3:.2f} ms hold: the "
              f"window may hold launch gaps", file=sys.stderr, flush=True)
    return start.elapsed_time(end) / launches


def host_ms(fn: Callable[[], object], launches: int) -> float:
    """Host-clock time per call of ``fn`` over ``launches`` calls (the CPU
    runs of the plain versions)."""
    fn()
    t = time.perf_counter()
    for _ in range(launches):
        fn()
    return (time.perf_counter() - t) * 1e3 / launches


def time_case(
    fn: Callable[[], object], windows: int = 5, launches: int = 20, host: bool = False
) -> dict:
    """The scripts' report of a case: the median and the spread of
    ``windows`` device-time windows of ``launches`` calls each (the Pallas
    scripts take 5 host-clock differences of chained runs); ``host``: the
    host clock (a CPU run)."""
    timer = host_ms if host else time_ms
    runs = sorted(timer(fn, launches) for _ in range(windows))
    return {"ms": statistics.median(runs), "lo": runs[0], "hi": runs[-1],
            "clock": "host" if host else "device"}


def case_line(label: str, t: dict) -> str:
    return f"{label}: {t['clock']} {t['ms']:.4f} ms (spread {t['lo']:.4f}-{t['hi']:.4f})"


def device_line(dev: torch.device) -> str:
    """What the cases ran on: the card's name and power limit, or the CPU."""
    if dev.type == "cuda":
        return card_line()
    return "cpu (the plain versions; host clock)"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --- checks of a kernel against its plain version -------------------------


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_same_bits(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    if not same_bits(got, ref):
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum()) if got.shape == ref.shape else -1
        raise AssertionError(f"{name}: {bad} of {ref.numel()} outputs differ from the plain version")


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, tol: float = SCORE_TOL) -> float:
    """Raw f32 sums (the floors) within ``tol``; returns the max |err|."""
    err = float((got.double() - ref.double()).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: off the plain version by {err} > {tol}")
    return err


def check_keys_close(
    name: str,
    got: torch.Tensor,
    ref: torch.Tensor,
    scores: torch.Tensor,
    block_n: int,
    clip: bool,
    tol: float = SCORE_TOL,
    sub: int = SUBTILE,
    h: int = H,
    qs: float = QS3,
    guard: bool = True,
    pad: int = 0,
) -> float:
    """Keyed tiles of a float kernel on random data against the plain
    version's (v3's by default): the dead and padding lanes equal, the
    guard lane the max of the kernel's own subtile tails, and every key
    within one grid step of the plain key, its level within ``tol`` of the
    plain score of the doc it names (so a key moves only at a grid edge).
    Returns the largest gap between a plain score and its key level's
    interval."""
    b = got.shape[0]
    nsub = block_n // sub
    nk = nsub * (h + pad)
    lanes = tile_lanes(block_n, sub, h, guard, pad)
    nb = got.shape[1] // lanes
    g3, r3 = got.view(b, nb, lanes), ref.view(b, nb, lanes)
    if not torch.equal(g3[:, :, nk + int(guard):], r3[:, :, nk + int(guard):]):
        raise AssertionError(f"{name}: dead lanes differ")
    g4 = g3[:, :, :nk].reshape(b, nb, nsub, h + pad)
    r4 = r3[:, :, :nk].reshape(b, nb, nsub, h + pad)
    if not torch.equal(g4[..., h:], r4[..., h:]):
        raise AssertionError(f"{name}: padding lanes differ")
    if guard and not torch.equal(g3[:, :, nk], g4[..., h - 1].amax(dim=2)):
        raise AssertionError(f"{name}: the guard lane is not the max of its tails")
    gk, rk = g4[..., :h].reshape(b, -1), r4[..., :h].reshape(b, -1)
    dead = gk == KEY_DEAD
    if not torch.equal(dead, rk == KEY_DEAD):
        raise AssertionError(f"{name}: dead keys differ")
    nkh = nsub * h
    col = torch.arange(nb * nkh, device=got.device)
    base = (col // nkh) * block_n + ((col % nkh) // h) * sub
    gi, ri = gk.long(), rk.long()
    lg = torch.div(gi, sub, rounding_mode="floor")
    lr = torch.div(ri, sub, rounding_mode="floor")
    doc = (base[None, :] + gi - lg * sub).clamp(0, scores.shape[1] - 1)
    s = scores.gather(1, doc).double()
    if clip:
        s = s.clamp(-3.0, 3.0)
    x = (s + KEY_BIAS) * qs
    lo, hi = torch.floor(x - tol * qs), torch.floor(x + tol * qs)
    ok = ((lg - lr).abs() <= 1) & (lg.double() >= lo) & (lg.double() <= hi)
    level = lg.double() / qs - KEY_BIAS
    gap = torch.clamp(torch.maximum(level - s, s - (level + 1.0 / qs)), min=0.0)
    need = float(gap[~dead].max()) if bool((~dead).any()) else 0.0
    if not bool(ok[~dead].all()):
        raise AssertionError(
            f"{name}: {int((~ok & ~dead).sum())} keys outside one grid step at an edge "
            f"(largest score gap {need}, tolerance {tol})"
        )
    return need
