"""P6: the guarded-kernel width shootout of ``benchmarks/tpu_select10.py``
on the H100 (its kernel body: ``make_variant``'s ``kernel`` :106 with its
``emit`` :91, called at :153; ``finish`` :175, ``candidates`` :197,
``packed`` :209, ``soundness`` :291).

Over bf16 docs ``[N, 1536]`` and bf16 queries, the prototype sums f32
products per contraction chunk of 128 columns over an 8192-doc block, then
per 512-doc subtile emits the top ``h`` (2 or 3) keys
``floor((clip(s, -3, 3) + KEY_BIAS) * 8192) * 512 + lane`` at lanes ``s *
h + i``, the guard (the max of the subtiles' ``h``-th keys) at lane ``16
h``, the rest of the block's 128 lanes ``KEY_DEAD``.  The kernel is the v3
core under a keyed variant (``csrc/probes/select10.cu``).

:func:`finish` merges the tiles (``top_k`` of the keys, decode, bound; the
bound +inf once the top key reaches the saturation key or the ``c``-th key
is dead), :func:`candidates` pads the batch to a multiple of 8 bf16 rows
first, :func:`packed` folds the bound into the last value, and
:func:`soundness` holds the candidates against an exact f32 scan, on the
random corpus and on a planted hot 512-doc span (:func:`planted_hot`).
Case A of the script, the production v3, is the port's own
``score_topk_fused3_packed`` (#5); its floor (``matmul_floor``, XLA
outside any Pallas kernel) is ``torch.matmul(...).amax(1)``.

    python -m svs_tpu_torch.probes.select10            # on the card
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys

import numpy as np
import torch

from ..ops.pallas_extract import score_topk_fused3_packed
from ..ops.topk import scores_matmul, top_k
from . import common as C

BLOCK_N = C.KEYED_BLOCK_N
SUBTILE = 512
QSCALE = C.QS2
#: The prototypes (``make_variant(512, h, 2^13)``): top 2 or 3 per 512 docs.
EMITS = {h: C.Keyed(variant=3 + h, sub=SUBTILE, h=h, clip=True, guard=True) for h in (2, 3)}
#: ``key_eps``: one step of the key grid.
KEY_EPS = 1.0 / QSCALE
#: Keys at or above this certify nothing (``sat_key``: the grid's level of
#: a 2.5 score).
SAT_KEY = float(int((2.5 + C.KEY_BIAS) * QSCALE) * SUBTILE)
#: Rows of a padded query batch (``QBLOCK``).
QBLOCK = 8
#: Candidates (``K``) at the probe's size, and at the script's smoke size
#: (a corpus below the probe's N).
K = 400
SMOKE_K = 50
#: The hot 512-doc span: 100 near-copies of row N / 3 at block 40 (the
#: smoke's block 7, or the last block of a smaller corpus), offset 1024,
#: jittered by 3e-3 normal noise.
HOT_BLOCK = 40
SMOKE_HOT_BLOCK = 7
HOT_ROWS = 100
HOT_OFFSET = 1024
HOT_JITTER = 3e-3
#: Batches at which v3 and 512/2 are set side by side.
SMALL_BATCHES = (32, 64, 128)


def extract_plain(docs, q, n_valid: int, h: int) -> torch.Tensor:
    """Plain-torch version of the kernel: the chunked f32 sum, the clipped
    keys, the guarded 512-doc tiles."""
    return EMITS[h].plain(docs, q, n_valid)


def extract(docs, q, n_valid: int, h: int) -> torch.Tensor:
    """One launch of the prototype's ``extract``: tiles ``[B, (N / 8192) *
    128]`` f32 from bf16 ``docs`` ``[N, D]`` and bf16 queries ``q`` ``[B,
    D]``.  The CUDA kernel for CUDA tensors, the plain version for CPU
    ones."""
    if h not in EMITS:
        raise ValueError(f"h={h}: the prototypes keep 2 or 3 keys a subtile")
    if not docs.is_cuda:
        return extract_plain(docs, q, n_valid, h)
    out = EMITS[h].launch(docs, q, n_valid, f"P6 512/{h}")
    extract.launches += 1  # type: ignore[attr-defined]
    return out


extract.launches = 0  # type: ignore[attr-defined]


def finish(out: torch.Tensor, c: int, h: int) -> tuple:
    """``finish``: the top ``c`` keys, their values and rows, and the bound
    ``max(guard value, weakest value)``, +inf when the top key reaches
    ``SAT_KEY`` or the ``c``-th key is dead."""
    sel, vals, rows, guard = C.top_keys(out, c, BLOCK_N, SUBTILE, h, QSCALE)
    bound = torch.maximum(guard, vals[:, -1])
    bound = torch.where(sel[:, 0] >= SAT_KEY, float("inf"), bound)
    bound = torch.where(sel[:, -1] <= C.KEY_DEAD, float("inf"), bound)
    return vals, rows, bound


def candidates(docs, q, n_valid: int, c: int, h: int) -> tuple:
    """``candidates``: the queries cast to the docs' type, padded with zero
    rows to a multiple of 8 (at least 8), through :func:`extract` and
    :func:`finish`; the padding's rows dropped."""
    b = q.shape[0]
    b_pad = max(QBLOCK, -(-b // QBLOCK) * QBLOCK)
    qq = q.to(docs.dtype)
    if b_pad != b:
        qq = torch.cat([qq, qq.new_zeros((b_pad - b, docs.shape[1]))])
    vals, rows, bound = finish(extract(docs, qq.contiguous(), n_valid, h), c, h)
    return vals[:b], rows[:b], bound[:b]


def packed(docs, q, n_valid: int, c: int, h: int) -> torch.Tensor:
    """``packed``: ``[B, 2, c]``, the values with the bound folded into the
    last, then the rows as f32."""
    vals, rows, bound = candidates(docs, q, n_valid, c, h)
    vals = torch.cat([vals[:, :-1], torch.maximum(vals[:, -1:], bound[:, None])], dim=1)
    return torch.stack([vals, rows.to(torch.float32)], dim=1)


def soundness(docs, q8, n_valid: int, c: int, h: int) -> dict:
    """The script's ``soundness``: every query's ``c`` candidates are
    distinct live rows, and each of the exact scan's top min(100, c) rows
    that they miss scores at most the bound + ``KEY_EPS`` + 1e-6 (the scan:
    bf16 queries against the bf16 docs in true f32).  Returns the missed
    count, the worst excess and the margin slack (the scan's last kept
    score minus the bound; positive: the rescore margin passes)."""
    vals, rows, bound = candidates(docs, q8, n_valid, c, h)
    scores = scores_matmul(docs, q8.to(torch.bfloat16))
    scores[:, n_valid:] = float("-inf")
    ovals, orows = top_k(scores, min(100, c))
    rows, bound = rows.cpu(), bound.cpu().double()
    ovals, orows = ovals.cpu().double(), orows.cpu()
    missing, worst = 0, 0.0
    for bq in range(q8.shape[0]):
        got = set(rows[bq].tolist())
        if len(got) != c:
            raise AssertionError(f"512/{h} query {bq}: duplicate rows")
        if not bool(((rows[bq] >= 0) & (rows[bq] < n_valid)).all()):
            raise AssertionError(f"512/{h} query {bq}: a dead row")
        for v, r in zip(ovals[bq].tolist(), orows[bq].tolist()):
            if r not in got:
                missing += 1
                if not v <= float(bound[bq]) + KEY_EPS + 1e-6:
                    raise AssertionError((f"512/{h}", bq, r, v, float(bound[bq])))
                worst = max(worst, v - float(bound[bq]))
    slack = (ovals[:, -1] - bound).tolist()
    return {"missing": missing, "of": q8.shape[0] * min(100, c), "worst_excess": worst,
            "slack_min": min(slack), "slack_median": statistics.median(slack)}


def sound_line(label: str, r: dict) -> str:
    return (f"{label:22}: {r['missing']}/{r['of']} oracle rows outside candidates (all "
            f"bounded, worst excess {r['worst_excess']:.2e}); margin slack min "
            f"{r['slack_min']:+.4f} median {r['slack_median']:+.4f}")


@contextlib.contextmanager
def planted_hot(docs, rng: np.random.Generator, hot_block: int):
    """The adversarial corpus, in place: rows ``8192 * hot_block + 1024 +
    [0, 100)`` set to jittered unit copies of row N / 3 (bf16), restored on
    exit (no second corpus).  Yields the 8 queries, row N / 3 as f32."""
    n, d = docs.shape
    hot = docs[n // 3].to(torch.float32).cpu().numpy()
    hot = hot / np.linalg.norm(hot)
    lo = BLOCK_N * hot_block + HOT_OFFSET
    if lo + HOT_ROWS > n:
        raise ValueError(f"block {hot_block} is past a corpus of {n} rows")
    jit = hot[None, :] + HOT_JITTER * rng.standard_normal((HOT_ROWS, d)).astype(np.float32)
    jit /= np.linalg.norm(jit, axis=1, keepdims=True)
    saved = docs[lo : lo + HOT_ROWS].clone()
    docs[lo : lo + HOT_ROWS] = torch.from_numpy(jit).to(docs.device).to(docs.dtype)
    try:
        yield torch.from_numpy(np.repeat(hot[None, :], 8, axis=0)).to(docs.device)
    finally:
        docs[lo : lo + HOT_ROWS] = saved


def check_soundness(docs, qf: torch.Tensor, rng: np.random.Generator, n_valid: int, c: int) -> dict:
    """The script's four soundness cases (random and hot, 512/2 and 512/3)
    on the first 8 queries ``qf`` (f32), then the hot span: ``{label:
    report}``."""
    res = {f"rand 512/H={h}": soundness(docs, qf[:8], n_valid, c, h) for h in EMITS}
    n = docs.shape[0]
    hot_block = HOT_BLOCK if n >= C.N else min(SMOKE_HOT_BLOCK, n // BLOCK_N - 1)
    with planted_hot(docs, rng, hot_block) as q_hot:
        for h in EMITS:
            res[f"hot  512/H={h}"] = soundness(docs, q_hot, n_valid, c, h)
    return res


def matmul_floor(docs, q) -> torch.Tensor:
    """``matmul_floor``: the max score of every query (cuBLAS's product)."""
    return torch.matmul(q.to(docs.dtype), docs.t()).amax(dim=1)


def time_cases(docs, qf, n_valid: int, c: int = K, windows: int = 5, launches: int = 20) -> dict:
    """The script's timed cases: the floor, v3 (production) and the 512/2
    and 512/3 candidate paths at the batch of ``qf``, v3 and 512/2 at
    ``SMALL_BATCHES``: device time (on the CPU the plain versions' host
    time)."""
    host = not docs.is_cuda
    b = qf.shape[0]
    q16 = qf.to(torch.bfloat16)
    cases = {
        f"bf16 b={b} floor": lambda: matmul_floor(docs, qf),
        f"bf16 b={b} v3 1024/4": lambda: score_topk_fused3_packed(docs, q16, n_valid, c),
        f"bf16 b={b}    512/2": lambda: packed(docs, qf, n_valid, c, 2),
        f"bf16 b={b}    512/3": lambda: packed(docs, qf, n_valid, c, 3),
    }
    for sb in SMALL_BATCHES:
        qb, qb16 = qf[:sb], q16[:sb]
        cases[f"bf16 b={sb:<3} v3"] = lambda qb16=qb16: score_topk_fused3_packed(docs, qb16, n_valid, c)
        cases[f"bf16 b={sb:<3} 512/2"] = lambda qb=qb: packed(docs, qb, n_valid, c, 2)
    return {label: C.time_case(fn, windows, launches, host=host) for label, fn in cases.items()}


def queries(b: int, d: int, device) -> tuple:
    """The script's queries (f32 unit rows from ``default_rng(0)``) and the
    generator, which goes on to jitter the hot span."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.from_numpy(q).to(device), rng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="P6: the 512-doc guarded prototypes on the H100")
    ap.add_argument("--device", default=None, help="default: the card; cpu: the plain versions")
    ap.add_argument("--docs", type=int, default=C.N, help="a multiple of 8192")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    print("device:", C.device_line(dev), flush=True)
    docs = C.synth_bf16(args.docs, C.D, dev)
    qf, rng = queries(C.B, C.D, dev)
    n_valid = args.docs - 100
    c = K if args.docs >= C.N else SMOKE_K
    for label, r in check_soundness(docs, qf, rng, n_valid, c).items():
        print(sound_line(label, r), flush=True)
    times = time_cases(docs, qf, n_valid, c)
    b = qf.shape[0]
    for label, t in times.items():
        print(C.case_line(f"{label:22}", t), flush=True)
    per = [times[f"bf16 b={b} {x}"]["ms"] / b * 1e3 for x in ("v3 1024/4", "   512/2", "   512/3")]
    print(f"  -> v3 {per[0]:.1f} | 512/2 {per[1]:.1f} | 512/3 {per[2]:.1f} us/query "
          f"{times[f'bf16 b={b} floor']['clock']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
