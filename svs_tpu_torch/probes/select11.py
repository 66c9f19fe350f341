"""P7: the deferred-emit (ping-pong) shootout of
``benchmarks/tpu_select11.py`` on the H100.

Its three kernel bodies, each a CUDA kernel here with its plain version:

- :func:`same_step` (``_same_step_kernel`` :105, call :263): v3 at block
  4096, the emit at the block's last contraction step: per 1024-doc
  subtile the top 4 keys ``floor((clip(s, -3, 3) + KEY_BIAS) * 4096) *
  1024 + lane`` at lanes ``s * 4 + h``, the guard at lane 16, lanes 17-127
  ``KEY_DEAD``.  The production v3 core (``csrc/fused3.cuh``) under a
  variant (``csrc/probes/select11_steps.cu``);
- :func:`deferred` (``_deferred_kernel`` :145, call :251): the same tiles,
  bit for bit, with the emit of one chunk overlapped with the product of
  the next by a ping-pong of two consumer warpgroups
  (``csrc/probes/select11_deferred.cu``: the design and what it costs);
- :func:`floor` (``matmul_floor_blocked``'s ``kern`` :332, call :354): the
  matmul-only floor, lane 0 of each 8192- or 4096-doc block's tile the
  block's max score over all its docs, lanes 1-127 zero.

All at the probe's contraction chunk of 128 columns (2 stages of 64 bf16
columns per wgmma run, summed from zero and added to the f32 total with one
round-to-nearest add).  :func:`packed4096` is the probe's candidate path
on those tiles (merge, decode, bound; plain torch).  Case B of the script,
the production v3, is the port's own ``score_topk_fused3_packed`` (#5).

The queries are bf16, as the port's v3 kernels take them.  The script
feeds f32 queries to bf16 docs (``tpu_select11.py:411-413``): a bf16
product on a TPU at default precision, an f32 one on the CPU in interpret
mode; the tests give the JAX probe the same bf16 queries, so both compute
one function.

    python -m svs_tpu_torch.probes.select11            # on the card
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.pallas_extract import score_topk_fused3_packed
from ..ops.topk import scores_matmul
from . import common as C

BLK = 4096
DIM_CHUNK = 128
NSUB = BLK // C.SUBTILE  # 4 subtiles per block
KEYS_PB = NSUB * C.H  # 16 key lanes per block
#: Candidates of the probe's timed path (``tpu_select11.py:67``), and at
#: the script's smoke size (``:64``, a corpus below the probe's N).
K = 400
SMOKE_K = 50
#: Batches at which v3 and the deferred emit are set side by side.
SMALL_BATCHES = (32, 64, 128)


def _check(docs, q, n_valid: int, block_n: int) -> tuple:
    n, d = docs.shape
    b = q.shape[0]
    C.check_operand(docs, torch.bfloat16, (n, d), "docs")
    C.check_operand(q, torch.bfloat16, (b, d), "queries")
    if not (0 < b <= 256 and n % block_n == 0 and d % DIM_CHUNK == 0 and 0 <= n_valid <= n):
        raise ValueError(f"P7 needs 0 < b <= 256, n % {block_n} == 0, d % 128 == 0; got {b}, {n}, {d}")
    return n, d, b


def same_step_plain(docs, q, n_valid: int) -> torch.Tensor:
    """Plain-torch version of the same-step and the deferred kernels (one
    function): the chunked f32 sum, the clipped v3 keys, the 4096 tiles."""
    acc = C.chunked_scores(docs, q, DIM_CHUNK)
    return C.v3_tiles(C.v3_keys(acc, clip=True), n_valid, BLK)


def _emit_launch(kind: int, docs, q, n_valid: int, what: str) -> torch.Tensor:
    n, d, b = _check(docs, q, n_valid, BLK)
    out = torch.full((b, C.tile_cols(n, BLK)), C.KEY_DEAD, dtype=torch.float32, device=docs.device)
    C.launch("svs_probe_select11", what, docs.device, kind, BLK, q.data_ptr(),
             docs.data_ptr(), b, n, d, int(n_valid), out.data_ptr())
    return out


def same_step(docs, q, n_valid: int) -> torch.Tensor:
    """P7's variant C: v3 tiles ``[B, (N / 4096) * 128]``, the emit after
    each chunk's product.  CUDA kernel for CUDA tensors, else plain."""
    if not docs.is_cuda:
        return same_step_plain(docs, q, n_valid)
    out = _emit_launch(0, docs, q, n_valid, "P7 same-step")
    same_step.launches += 1  # type: ignore[attr-defined]
    return out


same_step.launches = 0  # type: ignore[attr-defined]


def deferred(docs, q, n_valid: int) -> torch.Tensor:
    """P7's variant D: the same tiles as :func:`same_step`, bit for bit,
    the emit deferred behind the next chunk's product."""
    if not docs.is_cuda:
        return same_step_plain(docs, q, n_valid)
    out = _emit_launch(1, docs, q, n_valid, "P7 deferred")
    deferred.launches += 1  # type: ignore[attr-defined]
    return out


deferred.launches = 0  # type: ignore[attr-defined]


def floor_plain(docs, q, block_n: int) -> torch.Tensor:
    """Plain-torch version of the blocked floor."""
    acc = C.chunked_scores(docs, q, DIM_CHUNK)
    b, n = acc.shape
    out = torch.zeros((b, n // block_n, C.OUT_LANES), dtype=torch.float32, device=acc.device)
    out[:, :, 0] = acc.view(b, n // block_n, block_n).amax(dim=2)
    return out.view(b, -1)


def floor(docs, q, block_n: int) -> torch.Tensor:
    """P7's matmul-only floor (cases A and E): ``[B, (N / block_n) *
    128]``, lane 0 of a tile its block's max score, the others 0."""
    if block_n not in (8192, 4096):
        raise ValueError(f"block {block_n}: the floor runs at 8192 or 4096")
    if not docs.is_cuda:
        return floor_plain(docs, q, block_n)
    n, d, b = _check(docs, q, 0, block_n)
    out = torch.zeros((b, n // block_n, C.OUT_LANES), dtype=torch.float32, device=docs.device)
    out[:, :, 0] = float("-inf")  # the blocks' maxima fold in with an atomic max
    C.launch("svs_probe_select11", f"P7 floor {block_n}", docs.device, 2, block_n,
             q.data_ptr(), docs.data_ptr(), b, n, d, n, out.data_ptr())
    floor.launches += 1  # type: ignore[attr-defined]
    return out.view(b, -1)


floor.launches = 0  # type: ignore[attr-defined]


def extract4096(docs, q, n_valid: int, deferred_emit: bool) -> torch.Tensor:
    return (deferred if deferred_emit else same_step)(docs, q, n_valid)


def packed4096(docs, q, n_valid: int, c: int, deferred_emit: bool) -> torch.Tensor:
    """The probe's candidate path on the 4096-block tiles
    (``tpu_select11.py:280-301``): the top ``c`` keys, their values and
    rows, the bound (the guard's value, or the weakest candidate's, +inf
    once the keys run dead) folded into the last value.  Returns ``[B, 2,
    c]``: values, then rows as f32."""
    out = extract4096(docs, q, n_valid, deferred_emit)
    sel, vals, rows, guard = C.top_keys(out, c, BLK)
    bound = torch.maximum(guard, vals[:, -1])
    bound = torch.where(sel[:, -1] <= C.KEY_DEAD, float("inf"), bound)
    vals = torch.cat([vals[:, :-1], torch.maximum(vals[:, -1:], bound[:, None])], dim=1)
    return torch.stack([vals, rows.to(torch.float32)], dim=1)


def check_tiles(docs, q, n_valid: int) -> None:
    """The probe's first check: the deferred tiles equal the same-step
    tiles bit for bit (``tpu_select11.py:417-426``)."""
    a, d = same_step(docs, q, n_valid), deferred(docs, q, n_valid)
    if not C.same_bits(a, d):
        bad = (a.view(torch.int32) != d.view(torch.int32)).nonzero()
        raise AssertionError(f"deferred tiles differ at {bad[:4].tolist()}")


def check_sound(docs, q, n_valid: int, k: int) -> None:
    """The probe's second check (``tpu_select11.py:429-454``): on the
    deferred path every query gets ``k`` distinct live rows, and each of
    the top min(100, k) rows by exact f32 score that it misses scores at
    most the bound (its last value) + 2e-3."""
    both = packed4096(docs, q, n_valid, k, True)
    vals, rows = both[:, 0, :].cpu(), both[:, 1, :].long().cpu()
    scores = scores_matmul(docs, q).cpu()  # exact f32, the corpus widened by blocks
    scores[:, n_valid:] = float("-inf")
    top = min(100, k)
    for bq in range(q.shape[0]):
        got = set(rows[bq].tolist())
        if len(got) != k or not all(0 <= r < n_valid for r in got):
            raise AssertionError(f"query {bq}: {len(got)} distinct rows, or a dead one")
        bound = float(vals[bq, -1])
        for r in torch.argsort(scores[bq], descending=True)[:top].tolist():
            if r not in got and not float(scores[bq, r]) <= bound + 2e-3:
                raise AssertionError((bq, r, float(scores[bq, r]), bound))


def time_cases(docs, q, n_valid: int, k: int = K, windows: int = 5, launches: int = 20) -> dict:
    """Cases A-E at the batch of ``q`` and v3 against the deferred emit at
    ``SMALL_BATCHES``, ``k`` candidates: device time (on the CPU the plain
    versions' host time)."""
    host = not docs.is_cuda
    b = q.shape[0]
    cases = {
        f"A bf16 b={b} floor 8192": lambda: floor(docs, q, 8192),
        f"E bf16 b={b} floor 4096": lambda: floor(docs, q, BLK),
        f"B bf16 b={b} v3 (prod)": lambda: score_topk_fused3_packed(docs, q, n_valid, k),
        f"C bf16 b={b} same-step": lambda: packed4096(docs, q, n_valid, k, False),
        f"D bf16 b={b} deferred": lambda: packed4096(docs, q, n_valid, k, True),
    }
    for sb in SMALL_BATCHES:
        qb = q[:sb]
        cases[f"bf16 b={sb:<3} v3"] = lambda qb=qb: score_topk_fused3_packed(docs, qb, n_valid, k)
        cases[f"bf16 b={sb:<3} deferred"] = lambda qb=qb: packed4096(docs, qb, n_valid, k, True)
    return {label: C.time_case(fn, windows, launches, host=host) for label, fn in cases.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="P7: the deferred-emit shootout on the H100")
    ap.add_argument("--device", default=None, help="default: the card; cpu: the plain versions")
    ap.add_argument("--docs", type=int, default=C.N, help="a multiple of 8192")
    args = ap.parse_args(argv)
    dev = C.resolve_device(args.device)
    print("device:", C.device_line(dev), flush=True)
    docs = C.synth_bf16(args.docs, C.D, dev)
    q = torch.from_numpy(C.unit_queries(C.B, C.D)).to(dev).to(torch.bfloat16)
    n_valid = args.docs - 100
    k = K if args.docs >= C.N else SMOKE_K
    check_tiles(docs, q[:8], n_valid)
    print("tiles: deferred == same-step (bitwise) OK", flush=True)
    check_sound(docs, q[:8], n_valid, k)
    print("candidates: sound vs oracle OK", flush=True)
    times = time_cases(docs, q, n_valid, k)
    b = q.shape[0]
    for label, t in times.items():
        print(C.case_line(f"{label:26}", t), flush=True)
        if label.startswith("D "):
            per = [times[f"{x} bf16 b={b} {y}"]["ms"] / b * 1e3
                   for x, y in (("B", "v3 (prod)"), ("C", "same-step"), ("D", "deferred"))]
            print(f"  -> v3 {per[0]:.1f} | same-step {per[1]:.1f} | deferred {per[2]:.1f} "
                  f"us/query {times[label]['clock']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
