"""Times the emit-shape probes against each other in one window on one CUDA
card, so that two cases are compared only within the same turns.

Each group's cases are timed once per turn, the order reversed every other
turn (``svs_tpu_torch.probes.common.time_ms``: device time per launch over
``--launches`` launches between one CUDA event pair).  A group times one
or two cases twice: the copy against its first gives the group's
same-instance spread, the largest |(copy - first) / first| of a turn.

Groups, on the probes' bf16 corpus [1,015,808 x 1536] (n_valid N - 100):
- ``kernels B=<b>`` at B = 128 and 256: the matmul floor (P8's ``mm128``,
  P4's ``matmul``) twice, P8's ``v3`` (P5's ``v3``), P6's 512/2 and 512/3
  kernels, P4's ``h8g1024``, ``hier``, ``h8g256``, ``current`` (P5's
  ``v2``) twice and ``h6g128``;
- ``paths B=<b>`` at B = 32, 64, 128, 256: production v3's path
  (``score_topk_fused3_packed``, #5 and the torch finish) twice and P6's
  512/2 path (``select10.packed``: the kernel and its torch finish), C = 400.

Pairs, b against a, one difference a turn: ``kernels``: every emit against
the floor (its emit cost) and against every cheaper emit (by median);
``paths``: 512/2 against v3.  A pair is resolved when every turn's
relative difference has one sign and is past the group's same-instance
spread in size (:func:`verdict`); otherwise it is unresolved.

    python3 tools/emit_ab.py [--turns 10] [--launches 20]

Prints the card's name and power limit, a line per pair, then one JSON
line.  No CUDA device: exit code 2.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCHES = (32, 64, 128, 256)
KERNEL_BATCHES = (128, 256)
#: The ``kernels`` group's emits (their floor, ``floor``, is not one).
EMITS = ("v3", "512/2", "512/3", "h8g1024", "hier", "h8g256", "current", "h6g128")


def turns_of(fns: dict, turns: int, launches: int, timer) -> dict:
    """``{label: [ms per launch, one a turn]}``: every case of ``fns`` once
    a turn, in order on even turns and reversed on odd ones."""
    names = list(fns)
    out = {name: [] for name in names}
    for turn in range(turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            out[name].append(timer(fns[name], launches))
    return out


def spread(times: dict, copies: dict) -> float:
    """The largest |(copy - first) / first| of any turn over the group's
    ``copies`` (``{copy: first}``)."""
    return max(abs(c - f) / f for copy, first in copies.items()
               for c, f in zip(times[copy], times[first]))


def verdict(a: list, b: list, noise: float) -> dict:
    """``b`` against ``a``, turn by turn: the differences in ms and
    relative to ``a``, their median and range, and whether the pair is
    resolved (every relative difference on one side of 0 and past
    ``noise`` in size)."""
    diff = [y - x for x, y in zip(a, b)]
    rel = [(y - x) / x for x, y in zip(a, b)]
    return {
        "diff_ms": statistics.median(diff), "diff_lo_ms": min(diff), "diff_hi_ms": max(diff),
        "rel": statistics.median(rel), "rel_lo": min(rel), "rel_hi": max(rel),
        "resolved": min(rel) > noise or max(rel) < -noise,
    }


def pair_line(group: str, what: str, v: dict, noise: float) -> str:
    word = "resolved" if v["resolved"] else "unresolved"
    return (f"{group}: {what}: {v['diff_ms']:+.4f} ms (turns {v['diff_lo_ms']:+.4f} to "
            f"{v['diff_hi_ms']:+.4f}), {v['rel'] * 100:+.2f}% (turns {v['rel_lo'] * 100:+.2f}% "
            f"to {v['rel_hi'] * 100:+.2f}%), same-instance spread {noise * 100:.2f}%: {word}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("emit_ab: CUDA is not available; this needs a GPU", file=sys.stderr)
        return 2
    from svs_tpu_torch.ops.pallas_extract import score_topk_fused3_packed
    from svs_tpu_torch.probes import common as C
    from svs_tpu_torch.probes import select8, select9, select10

    card = C.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    docs = C.synth_bf16(C.N, C.D, dev)
    qf, _ = select10.queries(C.B, C.D, dev)
    q16 = qf.to(torch.bfloat16)
    n_valid = C.N - 100

    def kernels(q):
        def p4(emit):
            return lambda: select8.extract(docs, q, n_valid, emit)

        fns = {"floor": p4("matmul"), "floor copy": p4("matmul"),
               "v3": lambda: select9.extract(docs, q, n_valid, "v3"),
               "512/2": lambda: select10.extract(docs, q, n_valid, 2),
               "512/3": lambda: select10.extract(docs, q, n_valid, 3)}
        for emit in ("h8g1024", "hier", "h8g256", "current"):
            fns[emit] = p4(emit)
        fns["current copy"] = p4("current")
        fns["h6g128"] = p4("h6g128")
        return fns, {"floor copy": "floor", "current copy": "current"}

    groups = {f"kernels B={b}": kernels(q16[:b]) for b in KERNEL_BATCHES}
    for b in BATCHES:
        qb, qb16 = qf[:b], q16[:b]
        groups[f"paths B={b}"] = (
            {"v3": lambda qb16=qb16: score_topk_fused3_packed(docs, qb16, n_valid, select10.K),
             "v3 copy": lambda qb16=qb16: score_topk_fused3_packed(docs, qb16, n_valid, select10.K),
             "512/2": lambda qb=qb: select10.packed(docs, qb, n_valid, select10.K, 2)},
            {"v3 copy": "v3"},
        )

    result = {"card": card, "turns": args.turns, "launches": args.launches, "groups": {}}
    for group, (fns, copies) in groups.items():
        times = turns_of(fns, args.turns, args.launches, C.time_ms)
        noise = spread(times, copies)
        pairs = {}
        if group.startswith("kernels"):
            for emit in EMITS:
                pairs[f"{emit} - floor"] = ("floor", emit)
            order = sorted(EMITS, key=lambda e: statistics.median(times[e]))
            for lo, hi in itertools.combinations(order, 2):
                pairs[f"{hi} - {lo}"] = (lo, hi)
        else:
            pairs["512/2 - v3"] = ("v3", "512/2")
        rec = {"ms": times, "median_ms": {k: statistics.median(v) for k, v in times.items()},
               "same_instance_spread": noise, "pairs": {}}
        for what, (a, b) in pairs.items():
            v = verdict(times[a], times[b], noise)
            rec["pairs"][what] = v
            print(pair_line(group, what, v, noise), flush=True)
        result["groups"][group] = rec
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
