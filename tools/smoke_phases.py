"""Runs named phases of ``chip_smoke.py`` alone on a CUDA card.

Each phase that takes only a work directory (the local provider's:
``local``, ``local_xlmr``, ``local_bigbird``, ``local_mistral``,
``local_gptj``, ``local_blenderbot``; ``providers``, ``pairwise``) runs as
the smoke runs it,
with its launch counts set to 0 before it and read after;
``local_families`` runs on checkpoints written first
(``chip_smoke.start_families``), their CPU runs beside the phases named
before it; ``probes`` runs the benchmark probes' phase (its library built
at first use).  The kernels are built from the checkout first.  Prints the card's name and power
limit, each phase's seconds and the total, and writes the phases' records
to ``--json`` (default ``build/smoke_phases.json``).  A failing
phase raises (exit code 1); no CUDA device: exit code 2.

    python3 tools/smoke_phases.py local_mistral local_gptj local_families
    python3 tools/smoke_phases.py local_blenderbot
    python3 tools/smoke_phases.py probes
"""

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+", help="phase names (chip_smoke.<name>_phase)")
    ap.add_argument("--json", default=str(ROOT / "build" / "smoke_phases.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("smoke_phases: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from svs_tpu_torch.ops import kernels
    from svs_tpu_torch.probes.common import card_line

    work = ROOT / "build" / "smoke_phases"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    os.environ["SVS_TPU_AUTOCALIB"] = "0"
    os.environ["SVS_TPU_CALIB_CACHE"] = str(work / "dispatch.json")
    print(card_line(), flush=True)
    t = time.perf_counter()
    kernels.library()
    print(f"kernels built in {time.perf_counter() - t:.1f} s", flush=True)
    out: dict = {"paths": {}, "launches": {}}
    t0 = time.perf_counter()
    try:  # a failing phase raises: exit code 1, its traceback, the records so far
        families = chip_smoke.start_families(work) if "local_families" in args.phases else None
        for name in args.phases:
            t = time.perf_counter()
            if name == "probes":  # the benchmark probes: no work directory
                chip_smoke.probes_phase(out)
            elif name != "local_families":
                getattr(chip_smoke, f"{name}_phase")(work, out)
            else:
                chip_smoke.local_families_phase(work, out, families)
            print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, default=str, indent=1))
        shutil.rmtree(work, ignore_errors=True)
        print(f"total {time.perf_counter() - t0:.1f} s; records in {args.json}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
