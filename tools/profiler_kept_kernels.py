"""Which kernel events ``torch.profiler`` keeps over a process's life, on
a CUDA card.

Every ``--every`` seconds (from 0 to ``--seconds``) the script runs two
groups of ``--sessions`` profiler sessions back to back, each session
three small matrix products and a device sync.  In the first group a
session starts right after the one before it stops; in the second a
device sync comes first.  It prints, per session, the launch events and
kernel events its trace kept (6/6 when all are kept) and its wall time.

Kineto keeps CUPTI attached from one profile to the next unless
``TEARDOWN_CUPTI=1``; with it, it tears CUPTI down after each profile,
which a later CUDA call completes.  Run the script with the variable set
to 0 and to 1 to compare (``svs_tpu_torch`` sets 1 when it is unset, and
syncs the device before each trace it takes):

    TEARDOWN_CUPTI=0 python3 tools/profiler_kept_kernels.py --seconds 180 --every 60
    TEARDOWN_CUPTI=1 python3 tools/profiler_kept_kernels.py --seconds 180 --every 60
"""

import argparse
import glob
import json
import os
import tempfile
import time


def group(x, sessions: int, sync_first: bool) -> str:
    """``sessions`` profiles back to back: "launches/kernels" kept by each,
    and each one's wall (ms, the profiler's start and stop included)."""
    import torch

    kept, walls = [], []
    with tempfile.TemporaryDirectory() as root:
        for i in range(sessions):
            out = os.path.join(root, str(i))
            if sync_first:
                torch.cuda.synchronize()
            start = time.perf_counter()
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                on_trace_ready=torch.profiler.tensorboard_trace_handler(out),
            ):
                for _ in range(3):
                    x @ x
                torch.cuda.synchronize()
            walls.append(round((time.perf_counter() - start) * 1e3, 1))
            (path,) = glob.glob(os.path.join(out, "*.json"))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                           and "Launch" in str(e.get("name")))
            kernels = sum(1 for e in events if e.get("cat") == "kernel")
            kept.append(f"{launches}/{kernels}")
    return f"{' '.join(kept)}; ms {walls}"


def main() -> int:
    t0 = time.monotonic()
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=180)
    ap.add_argument("--every", type=float, default=60)
    ap.add_argument("--sessions", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_kept_kernels: needs a CUDA card")
        return 2
    x = torch.randn(256, 256, device="cuda")
    teardown = os.environ.get("TEARDOWN_CUPTI")
    target = 0.0
    while target <= args.seconds:
        time.sleep(max(0.0, target - (time.monotonic() - t0)))
        for sync_first in (False, True):
            print(f"t={time.monotonic() - t0:.0f} s, TEARDOWN_CUPTI={teardown}, "
                  f"{'sync first' if sync_first else 'back to back'}: launches/kernels "
                  f"{group(x, args.sessions, sync_first)}", flush=True)
        target += args.every
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
