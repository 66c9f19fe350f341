"""Kernel-dispatch auto-calibration: measured winners, not hardcoded
crossovers (port of ``svs_tpu.engine.calibrate``).

The v2 (keyed) vs v3 (guarded) selection kernels trade off differently
with batch size, block count and precision; the static dispatch prior
(``GUARD_MIN_BATCH`` = 16) is a point measurement from another chip.  On
the H100 the v3 core already wins below it (int8 B=8: v2 on the first
core 0.79 ms, the v3 core about 0.50 ms).

So the crossover is *derived*: on the first use of a (device kind,
precision, shape class) on a CUDA device the engine spawns a one-time
background probe that times both kernels at the live shape on the live
corpus and persists the winner.  Until the probe lands (and on the CPU,
where the plain versions' timings say nothing about the card) the static
prior decides.  Decisions are sticky per engine instance, so the
prescore-error bound and the dispatch never drift within one engine's
lifetime (``RetrievalEngine._calib_winner``).

Keys and the cache are the port's own, so that H100 winners never mix
with TPU ones: the device kind is ``torch.cuda.get_device_name`` with
spaces replaced by ``_``, the measurement tag is ``ce1`` (CUDA events
around a chain of launches; the reference's is ``m2``), and the default
cache file is ``~/.cache/svs_tpu_torch/dispatch.json``.
``$SVS_TPU_CALIB_CACHE`` overrides it; delete it to re-calibrate.
``SVS_TPU_AUTOCALIB=0`` (or ``off``) disables probing, ``force`` probes on
the CPU too (tests); both are read at call time.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
import time
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Optional, Tuple, Union

import torch

if TYPE_CHECKING:  # pragma: no cover - annotations only
    from .packing import PackedCorpus

log = logging.getLogger(__name__)

#: The measurement method's tag, the last field of every key: CUDA events
#: around ``_PROBE_CHAIN`` launches on the probe's own stream.
MEASUREMENT_TAG = "ce1"


def _bucket_pow2(x: int) -> int:
    """Round up to a power of two — shape-class granularity: a probe at
    n=1,015,808 should also serve n=1,000,000-ish repacks."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def dispatch_key(
    device_kind: str, precision: str, n_rows: int, d: int, b: int, c: int
) -> str:
    """Shape-class key: device kind + precision + bucketed rows/batch/
    candidates + exact dim (dim changes the kernel's inner loop shape
    directly) + the measurement tag (:data:`MEASUREMENT_TAG`)."""
    return (
        f"{device_kind}|{precision}|n{_bucket_pow2(n_rows)}"
        f"|d{d}|b{_bucket_pow2(b)}|c{_bucket_pow2(c)}|{MEASUREMENT_TAG}"
    )


def device_kind(device: Union[str, torch.device, None]) -> str:
    """The key's device field: the CUDA device's name with spaces replaced
    by ``_`` (``NVIDIA_H100_80GB_HBM3``), ``cpu`` otherwise."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev).replace(" ", "_")


def default_cache_path() -> Path:
    return Path.home() / ".cache" / "svs_tpu_torch" / "dispatch.json"


class DispatchCalibrator:
    """Persistent (winner per shape-class) store with single-flight
    probe claiming.  Thread-safe; loads lazily; a corrupt or unwritable
    cache file degrades to in-memory-only operation."""

    def __init__(self, path: Optional[Path] = None) -> None:
        self._lock = threading.Lock()
        self._loaded = False
        self._entries: Dict[str, Dict[str, object]] = {}
        self._probing: set = set()
        self._path = path

    def path(self) -> Optional[Path]:
        if self._path is None:
            env = os.environ.get("SVS_TPU_CALIB_CACHE")
            self._path = Path(env) if env else default_cache_path()
        return self._path

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        p = self.path()
        try:
            if p is not None and p.is_file():
                data = json.loads(p.read_text())
                if isinstance(data, dict):
                    self._entries = {
                        k: v for k, v in data.items() if isinstance(v, dict)
                    }
        except (OSError, ValueError) as exc:  # corrupt: recalibrate
            log.warning("ignoring unreadable calibration cache %s (%s)",
                        p, exc)
            self._entries = {}

    def decide(self, key: str) -> Optional[str]:
        """The persisted winner ('v2'/'v3') for this shape class, or
        ``None`` when it has not been measured."""
        with self._lock:
            self._ensure_loaded()
            entry = self._entries.get(key)
            winner = entry.get("winner") if entry else None
            return winner if winner in ("v2", "v3") else None

    def entries(self) -> Dict[str, Dict[str, object]]:
        """A copy of every measured entry (key -> winner, v2_ms, v3_ms)."""
        with self._lock:
            self._ensure_loaded()
            return {k: dict(v) for k, v in self._entries.items()}

    def claim_probe(self, key: str) -> bool:
        """Single-flight probe claim: True exactly once per un-measured
        key per process."""
        with self._lock:
            self._ensure_loaded()
            if key in self._entries or key in self._probing:
                return False
            self._probing.add(key)
            return True

    def release_probe(self, key: str) -> None:
        with self._lock:
            self._probing.discard(key)

    def record(self, key: str, winner: str, v2_s: float, v3_s: float) -> None:
        """Persist a measured winner (atomic tmp+replace; failures keep
        the in-memory entry so this process still benefits)."""
        if winner not in ("v2", "v3"):
            raise ValueError(f"winner must be 'v2' or 'v3', got {winner!r}")
        with self._lock:
            self._ensure_loaded()
            self._entries[key] = {
                "winner": winner,
                "v2_ms": round(v2_s * 1e3, 4),
                "v3_ms": round(v3_s * 1e3, 4),
            }
            self._probing.discard(key)
            snapshot = dict(self._entries)
        p = self.path()
        try:
            if p is not None:
                p.parent.mkdir(parents=True, exist_ok=True)
                tmp = p.with_suffix(".tmp")
                tmp.write_text(json.dumps(snapshot, indent=1, sort_keys=True))
                os.replace(tmp, p)
        except OSError as exc:
            log.warning("could not persist calibration cache %s (%s)", p, exc)
        log.info("dispatch calibration %s: winner=%s (v2 %.2f ms, "
                 "v3 %.2f ms)", key, winner, v2_s * 1e3, v3_s * 1e3)


_calibrator: Optional[DispatchCalibrator] = None
_calibrator_lock = threading.Lock()


def get_calibrator() -> DispatchCalibrator:
    global _calibrator
    with _calibrator_lock:
        if _calibrator is None:
            _calibrator = DispatchCalibrator()
        return _calibrator


def reset_calibrator() -> None:
    """Test hook: drop the process-wide calibrator (e.g. after changing
    ``SVS_TPU_CALIB_CACHE``)."""
    global _calibrator
    with _calibrator_lock:
        _calibrator = None


def probing_enabled(device: Union[str, torch.device, None] = None) -> bool:
    """Active probing policy: off when disabled by env
    (``SVS_TPU_AUTOCALIB=0|off``), off unless ``device`` (the engine's; by
    default the card when there is one) is a CUDA device — the plain
    versions' CPU timings say nothing about the card.
    ``SVS_TPU_AUTOCALIB=force`` probes on the CPU too (tests)."""
    mode = os.environ.get("SVS_TPU_AUTOCALIB", "1")
    if mode in ("0", "off"):
        return False
    if mode == "force":
        return True
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


#: Dependent launches per timed probe run: one CUDA event pair brackets the
#: chain, so the per-run host overhead amortises over it.
_PROBE_CHAIN = 8


def time_kernel_pair(
    corpus: "PackedCorpus",
    data: torch.Tensor,
    scales: Optional[torch.Tensor],
    q: torch.Tensor,
    c: int,
    wide: bool,
) -> Tuple[float, float]:
    """Seconds per launch of the v2 and the v3 selection path (kernel +
    finish, as the engine dispatches them) at the live shape, on the live
    corpus: after one warm-up call per side, the median of 3 runs, a run
    being ``_PROBE_CHAIN`` dependent calls (each call's queries carry
    ``0 *`` the previous wire's first value) between one CUDA event pair
    on a stream of the probe's own.  On the CPU (``force``) the plain
    versions run and the host clock times them."""
    from ..ops.pallas_extract import (
        score_topk_fused2_int8_packed,
        score_topk_fused2_packed,
        score_topk_fused3_int8_packed,
        score_topk_fused3_packed,
    )

    n_valid = corpus.n_valid
    if corpus.precision == "int8":
        def v2(qq: torch.Tensor) -> torch.Tensor:
            return score_topk_fused2_int8_packed(data, scales, qq, n_valid, c, wide=wide)

        def v3(qq: torch.Tensor) -> torch.Tensor:
            return score_topk_fused3_int8_packed(data, scales, qq, n_valid, c, wide=wide)
    else:
        def v2(qq: torch.Tensor) -> torch.Tensor:
            return score_topk_fused2_packed(data, qq, n_valid, c, wide=wide)

        def v3(qq: torch.Tensor) -> torch.Tensor:
            return score_topk_fused3_packed(data, qq, n_valid, c, wide=wide)

    def chain(fn) -> None:
        qc = q
        for _ in range(_PROBE_CHAIN):
            out = fn(qc)
            qc = qc + 0.0 * out[0, 0].to(qc.dtype)

    on_card = q.is_cuda

    def one_run(fn) -> float:
        if not on_card:
            t = time.perf_counter()
            chain(fn)
            return (time.perf_counter() - t) / _PROBE_CHAIN
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(fn)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / _PROBE_CHAIN

    def median_time(fn) -> float:
        fn(q)  # warm-up
        if on_card:
            torch.cuda.current_stream(q.device).synchronize()
        return statistics.median(one_run(fn) for _ in range(3))

    if not on_card:
        return median_time(v2), median_time(v3)
    stream = torch.cuda.Stream(device=q.device)
    # the probe's stream must see the queries (made on the caller's stream)
    stream.wait_stream(torch.cuda.current_stream(q.device))
    with torch.cuda.stream(stream):
        return median_time(v2), median_time(v3)
