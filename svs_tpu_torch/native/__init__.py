"""ctypes loader for the native host library (``fastpack.cpp``), with
NumPy fallbacks (port of ``svs_tpu.native``: the same entry points, the
same bits).

The shared object is compiled at first use (``g++ -O3 -march=native``,
then a portable build when that fails) from the source in this package,
into ``build/svs_tpu_torch/native/<source hash>/`` beside the package:
never next to the source.  The build writes a temporary file and
``os.replace``s it into place under a file lock, so processes that reach
the first build together build it once.  A ``-march=native`` build is
tagged with this host's instruction-set fingerprint and rebuilt on a host
with another one.  Hosts without a toolchain fall back to the NumPy
implementations, which give the same bits: the native layer speeds
things up but never gates.  ``SVS_TPU_NO_NATIVE=1`` turns it off.

bf16 is carried as its raw ``uint16`` bits (the port has no
``ml_dtypes``): :func:`f32_to_bf16` and the bf16 :func:`permute_cast_pack`
return ``uint16`` arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "fastpack.cpp"
_BUILD_ROOT = _HERE.parent.parent / "build" / "svs_tpu_torch" / "native"
_BASE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_ABI = 4

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False
#: Seconds the last build in this process took (0.0 when the library came
#: from the build directory).
build_seconds = 0.0

_N_THREADS = min(16, os.cpu_count() or 1)


def library_path() -> Path:
    """Where this source's library lives (built or not)."""
    h = hashlib.sha256(" ".join(_BASE_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libfastpack.so"


def _host_fingerprint() -> str:
    """ISA fingerprint of THIS host.  The library is compiled with
    ``-march=native``, so a built artifact is only valid on hosts with the
    same instruction-set features (a build directory on a shared
    filesystem would otherwise serve an AVX-512 binary to an AVX2 host
    and SIGILL on first use)."""
    import platform

    feats = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats += "|" + " ".join(sorted(line.split()[2:]))
                    break
    except OSError:
        pass
    return hashlib.sha256(feats.encode()).hexdigest()[:16]


def _tag_path(so: Path) -> Path:
    return so.with_name(so.name + ".host")


def _usable(so: Path) -> bool:
    """A built library whose ISA tag is ``portable`` or this host's."""
    if not so.exists():
        return False
    try:
        tag = _tag_path(so).read_text().strip()
    except OSError:
        return False
    return tag in ("portable", _host_fingerprint())


def _compile(so: Path) -> bool:
    """Build ``so``: ``-march=native`` first (the int8 prescore vectorizes
    ~4x wider with AVX2/VNNI code; the artifact is built ON this host and
    tagged with its fingerprint), then a portable build.  Each attempt
    writes a temporary file that ``os.replace`` moves into place, and the
    tag follows the same way."""
    global build_seconds
    t0 = time.perf_counter()
    last: Optional[BaseException] = None
    for flags, tag in ((["-march=native"], None), ([], "portable")):
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(
                ["g++", *_BASE_FLAGS, *flags, "-o", str(tmp), str(_SRC)],
                check=True,
                capture_output=True,
                timeout=180,
            )
            tag_tmp = tmp.with_name(tmp.name + ".host")
            tag_tmp.write_text(tag or _host_fingerprint())
            os.replace(tmp, so)
            os.replace(tag_tmp, _tag_path(so))
            build_seconds = time.perf_counter() - t0
            return True
        except (OSError, subprocess.SubprocessError) as exc:
            last = exc
            tmp.unlink(missing_ok=True)
    log.info("fastpack native build unavailable (%s); using NumPy paths", last)
    return False


def _build_locked(so: Path) -> bool:
    """Build ``so`` unless a usable one is there, holding an exclusive
    lock on the build directory meanwhile (one builder at a time; the
    others wait, then find the library)."""
    import fcntl

    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _usable(so):
                return True
            return _compile(so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _abi_of(lib: ctypes.CDLL) -> int:
    try:
        return int(lib.fastpack_abi_version())
    except AttributeError:
        return 0


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if os.environ.get("SVS_TPU_NO_NATIVE") == "1" or _build_failed:
        return None
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = None
        try:
            so = library_path()
            if _usable(so) or _build_locked(so):
                lib = ctypes.CDLL(str(so))
        except OSError as exc:
            log.info("fastpack native library unavailable (%s)", exc)
            lib = None
        if lib is not None and _abi_of(lib) != _ABI:
            log.warning("fastpack ABI mismatch; using NumPy paths")
            lib = None
        if lib is None:
            _build_failed = True
            return None
        _configure(lib)
        _lib = lib
        return _lib


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.fastpack_f32_to_bf16.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_uint16), c.c_size_t, c.c_int
    ]
    lib.fastpack_quantize_int8.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_int8), c.POINTER(c.c_float),
        c.c_size_t, c.c_size_t, c.c_int,
    ]
    lib.fastpack_normalize_rows.argtypes = [
        c.POINTER(c.c_float), c.c_size_t, c.c_size_t, c.c_int
    ]
    lib.fastpack_topk_f32.argtypes = [
        c.POINTER(c.c_float), c.c_size_t, c.c_int,
        c.POINTER(c.c_float), c.POINTER(c.c_int32),
    ]
    lib.fastpack_scan_embeddings.argtypes = [
        c.c_char_p, c.c_longlong, c.c_longlong, c.c_longlong,
        c.POINTER(c.c_longlong), c.POINTER(c.c_ubyte),
    ]
    lib.fastpack_scan_embeddings.restype = c.c_longlong
    lib.fastpack_scan_embeddings_range.argtypes = [
        c.c_char_p, c.c_longlong, c.c_longlong, c.c_longlong, c.c_longlong,
        c.POINTER(c.c_longlong), c.POINTER(c.c_ubyte),
    ]
    lib.fastpack_scan_embeddings_range.restype = c.c_longlong
    lib.fastpack_permute_cast_bf16.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_int64), c.POINTER(c.c_uint16),
        c.c_size_t, c.c_size_t, c.c_size_t, c.c_int,
    ]
    lib.fastpack_permute_cast_f32.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_int64), c.POINTER(c.c_float),
        c.c_size_t, c.c_size_t, c.c_size_t, c.c_int,
    ]
    lib.fastpack_permute_cast_int8.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_int64), c.POINTER(c.c_int8),
        c.POINTER(c.c_float), c.c_size_t, c.c_size_t, c.c_size_t, c.c_int,
    ]
    lib.fastpack_int8_topc.argtypes = [
        c.POINTER(c.c_int8), c.POINTER(c.c_float), c.POINTER(c.c_int32),
        c.c_size_t, c.c_size_t,
        c.POINTER(c.c_int8), c.POINTER(c.c_float),
        c.c_size_t, c.c_int,
        c.POINTER(c.c_float), c.POINTER(c.c_int32), c.c_int,
    ]


def native_available() -> bool:
    return _get_lib() is not None


def _fptr(arr: np.ndarray, ctype: "Any") -> "Any":
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def f32_to_bf16(matrix: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 bits (``uint16``), multithreaded
    when native; a NaN keeps its sign and top payload bits, made quiet."""
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    lib = _get_lib()
    if lib is None:
        from ..engine.packing import _bf16_rne_bits

        return _bf16_rne_bits(matrix.view(np.uint32))
    out = np.empty(matrix.shape, dtype=np.uint16)
    lib.fastpack_f32_to_bf16(
        _fptr(matrix, ctypes.c_float), _fptr(out, ctypes.c_uint16),
        matrix.size, _N_THREADS,
    )
    return out


def quantize_int8(matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization on the host."""
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    rows, cols = matrix.shape
    lib = _get_lib()
    if lib is None:
        absmax = np.abs(matrix).max(axis=1)
        scales = np.maximum(absmax, 1e-30) / 127.0
        q = np.clip(np.rint(matrix / scales[:, None]), -127, 127).astype(np.int8)
        return q, scales.astype(np.float32)
    q = np.empty((rows, cols), dtype=np.int8)
    scales = np.empty((rows,), dtype=np.float32)
    lib.fastpack_quantize_int8(
        _fptr(matrix, ctypes.c_float), _fptr(q, ctypes.c_int8),
        _fptr(scales, ctypes.c_float), rows, cols, _N_THREADS,
    )
    return q, scales


def int8_topc_prescore(
    docs_i8: np.ndarray,
    row_scales: np.ndarray,
    row_sums: Optional[np.ndarray],
    queries_i8: np.ndarray,
    q_scales: np.ndarray,
    c: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Host int8 prescore + top-``c`` candidate selection per query: the
    first pass of the host two-pass search (``RetrievalEngine.
    _host_two_pass``).  ``row_sums`` (int32 per-row sums of the int8
    matrix, computed once per corpus) feeds the VNNI bias trick of
    ``fastpack.cpp``.  Returns ``(vals f32 [b, c'], idx int32 [b, c'])``
    with ``c' = min(c, rows)``, rows in descending reconstruction-score
    order (ties to the larger row index); ``None`` when the native
    library is unavailable (callers run the full f32 scan instead: a
    NumPy int8 product is slower than the f32 BLAS scan)."""
    lib = _get_lib()
    if lib is None:
        return None
    docs_i8 = np.ascontiguousarray(docs_i8, dtype=np.int8)
    queries_i8 = np.atleast_2d(np.ascontiguousarray(queries_i8, np.int8))
    row_scales = np.ascontiguousarray(row_scales, dtype=np.float32)
    q_scales = np.ascontiguousarray(q_scales, dtype=np.float32)
    rows, cols = docs_i8.shape
    b = queries_i8.shape[0]
    assert queries_i8.shape[1] == cols and q_scales.shape == (b,)
    sums_ptr = None
    if row_sums is not None:
        row_sums = np.ascontiguousarray(row_sums, dtype=np.int32)
        assert row_sums.shape == (rows,)
        sums_ptr = _fptr(row_sums, ctypes.c_int32)
    c_eff = min(int(c), rows)
    vals = np.empty((b, c_eff), dtype=np.float32)
    idx = np.empty((b, c_eff), dtype=np.int32)
    lib.fastpack_int8_topc(
        _fptr(docs_i8, ctypes.c_int8), _fptr(row_scales, ctypes.c_float),
        sums_ptr,
        rows, cols,
        _fptr(queries_i8, ctypes.c_int8), _fptr(q_scales, ctypes.c_float),
        b, c_eff,
        _fptr(vals, ctypes.c_float), _fptr(idx, ctypes.c_int32),
        _N_THREADS,
    )
    return vals, idx


def normalize_rows(matrix: np.ndarray) -> np.ndarray:
    """L2-normalize rows in a copy of ``matrix``."""
    matrix = np.array(matrix, dtype=np.float32, copy=True, order="C")
    lib = _get_lib()
    if lib is None:
        norms = np.linalg.norm(matrix, axis=1, keepdims=True)
        np.divide(matrix, norms, out=matrix, where=norms > 1e-15)
        return matrix
    lib.fastpack_normalize_rows(
        _fptr(matrix, ctypes.c_float), matrix.shape[0], matrix.shape[1],
        _N_THREADS,
    )
    return matrix


def scan_embeddings(
    path: str, after_id: int, n: int, dim: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Scan committed embedding rows with id > ``after_id`` straight into
    NumPy buffers through the SQLite C API, with no Python object per row.
    Returns ``(matrix [n, dim] f32, ids [n] int64)``, or ``None`` when the
    native library or libsqlite3 is unavailable or the scan did not see
    exactly ``n`` rows (the caller falls back to the streaming scan)."""
    lib = _get_lib()
    if lib is None or n <= 0 or dim <= 0:
        return None
    ids = np.empty((n,), dtype=np.int64)
    matrix = np.empty((n, dim), dtype=np.float32)
    got = lib.fastpack_scan_embeddings(
        str(path).encode(), after_id, n, dim * 4,
        _fptr(ids, ctypes.c_longlong), _fptr(matrix, ctypes.c_ubyte),
    )
    if got != n:
        log.debug("native embedding scan declined (rc=%d, want %d)", got, n)
        return None
    return matrix, ids


def scan_embeddings_parallel(
    path: str, ranges: "List[Tuple[int, int, int]]", n: int, dim: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parallel :func:`scan_embeddings`: each ``(after_id, upto_id,
    count)`` range is scanned on its own thread with its own read-only
    SQLite connection (disjoint btree walks parallelize the overflow-chain
    traversal that dominates the single-threaded scan).  ``ranges`` must
    partition the id space in ascending order with counts summing to
    ``n``."""
    lib = _get_lib()
    if lib is None or n <= 0 or dim <= 0:
        return None
    assert sum(cnt for _, _, cnt in ranges) == n
    ids = np.empty((n,), dtype=np.int64)
    matrix = np.empty((n, dim), dtype=np.float32)
    path_b = str(path).encode()
    results: List[int] = [0] * len(ranges)

    def scan_one(i: int, after: int, upto: int, off: int, cnt: int) -> None:
        # row-sliced views are contiguous; ctypes releases the GIL
        results[i] = lib.fastpack_scan_embeddings_range(
            path_b, after, upto, cnt, dim * 4,
            _fptr(ids[off : off + cnt], ctypes.c_longlong),
            _fptr(matrix[off : off + cnt], ctypes.c_ubyte),
        )

    import concurrent.futures as cf

    off = 0
    jobs = []
    with cf.ThreadPoolExecutor(max_workers=len(ranges)) as pool:
        for i, (after, upto, cnt) in enumerate(ranges):
            if cnt:
                jobs.append(pool.submit(scan_one, i, after, upto, off, cnt))
            off += cnt
        for j in jobs:
            j.result()
    for i, (_, _, cnt) in enumerate(ranges):
        if cnt and results[i] != cnt:
            log.debug(
                "parallel embedding scan declined (range %d rc=%d want %d)",
                i, results[i], cnt,
            )
            return None
    return matrix, ids


def permute_cast_pack(
    matrix: np.ndarray,
    perm: np.ndarray,
    precision: str,
    n_pad: int,
    d_pad: int,
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Fused permute + pad + cast into the packed host layout, one
    multithreaded pass.  Returns ``(data [n_pad, d_pad], scales [n_pad] |
    None)`` (bf16 as ``uint16`` bits) or ``None`` when the native library
    is unavailable.  Padding rows and columns are zero; int8 padding rows
    get the quantizer's zero-row scale ``1e-30 / 127``."""
    lib = _get_lib()
    if lib is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    n, d = matrix.shape
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    assert perm.shape == (n,)
    if precision == "bf16":
        out = np.zeros((n_pad, d_pad), dtype=np.uint16)
        lib.fastpack_permute_cast_bf16(
            _fptr(matrix, ctypes.c_float), _fptr(perm, ctypes.c_int64),
            _fptr(out, ctypes.c_uint16), n, d, d_pad, _N_THREADS,
        )
        return out, None
    if precision == "f32":
        out = np.zeros((n_pad, d_pad), dtype=np.float32)
        lib.fastpack_permute_cast_f32(
            _fptr(matrix, ctypes.c_float), _fptr(perm, ctypes.c_int64),
            _fptr(out, ctypes.c_float), n, d, d_pad, _N_THREADS,
        )
        return out, None
    if precision == "int8":
        out = np.zeros((n_pad, d_pad), dtype=np.int8)
        scales = np.full(
            (n_pad,), np.float32(1e-30) / np.float32(127.0), dtype=np.float32
        )
        lib.fastpack_permute_cast_int8(
            _fptr(matrix, ctypes.c_float), _fptr(perm, ctypes.c_int64),
            _fptr(out, ctypes.c_int8), _fptr(scales, ctypes.c_float),
            n, d, d_pad, _N_THREADS,
        )
        return out, scales
    raise ValueError(f"unknown precision: {precision!r}")


def topk_f32(scores: np.ndarray, k: int) -> List[Tuple[float, int]]:
    """Exact top-k over a score vector, as ``(score, index)`` pairs in
    descending order, ties to the larger index."""
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    kk = min(int(k), scores.size)
    if kk <= 0:
        return []
    lib = _get_lib()
    if lib is None:
        from ..utils.topk_np import top_k_numpy

        return top_k_numpy(scores, kk)
    vals = np.empty((kk,), dtype=np.float32)
    idx = np.empty((kk,), dtype=np.int32)
    lib.fastpack_topk_f32(
        _fptr(scores, ctypes.c_float), scores.size, kk,
        _fptr(vals, ctypes.c_float), _fptr(idx, ctypes.c_int32),
    )
    return [(float(v), int(i)) for v, i in zip(vals, idx)]
