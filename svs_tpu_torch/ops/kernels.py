"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded through ``ctypes``: one ``nvcc``
per ``.cu`` file, all started together, then one link.  The build happens
at first use, from the sources in the package and nothing else, into
``build/svs_tpu_torch/<hash>/`` beside the package (keyed by a hash of the
sources and flags, so an edited kernel never loads a stale build).
Nothing here runs at import: the CPU never builds or loads the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "svs_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: Seconds the last build took (0.0 when the library came from the cache).
build_seconds = 0.0


def _sources(csrc: Path) -> list[Path]:
    return sorted(
        p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh")
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "svs_tpu_torch CUDA kernels are built from source at first use"
    )


def library_path(csrc: Path = _CSRC) -> Path:
    """Where the library of the sources in ``csrc`` lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libsvs_kernels.so"


def _build(target: Path, csrc: Path) -> None:
    global build_seconds
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in _sources(csrc) if p.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(
        prefix=".build-", dir=str(target.parent)
    ) as tmp:
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in cu]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
            for src, obj in zip(cu, objs)
        ]
        failed = []
        for src, proc in zip(cu, procs):
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"== {src.name} ({proc.returncode})\n{out}{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = str(Path(tmp) / "libsvs_kernels.so")
        proc = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", so, *objs],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(so, target)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0


#: The C interface of this tree's ``csrc``: argument types of each launcher
#: (each returns a ``cudaError_t`` as int).
_vp, _i, _sz, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_longlong
SIGNATURES = {
    "svs_fused_int8": ([_i, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp, _vp, _vp], _i),
    "svs_fused_float": ([_i, _i, _vp, _vp, _i, _i, _i, _i, _vp, _vp, _vp], _i),
    "svs_staged_finish_scratch": ([_i, _i, _i, _i, _i], _ll),
    "svs_staged_finish": ([_vp, _i, _i, _i, _i, _i, _vp, _vp, _vp, _vp, _sz, _vp], _i),
    "svs_extract": ([_vp, _i, _i, _vp, _vp, _vp], _i),
    "svs_pair_keys": ([_vp, _i, _i, _vp, _vp], _i),
}


def build(csrc: Path = _CSRC) -> Path:
    """The library of the sources in ``csrc`` (the package's own, or the
    same files from another tree), built first if needed."""
    path = library_path(csrc)
    if not path.exists():
        _build(path, csrc)
    return path


def load(csrc: Path = _CSRC) -> ctypes.CDLL:
    """The library of the sources in ``csrc``, built first if needed, with
    every launcher of :data:`SIGNATURES` bound (a missing one raises)."""
    lib = ctypes.CDLL(str(build(csrc)))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = load()
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")
