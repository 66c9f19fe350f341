"""What the probe parity tests share (``tests/test_torch_probes.py``,
``tests/test_torch_probes_emits.py``): the Pallas probe scripts loaded from
their files, the seeded rows both sides get, and the views the comparisons
take."""

import importlib.util
import os
from pathlib import Path

import numpy as np

from svs_tpu_torch.probes import common as C

ROOT = Path(__file__).resolve().parent.parent


def load_script(name: str, **env):
    """``benchmarks/<name>.py`` as a module, loaded by path (unchanged),
    with ``env`` set while it loads (its smoke switches)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        spec = importlib.util.spec_from_file_location(f"probe_{name}", ROOT / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mod


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def lattice_rows(rng, n: int, d: int) -> np.ndarray:
    """Entries m * 2^-7, m in [-4, 4]: exact in bf16, every partial sum of a
    dot an exact f32 number, so every order of summation agrees."""
    return rng.integers(-4, 5, (n, d)).astype(np.float32) / 128.0


def written(tiles: np.ndarray, nk: int, lanes: int = C.OUT_LANES) -> np.ndarray:
    """The lanes a guarded probe writes (``nk`` keys and the guard), the
    others KEY_DEAD as the port fills them."""
    b = tiles.shape[0]
    t3 = np.asarray(tiles, dtype=np.float32).reshape(b, -1, lanes)
    out = np.full_like(t3, C.KEY_DEAD)
    out[:, :, : nk + 1] = t3[:, :, : nk + 1]
    return out.reshape(b, -1)
