"""The benchmark probes of ``svs_tpu`` on the H100: the Pallas probe
bodies of ``benchmarks/tpu_int8_opt.py`` (P9), ``tpu_bf16_opt.py`` (P8),
``tpu_select11.py`` (P7), ``tpu_select10.py`` (P6), ``tpu_select9.py`` (P5)
and ``tpu_select8.py`` (P4), each a hand-written CUDA kernel
(``csrc/probes``, a library of their own built at a probe's first use)
beside its plain PyTorch version.

- :mod:`.int8_opt` — the guarded v3 int8 emit and its variants (v3dq: the
  query scale folded into the key grid), the matmul-only floor, at
  contraction chunks 128 and 256;
- :mod:`.bf16_opt` — the bf16 v3 emit and the floor at blocks 8192 and
  4096, chunks 128 and 256;
- :mod:`.select11` — v3 at block 4096 with the emit in the same step as
  its block's product or deferred behind the next chunk's (a ping-pong of
  two consumer warpgroups), and the blocked matmul floors;
- :mod:`.select10` — the guarded prototypes at 512-doc subtiles and 2 or 3
  keys each, their finish, and the soundness of their bound on a random
  corpus and a planted hot span, beside the production v3;
- :mod:`.select9` — the v3 prototype against v2 (top 8 per 512 docs) and
  the floor;
- :mod:`.select8` — the keyed kernel's six emits: current, the "hier"
  fold, top-H per 128-, 256- and 1024-doc group, and the floor.

The last three run the v3 core under ``fused3::KeyedVariant`` (subtile
width, list length, key grid, clip, guard, padding, the fold).  They
measure the v3 kernels' floors and emit designs; no path of the package
calls them.  Run one on the card with ``python -m
svs_tpu_torch.probes.select11`` (``int8_opt``, ``bf16_opt``, ``select10``,
``select9``, ``select8``); with
``--device cpu`` (or ``device="cpu"`` in the functions that make data)
the plain versions run on the CPU, as the tests run them.  Without a card
and without ``cpu`` named, every entry point raises.
"""

from __future__ import annotations

#: ``(module, wrapper)`` of every probe kernel, for launch accounting.
_WRAPPERS = (
    ("int8_opt", "extract"),
    ("bf16_opt", "extract"),
    ("select11", "same_step"),
    ("select11", "deferred"),
    ("select11", "floor"),
    ("select10", "extract"),
    ("select9", "extract"),
    ("select8", "extract"),
)


def kernel_wrappers() -> dict:
    """``{"<module>.<wrapper>": wrapper}`` of every probe kernel."""
    import importlib

    return {
        f"{mod}.{name}": getattr(importlib.import_module(f"{__name__}.{mod}"), name)
        for mod, name in _WRAPPERS
    }


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
