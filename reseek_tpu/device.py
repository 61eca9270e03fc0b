"""The one place that decides what the program runs on.

The platform is JAX's default backend: "gpu" on a CUDA card, "cpu" where
JAX is held to the host (the tests).  Every choice that depends on it is
made from here: the engine `engine="auto"` picks, and whether the device
path uses the repository's CUDA kernels (ops/sw_cuda.py) or the plain
JAX versions XLA compiles (ops/sw_sweep.py, ops/sw_jax.py).  A broken
CUDA plugin raises here; it is never taken for a missing card.
"""

from __future__ import annotations

import contextlib

KERNELS = ("mu", "align")  # ops/sw_cuda.py: Mu filter, stage-3 traceback
_plain: frozenset = frozenset()


def platform() -> str:
    import jax
    return jax.default_backend()


def default_engine() -> str:
    """Search engine for engine="auto": the batched device engine on the
    GPU, the per-pair host engine on the CPU."""
    p = platform()
    if p == "gpu":
        return "device"
    if p == "cpu":
        return "host"
    raise RuntimeError(f"unsupported JAX platform {p!r}")


def kernels(name: str) -> bool:
    """Whether device code calls the hand-written CUDA kernel `name` (one
    of KERNELS): on the GPU, unless `plain_kernels()` covers it."""
    assert name in KERNELS, name
    return name not in _plain and platform() == "gpu"


@contextlib.contextmanager
def plain_kernels(*names: str):
    """Run the device path on the plain JAX versions of the named kernels
    (all when none is named), i.e. on what XLA makes of them, e.g. to time
    a kernel against its plain version.  Compiled functions are keyed on
    the choice, so both stay cached."""
    global _plain
    old, _plain = _plain, frozenset(names or KERNELS)
    try:
        yield
    finally:
        _plain = old
