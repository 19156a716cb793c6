"""Where the program runs: the one backend decision and the compile
cache.

`kernel_mode` is the only place that decides whether a hand-written
Pallas kernel runs. The kernels (ops/pallas_assembly.py) are compiled
for the GPU through Triton, so they run compiled only on a `gpu`
backend. On any other backend the plain XLA path runs, unless the
caller asks for the kernel in interpret mode (tests, or
ORC_PALLAS_ASM=force for the fused assembly).

`setup_compile_cache` keeps JAX's persistent compilation cache where
JAX_COMPILATION_CACHE_DIR says, or else at one fixed path inside the
checkout (the path is part of the cache key, so it must not move).
`card` and `device_tag` name the hardware beside every measurement.
"""

from __future__ import annotations

import os

import jax

#: Default persistent compile cache: inside the checkout, git-ignored.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache",
)


def kernel_mode(interpret: bool = False) -> "str | None":
    """How a Pallas kernel may run here: "gpu" (compiled through
    Triton) on a GPU backend, "interpret" when the caller asked for it
    on another backend, else None (take the XLA path)."""
    if jax.default_backend() == "gpu":
        return "gpu"
    return "interpret" if interpret else None


def card() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them (a card below its maximum power limit runs slower
    under load, so every measurement names both)."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_tag() -> dict:
    """Platform, device kind, device count and card, for every result
    line a measurement prints."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "card": card(),
    }


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. JAX_COMPILATION_CACHE_DIR, when set, wins
    (JAX reads it itself); otherwise CACHE_DIR is used."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
