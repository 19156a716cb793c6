"""Profiling helpers.

The reference profiles with span-close tracing events and manual
Instant timing (main.rs:28-50, solver.rs:209-215, SURVEY.md 5). JAX
equivalents:

- `trace(dir)` — context manager around `jax.profiler.trace`; the
  resulting traces open in TensorBoard/Perfetto with per-op HBM and
  compute-unit counters (the roofline source of truth).
- `Timer` — lightweight phase timing with block_until_ready.
- `measure_bandwidth(fn, bytes_accessed)` — time a jitted op and report
  achieved GB/s.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/orc_cfd_trace"):
    with jax.profiler.trace(log_dir):
        yield log_dir


class Timer:
    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.phases[name] = self.phases.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [
            f"{k:>24}: {v*1e3:9.2f} ms ({100*v/total:5.1f}%)"
            for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


def measure(fn: Callable, *args, warmup: int = 2, iters: int = 10):
    """Median wall time of fn(*args) with device sync. Returns seconds."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def measure_bandwidth(fn: Callable, bytes_accessed: int, *args, **kw):
    """(seconds, GB/s) for a memory-bound op."""
    t = measure(fn, *args, **kw)
    return t, bytes_accessed / t / 1e9
