"""Benchmark timing discipline.

The reference times a single iteration of encode+commit+wait with no
warmup (``main.mm:676-698``) and its own docs show the resulting noise
(6.6x vs 9.29x peak across runs, SURVEY.md §6).  Here: explicit warmup
(compile excluded), several timed repetitions, and ``block_until_ready``
inside the timed region, since JAX returns before the device finishes.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


def measure(
    fn: Callable[[], object],
    *,
    warmup: int = 2,
    iters: int = 10,
) -> dict:
    """Median/min/max/mean seconds per call of ``fn()`` (host clock,
    each call waited for with ``block_until_ready``)."""
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return {
        "median_s": statistics.median(times),
        "min_s": min(times),
        "max_s": max(times),
        "mean_s": statistics.fmean(times),
        "std_s": statistics.pstdev(times) if len(times) > 1 else 0.0,
        "iters": iters,
    }


def measure_compiled(
    fn: Callable[..., object],
    args: tuple,
    *,
    iters: int = 20,
    warmup: int = 2,
) -> dict:
    """``measure`` of ``jax.jit(fn)(*args)``; compilation happens in the
    warmup and is not timed."""
    compiled = jax.jit(fn)
    return measure(lambda: compiled(*args), warmup=warmup, iters=iters)
