"""Profiling / tracing helpers.

The reference profiles with Xcode GPU Frame Capture and Metal System
Trace (``xcode_setup_guide.md:37-47``) and stubs an in-process capture
scaffold (``main.mm:34-38``); the equivalents here are
``jax.profiler`` traces viewable in Perfetto/XProf plus the roofline
accounting in ``utils/roofline.py``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/fam_trace") -> Iterator[None]:
    """Capture a device trace: view with xprof/tensorboard or Perfetto.

    Usage::

        with trace("/tmp/fam_trace"):
            flash_attention(q, k, v).block_until_ready()
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (shows up as a track annotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def device_memory_stats(device: Optional[jax.Device] = None) -> dict:
    """Live/peak HBM usage for OOM debugging (None off-device)."""
    d = device or jax.devices()[0]
    stats = getattr(d, "memory_stats", lambda: None)()
    if not stats:
        return {}
    return {
        "bytes_in_use": stats.get("bytes_in_use"),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }
