"""Profiling hooks: jax.profiler trace capture + per-phase wall accounting.

Counterpart of the reference's wall-clock-only instrumentation
(SURVEY.md §5 "Tracing/profiling"): `PerformanceTimer` covers named walls
(eval/metrics.py); this adds XLA-level traces viewable in TensorBoard /
Perfetto and a context manager for annotated trace regions.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a jax.profiler trace for the enclosed region."""
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside a trace (shows up on the timeline)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def device_memory_profile(path: Optional[str] = None) -> bytes:
    """Snapshot the device memory profile (pprof format)."""
    prof = jax.profiler.device_memory_profile()
    if path:
        with open(path, "wb") as f:
            f.write(prof)
    return prof
