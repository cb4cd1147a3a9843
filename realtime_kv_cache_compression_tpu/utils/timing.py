"""Device timing: host clock around work that ends in `block_until_ready`.

JAX returns before the device finishes, so a timed region waits for every
output it produced; without the wait it would measure the enqueue.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import jax


def timed(fn: Callable[[], object], reps: int = 3) -> Tuple[float, object]:
    """Best-of-reps wall time of fn(), waiting on its outputs.

    Returns (seconds, last_result)."""
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best, out
