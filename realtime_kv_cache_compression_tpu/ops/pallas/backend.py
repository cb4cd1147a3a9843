"""Where the Pallas kernels run: compiled on the GPU, interpreted on the CPU.

Every kernel in this package names its route (Pallas on Triton). There is no
implicit interpreter: the CPU backend interprets (that is how the test suite
runs the kernels), the GPU backend compiles, and any other backend raises.
"""

from __future__ import annotations

import jax


def interpret_mode() -> bool:
    """True on the CPU (interpreter), False on the GPU (compiled)."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise NotImplementedError(
        f"Pallas kernels compile for 'gpu' and interpret on 'cpu'; backend "
        f"{backend!r} has neither. Use the XLA paths (use_flash=False, "
        f"use_fused=False) there.")
