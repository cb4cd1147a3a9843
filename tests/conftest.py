"""Test harness: force an 8-device virtual CPU mesh before JAX imports.

This is how JAX codebases test multi-device sharding without hardware
(SURVEY.md §4): XLA_FLAGS=--xla_force_host_platform_device_count=8 with the
CPU backend. All unit tests run CPU-only on synthetic tensors, mirroring the
reference's test strategy (/root/reference/tests/, SURVEY.md §4) — no model
downloads, sub-second suites.

The card-only tests (marker `gpu`, run with `pytest -m gpu` on a machine
with an NVIDIA GPU) keep the default platform instead; elsewhere they skip.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    # Runs before any test module touches a JAX backend. `-m gpu` selects
    # the card-only tests, which need the default (GPU) platform; every
    # other run is pinned to the CPU.
    if config.getoption("markexpr") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (compiled kernels, cuDNN)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: compiled Triton/cuDNN paths have "
                    "no CPU form; run `pytest -m gpu` on the card")
