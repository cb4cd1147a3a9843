"""True multi-process ("multi-host") SPMD tests.

The reference is single-process (SURVEY.md §2.6); the north star demands
multi-host serving. These tests spawn REAL separate processes (2 hosts x 4
virtual CPU devices each) joined by jax.distributed — cross-process
collectives ride Gloo, the zero-egress stand-in for DCN — and verify the
sharded compressed model and the continuous-batching engine are
token-identical to the single-process paths. The identical code runs on
multi-host clusters with only platform flags changed.
"""

import pytest

from realtime_kv_cache_compression_tpu.parallel.multihost import (
    launch_local_sim)


@pytest.mark.slow  # ~85 s: spawns 2 real processes, each compiles its own
def test_two_process_spmd_and_serving_token_identity():
    out = launch_local_sim(num_processes=2, local_devices=4, arm="both")
    assert "MULTIHOST_SIM_OK" in out
    assert "token match = True" in out


@pytest.mark.slow  # ~70 s: 4 processes x 2 devices, SPMD arm only
def test_four_process_mesh():
    out = launch_local_sim(num_processes=4, local_devices=2, arm="spmd")
    assert "MULTIHOST_SIM_OK" in out
