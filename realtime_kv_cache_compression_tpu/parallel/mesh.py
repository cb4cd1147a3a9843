"""Device-mesh helpers for GSPMD sharding.

No reference counterpart (the reference is single-process single-GPU,
SURVEY.md §2.6) — this is the north-star-mandated scale-out layer. Axes:
  data  — batch/data parallelism (continuous batching shards requests here)
  model — tensor parallelism over attention heads / MLP hidden / vocab
XLA inserts the collectives from the sharding annotations (NCCL on GPUs);
the cards of one host are joined all to all, so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(data: Optional[int] = None, model: Optional[int] = None,
                devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    Defaults: all devices on the model axis if `model` divides the device
    count and `data` is unset; otherwise the largest model factor that
    divides the kv-head count should be chosen by the caller.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None and model is None:
        model = n
        data = 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def single_device_mesh() -> Mesh:
    return create_mesh(1, 1, devices=jax.devices()[:1])


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
