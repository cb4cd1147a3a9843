"""The accelerator a measurement runs on, named in every result.

A measurement path that finds no GPU fails: numbers from the CPU backend
are never reported under a device metric.
"""

from __future__ import annotations

import subprocess
from typing import Dict

import jax


def card_info() -> str:
    """`name, power.limit` of the first card, from nvidia-smi (a child
    process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_record() -> Dict[str, object]:
    """{"platform", "kind", "count"} as JAX reports the devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> Dict[str, object]:
    """The device record, or SystemExit when JAX found no GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {rec['platform']!r}; this "
                         f"measurement runs only on the card")
    return rec
