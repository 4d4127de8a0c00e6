"""Which device a measurement ran on.

Every timing this repository prints names its device; a measurement path
that finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """The default backend's platform, device kind and device count; raises
    unless the default backend is the GPU."""
    import jax

    devices = jax.devices()
    if jax.default_backend() != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is "
                           f"{jax.default_backend()!r} ({devices})")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each: a card set below its power limit runs slower under load, so every
    number kept is written beside it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
