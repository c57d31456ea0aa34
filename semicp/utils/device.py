"""Which device a run measures, and the refusal to measure the wrong one.

Every number a benchmark prints names the device it ran on. A
measurement that finds no GPU fails; it does not fall back to the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys


def card_info() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (read by a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(allow_cpu: bool = False) -> dict:
    """Exit non-zero unless JAX runs on a GPU. With allow_cpu, a run the
    user pointed at the CPU with JAX_PLATFORMS=cpu may go on.

    Returns {"platform", "kind", "count"} as JAX reports the devices."""
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu" and not (
            allow_cpu and os.environ.get("JAX_PLATFORMS") == "cpu"):
        hint = "; set JAX_PLATFORMS=cpu to run on the CPU" if allow_cpu else ""
        sys.exit(f"semicp: no GPU found (JAX platform {platform!r}){hint}")
    return {"platform": platform, "kind": devs[0].device_kind,
            "count": len(devs)}
