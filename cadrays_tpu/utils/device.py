"""The accelerator a measurement runs on.

Every timed result names its device. A measurement that finds no GPU
stops instead of timing the CPU.
"""
from __future__ import annotations

import subprocess


def describe() -> dict:
    """JAX's view of the devices: platform, device kind and count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """`describe()`, or SystemExit(1) when JAX's first device is no GPU."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is on platform "
                         f"{dev['platform']!r}")
    return dev


def nvidia_smi_name_power() -> str:
    """The cards' names and power limits, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
