"""Which accelerator a measurement ran on.

Every timing this repository prints names its device: JAX's platform, device
kind and device count, and the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load).
Measurement entry points refuse to run anywhere but a GPU, so a CPU timing is
never reported as a device number.
"""

from __future__ import annotations

import shutil
import subprocess

import jax


def device_record() -> dict:
    """JAX's view of the devices: platform, kind and count."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def require_gpu() -> dict:
    """``device_record()``, or RuntimeError when JAX's first device is not a GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise RuntimeError(
            f"needs a GPU, but JAX's first device is {rec['platform']} ({rec['kind']}); "
            "device timings are only taken on the card"
        )
    return rec


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output (one line per card),
    from a child process that stays off JAX."""
    if shutil.which("nvidia-smi") is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
