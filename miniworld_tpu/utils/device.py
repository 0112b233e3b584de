"""Accelerator checks for the scripts that measure on the GPU."""

from __future__ import annotations

import subprocess

import jax


def require_gpu():
    """The first JAX device, or RuntimeError when it is not a GPU.

    Measurements name the device they ran on and never fall back to the
    CPU: a CPU number is no evidence about the card.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this script measures the card only"
        )
    return dev


def card_name_power() -> str:
    """'<name>, <power limit>' of each card, as nvidia-smi reports them
    (the clocks of a card set below its maximum power drop under load,
    so every rate is printed beside this line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
