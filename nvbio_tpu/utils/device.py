"""The card a measurement was taken on."""

from __future__ import annotations

import subprocess


def card_name(dev) -> str:
    """``nvidia-smi``'s name and power limit for a GPU device (a card
    set below its maximum power runs slower under load, so every rate
    printed names both); the JAX device kind for any other device."""
    if dev.platform != "gpu":
        return f"{dev.platform}:{dev.device_kind}"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
