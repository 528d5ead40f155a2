"""Describe the accelerator a run used, for every number it prints.

The card's name and power limit come from ``nvidia-smi`` in a child
process that never imports JAX (a second JAX process would try to reserve
the card's memory).  A card set below its maximum power runs slower under
load, so the limit belongs beside every time.
"""

from __future__ import annotations

import shutil
import subprocess


def nvidia_smi_line() -> str:
    """``name, power.limit`` of each visible card as nvidia-smi prints them
    (one card per line), or a note when nvidia-smi is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu() -> dict:
    """Fail unless JAX runs on a GPU; returns the devices in use as
    {"platform", "kind", "count"}."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"a GPU is required; JAX runs on {backend!r}")
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
