"""The device a measurement ran on, as every reported number names it."""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports its devices."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them (a card set
    below its maximum power runs slower under load, so this goes beside
    every number)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def require_gpu() -> dict:
    """Exit (non-zero, with the reason) unless JAX's default device is a
    GPU: a measurement path never falls back to the CPU. Returns
    device_info()."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {info['platform']} "
            f"({info['kind']}); this measurement runs only on the GPU")
    return info
