"""The device a measurement runs on, for scripts that must not run
anywhere but on NVIDIA GPUs (chip_smoke.py, bench.py, bench/)."""

from __future__ import annotations

import subprocess


def nvidia_smi() -> str:
    """``name, power.limit`` of the cards as nvidia-smi prints them;
    raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(count: int = 1):
    """JAX's devices as (platform, device_kind, count); raises unless
    they are GPUs and at least ``count`` of them."""
    import jax

    devs = jax.devices()
    info = (devs[0].platform, devs[0].device_kind, len(devs))
    if info[0] != "gpu":
        raise RuntimeError(f"needs a GPU; JAX found {info}")
    if len(devs) < count:
        raise RuntimeError(f"needs {count} GPUs; JAX found {len(devs)}")
    return info
