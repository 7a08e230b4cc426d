"""The accelerator the codec is measured on, as JAX and the driver see it.

Measurement paths (chip_smoke.py, bench.py) require a GPU and fail
without one; they never fall back to the CPU. The card's name and power
limit come from nvidia-smi in a child process that does not import JAX.
"""

from __future__ import annotations

import subprocess


def require_gpu(count: int = 1) -> list:
    """The first ``count`` JAX devices; raises unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's devices are {devs[0].platform} devices")
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devs)}")
    return devs[:count]


def describe(devs) -> dict:
    """platform, device_kind and count, as JAX reports them."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi() -> list[str]:
    """One "name, power.limit" line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
