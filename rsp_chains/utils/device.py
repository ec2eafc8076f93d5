"""Accelerator checks and the persistent compile cache shared by the program's
entry points (``chip_smoke.py``, ``bench.py``, ``python -m rsp_chains.cli``).

A measurement that finds no GPU fails; it never falls back to the CPU and
reports CPU numbers under device names."""

from __future__ import annotations

import os
import pathlib
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache(checkout: os.PathLike | str = CHECKOUT) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is set here. Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache`` (listed in ``.gitignore``): the path is part of
    the cache key, so a directory that moved would never hit."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    path = str(pathlib.Path(checkout) / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """``jax.devices()`` when JAX's default backend is a GPU; raises
    ``RuntimeError`` otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX found platform "
            f"{devices[0].platform!r} ({devices[0].device_kind})")
    return devices


def card_description() -> str:
    """The cards' names and power limits as ``nvidia-smi`` reports them, one
    ``name, limit`` entry per card joined by ``; `` (a card set below its
    maximum power runs slower under load, so every number travels with it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
