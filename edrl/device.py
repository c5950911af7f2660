"""Where the program runs: the GPU guard, the card's identity and the
persistent compile cache."""

from __future__ import annotations

import os
import subprocess

import jax

# Fixed, inside the checkout (listed in .gitignore): the cache path is part
# of the cache key, so a directory that moves never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Keep compiled programs across processes; returns the directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone; otherwise the cache goes to ``CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu() -> list:
    """``jax.devices()`` when they are CUDA devices; raises otherwise."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU, but JAX found {devices[0].platform}: {devices}"
        )
    return devices


def card_info() -> str:
    """``name, power.limit`` of each card, one line per card, from
    ``nvidia-smi`` (a child process that does not open the card with JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()
