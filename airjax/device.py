"""Which device the program runs on, and where its compile cache lives.

Every entry point (``airjax.cli.main``, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``) calls ``setup_compile_cache`` before its first
compile, and reports ``describe()`` beside anything it measures.
"""

from __future__ import annotations

import os
import pathlib

import jax

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
# Fixed, inside the checkout: the cache path is part of what JAX keys a
# hit on, so a directory that moved between runs would never hit.
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"
# Host-side profiler traces (adsb --trace, bench.py --trace) default here.
TRACE_DIR = REPO_ROOT / "traces"


def setup_compile_cache() -> str:
    """Enable JAX's persistent compile cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here. Otherwise the cache goes to ``<repo>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def describe() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
