"""Device mesh helpers.

The reference has no distributed computing at all (SURVEY.md §2.4) — its
parallelism is three OS threads and mpsc channels. Here the time axis of the
IQ stream is sharded over a 1-D `Mesh` (all cards of a host reach each
other at the same rate, so the mesh follows the stream alone), and
decoded-candidate gathers ride XLA collectives.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

TIME_AXIS = "t"


def make_mesh(n_devices: int | None = None, axis: str = TIME_AXIS) -> Mesh:
    """1-D mesh over the first `n_devices` local devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def time_sharding(mesh: Mesh, axis: str = TIME_AXIS) -> NamedSharding:
    """Shard the leading (time/block) axis, replicate the rest."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def init_distributed() -> None:
    """Multi-host initialization (jax.distributed); no-op when single-host.

    Call before any other JAX API in a multi-host launch. With no
    arguments, jax.distributed.initialize() finds the coordinator and
    process ids only where the cluster environment provides them; where
    it cannot, this is a single-process run and nothing is done.
    """
    try:
        jax.distributed.initialize()
    except (ValueError, RuntimeError):
        # Single-process: nothing to do.
        pass
