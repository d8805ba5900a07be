"""Channel-parallel decode: N independent receivers sharded across chips.

BASELINE config 4: "8 simulated receivers sharded across chips". Each
channel is an independent IQ stream (one antenna/SDR); the channel axis is
pure data parallelism over the mesh — no halo needed between channels,
each device decodes its local channels sequentially with `lax.map`
(whether vmap would be faster on the card is not measured yet).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from airjax.dsp.demod import WINDOW
from airjax.dsp.magnitude import magnitude_u16
from airjax.pipeline import decode_mags_block

CHANNEL_AXIS = "c"


def build_channel_decoder(
    mesh: Mesh,
    n_channels: int,
    block_len: int,
    capacity: int,
    axis: str = CHANNEL_AXIS,
):
    """Jitted decoder for (n_channels, block_len + 239, 2) int16 batches.

    Channels are sharded over the mesh axis; outputs are per-channel
    candidate dicts with a leading channel axis (global offsets are
    channel-local sample offsets).
    """
    n_dev = mesh.shape[axis]
    if n_channels % n_dev != 0:
        raise ValueError(f"{n_channels} channels not divisible by {n_dev} devices")

    def local_step(iq_local: jnp.ndarray):
        # iq_local: (n_channels/n_dev, block_len + halo, 2)
        def one(iq):
            return decode_mags_block(magnitude_u16(iq), block_len, capacity)

        return jax.lax.map(one, iq_local)  # sequential over local channels

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=PartitionSpec(axis, None, None),
        out_specs={
            "offsets": PartitionSpec(axis, None),
            "valid": PartitionSpec(axis, None),
            "good": PartitionSpec(axis, None),
            "recovered": PartitionSpec(axis, None),
            "frames": PartitionSpec(axis, None, None),
            "n_detections": PartitionSpec(axis),
            "n_good": PartitionSpec(axis),
            "overflow": PartitionSpec(axis),
        },
    )

    in_sharding = NamedSharding(mesh, PartitionSpec(axis, None, None))

    @jax.jit
    def step(iq: jnp.ndarray):
        iq = jax.lax.with_sharding_constraint(iq, in_sharding)
        return sharded(iq)

    return step


def decode_channels(
    iq_channels,
    mesh: Mesh,
    capacity: int = 1024,
    axis: str = CHANNEL_AXIS,
):
    """Host convenience: decode a (C, L, 2) multi-channel capture.

    Pads each channel with a zero halo; returns a list (one per channel)
    of (0, offset, frame_bytes, recovered) hit tuples in offset order.
    """
    import numpy as np

    arr = np.asarray(iq_channels, dtype=np.int16)
    c, n, _ = arr.shape
    halo = WINDOW - 1
    block_len = n - halo if n > halo else 0
    if block_len <= 0:
        return [[] for _ in range(c)]
    iq_dev = jnp.asarray(arr)
    step = build_channel_decoder(mesh, c, block_len, capacity, axis)
    out = jax.device_get(step(iq_dev))
    # Adaptive regrow: a per-channel detection storm must not silently
    # truncate that channel's hits.
    while bool(np.any(out["overflow"])) and capacity < block_len:
        capacity = min(capacity * 4, block_len)
        step = build_channel_decoder(mesh, c, block_len, capacity, axis)
        out = jax.device_get(step(iq_dev))

    max_offset = n - WINDOW
    results = []
    for ch in range(c):
        hits = []
        for k in np.nonzero(out["good"][ch])[0]:
            off = int(out["offsets"][ch][k])
            if off <= max_offset:
                hits.append(
                    (0, off, out["frames"][ch][k].tobytes(), bool(out["recovered"][ch][k]))
                )
        results.append(hits)
    return results


def build_channel_decoder_extended(
    mesh: Mesh,
    n_channels: int,
    block_len: int,
    capacity: int,
    axis: str = CHANNEL_AXIS,
):
    """Extended-mode (every Mode S downlink format) channel decoder:
    channels sharded over the mesh, each decoded by
    airjax.pipeline.decode_mags_block_extended with a leading channel axis."""
    from airjax.pipeline import decode_mags_block_extended

    n_dev = mesh.shape[axis]
    if n_channels % n_dev != 0:
        raise ValueError(f"{n_channels} channels not divisible by {n_dev} devices")

    def local_step(iq_local: jnp.ndarray):
        def one(iq):
            return decode_mags_block_extended(magnitude_u16(iq), block_len, capacity)

        return jax.lax.map(one, iq_local)

    # Probe the output tree once (abstractly) so the specs list never
    # drifts from decode_mags_block_extended's schema.
    probe = jax.eval_shape(
        local_step,
        jax.ShapeDtypeStruct((n_channels // n_dev, block_len + WINDOW - 1, 2), jnp.int16),
    )
    specs = {
        k: PartitionSpec(axis, *([None] * (v.ndim - 1))) for k, v in probe.items()
    }

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=PartitionSpec(axis, None, None),
        out_specs=specs,
    )
    in_sharding = NamedSharding(mesh, PartitionSpec(axis, None, None))

    @jax.jit
    def step(iq: jnp.ndarray):
        iq = jax.lax.with_sharding_constraint(iq, in_sharding)
        return sharded(iq)

    return step


def decode_channels_extended(
    iq_channels,
    mesh: Mesh,
    capacity: int = 2048,
    axis: str = CHANNEL_AXIS,
    now: float = 0.0,
):
    """Decode a (C, L, 2) multi-channel capture in extended mode.

    Returns a list (one per channel) of [(offset, packet)] via
    airjax.extended.assemble_extended — each channel gets its own ICAO
    acceptance cache (independent receivers)."""
    import numpy as np

    from airjax.extended import assemble_extended
    from airjax.track.icao_cache import IcaoCache

    arr = np.asarray(iq_channels, dtype=np.int16)
    c, n, _ = arr.shape
    halo = WINDOW - 1
    block_len = n - halo if n > halo else 0
    if block_len <= 0:
        return [[] for _ in range(c)]
    iq_dev = jnp.asarray(arr)
    step = build_channel_decoder_extended(mesh, c, block_len, capacity, axis)
    out = jax.device_get(step(iq_dev))
    while bool(np.any(out["overflow"])) and capacity < block_len:
        capacity = min(capacity * 4, block_len)
        step = build_channel_decoder_extended(mesh, c, block_len, capacity, axis)
        out = jax.device_get(step(iq_dev))

    results = []
    for ch in range(c):
        per = {k: np.asarray(v[ch]) for k, v in out.items()}
        results.append(assemble_extended(per, now, IcaoCache()))
    return results
