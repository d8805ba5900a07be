"""Multi-host decode: per-host IQ ingestion, pod-wide halo scan, host-0 gather.

BASELINE config 5: time-block sharding across >=2 hosts. The sharded halo
decoder (airjax.parallel.halo) is mesh-agnostic — over a multi-host mesh
its `ppermute` halo crosses hosts with no code change. This module adds the multi-host plumbing around it:

  * init()                — jax.distributed.initialize (no-op single-host)
  * global_mesh()         — 1-D mesh over all devices of all processes
  * ingest_process_local()— each host contributes its own IQ span via
                            jax.make_array_from_process_local_data
  * decode_capture()      — run the sharded decode, then
                            process_allgather the (small) candidate
                            arrays so every host — in particular host 0 —
                            sees the full ordered hit stream

The reference is strictly single-process (SURVEY §2.4); this is the
capability it has no analogue for.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from airjax.dsp.demod import WINDOW
from airjax.parallel.halo import build_sharded_decoder
from airjax.parallel.mesh import TIME_AXIS


def init() -> tuple[int, int]:
    """Initialize jax.distributed from the environment; returns
    (process_index, process_count). Safe to call single-host."""
    try:
        jax.distributed.initialize()
    except (ValueError, RuntimeError):
        pass  # single-process or already initialized
    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = TIME_AXIS) -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def ingest_process_local(
    local_iq: np.ndarray, mesh: Mesh, axis: str = TIME_AXIS
) -> jax.Array:
    """Build the global time-sharded IQ array from per-host spans.

    Host p holds samples [p*local_len, (p+1)*local_len) of the global
    stream; local_len must divide evenly among the host's local devices.
    """
    sharding = NamedSharding(mesh, PartitionSpec(axis, None))
    return jax.make_array_from_process_local_data(sharding, local_iq)


def decode_capture(
    local_iq: np.ndarray,
    capacity_per_shard: int = 256,
    axis: str = TIME_AXIS,
    gather: str = "compact",
    compact_capacity: int | None = None,
):
    """Decode a capture whose span is distributed across hosts.

    Every process calls this with its own contiguous span (equal sizes).
    Returns (hits, stats) — identical on every host after the gather;
    hits are (0, global_offset, frame_bytes, recovered), offset-ordered.

    gather="compact" (default): the cross-shard device-side compaction
    (halo.build_sharded_decoder_compact) returns REPLICATED ~n_good-row
    arrays, so no process_allgather is needed at all — the psum inside
    the sharded program already moved the (tiny) hit rows between devices,
    and each host fetches its local replica. "dense" keeps the classic
    (D*K,) arrays + explicit allgather for A/B.
    """
    from jax.experimental import multihost_utils

    from airjax.parallel.halo import (
        _run_compact_with_regrow,
        build_sharded_decoder_compact,
    )

    mesh = global_mesh(axis)
    n_dev = mesh.shape[axis]
    local = np.ascontiguousarray(local_iq, dtype=np.int16)
    n_global = local.shape[0] * jax.process_count()
    if n_global % n_dev != 0:
        raise ValueError(
            f"global samples {n_global} not divisible by {n_dev} devices"
        )
    iq_global = ingest_process_local(local, mesh, axis)
    block = n_global // n_dev
    max_offset = n_global - WINDOW

    if gather == "compact":
        C = compact_capacity or max(128, capacity_per_shard)
        # Overflow covers per-shard candidate capacity AND the global
        # compact buffer; replicated, so every process regrows in step.
        out, scal, capacity_per_shard, C = _run_compact_with_regrow(
            lambda k, c: build_sharded_decoder_compact(
                mesh, n_global, k, c, axis
            ),
            iq_global, capacity_per_shard, C, block, n_dev, "n_good",
        )
        n_good = int(scal["n_good"])
        rows = jax.device_get(
            {
                "offsets": out["offsets"][:n_good],
                "recovered": out["recovered"][:n_good],
                "frames": out["frames"][:n_good],
            }
        )
        hits = []
        for k in range(n_good):
            off = int(rows["offsets"][k])
            if off <= max_offset:
                hits.append(
                    (
                        0,
                        off,
                        np.asarray(rows["frames"][k]).tobytes(),
                        bool(rows["recovered"][k]),
                    )
                )
        stats = {
            "n_detections": int(scal["n_detections"]),
            "n_good": n_good,
            "overflow": bool(scal["overflow"]),
            "capacity_per_shard": capacity_per_shard,
            "compact_capacity": C,
            "fetched_bytes": n_good * (4 + 4 + 14),
            "processes": jax.process_count(),
            "devices": n_dev,
        }
        return hits, stats

    step = build_sharded_decoder(mesh, n_global, capacity_per_shard, axis)
    out = step(iq_global)
    # Adaptive regrow on per-shard capacity overflow, mirroring
    # decode_capture_sharded (halo.py): without it a detection storm in
    # one shard would silently truncate the hit list. The overflow flag
    # is replicated (jnp.any over shards), so every process takes the
    # same number of regrow iterations.
    while bool(jax.device_get(out["overflow"])) and capacity_per_shard < block:
        capacity_per_shard = min(capacity_per_shard * 4, block)
        step = build_sharded_decoder(mesh, n_global, capacity_per_shard, axis)
        out = step(iq_global)

    # Candidate outputs are small (n_dev * K); gather them everywhere.
    gathered = {
        k: np.asarray(multihost_utils.process_allgather(out[k], tiled=True))
        if out[k].ndim > 0
        else np.asarray(jax.device_get(out[k]))
        for k in ("offsets", "good", "recovered", "frames")
    } if jax.process_count() > 1 else jax.device_get(out)

    hits = []
    for k in np.nonzero(np.asarray(gathered["good"]))[0]:
        off = int(gathered["offsets"][k])
        if off <= max_offset:
            hits.append(
                (
                    0,
                    off,
                    np.asarray(gathered["frames"][k]).tobytes(),
                    bool(gathered["recovered"][k]),
                )
            )
    hits.sort(key=lambda h: h[1])
    stats = {
        "n_detections": int(jax.device_get(out["n_detections"])),
        "n_good": int(jax.device_get(out["n_good"])),
        "overflow": bool(jax.device_get(out["overflow"])),
        "capacity_per_shard": capacity_per_shard,
        "processes": jax.process_count(),
        "devices": n_dev,
    }
    return hits, stats


def _gather_extended_arrays(
    local_iq: np.ndarray,
    capacity_per_shard: int,
    axis: str,
    gather: str = "compact",
    compact_capacity: int | None = None,
) -> tuple[dict, dict]:
    """Shared core of the extended multi-host decoders: run the sharded
    extended pipeline over the pod (with overflow regrow) and return the
    (gathered, stats) candidate dict every host holds identically.

    gather="compact" (default): the cross-shard compaction returns
    REPLICATED ~n_candidates-row arrays — the psum inside the sharded
    program is the gather, each host fetches its local replica, and no
    process_allgather runs at all. "dense" keeps the (D*K,) arrays +
    explicit allgather for A/B."""
    from jax.experimental import multihost_utils

    from airjax.parallel.halo import (
        _EXT_DATA_KEYS,
        _EXT_MASK_KEYS,
        EXT_COMPACT_ROW_KEYS,
        _run_compact_with_regrow,
        build_sharded_decoder_extended,
        build_sharded_decoder_extended_compact,
        unpack_extended_compact,
    )

    mesh = global_mesh(axis)
    n_dev = mesh.shape[axis]
    local = np.ascontiguousarray(local_iq, dtype=np.int16)
    n_global = local.shape[0] * jax.process_count()
    if n_global % n_dev != 0:
        raise ValueError(
            f"global samples {n_global} not divisible by {n_dev} devices"
        )
    iq_global = ingest_process_local(local, mesh, axis)
    block = n_global // n_dev

    if gather == "compact":
        C = compact_capacity or max(512, capacity_per_shard)
        out, scal, capacity_per_shard, C = _run_compact_with_regrow(
            lambda k, c: build_sharded_decoder_extended_compact(
                mesh, n_global, k, c, axis
            ),
            iq_global, capacity_per_shard, C, block, n_dev, "n_candidates",
        )
        n_cand = int(scal["n_candidates"])
        fetched = jax.device_get(
            {k: out[k][:n_cand] for k in EXT_COMPACT_ROW_KEYS}
        )
        gathered = unpack_extended_compact(fetched, n_cand)
        stats = {
            "n_detections": int(scal["n_detections"]),
            "n_good_long": int(np.sum(gathered["good_long"])),
            "n_good_df11": int(np.sum(gathered["good_df11"])),
            "overflow": bool(scal["overflow"]),
            "capacity_per_shard": capacity_per_shard,
            "compact_capacity": C,
            "n_candidates": n_cand,
            "fetched_bytes": n_cand * (4 + 1 + 4 + 4 + 4 + 14 + 14),
            "processes": jax.process_count(),
            "devices": n_dev,
        }
        return gathered, stats

    step = build_sharded_decoder_extended(
        mesh, n_global, capacity_per_shard, axis
    )
    out = step(iq_global)
    # Regrow on overflow like decode_capture_sharded_extended: the
    # extended preamble-only gate fires far more often than the DF17
    # stencil, so truncation here would drop real validated frames.
    while bool(jax.device_get(out["overflow"])) and capacity_per_shard < block:
        capacity_per_shard = min(capacity_per_shard * 4, block)
        step = build_sharded_decoder_extended(
            mesh, n_global, capacity_per_shard, axis
        )
        out = step(iq_global)

    keys = ("offsets", "frames", "frames_raw") + _EXT_MASK_KEYS + _EXT_DATA_KEYS
    gathered = {
        k: np.asarray(multihost_utils.process_allgather(out[k], tiled=True))
        for k in keys
    } if jax.process_count() > 1 else {
        k: np.asarray(jax.device_get(out[k])) for k in keys
    }
    stats = {
        "n_detections": int(jax.device_get(out["n_detections"])),
        "n_good_long": int(np.sum(gathered["good_long"])),
        "n_good_df11": int(np.sum(gathered["good_df11"])),
        "overflow": bool(jax.device_get(out["overflow"])),
        "capacity_per_shard": capacity_per_shard,
        "processes": jax.process_count(),
        "devices": n_dev,
    }
    return gathered, stats


def decode_capture_extended(
    local_iq: np.ndarray,
    capacity_per_shard: int = 2048,
    axis: str = TIME_AXIS,
    now: float = 0.0,
    cache=None,
    gather: str = "compact",
):
    """Extended-mode (every Mode S downlink format) multi-host decode.

    Same contract as decode_capture — every process contributes its own
    contiguous span, every host gathers the identical result — but the
    pod runs the extended sharded pipeline
    (airjax.parallel.halo.build_sharded_decoder_extended) and the result
    is the ordered typed packet list of airjax.extended.assemble_extended
    (the ICAO acceptance cache sees every CRC-validated frame in the
    capture before any AP-addressed candidate is gated, identical to a
    single-block decode). Returns ([(global_offset, packet)], stats).
    """
    from airjax.extended import assemble_extended
    from airjax.track.icao_cache import IcaoCache

    gathered, stats = _gather_extended_arrays(
        local_iq, capacity_per_shard, axis, gather=gather
    )
    packets = assemble_extended(
        gathered, now, cache if cache is not None else IcaoCache()
    )
    return packets, stats


def attach_candidate_fields(gathered: dict) -> dict:
    """Attach `fields` / `short_fields` to a gathered extended candidate
    dict in place, making it a valid input for the batched sink
    (airjax.track.batch.ExtendedBatchTracker.on_extended_block — same
    arrays decode_iq_block_extended_with_fields fuses on a single chip,
    airjax.pipeline:240). On a pod the per-candidate extraction is tiny
    (K frames x integer ops), so it runs AFTER the allgather on the
    replicated arrays instead of inside the sharded program."""
    from airjax.protocol.fields import extract_fields
    from airjax.protocol.shortframe import extract_short_fields_from_raw

    gathered["fields"] = jax.device_get(
        extract_fields(jnp.asarray(gathered["frames"]))
    )
    gathered["short_fields"] = jax.device_get(
        extract_short_fields_from_raw(gathered["frames_raw"])
    )
    return gathered


def decode_capture_extended_batched(
    local_iq: np.ndarray,
    tracker,
    capacity_per_shard: int = 2048,
    axis: str = TIME_AXIS,
    now: float = 0.0,
    cache=None,
    gather: str = "compact",
):
    """Multi-host extended decode driving a BATCHED tracker sink.

    Every host gathers the identical candidate arrays, attaches the
    per-candidate field arrays, and applies ONE on_extended_block to
    `tracker` (airjax.track.batch.ExtendedBatchTracker) — so every
    host's tracker replica converges to the same aircraft state without
    any packet-object stream. Returns (messages_applied, stats)."""
    from airjax.track.icao_cache import IcaoCache

    gathered, stats = _gather_extended_arrays(
        local_iq, capacity_per_shard, axis, gather=gather
    )
    attach_candidate_fields(gathered)
    applied = tracker.on_extended_block(
        gathered, now, cache if cache is not None else IcaoCache()
    )
    return applied, stats
