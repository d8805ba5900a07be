"""Sharded overlap-save decode: the ring-attention analogue for this workload.

A continuous IQ stream is sharded along time across the mesh; a Mode S
window is 240 samples, so each shard needs the first 239 magnitudes of its
right neighbor to scan every offset it owns. That halo moves between devices with a
single `jax.lax.ppermute` (ring shift by one), after which every device
scans its own `B` offsets — every global offset is scanned exactly once, so
no dedupe is needed and no frame is ever lost at a shard boundary (the class
of bug the reference demonstrably has at its 20,000-sample chunk edges,
src/adsb.rs:75-89).

The last shard receives the *first* shard's head as its halo (ring
wraparound); offsets whose window would run past the true end of the capture
are masked out with the static capture length, matching the reference's scan
bound `len - 240` (src/adsb.rs:98).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from airjax.dsp.demod import WINDOW
from airjax.dsp.magnitude import magnitude_u16
from airjax.parallel.mesh import TIME_AXIS
from airjax.pipeline import decode_mags_block, decode_mags_block_extended

HALO = WINDOW - 1  # 239

# The tuned shard decomposition pads so block ≡ TUNED_RESIDUE (mod 1024):
# then a TUNED_HALO-sample exchange makes the per-shard slice
# (block + 240) exactly 1024-aligned while n_off = block stays off a
# power of two. Both decompositions scan every offset exactly once; which
# shape is faster is a per-device measurement (PERF.md).
TUNED_HALO = 240
TUNED_RESIDUE = (-TUNED_HALO) % 1024  # 784


def _halo_size(block: int) -> int:
    """Per-shard halo: 240 when the caller opted into the tuned
    decomposition (block ≡ 784 mod 1024), else the minimal 239. Both
    cover the 239 samples a window straddling the shard edge needs; the
    extra sample exists purely to tile-align the per-shard slice."""
    if block % 1024 == TUNED_RESIDUE:
        return TUNED_HALO
    return HALO


def tuned_block(per_shard: int) -> int:
    """Round a per-shard sample count UP to the tuned congruence class
    (≡ 784 mod 1024) so `build_sharded_decoder` picks the aligned shape.
    Below 4096 samples the minimal pad is kept."""
    if per_shard < 4096:
        return per_shard
    return per_shard + (TUNED_RESIDUE - per_shard) % 1024


def build_sharded_decoder(
    mesh: Mesh,
    n_samples: int,
    capacity_per_shard: int,
    axis: str = TIME_AXIS,
):
    """Build a jitted sharded decode step for captures of `n_samples`.

    The returned callable maps a ({n_samples}, 2) int16 IQ array (sharded or
    not — input sharding is constrained inside) to a dict of *global* arrays:
      offsets (D*K,) int32 global sample offsets (invalid slots = n_samples)
      good    (D*K,) bool
      recovered (D*K,) bool
      frames  (D*K, 14) uint8
      n_detections, n_good () int32 (summed over shards)

    `n_samples` must divide evenly by the mesh size (pad on host — ideally
    to `tuned_block(...) * n_dev` so the shard-local kernel runs the
    measured-fast shape).
    """
    n_dev = mesh.shape[axis]
    if n_samples % n_dev != 0:
        raise ValueError(f"n_samples {n_samples} not divisible by mesh size {n_dev}")
    block = n_samples // n_dev
    if block < HALO:
        raise ValueError(f"per-shard block {block} smaller than halo {HALO}")
    halo_n = _halo_size(block)
    max_offset = n_samples - WINDOW  # last scannable global offset
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_step(iq_local: jnp.ndarray) -> dict[str, jnp.ndarray]:
        # iq_local: (block, 2) int16 on each device
        mags = magnitude_u16(iq_local)  # (block,)
        halo = jax.lax.ppermute(mags[:halo_n], axis, perm)  # right nbr's head
        ext = jnp.concatenate([mags, halo])  # (block + halo_n,)
        res = decode_mags_block(ext, block, capacity_per_shard)
        base = jax.lax.axis_index(axis).astype(jnp.int32) * block
        global_offsets = res["offsets"] + base
        in_range = res["valid"] & (global_offsets <= max_offset)
        return {
            "offsets": jnp.where(in_range, global_offsets, n_samples),
            "good": res["good"] & in_range,
            "recovered": res["recovered"] & in_range,
            "frames": res["frames"],
            "n_detections": res["n_detections"][None],
            "n_good": jnp.sum(res["good"] & in_range, dtype=jnp.int32)[None],
            "overflow": res["overflow"][None],
        }

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=PartitionSpec(axis, None),
        out_specs={
            "offsets": PartitionSpec(axis),
            "good": PartitionSpec(axis),
            "recovered": PartitionSpec(axis),
            "frames": PartitionSpec(axis, None),
            "n_detections": PartitionSpec(axis),
            "n_good": PartitionSpec(axis),
            "overflow": PartitionSpec(axis),
        },
    )

    in_sharding = NamedSharding(mesh, PartitionSpec(axis, None))

    @jax.jit
    def step(iq: jnp.ndarray):
        iq = jax.lax.with_sharding_constraint(iq, in_sharding)
        out = sharded(iq)
        return {
            "offsets": out["offsets"],
            "good": out["good"],
            "recovered": out["recovered"],
            "frames": out["frames"],
            "n_detections": jnp.sum(out["n_detections"]),
            "n_good": jnp.sum(out["n_good"]),
            "overflow": jnp.any(out["overflow"]),
        }

    return step


def decode_capture_sharded(
    iq,
    mesh: Mesh,
    capacity_per_shard: int = 256,
    axis: str = TIME_AXIS,
    gather: str = "compact",
    compact_capacity: int | None = None,
):
    """Host convenience: pad, run the sharded decoder, collect ordered hits.

    Returns (hits, stats); hits are (0, global_offset, frame_bytes,
    recovered) tuples sorted by offset — the same schema as
    airjax.pipeline.decode_capture_overlap.

    gather="compact" (default) runs the hit-proportional cross-shard
    compaction (build_sharded_decoder_compact): the host fetch carries
    ~n_good rows instead of D*K (stats["fetched_bytes"] records it).
    gather="dense" keeps the classic (D*K,) fetch for A/B.
    """
    import numpy as np

    from airjax.pipeline import pad_iq_non_detecting

    n_dev = mesh.shape[axis]
    n = len(iq)
    # Pad so the per-shard block lands in the tuned congruence class
    # (≡ 784 mod 1024 when big enough): the shard-local decode then scans
    # an off-power offset count over a 1024-aligned slice.
    block = tuned_block(-(-n // n_dev))
    padded_len = block * n_dev
    arr = pad_iq_non_detecting(np.asarray(iq, dtype=np.int16), padded_len)
    iq_dev = jnp.asarray(arr)
    max_offset = n - WINDOW
    hits = []

    if gather == "compact":
        C = compact_capacity or max(128, capacity_per_shard)
        out, scal, capacity_per_shard, C = _run_compact_with_regrow(
            lambda k, c: build_sharded_decoder_compact(
                mesh, padded_len, k, c, axis
            ),
            iq_dev, capacity_per_shard, C, block, n_dev, "n_good",
        )
        n_good = int(scal["n_good"])
        # Hit-proportional fetch: n_good rows, not D*K.
        rows = jax.device_get(
            {
                "offsets": out["offsets"][:n_good],
                "recovered": out["recovered"][:n_good],
                "frames": out["frames"][:n_good],
            }
        )
        for k in range(n_good):
            off = int(rows["offsets"][k])
            if off <= max_offset:
                hits.append(
                    (0, off, rows["frames"][k].tobytes(), bool(rows["recovered"][k]))
                )
        stats = {
            "n_detections": int(scal["n_detections"]),
            "n_good": n_good,
            "overflow": bool(scal["overflow"]),
            "capacity_per_shard": capacity_per_shard,
            "compact_capacity": C,
            "fetched_bytes": n_good * (4 + 4 + 14),
        }
        return hits, stats

    step = build_sharded_decoder(mesh, padded_len, capacity_per_shard, axis)
    out = jax.device_get(step(iq_dev))
    # Adaptive regrow on per-shard capacity overflow — a detection storm in
    # one shard must not silently truncate hits.
    while bool(out["overflow"]) and capacity_per_shard < block:
        capacity_per_shard = min(capacity_per_shard * 4, block)
        step = build_sharded_decoder(mesh, padded_len, capacity_per_shard, axis)
        out = jax.device_get(step(iq_dev))

    for k in np.nonzero(out["good"])[0]:
        off = int(out["offsets"][k])
        if off <= max_offset:
            hits.append(
                (0, off, out["frames"][k].tobytes(), bool(out["recovered"][k]))
            )
    hits.sort(key=lambda h: h[1])
    stats = {
        "n_detections": int(out["n_detections"]),
        "n_good": int(out["n_good"]),
        "overflow": bool(out["overflow"]),
        # Final capacity: > the caller's argument iff the regrow loop fired.
        "capacity_per_shard": capacity_per_shard,
        "fetched_bytes": out["offsets"].size * (4 + 1 + 1) + out["frames"].size,
    }
    return hits, stats


# ---------------------------------------------------------------------------
# Hit-proportional candidate gather
# ---------------------------------------------------------------------------
#
# The dense sharded decoders above return (D*K,) candidate arrays: at
# K=256/2048 per shard the host fetch (and, across hosts, the host-0
# gather) carries D*K*rowbytes even when n_good ~ 20. The compact
# builders below add a cross-shard device-side compaction: per-shard
# good/candidate slots are re-compacted to the front (gather-based, no
# big scatters), per-shard counts are all-gathered to derive each
# shard's global write base (an exclusive scan over D scalars), and each
# shard contributes its rows into a REPLICATED (C,) buffer via
# dynamic_update_slice + psum — rows land offset-sorted (ascending shard
# base x ascending in-shard offset), zero rows sum transparently, and
# the collective does the gather so the host fetches ~n_good rows
# instead of D*K.


def _compact_local(mask: jnp.ndarray, capacity: int):
    """Indices of True slots in ascending order: (safe_sel, valid_out,
    count). safe_sel is clamped to 0 for invalid output slots (callers
    mask the gathered payload with valid_out)."""
    from airjax.dsp.demod import compact_detections

    sel, valid_out, count = compact_detections(mask, capacity)
    return jnp.where(valid_out, sel, 0), valid_out, count.astype(jnp.int32)


def _scatter_to_global(
    values: jnp.ndarray,
    valid_out: jnp.ndarray,
    base: jnp.ndarray,
    compact_capacity: int,
    axis: str,
) -> jnp.ndarray:
    """Contribute this shard's compacted-to-front rows at [base,
    base+count) of a replicated (compact_capacity, ...) buffer.

    Invalid rows are zeroed so overlapping pad regions sum transparently
    under psum; the buffer is oversized by K rows so a full shard never
    writes past the end (XLA clamps dynamic_update_slice starts — a
    clamped write can only corrupt rows when total > C, which the
    overflow flag already forces the caller to discard)."""
    k = values.shape[0]
    v = jnp.where(
        valid_out.reshape((k,) + (1,) * (values.ndim - 1)), values, 0
    ).astype(jnp.int32)
    buf = jnp.zeros((compact_capacity + k,) + values.shape[1:], jnp.int32)
    buf = jax.lax.dynamic_update_slice(
        buf, v, (base,) + (0,) * (values.ndim - 1)
    )
    return jax.lax.psum(buf, axis)[:compact_capacity]


# Per-candidate payload columns of the extended compact output — the
# one list the host wrappers (here), the multihost gather, and the
# sharded stream runner all fetch; keep it single-sourced.
EXT_COMPACT_ROW_KEYS = (
    "offsets", "classmask", "df", "icao_ap_short", "icao_ap_long",
    "frames", "frames_raw",
)


def _run_compact_with_regrow(
    make_step, iq_dev, K: int, C: int, block: int, n_dev: int, count_key: str
):
    """Run a compact sharded step, regrowing the per-shard candidate
    capacity AND the global compact capacity on overflow (either flag
    forces a rerun; the shared loop of every compact host wrapper).
    Returns (out, scal, K, C)."""
    keys = (count_key, "n_detections", "overflow")
    out = make_step(K, C)(iq_dev)
    scal = jax.device_get({k: out[k] for k in keys})
    while bool(scal["overflow"]) and (K < block or C < n_dev * block):
        K = min(K * 4, block)
        C = min(C * 4, n_dev * block)
        out = make_step(K, C)(iq_dev)
        scal = jax.device_get({k: out[k] for k in keys})
    return out, scal, K, C


def _global_base(count: jnp.ndarray, n_dev: int, axis: str):
    """(base, total): this shard's exclusive-prefix write position and
    the mesh-wide row count, from one (D,)-scalar all_gather."""
    counts = jax.lax.all_gather(count, axis)  # (D,)
    my = jax.lax.axis_index(axis)
    base = jnp.sum(
        jnp.where(jnp.arange(n_dev) < my, counts, 0), dtype=jnp.int32
    )
    # total via psum (not a sum over the gathered vector): psum's result
    # is provably replicated, which shard_map's out_specs=P() check needs.
    return base, jax.lax.psum(count, axis)


def build_sharded_decoder_compact(
    mesh: Mesh,
    n_samples: int,
    capacity_per_shard: int,
    compact_capacity: int,
    axis: str = TIME_AXIS,
    with_fields: bool = False,
    recover2: bool = False,
):
    """Sharded DF17 decode with hit-proportional output.

    Same scan as build_sharded_decoder, but the result is a REPLICATED
    compact dict sized by `compact_capacity` (global, across all
    shards) instead of dense (D*K,) arrays:

      offsets   (C,) int32  global sample offsets, offset-sorted; rows
                            >= n_good are zero
      recovered (C,) bool
      frames    (C, 14) uint8
      n_good, n_detections () int32
      overflow  () bool — per-shard candidate overflow OR n_good > C;
                          callers must regrow and rerun on it.
    """
    n_dev = mesh.shape[axis]
    if n_samples % n_dev != 0:
        raise ValueError(f"n_samples {n_samples} not divisible by mesh size {n_dev}")
    block = n_samples // n_dev
    if block < HALO:
        raise ValueError(f"per-shard block {block} smaller than halo {HALO}")
    halo_n = _halo_size(block)
    max_offset = n_samples - WINDOW
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    K, C = capacity_per_shard, compact_capacity

    def local_step(iq_local: jnp.ndarray) -> dict[str, jnp.ndarray]:
        mags = magnitude_u16(iq_local)
        halo = jax.lax.ppermute(mags[:halo_n], axis, perm)
        ext = jnp.concatenate([mags, halo])
        res = decode_mags_block(ext, block, K, recover2=recover2)
        shard_base = jax.lax.axis_index(axis).astype(jnp.int32) * block
        global_offsets = res["offsets"] + shard_base
        mask = res["good"] & res["valid"] & (global_offsets <= max_offset)
        sel, valid_out, count = _compact_local(mask, K)
        base, total = _global_base(count, n_dev, axis)
        out = {
            "offsets": _scatter_to_global(
                global_offsets[sel], valid_out, base, C, axis
            ),
            "recovered": _scatter_to_global(
                res["recovered"][sel].astype(jnp.int32), valid_out, base, C, axis
            ).astype(bool),
            "frames": _scatter_to_global(
                res["frames"][sel].astype(jnp.int32), valid_out, base, C, axis
            ).astype(jnp.uint8),
            "n_good": total,
            "n_detections": jax.lax.psum(res["n_detections"], axis),
            "overflow": jax.lax.psum(res["overflow"].astype(jnp.int32), axis)
            > 0,
        }
        if recover2:
            out["recovered2"] = _scatter_to_global(
                res["recovered2"][sel].astype(jnp.int32),
                valid_out, base, C, axis,
            ).astype(bool)
        return out

    out_keys = [
        "offsets", "recovered", "frames", "n_good", "n_detections", "overflow",
    ] + (["recovered2"] if recover2 else [])
    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=PartitionSpec(axis, None),
        out_specs={k: PartitionSpec() for k in out_keys},
    )
    in_sharding = NamedSharding(mesh, PartitionSpec(axis, None))

    @jax.jit
    def step(iq: jnp.ndarray):
        iq = jax.lax.with_sharding_constraint(iq, in_sharding)
        out = sharded(iq)
        out["overflow"] = out["overflow"] | (out["n_good"] > C)
        if with_fields:
            # Batched-sink support: protocol fields extracted on the
            # (tiny) replicated compact buffer inside the same program —
            # no extra host->device round trip per stream step.
            from airjax.protocol.fields import extract_fields

            out["fields"] = extract_fields(out["frames"])
        return out

    return step


# ---------------------------------------------------------------------------
# Extended mode (every Mode S downlink format), sharded
# ---------------------------------------------------------------------------

# Boolean per-candidate classes produced by decode_mags_block_extended that
# must be masked to the shard's owned offset range.
_EXT_MASK_KEYS = (
    "good_long",
    "recovered",
    "good_df11",
    "cand_df11_ic",
    "cand_short_ap",
    "cand_long_ap",
)
# Per-candidate payloads carried through unmasked (consumers index them only
# at positions one of the masks selects).
_EXT_DATA_KEYS = ("df", "icao_ap_short", "icao_ap_long")
_EXT_FRAME_KEYS = ("frames", "frames_raw")


def build_sharded_decoder_extended(
    mesh: Mesh,
    n_samples: int,
    capacity_per_shard: int,
    axis: str = TIME_AXIS,
):
    """Sharded decode of EVERY Mode S downlink format (DF0/4/5/11/16/17+,
    20/21) — the extended pipeline (airjax.pipeline.decode_mags_block_extended,
    preamble-only stencil + dual long/short CRC) under the same
    overlap-save ppermute halo as the DF17 decoder. The detector gate being
    generalized is the reference's at src/adsb/demod.rs:38-54.

    Returns a jitted step mapping ({n_samples}, 2) int16 IQ to the global
    candidate dict `airjax.extended.assemble_extended` consumes (offsets
    globalized; every validity class masked to owned, in-capture offsets).
    """
    n_dev = mesh.shape[axis]
    if n_samples % n_dev != 0:
        raise ValueError(f"n_samples {n_samples} not divisible by mesh size {n_dev}")
    block = n_samples // n_dev
    if block < HALO:
        raise ValueError(f"per-shard block {block} smaller than halo {HALO}")
    halo_n = _halo_size(block)
    max_offset = n_samples - WINDOW
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_step(iq_local: jnp.ndarray) -> dict[str, jnp.ndarray]:
        mags = magnitude_u16(iq_local)
        halo = jax.lax.ppermute(mags[:halo_n], axis, perm)
        ext = jnp.concatenate([mags, halo])
        res = decode_mags_block_extended(ext, block, capacity_per_shard)
        base = jax.lax.axis_index(axis).astype(jnp.int32) * block
        global_offsets = res["offsets"] + base
        in_range = res["valid"] & (global_offsets <= max_offset)
        out = {
            "offsets": jnp.where(in_range, global_offsets, n_samples),
            "n_detections": res["n_detections"][None],
            "overflow": res["overflow"][None],
        }
        for k in _EXT_MASK_KEYS:
            out[k] = res[k] & in_range
        for k in _EXT_DATA_KEYS + _EXT_FRAME_KEYS:
            out[k] = res[k]
        return out

    specs = {
        "offsets": PartitionSpec(axis),
        "n_detections": PartitionSpec(axis),
        "overflow": PartitionSpec(axis),
        **{k: PartitionSpec(axis) for k in _EXT_MASK_KEYS},
        **{k: PartitionSpec(axis) for k in _EXT_DATA_KEYS},
        **{k: PartitionSpec(axis, None) for k in _EXT_FRAME_KEYS},
    }
    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=PartitionSpec(axis, None),
        out_specs=specs,
    )
    in_sharding = NamedSharding(mesh, PartitionSpec(axis, None))

    @jax.jit
    def step(iq: jnp.ndarray):
        iq = jax.lax.with_sharding_constraint(iq, in_sharding)
        out = sharded(iq)
        out["n_detections"] = jnp.sum(out["n_detections"])
        out["overflow"] = jnp.any(out["overflow"])
        return out

    return step


def build_sharded_decoder_extended_compact(
    mesh: Mesh,
    n_samples: int,
    capacity_per_shard: int,
    compact_capacity: int,
    axis: str = TIME_AXIS,
    with_fields: bool = False,
    recover2: bool = False,
):
    """Extended sharded decode with hit-proportional output.

    Candidate rows (union of every validity class in _EXT_MASK_KEYS) are
    compacted across shards into a replicated (C,) buffer; the six class
    booleans ride as one packed uint8 `classmask` (bit i =
    _EXT_MASK_KEYS[i]) that `unpack_extended_compact` re-expands into
    the dict airjax.extended.assemble_extended consumes. Output:

      offsets (C,) int32 · classmask (C,) uint8 · df (C,) int32 ·
      icao_ap_short/long (C,) int32 · frames/frames_raw (C, 14) uint8 ·
      n_candidates, n_detections () int32 · overflow () bool
    """
    n_dev = mesh.shape[axis]
    if n_samples % n_dev != 0:
        raise ValueError(f"n_samples {n_samples} not divisible by mesh size {n_dev}")
    block = n_samples // n_dev
    if block < HALO:
        raise ValueError(f"per-shard block {block} smaller than halo {HALO}")
    halo_n = _halo_size(block)
    max_offset = n_samples - WINDOW
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    K, C = capacity_per_shard, compact_capacity

    def local_step(iq_local: jnp.ndarray) -> dict[str, jnp.ndarray]:
        mags = magnitude_u16(iq_local)
        halo = jax.lax.ppermute(mags[:halo_n], axis, perm)
        ext = jnp.concatenate([mags, halo])
        res = decode_mags_block_extended(ext, block, K, recover2=recover2)
        shard_base = jax.lax.axis_index(axis).astype(jnp.int32) * block
        global_offsets = res["offsets"] + shard_base
        in_range = res["valid"] & (global_offsets <= max_offset)
        classes = [res[k] & in_range for k in _EXT_MASK_KEYS]
        classmask = jnp.zeros(K, jnp.int32)
        union = jnp.zeros(K, bool)
        for i, cls in enumerate(classes):
            classmask = classmask | (cls.astype(jnp.int32) << i)
            union = union | cls
        sel, valid_out, count = _compact_local(union, K)
        base, total = _global_base(count, n_dev, axis)

        def scat(v):
            return _scatter_to_global(v, valid_out, base, C, axis)

        out = {
            "offsets": scat(global_offsets[sel]),
            "classmask": scat(classmask[sel]).astype(jnp.uint8),
            "df": scat(res["df"][sel].astype(jnp.int32)),
            "icao_ap_short": scat(res["icao_ap_short"][sel].astype(jnp.int32)),
            "icao_ap_long": scat(res["icao_ap_long"][sel].astype(jnp.int32)),
            "frames": scat(res["frames"][sel].astype(jnp.int32)).astype(
                jnp.uint8
            ),
            "frames_raw": scat(
                res["frames_raw"][sel].astype(jnp.int32)
            ).astype(jnp.uint8),
            "n_candidates": total,
            "n_detections": jax.lax.psum(res["n_detections"], axis),
            "overflow": jax.lax.psum(res["overflow"].astype(jnp.int32), axis)
            > 0,
        }
        if recover2:
            out["recovered2"] = scat(
                (res["recovered2"] & in_range)[sel].astype(jnp.int32)
            ).astype(bool)
        return out

    out_keys = [
        "offsets", "classmask", "df", "icao_ap_short", "icao_ap_long",
        "frames", "frames_raw", "n_candidates", "n_detections", "overflow",
    ] + (["recovered2"] if recover2 else [])
    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=PartitionSpec(axis, None),
        out_specs={k: PartitionSpec() for k in out_keys},
    )
    in_sharding = NamedSharding(mesh, PartitionSpec(axis, None))

    @jax.jit
    def step(iq: jnp.ndarray):
        iq = jax.lax.with_sharding_constraint(iq, in_sharding)
        out = sharded(iq)
        out["overflow"] = out["overflow"] | (out["n_candidates"] > C)
        if with_fields:
            # Batched-sink support (see build_sharded_decoder_compact).
            from airjax.protocol.fields import extract_fields
            from airjax.protocol.shortframe import extract_short_fields_from_raw

            out["fields"] = extract_fields(out["frames"])
            out["short_fields"] = extract_short_fields_from_raw(
                out["frames_raw"]
            )
        return out

    return step


def unpack_extended_compact(out: dict, n: int | None = None) -> dict:
    """Expand a fetched compact extended dict (numpy) into the schema
    airjax.extended.assemble_extended consumes: per-class boolean arrays
    from the packed classmask, arrays sliced to the candidate count."""
    import numpy as np

    n = int(out["n_candidates"]) if n is None else n
    cm = np.asarray(out["classmask"][:n])
    unpacked = {
        "offsets": np.asarray(out["offsets"][:n]),
        "df": np.asarray(out["df"][:n]),
        "icao_ap_short": np.asarray(out["icao_ap_short"][:n]),
        "icao_ap_long": np.asarray(out["icao_ap_long"][:n]),
        "frames": np.asarray(out["frames"][:n]),
        "frames_raw": np.asarray(out["frames_raw"][:n]),
    }
    for i, k in enumerate(_EXT_MASK_KEYS):
        unpacked[k] = (cm >> i) & 1 > 0
    if "recovered2" in out:  # opt-in 2-bit-repair column (recover2 mode)
        unpacked["recovered2"] = np.asarray(out["recovered2"][:n])
    return unpacked


def decode_capture_sharded_extended(
    iq,
    mesh: Mesh,
    capacity_per_shard: int = 2048,
    axis: str = TIME_AXIS,
    now: float = 0.0,
    cache=None,
    gather: str = "compact",
    compact_capacity: int | None = None,
):
    """Host convenience: sharded extended decode -> ordered typed packets.

    Returns ([(global_offset, packet)], stats) via
    airjax.extended.assemble_extended — identical semantics to decoding the
    whole capture as ONE extended block (the ICAO acceptance cache sees all
    CRC-validated frames before any AP-addressed candidate is gated).

    gather="compact" (default) fetches only candidate rows via the
    cross-shard compaction (build_sharded_decoder_extended_compact);
    "dense" keeps the (D*K,) fetch for A/B.
    """
    import numpy as np

    from airjax.extended import assemble_extended
    from airjax.pipeline import pad_iq_non_detecting
    from airjax.track.icao_cache import IcaoCache

    n_dev = mesh.shape[axis]
    n = len(iq)
    block = tuned_block(-(-n // n_dev))
    padded_len = block * n_dev
    arr = pad_iq_non_detecting(np.asarray(iq, dtype=np.int16), padded_len)
    iq_dev = jnp.asarray(arr)
    max_offset = n - WINDOW

    if gather == "compact":
        C = compact_capacity or max(512, capacity_per_shard)
        out, scal, capacity_per_shard, C = _run_compact_with_regrow(
            lambda k, c: build_sharded_decoder_extended_compact(
                mesh, padded_len, k, c, axis
            ),
            iq_dev, capacity_per_shard, C, block, n_dev, "n_candidates",
        )
        n_cand = int(scal["n_candidates"])
        fetched = jax.device_get(
            {k: out[k][:n_cand] for k in EXT_COMPACT_ROW_KEYS}
        )
        unpacked = unpack_extended_compact(fetched, n_cand)
        # Bound offsets by the true capture (windows past len(iq) were
        # never real — the device mask only knew the padded length).
        in_cap = unpacked["offsets"] <= max_offset
        for k in _EXT_MASK_KEYS:
            unpacked[k] = unpacked[k] & in_cap
        packets = assemble_extended(
            unpacked, now, cache if cache is not None else IcaoCache()
        )
        stats = {
            "n_detections": int(scal["n_detections"]),
            "n_good_long": int(np.sum(unpacked["good_long"])),
            "n_good_df11": int(np.sum(unpacked["good_df11"])),
            "overflow": bool(scal["overflow"]),
            "capacity_per_shard": capacity_per_shard,
            "compact_capacity": C,
            "n_candidates": n_cand,
            "fetched_bytes": n_cand * (4 + 1 + 4 + 4 + 4 + 14 + 14),
        }
        return packets, stats

    step = build_sharded_decoder_extended(mesh, padded_len, capacity_per_shard, axis)
    out = jax.device_get(step(iq_dev))
    while bool(out["overflow"]) and capacity_per_shard < block:
        capacity_per_shard = min(capacity_per_shard * 4, block)
        step = build_sharded_decoder_extended(
            mesh, padded_len, capacity_per_shard, axis
        )
        out = jax.device_get(step(iq_dev))

    # The padded-capture mask already bounded offsets by padded_len; bound
    # them by the true capture here (windows past len(iq) were never real).
    in_cap = np.asarray(out["offsets"]) <= max_offset
    for k in _EXT_MASK_KEYS:
        out[k] = np.asarray(out[k]) & in_cap

    packets = assemble_extended(out, now, cache if cache is not None else IcaoCache())
    stats = {
        "n_detections": int(out["n_detections"]),
        "n_good_long": int(np.sum(out["good_long"])),
        "n_good_df11": int(np.sum(out["good_df11"])),
        "overflow": bool(out["overflow"]),
        "capacity_per_shard": capacity_per_shard,
    }
    return packets, stats
