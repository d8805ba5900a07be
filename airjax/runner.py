"""Streaming runner: block source -> jitted device decode -> packet sink.

This is the device-side replacement for the reference's thread-2 scalar scan
loop (src/adsb.rs:92-122): blocks arrive from a bounded prefetcher, each is
decoded by one jitted program, and validated frames surface as
`AdsbPacket`s in stream order.

Two stream modes:
  * parity  — each chunk scanned independently over offsets
              [0, len-240) exactly like the reference; frames straddling
              chunk edges are lost (reference behavior).
  * overlap — a 239-sample carry from the previous chunk is prepended, so
              consecutive chunks form a seamless scan (overlap-save in
              time): no frame is ever lost at a chunk boundary and every
              global offset is scanned exactly once.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import jax
import numpy as np

from airjax.config import DEFAULT_CONFIG, PipelineConfig
from airjax.dsp.demod import WINDOW
from airjax.io.source import Prefetcher
from airjax.protocol.packet import AdsbPacket

# Overlap-mode blocks at least this long use the shape-tuned scan
# (1024-aligned slice, n_off ≡ 784 mod 1024). Below it the minimal classic
# decomposition (n_off = len - 239) is kept. Both give the same hit
# stream; PERF.md records what each shape costs on the card.
TUNED_STREAM_MIN = 1 << 16


class StreamStats:
    def __init__(self):
        from airjax.observability import StageTimer

        self.blocks = 0
        self.samples = 0
        self.detections = 0
        self.good = 0
        self.recovered = 0
        self.recovered2 = 0  # opt-in 2-bit repairs accepted (--recover2)
        self.overflow_blocks = 0
        self.started = time.time()
        # Host-side per-stage wall-clock accounting (always on — a few
        # perf_counter calls per BLOCK): dispatch (block prep + jitted
        # decode dispatch), fetch (device result transfer + overflow
        # regrow), apply (packet assembly + sink). The reference's only
        # analogue is two commented-out counters (src/adsb.rs:93-94,120).
        self.stages = StageTimer()

    def as_dict(self) -> dict:
        dt = max(time.time() - self.started, 1e-9)
        return {
            "blocks": self.blocks,
            "samples": self.samples,
            "detections": self.detections,
            "good": self.good,
            "recovered": self.recovered,
            "recovered2": self.recovered2,
            "overflow_blocks": self.overflow_blocks,
            "msamples_per_s": round(self.samples / dt / 1e6, 3),
            "stages": self.stages.as_dict(),
        }


def _gate_recover2_batch(
    idx: np.ndarray, icaos: np.ndarray, rec2: np.ndarray, seen: set
) -> tuple[np.ndarray, int]:
    """Vectorized recover2 acceptance over one block's validated rows.

    `idx` selects the block's CRC-validated slots in ascending offset
    order; `icaos`/`rec2` are the per-slot arrays. Reproduces the
    per-packet gate exactly: a 2-flip repair is kept iff its ICAO was
    seen in a clean/1-flip row earlier in the STREAM (the `seen` set,
    mutated here) or earlier in THIS block. Returns (kept_idx,
    n_accepted_repairs).
    """
    if len(idx) == 0:
        return idx, 0
    ic = np.asarray(icaos)[idx].astype(np.int64)
    r2 = np.asarray(rec2)[idx].astype(bool)
    clean_pos = np.nonzero(~r2)[0]
    earlier_clean = np.zeros(len(ic), bool)
    if len(clean_pos):
        u, first = np.unique(ic[clean_pos], return_index=True)
        first_pos = clean_pos[first]
        j = np.minimum(np.searchsorted(u, ic), len(u) - 1)
        earlier_clean = (u[j] == ic) & (first_pos[j] < np.arange(len(ic)))
    if seen:
        in_seen = np.isin(ic, np.fromiter(seen, np.int64, len(seen)))
    else:
        in_seen = np.zeros(len(ic), bool)
    keep = ~r2 | in_seen | earlier_clean
    if len(clean_pos):
        seen.update(np.unique(ic[clean_pos]).tolist())
    return idx[keep], int(np.sum(r2 & keep))


def run_stream(
    source: Iterator[np.ndarray],
    on_packet: Callable[[AdsbPacket], None],
    cfg: PipelineConfig = DEFAULT_CONFIG,
    overlap: bool = True,
    prefetch_depth: int = 4,
    stats: StreamStats | None = None,
    plot_dir: str | None = None,
    extended: bool = False,
    pipeline_depth: int = 1,
    dump_preamble: bool = False,
    recover2: bool = False,
) -> StreamStats:
    """Consume a block source until exhausted; call on_packet per frame.

    recover2=True (opt-in yield improvement) additionally accepts
    frames repaired by a unique DOUBLE bit-flip
    (airjax.protocol.crc.crc_check_and_recover2), gated so a >=3-bit
    noise burst aliasing to a 2-flip repair of a different codeword is
    never emitted: in parity mode the repaired ICAO must already have
    been seen in a clean/1-flip frame this stream (per-packet walk or
    the vectorized batched gate); in extended mode the frames ride the
    existing ICAO acceptance cache and never seed it (assemble_extended
    pass 1.5 / the batched sink's mirrored gate). Parity semantics are
    untouched when off. stats.recovered2 counts accepted repairs on
    every path except the extended batched sink (which applies them but
    does not report the split).

    With plot_dir set, an SVG magnitude plot of each decoded frame's
    window is dumped there (debug aid; see airjax.visualise).

    With extended=True, every Mode S downlink format is decoded (DF11
    all-call, AP-addressed DF4/5/20/21 surveillance replies, in addition
    to the reference's DF17) — see airjax.extended. on_packet then also
    receives AllCallReply / SurveillanceReply objects.

    pipeline_depth keeps that many decodes in flight before fetching
    results (JAX async dispatch): block k+1's device work overlaps block
    k's host-side fetch + packet assembly. Packets are still emitted in
    strict stream order (FIFO drain). 0 restores fully-serial behavior.
    """
    import collections

    import jax.numpy as jnp

    from airjax.pipeline import decode_iq_block

    stats = stats or StreamStats()
    # Batched host path: a sink exposing
    # `on_fields(fields, idx, now)` (airjax.track.batch.BatchTracker)
    # receives each block's device-extracted protocol fields in ONE call
    # instead of one AdsbPacket per frame (the per-packet python path
    # measures ~114k msgs/s on a host CPU, tools/bench_host.py).
    # Parity (DF17) mode only; extended mode and plot_dir keep per-packet.
    batch_fn = getattr(on_packet, "on_fields", None)
    if (
        batch_fn is not None
        and not extended
        and plot_dir is None
        and not dump_preamble
    ):
        from airjax.pipeline import decode_iq_block_with_fields as _decode_b
    else:
        batch_fn = None
    # Extended-mode batched sink (ExtendedBatchTracker.on_extended_block):
    # fields extracted on device; dominant ADS-B classes applied in runs,
    # everything else through the exact per-packet path, interleaved in
    # offset order (airjax/track/batch.py).
    ext_batch_fn = getattr(on_packet, "on_extended_block", None)
    if not (
        extended
        and ext_batch_fn is not None
        and plot_dir is None
        and not dump_preamble
    ):
        ext_batch_fn = None
    if extended:
        from airjax.extended import assemble_extended
        from airjax.pipeline import decode_iq_block_extended
        from airjax.pipeline import (
            decode_iq_block_extended_with_fields as _decode_eb,
        )
        from airjax.track.icao_cache import IcaoCache

        icao_cache = IcaoCache()
    halo = WINDOW - 1
    # Initial carry uses the non-detecting (1,0)-magnitude pattern: a
    # zero carry passes the equality-tolerant preamble gate at every
    # offset and floods the candidate capacity with bogus detections
    # (~214 per stream start, measured).
    carry = None
    if overlap:
        carry = np.zeros((halo, 2), dtype=np.int16)
        carry[::2, 0] = 1
    # Global sample index of carry[0]; first block's padded head is masked.
    global_base = -halo
    pending = np.zeros((0, 2), dtype=np.int16)

    if extended and recover2:
        _base_ext = (
            _decode_eb if ext_batch_fn is not None else decode_iq_block_extended
        )

        def decode_fn(ext, n_off, capacity, _fn=_base_ext):
            return _fn(ext, n_off, capacity, recover2=True)
    elif extended:
        decode_fn = _decode_eb if ext_batch_fn is not None else decode_iq_block_extended
    elif batch_fn is not None and recover2:
        def decode_fn(ext, n_off, capacity):
            return _decode_b(ext, n_off, capacity, recover2=True)
    elif recover2:
        from airjax.pipeline import decode_iq_block_r2

        decode_fn = decode_iq_block_r2
    elif batch_fn is not None:
        decode_fn = _decode_b
    else:
        decode_fn = decode_iq_block
    seen_icaos: set[int] = set()  # recover2 acceptance gate
    inflight: "collections.deque" = collections.deque()

    def _process(entry) -> None:
        ext, n_off, base, now, n_samples, out_dev = entry
        with stats.stages.stage("fetch"):
            out = jax.device_get(out_dev)
            # Adaptive overflow regrow (synchronous — overflow is rare
            # and dropped detections would silently lose frames).
            overflowed = bool(out["overflow"])
            capacity = cfg.max_candidates
            while bool(out["overflow"]) and capacity < n_off:
                capacity = min(capacity * 4, n_off)
                out = jax.device_get(
                    decode_fn(jnp.asarray(ext), n_off, capacity)
                )
        t_apply = time.perf_counter()
        emitted = 0
        if extended and ext_batch_fn is not None:
            # min_offset masks application (not cache seeding) of the
            # zero-padded head of the very first block, exactly like the
            # per-packet skip below — which also seeds the cache first
            # (assemble_extended pass 1).
            emitted = ext_batch_fn(
                out, now, icao_cache,
                min_offset=(-base if overlap and base < 0 else None),
            )
        elif extended:
            # Offsets whose frame validated only via the gated 2-flip
            # repair (recover2 mode): for the accepted-repairs stat.
            rec2_offs = (
                set(
                    np.asarray(out["offsets"])[
                        np.asarray(out["recovered2"])
                    ].tolist()
                )
                if "recovered2" in out
                else ()
            )
            for local, pkt in assemble_extended(out, now, icao_cache):
                if overlap and base + local < 0:
                    continue
                if local in rec2_offs:
                    stats.recovered2 += 1
                if dump_preamble:
                    from airjax import golden, visualise

                    window = ext[local : local + 16]
                    print(
                        visualise.dump_preamble(
                            golden.magnitude(window),
                            offset=base + local if overlap else local,
                        )
                    )
                on_packet(pkt)
                emitted += 1
        elif batch_fn is not None:
            good = np.asarray(out["good"])
            if overlap:
                # int64: the stream base exceeds 2^31 after ~18 min of
                # free-running decode, and numpy refuses to add a large
                # Python int to the int32 offsets (OverflowError — the
                # round-5 600 s sharded soak crashed exactly here).
                good = good & (
                    np.asarray(out["offsets"], np.int64) + base >= 0
                )
            idx = np.nonzero(good)[0]
            if recover2:
                idx, n_r2 = _gate_recover2_batch(
                    idx, out["fields"]["icao"], out["recovered2"], seen_icaos
                )
                stats.recovered2 += n_r2
            emitted = batch_fn(out["fields"], idx, now)
        else:
            for k in np.nonzero(out["good"])[0]:
                local = int(out["offsets"][k])
                if overlap and base + local < 0:
                    continue  # zero-padded head of the very first block
                fb = out["frames"][k].tobytes()
                if recover2:
                    icao = int.from_bytes(fb[1:4], "big")
                    if bool(out["recovered2"][k]):
                        # Gate: a 2-flip repair is only trusted for an
                        # aircraft already validated without it.
                        if icao not in seen_icaos:
                            continue
                        stats.recovered2 += 1
                    else:
                        seen_icaos.add(icao)
                on_packet(AdsbPacket.from_bytes(fb, now))
                emitted += 1
                if plot_dir is not None or dump_preamble:
                    from airjax import golden, visualise

                    window = ext[local : local + WINDOW]
                    goff = base + local if overlap else local
                    if plot_dir is not None:
                        visualise.plot_adsb_frame(
                            golden.magnitude(window),
                            out_dir=plot_dir,
                            detection_offset=0,
                            title=f"frame @ {goff}",
                        )
                    if dump_preamble:
                        print(
                            visualise.dump_preamble(
                                golden.magnitude(window[:16]), offset=goff
                            )
                        )
        stats.stages.add("apply", time.perf_counter() - t_apply)
        # The tail flush is an extra decode call, not a source block
        # (its entry carries n_samples=0): it must not skew block counts.
        stats.blocks += 1 if n_samples else 0
        stats.samples += n_samples
        stats.detections += int(out["n_detections"])
        stats.good += emitted
        stats.recovered += int(np.sum(out["recovered"]))
        # Counts blocks that REQUIRED a regrow (the regrown result's own
        # flag is clear by construction, so the final flag would always
        # read 0 — the interesting event is that the initial capacity
        # was insufficient).
        stats.overflow_blocks += overflowed

    for block in Prefetcher(source, depth=prefetch_depth):
        block = np.asarray(block, dtype=np.int16)
        if overlap and len(pending):
            # Short reads (live SDR partial buffers) accumulate rather
            # than being dropped, preserving stream continuity.
            block = np.concatenate([pending, block], axis=0)
            pending = pending[:0]
        if block.shape[0] < WINDOW:
            if overlap:
                pending = block
            # parity mode: the reference cannot process blocks < 240
            # samples at all (its offset range underflows), so skipping
            # matches its only well-defined behavior
            continue
        if overlap:
            full = np.concatenate([carry, block], axis=0)
            if full.shape[0] >= TUNED_STREAM_MIN:
                # Shape-tuned scan: a 1024-aligned slice with
                # n_off ≡ 784 (mod 1024) (see TUNED_STREAM_MIN). The carry
                # grows to at most 1263 + 239 samples and the emitted hit
                # stream is decomposition-invariant (tests/test_runner.py).
                slice_len = (full.shape[0] // 1024) * 1024
                n_off = slice_len - 240
                ext = full[:slice_len]
            else:
                n_off = full.shape[0] - halo
                ext = full
            carry = full[n_off:].copy()
        else:
            n_off = block.shape[0] - WINDOW
            ext = block
        with stats.stages.stage("dispatch"):
            out_dev = decode_fn(jnp.asarray(ext), n_off, cfg.max_candidates)
        inflight.append(
            (ext, n_off, global_base, time.time(), block.shape[0], out_dev)
        )
        if overlap:
            global_base += n_off
        while len(inflight) > max(pipeline_depth, 0):
            _process(inflight.popleft())
    if overlap and len(pending):
        # A final short read (< 240 samples) never formed a block; its
        # samples still terminate the stream and frames ending inside
        # them are scannable once appended to the carry.
        carry = (
            np.concatenate([carry, pending], axis=0)
            if carry is not None
            else pending
        )
    if overlap and carry is not None and carry.shape[0] > halo:
        # Tail flush: the tuned decomposition can leave more than a
        # window's worth of samples in the carry; their offsets are still
        # scannable (windows end exactly at the stream end).
        n_off = carry.shape[0] - halo
        out_dev = decode_fn(jnp.asarray(carry), n_off, cfg.max_candidates)
        inflight.append((carry, n_off, global_base, time.time(), 0, out_dev))
    while inflight:
        _process(inflight.popleft())
    return stats


def run_stream_sharded(
    source: Iterator[np.ndarray],
    on_packet: Callable[[AdsbPacket], None],
    mesh=None,
    n_devices: int | None = None,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    stats: StreamStats | None = None,
    extended: bool = False,
    shard_block: int | None = None,
    capacity_per_shard: int | None = None,
    compact_capacity: int | None = None,
    pipeline_depth: int = 1,
    recover2: bool = False,
) -> StreamStats:
    """Continuous-stream decode sharded over a device mesh (the product
    path for aggregate multi-card throughput, `adsb --devices N`).

    recover2 mirrors run_stream's opt-in gated 2-bit repair: parity
    frames gate on the stream's seen-ICAO set (per-packet walk or the
    vectorized batched gate), extended frames on the ICAO acceptance
    cache (assemble_extended / the batched sink's mirrored gate).

    Incoming blocks are coalesced into fixed steps of
    `shard_block * n_devices` samples; each step runs the compact
    overlap-save sharded decoder (airjax.parallel.halo — ppermute halo
    between shards, psum hit gather), and a 239-sample carry preserves
    scan continuity BETWEEN steps, so every global offset of the stream
    is scanned exactly once: frames straddling source-block boundaries,
    step boundaries, and shard boundaries all decode. The emitted hit
    stream is bit-identical to single-device run_stream(overlap=True)
    over the same samples (tests/test_runner_sharded.py).

    The stream end pads the final partial step with the non-detecting
    pattern and drops padded-region offsets — the same exactness
    contract as decode_capture_sharded's padding.

    Stats caveat: `detections` counts the RAW per-shard preamble hits,
    and each step's last 239 offsets are re-scanned by the next step
    (within a step they carry ring-wrapped halo context and are masked
    from hits; the next step scans them with real context) — so a
    detection whose gate sits in that boundary region is counted twice.
    `good` and the emitted packet stream are exact (equality-tested
    against single-device run_stream); treat `detections` as >= the
    single-device count.

    Sinks: per-packet (AdsbPacket / extended typed packets) or the
    batched trackers (on_fields / on_extended_block), same as
    run_stream. Reference analogue of the whole loop: the live pipeline
    src/adsb.rs:126-167 — which is strictly single-threaded per stage.
    """
    import collections

    import jax.numpy as jnp

    from airjax.parallel.halo import (
        _EXT_MASK_KEYS,
        EXT_COMPACT_ROW_KEYS,
        HALO as _HALO,
        build_sharded_decoder_compact,
        build_sharded_decoder_extended_compact,
        tuned_block,
        unpack_extended_compact,
    )
    from airjax.parallel.mesh import make_mesh
    from airjax.pipeline import pad_iq_non_detecting

    if mesh is None:
        mesh = make_mesh(n_devices)
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    stats = stats or StreamStats()

    batch_fn = getattr(on_packet, "on_fields", None) if not extended else None
    ext_batch_fn = (
        getattr(on_packet, "on_extended_block", None) if extended else None
    )
    if extended:
        from airjax.extended import assemble_extended
        from airjax.track.icao_cache import IcaoCache

        icao_cache = IcaoCache()

    block = shard_block or tuned_block(max(16384, cfg.block_len))
    T = block * n_dev  # samples per sharded step
    F = T - _HALO  # fresh samples consumed per step
    K = capacity_per_shard or cfg.max_candidates
    C = compact_capacity or max(128 if not extended else 512, K)
    with_fields = batch_fn is not None or ext_batch_fn is not None
    builder = (
        build_sharded_decoder_extended_compact
        if extended
        else build_sharded_decoder_compact
    )
    steps: dict[tuple[int, int], Callable] = {}

    def get_step(k: int, c: int):
        if (k, c) not in steps:
            steps[(k, c)] = builder(
                mesh, T, k, c, axis, with_fields=with_fields,
                recover2=recover2,
            )
        return steps[(k, c)]

    count_key = "n_candidates" if extended else "n_good"
    row_keys = (
        EXT_COMPACT_ROW_KEYS if extended else ("offsets", "recovered", "frames")
    )
    if recover2:
        row_keys = row_keys + ("recovered2",)
    seen_icaos: set[int] = set()  # parity recover2 acceptance gate

    # Warm the step compile BEFORE consuming the source: a first compile
    # can take minutes, and in extended mode frames that arrive during
    # the stall would age past the 60 s ICAO acceptance window before
    # their step is processed (an extended stream once lost its
    # tail-step DF24 exactly this way). The warm input is the
    # non-detecting pattern, and the jitted step is reused afterwards.
    warm = np.zeros((T, 2), dtype=np.int16)
    warm[::2, 0] = 1
    int(jax.device_get(get_step(K, C)(jnp.asarray(warm))[count_key]))

    # Initial carry: the non-detecting (1,0)-magnitude pattern (see
    # run_stream); its offsets are masked by global_base < 0.
    carry = np.zeros((_HALO, 2), dtype=np.int16)
    carry[::2, 0] = 1
    global_base = -_HALO
    acc = np.zeros((0, 2), dtype=np.int16)
    inflight: "collections.deque" = collections.deque()

    def _fetch_rows(out_dev, n: int) -> dict:
        rows = {k: out_dev[k][:n] for k in row_keys}
        if with_fields:
            rows["fields"] = {
                k: v[:n] for k, v in out_dev["fields"].items()
            }
            if extended:
                rows["short_fields"] = {
                    k: v[:n] for k, v in out_dev["short_fields"].items()
                }
        return jax.device_get(rows)

    def _process(entry) -> None:
        nonlocal K, C
        ext_in, base, now, n_fresh, max_local, out_dev = entry
        with stats.stages.stage("fetch"):
            scal = jax.device_get(
                {
                    k: out_dev[k]
                    for k in (count_key, "n_detections", "overflow")
                }
            )
            overflowed = bool(scal["overflow"])
            while bool(scal["overflow"]) and (K < block or C < T):
                K = min(K * 4, block)
                C = min(C * 4, T)
                out_dev = get_step(K, C)(jnp.asarray(ext_in))
                scal = jax.device_get(
                    {
                        k: out_dev[k]
                        for k in (count_key, "n_detections", "overflow")
                    }
                )
            n = int(scal[count_key])
            rows = _fetch_rows(out_dev, n)
        t_apply = time.perf_counter()
        # int64: the stream base exceeds 2^31 after ~2.1 G samples and
        # numpy refuses Python-int + int32-array then (OverflowError —
        # the 600 s free-running soak crashed exactly here).
        offs = np.asarray(rows["offsets"], dtype=np.int64)
        # Stream-validity: skip the padded head of the very first step
        # (base < 0) and, on the padded tail step, offsets whose window
        # ran past the true stream end.
        ok = offs + base >= 0
        if max_local is not None:
            ok &= offs <= max_local
        emitted = 0
        if extended:
            unp = unpack_extended_compact(rows, n)
            if max_local is not None:
                # Pad-region candidates on the final step must not even
                # seed the acceptance cache: single-device run_stream
                # never scans those offsets, and exact hit-stream
                # equality includes cache-gating visibility. Iterate
                # the canonical class list so a future candidate class
                # cannot silently miss this mask.
                for k_ in _EXT_MASK_KEYS + (
                    ("recovered2",) if recover2 else ()
                ):
                    unp[k_] = unp[k_] & (offs <= max_local)
            stats.recovered += int(np.sum(unp["recovered"]))
        if extended and ext_batch_fn is not None:
            unp["fields"] = rows["fields"]
            unp["short_fields"] = rows["short_fields"]
            emitted = ext_batch_fn(
                unp, now, icao_cache,
                min_offset=(-base if base < 0 else None),
            )
        elif extended:
            rec2_offs = (
                set(offs[np.asarray(unp["recovered2"])].tolist())
                if recover2
                else ()
            )
            for local, pkt in assemble_extended(unp, now, icao_cache):
                if base + local < 0:
                    continue
                if local in rec2_offs:
                    stats.recovered2 += 1
                on_packet(pkt)
                emitted += 1
        elif batch_fn is not None:
            idx = np.nonzero(ok)[0]
            if recover2:
                idx, n_r2 = _gate_recover2_batch(
                    idx, rows["fields"]["icao"], rows["recovered2"],
                    seen_icaos,
                )
                stats.recovered2 += n_r2
            emitted = batch_fn(rows["fields"], idx, now)
        else:
            for k_ in np.nonzero(ok)[0]:
                fb = np.asarray(rows["frames"][k_]).tobytes()
                if recover2:
                    icao = int.from_bytes(fb[1:4], "big")
                    if bool(rows["recovered2"][k_]):
                        # Same gate as run_stream: a 2-flip repair is
                        # only trusted for an already-validated ICAO.
                        if icao not in seen_icaos:
                            continue
                        stats.recovered2 += 1
                    else:
                        seen_icaos.add(icao)
                on_packet(AdsbPacket.from_bytes(fb, now))
                emitted += 1
        stats.stages.add("apply", time.perf_counter() - t_apply)
        stats.blocks += 1 if n_fresh else 0
        stats.samples += n_fresh
        stats.detections += int(scal["n_detections"])
        stats.good += emitted
        if not extended:
            recov = np.asarray(rows["recovered"])
            stats.recovered += int(np.sum(recov[ok]))
        # (extended: recovered counted above from the unpacked classes,
        # mirroring single-device run_stream's block-level sum.)
        stats.overflow_blocks += overflowed

    def _dispatch(fresh: np.ndarray, max_local: int | None) -> None:
        nonlocal carry, global_base
        full = np.concatenate([carry, fresh], axis=0)
        if full.shape[0] < T:
            full = pad_iq_non_detecting(full, T)
        with stats.stages.stage("dispatch"):
            out_dev = get_step(K, C)(jnp.asarray(full))
        inflight.append(
            (full, global_base, time.time(), fresh.shape[0], max_local, out_dev)
        )
        carry = full[F:].copy()
        global_base += F
        while len(inflight) > max(pipeline_depth, 0):
            _process(inflight.popleft())

    for blk in Prefetcher(source, depth=4):
        blk = np.asarray(blk, dtype=np.int16)
        acc = np.concatenate([acc, blk], axis=0) if len(acc) else blk
        while acc.shape[0] >= F:
            fresh, acc = acc[:F], acc[F:]
            _dispatch(fresh, None)
    if acc.shape[0] > 0:
        # Final partial step: pad to T; only offsets whose full window
        # fits inside carry+acc are real.
        true_len = _HALO + acc.shape[0]
        if true_len >= WINDOW:
            _dispatch(acc, true_len - WINDOW)
    while inflight:
        _process(inflight.popleft())
    return stats
