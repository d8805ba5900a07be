"""The jitted decode pipeline: IQ blocks -> validated 14-byte frames.

The reference's three-thread scalar pipeline (src/adsb.rs:92-122) becomes a
single traced array program per block batch:

  int16 IQ -> exact u32 magnitude -> branch-free preamble/DF17 scan over all
  offsets -> masked compaction into fixed-capacity candidates -> PPM
  bit-slice of candidates -> GF(2) matmul CRC + single-bit syndrome
  recovery -> (frames, offsets, masks, stats)

Two block decompositions are provided:

  * parity mode — reproduces the reference playback semantics exactly:
    20,000-sample chunks, offsets [0, 19760) per chunk, boundary-straddling
    frames dropped, tail dropped, duplicates kept (the reference's
    `_i += 240` skip is a no-op — src/adsb.rs:113).
  * overlap mode — the fixed "long-context" decomposition: blocks carry a
    239-sample halo from the next block, so every global offset is scanned
    exactly once and no frame is ever lost at a block edge.

Host-side, validated frames become `AdsbPacket`s in capture order.
"""

from __future__ import annotations

import functools
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from airjax.config import PipelineConfig, DEFAULT_CONFIG
from airjax.dsp.demod import (
    WINDOW,
    compact_detections,
    detect,
    detect_preamble_only,
    pack_cmp_words,
    slice_bits,
    slice_bits_packed,
)
from airjax.dsp.magnitude import magnitude_u16
from airjax.protocol.crc import bits_to_bytes, crc_check_and_recover
from airjax.protocol.packet import AdsbPacket


def compact_mask(det: jnp.ndarray, capacity: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compact True positions of a bool vector into ascending slots.

    Delegates to airjax.dsp.demod.compact_detections (gather-based, no
    scatter). Invalid slots hold n. Returns (indices (capacity,) int32,
    n_true () int32).
    """
    offsets, _, n_det = compact_detections(det, capacity)
    return offsets, n_det


def decode_mags_block(
    mags: jnp.ndarray, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, jnp.ndarray]:
    """Scan one magnitude block: detection, slicing, CRC, recovery.

    Args:
      mags: (L,) unsigned magnitudes (u16 from magnitude_u16 in production —
        lossless, see airjax.dsp.magnitude), L >= n_off + WINDOW - 1.
      n_off: number of window offsets to scan (static).
      capacity: fixed candidate capacity (static).
      recover2: opt-in 2-bit repair (extra `recovered2` key; callers
        must gate acceptance — see decode_mags_block_r2).
    """
    return _decode_mags_common(mags, n_off, capacity, recover2=recover2)


def _decode_mags_common(
    mags: jnp.ndarray, n_off: int, capacity: int, recover2: bool
) -> dict[str, jnp.ndarray]:
    """One shared detect/compact/slice/CRC body for the parity pipeline
    and its opt-in 2-bit-recovery variant — only the recovery call
    differs, so perf/semantics changes to the hot path cannot drift
    between the two."""
    det = detect(mags, n_off)
    offsets, n_det = compact_mask(det, capacity)
    valid = offsets < n_off
    words = pack_cmp_words(mags)
    bits = slice_bits_packed(words, jnp.where(valid, offsets, 0))
    recovered2 = None
    if recover2:
        from airjax.protocol.crc import crc_check_and_recover2

        bits, crc_ok, recovered, recovered2 = crc_check_and_recover2(bits)
    else:
        bits, crc_ok, recovered = crc_check_and_recover(bits)
    good = crc_ok & valid
    frames = bits_to_bytes(bits)
    out = {
        "offsets": offsets,
        "valid": valid,
        "good": good,
        "recovered": recovered & valid,
        "frames": frames,
        "n_detections": n_det,
        "n_good": jnp.sum(good, dtype=jnp.int32),
        "overflow": n_det > capacity,
    }
    if recovered2 is not None:
        out["recovered2"] = recovered2 & valid
    return out


@functools.partial(jax.jit, static_argnames=("n_off", "capacity"))
def decode_iq_block(
    iq: jnp.ndarray, n_off: int, capacity: int
) -> dict[str, jnp.ndarray]:
    """(L, 2) int16 IQ -> candidate dict (single block, jitted)."""
    return decode_mags_block(magnitude_u16(iq), n_off, capacity)


def decode_mags_block_r2(
    mags: jnp.ndarray, n_off: int, capacity: int
) -> dict[str, jnp.ndarray]:
    """decode_mags_block + 2-bit CRC recovery (opt-in yield improvement
    beyond the reference's 1-flip brute force,
    src/adsb/crc.rs:49-65). Extra key `recovered2` marks frames that
    validated only via a unique double-flip repair; `good` includes
    them. Callers MUST gate recovered2 acceptance (see
    airjax.protocol.crc.crc_check_and_recover2) — a ≥3-bit error can
    alias to a 2-flip repair of a different codeword."""
    return _decode_mags_common(mags, n_off, capacity, recover2=True)


@functools.partial(jax.jit, static_argnames=("n_off", "capacity"))
def decode_iq_block_r2(
    iq: jnp.ndarray, n_off: int, capacity: int
) -> dict[str, jnp.ndarray]:
    """(L, 2) int16 IQ -> candidate dict incl. 2-bit repairs (jitted)."""
    return decode_mags_block_r2(magnitude_u16(iq), n_off, capacity)


def decode_mags_block_extended(
    mags: jnp.ndarray, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, jnp.ndarray]:
    """Extended scan: every Mode S downlink format, not just DF17.

    recover2=True (opt-in, `adsb --extended --recover2`) additionally
    repairs long frames via the unique 2-bit pairwise-syndrome table;
    such frames join `good_long` and are flagged in the extra
    `recovered2` key — the host assembly MUST gate them on the ICAO
    acceptance cache (airjax.extended.assemble_extended does) since a
    >=3-bit error can alias to a repair of a different codeword.

    Preamble-only detection (no DF gate), then per-candidate
    classification (extension beyond the reference — see
    airjax.protocol.shortframe):

      * long frames (DF>=16, 112 bits): CRC check + 1-bit recovery
        (`good_long`); DF20/21 are AP-addressed, so their CRC "residual"
        is the transmitting ICAO (`icao_ap_long`, host-validated).
      * short frames (56 bits): DF11 validates when PI == CRC
        (interrogator 0, `good_df11`); DF4/5 are AP-addressed
        candidates (`icao_ap_short`, host-validated).
    """
    from airjax.protocol.crc import DATA_BITS, crc24_batch, pack_bits_msbfirst
    from airjax.protocol import shortframe

    det = detect_preamble_only(mags, n_off)
    offsets, n_det = compact_mask(det, capacity)
    valid = offsets < n_off
    words = pack_cmp_words(mags)
    bits = slice_bits_packed(words, jnp.where(valid, offsets, 0))

    df = pack_bits_msbfirst(bits[..., :5], 5).astype(jnp.int32)

    # Long-frame path (reference semantics incl. recovery).
    long_rec2 = None
    if recover2:
        from airjax.protocol.crc import crc_check_and_recover2

        long_bits, long_ok, long_rec, long_rec2 = crc_check_and_recover2(bits)
    else:
        long_bits, long_ok, long_rec = crc_check_and_recover(bits)
    is_long = df >= 16
    # AP-addressed long frames (DF16 ACAS long air-air, DF20/21 Comm-B,
    # DF24 Comm-D ELM):
    # residual = ICAO (no recovery possible); they are excluded from the
    # CRC-validated class even when the residual happens to be 0, and
    # address-0 candidates are dropped outright (0 is not a real aircraft
    # and the host ICAO cache could never accept it — this also keeps
    # degenerate all-zero streams, whose frames decode as address 0, from
    # flooding the candidate capacity).
    # DF24+ (first two bits '11', df field 24-31) is Comm-D ELM — also
    # AP-addressed (ICAO Annex 10 v4 3.1.2.7.3).
    is_long_ap = (df == 16) | (df == 20) | (df == 21) | (df >= 24)
    good_long = long_ok & is_long & valid & ~is_long_ap
    calced_long = crc24_batch(bits[..., :DATA_BITS])
    pcrc_long = pack_bits_msbfirst(bits[..., DATA_BITS:], 24)
    icao_ap_long = calced_long ^ pcrc_long
    cand_long_ap = is_long_ap & valid & (icao_ap_long != 0)

    # Short-frame path.
    crc_short = shortframe.crc24_short_batch(bits[..., :32])
    pi = pack_bits_msbfirst(bits[..., 32:56], 24)
    icao_ap_short = crc_short ^ pi
    good_df11 = (df == 11) & (icao_ap_short == 0) & valid
    # DF11 interrogated all-calls: PI = CRC ^ interrogator code (II/SI,
    # encoded range < 80). The AA address is cleartext but the checksum
    # no longer independently validates, so these are candidates gated
    # host-side on the ICAO cache (like AP frames).
    cand_df11_ic = (
        (df == 11) & valid & (icao_ap_short != 0) & (icao_ap_short < 80)
    )
    # DF0 (ACAS short air-air) is AP-addressed like DF4/5; address-0
    # candidates dropped (see the long-frame note above).
    cand_short_ap = (
        ((df == 0) | (df == 4) | (df == 5)) & valid & (icao_ap_short != 0)
    )

    frames = bits_to_bytes(long_bits)
    frames_raw = bits_to_bytes(bits)
    out = {
        "offsets": offsets,
        "valid": valid,
        "df": df,
        "frames": frames,  # recovery applied (long frames)
        "frames_raw": frames_raw,
        "good_long": good_long,
        "recovered": long_rec & good_long,
        "good_df11": good_df11,
        "cand_df11_ic": cand_df11_ic,
        "cand_short_ap": cand_short_ap,
        "cand_long_ap": cand_long_ap,
        "icao_ap_short": icao_ap_short,
        "icao_ap_long": icao_ap_long,
        "n_detections": n_det,
        "overflow": n_det > capacity,
    }
    if long_rec2 is not None:
        out["recovered2"] = long_rec2 & good_long
    return out


@functools.partial(
    jax.jit, static_argnames=("n_off", "capacity", "recover2")
)
def decode_iq_block_extended(
    iq: jnp.ndarray, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, jnp.ndarray]:
    return decode_mags_block_extended(
        magnitude_u16(iq), n_off, capacity, recover2=recover2
    )


@functools.partial(
    jax.jit, static_argnames=("n_off", "capacity", "recover2")
)
def decode_iq_block_with_fields(
    iq: jnp.ndarray, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, jnp.ndarray]:
    """decode_iq_block + batched protocol field extraction fused into the
    same device program: the (capacity,)-shaped field arrays ride the same
    host fetch as the candidate dict, so the online host path never parses
    frame bytes per packet (the reference's thread-3 consumer does,
    src/adsb.rs:149-167 via packet.rs:25-49). Fields of invalid slots are
    garbage; consumers index only where `good`. recover2 adds the gated
    2-bit repair class (`recovered2` key; the stream runner gates)."""
    from airjax.protocol.fields import extract_fields

    out = decode_mags_block(magnitude_u16(iq), n_off, capacity, recover2)
    out["fields"] = extract_fields(out["frames"])
    return out


@functools.partial(
    jax.jit, static_argnames=("n_off", "capacity", "recover2")
)
def decode_iq_block_extended_with_fields(
    iq: jnp.ndarray, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, jnp.ndarray]:
    """Extended decode + batched field extraction in one device program
    (the extended-mode analogue of decode_iq_block_with_fields).
    `fields` is extracted from the corrected LONG frames and is
    meaningful only where `good_long`; `short_fields`
    (airjax.protocol.shortframe.extract_short_fields over the raw first
    7 bytes) serves the AP-candidate host assembly, meaningful only
    where a cand_* class is set."""
    from airjax.protocol.fields import extract_fields
    from airjax.protocol.shortframe import extract_short_fields_from_raw

    out = decode_mags_block_extended(
        magnitude_u16(iq), n_off, capacity, recover2=recover2
    )
    out["fields"] = extract_fields(out["frames"])
    out["short_fields"] = extract_short_fields_from_raw(out["frames_raw"])
    return out


@functools.partial(jax.jit, static_argnames=("n_off", "capacity"))
def decode_iq_chunks(
    iq_chunks: jnp.ndarray, n_off: int, capacity: int
) -> dict[str, jnp.ndarray]:
    """(B, L, 2) int16 IQ chunk batch -> batched candidate dict (vmapped)."""
    return jax.vmap(
        lambda iq: decode_mags_block(magnitude_u16(iq), n_off, capacity)
    )(iq_chunks)


def decode_iq_block_adaptive(
    iq_block: np.ndarray, n_off: int, capacity: int
) -> dict:
    """Decode one block, growing candidate capacity on overflow.

    The fixed-capacity compaction drops detections past `capacity`
    (flagged via `overflow`); parity demands every hit, so overflowing
    blocks are re-decoded at 4x capacity until they fit (degenerate
    streams — e.g. constant magnitudes, where every offset detects — cap
    out at n_off). Each distinct capacity is one extra jit cache entry.
    """
    block = jnp.asarray(iq_block)
    out = jax.device_get(decode_iq_block(block, n_off, capacity))
    while bool(out["overflow"]) and capacity < n_off:
        capacity = min(capacity * 4, n_off)
        out = jax.device_get(decode_iq_block(block, n_off, capacity))
    return out


# ---------------------------------------------------------------------------
# Block decompositions
# ---------------------------------------------------------------------------


def pad_iq_non_detecting(iq: np.ndarray, target_len: int) -> np.ndarray:
    """Pad IQ to target_len with a pattern that can never detect.

    Zero padding is dangerous: constant magnitudes pass the reference's
    equality-tolerant preamble check at EVERY offset and an all-zero frame
    has CRC 0, so a zero tail floods the candidate capacity. An
    alternating (1,0) magnitude pattern makes min(preamble highs) = 0 <
    max(lows) = 1 at every pure-pad offset, killing all pad detections.
    (Windows overlapping real samples are handled by the callers' global
    offset masks.)
    """
    n = len(iq)
    out = np.empty((target_len, 2), dtype=np.int16)
    out[:n] = iq
    pad = target_len - n
    if pad > 0:
        tail = np.zeros((pad, 2), dtype=np.int16)
        tail[::2, 0] = 1  # |IQ| = 1, 0, 1, 0, ...
        out[n:] = tail
    return out


def reference_chunk_count(n_samples: int, chunk: int = 20000) -> int:
    """Number of chunks the reference playback emits (src/adsb.rs:75-89).

    `while i < len - 20000 { send [i, i+20000); i += 20000 }` — note this
    drops the tail *including the final full chunk* when len is an exact
    multiple.
    """
    if n_samples <= chunk:
        return 0
    return -(-(n_samples - chunk) // chunk)  # ceil((len - chunk)/chunk)


def decode_capture_parity(
    iq: np.ndarray,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    fused: bool = True,
) -> tuple[list[tuple[int, int, bytes, bool]], dict]:
    """Decode a capture with exact reference playback semantics.

    Returns (hits, stats) where hits is a list of
    (chunk_index, offset_in_chunk, frame_bytes, recovered) in scan order.

    With fused=True (default) the capture is scanned ONCE as large
    overlap-save blocks and the reference's chunking semantics are applied
    as a pure offset filter afterwards: a chunk-local detection at
    (c, o) is identical to the whole-stream detection at c*chunk + o
    because magnitudes are per-sample, so "reference chunking" is exactly
    the subset of whole-stream hits with o_in_chunk < chunk - 240 and
    chunk_index < n_chunks. This is ~20x faster than actually decoding
    per-20k-chunk (vmapped small blocks) and bit-identical (fuzz-verified
    against the golden scalar decoder). fused=False keeps the literal
    per-chunk decode for cross-validation.
    """
    chunk = cfg.block_len
    n_off = chunk - WINDOW
    n_chunks = reference_chunk_count(len(iq), chunk)
    if n_chunks == 0:
        return [], {"n_detections": 0, "n_good": 0, "overflow": False}

    if fused:
        import dataclasses

        scan_cfg = dataclasses.replace(cfg, block_len=max(chunk, 1 << 22))
        prep = _prep_overlap(np.asarray(iq[: n_chunks * chunk]), scan_cfg)
        whole, scan_stats = _overlap_scan(*prep, scan_cfg)
        hits = []
        for _, g, frame, rec in whole:
            c, o = divmod(g, chunk)
            if o < n_off:
                hits.append((c, o, frame, rec))
        # Hit-level stats reflect the returned (chunk-filtered) hits, and
        # n_detections is the exact reference-chunked count — an extra
        # counting pass over the SAME device array as the scan (prep[0]'s
        # prefix is the capture, so it is uploaded once).
        stats = {
            "n_detections": int(
                _count_chunked_detections(prep[0], chunk, n_chunks)
            ),
            "n_good": len(hits),
            "n_recovered": sum(1 for h in hits if h[3]),
            "overflow": scan_stats.get("overflow", False),
        }
        return hits, stats

    blocks = np.asarray(iq[: n_chunks * chunk]).reshape(n_chunks, chunk, 2)
    out = jax.device_get(
        decode_iq_chunks(jnp.asarray(blocks), n_off, cfg.max_candidates)
    )
    hits = _collect_hits(
        out, lambda c, o: (c, o), blocks, n_off, cfg.max_candidates
    )
    return hits, _collect_stats(out)



@functools.partial(jax.jit, static_argnames=("chunk", "n_chunks"))
def _count_chunked_detections(iq: jnp.ndarray, chunk: int, n_chunks: int):
    """Exact reference-chunked detection count for the fused parity path.

    A chunk-local detection at (c, o) is identical to the whole-stream
    detection at g = c*chunk + o (magnitudes are per-sample), so the
    per-chunk count is the whole-stream mask filtered to o < chunk-WINDOW
    — one cheap extra pass, removing the round-1 documented divergence
    where fused-parity stats reported a whole-stream count.

    `iq` may extend beyond n_chunks*chunk samples (e.g. the overlap
    scan's padded device array, reused to avoid a second upload); the
    tail is never scanned.
    """
    mags = magnitude_u16(iq)
    n_scan = n_chunks * chunk - WINDOW
    det = detect(mags, n_scan)
    det = jnp.pad(det, (0, n_chunks * chunk - n_scan))
    per_chunk = det.reshape(n_chunks, chunk)[:, : chunk - WINDOW]
    return jnp.sum(per_chunk, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("slice_len", "n_off", "capacity"))
def _decode_block_at(
    iq_padded: jnp.ndarray, start, slice_len: int, n_off: int, capacity: int
):
    """Decode `n_off` offsets of the slice starting at traced offset
    `start` of a padded capture resident on device (one upload,
    device-side slicing instead of a host np.stack of overlapping
    blocks)."""
    ext = jax.lax.dynamic_slice(iq_padded, (start, 0), (slice_len, 2))
    return decode_mags_block(magnitude_u16(ext), n_off, capacity)


def decode_capture_overlap(
    iq: np.ndarray,
    cfg: PipelineConfig = DEFAULT_CONFIG,
) -> tuple[list[tuple[int, int, bytes, bool]], dict]:
    """Decode a capture with the overlap-save decomposition (no frame loss).

    Every global offset in [0, len - WINDOW] is scanned exactly once: blocks
    of `block_len` each carry a halo of WINDOW-1 samples from the next block.
    Returns hits as (block_index, global_offset, frame_bytes, recovered).
    """
    prep = _prep_overlap(iq, cfg)
    if prep is None:
        return [], {"n_detections": 0, "n_good": 0, "overflow": False}
    return _overlap_scan(*prep, cfg)


def _prep_overlap(iq: np.ndarray, cfg: PipelineConfig):
    """Pad + upload a capture for the overlap scan; None if too short.

    Large blocks scan a 1024-aligned slice of exactly `block` samples
    with n_off = block - 1264, which keeps the offset count off a power
    of two; small blocks keep the classic halo form (block + 239). Both
    scan every offset exactly once, so the hit stream is the same.
    Returns (iq_dev, n, slice_len, scan, n_blocks) — iq_dev[:n] is the
    capture itself (the pad is non-detecting), so callers can reuse the
    single upload for extra passes like _count_chunked_detections.
    """
    block = cfg.block_len
    n = len(iq)
    if n < WINDOW:
        return None
    if block >= 4096:
        slice_len = block
        scan = block - 1264
    else:
        slice_len = block + WINDOW - 1
        scan = block
    n_blocks = -(-max(n - WINDOW + 1, 1) // scan)
    padded = pad_iq_non_detecting(
        np.asarray(iq), (n_blocks - 1) * scan + slice_len
    )
    return jnp.asarray(padded), n, slice_len, scan, n_blocks


def _overlap_scan(
    iq_dev: jnp.ndarray,
    n: int,
    slice_len: int,
    scan: int,
    n_blocks: int,
    cfg: PipelineConfig,
) -> tuple[list[tuple[int, int, bytes, bool]], dict]:
    # Offsets at the very end whose window would run past the capture are
    # invalid (the reference never scans them either).
    max_global = n - WINDOW

    hits = []
    stats = {"n_detections": 0, "n_good": 0, "n_recovered": 0, "overflow": False}
    for b in range(n_blocks):
        capacity = cfg.max_candidates
        out = jax.device_get(
            _decode_block_at(iq_dev, b * scan, slice_len, scan, capacity)
        )
        while bool(out["overflow"]) and capacity < scan:
            capacity = min(capacity * 4, scan)
            out = jax.device_get(
                _decode_block_at(iq_dev, b * scan, slice_len, scan, capacity)
            )
        for k in np.nonzero(out["good"])[0]:
            g = b * scan + int(out["offsets"][k])
            if g <= max_global:
                hits.append(
                    (b, g, out["frames"][k].tobytes(), bool(out["recovered"][k]))
                )
        stats["n_detections"] += int(out["n_detections"])
        stats["n_good"] += int(out["n_good"])
        stats["n_recovered"] += int(np.sum(out["recovered"]))
        stats["overflow"] |= bool(out["overflow"])
    return hits, stats


def _collect_hits(
    out: dict,
    to_global,
    blocks: np.ndarray | None = None,
    n_off: int | None = None,
    capacity: int | None = None,
) -> list[tuple[int, int, bytes, bool]]:
    """Collect ordered hits; re-decodes overflowed blocks adaptively when
    the raw blocks are provided (so capacity overflow never loses hits)."""
    hits = []
    n_blocks = out["offsets"].shape[0]
    overflow = np.asarray(out["overflow"])
    for b in range(n_blocks):
        if blocks is not None and bool(overflow[b]):
            blk_out = decode_iq_block_adaptive(blocks[b], n_off, capacity)
            good = blk_out["good"]
            offs = blk_out["offsets"]
            frames = blk_out["frames"]
            rec = blk_out["recovered"]
        else:
            good = np.asarray(out["good"][b])
            offs = np.asarray(out["offsets"][b])
            frames = np.asarray(out["frames"][b])
            rec = np.asarray(out["recovered"][b])
        for k in np.nonzero(good)[0]:
            blk, off = to_global(b, int(offs[k]))
            hits.append((blk, off, frames[k].tobytes(), bool(rec[k])))
    return hits


def _collect_stats(out: dict) -> dict:
    return {
        "n_detections": int(np.sum(out["n_detections"])),
        "n_good": int(np.sum(out["n_good"])),
        "n_recovered": int(np.sum(out["recovered"])),
        "overflow": bool(np.any(out["overflow"])),
    }


def hits_to_packets(
    hits: list[tuple[int, int, bytes, float | None]],
    time_processed: float | None = None,
) -> Iterator[AdsbPacket]:
    for _, _, frame, _ in hits:
        yield AdsbPacket.from_bytes(frame, time_processed)
