"""Vectorized preamble/DF17 detection and PPM bit-slicing.

The reference scans every sample offset with a scalar early-exit loop
(src/adsb.rs:98-116 -> src/adsb/demod.rs:17-57): an offset is a detection iff

  min(mag[i + h] for h in PREAMBLE_HIGHS) >= max(mag[i + l] for l in LOWS)
  and the same for the 10-sample DF=17 pattern at i+16..i+25,

and a detection's 112 bits come from the "relative" Manchester slicer
(src/adsb/demod.rs:92-131): bit_k = mag[i+16+2k] > mag[i+16+2k+1]. (That
slicer can never reject — a pair compare always yields a valid Manchester
pair — so the CRC is the only filter; the `errors > 2` bail is dead.)

Here the scan is a branch-free array program over all offsets at once:
26 shifted min/max/compare ops per offset, then a masked
compaction of detection offsets into a fixed-capacity candidate buffer, then
bit-slicing of just those K candidates. Static shapes throughout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Mode S preamble: highs/lows at half-us sample indices (demod.rs:23-24).
PREAMBLE_HIGHS = (0, 2, 7, 9)
PREAMBLE_LOWS = (1, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15)
# DF=17 pattern `10001` over the next 10 samples (demod.rs:45-46), +16 shift.
DF17_HIGHS = (16, 19, 21, 23, 24)
DF17_LOWS = (17, 18, 20, 22, 25)

WINDOW = 240  # 16 preamble + 224 data samples
DATA_OFFSET = 16
FRAME_SAMPLES = 224
FRAME_BITS = 112


def _shifted(mags: jnp.ndarray, shift: int, n_off: int) -> jnp.ndarray:
    return jax.lax.dynamic_slice_in_dim(mags, shift, n_off, axis=-1)


def detect(mags: jnp.ndarray, n_off: int) -> jnp.ndarray:
    """Detection mask over offsets [0, n_off) of a magnitude block.

    Args:
      mags: (..., L) uint32 magnitudes with L >= n_off + 25.
    Returns:
      (..., n_off) bool, True where the preamble + DF17 checks pass.
    """
    hmin = functools.reduce(
        jnp.minimum, (_shifted(mags, s, n_off) for s in PREAMBLE_HIGHS)
    )
    lmax = functools.reduce(
        jnp.maximum, (_shifted(mags, s, n_off) for s in PREAMBLE_LOWS)
    )
    dmin = functools.reduce(
        jnp.minimum, (_shifted(mags, s, n_off) for s in DF17_HIGHS)
    )
    dmax = functools.reduce(
        jnp.maximum, (_shifted(mags, s, n_off) for s in DF17_LOWS)
    )
    return (hmin >= lmax) & (dmin >= dmax)


COMPACT_TILE = 512


def detect_preamble_only(mags: jnp.ndarray, n_off: int) -> jnp.ndarray:
    """Preamble gate WITHOUT the DF17 pattern check (extension mode).

    The reference's detector only accepts DF17 (demod.rs:38-54); the
    extended decode mode accepts any Mode S downlink format, so the gate
    is the 16-sample preamble alone — downstream CRC/address checks do
    the filtering.
    """
    hmin = functools.reduce(
        jnp.minimum, (_shifted(mags, s, n_off) for s in PREAMBLE_HIGHS)
    )
    lmax = functools.reduce(
        jnp.maximum, (_shifted(mags, s, n_off) for s in PREAMBLE_LOWS)
    )
    return hmin >= lmax


def compact_detections(
    det: jnp.ndarray, max_candidates: int, tile: int = COMPACT_TILE
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compact a (n_off,) bool mask into ascending candidate offsets.

    Two-level gather-based compaction (no scatter, and no flat O(N)
    cumsum over the whole stream):
      1. per-tile detection counts (one reduction pass) + a tiny cumsum
         over the N/tile tile counts;
      2. binary-search the tile prefix for each rank, gather just the K
         candidate tiles, and locate the in-tile position with a small
         per-row cumsum + search.
    Returns (offsets (K,) int32 with invalid slots = n_off, valid (K,)
    bool, n_detections () int32). Detections beyond capacity are dropped
    (the count still reflects them, so callers can flag overflow).
    """
    n_off = det.shape[-1]
    n_tiles = -(-n_off // tile)
    padded = jnp.pad(det, (0, n_tiles * tile - n_off)).reshape(n_tiles, tile)
    row_counts = jnp.sum(padded, axis=1, dtype=jnp.int32)
    row_cum = jnp.cumsum(row_counts)
    row_start = row_cum - row_counts
    ranks = jnp.arange(1, max_candidates + 1, dtype=jnp.int32)
    row_idx = jnp.searchsorted(row_cum, ranks, side="left").astype(jnp.int32)
    safe_row = jnp.minimum(row_idx, n_tiles - 1)
    rows = padded[safe_row]  # (K, tile) — only candidate tiles are touched
    local_cum = jnp.cumsum(rows.astype(jnp.int32), axis=1)
    local_rank = ranks - row_start[safe_row]
    # Rank -> in-tile position via sum-compare rather than a vmapped
    # binary search: searchsorted(a, v) == sum(a < v) for sorted a, so a
    # dense (K, tile) compare+reduce replaces K while-loop searches.
    local_idx = jnp.sum(
        local_cum < local_rank[:, None], axis=1, dtype=jnp.int32
    )
    offsets = safe_row * tile + local_idx
    total = row_cum[-1]
    valid = ranks <= total
    offsets = jnp.where(valid, offsets, n_off)
    return offsets, valid, total


def slice_bits(mags: jnp.ndarray, offsets: jnp.ndarray) -> jnp.ndarray:
    """Bit-slice candidate windows: (L,) mags x (K,) offsets -> (K, 112) bits.

    bit_k = mag[o+16+2k] > mag[o+16+2k+1] (falling edge = 1), matching the
    reference's relative slicer + Manchester fold (demod.rs:92-131,180-201).
    Offsets must be in-range (clamp before calling).

    Direct gather formulation — simple but O(K*224) gathered elements; the
    production pipeline uses the packed-word path below (pack_cmp_words +
    slice_bits_packed), which gathers 8 words per candidate instead.
    """

    def one(offset):
        window = jax.lax.dynamic_slice(mags, (offset + DATA_OFFSET,), (FRAME_SAMPLES,))
        return (window[0::2] > window[1::2]).astype(jnp.uint8)

    return jax.vmap(one)(offsets)


def threshold_slice_bits(
    mags: jnp.ndarray, offsets: jnp.ndarray, high: jnp.ndarray, derate: float = 0.9
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's DEAD threshold slicer variant, for completeness.

    `extract_manchester_threshold` (demod.rs:142-173, #[allow(dead_code)],
    "Processed: 149, Good: 8" vs the relative slicer's 35) slices each
    half-bit against a derated `high` — the detector's already-derated
    min-preamble-high (check_for_adsb_packet returns u32(f32(min)*0.9),
    extract_packet derates once more by 0.9, demod.rs:56,66 — net ~0.81 of
    min_high) — and rejects a frame when more than 2 invalid (equal)
    Manchester pairs accumulate within any byte. Invalid pairs decode as
    bit 0 (the (0,0)/(1,1) symbol cases fall through, demod.rs:190-193).
    Kept out of the production pipeline — the reference author measured it
    strictly worse — but implemented and tested so the capability exists.

    Args:
      high: (K,) or scalar u32 — per-candidate detector high values.
    Returns (bits (K, 112) uint8, ok (K,) bool).
    """
    # Exact derate in u32: for every magnitude-range input x <= 46340*0.9,
    # trunc(f64(x) * 0.9_f64) == trunc(f32(x) * 0.9_f32) == x * 9 // 10.
    # Proof sketch: x*9/10 has fractional part in {0, .1, ..., .9}; the
    # float product's total error (|0.9_fXX - 0.9| * x + rounding, < 3e-3
    # for f32, < 5e-12 for f64) is far below the 0.1 gap to the next
    # integer, and at exact multiples of 10 the product rounds back onto
    # the integer because the representation error is under half an ulp.
    # So the reference's f64 derate (demod.rs:66) is reproduced exactly
    # without x64 mode. Non-tenth derates fall back to f32.
    high_b = jnp.broadcast_to(high, offsets.shape).astype(jnp.uint32)
    num = derate * 10.0
    if num == int(num):
        threshold = (high_b * jnp.uint32(int(num))) // jnp.uint32(10)
    else:  # pragma: no cover - no such derate in the reference
        threshold = (high_b.astype(jnp.float32) * derate).astype(jnp.uint32)

    def one(offset, thr):
        window = jax.lax.dynamic_slice(
            mags, (offset + DATA_OFFSET,), (FRAME_SAMPLES,)
        )
        first = window[0::2] > thr
        second = window[1::2] > thr
        valid = first != second
        bits = (first & valid).astype(jnp.uint8)
        # > 2 invalid pairs within any byte -> reject (errors reset per byte)
        per_byte = jnp.sum((~valid).reshape(14, 8), axis=1)
        return bits, jnp.all(per_byte <= 2)

    return jax.vmap(one)(offsets, threshold)


_WORDS_PER_CAND = 8  # ceil((31 + 223) / 32) — covers any 32-bit alignment


def pack_cmp_words(mags: jnp.ndarray) -> jnp.ndarray:
    """Precompute ALL pair-compare bits packed 32/word (MSB first).

    cmp[i] = mags[i] > mags[i+1] is computed once for every sample and
    packed by an integer reduction: the (N/32, 32) bit matrix times the
    powers of two 2^31..2^0, summed in uint32. Every product is a single
    bit of the word, so the sum is exact in any order; no float and no
    matmul precision is involved. Padded with _WORDS_PER_CAND zero words.

    On the H100 this measured faster than the earlier f32-matmul pack
    (which had to materialize the 0/1 operand as f32 for the GEMM), alone
    and inside the full-block decode (PERF.md).

    The cmp bits stay interleaved (data bits are extracted as every
    other bit downstream), so no stride-2 split of the stream is needed.
    """
    cmp = (mags[:-1] > mags[1:]).astype(jnp.uint32)
    n = cmp.shape[0]
    n_words = -(-n // 32)
    padded = jnp.pad(cmp, (0, n_words * 32 - n)).reshape(n_words, 32)
    weights = jnp.uint32(1) << jnp.arange(31, -1, -1, dtype=jnp.uint32)
    words = jnp.sum(padded * weights, axis=1, dtype=jnp.uint32)
    return jnp.pad(words, (0, _WORDS_PER_CAND))


def slice_bits_packed(words: jnp.ndarray, offsets: jnp.ndarray) -> jnp.ndarray:
    """(K,) offsets -> (K, 112) bits via 8 word gathers per candidate.

    Candidate bit t lives at cmp index o + 16 + 2t; the 112 bits span at
    most 8 consecutive 32-bit words, so slicing is a (K, 8) gather plus a
    branch-free 8-way select and variable shift.
    """
    d0 = offsets + DATA_OFFSET  # bit index of data bit 0 in the cmp stream
    word0 = d0 >> 5
    align = (d0 & 31).astype(jnp.uint32)  # (K,)

    j = jnp.arange(_WORDS_PER_CAND, dtype=jnp.int32)
    gathered = words[word0[:, None] + j[None, :]]  # (K, 8) uint32

    t = jnp.arange(FRAME_BITS, dtype=jnp.uint32)  # (112,)
    pos = align[:, None] + 2 * t[None, :]  # (K, 112) in [0, 253]
    word_sel = (pos >> 5).astype(jnp.int32)  # 0..7
    shift = 31 - (pos & 31)
    sel = jnp.zeros(pos.shape, dtype=jnp.uint32)
    for jj in range(_WORDS_PER_CAND):
        sel = jnp.where(word_sel == jj, gathered[:, jj : jj + 1], sel)
    return ((sel >> shift) & 1).astype(jnp.uint8)
