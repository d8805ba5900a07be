"""Mode S CRC-24 as GF(2) linear algebra, batched on the device.

The reference (src/adsb/crc.rs:10-40) computes the CRC by bit-serial long
division with generator 0x1FFF409 over the first 88 bits of a 112-bit frame
padded with 24 zero bits, and recovers single-bit errors by brute-force
flipping each of the 112 bits and recomputing the CRC (src/adsb/crc.rs:49-65,
O(112 x CRC) per failed packet).

CRC over GF(2) is linear in the message bits, so the batched formulation
is a single (N, 88) @ (88, 24) integer matmul followed by a parity reduction:
  crc(bits) = XOR_{i: bits[i]=1} crc(e_i)
where e_i is the i-th unit message. Single-bit recovery reduces to one table
lookup: flipping message bit j changes the computed CRC by the constant
syndrome S_j = crc(e_j), so a failed frame is recoverable iff
  calced_crc XOR packet_crc  ==  S_j   for some j < 88.
Flips inside the CRC field itself (j >= 88) can never validate in the
reference either, because it compares against the *original* packet CRC
(src/adsb/crc.rs:56-58) — so restricting the search to j < 88 is exact.
Syndromes of a proper CRC-24 are pairwise distinct, so at most one j matches
and "first match in byte/bit scan order" == "the unique match".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

GENERATOR = 0x1FFF409  # 25-bit polynomial (src/adsb/crc.rs:11)
CRC_BITS = 24
DATA_BITS = 88  # 11 bytes covered by the CRC
FRAME_BITS = 112
FRAME_BYTES = 14


def crc24(data: bytes | list[int] | np.ndarray) -> int:
    """Scalar bit-serial reference CRC (mirrors src/adsb/crc.rs:10-40).

    Used to build the GF(2) matrix and as an independent oracle in tests.
    """
    bits = []
    for byte in bytes(data):
        for i in range(7, -1, -1):
            bits.append((byte >> i) & 1)
    bits.extend([0] * CRC_BITS)

    for i in range(len(bits) - CRC_BITS):
        if bits[i]:
            for j in range(CRC_BITS + 1):
                bits[i + j] ^= (GENERATOR >> (CRC_BITS - j)) & 1

    remainder = 0
    for i in range(CRC_BITS):
        remainder = (remainder << 1) | bits[len(bits) - CRC_BITS + i]
    return remainder


@functools.cache
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(crc_matrix (88,24) uint8, syndromes (88,) uint32).

    crc_matrix[j] = bit vector (MSB first) of crc24 of the 11-byte message
    with only bit j set; syndromes[j] = the same packed as an integer.
    """
    matrix = np.zeros((DATA_BITS, CRC_BITS), dtype=np.uint8)
    syndromes = np.zeros((DATA_BITS,), dtype=np.uint32)
    for j in range(DATA_BITS):
        msg = bytearray(DATA_BITS // 8)
        msg[j // 8] = 1 << (7 - j % 8)
        s = crc24(bytes(msg))
        syndromes[j] = s
        for k in range(CRC_BITS):
            matrix[j, k] = (s >> (CRC_BITS - 1 - k)) & 1
    return matrix, syndromes


def crc_matrix() -> np.ndarray:
    return _tables()[0]


def syndromes() -> np.ndarray:
    return _tables()[1]


def pack_bits_msbfirst(bits: jnp.ndarray, width: int) -> jnp.ndarray:
    """Pack a trailing axis of {0,1} bits (MSB first) into one integer."""
    weights = (1 << jnp.arange(width - 1, -1, -1, dtype=jnp.uint32)).astype(
        jnp.uint32
    )
    return jnp.sum(bits.astype(jnp.uint32) * weights, axis=-1, dtype=jnp.uint32)


def crc24_batch(bits88: jnp.ndarray) -> jnp.ndarray:
    """Batched CRC of (..., 88) {0,1} bit arrays -> (...,) uint32.

    One int32 matmul + parity + pack. The column sums are at most 88, so
    the integer dot is exact in any summation order. cuBLAS has no s32
    GEMM; on the H100 XLA emits this as its own fusion, and chip_smoke.py
    checks it bit-exact against the native table CRC (an int8 form with
    int32 accumulation measured no faster there, PERF.md).
    """
    matrix = jnp.asarray(crc_matrix(), dtype=jnp.int32)
    sums = jnp.matmul(
        bits88.astype(jnp.int32), matrix, preferred_element_type=jnp.int32
    )
    return pack_bits_msbfirst(sums & 1, CRC_BITS)


def crc_check_and_recover(
    bits112: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched CRC filter with single-bit-flip recovery.

    Args:
      bits112: (N, 112) {0,1} frame bits, MSB-first within each byte.

    Returns:
      (corrected_bits (N, 112), good (N,) bool, recovered (N,) bool)
      `good` marks frames whose CRC validated directly or after recovering a
      unique single-bit flip in the 88 data bits; `corrected_bits` has that
      flip applied (and equals the input where no recovery happened).
    """
    calced = crc24_batch(bits112[..., :DATA_BITS])
    packet_crc = pack_bits_msbfirst(bits112[..., DATA_BITS:], CRC_BITS)
    delta = calced ^ packet_crc

    ok = delta == 0
    table = jnp.asarray(syndromes(), dtype=jnp.uint32)  # (88,)
    match = delta[..., None] == table  # (N, 88)
    found = jnp.any(match, axis=-1) & ~ok
    # Unique match (distinct syndromes); pad to 112 so no flip in CRC field.
    flip = jnp.pad(match, [(0, 0)] * (match.ndim - 1) + [(0, CRC_BITS)])
    corrected = jnp.where(
        found[..., None], bits112 ^ flip.astype(bits112.dtype), bits112
    )
    return corrected, ok | found, found


@functools.cache
def _pair_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pairwise-flip syndrome table for 2-bit recovery (opt-in yield
    improvement): syndromes of flipping data bits
    (i, j), i < j < 88 — (3828,) uint32 plus the (i, j) index arrays.

    Uniqueness: a collision S_i^S_j == S_k^S_l between distinct pairs
    would imply a weight-4 codeword; the Mode S CRC-24 has minimum
    distance 6 at 112 bits, so pair syndromes are pairwise distinct AND
    disjoint from the single-bit table (weight-3 codewords would be
    needed) — asserted at build time.
    """
    s = syndromes().astype(np.uint32)
    i, j = np.triu_indices(DATA_BITS, k=1)
    pair = s[i] ^ s[j]
    assert len(np.unique(pair)) == len(pair), "pair syndrome collision"
    assert not np.intersect1d(pair, s).size, "pair/single syndrome overlap"
    assert not np.any(pair == 0)
    return pair, i.astype(np.int32), j.astype(np.int32)


def crc_check_and_recover2(
    bits112: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched CRC filter with single- AND double-bit-flip recovery.

    Beyond-parity extension (the reference recovers single flips only,
    src/adsb/crc.rs:49-65). Returns (corrected (N,112), good (N,) —
    direct | 1-flip | 2-flip, recovered (N,) 1-flip, recovered2 (N,)
    2-flip). The 2-flip repair is syndrome-unique (see _pair_tables),
    but a ≥3-bit error CAN sit within distance 2 of a *different*
    codeword (minimum distance 6), so callers MUST gate acceptance of
    `recovered2` frames on out-of-band evidence — the stream runner
    requires the repaired ICAO to have been seen in a clean/1-flip
    frame first (airjax.runner), mirroring the AP-address cache gate.
    """
    corrected, good, recovered = crc_check_and_recover(bits112)
    calced = crc24_batch(bits112[..., :DATA_BITS])
    packet_crc = pack_bits_msbfirst(bits112[..., DATA_BITS:], CRC_BITS)
    delta = calced ^ packet_crc
    pair, pi, pj = _pair_tables()
    match = delta[..., None] == jnp.asarray(pair)  # (N, 3828)
    found2 = jnp.any(match, axis=-1) & ~good
    idx = jnp.argmax(match, axis=-1)
    fi = jnp.asarray(pi)[idx]
    fj = jnp.asarray(pj)[idx]
    pos = jnp.arange(FRAME_BITS)
    flip = (pos == fi[..., None]) | (pos == fj[..., None])
    corrected = jnp.where(
        found2[..., None], bits112 ^ flip.astype(bits112.dtype), corrected
    )
    return corrected, good | found2, recovered, found2


def bytes_to_bits(frame_bytes: np.ndarray | bytes) -> np.ndarray:
    """(..., 14) uint8 -> (..., 112) {0,1} uint8, MSB first (host helper)."""
    arr = np.frombuffer(bytes(frame_bytes), dtype=np.uint8) if isinstance(
        frame_bytes, (bytes, bytearray)
    ) else np.asarray(frame_bytes, dtype=np.uint8)
    return np.unpackbits(arr, axis=-1)


def bits_to_bytes(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., 112) {0,1} -> (..., 14) uint8, MSB first (works under jit)."""
    shaped = bits.reshape(bits.shape[:-1] + (FRAME_BYTES, 8)).astype(jnp.uint32)
    weights = (1 << jnp.arange(7, -1, -1, dtype=jnp.uint32)).astype(jnp.uint32)
    return jnp.sum(shaped * weights, axis=-1, dtype=jnp.uint32).astype(jnp.uint8)


def try_crc_recovery2_scalar(frame: bytes) -> bytes | None:
    """Scalar 2-bit-flip repair (oracle for crc_check_and_recover2).

    Uses the same pairwise syndrome table as the device path; returns
    the repaired 14-byte frame, or None when the syndrome matches no
    data-bit pair. Callers gate acceptance exactly like the device
    consumers (a >=3-bit error can alias to a different codeword)."""
    packet_crc = (frame[-3] << 16) | (frame[-2] << 8) | frame[-1]
    delta = crc24(frame[:11]) ^ packet_crc
    pair, pi, pj = _pair_tables()
    hit = np.nonzero(pair == delta)[0]
    if not hit.size:
        return None
    i, j = int(pi[hit[0]]), int(pj[hit[0]])
    buf = bytearray(frame)
    buf[i // 8] ^= 1 << (7 - i % 8)
    buf[j // 8] ^= 1 << (7 - j % 8)
    return bytes(buf)


def try_crc_recovery_scalar(frame: bytes) -> bytes | None:
    """Scalar oracle mirroring src/adsb/crc.rs:49-65 (tests only)."""
    buf = bytearray(frame)
    packet_crc = (buf[-3] << 16) | (buf[-2] << 8) | buf[-1]
    for num in range(len(buf)):
        for i in range(8):
            augmented = bytearray(buf)
            augmented[num] ^= 1 << (7 - i)
            if crc24(bytes(augmented[:-3])) == packet_crc:
                return bytes(augmented)
    return None
