"""Exact |IQ| magnitude without float64.

The reference computes magnitude as f64 sqrt(re^2 + im^2) truncated to u32
(src/utils.rs:46-52). Every downstream decision is an integer comparison of
these truncated magnitudes, and the truncation collapses near-ties, so the
whole pipeline's bit-exactness hinges on reproducing it exactly.

trunc(f64_sqrt(s)) == isqrt(s) exactly for every integer s = re^2 + im^2
<= 2^31: the correctly-rounded f64 sqrt of s is within 0.5 ulp (~2^-37 at
46341) of the true root, while the closest a true root of a non-square
integer can come to an integer k is ~1/(2k) ~ 1e-5, so rounding can never
carry the value across an integer boundary. The device therefore computes
the exact integer square root from an f32 estimate and a one-step fixup:

  k0 = trunc(f32_sqrt(f32(s)))
  k  = k0 + 1 if (k0+1)^2 <= s else k0
  k  = k - 1  if k^2 > s         else k

The fixup is exact whenever k0 is within +-1 of isqrt(s). That holds for
any f32 sqrt within a few ulp: f32(s) is off by at most 2^7 for s <= 2^31,
which moves sqrt(s) by < 2^7 / (2 * 46340) < 0.002 at the top of the range
(and not at all for s < 2^24, where f32(s) is exact), and a few ulp of
46340 add < 0.02 more — far inside one integer step. The chip smoke test
(chip_smoke.py) checks every s in [0, 2^31] on the card; the CPU tests
check the fixup itself against estimates perturbed by +-1.

All arithmetic is uint32 (max (46342)^2 < 2^32) and fuses with the
downstream detector.
"""

from __future__ import annotations

import jax.numpy as jnp


def squared_magnitude_u32(iq: jnp.ndarray) -> jnp.ndarray:
    """(..., 2) int16 I/Q -> (...) uint32 re^2+im^2 (exact, max 2^31)."""
    re = iq[..., 0].astype(jnp.int32)
    im = iq[..., 1].astype(jnp.int32)
    # Each square <= 2^30 fits int32; the sum can be exactly 2^31 (both
    # -32768), so add in uint32.
    return (re * re).astype(jnp.uint32) + (im * im).astype(jnp.uint32)


def isqrt_u32(s: jnp.ndarray) -> jnp.ndarray:
    """Elementwise exact floor(sqrt(s)) for uint32 s <= 2^31."""
    return isqrt_fixup(s, jnp.sqrt(s.astype(jnp.float32)).astype(jnp.uint32))


def isqrt_fixup(s: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """floor(sqrt(s)) from an estimate k within +-1 of it (uint32 both)."""
    up = k + 1
    k = jnp.where(up * up <= s, up, k)
    k = jnp.where((k > 0) & (k * k > s), k - 1, k)
    return k


def magnitude_u32(iq: jnp.ndarray) -> jnp.ndarray:
    """(..., 2) int16 I/Q -> (...) uint32 magnitudes, bit-exact vs reference."""
    return isqrt_u32(squared_magnitude_u32(iq))


def magnitude_u16(iq: jnp.ndarray) -> jnp.ndarray:
    """(..., 2) int16 I/Q -> (...) uint16 magnitudes, bit-exact vs reference.

    The maximum magnitude is isqrt(2 * 32768^2) = 46340 < 2^16, so
    narrowing to u16 is lossless and every unsigned comparison downstream
    (the detector's >= stencil and the PPM pair compares) is identical to
    the u32 form — while halving the bytes of the magnitude write and of
    both stream-sized reads (detect + pack). The cast fuses into the
    isqrt pass; nothing u32 is ever materialized.
    """
    return isqrt_u32(squared_magnitude_u32(iq)).astype(jnp.uint16)
