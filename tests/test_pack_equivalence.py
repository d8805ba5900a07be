"""Regression guards for the compute-path formulations.

The production pipeline uses u16 magnitudes and an integer-reduce bit
pack; these must stay bit-identical to the u32 magnitudes and to
np.packbits of the pair-compare bits forever (the parity oracle chain
depends on it).
"""

import jax.numpy as jnp
import numpy as np

from airjax.dsp.demod import pack_cmp_words
from airjax.dsp.magnitude import magnitude_u16, magnitude_u32


def _random_iq(rng, n):
    return rng.integers(-32768, 32768, size=(n, 2)).astype(np.int16)


def test_magnitude_u16_lossless():
    rng = np.random.default_rng(0)
    iq = _random_iq(rng, 50000)
    # Extremes: the maximum-magnitude corner and near-tie small values.
    iq[:4] = [[-32768, -32768], [32767, 32767], [0, 0], [1, 0]]
    m32 = np.asarray(magnitude_u32(jnp.asarray(iq)))
    m16 = np.asarray(magnitude_u16(jnp.asarray(iq)))
    assert m16.dtype == np.uint16
    assert int(m32.max()) == 46340 == int(m16.max())  # isqrt(2^31)
    np.testing.assert_array_equal(m32, m16.astype(np.uint32))


def test_pack_matches_packbits():
    rng = np.random.default_rng(1)
    for n in (63, 64, 65, 4096, 20000):
        mags = rng.integers(0, 1 << 16, size=n).astype(np.uint16)
        words = np.asarray(pack_cmp_words(jnp.asarray(mags)))
        packed = np.packbits(mags[:-1] > mags[1:])
        packed = np.pad(packed, (0, -len(packed) % 4)).view(">u4")
        # One word per 32 compare bits, then 8 zero guard words.
        assert len(words) == len(packed) + 8
        np.testing.assert_array_equal(words[: len(packed)], packed)
        assert not words[len(packed):].any()


def test_pack_matches_scalar_bits():
    rng = np.random.default_rng(2)
    mags = rng.integers(0, 200, size=1000).astype(np.uint16)
    words = np.asarray(pack_cmp_words(jnp.asarray(mags)))
    cmp = (mags[:-1] > mags[1:]).astype(np.uint32)
    for p in rng.integers(0, len(cmp), size=200):
        bit = (words[p >> 5] >> (31 - (p & 31))) & 1
        assert bit == cmp[p], p
