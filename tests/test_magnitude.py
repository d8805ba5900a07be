"""Exact magnitude parity: isqrt formulation vs the reference's
trunc(f64 sqrt(re^2+im^2)) (src/utils.rs:46-52)."""

import numpy as np
import jax.numpy as jnp
import pytest

from airjax.dsp.magnitude import isqrt_fixup, isqrt_u32, magnitude_u32


def _reference_mag(iq: np.ndarray) -> np.ndarray:
    re = iq[:, 0].astype(np.float64)
    im = iq[:, 1].astype(np.float64)
    return np.sqrt(re * re + im * im).astype(np.uint32)


def test_random_parity():
    rng = np.random.default_rng(42)
    iq = rng.integers(-32768, 32768, size=(100_000, 2), dtype=np.int16)
    ours = np.asarray(magnitude_u32(jnp.asarray(iq)))
    assert np.array_equal(ours, _reference_mag(iq))


def test_extremes():
    iq = np.array(
        [
            [-32768, -32768],  # s = 2^31 exactly
            [32767, 32767],
            [-32768, 0],
            [0, 0],
            [1, 0],
            [3, 4],
            [-3, -4],
        ],
        dtype=np.int16,
    )
    ours = np.asarray(magnitude_u32(jnp.asarray(iq)))
    assert np.array_equal(ours, _reference_mag(iq))
    assert ours[3] == 0 and ours[5] == 5


def test_perfect_squares_boundary():
    # Values straddling integer sqrt boundaries: k^2-1, k^2, k^2+1
    ks = np.array([1, 2, 255, 256, 46340, 46341], dtype=np.uint64)
    s = np.concatenate([ks * ks - 1, ks * ks, ks * ks + 1]).astype(np.uint32)
    ours = np.asarray(isqrt_u32(jnp.asarray(s)))
    expect = np.sqrt(s.astype(np.float64)).astype(np.uint32)
    assert np.array_equal(ours, expect)


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_isqrt_fixup_exact_within_one(delta):
    """The fixup turns any estimate within +-1 of the root into the exact
    floor(sqrt(s)): checked at every perfect square and its neighbours up
    to 2^31 (where roots change, so where an estimate can be off)."""
    k = np.arange(0, 46341, dtype=np.uint64)
    s = np.concatenate([k * k - 1, k * k, k * k + 1, [1 << 31]])
    s = s[(s <= (1 << 31)) & (s < (1 << 63))].astype(np.uint32)
    root = np.floor(np.sqrt(s.astype(np.float64))).astype(np.int64)
    est = np.maximum(root + delta, 0).astype(np.uint32)
    got = np.asarray(isqrt_fixup(jnp.asarray(s), jnp.asarray(est)))
    np.testing.assert_array_equal(got, root.astype(np.uint32))
