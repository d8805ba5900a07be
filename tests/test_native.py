"""Native C++ runtime tests: builds the library and checks every export
against the Python/golden implementations (a third independent decoder)."""

import numpy as np
import pytest

from airjax import golden
from airjax.io import synth
from airjax.io.c16 import load_c16, save_c16
from airjax.protocol import crc

native = pytest.importorskip("airjax.native")

try:
    native.get_lib()
    HAVE_NATIVE = True
except native.NativeUnavailable:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="no C++ toolchain")


def test_c16_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(-32768, 32768, size=(5000, 2), dtype=np.int16)
    p = tmp_path / "x.c16"
    native.save_c16(data, p)
    assert np.array_equal(native.load_c16(p), data)
    # interoperable with the Python codec
    assert np.array_equal(load_c16(p), data)
    p2 = tmp_path / "y.c16"
    save_c16(data, p2)
    assert np.array_equal(native.load_c16(p2), data)


def test_magnitude_matches_golden():
    rng = np.random.default_rng(1)
    iq = rng.integers(-32768, 32768, size=(100000, 2), dtype=np.int16)
    assert np.array_equal(native.magnitude(iq), golden.magnitude(iq))


def test_crc24_matches_reference_vector():
    data = bytes([0x8D, 0x40, 0x6B, 0x90, 0x20, 0x15, 0xA6, 0x78, 0xD4, 0xD2, 0x20])
    assert native.crc24(data) == 0xAA4BDA == crc.crc24(data)
    rng = np.random.default_rng(2)
    for _ in range(20):
        msg = rng.integers(0, 256, size=11, dtype=np.uint8).tobytes()
        assert native.crc24(msg) == crc.crc24(msg)


def test_decode_chunk_matches_golden():
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("NATIVE"))
    bad = synth.flip_bit(frame, 33)
    iq = synth.modulate([frame, bad], [300, 2000], 8000, snr_db=12.0, seed=3)
    native_hits, n_det = native.decode_chunk(iq)
    golden_hits = golden.decode_chunk(iq)
    assert [(o, p) for o, p, _ in native_hits] == golden_hits
    assert any(o == 2000 and p == frame and r for o, p, r in native_hits)
    assert n_det >= 2


def test_ring_buffer():
    ring = native.Ring(block_samples=1000, depth=2)
    a = np.ones((1000, 2), dtype=np.int16)
    b = np.full((500, 2), 2, dtype=np.int16)
    assert ring.push(a)
    assert ring.push(b)
    assert not ring.push(a)  # full -> backpressure
    assert len(ring) == 2
    got = ring.pop()
    assert np.array_equal(got, a)
    got2 = ring.pop()
    assert got2.shape == (500, 2) and np.all(got2 == 2)
    assert ring.pop() is None
    ring.close()


def test_native_extended_matches_golden_fuzz():
    """Native extended-mode scalar decoder vs the golden python oracle:
    identical (offset, kind, frame, icao_ap) streams on mixed-format
    noisy captures."""
    from airjax import golden
    from airjax.io import synth
    from airjax.native import decode_chunk_extended
    from airjax.protocol import shortframe

    rng = np.random.default_rng(99)
    icao = 0x7C6B30
    frames = [
        synth.make_df17(icao, synth.make_id_me("NATEXT_")),
        shortframe.make_df11(icao),
        shortframe.make_df4(icao, altitude_ft=7500, gillham=True),
        shortframe.make_df5(icao, squawk=7700),
        shortframe.make_df20(icao, altitude_ft=36000),
        shortframe.make_df21(icao, squawk=1200),
    ]
    for trial in range(6):
        offs = sorted(rng.choice(np.arange(4, 36) * 500, size=len(frames), replace=False))
        iq = synth.modulate(
            frames, [int(o) for o in offs], 20000,
            noise_std=float(rng.choice([0.0, 30.0, 80.0])), seed=trial,
        )
        g = golden.decode_chunk_extended(iq)
        n, ndet = decode_chunk_extended(iq)
        # golden returns icao_ap 0 for 'long'; native also writes 0 there.
        assert [(o, k, f, a) for o, k, f, a in g] == n, trial
        assert ndet >= len(g)


@pytest.mark.parametrize("state", ["missing", "stale"])
def test_ensure_built_rebuilds(state, tmp_path):
    """The library is not committed: native.py builds it from source when
    it is missing, and again when the source is newer than it."""
    import ctypes
    import os
    import shutil

    for name in ("airjax_native.cpp", "Makefile"):
        shutil.copy(native._NATIVE_DIR / name, tmp_path / name)
    lib = tmp_path / "libairjax_native.so"
    if state == "stale":
        lib.write_bytes(b"not a library")
        os.utime(lib, (1, 1))
    assert native.ensure_built(tmp_path) == lib
    loaded = ctypes.CDLL(str(lib))
    loaded.airjax_crc24.restype = ctypes.c_uint32
    msg = bytes(range(11))
    buf = (ctypes.c_uint8 * 11).from_buffer_copy(msg)
    assert loaded.airjax_crc24(buf, 11) == crc.crc24(msg)
    assert not list(tmp_path.glob(".*.tmp"))
