"""ctypes bindings for the native C++ runtime (native/airjax_native.cpp).

Builds the shared library from native/airjax_native.cpp on first use (it
is not committed: it is compiled for the machine that loads it). Binding
is a plain C ABI through ctypes, so no binding library is needed.
Provides:

  * load_c16 / save_c16       — native capture IO
  * magnitude                 — reference-exact u32 magnitudes
  * crc24                     — table-driven Mode S CRC
  * decode_chunk              — reference-exact scalar decoder (the native
                                parity oracle / host fallback)
  * Ring                      — lock-free SPSC block ring buffer (bounded
                                native replacement for the reference's
                                mpsc channel, src/adsb.rs:131)
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_NAME = "libairjax_native.so"
_SRC_NAME = "airjax_native.cpp"
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def ensure_built(native_dir: pathlib.Path = _NATIVE_DIR) -> pathlib.Path:
    """Build `<native_dir>/libairjax_native.so` if missing or older than
    its source; returns its path.

    The build is native/Makefile's rule (built on the machine that loads
    it, so -march=native is safe). Safe to call from several processes at
    once (the test runner's workers all import this): the build holds an
    exclusive file lock and renames a finished library into place, so no
    process ever loads a half-written one.
    """
    import fcntl

    lib_path = native_dir / _LIB_NAME
    src = native_dir / _SRC_NAME

    def stale() -> bool:
        return not lib_path.exists() or (
            src.exists() and src.stat().st_mtime > lib_path.stat().st_mtime
        )

    if not stale():
        return lib_path
    if not src.exists():
        raise NativeUnavailable(f"missing {lib_path} and its source {src}")
    with open(native_dir / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if stale():  # another process may have built it meanwhile
            tmp = native_dir / f".{_LIB_NAME}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["make", "-s", "-C", str(native_dir), f"TARGET={tmp.name}",
                     tmp.name],
                    check=True, capture_output=True,
                )
                os.replace(tmp, lib_path)
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", b"")
                raise NativeUnavailable(
                    f"failed to build native library: {e} {detail!r}"
                ) from e
            finally:
                tmp.unlink(missing_ok=True)
    return lib_path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(ensure_built()))

        lib.airjax_load_c16.restype = ctypes.c_longlong
        lib.airjax_load_c16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ]
        lib.airjax_save_c16.restype = ctypes.c_int
        lib.airjax_save_c16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_longlong,
        ]
        lib.airjax_free.argtypes = [ctypes.c_void_p]
        lib.airjax_magnitude.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.airjax_crc24.restype = ctypes.c_uint32
        lib.airjax_crc24.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.airjax_decode_chunk.restype = ctypes.c_longlong
        lib.airjax_decode_chunk.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.airjax_decode_chunk_extended.restype = ctypes.c_longlong
        lib.airjax_decode_chunk_extended.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.airjax_decode_chunk_extended_r2.restype = ctypes.c_longlong
        lib.airjax_decode_chunk_extended_r2.argtypes = (
            lib.airjax_decode_chunk_extended.argtypes
        )
        lib.airjax_ring_create.restype = ctypes.c_void_p
        lib.airjax_ring_create.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
        lib.airjax_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.airjax_ring_push.restype = ctypes.c_int
        lib.airjax_ring_push.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_longlong,
        ]
        lib.airjax_ring_pop.restype = ctypes.c_longlong
        lib.airjax_ring_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16)]
        lib.airjax_ring_size.restype = ctypes.c_longlong
        lib.airjax_ring_size.argtypes = [ctypes.c_void_p]

        _lib = lib
        return lib


def _i16_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def load_c16(path: str | os.PathLike) -> np.ndarray:
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_int16)()
    n = lib.airjax_load_c16(str(path).encode(), ctypes.byref(out))
    if n < 0:
        raise ValueError(f"couldn't load c16 file {path}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(int(n), 2)).copy()
    finally:
        lib.airjax_free(out)
    return arr


def save_c16(data: np.ndarray, path: str | os.PathLike) -> None:
    lib = get_lib()
    arr = np.ascontiguousarray(data, dtype=np.int16)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"expected (N, 2) I/Q array, got {arr.shape}")
    if lib.airjax_save_c16(str(path).encode(), _i16_ptr(arr), arr.shape[0]) != 0:
        raise OSError(f"couldn't save c16 file {path}")


def magnitude(iq: np.ndarray) -> np.ndarray:
    lib = get_lib()
    arr = np.ascontiguousarray(iq, dtype=np.int16)
    out = np.empty(arr.shape[0], dtype=np.uint32)
    lib.airjax_magnitude(
        _i16_ptr(arr), arr.shape[0], out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    )
    return out


def crc24(data: bytes) -> int:
    lib = get_lib()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return int(lib.airjax_crc24(buf, len(data)))


def decode_chunk(
    iq: np.ndarray, max_hits: int = 4096
) -> tuple[list[tuple[int, bytes, bool]], int]:
    """Reference-exact scalar decode of one chunk -> (hits, n_detections)."""
    lib = get_lib()
    arr = np.ascontiguousarray(iq, dtype=np.int16)
    offsets = np.empty(max_hits, dtype=np.int64)
    packets = np.empty(max_hits * 14, dtype=np.uint8)
    recovered = np.empty(max_hits, dtype=np.uint8)
    n_det = ctypes.c_longlong(0)
    n = lib.airjax_decode_chunk(
        _i16_ptr(arr),
        arr.shape[0],
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        packets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        recovered.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_hits,
        ctypes.byref(n_det),
    )
    hits = [
        (int(offsets[i]), packets[14 * i : 14 * (i + 1)].tobytes(), bool(recovered[i]))
        for i in range(int(n))
    ]
    return hits, int(n_det.value)


_EXT_KINDS = ("long", "df11", "short_ap", "long_ap", "df11_ic", "long2")


def decode_chunk_extended(
    iq: np.ndarray, max_hits: int = 4096, recover2: bool = False
) -> tuple[list[tuple[int, str, bytes, int]], int]:
    """Extended-mode scalar decode (native tier of the oracle chain).

    Returns (hits, n_detections) where hits are (offset, kind,
    frame_bytes, icao_ap) in scan order — the same shape as
    airjax.golden.decode_chunk_extended (short-frame kinds carry 7 frame
    bytes, long kinds 14). recover2=True classifies unique-2-flip
    repairs as kind 'long2' (pre-gate), mirroring
    golden.decode_chunk_extended(recover2=True).
    """
    lib = get_lib()
    arr = np.ascontiguousarray(iq, dtype=np.int16)
    offsets = np.empty(max_hits, dtype=np.int64)
    kinds = np.empty(max_hits, dtype=np.uint8)
    packets = np.empty(max_hits * 14, dtype=np.uint8)
    icao_ap = np.empty(max_hits, dtype=np.uint32)
    recovered = np.empty(max_hits, dtype=np.uint8)
    n_det = ctypes.c_longlong(0)
    fn = (
        lib.airjax_decode_chunk_extended_r2
        if recover2
        else lib.airjax_decode_chunk_extended
    )
    n = fn(
        _i16_ptr(arr),
        arr.shape[0],
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        packets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        icao_ap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        recovered.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_hits,
        ctypes.byref(n_det),
    )
    hits = []
    for i in range(int(n)):
        kind = _EXT_KINDS[int(kinds[i])]
        nbytes = 14 if kind in ("long", "long2", "long_ap") else 7
        hits.append(
            (
                int(offsets[i]),
                kind,
                packets[14 * i : 14 * i + nbytes].tobytes(),
                int(icao_ap[i]),
            )
        )
    return hits, int(n_det.value)


class Ring:
    """Bounded lock-free SPSC ring of fixed-size IQ blocks."""

    def __init__(self, block_samples: int, depth: int = 8):
        self._lib = get_lib()
        self._block = block_samples
        self._handle = self._lib.airjax_ring_create(block_samples, depth)
        if not self._handle:
            raise NativeUnavailable("ring allocation failed")

    def push(self, iq: np.ndarray) -> bool:
        arr = np.ascontiguousarray(iq, dtype=np.int16)
        return bool(self._lib.airjax_ring_push(self._handle, _i16_ptr(arr), arr.shape[0]))

    def pop(self) -> np.ndarray | None:
        out = np.empty((self._block, 2), dtype=np.int16)
        n = self._lib.airjax_ring_pop(self._handle, _i16_ptr(out))
        if n < 0:
            return None
        return out[: int(n)]

    def __len__(self) -> int:
        return int(self._lib.airjax_ring_size(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.airjax_ring_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
