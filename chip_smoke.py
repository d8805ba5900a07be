"""Run airjax's decode path on the GPU and check it against the oracles.

Usage:
  python chip_smoke.py              # one card: phases device..stream
  python chip_smoke.py --devices 4  # only the multi-card phase, on 4 cards

Everything runs in this one process (a second JAX process could not get
the card's memory); the CLI is driven through `airjax.cli.main` in-process.
Phases, each printing what it found on lines of its own:

  device   platform, device_kind, count, nvidia-smi name and power limit
  isqrt    isqrt_u32 over every s in [0, 2^31]; mismatches must be 0
  kernels  at one 2^24 + 1024-sample block: magnitudes against the native
           decoder's, pack_cmp_words against np.packbits, the long and
           short CRC matmuls against the native table CRC, and the memory
           analysis of the full-block decode
  decode   the same block through decode_iq_block and
           decode_iq_block_extended (with and without recover2), hit
           lists byte-identical to the native decoder's; decode_iq_block_r2
           against golden on a 2M-sample slice; 20-iteration three-way
           fuzz slices (golden == native == device)
  stream   a seeded 60 s, 2 MS/s capture replayed through
           `airjax adsb --playback FILE --fast` (plain, --extended,
           --recover2) and through run_stream into a BatchTracker; frames
           equal to the native decoder's on the same samples
  devices  (--devices N only) dryrun_multichip(N), run_stream_sharded on
           N cards against run_stream on one, decode_channels over N cards

Any failed phase makes the exit code non-zero. The last line of a run in
which every phase passed is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Scratch files (the capture, JSONL outputs) go to <repo>/.smoke and are
removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / ".smoke"


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What each phase runs at. FULL is what users run; the CPU tests
    rehearse the same code at TINY."""

    isqrt_hi: int = 1 << 31  # inclusive
    isqrt_chunk: int = 1 << 27
    block: int = (1 << 24) + 1024  # bench.py's block: 2^24 + 1024 halo
    crc_frames: int = 8192
    golden_slice: int = 2_000_000
    fuzz_iters: int = 20
    stream_seconds: float = 60.0
    channel_samples: int = 1 << 22


FULL = Sizes()
TINY = Sizes(
    isqrt_hi=(1 << 20) + 7, isqrt_chunk=1 << 18, block=(1 << 15) + 1024,
    crc_frames=4096, golden_slice=20_000, fuzz_iters=2,
    stream_seconds=0.3, channel_samples=1 << 14,
)
SAMPLE_RATE = 2_000_000
CHUNK = 20_000  # the receiver's block, src/adsb.rs:78


def phase_plan(argv=None) -> tuple[list[str], int | None]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="run only the multi-card phase, on the first N cards",
    )
    args = p.parse_args(argv)
    if args.devices is not None:
        return ["devices"], args.devices
    return ["device", "isqrt", "kernels", "decode", "stream"], None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def native_hits_through(iq: np.ndarray, extended: bool = False, **kw):
    """Native decode of every offset o <= len(iq) - 240.

    The native scan (like the reference) covers o < len - 240; the
    overlap-save runners also scan o = len - 240, whose window ends at the
    last sample. One appended sample adds exactly that offset and changes
    no window that ends inside `iq`.
    """
    from airjax import native

    ext = np.concatenate([iq, np.zeros((1, 2), np.int16)])
    fn = native.decode_chunk_extended if extended else native.decode_chunk
    hits, _ = fn(ext, max_hits=max(4096, len(iq) // 256), **kw)
    return hits


def bench_block(n: int, seed: int = 0):
    """bench.py's workload: ~1 frame per 16k samples, noise_std 60."""
    import bench

    blocks, n_frames = bench.build_workload(n - 1024, 1, seed=seed)
    return blocks[0], n_frames


def stream_capture(seconds: float, seed: int = 0) -> np.ndarray:
    """A seeded receiver stream with synthetic_blocks' traffic: two DF17
    frames (identification / airborne position, three aircraft) in every
    20,000-sample block, noise_std 60. Made on the device."""
    from airjax.io import synth

    n_blocks = max(2, int(seconds * SAMPLE_RATE) // CHUNK)
    rng = np.random.default_rng(seed)
    icaos = (0x7C6B30, 0x40621D, 0xC82B10)
    pool = []
    for j in range(600):
        if j % 2 == 0:
            me = synth.make_id_me("SYN" + str(100 + j % 900))
        else:
            me = synth.make_position_me(
                tc=11, altitude_ft=10000 + 25 * (j % 100),
                cpr_lat=int(rng.integers(0, 1 << 17)),
                cpr_lon=int(rng.integers(0, 1 << 17)), odd=bool(j % 4 == 1),
            )
        pool.append(synth.make_df17(icaos[j % 3], me))
    frames, offsets = [], []
    for b in range(n_blocks):
        for k in range(2):
            frames.append(pool[(2 * b + k) % len(pool)])
            offsets.append(b * CHUNK + 100 + k * (CHUNK // 2))
    iq = synth.modulate_device(frames, offsets, n_blocks * CHUNK, seed=seed)
    return np.asarray(iq)


def played_samples(n: int) -> int:
    """Samples `adsb --playback` replays (the tail, including the final
    full chunk, is dropped like the reference's playback)."""
    from airjax.pipeline import reference_chunk_count

    return reference_chunk_count(n, CHUNK) * CHUNK


def _count_files(path: pathlib.Path) -> int:
    return sum(1 for f in path.rglob("*") if f.is_file()) if path.is_dir() else 0


def _timed(label: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"  {label}: {time.perf_counter() - t0:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(sizes: Sizes = FULL) -> None:
    from airjax.device import describe

    info = describe()
    print(f"  jax: {info}")
    check(info["platform"] == "gpu", f"not a GPU: {info}")
    _print_cards()


def _print_cards() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(f"  nvidia-smi: {line.strip()}")


def phase_isqrt(sizes: Sizes = FULL) -> None:
    import functools

    import jax
    import jax.numpy as jnp

    from airjax.dsp.magnitude import isqrt_u32

    @functools.partial(jax.jit, static_argnames="n")
    def mismatches(base, hi, n):
        s = base + jax.lax.iota(jnp.uint32, n)
        k = isqrt_u32(s)
        # k <= 46340 for s <= 2^31, so (k+1)^2 < 2^32 cannot overflow.
        ok = (k * k <= s) & ((k + 1) * (k + 1) > s)
        live = s <= hi
        return jnp.sum(live & ~ok, dtype=jnp.int32), jnp.max(jnp.where(live, k, 0))

    bad, kmax, base = 0, 0, 0
    hi = jnp.uint32(sizes.isqrt_hi)
    while base <= sizes.isqrt_hi:
        b, k = mismatches(jnp.uint32(base), hi, sizes.isqrt_chunk)
        bad += int(b)
        kmax = max(kmax, int(k))
        base += sizes.isqrt_chunk
    print(f"  isqrt_u32 over [0, {sizes.isqrt_hi}]: {bad} mismatches "
          f"(max root {kmax}), tolerance 0")
    check(bad == 0, f"{bad} isqrt mismatches")


def phase_kernels(sizes: Sizes = FULL) -> None:
    import jax
    import jax.numpy as jnp

    from airjax import native
    from airjax.dsp.demod import WINDOW, pack_cmp_words
    from airjax.dsp.magnitude import magnitude_u16
    from airjax.pipeline import decode_iq_block
    from airjax.protocol.crc import crc24_batch
    from airjax.protocol.shortframe import crc24_short_batch

    iq, _ = bench_block(sizes.block)
    iq_host = np.asarray(iq)
    mags = jax.jit(magnitude_u16)(iq)
    m_host = np.asarray(mags)
    ref = native.magnitude(iq_host)
    n_bad = int(np.sum(m_host.astype(np.uint32) != ref))
    print(f"  magnitude_u16 vs native, {len(ref)} samples: {n_bad} mismatches")
    check(n_bad == 0, "magnitudes differ from the native decoder's")

    words = np.asarray(jax.jit(pack_cmp_words)(mags))
    cmp = m_host[:-1] > m_host[1:]
    packed = np.packbits(cmp)
    packed = np.pad(packed, (0, -len(packed) % 4)).view(">u4").astype(np.uint32)
    n_bad = int(np.sum(words[: len(packed)] != packed))
    print(f"  pack_cmp_words (integer reduce) vs np.packbits, {len(packed)} words: "
          f"{n_bad} mismatches, {int(np.count_nonzero(words[len(packed):]))} "
          "nonzero pad words")
    check(n_bad == 0 and not words[len(packed):].any(), "bit-pack differs")

    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (sizes.crc_frames, 14), dtype=np.uint8)
    bits = jnp.asarray(np.unpackbits(frames, axis=1))
    long_dev = np.asarray(jax.jit(crc24_batch)(bits[:, :88]))
    short_dev = np.asarray(jax.jit(crc24_short_batch)(bits[:, :32]))
    long_ref = np.array([native.crc24(f[:11].tobytes()) for f in frames])
    short_ref = np.array([native.crc24(f[:4].tobytes()) for f in frames])
    n_long = int(np.sum(long_dev != long_ref))
    n_short = int(np.sum(short_dev != short_ref))
    print(f"  crc24_batch / crc24_short_batch vs native.crc24, "
          f"{sizes.crc_frames} frames: {n_long} / {n_short} mismatches")
    check(n_long == 0 and n_short == 0, "CRC matmul differs")

    n_off = sizes.block - WINDOW
    compiled = decode_iq_block.lower(iq, n_off=n_off, capacity=4096).compile()
    ma = compiled.memory_analysis()
    fields = {
        k: getattr(ma, k) for k in dir(ma)
        if k.endswith("_in_bytes") and not k.startswith("_")
    }
    print(f"  decode_iq_block({sizes.block} samples) memory_analysis: {fields}")


def _parity_hits(out) -> list:
    return [
        (int(out["offsets"][k]), out["frames"][k].tobytes(),
         bool(out["recovered"][k]))
        for k in np.nonzero(out["good"])[0]
    ]


def phase_decode(sizes: Sizes = FULL) -> None:
    import jax
    import jax.numpy as jnp

    from airjax import golden, native
    from airjax.dsp.demod import WINDOW
    from airjax.pipeline import decode_iq_block, decode_iq_block_r2
    from tools import fuzz_extended, fuzz_parity

    iq, n_frames = bench_block(sizes.block)
    iq_host = np.asarray(iq)
    n_off = sizes.block - WINDOW

    def adaptive(fn, x, n, capacity):
        out = jax.device_get(fn(x, n, capacity))
        while bool(out["overflow"]) and capacity < n:
            capacity = min(capacity * 4, n)
            out = jax.device_get(fn(x, n, capacity))
        return out

    def full_block():
        return jax.block_until_ready(decode_iq_block(iq, n_off, 4096))

    _timed("decode_iq_block first call (compile or cache load, run)", full_block)
    _timed("decode_iq_block second call (run)", full_block)
    dev = _parity_hits(adaptive(decode_iq_block, iq, n_off, 4096))
    nat, _ = _timed("native.decode_chunk", native.decode_chunk, iq_host,
                    max_hits=1 << 16)
    print(f"  parity: {len(dev)} device hits, {len(nat)} native hits "
          f"({n_frames} frames embedded)")
    check(dev == nat, "parity hits differ from the native decoder's")
    check(len(dev) >= n_frames, "frames lost")

    for r2 in (False, True):
        dev = _timed(f"extended recover2={r2} device",
                     fuzz_extended.device_classified, iq_host, recover2=r2,
                     capacity=1 << 14)
        nat, _ = native.decode_chunk_extended(
            iq_host, max_hits=1 << 18, recover2=r2
        )
        kinds = sorted({h[1] for h in dev})
        print(f"  extended recover2={r2}: {len(dev)} device hits {kinds}, "
              f"{len(nat)} native hits")
        check(dev == nat, f"extended(recover2={r2}) differs from native")

    sl = iq_host[: sizes.golden_slice]
    n2 = len(sl) - WINDOW
    dev = [(o, f) for o, f, _ in
           _parity_hits(adaptive(decode_iq_block_r2, jnp.asarray(sl), n2, 1024))]
    gold = _timed("golden.decode_chunk(recover2=True)", golden.decode_chunk,
                  sl, recover2=True)
    print(f"  parity recover2 vs golden on {len(sl)} samples: "
          f"{len(dev)} device hits, {len(gold)} golden hits")
    check(dev == gold, "decode_iq_block_r2 differs from golden")

    with contextlib.redirect_stdout(sys.stderr):
        rc = (
            fuzz_parity.run(sizes.fuzz_iters, seed=101, chunk=4000),
            fuzz_extended.run(sizes.fuzz_iters, seed=202, chunk=4000),
            fuzz_extended.run(sizes.fuzz_iters, seed=303, chunk=4000,
                              recover2=True),
        )
    print(f"  three-way fuzz, {sizes.fuzz_iters} iterations each "
          f"(parity, extended, extended recover2): exit codes {rc}")
    check(rc == (0, 0, 0), "fuzz mismatch")


def _jsonl_stream(path: pathlib.Path) -> list[tuple[str, str]]:
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        out.append(("hex", rec["hex"]) if "hex" in rec else ("icao", rec["icao"]))
    return out


def _expected_extended(hits) -> list[tuple[str, str]]:
    """What `adsb --extended` emits for native extended hits on DF17-only
    traffic: every CRC-valid long frame, every zero-PI DF11, and the
    address-gated candidates whose address a valid frame carries."""
    seen = {p[1:4].hex() for _, kind, p, _ in hits if kind in ("long", "df11")}
    out = []
    for _, kind, p, icao_ap in hits:
        if kind == "long":
            out.append(("hex", p.hex()))
        elif kind == "df11":
            out.append(("icao", p[1:4].hex()))
        else:
            icao = p[1:4].hex() if kind == "df11_ic" else f"{icao_ap:06x}"
            if icao in seen:
                out.append(("icao", icao))
    return out


def _run_cli(args: list[str], log: pathlib.Path) -> str:
    from airjax.cli import main

    with open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = main(args)
    check(rc == 0, f"airjax {' '.join(args)} exited {rc}")
    stats = [ln for ln in log.read_text().splitlines() if ln.startswith("stats:")]
    check(len(stats) == 1, "no stats: line")
    return stats[0]


def phase_stream(sizes: Sizes = FULL) -> None:
    from airjax import native
    from airjax.io.source import playback_blocks
    from airjax.runner import run_stream
    from airjax.track.batch import BatchTracker

    WORK.mkdir(exist_ok=True)
    cap = WORK / "capture.c16"
    iq = _timed("capture (device-generated)", stream_capture,
                sizes.stream_seconds)
    native.save_c16(iq, cap)
    n_play = played_samples(len(iq))
    print(f"  capture: {len(iq)} samples ({len(iq) / SAMPLE_RATE:.1f} s at "
          f"2 MS/s), {n_play} replayed")
    parity = [p.hex() for _, p, _ in _timed(
        "native parity decode", native_hits_through, iq[:n_play])]
    ext = _expected_extended(_timed(
        "native extended decode", native_hits_through, iq[:n_play],
        extended=True))

    for flag in ("", "--extended", "--recover2"):
        out = WORK / f"out{flag or '-plain'}.jsonl"
        out.unlink(missing_ok=True)
        args = ["adsb", "--playback", str(cap), "--fast", "-m", "stream",
                "--jsonl", str(out)] + ([flag] if flag else [])
        t0 = time.perf_counter()
        stats = _run_cli(args, WORK / "cli.log")
        wall = time.perf_counter() - t0
        got = _jsonl_stream(out)
        want = [("hex", h) for h in parity] if flag != "--extended" else ext
        print(f"  adsb {flag or '(plain)'}: {len(got)} JSONL frames, "
              f"{len(want)} native, {wall:.1f} s")
        print(f"  {stats}")
        check(got == want, f"adsb {flag} frames differ from native")
        check(f"'good': {len(want)}," in stats, "stats good count differs")

    tracker = BatchTracker()
    t0 = time.perf_counter()
    stats = run_stream(playback_blocks(str(cap), realtime_factor=None), tracker)
    icaos = {int(h[2:8], 16) for h in parity}
    print(f"  run_stream -> BatchTracker: good={stats.good}, "
          f"messages={tracker.n_messages}, aircraft={len(tracker.aircrafts)}, "
          f"{time.perf_counter() - t0:.1f} s; stages {stats.stages.as_dict()}")
    check(stats.good == tracker.n_messages == len(parity),
          "batched sink count differs from native")
    check(set(tracker.aircrafts) == icaos, "batched sink aircraft differ")


def phase_devices(sizes: Sizes = FULL, n_devices: int = 4) -> None:
    import jax

    import __graft_entry__
    from airjax.io import synth
    from airjax.parallel.channels import decode_channels
    from airjax.parallel.mesh import make_mesh
    from airjax.runner import run_stream, run_stream_sharded

    check(len(jax.devices()) >= n_devices,
          f"{n_devices} devices asked, {len(jax.devices())} found")
    if jax.devices()[0].platform == "gpu":
        _print_cards()
    _timed(f"dryrun_multichip({n_devices})",
           __graft_entry__.dryrun_multichip, n_devices)

    iq = _timed("capture (device-generated)", stream_capture,
                sizes.stream_seconds)

    def blocks():
        for i in range(0, played_samples(len(iq)), CHUNK):
            yield iq[i : i + CHUNK]

    one, many = [], []
    t0 = time.perf_counter()
    st1 = run_stream(blocks(), one.append)
    t1 = time.perf_counter()
    stn = run_stream_sharded(blocks(), many.append, n_devices=n_devices)
    t2 = time.perf_counter()
    print(f"  run_stream (1 card): {st1.good} frames, {t1 - t0:.1f} s; "
          f"stages {st1.stages.as_dict()}")
    print(f"  run_stream_sharded ({n_devices} cards): {stn.good} frames, "
          f"{t2 - t1:.1f} s; stages {stn.stages.as_dict()}")
    check([p.packet for p in one] == [p.packet for p in many],
          "sharded hit stream differs from the single-card one")

    frame = synth.make_df17(0x7C6B30, synth.make_id_me("CHANNEL"))
    n = sizes.channel_samples
    offs = list(range(100, n - 300, 16384))
    chans = np.stack([
        np.asarray(synth.modulate_device([frame] * len(offs), offs, n, seed=c))
        for c in range(n_devices)
    ])
    got = _timed(f"decode_channels over {n_devices} cards", decode_channels,
                 chans, make_mesh(n_devices, axis="c"), capacity=1024)
    for c in range(n_devices):
        want = [(o, p, r) for o, p, r in native_hits_through(chans[c])]
        check([(o, p, r) for _, o, p, r in got[c]] == want,
              f"channel {c} differs from native")
    print(f"  decode_channels: {[len(g) for g in got]} hits per channel, "
          "equal to native")


PHASES = {
    "device": phase_device,
    "isqrt": phase_isqrt,
    "kernels": phase_kernels,
    "decode": phase_decode,
    "stream": phase_stream,
    "devices": phase_devices,
}


def main(argv=None) -> int:
    phases, n_devices = phase_plan(argv)
    sys.path.insert(0, str(ROOT))
    import jax

    from airjax.device import describe, setup_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU ({describe()})", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cache = pathlib.Path(setup_compile_cache())
    n_cached = _count_files(cache)
    from airjax import native

    native.get_lib()  # builds the native oracle for this machine
    print(f"setup: compile cache {cache} ({n_cached} files), native library "
          f"built/loaded in {time.perf_counter() - t0:.1f} s")
    failed = []
    try:
        for name in phases:
            print(f"== {name}", flush=True)
            t = time.perf_counter()
            try:
                if name == "devices":
                    phase_devices(FULL, n_devices)
                else:
                    PHASES[name](FULL)
            except Exception:
                failed.append(name)
                traceback.print_exc()
                print("  FAILED")
            print(f"  {name}: {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"compile cache {cache}: {n_cached} files at start, "
          f"{_count_files(cache)} now")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": describe()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
