"""Three-way differential parity fuzzer: the jitted pipeline, the golden
scalar decoder and the native C++ decoder on randomized captures — lengths (chunk-boundary edge cases
included), SNRs, overlapping/corrupted frames, tie-heavy low-amplitude
streams, and constant-magnitude storms.

Any mismatch is a bit-exactness bug. Exit 0 = all iterations agree.

Usage: python tools/fuzz_parity.py [--iters 200] [--seed 0] [--chunk 4000]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))

from airjax import golden  # noqa: E402
from airjax.config import PipelineConfig  # noqa: E402
from airjax.io import synth  # noqa: E402
from airjax.pipeline import (  # noqa: E402
    decode_capture_parity,
    reference_chunk_count,
)


def random_capture(rng: np.random.Generator, chunk: int) -> np.ndarray:
    kind = rng.integers(0, 6)
    n = int(
        rng.choice(
            [
                chunk - 1,
                chunk,
                chunk + 1,
                2 * chunk,
                2 * chunk + 1,
                int(rng.integers(300, 3 * chunk)),
            ]
        )
    )
    if kind == 0:  # pure noise
        return np.clip(
            np.round(rng.normal(0, rng.uniform(5, 500), (n, 2))), -32768, 32767
        ).astype(np.int16)
    if kind == 1:  # tiny amplitudes: truncation-tie storm
        return rng.integers(-4, 5, size=(n, 2)).astype(np.int16)
    if kind == 2:  # constant stream: every offset detects
        return np.full((n, 2), int(rng.integers(0, 50)), dtype=np.int16)
    # frames at random (possibly overlapping) offsets, random SNR/corruption
    n = max(n, 1200)
    count = int(rng.integers(1, 6))
    frames = []
    offsets = []
    for _ in range(count):
        icao = int(rng.integers(0, 1 << 24))
        if rng.random() < 0.5:
            me = synth.make_id_me("FZ" + str(rng.integers(100, 999)))
        else:
            me = synth.make_position_me(
                tc=int(rng.integers(9, 19)),
                altitude_ft=int(rng.integers(0, 2000)) * 25 - 1000,
                cpr_lat=int(rng.integers(0, 1 << 17)),
                cpr_lon=int(rng.integers(0, 1 << 17)),
                odd=bool(rng.integers(0, 2)),
            )
        frame = synth.make_df17(icao, me)
        if rng.random() < 0.3:
            frame = synth.flip_bit(frame, int(rng.integers(0, 112)))
        frames.append(frame)
        offsets.append(int(rng.integers(0, n - 300)))
    snr = float(rng.uniform(0, 25)) if rng.random() < 0.7 else None
    return synth.modulate(
        frames,
        offsets,
        n,
        snr_db=snr,
        noise_std=float(rng.uniform(10, 200)),
        seed=int(rng.integers(0, 1 << 31)),
    )


def native_playback(iq: np.ndarray, chunk: int) -> list[tuple[int, int, bytes]]:
    """The native decoder under the reference's playback chunking."""
    from airjax.native import decode_chunk

    out = []
    for c in range(reference_chunk_count(len(iq), chunk)):
        hits, _ = decode_chunk(iq[c * chunk : (c + 1) * chunk], max_hits=chunk)
        out.extend((c, o, p) for o, p, _ in hits)
    return out


def run(iters: int, seed: int, chunk: int) -> int:
    rng = np.random.default_rng(seed)
    cfg = PipelineConfig(block_len=chunk, max_candidates=128)
    for i in range(iters):
        iq = random_capture(rng, chunk)
        ours, _ = decode_capture_parity(iq, cfg)
        gold = golden.decode_capture_playback(iq, chunk=chunk)
        nat = native_playback(iq, chunk)
        ours_cmp = [(c, o, f) for c, o, f, _ in ours]
        if ours_cmp != gold or nat != gold:
            print(f"MISMATCH at iteration {i} (len={len(iq)})")
            print(" ours:  ", ours_cmp[:5])
            print(" native:", nat[:5])
            print(" gold:  ", gold[:5])
            return 1
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{iters} ok ({len(gold)} hits last)")
    print(f"all {iters} iterations three-way bit-exact")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=4000)
    args = p.parse_args(argv)
    return run(args.iters, args.seed, args.chunk)


if __name__ == "__main__":
    sys.exit(main())
