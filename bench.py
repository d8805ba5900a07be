"""airjax benchmark: sustained IQ decode throughput on one chip.

Prints ONE JSON line:
  {"metric": "iq_throughput_msps", "value": N, "unit": "Msamples/s",
   "vs_baseline": N / 2.0, ...}

Baseline: the reference's design floor is real-time decode of 2.0 MS/s
complex IQ on one CPU thread (src/adsb.rs:44,92-122; BASELINE.md) — it
publishes no other numbers. vs_baseline is therefore the speedup over
2 Msamples/s.

The workload is the full decode pipeline (magnitude -> preamble/DF17 scan
at stride 1 -> candidate compaction -> PPM bit-slice -> GF(2) CRC +
single-bit recovery) on synthetic IQ with a realistic frame density, using
the overlap-save block layout.

Measurement method: (a) run R decode passes inside ONE jitted fori_loop
(each pass decodes a cheaply-perturbed copy of the input so XLA cannot
hoist the work out of the loop), (b) end each timing with a fetch of the
aggregated stats scalars, and (c) report the slope between a large-R and a
small-R timing, which cancels the fixed dispatch/fetch overhead.

`python bench.py` runs on the GPU only: it exits non-zero where JAX finds
no GPU, so a CPU time is never printed as a device number. `bench()`
itself runs anywhere (the CPU tests call it at a small size).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from airjax.device import describe, setup_compile_cache
from airjax.dsp.demod import WINDOW
from airjax.io import synth
from airjax.pipeline import decode_mags_block
from airjax.dsp.magnitude import magnitude_u16


def build_workload(block_len: int, n_blocks: int, seed: int = 0):
    """Synthetic capture shaped (n_blocks, block_len + halo, 2) int16.

    Built on-device: synthesizing a 130 MB workload with host numpy
    takes minutes.
    """
    # Halo padded to 1024 (>= WINDOW-1) so the block array is 1024-aligned;
    # the scan covers n_off = block_len - WINDOW offsets of it.
    halo = 1024
    n = block_len * n_blocks + halo
    rng = np.random.default_rng(seed)
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("BENCH00"))
    # ~1 frame per 16k samples (dense traffic).
    n_frames = max(1, n // 16384)
    offsets = np.sort(
        rng.choice(np.arange(0, (n - WINDOW) // 300) * 300, size=n_frames, replace=False)
    )
    iq = synth.modulate_device(
        [frame] * len(offsets), list(map(int, offsets)), n, noise_std=60.0, seed=seed
    )
    # A tuple of separate arrays, NOT a stacked (n_blocks, L, 2): selecting
    # a block out of a stacked array with dynamic_index_in_dim inside the
    # timing loop can materialize a 64 MB copy that XLA does not fuse
    # into the magnitude stage.
    blocks = tuple(
        jnp.asarray(jax.lax.dynamic_slice_in_dim(iq, i * block_len, block_len + halo))
        for i in range(n_blocks)
    )
    return blocks, len(offsets)


def make_repeat_step(block_len: int, capacity: int):
    """One jitted call running `reps` full decode passes over the batch."""

    import functools

    @jax.jit
    def step(blocks, reps):
        # `reps` is a traced scalar: one compilation serves every timing
        # point.
        n_blocks = len(blocks)

        n_off = block_len - WINDOW  # see build_workload's shape note

        def run(iq, r):
            # Perturbed per pass (wrapping int16 add) so the decode is not
            # loop-invariant; the add fuses into the magnitude stage.
            perturbed = iq + r.astype(jnp.int16)
            out = decode_mags_block(magnitude_u16(perturbed), n_off, capacity)
            return out["n_good"], out["n_detections"]

        def one_pass(r, acc):
            # One block per pass, round-robin via lax.switch over closures
            # (no block copy; see build_workload). With a single block the
            # switch is bypassed entirely.
            if n_blocks == 1:
                g, d = run(blocks[0], r)
            else:
                g, d = jax.lax.switch(
                    r % n_blocks, [functools.partial(run, b) for b in blocks], r
                )
            return acc[0] + g, acc[1] + d

        return jax.lax.fori_loop(
            0, reps, one_pass, (jnp.int32(0), jnp.int32(0))
        )

    return step


def _timed(fn, *args, iters=3):
    best = float("inf")
    last = None
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        last = tuple(int(x) for x in out)  # forces full execution + fetch
        best = min(best, time.perf_counter() - t0)
    return best, last


def bench(block_len=1 << 24, n_blocks=1, capacity=2048, r_small=2, r_big=42):
    # n_blocks=1: the per-pass int16 perturbation alone already defeats
    # loop-invariant hoisting (good counts track the input).
    blocks, n_frames = build_workload(block_len, n_blocks)
    total_samples = block_len - WINDOW  # offsets scanned per pass (n_off)
    step = make_repeat_step(block_len, capacity)

    # Warm the (single) compilation.
    jax.block_until_ready(step(blocks, r_small))
    int(step(blocks, r_small)[0])

    t_small, _ = _timed(step, blocks, r_small)
    t_big, (good_sum, det_sum) = _timed(step, blocks, r_big)
    per_pass = (t_big - t_small) / (r_big - r_small)

    # Decode-quality stats averaged over the timed passes (no second
    # compiled program).
    n_good = good_sum // r_big
    n_det = det_sum // r_big

    msps = total_samples / per_pass / 1e6
    return {
        "metric": "iq_throughput_msps",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / 2.0, 1),
        "detail": {
            "device": describe(),
            "block_len": block_len,
            "n_blocks": n_blocks,
            "seconds_per_pass": round(per_pass, 6),
            "fixed_overhead_s": round(t_small - per_pass * r_small, 4),
            "frames_embedded": n_frames,
            "frames_decoded_per_pass": n_good,
            "detections_per_pass": n_det,
            "decoded_msgs_per_s": round(n_good / per_pass, 1),
            "effective_gbps": round(total_samples * 4 / per_pass / 1e9, 1),
        },
    }


if __name__ == "__main__":
    import contextlib
    import sys

    if jax.devices()[0].platform != "gpu":
        print(
            f"bench.py measures the GPU; JAX found {describe()}",
            file=sys.stderr,
        )
        sys.exit(2)
    setup_compile_cache()

    # `bench.py --trace [DIR]`: wrap the whole run in a jax.profiler
    # trace (airjax.observability). The contract JSON line is unchanged
    # (trace status goes through logging, not stdout).
    ctx = contextlib.nullcontext()
    if "--trace" in sys.argv:
        from airjax.observability import trace

        i = sys.argv.index("--trace")
        trace_dir = (
            sys.argv[i + 1]
            if len(sys.argv) > i + 1 and not sys.argv[i + 1].startswith("-")
            else None  # airjax.device.TRACE_DIR
        )
        ctx = trace(trace_dir)
    try:
        with ctx:
            print(json.dumps(bench()))
    except Exception as e:  # always emit the contract line
        print(
            json.dumps(
                {
                    "metric": "iq_throughput_msps",
                    "value": 0,
                    "unit": "Msamples/s",
                    "vs_baseline": 0,
                    "error": f"{type(e).__name__}: {e}"[:300],
                }
            )
        )
        raise
