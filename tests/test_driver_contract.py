"""Driver contract smoke tests: bench.py and __graft_entry__.py must keep
working (the round driver runs them unattended on real hardware)."""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def test_bench_small_cpu():
    import bench

    result = bench.bench(
        block_len=1 << 15, n_blocks=2, capacity=128, r_small=1, r_big=3
    )
    assert result["metric"] == "iq_throughput_msps"
    assert result["unit"] == "Msamples/s"
    assert result["value"] > 0
    assert abs(result["vs_baseline"] - result["value"] / 2.0) < 0.1
    json.dumps(result)  # serializable
    assert result["detail"]["frames_decoded_per_pass"] >= 1


def test_graft_entry():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out["frames"].shape[-1] == 14
    assert out["offsets"].shape == out["good"].shape


def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(len(jax.devices()))


def test_bench_main_refuses_cpu():
    """`python bench.py` measures the GPU: with no GPU it exits non-zero
    and prints no result line."""
    import os
    import subprocess

    root = pathlib.Path(__file__).resolve().parent.parent
    res = subprocess.run(
        [sys.executable, "bench.py"], cwd=root,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "iq_throughput_msps" not in res.stdout
