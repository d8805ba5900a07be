"""airjax.device: the compile-cache helper every entry point calls, and
the device description printed beside every result."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from airjax import device

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [True, False])
def test_setup_compile_cache(env_set, tmp_path, monkeypatch, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert device.setup_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper sets nothing.
        assert jax.config.jax_compilation_cache_dir is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = device.setup_compile_cache()
        # A fixed path inside the checkout: no temp name, pid or time.
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert device.setup_compile_cache() == path


def test_env_cache_dir_receives_the_cache(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, a compile lands there."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from airjax.device import setup_compile_cache\n"
        "setup_compile_cache()\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()\n"
    )
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        PYTHONPATH=str(ROOT),
    )
    subprocess.run(
        [sys.executable, "-c", code], env=env, check=True, timeout=120,
        cwd=tmp_path,
    )
    assert any((tmp_path / "cache").iterdir())


def test_describe_names_the_backend():
    info = device.describe()
    assert info == {
        "platform": "cpu",
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


def test_trace_dir_is_inside_the_checkout():
    assert device.TRACE_DIR.parent == ROOT
