"""Test config: force the CPU backend with 8 virtual devices so the
sharding/halo logic is testable without a GPU (SURVEY.md §4c).

The platform is set through jax.config before any backend initializes, so
the suite runs on the CPU even where a GPU is present. Tests that need the
card carry the `gpu` marker and skip here; `python chip_smoke.py` runs the
same checks on the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    """`gpu`-marked tests skip where JAX has no GPU (decided per test at
    run time, never at import, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU (run python chip_smoke.py on the card)")
