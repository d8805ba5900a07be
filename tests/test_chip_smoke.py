"""chip_smoke.py on the CPU: it refuses to report without a GPU, its phase
plan, and each phase's checks rehearsed at a tiny size (the card runs the
same code at full size)."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_without_gpu():
    res = _run(ROOT, ROOT / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    res = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize(
    "argv, phases, n_devices",
    [
        ([], ["device", "isqrt", "kernels", "decode", "stream"], None),
        (["--devices", "4"], ["devices"], 4),
    ],
)
def test_phase_plan(argv, phases, n_devices):
    assert chip_smoke.phase_plan(argv) == (phases, n_devices)


def test_full_sizes_are_what_users_run():
    full = chip_smoke.FULL
    assert full.isqrt_hi == 1 << 31
    assert full.block == (1 << 24) + 1024
    assert full.crc_frames >= 4096
    assert full.stream_seconds * chip_smoke.SAMPLE_RATE == 120_000_000
    assert full.fuzz_iters == 20


@pytest.mark.parametrize("phase", ["isqrt", "kernels", "decode", "stream"])
def test_phase_rehearsal(phase, tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    chip_smoke.PHASES[phase](chip_smoke.TINY)


def test_devices_phase_rehearsal(capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (conftest gives the CPU 8)")
    chip_smoke.phase_devices(chip_smoke.TINY, 4)
    assert "equal to native" in capsys.readouterr().out


@pytest.mark.gpu
def test_isqrt_exhaustive_on_card():
    chip_smoke.phase_isqrt(chip_smoke.FULL)


def test_device_phase_fails_on_cpu():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_device()


def test_native_hits_through_covers_last_offset():
    """The appended sample adds offset len-240 to the native scan."""
    from airjax.io import synth

    frame = synth.make_df17(0x7C6B30, synth.make_id_me("EDGE"))
    n = 2000
    iq = synth.modulate([frame], [n - 240], n, seed=1)
    hits = chip_smoke.native_hits_through(iq)
    assert [(o, p) for o, p, _ in hits] == [(n - 240, frame)]
