"""Fuzz parity: the jitted device pipeline must produce byte-identical hit
streams (offset order, duplicates included) to the golden scalar decoder —
the reimplementation of the reference semantics — on noisy synthetic IQ.
This is the BASELINE config-1 bit-exactness gate without hardware captures.
"""

import numpy as np
import pytest

from airjax import golden
from airjax.config import PipelineConfig
from airjax.io import synth
from airjax.pipeline import decode_capture_parity

CFG = PipelineConfig(block_len=4000)  # small blocks: fast golden scan


def _run_both(iq):
    jit_hits, _ = decode_capture_parity(iq, CFG)
    gold = golden.decode_capture_playback(iq, chunk=CFG.block_len)
    return [(c, o, f) for c, o, f, _ in jit_hits], gold


@pytest.mark.parametrize("snr_db", [20.0, 10.0, 6.0, 3.0])
def test_parity_vs_golden_snr(snr_db):
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("PARITY"))
    rng = np.random.default_rng(int(snr_db * 10))
    offsets = [200, 1200, 2600, 4500, 6100, 7900]
    iq = synth.modulate(
        [frame] * len(offsets), offsets, 12001, snr_db=snr_db, seed=int(snr_db)
    )
    ours, gold = _run_both(iq)
    assert ours == gold


def test_parity_pure_noise():
    rng = np.random.default_rng(99)
    iq = np.clip(
        np.round(rng.normal(0, 200, (8001, 2))), -32768, 32767
    ).astype(np.int16)
    ours, gold = _run_both(iq)
    assert ours == gold


def test_parity_low_amplitude_ties():
    # Tiny amplitudes maximize magnitude-truncation ties, stressing the
    # >= / > edge semantics.
    rng = np.random.default_rng(7)
    iq = rng.integers(-4, 5, size=(8001, 2)).astype(np.int16)
    ours, gold = _run_both(iq)
    assert ours == gold


def test_parity_corrupted_frames():
    frame = synth.make_df17(0x40621D, synth.make_id_me("RECOVER"))
    bad1 = synth.flip_bit(frame, 17)
    bad2 = synth.flip_bit(frame, 100)  # flip inside CRC field: unrecoverable
    iq = synth.modulate([bad1, frame, bad2], [300, 1500, 2800], 8001, seed=3)
    ours, gold = _run_both(iq)
    assert ours == gold
    recovered_frames = [f for _, o, f in ours if o == 300]
    assert recovered_frames == [frame]
    assert all(o != 2800 for _, o, _ in ours)


def test_fuzz_parity_three_way_slice():
    """tools/fuzz_parity.py's loop (device, golden and native under the
    reference's playback chunking) at a CI-sized slice."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "fuzz_parity.py"
    spec = importlib.util.spec_from_file_location("fuzz_parity", path)
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    assert fuzz.run(iters=6, seed=11, chunk=2000) == 0
