"""Opt-in 2-bit CRC recovery (VERDICT r4 item 6): unique pairwise-
syndrome repair on device, ICAO-gated acceptance in the stream runner,
parity path untouched when off."""

import jax
import jax.numpy as jnp
import numpy as np

from airjax.io import synth
from airjax.pipeline import decode_iq_block, decode_iq_block_r2
from airjax.protocol.crc import (
    DATA_BITS,
    bytes_to_bits,
    crc_check_and_recover2,
)
from airjax.runner import run_stream

ICAO = 0x7C6B30
FRAME = synth.make_df17(ICAO, synth.make_id_me("RECOVER2"))


def _flip_bits(frame: bytes, positions) -> bytes:
    b = bytearray(frame)
    for p in positions:
        b[p // 8] ^= 1 << (7 - p % 8)
    return bytes(b)


def test_crc_recover2_repairs_double_flips():
    corrupted = np.stack(
        [
            bytes_to_bits(FRAME),  # clean
            bytes_to_bits(_flip_bits(FRAME, [37])),  # 1-flip
            bytes_to_bits(_flip_bits(FRAME, [5, 61])),  # 2-flip
            bytes_to_bits(_flip_bits(FRAME, [0, 87])),  # 2-flip edges
        ]
    )
    bits, good, rec, rec2 = crc_check_and_recover2(jnp.asarray(corrupted))
    assert np.asarray(good).tolist() == [True] * 4
    assert np.asarray(rec).tolist() == [False, True, False, False]
    assert np.asarray(rec2).tolist() == [False, False, True, True]
    # Every repair lands on the TRANSMITTED frame bits exactly.
    want = bytes_to_bits(FRAME)
    assert np.array_equal(np.asarray(bits), np.stack([want] * 4))


def test_crc_recover2_crc_field_flips_do_not_validate():
    """The parity quirk extends: flips inside the 24-bit CRC field can
    never validate (pair table spans data bits only)."""
    bits = np.stack(
        [
            bytes_to_bits(_flip_bits(FRAME, [DATA_BITS + 1, DATA_BITS + 9])),
            bytes_to_bits(_flip_bits(FRAME, [3, DATA_BITS + 4])),
        ]
    )
    _, good, _, rec2 = crc_check_and_recover2(jnp.asarray(bits))
    assert not np.any(np.asarray(good))
    assert not np.any(np.asarray(rec2))


def test_pipeline_r2_matches_standard_plus_double_repairs():
    """A capture carrying a clean frame and a 2-bit-corrupted one: the
    standard pipeline decodes 1, the r2 pipeline decodes both (and its
    standard outputs are bit-identical for the clean frame)."""
    bad = _flip_bits(FRAME, [11, 70])
    iq = synth.modulate([FRAME, bad], [500, 3000], 8000, seed=3)
    n_off = 8000 - 240
    std = jax.device_get(decode_iq_block(jnp.asarray(iq), n_off, 64))
    r2 = jax.device_get(decode_iq_block_r2(jnp.asarray(iq), n_off, 64))
    std_goods = {
        int(std["offsets"][k]): std["frames"][k].tobytes()
        for k in np.nonzero(std["good"])[0]
    }
    r2_goods = {
        int(r2["offsets"][k]): r2["frames"][k].tobytes()
        for k in np.nonzero(r2["good"])[0]
    }
    assert std_goods == {500: FRAME}
    assert r2_goods == {500: FRAME, 3000: FRAME}  # repaired to the original
    k3000 = int(np.nonzero(np.asarray(r2["offsets"]) == 3000)[0][0])
    assert bool(r2["recovered2"][k3000])


def test_runner_gating():
    """recovered2 frames emit ONLY for ICAOs already seen clean: the
    corrupted frame of a never-seen aircraft is suppressed."""
    other = synth.make_df17(0x123456, synth.make_id_me("STRANGER"))
    stream_iq = synth.modulate(
        [
            FRAME,  # clean: seeds ICAO
            _flip_bits(FRAME, [12, 40]),  # accepted 2-flip repair
            _flip_bits(other, [12, 40]),  # REJECTED: ICAO never seen clean
        ],
        [500, 3000, 6000],
        20000,
        seed=4,
    )
    got = []
    stats = run_stream(
        iter([stream_iq]), got.append, overlap=True, recover2=True
    )
    assert [(p.icao, p.packet) for p in got] == [
        (ICAO, FRAME),
        (ICAO, FRAME),
    ]
    assert stats.recovered2 == 1
    # Off: only the clean frame decodes, and recovered2 stays 0.
    got_off = []
    stats_off = run_stream(iter([stream_iq]), got_off.append, overlap=True)
    assert [p.packet for p in got_off] == [FRAME]
    assert stats_off.recovered2 == 0


def test_extended_batched_sink_recover2_matches_per_packet():
    """The EXTENDED batched sink under recover2: repairs gate on the
    acceptance cache inside on_extended_block (never seeding it) and the
    tracker state matches the per-packet path."""
    from airjax.extended import handle_extended_update
    from airjax.runner import run_stream
    from airjax.track.batch import ExtendedBatchTracker

    other = synth.make_df17(0x123456, synth.make_id_me("STRANGER"))
    iq = synth.modulate(
        [
            FRAME,
            _flip_bits(FRAME, [12, 40]),  # accepted (cached ICAO)
            _flip_bits(other, [12, 40]),  # rejected (never seen clean)
        ],
        [500, 3000, 6000],
        20000,
        seed=6,
    )
    per = {}
    got = []

    def per_packet(pkt):
        got.append(pkt)
        handle_extended_update(pkt, per)

    run_stream(iter([iq]), per_packet, overlap=True, extended=True,
               recover2=True)
    bt = ExtendedBatchTracker()
    run_stream(iter([iq]), bt, overlap=True, extended=True, recover2=True)
    assert [p.icao for p in got] == [ICAO, ICAO]  # stranger suppressed
    assert set(per) == set(bt.aircrafts) == {ICAO}
    assert bt.n_messages == 2
    assert (
        per[ICAO].get_callsign() == bt.aircrafts[ICAO].get_callsign()
    )


def test_cli_flag_combos(capsys):
    from airjax.cli import main

    assert main(["adsb", "--synthetic", "2", "--recover2"]) == 0
    out = capsys.readouterr().out
    assert "'recovered2': 0" in out
    # Composes with --extended and --devices (and both batched sinks,
    # tested through run_stream elsewhere in this file).
    assert main(["adsb", "--synthetic", "2", "--recover2", "--extended"]) == 0
    assert main(
        ["adsb", "--synthetic", "2", "--recover2", "--devices", "2"]
    ) == 0


def _r2_stream_iq(n_total=200_000):
    other = synth.make_df17(0x123456, synth.make_id_me("STRANGER"))
    return synth.modulate(
        [
            FRAME,
            _flip_bits(FRAME, [12, 40]),  # accepted (ICAO seen clean)
            _flip_bits(other, [12, 40]),  # rejected (never seen clean)
            FRAME,
        ],
        [500, 3000, 6000, 150_000],
        n_total,
        seed=6,
    )


def test_batched_sink_recover2_matches_per_packet():
    """The parity BATCHED sink under recover2 (vectorized gate in the
    runner) lands the same tracker state and accepted-repair count as
    the per-packet path — stranger suppression included."""
    from airjax.track.aircraft import handle_aircraft_update
    from airjax.track.batch import BatchTracker

    iq = _r2_stream_iq()

    def blocks():
        for i in range(0, len(iq), 20000):
            yield iq[i : i + 20000]

    per = {}
    got = []

    def per_packet(pkt):
        got.append(pkt)
        handle_aircraft_update(pkt, per)

    s1 = run_stream(blocks(), per_packet, overlap=True, recover2=True)
    bt = BatchTracker()
    s2 = run_stream(blocks(), bt, overlap=True, recover2=True)
    assert s1.recovered2 == s2.recovered2 == 1
    assert s1.good == s2.good == 3  # stranger suppressed in both
    assert set(per) == set(bt.aircrafts) == {ICAO}
    assert (
        per[ICAO].get_callsign() == bt.aircrafts[ICAO].get_callsign()
    )


def test_batched_sink_recover2_sharded(mesh_or_none=None):
    from airjax.parallel.mesh import make_mesh
    from airjax.runner import run_stream_sharded
    from airjax.track.batch import BatchTracker

    iq = _r2_stream_iq()

    def blocks():
        for i in range(0, len(iq), 20000):
            yield iq[i : i + 20000]

    bt1, bt2 = BatchTracker(), BatchTracker()
    s1 = run_stream(blocks(), bt1, overlap=True, recover2=True)
    s2 = run_stream_sharded(
        blocks(), bt2, mesh=make_mesh(8), recover2=True
    )
    assert s1.recovered2 == s2.recovered2 == 1
    assert s1.good == s2.good == 3
    assert set(bt1.aircrafts) == set(bt2.aircrafts) == {ICAO}


def test_gate_recover2_batch_within_block_order():
    """A repair BEFORE its aircraft's first clean row in the same block
    is rejected (the per-packet gate is position-sensitive)."""
    from airjax.runner import _gate_recover2_batch

    idx = np.arange(3)
    icaos = np.array([ICAO, ICAO, ICAO])
    rec2 = np.array([True, False, True])  # repair first, clean, repair
    seen: set = set()
    kept, n_r2 = _gate_recover2_batch(idx, icaos, rec2, seen)
    assert kept.tolist() == [1, 2] and n_r2 == 1
    assert ICAO in seen
    # Next block: the stream-seen set accepts a lone repair.
    kept2, n2 = _gate_recover2_batch(
        np.arange(1), np.array([ICAO]), np.array([True]), seen
    )
    assert kept2.tolist() == [0] and n2 == 1


def test_sharded_runner_recover2_equality():
    """run_stream_sharded with recover2 emits the exact stream of
    run_stream with recover2 (gate evolution included)."""
    from airjax.parallel.mesh import make_mesh
    from airjax.runner import run_stream_sharded

    other = synth.make_df17(0x123456, synth.make_id_me("STRANGER"))
    n_total = 200_000
    iq = synth.modulate(
        [
            FRAME,
            _flip_bits(FRAME, [12, 40]),  # accepted (ICAO seen clean)
            _flip_bits(other, [12, 40]),  # rejected (never seen clean)
            FRAME,
        ],
        [500, 3000, 6000, 150_000],
        n_total,
        seed=6,
    )

    def blocks():
        for i in range(0, n_total, 20000):
            yield iq[i : i + 20000]

    got1, got2 = [], []
    s1 = run_stream(blocks(), got1.append, overlap=True, recover2=True)
    s2 = run_stream_sharded(
        blocks(), got2.append, mesh=make_mesh(8), recover2=True
    )
    assert [p.packet.hex() for p in got1] == [p.packet.hex() for p in got2]
    assert len(got1) == 3  # stranger suppressed in both
    assert s1.recovered2 == s2.recovered2 == 1


def test_sharded_runner_recover2_extended_equality():
    from airjax.parallel.mesh import make_mesh
    from airjax.runner import run_stream_sharded

    n_total = 200_000
    iq = synth.modulate(
        [FRAME, _flip_bits(FRAME, [30, 31]), FRAME],
        [500, 3000, 150_000],
        n_total,
        seed=7,
    )

    def blocks():
        for i in range(0, n_total, 20000):
            yield iq[i : i + 20000]

    got1, got2 = [], []
    s1 = run_stream(
        blocks(), got1.append, overlap=True, extended=True, recover2=True
    )
    s2 = run_stream_sharded(
        blocks(), got2.append, mesh=make_mesh(8), extended=True, recover2=True
    )
    assert [p.packet.hex() for p in got1] == [p.packet.hex() for p in got2]
    assert len(got1) == 3
    assert s1.recovered2 == s2.recovered2 == 1


def test_noise_fuzz_zero_false_accepts():
    """Mid-SNR noise + heavily corrupted unknown-ICAO frames: nothing
    wrong is ever emitted under recover2."""
    rng = np.random.default_rng(11)
    for it in range(4):
        frames = [
            _flip_bits(
                synth.make_df17(int(rng.integers(1, 1 << 24)), synth.make_id_me("X")),
                rng.choice(112, size=int(rng.integers(2, 5)), replace=False),
            )
            for _ in range(4)
        ]
        iq = synth.modulate(
            frames, [500 + 2000 * i for i in range(4)], 12000,
            noise_std=35.0, seed=100 + it,
        )
        got = []
        run_stream(iter([iq]), got.append, overlap=True, recover2=True)
        # Corrupted frames of never-seen ICAOs must all be suppressed.
        assert got == [], [p.packet.hex() for p in got]


def test_golden_recover2_matches_device_r2():
    """golden.decode_chunk(recover2=True) is the ungated oracle of
    decode_iq_block_r2: a double-flipped frame comes back repaired in
    both, a single flip in both, and recover2=False drops the double."""
    from airjax import golden

    frame = synth.make_df17(0x4840D6, synth.make_id_me("GOLDR2"))
    two = synth.flip_bit(synth.flip_bit(frame, 20), 61)
    one = synth.flip_bit(frame, 40)
    iq = synth.modulate([two, one, frame], [300, 2000, 4000], 6000, seed=9)
    gold = golden.decode_chunk(iq, recover2=True)
    assert [o for o, _ in gold] == [300, 2000, 4000]
    assert all(p == frame for _, p in gold)
    assert [o for o, _ in golden.decode_chunk(iq)] == [2000, 4000]
    out = jax.device_get(
        decode_iq_block_r2(jnp.asarray(iq), len(iq) - 240, 64)
    )
    dev = [
        (int(out["offsets"][k]), out["frames"][k].tobytes())
        for k in np.nonzero(out["good"])[0]
    ]
    assert dev == gold
