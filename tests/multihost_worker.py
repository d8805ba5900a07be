"""Worker process for the true 2-process multi-host test.

Launched (twice) by tests/test_multihost.py::test_two_process_loopback with
argv = [rank, coordinator_address]. Each rank synthesizes the SAME global
capture deterministically, ingests only its own half via
multihost.decode_capture — in BOTH gather modes, so the compact
(replicated psum) path AND the dense path's
jax.make_array_from_process_local_data + process_allgather branch each
execute under a real 2-process runtime — and prints the full gathered
hit stream; the parent asserts both ranks printed identical, complete
results and that the two gathers agreed.
"""

import json
import sys


def main() -> None:
    rank = int(sys.argv[1])
    coordinator = sys.argv[2]

    import jax

    # This loopback test runs on the CPU backend whatever the machine has.
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=2, process_id=rank
    )
    assert jax.process_count() == 2, jax.process_count()

    from airjax.io import synth
    from airjax.parallel import multihost

    n = 32768
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("TWOPROC_"))
    # One frame per host's interior + one STRADDLING the process boundary
    # (the class of loss the reference suffers at chunk edges, adsb.rs:77).
    offsets = [1000, n // 2 - 120, 30000]
    iq = synth.modulate([frame] * len(offsets), offsets, n, seed=9)
    half = n // 2
    local = iq[rank * half : (rank + 1) * half]

    hits, stats = multihost.decode_capture(local)  # compact (default)
    # Dense A/B under the same 2-process runtime: keeps the retained
    # process_allgather branch covered by a TRUE multi-process test.
    dense_hits, _dense_stats = multihost.decode_capture(
        local, gather="dense"
    )
    assert dense_hits == hits, (len(dense_hits), len(hits))

    # Extended path in the same 2-process session: a DF17, a DF11
    # all-call STRADDLING the process boundary, and a cache-gated DF4.
    from airjax.protocol import shortframe

    df11 = shortframe.make_df11(0x40621D)
    df4 = shortframe.make_df4(0x40621D, 9000)
    eoffsets = [2000, half - 60, 28000]
    eiq = synth.modulate([frame, df11, df4], eoffsets, n, seed=10)
    packets, estats = multihost.decode_capture_extended(
        eiq[rank * half : (rank + 1) * half], now=100.0
    )

    # Batched sink from the gathered arrays (VERDICT r3 item 3): every
    # rank applies the identical block to its own tracker replica; the
    # parent asserts both replicas AND the per-packet path agree.
    from airjax.track.batch import ExtendedBatchTracker

    tracker = ExtendedBatchTracker()
    applied, bstats = multihost.decode_capture_extended_batched(
        eiq[rank * half : (rank + 1) * half], tracker, now=100.0
    )
    tracker_state = {
        f"{icao:06x}": {
            "callsign": a.callsign,
            "altitude": a.altitude,
            # An untouched last_contact is Aircraft.__init__'s wall-clock
            # default and legitimately differs between processes; only
            # synthetic stamps (now=100.0) are comparable.
            "last_contact": a.last_contact if a.last_contact < 1e9 else None,
        }
        for icao, a in tracker.aircrafts.items()
    }

    print(
        "RESULT "
        + json.dumps(
            {
                "rank": rank,
                "expected_offsets": offsets,
                "frame_hex": frame.hex(),
                "hits": [[h[1], h[2].hex(), h[3]] for h in hits],
                "stats": stats,
                "expected_ext": eoffsets,
                "epackets": [[off, type(p).__name__] for off, p in packets],
                "estats": estats,
                "batched_applied": applied,
                "batched_stats": bstats,
                "tracker_state": tracker_state,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
