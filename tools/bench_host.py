"""Host keep-up benchmark: how many decoded msgs/s can the online host
side apply?

Two paths, same message stream:

  per-packet — AdsbPacket.from_bytes + handle_aircraft_update per frame
               (the shape of the reference's thread-3 consumer,
               src/adsb.rs:149-167; what run_stream's default sink does)
  batched    — BatchTracker.on_fields per 1024-frame block (what
               run_stream uses when the sink exposes on_fields; protocol
               fields are extracted ON DEVICE inside the same jitted
               decode program, decode_iq_block_with_fields, and ride the
               existing result fetch — so this path times exactly the
               host work that remains)

The stream is worst-case for the tracker: every position message forms a
CPR pair (alternating parity), so the pairing + geodecode path runs at
full rate.

Run: python tools/bench_host.py [--messages 200000]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")  # field extraction cost is NOT
# what's being measured (it is fused into the device decode in production)

import jax.numpy as jnp
import numpy as np

from airjax.io import synth
from airjax.protocol.fields import extract_fields
from airjax.protocol.packet import AdsbPacket
from airjax.track.aircraft import handle_aircraft_update
from airjax.track.batch import BatchTracker

BLOCK = 1024  # good frames per decode block at bench density


def build_stream(n_messages: int, n_aircraft: int = 64) -> np.ndarray:
    frames = []
    for a in range(n_aircraft):
        icao = 0x100000 + a
        frames.append(synth.make_df17(icao, synth.make_id_me(f"AC{a:05d}")))
        frames.append(
            synth.make_df17(
                icao,
                synth.make_position_me(
                    tc=11, altitude_ft=10000 + a * 25,
                    cpr_lat=93000, cpr_lon=51372, odd=False,
                ),
            )
        )
        frames.append(
            synth.make_df17(
                icao,
                synth.make_position_me(
                    tc=11, altitude_ft=10000 + a * 25,
                    cpr_lat=74158, cpr_lon=50194, odd=True,
                ),
            )
        )
    seq = [frames[i % len(frames)] for i in range(n_messages)]
    return np.frombuffer(b"".join(seq), np.uint8).reshape(n_messages, 14)


def build_extended_block(n_aircraft: int = 64, repeats: int = 3):
    """One realistic extended-mode decode block: per aircraft-and-repeat
    an ID, an even+odd position pair and a TC19 velocity (the batched
    fast-path classes), plus DF11 all-calls and cache-gated DF4
    surveillance replies for half the fleet. Returns the device dict of
    decode_iq_block_extended_with_fields.

    `repeats=3` sizes the block at ~960 messages — matching the parity
    bench's 1024-frame blocks (bench.py), so host and device rates compare
    like for like."""
    from airjax.pipeline import decode_iq_block_extended_with_fields
    from airjax.protocol import shortframe

    frames = []
    for r in range(repeats):
        for a in range(n_aircraft):
            icao = 0x100000 + a
            frames.append(synth.make_df17(icao, synth.make_id_me(f"AC{a:05d}")))
            frames.append(
                synth.make_df17(
                    icao,
                    synth.make_position_me(
                        tc=11, altitude_ft=10000 + a * 25 + r,
                        cpr_lat=93000 + r, cpr_lon=51372, odd=False,
                    ),
                )
            )
            frames.append(
                synth.make_df17(
                    icao,
                    synth.make_position_me(
                        tc=11, altitude_ft=10000 + a * 25 + r,
                        cpr_lat=74158 + r, cpr_lon=50194, odd=True,
                    ),
                )
            )
            frames.append(
                synth.make_df17(
                    icao,
                    synth.make_velocity_me(
                        ew_kt=100 + a, ns_kt=-50, vertical_rate_fpm=640
                    ),
                )
            )
            if a % 2 == 0:
                frames.append(shortframe.make_df11(icao))
                frames.append(shortframe.make_df4(icao, 10000 + a * 25))
    spacing = 400
    n = ((len(frames) * spacing + 2048) // 1024) * 1024
    iq = synth.modulate(
        frames, [100 + i * spacing for i in range(len(frames))], n, seed=3
    )
    out = jax.device_get(
        decode_iq_block_extended_with_fields(
            jnp.asarray(iq), n - 240, 4096
        )
    )
    n_good = int(np.sum(np.asarray(out["good_long"]) | np.asarray(out["good_df11"])))
    assert n_good >= len(frames) - n_aircraft * repeats, (n_good, len(frames))
    return out, len(frames)


def run_extended(M: int) -> dict:
    """Extended-mode keep-up: assemble_extended + handle_extended_update
    per packet vs ExtendedBatchTracker.on_extended_block per block, same
    device dict stream."""
    from airjax.extended import assemble_extended, handle_extended_update
    from airjax.track.batch import ExtendedBatchTracker
    from airjax.track.icao_cache import IcaoCache

    out, per_block = build_extended_block()
    n_blocks = max(M // per_block, 1)

    aircrafts = {}
    cache = IcaoCache()
    t0 = time.perf_counter()
    t = 1000.0
    n_pkt = 0
    for _ in range(n_blocks):
        for _off, pkt in assemble_extended(out, t, cache):
            handle_extended_update(pkt, aircrafts)
            n_pkt += 1
        t += 0.5
    dt_pkt = time.perf_counter() - t0

    bt = ExtendedBatchTracker()
    cache_b = IcaoCache()
    t0 = time.perf_counter()
    t = 1000.0
    n_bat = 0
    for _ in range(n_blocks):
        n_bat += bt.on_extended_block(out, t, cache_b)
        t += 0.5
    dt_bat = time.perf_counter() - t0

    assert n_pkt == n_bat and len(aircrafts) == len(bt.aircrafts)
    geo_pkt = sum(1 for a in aircrafts.values() if a.geo_position)
    geo_bat = sum(1 for a in bt.aircrafts.values() if a.geo_position)
    assert geo_pkt == geo_bat
    return {
        "extended_messages": n_pkt,
        "extended_per_packet_msgs_per_s": round(n_pkt / dt_pkt),
        "extended_batched_msgs_per_s": round(n_bat / dt_bat),
        "extended_speedup": round(dt_pkt / dt_bat, 2),
        "extended_aircraft": len(aircrafts),
        "extended_with_geo": geo_pkt,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--messages", type=int, default=200_000)
    args = ap.parse_args()
    M = args.messages

    arr = build_stream(M)
    frame_bytes = [arr[i].tobytes() for i in range(M)]

    # --- per-packet path ---
    aircrafts = {}
    t0 = time.perf_counter()
    for i in range(M):
        handle_aircraft_update(
            AdsbPacket.from_bytes(frame_bytes[i], 1000.0), aircrafts
        )
    dt_pkt = time.perf_counter() - t0
    geo_pkt = sum(1 for a in aircrafts.values() if a.geo_position)

    # --- batched path: pre-extract fields per block (device-side in
    # production), time only the host work on_fields performs ---
    blocks = []
    for i in range(0, M, BLOCK):
        sub = arr[i : i + BLOCK]
        blocks.append(
            (jax.device_get(extract_fields(jnp.asarray(sub))), np.arange(len(sub)))
        )
    bt = BatchTracker()
    t0 = time.perf_counter()
    for fields, idx in blocks:
        bt.on_fields(fields, idx, 1000.0)
    dt_bat = time.perf_counter() - t0
    geo_bat = sum(1 for a in bt.aircrafts.values() if a.geo_position)

    assert geo_pkt == geo_bat and len(aircrafts) == len(bt.aircrafts)
    out = {
        "messages": M,
        "per_packet_msgs_per_s": round(M / dt_pkt),
        "batched_msgs_per_s": round(M / dt_bat),
        "speedup": round(dt_pkt / dt_bat, 2),
        "aircraft": len(aircrafts),
        "with_geo": geo_pkt,
    }
    out.update(run_extended(M))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
