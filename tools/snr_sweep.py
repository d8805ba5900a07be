"""SNR sensitivity sweep (BASELINE config 2): decode probability vs SNR.

Batches of synthetic captures at mixed SNR are decoded by the device pipeline
and (optionally) cross-checked against the golden scalar decoder — the
decode-rate curves must coincide, since the pipelines are bit-identical.

Usage:
  python tools/snr_sweep.py [--captures 64] [--frames 8] [--golden] [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))

from airjax import golden  # noqa: E402
from airjax.config import PipelineConfig  # noqa: E402
from airjax.io import synth  # noqa: E402
from airjax.pipeline import decode_capture_parity  # noqa: E402


def sweep(
    snrs_db=(0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 14.0, 20.0),
    captures_per_snr: int = 8,
    frames_per_capture: int = 8,
    capture_len: int = 24001,
    check_golden: bool = False,
    recover2: bool = False,
    seed: int = 0,
) -> dict:
    cfg = PipelineConfig(block_len=capture_len - 1)
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("SNRTEST"))
    spacing = (capture_len - 600) // frames_per_capture
    offsets = [300 + i * spacing for i in range(frames_per_capture)]

    curve = []
    for snr in snrs_db:
        decoded = 0
        total = 0
        golden_decoded = 0
        r2_decoded = 0
        r2_false_accepts = 0
        for c in range(captures_per_snr):
            iq = synth.modulate(
                [frame] * len(offsets),
                offsets,
                capture_len,
                snr_db=snr,
                seed=seed * 100003 + int(snr * 10) * 101 + c,
            )
            hits, _ = decode_capture_parity(iq, cfg)
            got = {h[1] for h in hits if h[2] == frame}
            decoded += len(got & set(offsets))
            total += len(offsets)
            if recover2:
                r2_got, r2_bad = _decode_recover2(iq, frame)
                r2_decoded += len(r2_got & set(offsets))
                r2_false_accepts += r2_bad
            if check_golden:
                ghits = golden.decode_capture_playback(iq, chunk=cfg.block_len)
                ggot = {o for _, o, p in ghits if p == frame}
                golden_decoded += len(ggot & set(offsets))
        point = {
            "snr_db": snr,
            "decode_rate": round(decoded / total, 4),
            "frames": total,
        }
        if recover2:
            point["decode_rate_recover2"] = round(r2_decoded / total, 4)
            point["recover2_false_accepts"] = r2_false_accepts
            # The gated 2-flip repair must be a pure-win curve: at least
            # the standard rate, and never an emitted wrong frame.
            assert point["decode_rate_recover2"] >= point["decode_rate"], point
            assert r2_false_accepts == 0, point
        if check_golden:
            point["golden_decode_rate"] = round(golden_decoded / total, 4)
            assert point["golden_decode_rate"] == point["decode_rate"], (
                f"device pipeline diverged from golden decoder at {snr} dB"
            )
        curve.append(point)
    return {"curve": curve, "frames_per_capture": frames_per_capture}


def _decode_recover2(iq, true_frame: bytes) -> tuple[set, int]:
    """Whole-capture decode with gated 2-bit recovery (the stream
    runner's acceptance rule: a recovered2 frame's ICAO must have been
    seen in a clean/1-flip frame earlier in the stream). Returns
    (accepted offsets of the true frame, count of accepted frames whose
    bytes are NOT the transmitted frame = false accepts)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from airjax.pipeline import decode_iq_block_r2

    n_off = len(iq) - 240
    capacity = 512
    out = jax.device_get(decode_iq_block_r2(jnp.asarray(iq), n_off, capacity))
    # Same regrow discipline as sweep_extended: a silent capacity
    # truncation must not masquerade as a recovery-rate difference.
    while bool(out["overflow"]) and capacity < n_off:
        capacity = min(capacity * 4, n_off)
        out = jax.device_get(
            decode_iq_block_r2(jnp.asarray(iq), n_off, capacity)
        )
    seen: set[int] = set()
    got: set[int] = set()
    bad = 0
    order = np.argsort(np.asarray(out["offsets"]), kind="stable")
    for k in order:
        if not out["good"][k]:
            continue
        fb = out["frames"][k].tobytes()
        icao = int.from_bytes(fb[1:4], "big")
        if bool(out["recovered2"][k]):
            if icao not in seen:
                continue
        else:
            seen.add(icao)
        if fb == true_frame:
            got.add(int(out["offsets"][k]))
        elif bool(out["recovered2"][k]):
            # Only a GATED 2-flip repair emitting wrong bytes counts as
            # a recover2 false accept; a plain CRC/1-flip noise alias is
            # emitted by the standard path too and must not be
            # misattributed to the repair (it would spuriously trip the
            # zero-false-accepts assert).
            bad += 1
    return got, bad


def sweep_extended(
    snrs_db=(0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 14.0, 20.0),
    captures_per_snr: int = 8,
    capture_len: int = 24001,
    check_golden: bool = False,
    seed: int = 0,
) -> dict:
    """Extended-mode sensitivity: per-kind decode rate vs SNR.

    Short frames carry half the data bits under the same preamble, and
    DF4's validity is a parity-recovered address match rather than a
    zero CRC residual — their curves legitimately differ from DF17's.
    Per capture: 2 DF17 (CRC-validated long), 2 DF11 (PI==CRC), and 2
    DF4 whose recovered icao_ap must equal the known transmitter.
    With check_golden, the scalar oracle (golden.decode_chunk_extended)
    recomputes every per-kind count and must agree exactly.
    """
    import jax
    import jax.numpy as jnp

    from airjax.pipeline import decode_iq_block_extended
    from airjax.protocol import shortframe

    icao = 0x7C6B30
    df17 = synth.make_df17(icao, synth.make_id_me("SNREXT"))
    df11 = shortframe.make_df11(icao)
    df4 = shortframe.make_df4(icao, 12000)
    frames = [df17, df11, df4, df17, df11, df4]
    spacing = (capture_len - 600) // len(frames)
    offsets = [300 + i * spacing for i in range(len(frames))]
    n_off = capture_len - 240

    curve = []
    for snr in snrs_db:
        got = {"df17": 0, "df11": 0, "df4": 0}
        golden_got = {"df17": 0, "df11": 0, "df4": 0}
        per_kind_total = 2 * captures_per_snr
        regrows = 0
        for c in range(captures_per_snr):
            iq = synth.modulate(
                frames, offsets, capture_len,
                snr_db=snr, seed=seed * 90001 + int(snr * 10) * 31 + c,
            )
            # A noisy capture overflowing the candidate capacity would
            # silently drop embedded offsets and could spuriously trip
            # the --golden divergence assert below (ADVICE r3) — and the
            # DF>=24 candidate-class widening (r4) raised the pressure
            # (ADVICE r4). Regrow like the pipeline does and surface the
            # count per SNR point instead of hard-asserting.
            capacity = 512
            out = jax.device_get(
                decode_iq_block_extended(jnp.asarray(iq), n_off, capacity)
            )
            while bool(out["overflow"]) and capacity < n_off:
                capacity = min(capacity * 4, n_off)
                regrows += 1
                out = jax.device_get(
                    decode_iq_block_extended(jnp.asarray(iq), n_off, capacity)
                )
            offs = np.asarray(out["offsets"])
            for i, off in enumerate(offsets):
                k = np.nonzero(offs == off)[0]
                if not len(k):
                    continue
                k = k[0]
                kind = ("df17", "df11", "df4")[i % 3]
                ok = (
                    bool(out["good_long"][k]) if kind == "df17"
                    else bool(out["good_df11"][k]) if kind == "df11"
                    else bool(out["cand_short_ap"][k])
                    and int(out["icao_ap_short"][k]) == icao
                )
                got[kind] += bool(ok)
            if check_golden:
                ghits = {
                    (o, kd): ap for o, kd, _, ap in golden.decode_chunk_extended(iq)
                }
                for i, off in enumerate(offsets):
                    kind = ("df17", "df11", "df4")[i % 3]
                    gok = (
                        (off, "long") in ghits if kind == "df17"
                        else (off, "df11") in ghits if kind == "df11"
                        else ghits.get((off, "short_ap")) == icao
                    )
                    golden_got[kind] += bool(gok)
        point = {
            "snr_db": snr,
            **{
                f"decode_rate_{k}": round(v / per_kind_total, 4)
                for k, v in got.items()
            },
            "capacity_regrows": regrows,
        }
        if check_golden:
            for k in got:
                point[f"golden_decode_rate_{k}"] = round(
                    golden_got[k] / per_kind_total, 4
                )
                assert golden_got[k] == got[k], (
                    f"extended pipeline diverged from golden decoder "
                    f"({k} at {snr} dB: device {got[k]} vs golden {golden_got[k]})"
                )
        curve.append(point)
    return {"curve": curve, "frames_per_kind_per_capture": 2}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--captures", type=int, default=8)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--golden", action="store_true", help="cross-check scalar oracle")
    p.add_argument("--extended", action="store_true", help="per-DF-kind curves")
    p.add_argument(
        "--recover2", action="store_true",
        help="A/B the gated 2-bit CRC recovery (decode_rate_recover2 "
        "column; asserts >= standard rate and zero false accepts)",
    )
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if args.extended:
        if args.frames != 8:
            print(
                "warning: --frames ignored in --extended mode "
                "(fixed 2xDF17+2xDF11+2xDF4 layout)",
                file=sys.stderr,
            )
        result = sweep_extended(
            captures_per_snr=args.captures, check_golden=args.golden
        )
    else:
        result = sweep(
            captures_per_snr=args.captures,
            frames_per_capture=args.frames,
            check_golden=args.golden,
            recover2=args.recover2,
        )
    text = json.dumps(result, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
