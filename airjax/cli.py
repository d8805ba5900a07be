"""CLI mirroring the reference's subcommands (src/cli.rs, src/main.rs):

  airjax list
  airjax receive <frequency> <sample_rate> <gain> <period> [-d DEVICE]
  airjax adsb [-d DEVICE] [-m {web,interactive,stream}] [-p PLAYBACK]

Extensions beyond the reference (all optional):
  adsb --synthetic N     decode N synthetic blocks (no hardware needed)
  adsb --no-overlap      reference-exact chunking (boundary frames lost)
  adsb --fast            replay without the 2x-real-time sleep
  receive --synthetic    capture synthetic IQ to the .c16 file
"""

from __future__ import annotations

import argparse
import sys


def _cmd_list(args) -> int:
    from airjax import sdr

    try:
        for i, dev in enumerate(sdr.list_devices()):
            print(f"{i}: {dev}")
    except sdr.SdrUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def _cmd_receive(args) -> int:
    import numpy as np

    from airjax.io.c16 import save_c16

    name = f"data_{args.frequency}_{args.sample_rate}_{args.gain}"
    if args.synthetic:
        from airjax.io.source import synthetic_blocks

        n_samples = int(args.sample_rate * args.period)
        chunks = []
        got = 0
        for block in synthetic_blocks(chunk=20000):
            chunks.append(block)
            got += len(block)
            if got >= n_samples:
                break
        data = np.concatenate(chunks)[:n_samples]
        save_c16(data, name)
        print(f"saved {len(data)} synthetic samples to {name}")
        return 0

    from airjax import sdr

    try:
        source = sdr.SdrSource(
            device=args.device,
            frequency_hz=args.frequency,
            sample_rate_hz=args.sample_rate,
            gain_db=args.gain,
        )
    except sdr.SdrUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    import time

    data = []
    start = time.time()
    for block in source.blocks():
        data.append(block)
        if time.time() - start >= args.period:
            break
    source.close()
    all_data = np.concatenate(data)
    save_c16(all_data, name)
    print(f"saved {len(all_data)} samples to {name}")
    return 0


def _cmd_adsb(args) -> int:
    if args.trace:
        # Device/host profile of the whole decode run (extension; view
        # with TensorBoard or ui.perfetto.dev — airjax.observability).
        from airjax import observability

        with observability.trace(args.trace):
            return _cmd_adsb_inner(args)
    return _cmd_adsb_inner(args)


def _cmd_adsb_inner(args) -> int:
    from airjax import observability
    from airjax.config import DEFAULT_CONFIG
    from airjax.runner import run_stream

    # --- source (src/adsb.rs:131-144) ---
    if args.playback:
        from airjax.io.source import playback_blocks

        try:
            source = playback_blocks(
                args.playback,
                realtime_factor=None if args.fast else 2.0,
            )
            source = iter(source)
            # Trigger the file load now for a clean error message.
            first = next(source, None)
        except (OSError, ValueError) as e:
            print(f"error: couldn't load playback data file: {e}", file=sys.stderr)
            return 1
        if first is not None:
            import itertools

            source = itertools.chain([first], source)
        else:
            source = iter(())
    elif args.synthetic is not None:
        from airjax.io.source import synthetic_blocks

        source = synthetic_blocks(n_blocks=args.synthetic)
    else:
        from airjax import sdr

        try:
            sdr_src = sdr.SdrSource(device=args.device)
        except sdr.SdrUnavailable as e:
            print(
                f"error: {e}\nhint: use --playback FILE or --synthetic N",
                file=sys.stderr,
            )
            return 1

        def _sdr_blocks(src=sdr_src, limit=args.max_blocks):
            # Deactivate/close the hardware stream however the consumer
            # stops (bound reached, generator dropped, or exception) —
            # a bare islice over blocks() would leave the SDR streaming
            # into a dead buffer. The live path rides the native SPSC
            # ring (falls back to the plain iterator without the lib).
            try:
                for i, blk in enumerate(src.blocks_ringbuffered()):
                    if limit is not None and i >= limit:
                        return
                    yield blk
            finally:
                src.close()

        source = _sdr_blocks()

    if args.max_blocks is not None and not (
        args.playback is None and args.synthetic is None
    ):
        import itertools

        source = itertools.islice(iter(source), args.max_blocks)

    overlap = not args.no_overlap
    if args.devices is not None:
        if args.no_overlap:
            print(
                "error: --devices requires overlap mode (the sharded "
                "runner's halo IS the overlap)",
                file=sys.stderr,
            )
            return 2
        if args.plot_dir or args.dump_preamble:
            print(
                "error: --plot-dir/--dump-preamble are single-device "
                "debug aids; drop --devices to use them",
                file=sys.stderr,
            )
            return 2

    def _run(source, sink, stats=None):
        """Dispatch to the single-device or the mesh-sharded stream
        runner (--devices N)."""
        if args.devices is not None:
            from airjax.runner import run_stream_sharded

            return run_stream_sharded(
                source, sink,
                n_devices=args.devices,
                extended=args.extended,
                stats=stats,
                recover2=args.recover2,
            )
        return run_stream(
            source, sink,
            overlap=overlap,
            extended=args.extended,
            stats=stats,
            # Stream-mode-only debug aids: in interactive mode the TUI
            # owns the terminal (a decode-thread print would garble
            # curses), and neither flag ever applied to web/interactive
            # before the _run refactor.
            plot_dir=args.plot_dir if args.mode == "stream" else None,
            dump_preamble=args.dump_preamble and args.mode == "stream",
            recover2=args.recover2,
        )

    ref_position = None
    if (args.ref_lat is None) != (args.ref_lon is None):
        print(
            "error: --ref-lat and --ref-lon must be given together",
            file=sys.stderr,
        )
        return 2
    if args.ref_lat is not None:
        ref_position = (args.ref_lat, args.ref_lon)
    if args.batched and args.mode == "stream":
        print(
            "warning: --batched has no effect in stream mode (its contract "
            "is one printed dump per packet)",
            file=sys.stderr,
        )

    # --- tracker checkpoint/resume (extension; see airjax.track.state) ---
    restored = None
    if args.state:
        import os

        if args.mode == "stream":
            print(
                "warning: --state has no effect in stream mode (no tracker)",
                file=sys.stderr,
            )
        elif os.path.exists(args.state):
            from airjax.track.state import load_state

            try:
                restored = load_state(args.state)
                print(f"restored {len(restored)} aircraft from {args.state}")
            except (ValueError, KeyError, TypeError) as e:
                # ValueError covers json.JSONDecodeError too.
                print(f"error: bad state file {args.state}: {e}", file=sys.stderr)
                return 1

    def _save_state(aircrafts) -> None:
        if args.state and args.mode != "stream":
            from airjax.track.state import save_state

            save_state(aircrafts, args.state)
            print(f"saved {len(aircrafts)} aircraft to {args.state}")

    # --- display sink (src/adsb.rs:149-167) ---
    if args.mode == "stream":
        from airjax.ui.stream import jsonl_writer, stream_printer, tee

        sink = stream_printer()
        if args.jsonl:
            sink = tee(sink, jsonl_writer(args.jsonl))
        stats = _run(source, sink)
        observability.log_stats("adsb_stream_done", stats.as_dict())
    elif args.mode == "interactive":
        import threading

        from airjax.ui.tui import TuiApp, interactive_display

        app = TuiApp(ref_position=ref_position, evict_after_s=args.evict_after)
        if restored:
            app.aircrafts.update(restored)
        tui_sink = (
            app.batched_sink(extended=args.extended)
            if args.batched
            else app.on_packet
        )
        from airjax.runner import StreamStats

        tui_stats = StreamStats()
        decode_thread = threading.Thread(
            target=_run,
            args=(source, tui_sink),
            kwargs={"stats": tui_stats},
            daemon=True,
        )
        decode_thread.start()
        interactive_display(app)
        # The daemon decode thread may still be mutating the shared table
        # (batched mode mutates under app._lock); hold the lock for a
        # consistent checkpoint. Per-packet mode only queues from the
        # decode thread, so the lock is uncontended there.
        with app._lock:
            _save_state(app.aircrafts)
        # After the checkpoint: a stats hiccup must never cost the save.
        observability.log_stats("adsb_interactive_done", tui_stats.as_dict())
        return 0
    elif args.mode == "web":
        from airjax.ui.web import WebDisplay

        display = WebDisplay(
            DEFAULT_CONFIG.web_host,
            port=args.port,
            quiet=False,
            extended_schema=args.extended,
            ref_position=ref_position,
            evict_after_s=args.evict_after,
        )
        display.start_background()
        if restored:
            display.aircrafts.update(restored)
        sink = (
            display.batched_sink(extended=args.extended)
            if args.batched
            else display.on_packet
        )
        try:
            stats = _run(source, sink)
            observability.log_stats("adsb_web_done", stats.as_dict())
            print("source exhausted; web server still running (Ctrl-C to quit)")
            import time

            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            return 0
        finally:
            # Same discipline as the TUI save above: the batched sink
            # mutates the shared table under display._lock from this
            # thread, but hold it anyway for symmetry/future threading.
            with display._lock:
                _save_state(display.aircrafts)
    else:  # pragma: no cover
        raise ValueError(args.mode)

    from airjax.device import describe

    print(f"\nstats: {dict(stats.as_dict(), device=describe())}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="airjax", description="JAX tool to interface with sdr devices and decode ADS-B"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("list", help="enumerate SDR devices")

    receive = sub.add_parser("receive", help="capture IQ to a .c16 file")
    receive.add_argument("frequency", type=float, help="Frequency in Hz")
    receive.add_argument("sample_rate", type=float, help="Sample rate in Hz")
    receive.add_argument("gain", type=float, help="Gain")
    receive.add_argument("period", type=int, help="Period in seconds")
    receive.add_argument("-d", "--device", type=int, default=None)
    receive.add_argument("--synthetic", action="store_true")

    adsb = sub.add_parser("adsb", help="decode + display ADS-B traffic")
    adsb.add_argument("-d", "--device", type=int, default=None)
    adsb.add_argument(
        "-m", "--mode", choices=["web", "interactive", "stream"], default="stream"
    )
    adsb.add_argument("-p", "--playback", default=None, help=".c16 capture to replay")
    adsb.add_argument("--synthetic", type=int, default=None, metavar="N")
    adsb.add_argument(
        "--max-blocks", type=int, default=None, metavar="N",
        help="stop after N source blocks (bounds live SDR runs; extension)",
    )
    adsb.add_argument("--no-overlap", action="store_true")
    adsb.add_argument("--fast", action="store_true")
    adsb.add_argument("--port", type=int, default=8080)
    adsb.add_argument(
        "--plot-dir", default=None, help="dump an SVG magnitude plot per frame"
    )
    adsb.add_argument(
        "--dump-preamble", action="store_true",
        help="stream mode: print a textual preamble dump (block graph + "
        "magnitude/index table) per decoded frame (the reference's "
        "print_preamble helpers, src/visualise.rs:38-62)",
    )
    adsb.add_argument(
        "--jsonl", default=None, help="append decoded packets as JSON lines"
    )
    adsb.add_argument(
        "--extended",
        action="store_true",
        help="decode all Mode S downlink formats (DF4/5/11/20/21), not just DF17",
    )
    adsb.add_argument(
        "--batched",
        action="store_true",
        help="web/interactive modes: batched tracker sink (~6x/5x host "
        "throughput); web also coalesces the WS broadcast to one summary "
        "per touched aircraft per block (the reference's per-packet "
        "granularity is the default)",
    )
    adsb.add_argument(
        "--state", default=None, metavar="FILE",
        help="tracker checkpoint: restore at start, save on exit "
        "(web/interactive modes)",
    )
    adsb.add_argument(
        "--ref-lat", type=float, default=None,
        help="receiver latitude (enables surface-position decode)",
    )
    adsb.add_argument(
        "--ref-lon", type=float, default=None,
        help="receiver longitude (enables surface-position decode)",
    )
    adsb.add_argument(
        "--trace", default=None, metavar="DIR",
        help="write a jax.profiler device/host trace of the run to DIR "
        "(view in TensorBoard / Perfetto; extension)",
    )
    adsb.add_argument(
        "--recover2", action="store_true",
        help="also accept frames repaired by a unique DOUBLE bit-flip, "
        "gated on an already-validated ICAO (the stream's seen-set in "
        "parity mode, the acceptance cache in --extended mode) — yield "
        "improvement beyond the reference's 1-flip recovery; composes "
        "with --extended, --batched, and --devices",
    )
    adsb.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="shard the decode over the first N devices of the mesh "
        "(continuous stream, ppermute halo between shards, cross-step "
        "carry; default: single-device runner). Extension — the "
        "reference is strictly single-threaded per stage",
    )
    adsb.add_argument(
        "--evict-after", type=float, default=None, metavar="SECONDS",
        help="drop aircraft unheard for SECONDS (web/interactive modes; "
        "default: never, matching the reference's unbounded table)",
    )

    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from airjax.device import setup_compile_cache

    setup_compile_cache()
    return {"list": _cmd_list, "receive": _cmd_receive, "adsb": _cmd_adsb}[
        args.command
    ](args)


if __name__ == "__main__":
    sys.exit(main())
