"""Observability: profiler traces, per-stage counters, structured logging.

The reference has none of this — println! breadcrumbs and two commented-out
counters (src/adsb.rs:93-94,120). Here every jitted decode returns a stats
struct (samples in, windows scanned, preambles hit, CRC pass/recovered,
overflow — see airjax.pipeline / airjax.runner.StreamStats), and this
module adds:

  * `trace(...)`   — context manager around jax.profiler for device traces
                     viewable in TensorBoard/Perfetto
  * `StageTimer`   — host-side wall-clock stage accounting
  * `log_stats`    — one-line structured (JSON) stat logging
"""

from __future__ import annotations

import contextlib
import json
import logging
import time

import jax

logger = logging.getLogger("airjax")


@contextlib.contextmanager
def trace(log_dir: str | None = None, enabled: bool = True):
    """Capture a device profile of the enclosed block.

    `log_dir` defaults to `<repo>/traces` (airjax.device.TRACE_DIR). View
    with: tensorboard --logdir <log_dir>  (or open the .perfetto trace in
    ui.perfetto.dev).
    """
    if not enabled:
        yield
        return
    if log_dir is None:
        from airjax.device import TRACE_DIR

        log_dir = str(TRACE_DIR)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("profile written to %s", log_dir)


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough to always on."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, dt: float) -> None:
        """Manual accounting for spans that don't nest as a `with` block
        (e.g. a region ending mid-function in airjax.runner._process).

        counts is written BEFORE totals so a concurrent as_dict (a UI
        thread reading stats while the decode thread accounts) never
        sees a totals key without its counts entry."""
        self.counts[name] = self.counts.get(name, 0) + 1
        self.totals[name] = self.totals.get(name, 0.0) + dt

    def as_dict(self) -> dict:
        # Snapshot both dicts first (C-level copies are atomic under the
        # GIL): safe to call from another thread mid-stream.
        totals, counts = dict(self.totals), dict(self.counts)
        return {
            name: {
                "total_s": round(total, 6),
                "calls": counts[name],
                "mean_ms": round(total / counts[name] * 1e3, 3),
            }
            for name, total in sorted(totals.items())
        }


def log_stats(event: str, stats: dict, level: int = logging.INFO) -> None:
    """Structured one-line stat log (absl-style key=value JSON)."""
    logger.log(level, "%s %s", event, json.dumps(stats, sort_keys=True))
