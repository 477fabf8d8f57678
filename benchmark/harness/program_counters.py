"""The program's own counters of the traced window, for the metrics that
read them (``source: program_counter``).

``nvbio_tpu_torch.utils.timers`` counts only while a ``torch.profiler``
records. In a run of the benchmark that is the traced window alone, so
after it the counters hold that window's counts. They are read from the
program the run has loaded (``sys.modules``), without importing anything
of it. A program that keeps no counters gives None, and so does a run
whose trace holds no device op (on the CPU, as the other device metrics)."""

from __future__ import annotations

import sys

MODULE = "nvbio_tpu_torch.utils.timers"


def read_counters(ctx) -> dict | None:
    """{name: count} of the traced window, or None."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    read = getattr(sys.modules.get(MODULE), "counters", None)
    return read() if read is not None else None


def share_pct(ctx, part: str, whole: str) -> float | None:
    """100 * part / whole of two counters; None where ``whole`` is 0 or
    absent."""
    c = read_counters(ctx)
    if not c or not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]
