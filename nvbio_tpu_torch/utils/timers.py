"""Host timers + per-stage stats (parity with ``nvbio/basic/timer.h`` and
nvBowtie's KernelStats, ``nvBowtie/bowtie2/cuda/stats.h:45-174``), and the
mapper's stage spans and counters, recorded while a ``torch.profiler``
records (``span``, ``count``).

``Timer`` and ``StageStats`` are a copy of ``nvbio_tpu.utils.timers``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
from torch.profiler import record_function


class Timer:
    def __init__(self):
        self._t0 = None
        self.seconds = 0.0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.seconds = time.perf_counter() - self._t0
        return self.seconds

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


@dataclasses.dataclass
class StageStats:
    """Accumulated per-stage timing/throughput (KernelStats equivalent)."""

    name: str
    calls: int = 0
    time: float = 0.0
    units: int = 0

    def add(self, seconds: float, units: int = 0) -> None:
        self.calls += 1
        self.time += seconds
        self.units += units

    @property
    def avg_speed(self) -> float:
        return self.units / self.time if self.time > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.name:16s} {self.time:8.2f}s  {self.calls:6d} calls"
            + (f"  {self.avg_speed:12,.0f} units/s" if self.units else "")
        )


# ---- stage spans and counters ---------------------------------------------
# The mapper's layers open a span and bump counters as they go. Both act
# only while a torch.profiler records in this process, which is their only
# switch: a span is then ``record_function("nvbio.<name>")``, on the
# profiler's clock beside the device events its calls launch (so ``map
# --profile``'s Chrome trace shows it), and a counter adds its value.
# Otherwise a span is one shared null context (a bare record_function costs
# ~10 us a call) and a counter neither launches a device op nor reads one.

SPAN_PREFIX = "nvbio."
_NULL_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch.profiler records in this process: the one switch of
    the spans and counters."""
    return torch.autograd._profiler_enabled()


def span(name: str, ordinal: int | None = None):
    """The span ``nvbio.<name>`` while a profiler records, else a null
    context; ``ordinal`` (the batch's, for the dispatch, fetch and wait of
    one batch) goes in the span's ``args``."""
    if not recording():
        return _NULL_SPAN
    return record_function(SPAN_PREFIX + name,
                           None if ordinal is None else str(ordinal))


_counters: dict = {}


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a profiler records: a
    host int, or a tensor on its device whose elements are added (a 0-dim
    count, or a mask of what is counted), or a function of no arguments
    that gives one of these from tensors it holds. A tensor or function is
    held as it is, with no device op and no read back (a sum would add ops
    to the profile), until the counters are read or reset; the caller must
    not change what it holds in place."""
    if recording():
        _counters.setdefault(name, []).append(value)


def _total(v) -> int:
    if callable(v):
        v = v()
    return int(v.sum()) if isinstance(v, torch.Tensor) else v


def counters() -> dict:
    """{name: total} of the counters since the last reset; what a counter
    holds on a device is worked out, summed and read back here (a
    sync)."""
    for name, vals in _counters.items():
        _counters[name] = [sum(_total(v) for v in vals)]
    return {name: vals[0] for name, vals in _counters.items()}


def reset_counters() -> None:
    _counters.clear()
