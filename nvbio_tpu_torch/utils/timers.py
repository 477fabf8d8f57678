"""Host timers + per-stage stats (parity with ``nvbio/basic/timer.h`` and
nvBowtie's KernelStats, ``nvBowtie/bowtie2/cuda/stats.h:45-174``).

A copy of ``nvbio_tpu.utils.timers``.
"""

from __future__ import annotations

import dataclasses
import time


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
