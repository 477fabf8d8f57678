"""What a ``torch.profiler`` trace of the traced window says: device busy
time, device ops by name, and the idle gaps with what the host was doing
in them. Reads the profiler's raw events (no per-event Python objects of
``key_averages``, which cost about half a millisecond a kernel)."""

from __future__ import annotations

from dataclasses import dataclass, field

# the benchmark's own host spans, named "bench.<step>" in record_function
SPAN_PREFIX = "bench."


def event_ns(ev, what: str) -> int:
    """An event's start or duration in ns, whatever the torch version."""
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else False


@dataclass
class Trace:
    """Device events (name, start ns, end ns) and the benchmark's host
    spans of one traced window [t0, t1] (ns, the profiler's clock): the
    host span named ``window``."""

    t0: int
    t1: int
    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)

    @classmethod
    def from_profile(cls, prof, window: str) -> "Trace":
        tr = cls(0, 0)
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = event_ns(ev, "start")
            end = start + event_ns(ev, "duration")
            if name.startswith(SPAN_PREFIX):
                # the host span, and its shadow on the device's timeline
                # (a user annotation, not an operation)
                if "CUDA" not in str(ev.device_type()):
                    tr.spans.append((name, start, end))
            elif "CUDA" in str(ev.device_type()) and not _annotation(ev):
                tr.device.append((name, start, end))
        tr.device.sort(key=lambda e: e[1])
        tr.t0, tr.t1 = next((s, e) for n, s, e in tr.spans if n == window)
        return tr

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, clipped to the
        window."""
        out = []
        for _, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def ops_by_name(self, contains: str | None = None) -> dict:
        """{name: (count, device seconds)} of the device events."""
        out = {}
        for name, s, e in self.device:
            if contains is not None and contains not in name:
                continue
            c, t = out.get(name, (0, 0.0))
            out[name] = (c + 1, t + (e - s) / 1e9)
        return out

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle gaps of the device in the window, each named
        by the benchmark span the host was in at its middle."""
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = (s + e) // 2
            # the innermost span around the gap's middle
            inner = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            name = (min(inner, key=lambda sp: sp[2] - sp[1])[0]
                    if inner else "host outside the benchmark's spans")
            out.append([name, (e - s) / 1e9])
        return out

    def top_ops(self, top: int = 10) -> list:
        rows = sorted(self.ops_by_name().items(), key=lambda kv: -kv[1][1])
        return [[name, t] for name, (_, t) in rows[:top]]
