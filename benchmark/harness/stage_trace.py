"""The program's stages in a traced window: a ``Trace`` (``trace.py``)
that also keeps the program's ``nvbio.*`` host spans beside the
benchmark's, the CUDA runtime calls, and each device op's correlation id.
Each device op is then put down to the spans that held the host when its
launch or copy call was made, the host's waits to the span they were made
in, and each idle gap to the innermost span of either set around its
middle (``Trace.idle_gaps`` over both sets).

The result line does not read it yet, since ``runner.traced_window``
builds a plain ``Trace``; ``benchmark/stages.py`` prints what it reads
(PERF.md, Open questions)."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.harness.trace import SPAN_PREFIX, Trace, _annotation, event_ns

# the program's spans (``nvbio_tpu_torch.utils.timers.span``)
PROGRAM_PREFIX = "nvbio."

# CUDA calls that hold the host until the device (a stream, an event) is
# done; ``cudaMemcpy`` is the blocking copy. A copy call whose device copy
# is from or to pageable host memory also waits (``Pageable`` in the copy's
# name): a pageable ``.to(device)`` is ``cudaMemcpyAsync``, staged by CUDA
# behind the stream's earlier work, then ``cudaStreamSynchronize``.
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


def chains(spans: list, times: list) -> list:
    """For each host time, the names of the spans around it, outermost
    first. Spans are (name, start, end) and nest (one thread)."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out = [()] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = tuple(s[0] for s in stack)
    return out


@dataclass
class StageTrace(Trace):
    """``Trace`` with both sets of host spans in ``spans``, the CUDA calls
    (name, start, end, correlation id) in ``calls``, and ``corr``, the
    correlation id of each op of ``device``, in its order."""

    calls: list = field(default_factory=list)
    corr: list = field(default_factory=list)

    @classmethod
    def from_profile(cls, prof, window: str) -> "StageTrace":
        tr, ops = cls(0, 0), []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = event_ns(ev, "start")
            end = start + event_ns(ev, "duration")
            on_device = "CUDA" in str(ev.device_type())
            if name.startswith((SPAN_PREFIX, PROGRAM_PREFIX)):
                if not on_device:
                    tr.spans.append((name, start, end))
            elif on_device:
                if not _annotation(ev):
                    ops.append((name, start, end, ev.correlation_id()))
            elif name.startswith("cu"):
                tr.calls.append((name, start, end, ev.correlation_id()))
        ops.sort(key=lambda op: op[1])
        tr.device = [op[:3] for op in ops]
        tr.corr = [op[3] for op in ops]
        tr.t0, tr.t1 = next((s, e) for n, s, e in tr.spans if n == window)
        return tr

    def launch_chains(self) -> list:
        """For each device op, the spans around its launch or copy call,
        outermost first (empty where no call of the trace made it)."""
        at = {c[3]: c[1] for c in self.calls}
        return chains(self.spans, [at.get(c, -1) for c in self.corr])

    def device_s(self, name: str) -> float:
        """Device seconds, in the window, of the ops launched inside a span
        ``name`` at any depth: an op launched in ``nvbio.seed`` inside
        ``nvbio.reseed`` counts toward both."""
        return sum(max(0, min(e, self.t1) - max(s, self.t0))
                   for (_, s, e), ch in zip(self.device, self.launch_chains())
                   if name in ch) / 1e9

    def call_s(self, within: str) -> dict:
        """{(innermost span, call name): seconds} the host spent in CUDA
        calls made inside a span ``within``; a waiting call (``SYNC_CALLS``
        and pageable copies) is named ``wait:<name>``."""
        pageable = {c for (n, _, _), c in zip(self.device, self.corr)
                    if "Pageable" in n}
        by = {}
        for c, ch in zip(self.calls,
                         chains(self.spans, [c[1] for c in self.calls])):
            if within in ch:
                wait = c[0] in SYNC_CALLS or c[3] in pageable
                key = (ch[-1], ("wait:" if wait else "") + c[0])
                by[key] = by.get(key, 0.0) + (c[2] - c[1]) / 1e9
        return by

    def sync_s(self, within: str) -> tuple:
        """(seconds, {innermost span: seconds}) the host spent in waiting
        calls made inside a span ``within``."""
        by = {}
        for (sp, call), t in self.call_s(within).items():
            if call.startswith("wait:"):
                by[sp] = by.get(sp, 0.0) + t
        return sum(by.values()), by

    def covered_share(self) -> float:
        """The share of the device's busy time taken by ops launched inside
        a program span."""
        busy = self.busy_s()
        if busy <= 0:
            return 0.0
        ops = [op for op, ch in zip(self.device, self.launch_chains())
               if any(n.startswith(PROGRAM_PREFIX) for n in ch)]
        return Trace(self.t0, self.t1, ops).busy_s() / busy

    def batches(self) -> int:
        return sum(1 for n, _, _ in self.spans
                   if n == PROGRAM_PREFIX + "dispatch")
