"""The metrics that read the program's counters, and the per-layer metrics
that were there before them, on the CPU: from one fixed synthetic trace
the five earlier metrics read the values they always read; the counter
metrics read the shares of the program's counters, and nothing where the
program has none, where the trace holds no device op, or where a share's
whole is 0; the program's ``nvbio.*`` spans leave the trace's device ops
and benchmark spans as they were."""

import sys
from types import ModuleType, SimpleNamespace

import pytest
import torch

from benchmark.harness.program_counters import MODULE
from benchmark.harness.spec import Spec
from benchmark.harness.trace import Trace
from benchmark.tests.conftest import REPO

EARLIER = ("dispatch_host_ms", "device_ops_per_batch", "k1_roofline",
           "device_idle_pct", "index_build_s")
COUNTED = ("reseed_fill_pct", "cand_fill_pct")


def reader(name):
    return Spec(REPO, "qgram-se150").reader(name)


def fixed_ctx():
    """A 10 ms window: K1 busy [1, 3] ms, a copy [2.5, 4] ms, a fill
    [6, 7] ms; a dispatch span; two K1 calls; three dispatches."""
    ms = 1_000_000
    device = [("banded_score_cands_kernel<31>", 1 * ms, 3 * ms),
              ("Memcpy HtoD (Pageable -> Device)", int(2.5 * ms), 4 * ms),
              ("Memset (Device)", 6 * ms, 7 * ms)]
    spans = [("bench.window", 0, 10 * ms), ("bench.dispatch", 0, 5 * ms)]
    trace = Trace(0, 10 * ms, device, spans)
    return SimpleNamespace(
        trace=trace, traced_batches=2, index_build_s=4.25,
        window=dict(dispatch_s=[0.1, 0.2, 0.3], seconds=1.0, batches=3),
        k1_calls=[(1000, 16, 150, 31, 100), (125, 16, 150, 31, 100)])


def test_earlier_metrics_read_what_they_read():
    ctx = fixed_ctx()
    got = {m: reader(m)(ctx) for m in EARLIER}
    assert got["dispatch_host_ms"] == pytest.approx(200.0)
    assert got["device_ops_per_batch"] == 1.5
    # 1125 x 16 x 150 x 31 cells at the lane-instruction peak over 2 ms
    assert got["k1_roofline"] == (pytest.approx(0.18764527376033058),
                                  "bound by issue")
    assert got["device_idle_pct"] == pytest.approx(60.0)
    assert got["index_build_s"] == 4.25


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's timers module with given counts."""
    mod = ModuleType(MODULE)
    monkeypatch.setitem(sys.modules, MODULE, mod)
    return mod


def test_counted_metrics_read_the_shares(program):
    program.counters = lambda: dict(reseed_needed=36, reseed_rows=24,
                                    cand_valid=30, cand_slots=120)
    ctx = fixed_ctx()
    assert reader("reseed_fill_pct")(ctx) == pytest.approx(150.0)
    assert reader("cand_fill_pct")(ctx) == pytest.approx(25.0)


def test_counted_metrics_stay_silent(program, monkeypatch):
    ctx = fixed_ctx()
    # a program without counters (the one before they were added)
    assert all(reader(m)(ctx) is None for m in COUNTED)
    program.counters = dict
    assert all(reader(m)(ctx) is None for m in COUNTED)
    # no reseed pass ran
    program.counters = lambda: dict(reseed_rows=0, cand_valid=3,
                                    cand_slots=4)
    assert reader("reseed_fill_pct")(ctx) is None
    assert reader("cand_fill_pct")(ctx) == pytest.approx(75.0)
    # a trace without device ops (a CPU run), or no trace
    ctx.trace.device = []
    assert all(reader(m)(ctx) is None for m in COUNTED)
    ctx.trace = None
    assert all(reader(m)(ctx) is None for m in COUNTED)
    monkeypatch.delitem(sys.modules, MODULE)
    assert all(reader(m)(fixed_ctx()) is None for m in COUNTED)


def test_program_spans_leave_the_trace_as_it_was():
    """A CPU profile of a mapper batch inside a benchmark span: the trace
    keeps the benchmark's spans alone, and no device op."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.io.reference import Reference

    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    m = ReadMapper.build(Reference(["t"], np.array([0, 20000]), g, None),
                         MapParams(max_read_len=60, seed_len=16,
                                   seed_stride=10, max_dist=5),
                         device="cpu")
    codes = np.stack([g[p:p + 60] for p in rng.integers(0, 19000, 16)])
    batch = ReadBatch([""] * 16, codes, np.full(codes.shape, 30, np.uint8),
                      np.full(16, 60, np.int32))
    torch.set_num_threads(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with record_function("bench.dispatch"):
                m.fetch(m.dispatch(batch)).wait()
    tr = Trace.from_profile(prof, "bench.window")
    assert sorted(n for n, _, _ in tr.spans) == ["bench.dispatch",
                                                 "bench.window"]
    assert tr.device == []
