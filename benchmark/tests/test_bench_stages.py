"""What ``harness/stage_trace.py`` reads of the program's stages, on the
CPU: device ops put down to the spans that held their launch, the host's
waits inside the dispatch by innermost span, idle gaps named by the
innermost span of either set, ``stages.py``'s per-batch report of them,
and a CPU profile of a mapper batch read with both sets of spans."""

import numpy as np
import pytest
import torch

from benchmark.harness.stage_trace import StageTrace
from benchmark.stages import report

D, U, S, R = (f"nvbio.{n}" for n in ("dispatch", "upload", "seed",
                                       "reseed"))


def synthetic():
    """A dispatch [0, 100] holding an upload whose pageable copy syncs
    (3-9), a first-pass seed (20-30) and a reseed pass (50-90) with its
    own seed (55-70); one launch outside every program span (120)."""
    spans = [("bench.window", 0, 400), ("bench.dispatch", 0, 110),
             (D, 0, 100), (U, 1, 10), (S, 20, 30), (R, 50, 90), (S, 55, 70)]
    launch = "cudaLaunchKernel"
    calls = [("cudaMemcpyAsync", 2, 3, 1), ("cudaStreamSynchronize", 3, 9, 2),
             (launch, 21, 22, 3), (launch, 56, 57, 4), (launch, 80, 81, 5),
             (launch, 120, 121, 6), ("cudaEventSynchronize", 150, 160, 0)]
    device = [("Memcpy HtoD (Pageable -> Device)", 4, 8),
              ("k_first_seed", 100, 140), ("k_reseed_seed", 140, 200),
              ("k_reseed_vote", 200, 210), ("k_outside", 300, 310)]
    return StageTrace(0, 400, device, spans, calls, [1, 3, 4, 5, 6])


def test_ops_are_put_down_to_the_spans_of_their_launch():
    tr = synthetic()
    # a kernel launched in seed inside reseed counts toward both
    assert tr.device_s(S) == pytest.approx((40 + 60) / 1e9)
    assert tr.device_s(R) == pytest.approx((60 + 10) / 1e9)
    assert tr.device_s(D) == pytest.approx((4 + 40 + 60 + 10) / 1e9)
    assert tr.covered_share() == pytest.approx(114 / 124)
    assert tr.batches() == 1


def test_syncs_inside_the_dispatch_by_innermost_span():
    """The pageable copy's call (1 ns) and its stream sync (6 ns) wait;
    the launches do not."""
    tr = synthetic()
    total, by = tr.sync_s(D)
    assert total == pytest.approx(7e-9) and by == pytest.approx({U: 7e-9})
    # the event sync at 150 lies outside every dispatch
    assert tr.sync_s("bench.dispatch")[0] == pytest.approx(7e-9)
    assert tr.call_s(R) == pytest.approx({(S, "cudaLaunchKernel"): 1e-9,
                                          (R, "cudaLaunchKernel"): 1e-9})
    assert tr.call_s(U) == pytest.approx({
        (U, "wait:cudaMemcpyAsync"): 1e-9,
        (U, "wait:cudaStreamSynchronize"): 6e-9})


def test_idle_gaps_take_the_innermost_span_of_either_set():
    """Busy [4, 8], [100, 210], [300, 310] of [0, 400]: the gap around 54
    lies in the reseed pass (its seed starts at 55), the one around 2 in
    the upload; those after the dispatch in the benchmark's spans."""
    gaps = [(n, round(s * 1e9)) for n, s in synthetic().idle_gaps()]
    assert gaps == [(R, 92), ("bench.window", 90), ("bench.window", 90),
                    (U, 4)]


def test_report_per_batch(monkeypatch):
    monkeypatch.setattr("benchmark.harness.runner.TRACED_BATCHES", 1)
    got = report(synthetic(), dict(reseed_needed=3, reseed_rows=8,
                                   cand_valid=0, cand_slots=0))
    assert got["seed_device_ms"] == pytest.approx(1e-4)
    assert got["reseed_device_ms"] == pytest.approx(7e-5)
    assert got["dispatch_sync_ms"] == pytest.approx(7e-6)
    assert got["dispatch_sync_by"] == pytest.approx({U: 7e-6})
    assert got["ops_per_batch"] == 5
    assert got["reseed_fill_pct"] == pytest.approx(37.5)
    # no slots: no share
    assert "cand_fill_pct" not in got


def test_a_profile_keeps_both_sets_of_spans():
    """A CPU profile of a mapper batch inside benchmark spans: the
    program's spans beside the benchmark's, and no device op."""
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
    tr = StageTrace.from_profile(prof, "bench.window")
    names = {n for n, _, _ in tr.spans}
    assert {"bench.window", "bench.dispatch", D, U, S,
            "nvbio.fetch", "nvbio.wait"} <= names
    assert tr.device == [] and tr.corr == [] and tr.batches() == 1
