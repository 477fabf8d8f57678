"""The cell ``g3g-qgroup-se150`` (a GRCh38-sized genome through the Q-Group
index at q 16) at the tiny size of ``conftest`` on the CPU: the port is
judged correct with every check the cell's limits name; the control is
not; a traced run reports the seeding metrics ``seed_fill_pct`` and
``seed_capped_pct`` from the program's counters (here with a stand-in
device op in the trace, since a CPU trace holds none and the counter
metrics stay silent without one), in the new cell and in ``qgram-se150``,
and not in ``fmi-se150``, whose seeding keeps no such counter."""

import json
import os

import pytest
import torch

from benchmark.harness.trace import Trace
from benchmark.tests.conftest import REPO
from benchmark.tests.test_bench_run import run

torch.set_num_threads(1)
CELL = "g3g-qgroup-se150"
SEEDING = ("seed_fill_pct", "seed_capped_pct")


def test_cell_correct_with_every_check(tiny_root, capsys):
    res = run(tiny_root, capsys, CELL)
    assert res["correct"], res["check"]
    with open(os.path.join(REPO, "benchmark", "limits", CELL + ".json")) as f:
        limits = json.load(f)
    assert set(res["check"]) == {k for k, v in limits.items()
                                 if isinstance(v, (int, float))} == {
        "wrong_fields", "missed_seeded", "missed_second", "missed_reseed"}
    assert res["check"]["wrong_fields"]["value"] == 0
    assert set(res["metrics"]) == {"reads_per_s", "sensitivity", "setup_s"}
    assert res["metrics"]["sensitivity"]["value"] > 0.9


def test_control_fails(tiny_root, capsys):
    res = run(tiny_root, capsys, CELL, "--control",
              "use_quality_penalties=false")
    assert not res["correct"]
    assert res["check"]["wrong_fields"]["value"] > 0


@pytest.fixture
def device_op(monkeypatch):
    """Every trace gains one stand-in device op inside its window."""
    orig = Trace.from_profile.__func__

    def from_profile(cls, prof, window):
        tr = orig(cls, prof, window)
        tr.device.append(("stand-in", tr.t0, tr.t0 + 1))
        return tr

    monkeypatch.setattr(Trace, "from_profile", classmethod(from_profile))


@pytest.mark.parametrize("workload", [CELL, "qgram-se150", "fmi-se150"])
def test_traced_run_reports_the_seeding_metrics(tiny_root, capsys,
                                                device_op, workload):
    from nvbio_tpu_torch.utils import timers

    # a run is a process of its own: no counts of an earlier test's run
    timers.reset_counters()
    res = run(tiny_root, capsys, workload, trace=1)
    assert res["correct"]
    if workload == "fmi-se150":
        assert not set(SEEDING) & set(res["metrics"])
        return
    fill = res["metrics"]["seed_fill_pct"]["value"]
    capped = res["metrics"]["seed_capped_pct"]["value"]
    assert 0 < fill <= 100 and 0 <= capped < 100
    assert res["metrics"]["seed_fill_pct"]["unit"] == "%"
