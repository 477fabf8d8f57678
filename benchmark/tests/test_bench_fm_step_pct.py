"""``fm_step_pct``, the seeding layer's counter metric, on the CPU: the
share of the program's ``fm_steps`` in ``fm_steps_fixed``, and nothing
where the program keeps no such counter, where the window ran no FM walk,
where the trace holds no device op, or where there is no trace."""

import sys
from types import ModuleType

import pytest

from benchmark.harness.program_counters import MODULE
from benchmark.tests.test_bench_counters import fixed_ctx, reader


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's timers module."""
    mod = ModuleType(MODULE)
    monkeypatch.setitem(sys.modules, MODULE, mod)
    return mod


def test_fm_step_pct_reads_the_share(program):
    program.counters = lambda: dict(fm_steps=30, fm_steps_fixed=120,
                                    cand_valid=1, cand_slots=2)
    assert reader("fm_step_pct")(fixed_ctx()) == pytest.approx(25.0)


def test_fm_step_pct_stays_silent(program, monkeypatch):
    read = reader("fm_step_pct")
    ctx = fixed_ctx()
    # a program without counters, or without the FM ones (the parent's)
    assert read(ctx) is None
    program.counters = lambda: dict(cand_valid=3, cand_slots=4)
    assert read(ctx) is None
    # a window that ran no FM walk (q-gram seeding)
    program.counters = lambda: dict(fm_steps=0, fm_steps_fixed=0)
    assert read(ctx) is None
    # a trace without device ops (a CPU run), or no trace
    program.counters = lambda: dict(fm_steps=5, fm_steps_fixed=10)
    ctx.trace.device = []
    assert read(ctx) is None
    ctx.trace = None
    assert read(ctx) is None
    monkeypatch.delitem(sys.modules, MODULE)
    assert read(fixed_ctx()) is None
