"""``vote_round_pct``, the device pipeline's vote counter metric, on the
CPU: the share of the program's ``vote_rounds`` in ``vote_rounds_fixed``,
and nothing where the program keeps no such counter, where the window
voted on no card, where the trace holds no device op, or where there is no
trace."""

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


def test_vote_round_pct_reads_the_share(program):
    program.counters = lambda: dict(vote_rounds=30, vote_rounds_fixed=160,
                                    cand_valid=1, cand_slots=2)
    assert reader("vote_round_pct")(fixed_ctx()) == pytest.approx(18.75)


def test_vote_round_pct_stays_silent(program, monkeypatch):
    read = reader("vote_round_pct")
    ctx = fixed_ctx()
    # a program without counters, or without the vote's (the parent's)
    assert read(ctx) is None
    program.counters = lambda: dict(cand_valid=3, cand_slots=4)
    assert read(ctx) is None
    # a window that voted on no card
    program.counters = lambda: dict(vote_rounds=0, vote_rounds_fixed=0)
    assert read(ctx) is None
    # a trace without device ops (a CPU run), or no trace
    program.counters = lambda: dict(vote_rounds=5, vote_rounds_fixed=10)
    ctx.trace.device = []
    assert read(ctx) is None
    ctx.trace = None
    assert read(ctx) is None
    monkeypatch.delitem(sys.modules, MODULE)
    assert read(fixed_ctx()) is None
