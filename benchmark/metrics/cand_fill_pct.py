"""cand_fill_pct (kernels, program counter): of the candidate slots that
K1 scored in the traced window (``cand_slots``, B x C a call), the share
that held a candidate (``cand_valid``), in percent: its useful work over
its attempted work (``harness/program_counters.py``)."""

from benchmark.harness.program_counters import share_pct


def read(ctx):
    return share_pct(ctx, "cand_valid", "cand_slots")
