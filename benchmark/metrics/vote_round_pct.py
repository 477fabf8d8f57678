"""vote_round_pct (device pipeline, program counter): of the rounds that
the dedup vote's plain version plays over the rows of the traced window's
launches (``vote_rounds_fixed``: rows x reps, a launch of
``csrc/vote_reps.cu``), the share that the rows played before they left
(``vote_rounds``), in percent: how much of the tournament the cell's
candidates really fill. Nothing where the program keeps no such counter
(``harness/program_counters.py``) or the window voted on no card."""

from benchmark.harness.program_counters import share_pct


def read(ctx):
    return share_pct(ctx, "vote_rounds", "vote_rounds_fixed")
