"""fm_step_pct (seeding, program counter): of the steps that the FM walks'
plain loops would take over the lanes of the traced window's kernel
launches (``fm_steps_fixed``: lanes x the loop's trip count, a launch of
``csrc/fm_search.cu``), the share that the lanes took (``fm_steps``), in
percent: the lower, the sooner the lanes leave their walks. Nothing where
the window ran no FM walk on the card (q-gram seeding) or the program keeps
no such counter (``harness/program_counters.py``)."""

from benchmark.harness.program_counters import share_pct


def read(ctx):
    return share_pct(ctx, "fm_steps", "fm_steps_fixed")
