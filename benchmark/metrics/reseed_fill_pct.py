"""reseed_fill_pct (device pipeline, program counter): of the reseed
queue's rows in the traced window (``reseed_rows``, B2 a pass), the share
that held a read needing the pass (``reseed_needed``), in percent.
Higher is better only up to 100: above 100 (not capped) is overflow, reads
that needed the pass and were left out, which ``reseed_overflow`` flags.
Nothing where the window ran no reseed pass
(``harness/program_counters.py``)."""

from benchmark.harness.program_counters import share_pct


def read(ctx):
    return share_pct(ctx, "reseed_needed", "reseed_rows")
