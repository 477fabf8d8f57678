"""seed_fill_pct (seeding, program counter): of the hit slots of the
q-gram seed grids' exact lookups in the traced window (``seed_slots``:
``hits_per_seed`` a valid seed, both passes), the share that located a
position (``seed_hits``), in percent: the dedup vote's and K1's columns
that hold a locus. Nothing where the window ran no q-gram lookup (FM
seeding) or the program keeps no such counter
(``harness/program_counters.py``)."""

from benchmark.harness.program_counters import share_pct


def read(ctx):
    return share_pct(ctx, "seed_hits", "seed_slots")
