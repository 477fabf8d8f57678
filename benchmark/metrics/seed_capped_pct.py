"""seed_capped_pct (seeding, program counter): of the valid seeds of the
q-gram seed grids' exact lookups in the traced window (``seed_valid``,
both passes), the share whose range held more than ``hits_per_seed``
positions (``seed_capped``), in percent: the seeds whose loci the
stratified slots only sample, so that a read's true locus may go unseen.
Nothing where the window ran no q-gram lookup (FM seeding) or the program
keeps no such counter (``harness/program_counters.py``)."""

from benchmark.harness.program_counters import share_pct


def read(ctx):
    return share_pct(ctx, "seed_capped", "seed_valid")
