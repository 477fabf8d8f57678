"""sensitivity (end to end, host clock run): share of the window's reads
(mates) whose alignment lies on the simulated strand within max_dist of
the simulated origin, from the fetched arrays."""


def read(ctx):
    return ctx.placed / ctx.reads
