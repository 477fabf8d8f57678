"""k1_roofline (kernels, device trace): the least time of the traced
window's K1 calls (``banded_score_cands``: the band's DP cells and the
bytes read and written once, against the card's published peaks,
``harness/roofline.py``) over K1's traced device time, in percent.
Returns (value, what bounds it); nothing where no K1 kernel ran."""

from benchmark.harness import roofline

KERNEL = "banded_score_cands_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.k1_calls:
        return None
    busy = sum(t for _, t in ctx.trace.ops_by_name(KERNEL).values())
    if busy <= 0:
        return None
    least, bounds = 0.0, set()
    for B, C, L, W, words in ctx.k1_calls:
        w = roofline.k1_call(B, C, L, W, words)
        t, bound = roofline.least_time(w["cells"], w["bytes"])
        least += t
        bounds.add(bound)
    return 100.0 * least / busy, "bound by " + " and ".join(sorted(bounds))
