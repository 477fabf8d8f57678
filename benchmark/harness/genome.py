"""The benchmark's genome: a synthetic genome with the composition and
repeat shares of a configuration's named assembly, made from a seed.

The configuration's ``genome`` block states, as shares of the genome's
bases, what its source publishes: the GC content, the dispersed repeats
(transposon-derived copies), the local inverted repeats and the tandem
repeats. The genome is written left to right as four kinds of segment:

- fresh segments: i.i.d. bases at the stated GC content;
- dispersed copies: an earlier segment copied in either orientation, with
  substitutions at a rate drawn uniformly in [``div_lo``, ``div_hi``];
- inverted repeats: the reverse complement of the bases just written,
  after a short fresh spacer, diverged alike;
- tandem arrays: a short unit repeated back to back, the array diverged
  alike.

Each next segment is of the kind furthest below its share so far (fresh
when none is), so the shares come out as stated; lengths are lognormal
(the configuration's ``assumed`` block gives the reasons). Codes: A 0, C 1,
G 2, T 3.
"""

from __future__ import annotations

import numpy as np

KINDS = ("dispersed_share", "inverted_share", "tandem_share")


def fresh(rng: np.random.Generator, n: int, gc: float) -> np.ndarray:
    """``n`` i.i.d. bases with GC content ``gc``."""
    cdf = np.cumsum([(1 - gc) / 2, gc / 2, gc / 2])
    return np.searchsorted(cdf, rng.random(n)).astype(np.uint8)


def diverge(rng: np.random.Generator, seg: np.ndarray, lo: float,
            hi: float) -> np.ndarray:
    """``seg`` with substitutions at a rate drawn uniformly in [lo, hi]."""
    nm = rng.binomial(len(seg), rng.uniform(lo, hi))
    if nm:
        at = rng.integers(0, len(seg), size=nm)
        seg[at] = (seg[at] + rng.integers(1, 4, size=nm)) % 4
    return seg


def revcomp(seg: np.ndarray) -> np.ndarray:
    return (3 - seg)[::-1].copy()


def lognormal(rng, mu: float, sigma: float, lo: int) -> int:
    return int(rng.lognormal(mu, sigma)) + lo


def make_genome(spec: dict, seed: int) -> np.ndarray:
    """The genome a configuration's ``genome`` block describes, from the
    run's seed: ``length`` uint8 codes."""
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0x6E0E])
    n = int(spec["length"])
    gc = float(spec["gc"])
    lo, hi = float(spec["div_lo"]), float(spec["div_hi"])
    g = np.empty(n, np.uint8)
    # a fresh prefix, so that the first copies have a source pool
    pos = min(n, int(spec["unique_prefix"]))
    g[:pos] = fresh(rng, pos, gc)
    written = dict.fromkeys(KINDS, 0)
    while pos < n:
        deficit = {k: spec[k] * pos - written[k] for k in KINDS}
        kind = max(deficit, key=deficit.get)
        if deficit[kind] <= 0:
            kind = None
        if kind == "dispersed_share":
            ln = min(lognormal(rng, *spec["dispersed_len"], 50), pos)
            src = int(rng.integers(0, pos - ln + 1))
            seg = g[src:src + ln].copy()
            if rng.random() < 0.5:
                seg = revcomp(seg)
            seg = diverge(rng, seg, lo, hi)
        elif kind == "inverted_share":
            arm = min(lognormal(rng, *spec["inverted_arm_len"], 20), pos)
            spacer = fresh(rng, int(rng.integers(0, spec["inverted_spacer"]
                                                 + 1)), gc)
            seg = np.concatenate([spacer, diverge(
                rng, revcomp(g[pos - arm:pos]), lo, hi)])
            # the spacer is fresh sequence, not repeat
            written["inverted_share"] -= len(spacer)
        elif kind == "tandem_share":
            unit = fresh(rng, int(rng.integers(*spec["tandem_unit"])), gc)
            reps = int(rng.integers(spec["tandem_copies"][0],
                                    spec["tandem_copies"][1] + 1))
            seg = diverge(rng, np.tile(unit, reps), lo, hi)
        else:
            seg = fresh(rng, lognormal(rng, *spec["fresh_len"], 100), gc)
        seg = seg[:n - pos]
        g[pos:pos + len(seg)] = seg
        if kind is not None:
            written[kind] += len(seg)
        pos += len(seg)
    return g
