"""The dedup vote's operands (``kernels.vote_reps``), made from a seed:
rows shaped like the mapper's calls, and rows built to reach each edge of
the tournament, shared by ``chip_smoke.py`` and the tests.

The mapper's calls (bowtie2's defaults, 150-base reads, a batch of 2^18):
the first pass votes 2^19 rows (both strands) of CH = 36 candidates with
q-gram seeding and 54 with FM seeding, for NCH = 8 reps; the reseed pass
votes the 1-mismatch loci of each of its 32768 x 18 seeds, 8 (FM), 36
(q = 12) or 48 (q = 16) a seed, for 2, then 2 x 32768 rows of 54 for 8.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 30            # 2 * max_dist at bowtie2's defaults
# (name, rows, n, n_reps, share of valid candidates)
PATH_SHAPES = (
    ("pass-qgram", 1 << 19, 36, 8, 0.9),
    ("pass-fm", 1 << 19, 54, 8, 0.1),
    ("within-fm", 32768 * 18, 8, 2, 0.5),
    ("within-q16", 32768 * 18, 48, 2, 0.3),
)
EDGE_NS = (1, 31, 32, 33, 36, 48, 54, 64, 65, 300)
GENOME = 3_100_000_000   # positions past 2^31, as at GRCh38's length


def path_operands(rows: int, n: int, fill: float, seed: int, dev,
                  tol: int = TOL):
    """(pv, valid) of ``rows`` rows of ``n`` candidates: each row's valid
    candidates (a share ``fill``) lie on 1 to 4 loci of a 3.1 Gbp genome,
    within ``tol`` of their locus, as a read's seed hits do."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    loci = torch.randint(0, GENOME, (rows, 4), generator=gen, device=dev)
    n_loci = torch.randint(1, 5, (rows, 1), generator=gen, device=dev)
    pick = (torch.rand((rows, n), generator=gen, device=dev)
            * n_loci).long()
    pv = torch.gather(loci, 1, pick) + torch.randint(
        0, tol + 1, (rows, n), generator=gen, device=dev)
    valid = torch.rand((rows, n), generator=gen, device=dev) < fill
    return pv, valid


def edge_rows(n: int, tol: int = TOL, seed: int = 0):
    """(pv (R, n) int64, valid (R, n) bool, names): rows that reach each
    edge of the tournament that fits in n columns, then random rows."""
    rng = np.random.default_rng(seed + n)
    rows, names = [], []

    def add(name, pos, ok=None):
        pos = np.asarray(pos, np.int64)[:n]
        p = np.zeros(n, np.int64)
        v = np.zeros(n, bool)
        p[:len(pos)] = pos
        v[:len(pos)] = True if ok is None else np.asarray(ok)[:n]
        # the columns past the given ones: invalid, with stray positions
        p[len(pos):] = rng.integers(0, GENOME, n - len(pos))
        order = rng.permutation(n)
        rows.append((p[order], v[order]))
        names.append(name)

    base = 2**31 + 12345
    add("all invalid", rng.integers(0, GENOME, n), np.zeros(n, bool))
    add("one valid", [base])
    add("two apart by tol", [base, base + tol])
    add("two apart by tol + 1", [base, base + tol + 1])
    # votes 2, 3, 2: sel is the middle one, the rep its left neighbour
    add("member left of sel", [base, base + tol, base + 2 * tol])
    # two clusters of equal votes: the left one first
    add("tie in votes", [base + 10 * tol, base + 10 * tol + 1, base,
                         base + 1])
    add("fewer clusters than reps", [base, base + 5 * tol, base + 5 * tol])
    add("invalid near a valid one", [base, base + 1, base + 2],
        [True, False, True])
    add("big cluster", base + rng.integers(0, tol + 1, 40))
    add("chain", base + tol * np.arange(n))
    add("below 2^31", rng.integers(0, 2**31, n))
    add("past 2^31", 2**31 + rng.integers(0, tol * n, n))
    add("many loci", rng.integers(0, GENOME, n))
    for _ in range(6):
        loci = rng.integers(0, GENOME, rng.integers(1, 6))
        pos = loci[rng.integers(0, len(loci), n)] + rng.integers(
            0, tol + 1, n)
        add("clustered", pos, rng.random(n) < rng.random())
    pv = np.stack([r[0] for r in rows])
    valid = np.stack([r[1] for r in rows])
    return torch.from_numpy(pv), torch.from_numpy(valid), names
