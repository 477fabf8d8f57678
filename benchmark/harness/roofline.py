"""Peaks of the card, and the work and bytes of K1 from its call shapes.

Published figures of one NVIDIA H100 SXM5 (NVIDIA's data sheet; at the
full 700 W power limit): HBM3 at 3.35 TB/s; 132 SMs, each issuing 4 warp
instructions of 32 lanes a cycle (128 lane-instructions), at a boost clock
of 1.98 GHz: 33.45 T lane-instructions a second.

K1 (``banded_score_cands``) scores, for each (read, candidate slot) pair,
a band of W diagonals over the read's L rows: L * W DP cells a slot.

The per-cell instruction floor is stated here once, from the recurrence
and not from any kernel's machine code: each cell produces three values
that its neighbours read (H, and the two gap states E and F), each wider
than 8 bits (scores of a 150-base read reach past -127), so at best two of
them share one 32-bit register, and one lane instruction writes one
register. So no implementation of this recurrence issues fewer than 3 / 2
lane instructions a cell. (Bit-parallel encodings of score differences
could go lower; none handles affine gaps with a per-base mismatch
penalty.)
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
LANES_PER_SM_CYCLE = 128
CLOCK_HZ = 1.98e9
ISSUE_PER_S = SMS * LANES_PER_SM_CYCLE * CLOCK_HZ
K1_INSTR_PER_CELL = 1.5


def k1_call(B: int, C: int, L: int, W: int, genome_words: int) -> dict:
    """Cells and bytes of one K1 call: reads, their reverse complements
    and both penalty planes (int32 (B, L) each), lengths, window starts
    (int64) and lengths (int32) a slot, the packed genome (int32 words),
    all read once; scores and best band indices (int32 a slot) written
    once."""
    slots = B * C
    read_bytes = 4 * B * L * 4 + 4 * B + slots * (8 + 4) + 4 * genome_words
    write_bytes = slots * 2 * 4
    return dict(cells=slots * L * W, bytes=read_bytes + write_bytes)


def least_time(cells: float, nbytes: float) -> tuple[float, str]:
    """(seconds, "issue" or "bytes"): the larger of the instruction floor
    over the issue ceiling and the bytes over HBM bandwidth."""
    t_issue = cells * K1_INSTR_PER_CELL / ISSUE_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_issue, "issue") if t_issue >= t_bytes else (t_bytes, "bytes")
