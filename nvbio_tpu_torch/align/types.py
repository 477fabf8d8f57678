"""Aligner and scoring-scheme types (copy of ``nvbio_tpu.align.types``).

The aligners are hashable frozen dataclasses, {EditDistance, SmithWaterman,
Gotoh, Hamming} x {GLOBAL, SEMI_GLOBAL, LOCAL}, with the JAX package's
defaults. Scoring values follow the reference's conventions: ``gap_open``
is the score of a length-1 gap, ``gap_ext`` the per-additional-symbol
score; E is the pattern-gap state (SAM "I"), F the text-gap state (SAM
"D"); all costs are negative scores.
"""

from __future__ import annotations

import dataclasses
import enum


class AlignmentType(enum.IntEnum):
    GLOBAL = 0
    LOCAL = 1
    SEMI_GLOBAL = 2  # pattern global, text local (free text prefix/suffix)


GLOBAL = AlignmentType.GLOBAL
LOCAL = AlignmentType.LOCAL
SEMI_GLOBAL = AlignmentType.SEMI_GLOBAL


@dataclasses.dataclass(frozen=True)
class SWScoring:
    """Linear-gap scoring (Smith-Waterman aligner)."""

    match: int = 2
    mismatch: int = -1
    deletion: int = -1   # vertical move: consumes text (SAM 'D')
    insertion: int = -1  # horizontal move: consumes pattern (SAM 'I')


@dataclasses.dataclass(frozen=True)
class GotohScoring:
    """Affine-gap scoring (Gotoh aligner).

    ``pattern_gap_*`` applies to the E (horizontal / SAM 'I') state,
    ``text_gap_*`` to the F (vertical / SAM 'D') state.
    """

    match: int = 2
    mismatch: int = -1
    pattern_gap_open: int = -2
    pattern_gap_ext: int = -1
    text_gap_open: int = -2
    text_gap_ext: int = -1


@dataclasses.dataclass(frozen=True)
class EditDistanceAligner:
    type: AlignmentType = GLOBAL

    @property
    def scoring(self) -> SWScoring:
        return SWScoring(match=0, mismatch=-1, deletion=-1, insertion=-1)


@dataclasses.dataclass(frozen=True)
class SmithWatermanAligner:
    type: AlignmentType = LOCAL
    scoring: SWScoring = SWScoring()


@dataclasses.dataclass(frozen=True)
class GotohAligner:
    type: AlignmentType = LOCAL
    scoring: GotohScoring = GotohScoring()


@dataclasses.dataclass(frozen=True)
class HammingAligner:
    """Mismatch-only scoring: no gaps, diagonal moves only."""

    type: AlignmentType = SEMI_GLOBAL
    scoring: SWScoring = SWScoring()


def make_edit_distance_aligner(
    type: AlignmentType = GLOBAL
) -> EditDistanceAligner:
    return EditDistanceAligner(AlignmentType(type))


def make_smith_waterman_aligner(
    type: AlignmentType, scoring: SWScoring = SWScoring()
) -> SmithWatermanAligner:
    return SmithWatermanAligner(AlignmentType(type), scoring)


def make_gotoh_aligner(
    type: AlignmentType, scoring: GotohScoring = GotohScoring()
) -> GotohAligner:
    return GotohAligner(AlignmentType(type), scoring)


def make_hamming_aligner(
    type: AlignmentType, scoring: SWScoring = SWScoring()
) -> HammingAligner:
    return HammingAligner(AlignmentType(type), scoring)


# A score small enough to never win a max() but large enough not to wrap
# around when a gap cost is added to it. Scores clamp against it, so the
# value is identical to the JAX package's.
NEG_INF = -(1 << 24)
