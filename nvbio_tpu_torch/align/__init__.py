"""Batched DP sequence alignment: the aligner library ({EditDistance,
SmithWaterman, Gotoh, Hamming} x {GLOBAL, SEMI_GLOBAL, LOCAL}, full-matrix
and banded, score + traceback, BLOSUM62, Myers) as plain torch ops on the
operands' device, and the mapper's banded Gotoh CUDA kernels
(``align.kernels``) with their traceback entry points and host
formatters. The names exported here are ``nvbio_tpu.align``'s."""

from nvbio_tpu_torch.align.types import (  # noqa: F401
    AlignmentType,
    GLOBAL,
    LOCAL,
    SEMI_GLOBAL,
    EditDistanceAligner,
    GotohAligner,
    GotohScoring,
    HammingAligner,
    SmithWatermanAligner,
    SWScoring,
    make_edit_distance_aligner,
    make_gotoh_aligner,
    make_hamming_aligner,
    make_smith_waterman_aligner,
)
from nvbio_tpu_torch.align.batch import (  # noqa: F401
    batch_score_full,
    batch_score_banded,
)
from nvbio_tpu_torch.align.traceback import (  # noqa: F401
    batch_traceback_banded,
    cigar_to_string,
)
