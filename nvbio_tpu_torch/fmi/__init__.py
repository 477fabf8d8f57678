"""FM-index: rank dictionary, index container, batched search (exact,
1- and k-mismatch), bidirectional extension, SMEMs and the protein
(wavelet-tree) FM index.

As in ``nvbio_tpu.fmi``, the package attribute ``rank`` is the function;
the module is ``importlib.import_module("nvbio_tpu_torch.fmi.rank")``."""

from nvbio_tpu_torch.fmi.index import FMIndex, build_fmindex  # noqa: F401
from nvbio_tpu_torch.fmi.rank import rank, rank2  # noqa: F401
from nvbio_tpu_torch.fmi.search import (  # noqa: F401
    backward_search,
    locate_batch,
)
