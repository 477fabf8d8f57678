"""Local de-novo micro-assembly (port of ``nvbio_tpu.assembly``).

GATK-HaplotypeCaller-style active-region reassembly, the counterpart of the
reference's ``nvMicroAssembly/`` app (``haplotype_caller.cu:62-99``,
``assembly_graph.h:35-160``): reads overlapping an active region + the
reference haplotype are chopped into k-mers, a De Bruijn graph is built in
CSR form, topologically sorted, cycle-checked, and the k best-weighted
source->sink paths are enumerated as candidate haplotypes.
"""

from nvbio_tpu_torch.assembly.graph import DebruijnGraph, build_debruijn_graph  # noqa: F401
from nvbio_tpu_torch.assembly.paths import k_best_haplotypes  # noqa: F401
from nvbio_tpu_torch.assembly.regions import ActiveRegion, load_active_regions  # noqa: F401
from nvbio_tpu_torch.assembly.support import HaplotypeSupport, haplotype_support  # noqa: F401
