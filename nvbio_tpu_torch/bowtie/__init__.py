"""Bowtie2-style read mapping: single-end, paired-end, local and
all-mapping over q-gram or FM-index seeds.

``ReadMapper`` resolves at first access (PEP 562): ``bowtie.pipeline``
imports ``fmi.sharded``, which imports ``parallel.mesh``, which imports
``bowtie.params`` and so runs this file; an eager import of the pipeline
here would close that cycle for a caller whose first import is
``parallel.mesh`` or ``fmi.sharded``."""

from nvbio_tpu_torch.bowtie.params import MapParams  # noqa: F401

__all__ = ["MapParams", "ReadMapper"]


def __getattr__(name):
    if name == "ReadMapper":
        from nvbio_tpu_torch.bowtie.pipeline import ReadMapper

        return ReadMapper
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
