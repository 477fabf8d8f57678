"""BWA-MEM-style alignment pipeline (nvmem equivalent).

SMEM search -> anchor chaining -> chain selection -> local banded extension
-> soft-clipped SAM. Port of ``nvbio_tpu.mem``; reference:
``nvmem/nvmem.cu:46-150``, ``pipeline.h``, ``build-chains.cu``,
``align.cu``.
"""

from nvbio_tpu_torch.mem.pipeline import MemMapper, MemParams  # noqa: F401
