"""The system under test: ``nvbio_tpu_torch``'s mapper, driven the way the
``map`` app drives it. The only module of the benchmark that imports the
program.

A batch goes through ``ReadMapper.dispatch`` (single-end) or
``paired.dispatch_pair_batch`` (paired-end), then ``ReadMapper.fetch``,
which enqueues the copy of every result array into pinned host memory
behind the batch's kernels; ``HostResult.wait`` hands them over as numpy
arrays. The window's loop dispatches batch i+1 before it waits on batch i,
as ``apps/map_app.map_single_end`` does.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


class System:
    """The mapper of one configuration, on ``device``. ``control`` names
    a mapping parameter to override (the correctness control), as
    ``{"key": value}``."""

    def __init__(self, cfg: dict, genome: np.ndarray, device,
                 control: dict | None = None):
        from nvbio_tpu_torch.align.types import GotohScoring
        from nvbio_tpu_torch.bowtie import MapParams
        from nvbio_tpu_torch.io.reference import Reference

        sc = cfg["scoring"]
        go, ge = -sc["gap_open"], -sc["gap_ext"]
        kw = dict(cfg["map_params"])
        kw.update(
            scoring=GotohScoring(match=sc["match"], mismatch=-sc["mm_max"],
                                 pattern_gap_open=go, pattern_gap_ext=ge,
                                 text_gap_open=go, text_gap_ext=ge),
            mm_penalty_min=sc["mm_min"], mm_penalty_max=sc["mm_max"],
            score_min_const=sc["score_min_const"],
            score_min_coeff=sc["score_min_coeff"])
        kw.update(control or {})
        self.params = MapParams(**kw)
        n = len(genome)
        self.reference = Reference(["bench"], np.array([0, n], np.int64),
                                   genome, None)
        self.device = device
        self.mapper = None

    def build(self) -> float:
        """Build the index and move it with the genome to the device
        (``ReadMapper.build``); returns its seconds by the host clock."""
        import torch

        from nvbio_tpu_torch.bowtie import ReadMapper

        t = time.perf_counter()
        self.mapper = ReadMapper.build(self.reference, self.params,
                                       device=self.device)
        if self.mapper.device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t

    def items(self, pool: list, kind: str) -> list:
        """The pool's batches as the program's ``ReadBatch``es."""
        from nvbio_tpu_torch.io.fastq import ReadBatch

        def rb(codes, quals):
            B, L = codes.shape
            return ReadBatch([""] * B, codes, quals,
                             np.full(B, L, np.int32))

        if kind == "paired":
            return [(rb(p["codes1"], p["quals1"]), rb(p["codes2"],
                                                      p["quals2"]))
                    for p in pool]
        return [rb(p["codes"], p["quals"]) for p in pool]

    def dispatch(self, item, kind: str):
        """Enqueue one batch and the copies of its results; returns the
        program's ``HostResult``."""
        m = self.mapper
        if kind == "paired":
            from nvbio_tpu_torch.bowtie.paired import dispatch_pair_batch

            r1, r2, pinfo = dispatch_pair_batch(m, *item)
            flat = {f"1.{k}": v for k, v in r1.items()}
            flat |= {f"2.{k}": v for k, v in r2.items()}
            flat |= {f"p.{k}": v for k, v in pinfo.items()}
            return m.fetch(flat)
        return m.fetch(m.dispatch(item))

    @contextlib.contextmanager
    def k1_recorder(self):
        """Record the shapes (B, C, L, W, genome words) of every K1 call
        made inside the block: a shim around the name the pipeline calls."""
        from nvbio_tpu_torch.bowtie import pipeline

        orig = pipeline.banded_score_cands
        calls = []

        def shim(*args, **kw):
            reads, w0, words, band = args[0], args[3], args[5], args[7]
            calls.append((reads.shape[0], w0.shape[1], reads.shape[1],
                          int(band), words.numel()))
            return orig(*args, **kw)

        pipeline.banded_score_cands = shim
        try:
            yield calls
        finally:
            pipeline.banded_score_cands = orig

    def close(self):
        self.mapper = None
