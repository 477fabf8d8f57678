"""DebugOutput: binary per-alignment diagnostic records.

Counterpart of the reference's DebugOutput (``io/output/output_debug.h``):
instead of SAM text, each alignment emits a fixed 28-byte record
(read_id, flag, ref_id, pos, mapq, ed, subs, ins, dels, has_second, score,
sec_score) — the format nvBowtie uses to diff aligner internals between
runs. Vectorized: a whole batch packs into one structured-array write.

A copy of ``nvbio_tpu.io.debug``.
"""

from __future__ import annotations

import numpy as np

DEBUG_DTYPE = np.dtype([
    ("read_id", "<u4"),
    ("flag", "<u2"),
    ("ref_id", "<u2"),
    ("pos", "<u4"),
    ("mapq", "u1"),
    ("ed", "u1"),
    ("subs", "u1"),
    ("ins", "u1"),
    ("dels", "u1"),
    ("has_second", "u1"),
    ("pad", "<u2"),
    ("score", "<i4"),
    ("sec_score", "<i4"),
])
MAGIC = b"NVTD\x01\x00"


class DebugOutput:
    """Writes batches of alignment diagnostics as fixed binary records."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        self.n_records = 0
        self._base = 0

    def process_batch(self, res: dict, ref_ids: np.ndarray,
                      positions: np.ndarray) -> None:
        """Append one result batch (arrays from align_batch_core)."""
        B = len(positions)
        rec = np.zeros(B, DEBUG_DTYPE)
        rec["read_id"] = self._base + np.arange(B, dtype=np.uint32)
        mapped = np.asarray(res["mapped"])
        rec["flag"] = (np.where(mapped, 0, 4)
                       | np.where(np.asarray(res["strand"]) & mapped, 16, 0))
        rec["ref_id"] = np.clip(ref_ids, 0, 2**16 - 1)
        rec["pos"] = np.where(mapped, positions, 0).astype(np.uint32)
        rec["mapq"] = np.clip(np.asarray(res["mapq"]), 0, 255)
        rec["ed"] = np.clip(np.asarray(res["nm"]), 0, 255)
        # substitution/indel split (output_debug.h records them; computed
        # on device from the traceback entries in finalize_best)
        for field in ("subs", "ins", "dels"):
            if field in res:
                rec[field] = np.clip(np.asarray(res[field]), 0, 255)
        rec["has_second"] = np.asarray(res["has_second"]).astype(np.uint8)
        rec["score"] = np.asarray(res["best_score"])
        rec["sec_score"] = np.asarray(res["second_score"])
        self.f.write(rec.tobytes())
        self.n_records += B
        self._base += B

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_debug(path: str) -> np.ndarray:
    """Load a DebugOutput file back as a structured array."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a DebugOutput file")
        return np.frombuffer(f.read(), DEBUG_DTYPE)
