"""Stage persistence + order-invariant checksums (debug subsystem).

A copy of ``nvbio_tpu.utils.persist`` (host code, no device work). Parity
with nvBowtie's persist/checksum debugging
(``nvBowtie/bowtie2/cuda/persist.h:47-82``, ``checksums.h:46-74``): dump
intermediate pipeline arrays to disk for offline diffing, and compute order-
invariant checksums so two runs can be compared even when work order differs
(the reference's determinism-check substitute for race detection).
"""

from __future__ import annotations

import numpy as np


def checksum(arr) -> int:
    """Order-invariant 32-bit checksum (sum of element hashes)."""
    a = np.asarray(arr)
    x = a.view(np.uint32) if a.dtype.itemsize == 4 else a.astype(np.uint32)
    x = x.astype(np.uint64).ravel()
    h = (x ^ (x >> 16)) * np.uint64(0x85EBCA6B) & np.uint64(0xFFFFFFFF)
    h = (h ^ (h >> 13)) * np.uint64(0xC2B2AE35) & np.uint64(0xFFFFFFFF)
    return int(h.sum() & np.uint64(0xFFFFFFFF))


def checksum_tree(tree: dict) -> dict:
    """Checksums of every array in a result dict (stage fingerprint)."""
    return {k: checksum(v) for k, v in tree.items()}


def persist(path: str, stage: str, tree: dict) -> None:
    """Dump a stage's arrays for offline diffing."""
    np.savez_compressed(
        f"{path}.{stage}.npz", **{k: np.asarray(v) for k, v in tree.items()}
    )


def diff_persisted(path_a: str, path_b: str) -> dict:
    """Compare two persisted stage dumps; returns {key: n_mismatches}."""
    a = np.load(path_a)
    b = np.load(path_b)
    out = {}
    for k in sorted(set(a.files) & set(b.files)):
        if a[k].shape != b[k].shape:
            out[k] = -1
        else:
            out[k] = int((a[k] != b[k]).sum())
    return out
