"""Suffix-array construction (a copy of ``nvbio_tpu.index.sa``).

``suffix_array`` returns the SA of T$ (n+1 entries, sa[0] == n): the
native C++ SA-IS engine (``native/sais.cpp``, method "native"/"auto"),
Manber-Myers prefix doubling in numpy ("doubling") or prefix doubling over
``torch.sort`` on a device ("device", ``index.device_sa``). The suffix
array is unique, so every method gives the same index.
"""

from __future__ import annotations

import numpy as np


def suffix_array(codes: np.ndarray, method: str = "auto",
                 device=None) -> np.ndarray:
    """SA of text + sentinel (n+1 entries, sa[0] == n).

    method: "native" (C++ SA-IS, O(n)), "doubling" (numpy, O(n log^2 n)),
    "auto" (native if the toolchain is available, else doubling), or
    "device" (``index.device_sa.suffix_array_device`` on ``device``: cuda
    unless the caller asks for the CPU).
    """
    if method == "device":
        from nvbio_tpu_torch.index.device_sa import suffix_array_device

        return suffix_array_device(codes, device)
    if method not in ("auto", "native", "doubling"):
        raise ValueError(f"unknown suffix array method {method!r}")
    if method in ("auto", "native"):
        try:
            from nvbio_tpu_torch import native

            K = int(np.max(codes)) + 1 if len(codes) else 1
            return native.sais_u8(codes, K=max(K, 4)).astype(np.int64)
        except Exception:
            if method == "native":
                raise
    return _suffix_array_doubling(codes)


def _suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    """Manber-Myers prefix doubling, fully vectorized numpy."""
    codes = np.asarray(codes)
    n = len(codes)
    s = np.empty(n + 1, dtype=np.int64)
    s[:n] = codes.astype(np.int64) + 1
    s[n] = 0
    m = n + 1

    sa = np.argsort(s, kind="stable")
    rank = np.empty(m, dtype=np.int64)
    keys = s[sa]
    rank[sa] = np.cumsum(np.concatenate([[0], keys[1:] != keys[:-1]]))

    k = 1
    while rank[sa[-1]] != m - 1:  # until all ranks unique
        idx = np.arange(m, dtype=np.int64)
        second = np.full(m, -1, dtype=np.int64)
        valid = idx + k < m
        second[valid] = rank[idx[valid] + k]
        key = rank * (m + 1) + (second + 1)
        sa = np.argsort(key, kind="stable")
        sk = key[sa]
        rank[sa] = np.cumsum(np.concatenate([[0], sk[1:] != sk[:-1]]))
        k *= 2

    return sa
