"""Wavelet tree: O(log s) rank for alphabets beyond 2 bits.

Port of ``nvbio_tpu.wavelet`` (``nvbio/strings/wavelet_tree.h:77-331``):
per-bit-level bitvectors (MSB first) with a stable partition between
levels and exclusive rank1 prefixes per 32-bit word. Used by the protein
FM index (``fmi/protein.py``), where the 4-symbol rank rows do not apply.

The build is host numpy; ``rank`` is tensor ops on the tree's device (log
s gathers and SWAR popcounts a query). The uint32 words travel as int32
bits, widened to int64 and masked to 32 bits.

``rank`` at ``pos == n`` where n is a multiple of 32 reads word n // 32,
one past the tables. The JAX package's ``jnp.take`` fills that read with
INT32_MIN (its rank comes back near -2^31); the port clamps the word to
the last one and keeps all 32 of its bits, which is the right count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nvbio_tpu_torch.fmi.rank import popcount32

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class WaveletTree:
    bits: int                    # levels (= bits per symbol)
    n: int
    levels_words: torch.Tensor   # int32 bits of uint32[bits, n_words]
    levels_cum: torch.Tensor     # int32[bits, n_words] exclusive rank1
    zeros: torch.Tensor          # int32[bits] count of 0-bits per level

    def to(self, device) -> "WaveletTree":
        return WaveletTree(self.bits, self.n, self.levels_words.to(device),
                           self.levels_cum.to(device), self.zeros.to(device))

    @property
    def device(self) -> torch.device:
        return self.levels_words.device


def _popcount_words(words: np.ndarray) -> np.ndarray:
    """Bits set in each uint32 word (host)."""
    return np.unpackbits(words.view(np.uint8).reshape(-1, 4),
                         axis=1).sum(axis=1, dtype=np.int64)


def build_wavelet_tree(codes: np.ndarray, bits: int) -> WaveletTree:
    """Host build (host tensors; ``.to(device)`` moves the tree)."""
    codes = np.asarray(codes, dtype=np.uint32)
    n = len(codes)
    n_words = max(1, (n + 31) // 32)
    words = np.zeros((bits, n_words), dtype=np.uint32)
    cums = np.zeros((bits, n_words), dtype=np.int64)
    zeros = np.zeros(bits, dtype=np.int64)

    cur = codes
    for level in range(bits):
        b = ((cur >> (bits - 1 - level)) & 1).astype(np.uint8)
        plane = np.zeros(n_words * 32, dtype=np.uint8)
        plane[:n] = b
        # bit i of word w is symbol 32w + i (little-endian bytes)
        words[level] = np.packbits(plane, bitorder="little").view("<u4")
        np.cumsum(_popcount_words(words[level])[:-1], out=cums[level][1:])
        zeros[level] = int((b == 0).sum())
        # stable partition for the next level
        cur = cur[np.argsort(b, kind="stable")]
    return WaveletTree(
        bits, n, torch.from_numpy(words.view(np.int32).copy()),
        torch.from_numpy(cums.astype(np.int32)),
        torch.from_numpy(zeros.astype(np.int32)))


def _rank1(wt: WaveletTree, level: int, pos: torch.Tensor) -> torch.Tensor:
    """# of 1-bits of ``level`` in [0, pos); the word index is clamped to
    the last word and the remainder may reach 32 (pos == n, n % 32 == 0)."""
    nw = wt.levels_words.shape[1]
    wi = (pos // 32).clamp(0, nw - 1)
    rem = pos - wi * 32
    w = wt.levels_words[level][wi].to(torch.int64) & _M32
    prefix = w & ((1 << rem) - 1)
    return wt.levels_cum[level][wi].to(torch.int64) + popcount32(prefix)


def rank(wt: WaveletTree, c, i) -> torch.Tensor:
    """# of occurrences of symbol c in codes[0:i), batched (int64 tensors
    on the tree's device; ``c`` broadcasts against ``i``)."""
    dev = wt.device
    i = torch.as_tensor(i, device=dev).to(torch.int64)
    c = torch.as_tensor(c, device=dev).to(torch.int64)
    lo = torch.zeros_like(i)
    hi = i
    for level in range(wt.bits):
        bit = (c >> (wt.bits - 1 - level)) & 1
        r_lo = _rank1(wt, level, lo)
        r_hi = _rank1(wt, level, hi)
        z = wt.zeros[level].to(torch.int64)
        lo = torch.where(bit == 1, z + r_lo, lo - r_lo)
        hi = torch.where(bit == 1, z + r_hi, hi - r_hi)
    return hi - lo
