"""String sets: batched, fixed-shape containers for collections of sequences.

Port of ``nvbio_tpu.stringset`` (the reference's storage-free string-set
views, ``nvbio/strings/string_set.h:60-88``): a *concatenated* layout (one
flat symbol array + offsets) for host-side storage, and a *dense padded*
layout (``[batch, max_len]`` codes + lengths), the view batched device
work takes (``PaddedStringSet.to(device)`` moves it into tensors). The
sparse, strided, prefix and suffix views are host numpy, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from nvbio_tpu_torch.alphabet import Alphabet, string_to_codes


@dataclasses.dataclass
class ConcatStringSet:
    """Host-side concatenated string set: flat codes + offsets (numpy)."""

    codes: np.ndarray      # uint8[total_symbols]
    offsets: np.ndarray    # int64[n + 1]
    alphabet: Alphabet = Alphabet.DNA

    @classmethod
    def from_strings(cls, strings, alphabet: Alphabet = Alphabet.DNA):
        codes = [string_to_codes(s, alphabet) for s in strings]
        offsets = np.zeros(len(codes) + 1, dtype=np.int64)
        np.cumsum([len(c) for c in codes], out=offsets[1:])
        flat = np.concatenate(codes) if codes else np.zeros(0, dtype=np.uint8)
        return cls(flat, offsets, alphabet)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]:self.offsets[i + 1]]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def to_padded(self, max_len: int | None = None, pad_value: int = 0):
        """Densify to (n, max_len) int8 plus int32 lengths — the device view."""
        lens = self.lengths
        ml = int(max_len if max_len is not None else (lens.max() if len(lens) else 0))
        if len(lens) and lens.max() > ml:
            raise ValueError(f"sequence longer than max_len={ml}")
        out = np.full((len(self), ml), pad_value, dtype=np.uint8)
        # vectorized scatter of the flat codes into the padded matrix
        if len(self):
            row = np.repeat(np.arange(len(self)), lens)
            col = np.arange(len(self.codes)) - np.repeat(self.offsets[:-1], lens)
            out[row, col] = self.codes
        return PaddedStringSet(out, lens.astype(np.int32), self.alphabet)


@dataclasses.dataclass
class PaddedStringSet:
    """Dense padded string set: the canonical fixed-shape device container."""

    codes: np.ndarray     # uint8[n, max_len]  (or a tensor after .to())
    lengths: np.ndarray   # int32[n]
    alphabet: Alphabet = Alphabet.DNA

    def __len__(self) -> int:
        return self.codes.shape[0]

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]

    def to(self, device) -> "PaddedStringSet":
        """The set as tensors on ``device`` (codes uint8, lengths int32)."""
        def t(a, dtype):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        return PaddedStringSet(t(self.codes, torch.uint8),
                               t(self.lengths, torch.int32), self.alphabet)

    def mask(self):
        """Boolean validity mask of shape (n, max_len)."""
        if isinstance(self.codes, np.ndarray):
            return (np.arange(self.max_len)[None, :]
                    < np.asarray(self.lengths)[:, None])
        return (torch.arange(self.max_len, device=self.codes.device)[None, :]
                < self.lengths[:, None])


def make_infix_set(base: np.ndarray, starts: np.ndarray, length: int) -> np.ndarray:
    """Dense infix view: gather fixed-length windows (seeds) from flat codes.

    Equivalent of the reference's InfixSet over a string (seed extraction):
    returns (len(starts), length) array. Out-of-range reads are clamped.
    """
    idx = np.clip(starts[:, None] + np.arange(length)[None, :], 0, len(base) - 1)
    return base[idx]


@dataclasses.dataclass
class SparseStringSet:
    """Sparse view: strings are (start, length) ranges into one base text.

    Counterpart of the reference's SparseStringSet (``string_set.h:60-88``):
    a shallow representation over shared storage — no copies until a dense
    (padded) materialization is requested for device work.
    """

    base: np.ndarray     # flat codes
    starts: np.ndarray   # int[n]
    lens: np.ndarray     # int[n]

    def __len__(self) -> int:
        return len(self.starts)

    def __getitem__(self, i: int) -> np.ndarray:
        s, l = int(self.starts[i]), int(self.lens[i])
        return self.base[s:s + l]

    def to_padded(self, max_len: int | None = None, pad_value: int = 0):
        L = int(max_len if max_len is not None else
                (self.lens.max() if len(self.lens) else 0))
        n = len(self.starts)
        idx = np.clip(
            np.asarray(self.starts)[:, None] + np.arange(L)[None, :],
            0, max(len(self.base) - 1, 0))
        mat = self.base[idx] if len(self.base) else np.zeros((n, L), np.uint8)
        valid = np.arange(L)[None, :] < np.asarray(self.lens)[:, None]
        mat = np.where(valid, mat, pad_value).astype(self.base.dtype)
        return PaddedStringSet(mat, np.asarray(self.lens, np.int32))


@dataclasses.dataclass
class StridedStringSet:
    """Strided view: string i's j-th symbol lives at base[j * stride + i].

    Counterpart of StridedStringSet (``string_set.h:60-88``) — the
    transposed layout CUDA kernels use for coalescing: the view converts
    between host (B, L) rows and the (L, B) lane-major layout.
    """

    base: np.ndarray     # flat, strided storage
    stride: int
    n: int               # number of strings
    lens: np.ndarray     # int[n]

    @classmethod
    def from_padded(cls, padded: "PaddedStringSet") -> "StridedStringSet":
        mat = np.asarray(padded.codes)
        return cls(base=np.ascontiguousarray(mat.T).reshape(-1),
                   stride=mat.shape[0], n=mat.shape[0],
                   lens=np.asarray(padded.lengths))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        L = int(self.lens[i])
        return self.base[np.arange(L) * self.stride + i]

    def to_padded(self) -> "PaddedStringSet":
        L = len(self.base) // max(self.stride, 1)
        mat = self.base.reshape(L, self.stride).T[:self.n]
        return PaddedStringSet(np.ascontiguousarray(mat),
                               np.asarray(self.lens, np.int32))


def make_prefix_set(concat: "ConcatStringSet", prefix_lens: np.ndarray):
    """PrefixSet view: the first ``prefix_lens[i]`` symbols of each string
    (``string_set.h`` Prefix/PrefixSet) as a SparseStringSet."""
    starts = np.asarray(concat.offsets[:-1])
    lens = np.minimum(np.asarray(prefix_lens), concat.lengths)
    return SparseStringSet(concat.codes, starts, lens)


def make_suffix_set(concat: "ConcatStringSet", suffix_from: np.ndarray):
    """SuffixSet view: each string from position ``suffix_from[i]`` on
    (``string_set.h`` Suffix/SuffixSet) as a SparseStringSet."""
    full = concat.lengths
    f = np.minimum(np.asarray(suffix_from), full)
    starts = np.asarray(concat.offsets[:-1]) + f
    return SparseStringSet(concat.codes, starts, full - f)
