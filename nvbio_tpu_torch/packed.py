"""Bit-packed symbol arrays (host numpy packing + torch device extraction).

Layout (identical to ``nvbio_tpu.packed``): symbol ``i`` lives in word
``i // spw`` at bit offset ``(i % spw) * bits`` (LSB-first), ``spw =
32 // bits``. Packed genomes travel to the device as **int32 tensors holding
the uint32 bits**: that is what the CUDA kernels read, and torch has no
uint32 arithmetic on the CPU. Plain torch code widens gathered words to
int64 and masks to the low 32 bits before shifting (``>>`` on int32 is
arithmetic, so an unmasked high symbol would sign-extend).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

import numpy as np
import torch

WORD_BITS = 32


def symbols_per_word(bits: int) -> int:
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported symbol size: {bits}")
    return WORD_BITS // bits


def words_for(length: int, bits: int) -> int:
    spw = symbols_per_word(bits)
    return (length + spw - 1) // spw


def pack(symbols: np.ndarray, bits: int) -> np.ndarray:
    """Pack symbol codes into a uint32 word array (host-side numpy)."""
    symbols = np.asarray(symbols)
    spw = symbols_per_word(bits)
    n = symbols.shape[-1]
    n_words = words_for(n, bits)
    if bits == 2 and sys.byteorder == "little":
        # 4 symbols -> 1 byte; little-endian byte quads ARE the LSB-first
        # uint32 words
        padded = np.zeros(symbols.shape[:-1] + (n_words * 4, 4), np.uint8)
        flat = padded.reshape(symbols.shape[:-1] + (n_words * 16,))
        flat[..., :n] = symbols
        np.bitwise_and(flat, 3, out=flat)
        b = (padded[..., 0] | (padded[..., 1] << 2)
             | (padded[..., 2] << 4) | (padded[..., 3] << 6))
        return np.ascontiguousarray(b).view(np.uint32)
    padded = np.zeros(symbols.shape[:-1] + (n_words * spw,), dtype=np.uint32)
    padded[..., :n] = symbols.astype(np.uint32) & ((1 << bits) - 1)
    grouped = padded.reshape(symbols.shape[:-1] + (n_words, spw))
    shifts = (np.arange(spw, dtype=np.uint32) * bits).astype(np.uint32)
    return np.bitwise_or.reduce(grouped << shifts, axis=-1).astype(np.uint32)


def unpack(words: np.ndarray, length: int, bits: int) -> np.ndarray:
    """Unpack a uint32 word array back to uint8 symbol codes (host-side)."""
    words = np.asarray(words, dtype=np.uint32)
    spw = symbols_per_word(bits)
    shifts = (np.arange(spw, dtype=np.uint32) * bits).astype(np.uint32)
    mask = np.uint32((1 << bits) - 1)
    syms = (words[..., :, None] >> shifts) & mask
    flat = syms.reshape(words.shape[:-1] + (-1,))
    return flat[..., :length].astype(np.uint8)


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 packed words -> int32 tensor of the same bits on ``device``."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(w.view(np.int32)).to(device)


@dataclasses.dataclass
class PackedArray:
    """A length-tagged packed symbol array (``nvbio_tpu.packed.
    PackedArray``). ``words`` is a numpy uint32 array (host) or an int32
    tensor of the same bits; ``.to(device)`` stands for the JAX
    ``.device()``."""

    words: Any          # uint32[n_words] (or batched [..., n_words])
    length: int         # number of valid symbols
    bits: int           # bits per symbol

    @classmethod
    def from_codes(cls, symbols: np.ndarray, bits: int) -> "PackedArray":
        return cls(pack(symbols, bits), int(np.asarray(symbols).shape[-1]),
                   bits)

    def to_codes(self) -> np.ndarray:
        w = self.words
        if isinstance(w, torch.Tensor):
            w = w.cpu().numpy().view(np.uint32)
        return unpack(w, self.length, self.bits)

    @property
    def spw(self) -> int:
        return symbols_per_word(self.bits)

    def to(self, device) -> "PackedArray":
        w = self.words
        w = w.to(device) if isinstance(w, torch.Tensor) else \
            words_to_tensor(w, device)
        return PackedArray(w, self.length, self.bits)


def gather_symbols(words, idx, bits: int):
    """The symbols at positions ``idx`` (any integer shape) of packed
    ``words``, as ``nvbio_tpu.packed.gather_symbols``: numpy words (uint32)
    give a numpy int32 array, tensor words (int32 bits) an int32 tensor on
    their device. Batched words (..., n_words) gather along the last axis,
    giving (..., *idx.shape)."""
    spw = symbols_per_word(bits)
    mask = (1 << bits) - 1
    if not isinstance(words, torch.Tensor):
        words = np.asarray(words, dtype=np.uint32)
        idx = np.asarray(idx, dtype=np.int64)
        word = np.take(words, idx // spw, axis=-1)
        shift = ((idx % spw) * bits).astype(np.uint32)
        return ((word >> shift) & mask).astype(np.int32)
    idx = torch.as_tensor(idx, device=words.device).to(torch.int64)
    word = words[..., idx // spw].to(torch.int64) & 0xFFFFFFFF
    return ((word >> ((idx % spw) * bits)) & mask).to(torch.int32)


def extract_window(words: torch.Tensor, start: torch.Tensor, win_len: int,
                   bits: int = 2) -> torch.Tensor:
    """``win_len`` consecutive symbols from each ``start`` (int32 codes).

    ``words``: int32 tensor of uint32 bits; ``start``: (...,) int64.
    Returns (..., win_len) int32. Symbols whose word lies past the end of
    ``words`` read as 0 — the semantics of ``nvbio_tpu.packed.
    extract_window_aligned`` (its ``gather_word_runs`` zero tail), which
    callers mask by window length anyway.
    """
    spw = symbols_per_word(bits)
    nw = words.shape[0]
    idx = start.to(torch.int64)[..., None] + torch.arange(
        win_len, dtype=torch.int64, device=start.device)
    widx = idx // spw
    w = words[widx.clamp(0, nw - 1)].to(torch.int64) & 0xFFFFFFFF
    sym = (w >> ((idx % spw) * bits)) & ((1 << bits) - 1)
    sym = torch.where(widx < nw, sym, torch.zeros_like(sym))
    return sym.to(torch.int32)


def reverse_rows(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-row reversal by variable length: y[b, j] = x[b, lens[b]-1-j] for
    j < lens[b]; the tail (j >= lens[b]) is 0.

    ``nvbio_tpu.packed.reverse_rows`` leaves the tail undefined (its word
    funnel shifts junk in); every consumer masks it by length, so only
    j < lens is part of the contract. A plain per-lane gather here.
    """
    B, L = x.shape
    j = torch.arange(L, dtype=torch.int64, device=x.device)[None, :]
    src = lens.to(torch.int64)[:, None] - 1 - j
    y = torch.gather(x, 1, src.clamp(0, L - 1).expand(B, L))
    return torch.where(src >= 0, y, torch.zeros_like(y))
