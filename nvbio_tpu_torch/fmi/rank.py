"""Rank dictionary over the 2-bit packed BWT, in the reference's interleaved
GPU layout.

Port of ``nvbio_tpu.fmi.rank``. The JAX package's hot layout is a TPU tile
row of 128 words (``rank.py:24-38``); the port takes the reference's own
interleaved layout instead (``nvbio/fmindex/rank_dictionary.h:82-271``):
one 32-byte row per 64-symbol block,

    row b = [occ_A, occ_C, occ_G, occ_T | the block's 4 packed BWT words]

(int32 tensors holding the uint32 bits), so one rank query gathers one
32-byte sector: the block's checkpoint counts and the words of its partial
block. ``rank``, ``rank_all`` and ``symbol_and_rank`` return exactly what
the JAX ``rank``, ``rank_all`` and ``symbol_and_rank_fused`` return.

Torch has no uint32 arithmetic on the CPU and no popcount: gathered words
are widened to int64 and masked to 32 bits, and the popcounts are SWAR
sums over those int64 values. Counts are int32 in storage, so texts stay
below 2^31 symbols, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

K = 64                # occurrence sampling interval, in symbols
WORDS_PER_BLOCK = 4   # 64 symbols / 16 symbols-per-word
SYM_PER_WORD = 16
ROW = 4 + WORDS_PER_BLOCK   # int32 entries per rank row (32 bytes)

_M32 = 0xFFFFFFFF
_EVEN = 0x55555555


def build_occ_table(bwt_words: np.ndarray, n: int) -> np.ndarray:
    """Host-side: (n_blocks+1, 4) int32 cumulative symbol counts at block
    starts; occ[b, c] = count of c in bwt[0 : b*K)."""
    from nvbio_tpu_torch import packed

    codes = packed.unpack(bwt_words, n, 2)
    n_blocks = (n + K - 1) // K
    pad = np.zeros(n_blocks * K, dtype=np.uint8)
    pad[:n] = codes
    per_block = np.stack([(pad.reshape(n_blocks, K) == c).sum(
        axis=1, dtype=np.int64) for c in range(4)], axis=1)
    occ = np.zeros((n_blocks + 1, 4), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=occ[1:])
    if occ.max() >= 2**31:
        raise ValueError("text too long for int32 rank (shard the index)")
    return occ.astype(np.int32)


def build_rank_rows(bwt_words: np.ndarray, n: int,
                    occ: np.ndarray) -> np.ndarray:
    """Host-side interleaved rank rows: (n//K + 2, 8) int32.

    Row b holds the 4 counts of bwt[0 : b*K) (``occ``, from
    ``build_occ_table``) and the 4 packed words of bwt[b*K : (b+1)*K)
    (zero past the text). Queries reach row n//K at
    most; the spare row past it keeps every gather of a clamped index on
    a written row."""
    w = np.asarray(bwt_words, dtype=np.uint32)
    nb = n // K + 2
    rows = np.zeros((nb, ROW), dtype=np.uint32)
    occ = np.asarray(occ, np.int64)
    rows[:occ.shape[0], :4] = occ.astype(np.uint32)
    rows[occ.shape[0]:, :4] = occ[-1].astype(np.uint32)
    words = np.zeros(nb * WORDS_PER_BLOCK, dtype=np.uint32)
    words[: w.shape[0]] = w
    rows[:, 4:] = words.reshape(nb, WORDS_PER_BLOCK)
    return rows.view(np.int32)


def build_ssa_rows(marks: np.ndarray, cum: np.ndarray) -> np.ndarray:
    """Host-side: the SSA mark words interleaved with their exclusive
    popcounts, (n_words, 2) int32, so each locate step gathers one 8-byte
    row."""
    m = np.asarray(marks, dtype=np.uint32).view(np.int32)
    return np.ascontiguousarray(np.stack(
        [m, np.asarray(cum, dtype=np.int32)], axis=1))


def rank_rows_tensor(bwt_words: torch.Tensor, n: int,
                     occ: torch.Tensor) -> torch.Tensor:
    """``build_rank_rows`` as torch ops on the tables' device: int32 bits
    of the packed words and int32 checkpoints in, (n//K + 2, 8) int32
    rows out."""
    nb = n // K + 2
    rows = torch.zeros((nb, ROW), dtype=torch.int32, device=occ.device)
    rows[:occ.shape[0], :4] = occ
    rows[occ.shape[0]:, :4] = occ[-1]
    words = torch.zeros(nb * WORDS_PER_BLOCK, dtype=torch.int32,
                        device=occ.device)
    words[:bwt_words.shape[0]] = bwt_words
    rows[:, 4:] = words.view(nb, WORDS_PER_BLOCK)
    return rows


def ssa_rows_tensor(marks: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """``build_ssa_rows`` as torch ops: (n_words, 2) int32 rows of the
    marks' int32 bits and their exclusive popcounts."""
    return torch.stack([marks.to(torch.int32), cum.to(torch.int32)],
                       dim=1).contiguous()


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in the low 32 bits of int64 ``x`` (SWAR)."""
    x = x - ((x >> 1) & _EVEN)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _matches(words: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One bit (the low bit of each 2-bit field) per symbol of ``words``
    equal to ``c``; int64 words masked to 32 bits."""
    x = words ^ (c * _EVEN)
    return ~(x | (x >> 1)) & _EVEN


def _count_matches(words, c, rem):
    """Occurrences of ``c`` among the first ``rem`` (< 64) symbols of each
    row's 4 words (..., 4): one mask per word, a nibble-wise sum of the 4
    words' field counts, then one byte fold."""
    w = torch.arange(WORDS_PER_BLOCK, dtype=torch.int64, device=words.device)
    m = (rem[..., None] - w * SYM_PER_WORD).clamp(0, SYM_PER_WORD)
    x = _matches(words, c[..., None]) & ((1 << (2 * m)) - 1)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)   # nibbles of 0..2
    x = x.sum(dim=-1)                                # nibbles of 0..8
    x = (x & 0x0F0F0F0F) + ((x >> 4) & 0x0F0F0F0F)   # bytes of 0..16
    return ((x * 0x01010101) & _M32) >> 24


def _row(rows: torch.Tensor, i: torch.Tensor):
    """(checkpoint counts (..., 4), words (..., 4) int64 masked to 32 bits,
    offset within the block) of positions ``i`` (int64)."""
    block = (i // K).clamp(0, rows.shape[0] - 1)
    r = rows[block].to(torch.int64)
    return r[..., :4], r[..., 4:] & _M32, i - block * K


def rank(rows: torch.Tensor, c: torch.Tensor, i: torch.Tensor):
    """rank(c, i) = # of occurrences of c in bwt[0:i), batched (int64).

    ``rows``: the interleaved rank rows; ``i`` in [0, n]; ``c`` (symbols,
    clamped to [0, 4)) of ``i``'s shape or one that broadcasts to it."""
    i = i.to(torch.int64)
    c = c.to(torch.int64).clamp(0, 3).expand(i.shape)
    base, words, rem = _row(rows, i)
    base_c = torch.gather(base, -1, c[..., None])[..., 0]
    return base_c + _count_matches(words, c, rem)


def rank2(rows: torch.Tensor, c: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor):
    """(rank(c, lo), rank(c, hi)), the backward-search step pair, from one
    stacked ``rank`` call. The JAX ``rank2`` takes the ``(bwt_words, occ)``
    pair; the port's takes its interleaved rank rows, as its ``rank``
    does. ``lo`` and ``hi`` share a shape, to which ``c`` broadcasts."""
    i = torch.stack([lo.to(torch.int64), hi.to(torch.int64)])
    both = rank(rows, c.to(torch.int64).expand(lo.shape)[None], i)
    return both[0], both[1]


def rank_all(rows: torch.Tensor, i: torch.Tensor):
    """rank of ALL 4 symbols at positions i: (..., 4) int64."""
    base, words, rem = _row(rows, i.to(torch.int64))
    cs = torch.arange(4, dtype=torch.int64, device=rows.device)
    part = _count_matches(words[..., None, :], cs, rem[..., None])
    return base + part


def symbol_and_rank(rows: torch.Tensor, i: torch.Tensor):
    """(bwt[i], rank(bwt[i], i)) from ONE rank-row gather — the LF step of
    locate (the reference's ``fmindex.h:472-505``). Past the text the
    symbol reads as 0 (the zero padding)."""
    base, words, rem = _row(rows, i.to(torch.int64))
    word = torch.gather(words, -1, (rem // SYM_PER_WORD)[..., None])[..., 0]
    c = (word >> (2 * (rem % SYM_PER_WORD))) & 3
    base_c = torch.gather(base, -1, c[..., None])[..., 0]
    return c, base_c + _count_matches(words, c, rem)
