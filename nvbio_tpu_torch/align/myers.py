"""Myers bit-parallel edit distance, batched and multi-word, plain torch
(port of ``nvbio_tpu.align.myers``, the JAX package's XLA function).

SEMI_GLOBAL edit distance (pattern global, text local: free text prefix
and suffix): each text step updates ceil(M/32) 32-bit words of the
pattern's bit vectors across the batch. Returns the least distance and the
text end (one past the last text index) of its first occurrence.

The words are int64 tensors masked to 32 bits (torch has no uint32
arithmetic on the CPU), the carry of the multi-word add taken from bit 32.
This is not a call of the mapper's K4 kernel (``align.kernels.
myers_semiglobal``): where the XLA function's gathers leave their arrays,
it follows them, and K4 does not.
  * A text code outside [0, n_symbols) (an N in a DNA text) gathers its
    match mask past the Peq table, which JAX fills with 0xFFFFFFFF: the
    symbol matches every pattern position. K4 reads such a code as 0.
  * At ``pattern_lens == 0`` the last pattern row is word -1, which JAX
    wraps to the last word, bit 31: the distance starts at 0 and a text
    step can take it to -1 (an N at the text's start does).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nvbio_tpu_torch.align.batch import _take_jax

_MASK = 0xFFFFFFFF


class MyersResult(NamedTuple):
    distance: torch.Tensor  # (B,) int32 minimal edit distance
    text_end: torch.Tensor  # (B,) int32 one-past-last text index of best end


def _build_peq(patterns, pattern_lens, n_words: int, n_symbols: int):
    """Peq bitmasks, (B, n_symbols * n_words) int64 words (symbol-major):
    bit j of word w of symbol c is set where pattern[32 w + j] == c inside
    the pattern's length."""
    B, M = patterns.shape
    dev = patterns.device
    pos = torch.arange(M, device=dev)
    sym = torch.arange(n_symbols, device=dev)
    hit = ((patterns[:, None, :] == sym[None, :, None])
           & (pos < pattern_lens[:, None])[:, None, :])        # (B, S, M)
    bits = torch.where(hit, torch.ones((), dtype=torch.int64, device=dev)
                       << (pos % 32), 0)
    bits = torch.nn.functional.pad(bits, (0, 32 * n_words - M))
    # each position owns a distinct bit of its word: the sum is the OR
    return bits.reshape(B, n_symbols * n_words, 32).sum(dim=2)


def myers_semiglobal(patterns, pattern_lens, texts, text_lens,
                     n_symbols: int = 4) -> MyersResult:
    """Semi-global edit distance of each (pattern, text) row: patterns
    (B, M) and texts (B, N) int32 codes, lens (B,). Every text step runs
    on the operands' device."""
    B, M = patterns.shape
    N = texts.shape[1]
    dev = patterns.device
    nw = (M + 31) // 32
    patterns = patterns.to(torch.int64)
    texts = texts.to(torch.int64)
    plen = pattern_lens.to(torch.int64)
    tlen = text_lens.to(torch.int64)

    peq = _build_peq(patterns, plen, nw, n_symbols)
    PV = torch.full((B, nw), _MASK, dtype=torch.int64, device=dev)
    MV = torch.zeros((B, nw), dtype=torch.int64, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    word = torch.arange(nw, device=dev)[None, :]
    # the pattern's last row: word -1, bit 31 at plen = 0 (floor division)
    last = plen - 1
    last_word = torch.div(last, 32, rounding_mode="floor")
    last_bit = torch.remainder(last, 32)

    score = plen.clone()
    best = plen.clone()               # distance of the empty-text alignment
    bend = torch.zeros((B,), dtype=torch.int64, device=dev)
    for j in range(N):
        base = texts[:, j:j + 1] * nw
        Eq = _take_jax(peq, base + word, _MASK)
        # Eq & PV + PV, a multi-word add (carry from bit 32)
        summ = (Eq & PV) + PV
        words, carry = [], 0
        for w in range(nw):
            t = summ[:, w] + carry
            words.append(t & _MASK)
            carry = t >> 32
        summ = torch.stack(words, dim=1)
        D0 = (summ ^ PV) | Eq | MV
        Hp = MV | (~(D0 | PV) & _MASK)
        Hn = PV & D0
        phl = _take_jax(Hp, last_word, _MASK)
        mhl = _take_jax(Hn, last_word, _MASK)
        score = score + ((phl >> last_bit) & 1) - ((mhl >> last_bit) & 1)
        # shift left by one across words, carry-in 0 (the search variant
        # keeps column 0 at distance 0)
        HpS = ((Hp << 1) & _MASK) | torch.cat([zero_col, Hp[:, :-1] >> 31],
                                              dim=1)
        HnS = ((Hn << 1) & _MASK) | torch.cat([zero_col, Hn[:, :-1] >> 31],
                                              dim=1)
        PV = HnS | (~(D0 | HpS) & _MASK)
        MV = D0 & HpS
        upd = (j < tlen) & (score < best)
        best = torch.where(upd, score, best)
        bend = torch.where(upd, j + 1, bend)
    return MyersResult(best.to(torch.int32), bend.to(torch.int32))


def myers_golden(pattern, text) -> int:
    """Numpy oracle: semi-global edit distance (pattern global, text local)."""
    M, N = len(pattern), len(text)
    prev = np.arange(M + 1)
    best = M
    for i in range(1, N + 1):
        cur = np.empty(M + 1, dtype=np.int64)
        cur[0] = 0
        for j in range(1, M + 1):
            cost = 0 if pattern[j - 1] == text[i - 1] else 1
            cur[j] = min(prev[j - 1] + cost, prev[j] + 1, cur[j - 1] + 1)
        best = min(best, cur[M])
        prev = cur
    return int(best)
