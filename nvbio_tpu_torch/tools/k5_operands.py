"""K5's operands (``kernels.regtile_score_blocked``), made from a seed:
bench.py's GCUPS operands, and a ragged batch whose pairs of alignments
cover the packed loop's guard (``kernels.k5_packed_pairs``). One builder of
each for ``chip_smoke.py``, the timing tools and the tests."""

from __future__ import annotations

import numpy as np
import torch

G_BENCH, L_BENCH = 4096, 100     # bench.py's GCUPS leg (bench.py:421-467)


def bench_operands(band: int, dev, mismatch: int, G: int = G_BENCH,
                   length: int = L_BENCH):
    """bench.py's GCUPS operands (bench.py:424-440), made on ``dev`` from the
    seed ``band``: random codes in [0, 4), the flat mismatch plane, every
    pattern ``length`` long and every text spanning length + band - 1. The
    kernel takes them with seq_f, full_text and uniform_plen."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(band)
    lp = (length + 7) // 8 * 8
    i32 = torch.int32
    return (torch.randint(0, 4, (G, lp, 8, 128), generator=gen, device=dev,
                          dtype=i32),
            torch.full((G, 1, 8, 128), length, dtype=i32, device=dev),
            torch.randint(0, 4, (G, lp + band, 8, 128), generator=gen,
                          device=dev, dtype=i32),
            torch.full((G, 1, 8, 128), length + band - 1, dtype=i32,
                       device=dev),
            torch.full((G, lp, 8, 128), mismatch, dtype=i32, device=dev))


def guard_operands(rng: np.random.Generator, G: int, length: int, band: int,
                   *, uniform_plen: bool = False, full_text: bool = False):
    """Blocked numpy operands (patterns, plen, texts, tlen, penalties) whose
    pairs (lanes 2j, 2j+1 of a block row) cover the packed guard's cases.
    Half the texts copy their pattern. In block row s of each block, the odd
    lane of every pair but the first 16 breaks the guard in one way while
    its even lane stays admissible (s = 1: a penalty of -200 on some rows;
    2: penalties of -127 on every row, past the sum's limit; 3: text codes
    65536 above the pattern's; 4: a negative text code; 5: pattern codes
    >= 65536 or negative, which the packed loop takes). Unless
    ``uniform_plen``: plen 0, 1 and past L, and halves of different
    lengths; block rows 0 and 7 draw plen from [0, L + 1], the others from
    [L/2, L + 1]. Unless ``full_text``: block rows 0 and 7 draw tlen from
    [0, TWp], the others span their band on 70% of the texts."""
    L, W = length, band
    Lp, TWp = (L + 7) // 8 * 8, (L + 7) // 8 * 8 + W
    pats = rng.integers(0, 5, (G, Lp, 8, 128))
    txts = rng.integers(0, 4, (G, TWp, 8, 128))
    txts[..., ::2] = np.pad(np.minimum(pats[:, :L], 3),
                            ((0, 0), (2, TWp - L - 2), (0, 0), (0, 0)))[
        ..., ::2]
    mm = -rng.integers(1, 7, (G, Lp, 8, 128))
    odd = np.s_[33::2]
    mm[:, ::7, 1, odd] = -200
    mm[:, :, 2, odd] = -127
    txts[:, :, 3, odd] += 65536
    txts[:, L // 3, 4, odd] = -1
    pats[:, :, 5, 33::4] += 65536
    pats[:, ::3, 5, 35::4] = -5
    free = np.s_[:, :, [0, 7]]
    if uniform_plen:
        plen = np.full((G, 1, 8, 128), L)
    else:
        plen = rng.integers(L // 2, L + 2, (G, 1, 8, 128))
        plen[free] = rng.integers(0, L + 2, (G, 1, 2, 128))
        plen[:, 0, 6, :8] = [0, L, 1, L, L + 1, L, L + 7, 0]
    if full_text:
        tlen = np.full((G, 1, 8, 128), TWp)
    else:
        tlen = np.where(rng.random((G, 1, 8, 128)) < 0.7, TWp,
                        rng.integers(0, TWp + 1, (G, 1, 8, 128)))
        tlen[free] = rng.integers(0, TWp + 1, (G, 1, 2, 128))
    return tuple(x.astype(np.int32) for x in (pats, plen, txts, tlen, mm))
