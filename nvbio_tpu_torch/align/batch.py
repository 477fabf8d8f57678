"""Batched alignment scorers of the aligner library, plain torch (port of
``nvbio_tpu.align.batch``).

  * ``batch_score_banded`` — the banded scorer of every aligner
    ({EditDistance, SmithWaterman, Gotoh, Hamming} x {GLOBAL, SEMI_GLOBAL,
    LOCAL}): one step a pattern row over a dense (B, W) band plane, the
    within-row text-gap dependency broken by an exclusive prefix max ("lazy
    F"); the JAX function's (W, B) layout is transposed here, which changes
    no value.
  * ``batch_score_full`` — the full-matrix scorer: an anti-diagonal
    wavefront, one step a diagonal over a dense (B, M+1) plane, the text
    symbols of each diagonal from a rolling reversed window.

Both run on their operands' device as tensor ops: on a card every step is
a few dozen launches of PyTorch's own kernels (the JAX package's scan route
is XLA array code; no TPU kernel lies on it). Scores are int32 and equal
to the JAX functions' bit for bit, edge values included: the same int32
operations in the same order, and the JAX gathers' out-of-range behaviour
(``_take_jax``) where an index can leave its array.

The mapper's K3 kernel has its own plain version
(``align.kernels.banded_score_plain``): its prefix max is floored at
NEG_INF, this module's is not, so the two share no code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nvbio_tpu_torch.align.types import (
    NEG_INF,
    AlignmentType,
    GotohAligner,
    HammingAligner,
)


class BestSink(NamedTuple):
    """Best score + terminal cell, the analogue of the reference's BestSink."""

    score: torch.Tensor         # (B,) int32
    sink_text: torch.Tensor     # (B,) int32: text index (i) of the end cell
    sink_pattern: torch.Tensor  # (B,) int32: pattern index (j)


def _take_jax(x, idx, fill: int):
    """``x[b, idx[b, ...]]`` for a (B, n) ``x`` and a (B,) or (B, k) ``idx``,
    as JAX's ``take_along_axis`` gathers: an index in [-n, 0) counts from
    the end, one outside [-n, n) reads ``fill`` (JAX fills the dtype's
    maximum for unsigned types, its minimum for signed ones). torch would
    raise instead, or assert on the card."""
    n = x.shape[1]
    flat = idx.dim() == 1
    idx = idx[:, None] if flat else idx
    inside = (idx >= -n) & (idx < n)
    j = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).to(torch.int64)
    got = torch.gather(x, 1, j)
    got = torch.where(inside, got, torch.full_like(got, fill))
    return got[:, 0] if flat else got


def _gap_params(aligner):
    """Uniform (po, pe, to, te) gap parameters of a linear or affine
    aligner."""
    s = aligner.scoring
    if isinstance(aligner, GotohAligner):
        return (s.pattern_gap_open, s.pattern_gap_ext, s.text_gap_open,
                s.text_gap_ext)
    # linear gaps: open == extend
    return s.insertion, s.insertion, s.deletion, s.deletion


def _subst_scores(p, t, match, mismatch, matrix=None):
    """Elementwise substitution scores, int32. With ``matrix`` (A x A int32,
    e.g. BLOSUM62) the score is the table's entry at (pattern symbol, text
    symbol clipped to [0, A)), the flat index clipped to the table."""
    if matrix is not None:
        A = matrix.shape[0]
        idx = p * A + t.clamp(0, A - 1)
        return matrix.reshape(-1)[idx.clamp(0, A * A - 1).to(torch.int64)]
    return torch.where(p == t, match, mismatch).to(torch.int32)


def _exclusive_running_max(x):
    """Exclusive prefix max along the last axis, NEG_INF shifted in and no
    floor (``torch.cummax`` of values below NEG_INF stays below it)."""
    inc = torch.cummax(x, dim=-1).values
    return torch.cat([torch.full_like(x[..., :1], NEG_INF), inc[..., :-1]],
                     dim=-1)


def _matrix(subst_matrix, dev):
    return (None if subst_matrix is None
            else torch.as_tensor(subst_matrix, dtype=torch.int32, device=dev))


def batch_score_banded(patterns, pattern_lens, texts, text_lens, aligner,
                       band: int, mismatch_scores=None,
                       subst_matrix=None) -> BestSink:
    """Banded alignment scores, band anchored at the window's main diagonal.

    DP cell (i, k): pattern consumed i, text consumed i + k, k in [0,
    band). patterns (B, M), texts (B, T) with T >= M + band - 1 (zero-padded
    to it otherwise), lens (B,); ``mismatch_scores`` (B, M) per-position
    mismatch scores, ``subst_matrix`` an (A, A) score table (protein).
    GLOBAL scores the band's last cell of the row at ``pattern_lens``
    (sink (plen + W - 1, plen)), SEMI_GLOBAL that row's first max (sink
    (plen + k, plen)), LOCAL the best cell of the rows up to ``pattern_lens``
    inside the text (sink (row, row)). Port of the JAX function
    (``nvbio_tpu/align/batch.py:87-198``)."""
    B, M = patterns.shape
    W = band
    dev = patterns.device
    atype = AlignmentType(aligner.type)
    local = atype == AlignmentType.LOCAL
    po, pe, to, te = _gap_params(aligner)
    match, mm_scalar = aligner.scoring.match, aligner.scoring.mismatch
    neg = NEG_INF
    matrix = _matrix(subst_matrix, dev)

    pats = patterns.to(torch.int32)
    TW = M + W - 1
    texts = texts.to(torch.int32)
    if texts.shape[1] < TW:
        texts = torch.nn.functional.pad(texts, (0, TW - texts.shape[1]))
    plen = pattern_lens.to(torch.int32)
    tlen = text_lens.to(torch.int32)
    mm = None if mismatch_scores is None else mismatch_scores.to(torch.int32)

    kcol = torch.arange(W, dtype=torch.int32, device=dev)[None, :]   # (1, W)
    if atype == AlignmentType.GLOBAL:
        H = torch.where(kcol == 0, 0, to + te * (kcol - 1)).to(
            torch.int32).expand(B, W)
    else:
        H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    E = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), neg, dtype=torch.int32, device=dev)
    best = torch.full((B,), neg, dtype=torch.int32, device=dev)
    sink_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    final = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    hamming = isinstance(aligner, HammingAligner)

    for i in range(1, M + 1):
        p = pats[:, i - 1:i]
        trow = texts[:, i - 1:i - 1 + W]
        mmv = mm_scalar if mm is None else mm[:, i - 1:i]
        sub = _subst_scores(p, trow, match, mmv, matrix)
        tidx = (i - 1) + kcol
        in_text = tidx < tlen[:, None]
        sub = torch.where(in_text, sub, neg)
        diag = H + sub
        if hamming:
            Hrow = diag.clamp(min=0) if local else diag
        else:
            # E (pattern gap, 'I'): from (i-1, k+1)
            Erow = torch.maximum(torch.cat([E[:, 1:], neg_col], dim=1) + pe,
                                 torch.cat([H[:, 1:], neg_col], dim=1) + po)
            H0 = torch.maximum(diag, Erow)
            if local:
                H0 = H0.clamp(min=0)
            # F (text gap, 'D'): F[k] = te*(k-1) + max_{k'<k}(H0[k'] +
            # to - te*k')
            F = _exclusive_running_max(H0 + (to - te * kcol)) + te * (kcol - 1)
            Hrow = torch.maximum(H0, F)
            E = Erow
        final = torch.where((plen == i)[:, None], Hrow, final)
        if local:
            row_valid = (i <= plen)[:, None] & in_text
            row_best = torch.where(row_valid, Hrow, neg).max(dim=1).values
            upd = row_best > best
            best = torch.where(upd, row_best, best)
            sink_i = torch.where(upd, i, sink_i)
        H = Hrow

    if atype == AlignmentType.GLOBAL:
        return BestSink(final[:, W - 1], plen + (W - 1), plen)
    if atype == AlignmentType.SEMI_GLOBAL:
        # free text suffix: the first max over the final row's band
        k_best = torch.argmax(final, dim=1).to(torch.int32)
        return BestSink(final.max(dim=1).values, plen + k_best, plen)
    return BestSink(best, sink_i, sink_i)


def batch_score_full(patterns, pattern_lens, texts, text_lens, aligner,
                     mismatch_scores=None, subst_matrix=None) -> BestSink:
    """Full-matrix alignment scores by an anti-diagonal wavefront: M + N
    - 1 steps over a dense (B, M+1) diagonal (slot j holds cell (d - j,
    j)), the text symbol of each slot from a window rolled one slot a step
    (-1 past ``text_lens``). GLOBAL ends at (tlen, plen), SEMI_GLOBAL at the
    best cell of row plen, LOCAL at the best valid cell (first max by
    diagonal, then by slot); the sink is (text index, pattern index). Port
    of the JAX function (``nvbio_tpu/align/batch.py:201-372``), with its
    boundaries, Hamming's NEG_INF edges and GLOBAL's recomputation where
    plen + tlen <= 1."""
    B, M = patterns.shape
    N = texts.shape[1]
    dev = patterns.device
    atype = AlignmentType(aligner.type)
    po, pe, to, te = _gap_params(aligner)
    match, mm_scalar = aligner.scoring.match, aligner.scoring.mismatch
    neg = NEG_INF
    matrix = _matrix(subst_matrix, dev)
    local = atype == AlignmentType.LOCAL
    glob = atype == AlignmentType.GLOBAL
    hamming = isinstance(aligner, HammingAligner)
    gotoh = isinstance(aligner, GotohAligner)

    patterns = patterns.to(torch.int32)
    texts = texts.to(torch.int32)
    plen = pattern_lens.to(torch.int32)
    tlen = text_lens.to(torch.int32)
    jj = torch.arange(M + 1, dtype=torch.int32, device=dev)

    def col_boundary(i: int) -> int:   # H[i][0]
        if glob:
            if hamming:
                return 0 if i == 0 else neg
            return 0 if i == 0 else to + te * (i - 1)
        return 0

    # H[0][j] of every slot j
    if hamming:
        row_boundary = torch.where(jj == 0, 0, neg).to(torch.int32)
    elif local:
        row_boundary = torch.zeros_like(jj)
    else:
        row_boundary = torch.where(jj == 0, 0, po + pe * (jj - 1)).to(
            torch.int32)

    def full(v):
        return torch.full((B, M + 1), v, dtype=torch.int32, device=dev)

    # diagonal 0: cell (0, 0); diagonal 1: cells (1, 0) and (0, 1)
    H2 = full(neg)
    H2[:, 0] = 0
    H1 = full(neg)
    H1[:, 0] = col_boundary(1)
    if M >= 1:
        H1[:, 1] = row_boundary[1]
    E1 = full(0 if local else neg)
    F1 = full(0 if local else neg)
    # rolling reversed text window: tw[:, j] = text symbol of cell (d-j, j),
    # i.e. text[d-1-j]; at diagonal 1, tw[:, 0] = text[0]
    tw = full(-1)
    if N:
        tw[:, 0] = texts[:, 0]
    mm = mm_scalar
    if mismatch_scores is not None:   # slot j scores pattern[j - 1]
        mm = torch.cat([torch.full((B, 1), mm_scalar, dtype=torch.int32,
                                   device=dev),
                        mismatch_scores.to(torch.int32)], dim=1)
    pat_row = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                         patterns], dim=1)
    neg_col = torch.full((B, 1), neg, dtype=torch.int32, device=dev)
    best = torch.full((B,), neg, dtype=torch.int32, device=dev)
    sink = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    in_pat = (jj[None, :] >= 1) & (jj[None, :] <= plen[:, None])
    plen_col = plen[:, None].to(torch.int64)

    def shift1(x):
        return torch.cat([neg_col, x[:, :-1]], dim=1)

    for d in range(2, M + N + 1):
        new_sym = torch.where(d - 1 < tlen, texts[:, min(d - 1, N - 1)], -1)
        tw = torch.cat([new_sym[:, None], tw[:, :-1]], dim=1)
        ii = d - jj
        sub = _subst_scores(pat_row, tw, match, mm, matrix)
        diag = shift1(H2) + sub
        if hamming:
            Hd, Ed, Fd = diag, E1, F1
        elif gotoh:
            Ed = torch.maximum(shift1(E1) + pe, shift1(H1) + po)
            Fd = torch.maximum(F1 + te, H1 + to)
            Hd = torch.maximum(diag, torch.maximum(Ed, Fd))
        else:
            Ed = shift1(H1) + po   # left move (linear)
            Fd = H1 + to           # top move (linear)
            Hd = torch.maximum(diag, torch.maximum(Ed, Fd))
        if local:
            Hd = Hd.clamp(min=0)

        # this diagonal's boundary cells: (d, 0) and (0, d)
        is_row0 = (jj == d)[None, :]
        Hd = torch.where(is_row0, row_boundary[None, :], Hd)
        Hd[:, 0] = col_boundary(d)
        if not local:
            Ed = torch.where(is_row0, neg, Ed)
            Ed[:, 0] = neg
            Fd = torch.where(is_row0, neg, Fd)
            Fd[:, 0] = neg

        if local:
            valid = (in_pat & (ii[None, :] >= 1)
                     & (ii[None, :] <= tlen[:, None]))
            masked = torch.where(valid, Hd, neg)
            row_best = masked.max(dim=1).values
            row_arg = torch.argmax(masked, dim=1).to(torch.int32)
            upd = row_best > best
            best = torch.where(upd, row_best, best)
            sink = torch.where(
                upd[:, None], torch.stack([d - row_arg, row_arg], dim=1), sink)
        elif atype == AlignmentType.SEMI_GLOBAL:
            hM = torch.gather(Hd, 1, plen_col)[:, 0]
            iM = d - plen
            upd = (iM >= 1) & (iM <= tlen) & (hM > best)
            best = torch.where(upd, hM, best)
            sink = torch.where(upd[:, None], torch.stack([iM, plen], dim=1),
                               sink)
        else:   # GLOBAL
            hM = torch.gather(Hd, 1, plen_col)[:, 0]
            ok = d == plen + tlen
            best = torch.where(ok, hM, best)
            sink = torch.where(ok[:, None], torch.stack([tlen, plen], dim=1),
                               sink)
        H1, H2, E1, F1 = Hd, H1, Ed, Fd

    if glob:
        # the score of aligning <= 1 symbol in all, recomputed
        small = torch.where(plen == 0, torch.where(tlen == 0, 0, to),
                            po).to(torch.int32)
        best = torch.where(plen + tlen <= 1, small, best)
    return BestSink(best, sink[:, 0], sink[:, 1])
