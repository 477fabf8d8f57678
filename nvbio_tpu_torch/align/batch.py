"""Batched banded Gotoh scorer, plain torch: the TPU kernel K3's function.

The flat (pattern, text) scorer: the band state is a dense (B, W) plane
updated once per pattern row, the within-row text-gap dependency broken by
an exclusive prefix max ("lazy F"). It computes what the TPU kernel
``banded_score_semiglobal_pallas`` (``nvbio_tpu/align/pallas_kernels.py:
133``) computes, SEMI_GLOBAL or LOCAL, and is the plain version of the
port's K3 (``align.kernels.banded_score``). The JAX package's scan scorer
(``nvbio_tpu.align.batch.batch_score_banded``) leaves its prefix max
unfloored where K3 floors it at NEG_INF; the two differ only in rows whose
every cell lies near NEG_INF (no alignment exists).
"""

from __future__ import annotations

import torch

from nvbio_tpu_torch.align.types import NEG_INF, GotohScoring


def batch_score_banded(patterns, pattern_lens, texts, text_lens,
                       scoring: GotohScoring, band: int,
                       mismatch_scores=None, local: bool = False):
    """Banded scores: returns (score, k_best), (B,) int32.

    DP cell (i, k): pattern consumed i, text consumed i + k, k in
    [0, band). patterns (B, M), texts (B, >= M + band - 1), lens (B,).
    SEMI_GLOBAL scores the row at ``pattern_lens``; ``local=True`` floors
    H at 0 and keeps a running max over the cells with i <= plen and
    i - 1 + k < tlen (pallas_kernels.py:93-94, :108-112).
    """
    B, M = patterns.shape
    W = band
    TW = M + W - 1
    dev = patterns.device
    po, pe = scoring.pattern_gap_open, scoring.pattern_gap_ext
    to, te = scoring.text_gap_open, scoring.text_gap_ext
    neg = NEG_INF
    pats = patterns.to(torch.int32)
    texts = texts.to(torch.int32)
    if texts.shape[1] < TW:
        texts = torch.nn.functional.pad(texts, (0, TW - texts.shape[1]))
    plen = pattern_lens.to(torch.int32)
    tlen = text_lens.to(torch.int32)
    mm = (None if mismatch_scores is None
          else mismatch_scores.to(torch.int32))

    kcol = torch.arange(W, dtype=torch.int32, device=dev)
    H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    E = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    final = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), neg, dtype=torch.int32, device=dev)
    for im1 in range(M):
        p = pats[:, im1:im1 + 1]
        trow = texts[:, im1:im1 + W]
        mmv = scoring.mismatch if mm is None else mm[:, im1:im1 + 1]
        in_text = (im1 + kcol)[None, :] < tlen[:, None]
        sub = torch.where(p == trow, scoring.match, mmv).to(torch.int32)
        sub = torch.where(in_text, sub, neg)
        diag = H + sub
        Erow = torch.maximum(torch.cat([E[:, 1:], neg_col], dim=1) + pe,
                             torch.cat([H[:, 1:], neg_col], dim=1) + po)
        H0 = torch.maximum(diag, Erow)
        if local:
            H0 = H0.clamp(min=0)
        # F[k] = te*(k-1) + max(NEG, max_{k'<k}(H0[k'] + to - te*k'))
        G = torch.cummax(H0 + (to - te * kcol), dim=1).values.clamp(min=neg)
        F = torch.cat([neg_col, G[:, :-1]], dim=1) + te * (kcol - 1)
        Hrow = torch.maximum(H0, F)
        if local:
            valid = in_text & (im1 + 1 <= plen)[:, None]
            final = torch.maximum(final, torch.where(valid, Hrow, neg))
        else:
            final = torch.where((plen == im1 + 1)[:, None], Hrow, final)
        H, E = Hrow, Erow
    score = final.max(dim=1).values
    k_best = torch.argmax(final, dim=1).to(torch.int32)
    return score, k_best
