"""Bowtie2-compatible MAPQ (V2 evaluator), torch.

Port of ``nvbio_tpu.bowtie.mapq.mapq_v2_end_to_end`` (BowtieMapq2's
monotone branch, ``nvBowtie/bowtie2/cuda/mapq.h:146-263``) and
``mapq_v2_local`` (its local branch, ``mapq.h:267-326``): piecewise tables
over (best_over, best_diff) normalized by the score range; and of
``mapq_v3`` (BowtieMapq3, ``mapq.h:43-145``), binned lookup tables, which
no mapping path calls (as in the JAX package). The arithmetic
is float32, as in the JAX package: in float64 the threshold products
(diff * 0.8, ...) round differently and MAPQs flip at the edges.
"""

from __future__ import annotations

import torch


def mapq_v2_end_to_end(best, second, has_second, min_score, max_score=0):
    f32 = torch.float32
    best = best.to(f32)
    second = second.to(f32)
    min_score = min_score.to(f32)
    diff = torch.clamp(float(max_score) - min_score, min=1.0)
    bo = best - min_score
    sel = torch.where

    # --- no-second branch ---
    one = sel(bo >= diff * 0.8, 42,
              sel(bo >= diff * 0.7, 40,
                  sel(bo >= diff * 0.6, 24,
                      sel(bo >= diff * 0.5, 23,
                          sel(bo >= diff * 0.4, 8,
                              sel(bo >= diff * 0.3, 3, 0))))))

    # --- two-alignments branch ---
    bd = torch.abs(torch.abs(best) - torch.abs(second))
    perfect = bo == diff

    def tier(hi_val, f1, v1, f2, v2, v3):
        return sel(perfect, hi_val,
                   sel(bo >= diff * f1, v1, sel(bo >= diff * f2, v2, v3)))

    two = sel(
        bd >= diff * 0.9, sel(perfect, 39, 33),
        sel(bd >= diff * 0.8, sel(perfect, 38, 27),
            sel(bd >= diff * 0.7, sel(perfect, 37, 26),
                sel(bd >= diff * 0.6, sel(perfect, 36, 22),
                    sel(bd >= diff * 0.5, tier(35, 0.84, 25, 0.68, 16, 5),
                        sel(bd >= diff * 0.4, tier(34, 0.84, 21, 0.68, 14, 4),
                            sel(bd >= diff * 0.3,
                                tier(32, 0.88, 18, 0.67, 15, 3),
                                sel(bd >= diff * 0.2,
                                    tier(31, 0.88, 17, 0.67, 11, 0),
                                    sel(bd >= diff * 0.1,
                                        tier(30, 0.88, 12, 0.67, 7, 0),
                                        sel(bd > 0,
                                            sel(bo >= diff * 0.67, 6, 2),
                                            sel(bo >= diff * 0.67, 1,
                                                0)))))))))))

    q = torch.where(has_second, two, one)
    return torch.where(best < min_score, torch.zeros_like(q), q).to(
        torch.int32)


def mapq_v2_local(best, second, has_second, min_score, max_score):
    """BowtieMapq2, local (non-monotone) branch: ``max_score`` is the
    perfect score (match bonus x read length), (B,)."""
    f32 = torch.float32
    best = best.to(f32)
    second = second.to(f32)
    min_score = min_score.to(f32)
    diff = torch.clamp(max_score.to(f32) - min_score, min=1.0)
    bo = best - min_score
    sel = torch.where

    one = sel(bo >= diff * 0.8, 44,
              sel(bo >= diff * 0.7, 42,
                  sel(bo >= diff * 0.6, 41,
                      sel(bo >= diff * 0.5, 36,
                          sel(bo >= diff * 0.4, 28,
                              sel(bo >= diff * 0.3, 24, 22))))))

    bd = torch.abs(torch.abs(best) - torch.abs(second))
    at_max = bo == diff
    hi = bo >= diff * 0.5

    def tri(a, b, c):
        return sel(at_max, a, sel(hi, b, c))

    two = sel(
        bd >= diff * 0.9, 40,
        sel(bd >= diff * 0.8, 39,
            sel(bd >= diff * 0.7, 38,
                sel(bd >= diff * 0.6, 37,
                    sel(bd >= diff * 0.5, tri(35, 25, 20),
                        sel(bd >= diff * 0.4, tri(34, 21, 19),
                            sel(bd >= diff * 0.3, tri(33, 18, 16),
                                sel(bd >= diff * 0.2, tri(32, 17, 12),
                                    sel(bd >= diff * 0.1, tri(31, 14, 9),
                                        sel(bd > 0, sel(hi, 11, 2),
                                            sel(hi, 1, 0)))))))))))
    return torch.where(has_second, two, one).to(torch.int32)


# BowtieMapq3 lookup tables (``nvBowtie/bowtie2/cuda/mapq.h:43-145``)
_M3_ONE = torch.tensor([43, 42, 41, 36, 32, 27, 20, 11, 4, 1, 0],
                       dtype=torch.int32)
_M3_TWO_PERFECT = torch.tensor([2, 16, 23, 30, 31, 32, 34, 36, 38, 40, 42],
                               dtype=torch.int32)
_M3_TWO = torch.tensor([
    [2, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0],
    [20, 14, 7, 3, 2, 1, 0, 0, 0, 0, 0],
    [20, 16, 10, 6, 3, 1, 0, 0, 0, 0, 0],
    [20, 17, 13, 9, 3, 1, 1, 0, 0, 0, 0],
    [21, 19, 15, 9, 5, 2, 2, 0, 0, 0, 0],
    [22, 21, 16, 11, 10, 5, 0, 0, 0, 0, 0],
    [23, 22, 19, 16, 11, 0, 0, 0, 0, 0, 0],
    [24, 25, 21, 30, 0, 0, 0, 0, 0, 0, 0],
    [30, 26, 29, 0, 0, 0, 0, 0, 0, 0, 0],
    [30, 27, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [30, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
], dtype=torch.int32)


def mapq_v3(best, second, has_second, min_score, max_score, is_paired=None):
    """BowtieMapq3, the bowtie1-style binned quality: (B,) int32 best and
    second scores, has_second, min and max (perfect) scores; optional
    ``is_paired`` hits short-circuit to 44. int32 out."""
    f32 = torch.float32
    dev = best.device
    bestf = best.to(f32)
    maxf = max_score.to(f32)
    minf = min_score.to(f32)
    norm = 10.0 / torch.clamp(maxf - minf, min=1.0)

    neg_best = torch.clamp(maxf - bestf, min=0.0)      # negated best score
    best_bin = (neg_best * norm + 0.5).to(torch.int32).clamp(0, 10).long()
    at_max = neg_best == 0

    diff = (best - second).to(f32)
    diff_bin = (diff * norm + 0.5).to(torch.int32).clamp(0, 10).long()

    one = torch.where(at_max, 44, _M3_ONE.to(dev)[best_bin])
    two = torch.where(at_max, _M3_TWO_PERFECT.to(dev)[best_bin],
                      _M3_TWO.to(dev)[diff_bin, best_bin])
    q = torch.where(has_second, two, one)
    q = torch.where(bestf < minf, 0, q)
    if is_paired is not None:
        q = torch.where(is_paired, 44, q)
    return q.to(torch.int32)
