"""Anchor chaining: the dense-batch equivalent of nvmem's chain builder.

Port of ``nvbio_tpu.mem.chain``. The reference builds chains with per-read
priority queues (``nvmem/build-chains.cu``); here chaining is a batched
O(A^2) DP over the A anchors of each read: f[i] = len_i + max over
compatible j < i of (f[j] - gap cost), anchors in (tpos, qbeg) order. The
JAX ``fori_loop`` over anchors becomes a Python loop over columns (each an
indexed write into the DP's own tensors, never the caller's), its parent
``scan`` a loop of A steps. ``argmax`` takes the first maximum on both
devices, as ``jnp.argmax`` does. Arithmetic is int64; the one place where
the JAX package's int32 wraps (``chain_anchors``' sort key of an invalid
anchor, 2**30 * 2) is wrapped the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nvbio_tpu_torch.align.types import NEG_INF

INVALID_KEY = 2**30   # the sort key of an invalid anchor


class BestChain(NamedTuple):
    score: torch.Tensor      # (B,)
    qbeg: torch.Tensor       # (B,) chain span in the read
    qend: torch.Tensor
    tbeg: torch.Tensor       # (B,) genome pos of the chain's first anchor
    n_anchors: torch.Tensor  # (B,)
    valid: torch.Tensor      # (B,) bool


class TopChains(NamedTuple):
    """K best chains per row (descending score), nvmem's per-read chain
    list + overlap filter (``nvmem/pipeline.h:107-147``)."""

    score: torch.Tensor   # (B, K)
    qbeg: torch.Tensor    # (B, K)
    qend: torch.Tensor    # (B, K)
    tbeg: torch.Tensor    # (B, K)
    valid: torch.Tensor   # (B, K) bool


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as the int32 the JAX package computes them in."""
    x = x & 0xFFFFFFFF
    return x - ((x >> 31) << 32)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[b, i[b]] for (B, A) x and (B,) i."""
    return torch.gather(x, 1, i[:, None])[:, 0]


def _sorted_anchors(qbeg, qend, tpos, valid, key):
    order = torch.argsort(key, dim=1, stable=True)
    qb, qe, tp = (torch.gather(x.to(torch.int64), 1, order)
                  for x in (qbeg, qend, tpos))
    return qb, qe, tp, qe - qb, torch.gather(valid, 1, order)


def _chain_dp(qb, tp, ln, va, max_gap: int, bandwidth: int,
              gap_coeff_num: int, gap_coeff_den: int,
              require_qb: bool = False):
    """f (B, A) best chain score ending at each anchor and its parent (-1 at
    a chain head); a column at a time, as the JAX ``fori_loop``."""
    B, A = qb.shape
    dev = qb.device
    f = torch.where(va, ln, NEG_INF)
    parent = torch.full((B, A), -1, dtype=torch.int64, device=dev)
    cols = torch.arange(A, dtype=torch.int64, device=dev)[None, :]
    for i in range(A):
        dq = qb[:, i:i + 1] - qb
        dt = tp[:, i:i + 1] - tp
        drift = (dq - dt).abs()
        compat = ((cols < i) & va & va[:, i:i + 1] & (dq > 0) & (dt > 0)
                  & (dt <= max_gap) & (drift <= bandwidth))
        if require_qb:
            compat = compat & (qb >= 0)
        cand = f + ln[:, i:i + 1] - (drift * gap_coeff_num) // gap_coeff_den
        cand = torch.where(compat, cand, NEG_INF)
        best_j = torch.argmax(cand, dim=1)
        best_v = _take(cand, best_j)
        upd = best_v > f[:, i]
        f[:, i] = torch.where(upd, best_v, f[:, i])
        parent[:, i] = torch.where(upd, best_j, -1)
    return f, parent


def chain_anchors(qbeg, qend, tpos, valid, max_gap: int = 1000,
                  bandwidth: int = 100, gap_coeff_num: int = 1,
                  gap_coeff_den: int = 8) -> BestChain:
    """Chain anchors per read; all inputs (B, A). Returns the best chain.

    Score model: anchor length minus |diagonal drift| * coeff between
    consecutive anchors (an integer simplification of BWA-MEM's chaining
    weight)."""
    B, A = qbeg.shape
    dev = qbeg.device
    # (tpos, qbeg) order by a stable sort; 2**30 * 2 wraps to -2**31 in
    # the JAX package's int32, so invalid anchors sort first there too
    key = _wrap_i32(torch.where(valid, tpos.to(torch.int64), INVALID_KEY)
                    * 2)
    qb, qe, tp, ln, va = _sorted_anchors(qbeg, qend, tpos, valid, key)
    f, parent = _chain_dp(qb, tp, ln, va, max_gap, bandwidth,
                          gap_coeff_num, gap_coeff_den, require_qb=True)

    tail = torch.argmax(f, dim=1)
    score = _take(f, tail)
    # walk parents to the chain head
    i = tail
    count = torch.ones((B,), dtype=torch.int64, device=dev)
    for _ in range(A):
        par = _take(parent, i)
        live = par >= 0
        count = count + live.to(torch.int64)
        i = torch.where(live, par, i)
    head = i
    qe_tail = _take(qe, tail)
    tbeg = _take(tp, head)
    qbeg_chain = _take(qb, head)

    valid_chain = score > NEG_INF // 2
    return BestChain(
        score=score,
        qbeg=torch.where(valid_chain, qbeg_chain, 0),
        qend=torch.where(valid_chain, qe_tail, 0),
        tbeg=torch.where(valid_chain, tbeg, 0),
        n_anchors=count,
        valid=valid_chain,
    )


def chain_anchors_topk(qbeg, qend, tpos, valid, n_chains: int,
                       max_gap: int = 1000, bandwidth: int = 100,
                       gap_coeff_num: int = 1, gap_coeff_den: int = 8,
                       overlap_den: int = 2) -> TopChains:
    """K best anchor chains per read with overlap filtering.

    Same DP as ``chain_anchors``, then K rounds of: pick the best remaining
    tail, walk its parents collecting the member-anchor mask, suppress
    those anchors, repeat. A chain whose read span overlaps an already
    kept chain by more than span/overlap_den, and which scores below half
    of it, is dropped (bwa-mem's chain filter, ``nvmem/pipeline.h:107-147``,
    ``nvmem.cu:128-149``); each round compares against every chain kept
    before it, in round order. Returns TopChains (B, n_chains), scores
    descending."""
    B, A = qbeg.shape
    dev = qbeg.device
    key = torch.where(valid, tpos.to(torch.int64), INVALID_KEY)
    qb, qe, tp, ln, va = _sorted_anchors(qbeg, qend, tpos, valid, key)
    f, parent = _chain_dp(qb, tp, ln, va, max_gap, bandwidth,
                          gap_coeff_num, gap_coeff_den)

    cols = torch.arange(A, dtype=torch.int64, device=dev)[None, :]
    f_work = f
    outs = []
    kept = []   # (qbeg, qend, score, ok) of the chains of earlier rounds
    for _ in range(n_chains):
        tail = torch.argmax(f_work, dim=1)
        score_k = _take(f_work, tail)
        i = tail
        member = torch.zeros((B, A), dtype=torch.bool, device=dev)
        for _ in range(A):
            member = member | (cols == i[:, None])
            par = _take(parent, i)
            i = torch.where(par >= 0, par, i)
        head = i
        qb_k = _take(qb, head)
        tb_k = _take(tp, head)
        qe_k = _take(qe, tail)
        ok = score_k > NEG_INF // 2
        for kqb, kqe, ks, kok in kept:
            ov = torch.minimum(qe_k, kqe) - torch.maximum(qb_k, kqb)
            span = (qe_k - qb_k).clamp(min=1)
            ok = ok & ~(kok & (ov * overlap_den > span) & (score_k * 2 < ks))
        outs.append((score_k, qb_k, qe_k, tb_k, ok))
        kept.append((qb_k, qe_k, score_k, ok))
        # suppress this chain's anchors for the next round
        f_work = torch.where(member, NEG_INF, f_work)

    def stack(j):
        return torch.stack([o[j] for o in outs], dim=1)

    ok = stack(4)
    return TopChains(
        score=stack(0),
        qbeg=torch.where(ok, stack(1), 0),
        qend=torch.where(ok, stack(2), 0),
        tbeg=torch.where(ok, stack(3), 0),
        valid=ok,
    )
