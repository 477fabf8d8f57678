"""Batched FM-index search: backward search, sampled-SA locate, interval
splits and the hybrid 1-mismatch search of the reseed pass.

Port of the parts of ``nvbio_tpu.fmi.search`` the map path calls
(``step_backward`` :53, ``backward_search_core`` :59, ``locate_core``
:116, ``search_1mm_hybrid_topk`` :302, ``extend_backward_all`` :402). The
JAX package's scans become Python loops of a fixed trip count over tensor
ops on the index's device: no loop reads a value back to the host, so on
CUDA a whole search is enqueued without a stall. Every gather index is
clamped into its table (a torch index out of range is a device-side assert
on CUDA); the JAX masks are kept, so clamped lanes never reach a result.
Intervals and positions are int64.
"""

from __future__ import annotations

import torch

from nvbio_tpu_torch.fmi.rank import popcount32, rank, rank_all, \
    symbol_and_rank


def _adjust(fmi, i):
    """Row of the full BWT -> position in the stored BWT ($ removed)."""
    return i - (i > fmi.primary).to(i.dtype)


def step_backward(fmi, c, lo, hi):
    """One backward-search step: prepend symbol c to the matched suffix.
    The (lo, hi) ranks of a lane come from one stacked rank call."""
    c = c.to(torch.int64).clamp(0, 3)
    r = rank(fmi.rank_rows, c, _adjust(fmi, torch.stack([lo, hi])))
    cnt = fmi.count[c]
    return cnt + r[0], cnt + r[1]


def backward_search_core(fmi, queries, qlens):
    """Exact match: SA interval [lo, hi) per query ((B, L) left-aligned).

    With an ftab attached, queries of length >= ftab_k start from the
    interval of their k-symbol suffix (key: the leftmost symbol in the high
    bits, symbols folded with min(., 3)); shorter lanes start from the full
    range and need at most k-1 steps, so the loop runs max(L-k, min(k-1, L))
    steps. Lanes that are done or empty are frozen and gather at (0, 0)."""
    queries = queries.to(torch.int64)
    qlens = qlens.to(torch.int64)
    B, L = queries.shape
    dev = queries.device
    k = fmi.ftab_k if fmi.ftab_lo is not None else 0
    full = torch.full((B,), fmi.n + 1, dtype=torch.int64, device=dev)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    if k and L >= k:
        use = qlens >= k
        j0 = (qlens - k).clamp(0, L - k)
        win = torch.gather(queries, 1, j0[:, None] + torch.arange(
            k, dtype=torch.int64, device=dev)[None, :]).clamp(max=3)
        shifts = 2 * (k - 1 - torch.arange(k, dtype=torch.int64, device=dev))
        key = torch.sum(win << shifts, dim=1).clamp(0, 4 ** k - 1)
        lo = torch.where(use, fmi.ftab_lo[key].to(torch.int64), zero)
        hi = torch.where(use, fmi.ftab_hi[key].to(torch.int64), full)
        qeff = torch.where(use, qlens - k, qlens)
        n_steps = max(L - k, min(k - 1, L))
    else:
        lo, hi, qeff, n_steps = zero, full, qlens, L
    for s in range(n_steps):
        j = (qeff - 1 - s).clamp(0, L - 1)
        c = torch.gather(queries, 1, j[:, None])[:, 0]
        active = (s < qeff) & (hi > lo)
        nlo, nhi = step_backward(fmi, c, torch.where(active, lo, 0),
                                 torch.where(active, hi, 0))
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
    return lo, hi


def locate_core(fmi, rows):
    """SA values of SA rows (in [0, n]) by a fixed ``sa_interval``-step LF
    walk; (positions int64, resolved). Each step gathers one SSA row
    (marks word and its exclusive popcount) and one rank row (the symbol
    and its rank); the sampled value is fetched once, after the walk."""
    i = rows.to(torch.int64).clamp(0, fmi.n)
    ssa, vals = fmi.ssa_rows, fmi.ssa_vals
    nw, nv = ssa.shape[0], vals.shape[0]
    tpos = torch.zeros_like(i)
    mrank = torch.zeros_like(i)
    done = torch.zeros_like(i, dtype=torch.bool)
    for t in range(fmi.sa_interval):
        iq = torch.where(done, 0, i)   # finished walks gather at row 0
        row = ssa[(iq // 32).clamp(max=nw - 1)].to(torch.int64)
        w, cu = row[:, 0] & 0xFFFFFFFF, row[:, 1]
        bit = iq % 32
        hit = (((w >> bit) & 1) != 0) & ~done
        rk_mark = cu + popcount32(w & ((1 << bit) - 1))
        tpos = torch.where(hit, t, tpos)
        mrank = torch.where(hit, rk_mark, mrank)
        done = done | hit
        c, rk = symbol_and_rank(fmi.rank_rows, _adjust(fmi, iq))
        i = torch.where(done, i, fmi.count[c] + rk)
    val = vals[mrank.clamp(0, nv - 1)].to(torch.int64)
    return torch.where(done, val + tpos, 0), done


def extend_backward_all(fmi, lo, hi):
    """Intervals for all 4 prepended symbols: (lo4, hi4) of shape (..., 4),
    one stacked rank-row gather for both ends."""
    r = rank_all(fmi.rank_rows, _adjust(fmi, torch.stack([lo, hi])))
    cnt = fmi.count[:4]
    return cnt + r[0], cnt + r[1]


def search_1mm_hybrid_topk(fmi, queries, qlens, n_approx: int, K: int = 8):
    """Approx-hybrid 1-mismatch search with top-K survivor compaction.

    0 mismatches in the seed's right part, at most 1 in its left
    ``n_approx`` positions (the reference's ``mapping.h:66-73``): one exact
    backward pass records the interval before every step; a mutation at
    position j resumes from the state after qlen-1-j steps through all 4
    symbols at once (``extend_backward_all``), the original symbol's column
    dropped; the K nonempty branches with the smallest j (ties in index
    order, as ``jax.lax.top_k``) then walk their j remaining original
    symbols. Returns (exact_lo, exact_hi, mm_lo, mm_hi), mm_* (B, K) with
    empty slots at lo == hi == 0."""
    from nvbio_tpu_torch.bowtie.paired import top_k_stable

    queries = queries.to(torch.int64)
    qlens = qlens.to(torch.int64)
    B, L = queries.shape
    A = min(n_approx, L)
    dev = queries.device
    lo = torch.zeros((B,), dtype=torch.int64, device=dev)
    hi = torch.full((B,), fmi.n + 1, dtype=torch.int64, device=dev)
    st_lo, st_hi = [], []
    for s in range(L):
        st_lo.append(lo)
        st_hi.append(hi)
        j = (qlens - 1 - s).clamp(0, L - 1)
        c = torch.gather(queries, 1, j[:, None])[:, 0]
        active = (s < qlens) & (hi > lo)
        nlo, nhi = step_backward(fmi, c, torch.where(active, lo, 0),
                                 torch.where(active, hi, 0))
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
    exact_lo, exact_hi = lo, hi

    jpos = torch.arange(A, dtype=torch.int64, device=dev)
    t = (qlens[:, None] - 1 - jpos[None, :]).clamp(0, L - 1)      # (B, A)
    blo = torch.gather(torch.stack(st_lo, dim=1), 1, t)
    bhi = torch.gather(torch.stack(st_hi, dim=1), 1, t)
    lo4, hi4 = extend_backward_all(fmi, blo, bhi)                  # (B, A, 4)
    base_sym = queries[:, :A]
    deltas = torch.arange(1, 4, dtype=torch.int64, device=dev)
    mm_sym = (base_sym[:, :, None] + deltas) % 4                   # (B, A, 3)
    mlo = torch.gather(lo4, 2, mm_sym)
    mhi = torch.gather(hi4, 2, mm_sym)
    pvalid = (jpos[None, :, None] < qlens[:, None, None]) & \
        (bhi > blo)[:, :, None]
    mlo = torch.where(pvalid, mlo, 0)
    mhi = torch.where(pvalid, mhi, 0)

    # ---- top-K survivor compaction (per seed) ------------------------------
    ne = (mhi > mlo).reshape(B, A * 3)
    jf = jpos[None, :, None].expand(B, A, 3).reshape(B, A * 3)
    score = torch.where(ne, A - jf, -1)          # smaller j = more specific
    _, sel = top_k_stable(score, min(K, A * 3))

    def pick(x):
        return torch.gather(x.reshape(B, A * 3), 1, sel)

    cok = pick(ne)
    clo = torch.where(cok, pick(mlo), 0)
    chi = torch.where(cok, pick(mhi), 0)
    cj = pick(jf)
    # continuation: walk the j remaining original symbols (j-1-u at step u)
    for u in range(A - 1):
        c = torch.gather(queries, 1, (cj - 1 - u).clamp(0, L - 1))
        active = (u < cj) & (chi > clo)
        nlo, nhi = step_backward(fmi, c, torch.where(active, clo, 0),
                                 torch.where(active, chi, 0))
        clo = torch.where(active, nlo, clo)
        chi = torch.where(active, nhi, chi)
    empty = ~cok | (chi <= clo)
    return (exact_lo, exact_hi, torch.where(empty, 0, clo),
            torch.where(empty, 0, chi))
