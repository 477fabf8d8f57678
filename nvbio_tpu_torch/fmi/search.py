"""Batched FM-index search: backward search, sampled-SA locate, interval
splits and the hybrid 1-mismatch search of the reseed pass.

Port of ``nvbio_tpu.fmi.search``: the parts the map path calls
(``step_backward`` :53, ``backward_search_core`` :59, ``locate_core``
:116, ``search_1mm_hybrid_topk`` :302, ``extend_backward_all`` :402) and
the library searches (``search_1mm`` :189, ``search_1mm_hybrid`` :216,
``search_kmm_core`` :420 with ``priority.py``'s beam, ``search_kmm``
:485; ``backward_search`` and ``locate_batch`` are the plain calls). The
JAX package's scans become Python loops of a fixed trip count over tensor
ops (the ``*_plain`` functions): no loop reads a value back to the host.
Every gather index is clamped into its table (a torch index out of range is
a device-side assert on CUDA); the JAX masks are kept, so clamped lanes
never reach a result. Intervals and positions are int64.

``backward_search_core``, ``locate_core`` and ``search_1mm_hybrid_topk``
route CPU tensors to the plain version and CUDA tensors to one launch of
``csrc/fm_search.cu`` (a lane a thread, its walk in registers, left as
soon as it is done or empty) through ``align.kernels``' launchers
``fm_backward_search``, ``fm_locate`` and ``fm_search_1mm_topk``, which
count their launches; the plain version's results bit for bit. While a
profiler records, each launch also writes the steps each lane took, held
as the counter ``fm_steps`` beside ``fm_steps_fixed``, the steps of the
plain version's fixed loops (``utils.timers``).
"""

from __future__ import annotations

import torch

from nvbio_tpu_torch.align import kernels as cuda_kernels
from nvbio_tpu_torch.fmi.rank import popcount32, rank, rank_all, \
    symbol_and_rank
from nvbio_tpu_torch.utils import timers


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


def backward_search_core_plain(fmi, queries, qlens):
    """``backward_search_core`` as torch ops.

    Exact match: SA interval [lo, hi) per query ((B, L) left-aligned).

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


def locate_core_plain(fmi, rows):
    """``locate_core`` as torch ops: SA values of SA rows (in [0, n]) by
    a fixed ``sa_interval``-step LF walk; (positions int64, resolved).
    Each step gathers one SSA row (marks word and its exclusive popcount)
    and one rank row (the symbol and its rank); the sampled value is
    fetched once, after the walk."""
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


def search_1mm_hybrid_topk_plain(fmi, queries, qlens, n_approx: int,
                                 K: int = 8):
    """``search_1mm_hybrid_topk`` as torch ops.

    Approx-hybrid 1-mismatch search with top-K survivor compaction.

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


# ---- the CUDA kernels (csrc/fm_search.cu, launched by align.kernels) ------

def _cuda_walk_inputs(queries, qlens):
    """The int32 (B, L) queries and the (B,) lengths (int32 or int64) the
    kernels read, contiguous."""
    q = queries if queries.dtype == torch.int32 else queries.to(torch.int32)
    ql = qlens if qlens.dtype in (torch.int32, torch.int64) \
        else qlens.to(torch.int64)
    return q.contiguous(), ql.contiguous()


def _steps(lanes: int, fixed: int, dev):
    """The per-lane steps output of one launch (int16, the kernel fills it)
    while a profiler records, held as the counter ``fm_steps`` with the
    plain loops' ``fm_steps_fixed`` = ``lanes * fixed``: no device op;
    else None (the kernel writes none)."""
    if not lanes or not timers.recording():
        return None
    steps = torch.empty(lanes, dtype=torch.int16, device=dev)
    timers.count("fm_steps", steps)
    timers.count("fm_steps_fixed", lanes * fixed)
    return steps


def backward_search_core(fmi, queries, qlens):
    """Exact match: SA interval [lo, hi) per query ((B, L) left-aligned),
    int64; ``backward_search_core_plain``'s results. CUDA tensors: one
    ``align.kernels.fm_backward_search`` launch (queries read as int32)."""
    if queries.device.type == "cpu":
        return backward_search_core_plain(fmi, queries, qlens)
    q, ql = _cuda_walk_inputs(queries, qlens)
    L = q.shape[-1]
    k = fmi.ftab_k if fmi.ftab_lo is not None and L >= fmi.ftab_k else 0
    n_steps = max(L - k, min(k - 1, L)) if k else L
    return cuda_kernels.fm_backward_search(
        q, ql, fmi.rank_rows, fmi.count, fmi.primary, fmi.n, fmi.ftab_lo,
        fmi.ftab_hi, k, n_steps, _steps(q.shape[0], n_steps, q.device))


def locate_core(fmi, rows):
    """SA values of SA rows (in [0, n], clamped) by an LF walk of at most
    ``sa_interval`` steps: (positions int64, resolved);
    ``locate_core_plain``'s results. CUDA tensors: one
    ``align.kernels.fm_locate`` launch."""
    if rows.device.type == "cpu":
        return locate_core_plain(fmi, rows)
    r = rows.to(torch.int64).contiguous()
    return cuda_kernels.fm_locate(
        r, fmi.rank_rows, fmi.count, fmi.primary, fmi.n, fmi.ssa_rows,
        fmi.ssa_vals, fmi.sa_interval,
        _steps(r.numel(), fmi.sa_interval, r.device))


def search_1mm_hybrid_topk(fmi, queries, qlens, n_approx: int, K: int = 8):
    """Approx-hybrid 1-mismatch search with top-K survivor compaction:
    (exact_lo, exact_hi, mm_lo, mm_hi), mm_* (B, min(K, 3 min(n_approx,
    L))) with empty slots at lo == hi == 0; ``search_1mm_hybrid_topk_
    plain``'s results (its docstring has the rule). CUDA tensors: one
    ``align.kernels.fm_search_1mm_topk`` launch."""
    if queries.device.type == "cpu":
        return search_1mm_hybrid_topk_plain(fmi, queries, qlens, n_approx, K)
    q, ql = _cuda_walk_inputs(queries, qlens)
    L = q.shape[-1]
    A = max(min(n_approx, L), 0)
    Kout = max(min(K, A * 3), 0)
    return cuda_kernels.fm_search_1mm_topk(
        q, ql, fmi.rank_rows, fmi.count, fmi.primary, fmi.n, A, Kout,
        _steps(q.shape[0], L + A + Kout * max(A - 1, 0), q.device))


def backward_search(fmi, queries, qlens):
    """``backward_search_core`` on tensors (or numpy arrays) moved to the
    index's device."""
    dev = fmi.device
    return backward_search_core(fmi, torch.as_tensor(queries, device=dev),
                                torch.as_tensor(qlens, device=dev))


def locate_batch(fmi, rows):
    return locate_core(fmi, torch.as_tensor(rows, device=fmi.device))


def search_1mm(fmi, queries, qlens):
    """Exact + all 1-mismatch SA ranges, dense enumeration: every position
    j of every query substituted by (q[j] + d) % 4, d = 1..3, each mutated
    query backward-searched in full (L·3 + 1 searches a query).

    Returns (exact_lo, exact_hi, mm_lo (B,L,3), mm_hi (B,L,3), mm_sym
    (B,L,3)); positions past a query's length give (0, 0)."""
    dev = fmi.device
    queries = torch.as_tensor(queries, device=dev).to(torch.int64)
    qlens = torch.as_tensor(qlens, device=dev).to(torch.int64)
    B, L = queries.shape
    deltas = torch.arange(1, 4, dtype=torch.int64, device=dev)
    eye = torch.eye(L, dtype=torch.int64, device=dev)
    mutated = (queries[:, None, None, :]
               + eye[None, :, None, :] * deltas[None, None, :, None]) % 4
    pos = torch.arange(L, device=dev)
    mm_sym = mutated[:, pos, :, pos].permute(1, 0, 2)          # (B, L, 3)
    lo, hi = backward_search_core(fmi, mutated.reshape(B * L * 3, L),
                                  qlens.repeat_interleave(L * 3))
    exact_lo, exact_hi = backward_search_core(fmi, queries, qlens)
    pvalid = (pos[None, :] < qlens[:, None])[..., None]
    mm_lo = torch.where(pvalid, lo.reshape(B, L, 3), 0)
    mm_hi = torch.where(pvalid, hi.reshape(B, L, 3), 0)
    return exact_lo, exact_hi, mm_lo, mm_hi, mm_sym


def search_1mm_hybrid(fmi, queries, qlens, n_approx: int):
    """Approx-hybrid 1-mismatch seeding (the reference's map_approx scheme,
    ``mapping.h:66-73``): 0 mismatches in the seed's right part, at most 1
    in its left ``n_approx`` positions. One exact backward pass records
    the interval before every step; a mutation at position j resumes from
    the state after qlen-1-j steps with the substituted symbol (one
    ``step_backward`` a delta), then walks the j remaining original
    symbols.

    Returns (exact_lo, exact_hi, mm_lo, mm_hi, mm_sym), mm_* of shape
    (B, n_approx, 3) for mutation positions 0..n_approx-1 from the left."""
    dev = fmi.device
    queries = torch.as_tensor(queries, device=dev).to(torch.int64)
    qlens = torch.as_tensor(qlens, device=dev).to(torch.int64)
    B, L = queries.shape
    A = min(n_approx, L)
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
    base_sym = torch.gather(queries, 1, jpos.clamp(max=L - 1)[None, :]
                            .expand(B, A))
    deltas = torch.arange(1, 4, dtype=torch.int64, device=dev)
    mm_sym = (base_sym[:, :, None] + deltas) % 4                   # (B, A, 3)
    mlo, mhi = step_backward(fmi, mm_sym, blo[:, :, None].expand(B, A, 3),
                             bhi[:, :, None].expand(B, A, 3))
    # continuation: walk the j remaining original symbols (j-1-u at step u)
    for u in range(A - 1):
        c = torch.gather(queries, 1, (jpos - 1 - u).clamp(0, L - 1)[None, :]
                         .expand(B, A))
        active = (u < jpos[None, :, None]) & (mhi > mlo)
        nlo, nhi = step_backward(fmi, c[:, :, None].expand(B, A, 3),
                                 torch.where(active, mlo, 0),
                                 torch.where(active, mhi, 0))
        mlo = torch.where(active, nlo, mlo)
        mhi = torch.where(active, nhi, mhi)
    pvalid = jpos[None, :, None] < qlens[:, None, None]
    return (exact_lo, exact_hi, torch.where(pvalid, mlo, 0),
            torch.where(pvalid, mhi, 0), mm_sym)


def search_kmm_core(fmi, queries, qlens, k: int, max_states: int = 32):
    """Approximate backward search with up to ``k`` mismatches.

    A beam of ``max_states`` live (lo, hi, n_mismatch) states per query
    advances in lockstep over suffix positions; each step branches every
    state through all 4 symbols (``extend_backward_all``), charges a
    mismatch for non-query symbols, and pushes the whole 4-way expansion
    into a ``max_states``-slot ``BatchPriorityQueue`` keyed by -mismatches
    (a stable sort: ties go to the queue's empty slots first, then to the
    expansion's column order, as in the JAX package). Distinct mismatch
    sets can reach the same SA range; callers that count occurrences
    should dedup on (lo, hi).

    Returns (lo, hi, n_mis, valid), each (B, max_states), mismatch-sorted."""
    from nvbio_tpu_torch.priority import NEG_INF as QNEG
    from nvbio_tpu_torch.priority import BatchPriorityQueue

    dev = fmi.device
    queries = torch.as_tensor(queries, device=dev).to(torch.int64)
    qlens = torch.as_tensor(qlens, device=dev).to(torch.int64)
    B, L = queries.shape
    S = max_states
    slot = torch.arange(S, dtype=torch.int64, device=dev)
    lo = torch.zeros((B, S), dtype=torch.int64, device=dev)
    hi = torch.where(slot == 0, fmi.n + 1, 0).expand(B, S)
    nm = torch.zeros((B, S), dtype=torch.int64, device=dev)
    valid = (slot == 0).expand(B, S)
    flat_idx = torch.arange(S * 4, dtype=torch.int32,
                            device=dev).expand(B, S * 4)
    sym = torch.arange(4, dtype=torch.int64, device=dev)
    for s in range(L):
        j = (qlens - 1 - s).clamp(0, L - 1)
        c = torch.gather(queries, 1, j[:, None])[:, 0]
        lo4, hi4 = extend_backward_all(fmi, lo, hi)              # (B, S, 4)
        nm4 = nm[:, :, None] + (sym[None, None, :] != c[:, None, None])
        valid4 = valid[:, :, None] & (hi4 > lo4) & (nm4 <= k)
        q = BatchPriorityQueue.make(B, S, xp=torch, device=dev).push(
            (-nm4).reshape(B, S * 4), flat_idx,
            mask=valid4.reshape(B, S * 4))
        order = q.values.to(torch.int64)

        def pick(x4):
            return torch.gather(x4.reshape(B, S * 4), 1, order)

        active = (s < qlens)[:, None]
        lo = torch.where(active, pick(lo4), lo)
        hi = torch.where(active, pick(hi4), hi)
        nm = torch.where(active, pick(nm4), nm)
        valid = torch.where(active, q.keys > QNEG, valid)
    return lo, hi, nm, valid


def search_kmm(fmi, queries, qlens, k: int, max_states: int = 32):
    return search_kmm_core(fmi, queries, qlens, k, max_states)
