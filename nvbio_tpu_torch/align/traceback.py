"""Banded and full-matrix traceback entry points and the host CIGAR/MD
formatters.

``batch_traceback_banded_fast`` is the port of the JAX function of the same
name (``nvbio_tpu/align/traceback.py:378``): one call of the fused
traceback kernel (``align.kernels.banded_traceback``; its plain version for
CPU tensors), returning ``(TracebackResult, nm)`` with ops END->START.
``batch_traceback_full`` (``traceback.py:436``) is the same kernel at band
T+M over left-padded text, in its wide form
(``align.kernels.banded_traceback_wide``).

``batch_traceback_banded`` and ``batch_traceback_full_scan`` are the
aligner library's traceback (the JAX package's scan route,
``traceback.py:54-281``, ``:482-498``), plain torch on the operands'
device, for every aligner and alignment type: a forward pass that records
one direction byte a band cell (``_banded_forward_dirs``), then a walk of
exactly M + W steps; they return plain op codes in forward order.
``cigar_to_string``, ``ops_to_chars`` and ``md_from_entries`` are copies
of the JAX package's numpy helpers.

Direction byte (per band cell): bits 0-1 the H provenance (0 diagonal, 1
E/pattern gap, 2 F/text gap, 3 local zero), bit 2 E extended from E, bit 3
F extended from F. Op codes: 0 none, 1 M, 2 I, 3 D. Packed op entry
layout: bits 0-1 op, bit 2 mismatch (M cells only), bits 3-6 the reference
symbol under the cell.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nvbio_tpu_torch.align.batch import (
    _exclusive_running_max,
    _gap_params,
    _subst_scores,
    _take_jax,
)
from nvbio_tpu_torch.align.kernels import (
    banded_traceback,
    banded_traceback_wide,
)
from nvbio_tpu_torch.align.types import (
    NEG_INF,
    AlignmentType,
    GotohScoring,
    HammingAligner,
)

OP_NONE, OP_M, OP_I, OP_D = 0, 1, 2, 3


class TracebackResult(NamedTuple):
    score: torch.Tensor          # (B,) int32
    # (B, MAXS) int32: packed entries END->START from the kernel route
    # (``batch_traceback_banded_fast``, ``batch_traceback_full``), plain op
    # codes in forward order from the scan route (``batch_traceback_banded``,
    # ``batch_traceback_full_scan``)
    ops: torch.Tensor
    n_ops: torch.Tensor          # (B,) int32 number of valid ops
    pattern_start: torch.Tensor  # (B,) int32 first pattern index consumed
    pattern_end: torch.Tensor    # (B,) int32 one-past-last pattern index
    text_start: torch.Tensor     # (B,) int32 first text index (window coords)
    text_end: torch.Tensor       # (B,) int32 one-past-last text index


def batch_traceback_banded_fast(patterns, pattern_lens, texts, text_lens,
                                scoring: GotohScoring, band: int,
                                mismatch_scores=None, local: bool = False):
    """SEMI_GLOBAL (or, ``local=True``, LOCAL) Gotoh traceback:
    ``(TracebackResult, nm)``; nm is the SAM NM edit count accumulated by
    the walk. ``ops`` are END->START: the host formatters reverse them
    (``reverse=True``)."""
    score, k0, ops, n_ops, k_fin, nm, i_end, i_start = banded_traceback(
        patterns, pattern_lens, texts, text_lens, scoring, band,
        mismatch_scores, local)
    return TracebackResult(
        score=score, ops=ops, n_ops=n_ops,
        pattern_start=i_start, pattern_end=i_end,
        text_start=i_start + k_fin, text_end=i_end + k0,
    ), nm


def batch_traceback_full(patterns, pattern_lens, texts, text_lens,
                         scoring: GotohScoring, mismatch_scores=None,
                         local: bool = False):
    """Full-matrix traceback: the pattern may align anywhere in its text
    window, with any indel drift. A banded traceback at band W = T + M over
    the text left-padded by M never-match symbols (code 8; it renders as
    ``N`` in MD if a path ever touches it) covers every monotone path of
    the M x T matrix; text coordinates are shifted back by M. Returns
    ``(TracebackResult, nm)`` with ops END->START."""
    B, M = patterns.shape
    pad = M
    W = texts.shape[1] + pad
    texts_p = torch.cat([torch.full((B, pad), 8, dtype=torch.int32,
                                    device=texts.device),
                         texts.to(torch.int32)], dim=1)
    tlens_p = text_lens.to(torch.int32) + pad
    score, k0, ops, n_ops, k_fin, nm, i_end, i_start = banded_traceback_wide(
        patterns, pattern_lens, texts_p, tlens_p, scoring, W,
        mismatch_scores, local)
    return TracebackResult(
        score=score, ops=ops, n_ops=n_ops,
        pattern_start=i_start, pattern_end=i_end,
        text_start=i_start + k_fin - pad, text_end=i_end + k0 - pad,
    ), nm


def _banded_forward_dirs(patterns, pattern_lens, texts, text_lens, aligner,
                         band: int, mismatch_scores=None):
    """The banded DP of ``align.batch.batch_score_banded`` recording a
    direction byte a cell: returns (dirs (B, M, W) uint8, final_row (B, W),
    best (B,), sink (B, 2) = (row, band cell) of LOCAL's best). As the JAX
    function (``traceback.py:54-160``), it takes no substitution matrix."""
    B, M = patterns.shape
    W = band
    dev = patterns.device
    atype = AlignmentType(aligner.type)
    local = atype == AlignmentType.LOCAL
    hamming = isinstance(aligner, HammingAligner)
    po, pe, to, te = _gap_params(aligner)
    match, mm_scalar = aligner.scoring.match, aligner.scoring.mismatch
    neg = NEG_INF

    pats = patterns.to(torch.int32)
    TW = M + W - 1
    texts = texts.to(torch.int32)
    if texts.shape[1] < TW:
        texts = torch.nn.functional.pad(texts, (0, TW - texts.shape[1]))
    plen = pattern_lens.to(torch.int32)
    tlen = text_lens.to(torch.int32)
    mm = None if mismatch_scores is None else mismatch_scores.to(torch.int32)
    kcol = torch.arange(W, dtype=torch.int32, device=dev)[None, :]

    if atype == AlignmentType.GLOBAL:
        H = torch.where(kcol == 0, 0, to + te * (kcol - 1)).to(
            torch.int32).expand(B, W)
    else:
        H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    E = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), neg, dtype=torch.int32, device=dev)
    best = torch.full((B,), neg, dtype=torch.int32, device=dev)
    sink = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    final = torch.full((B, W), neg, dtype=torch.int32, device=dev)
    dirs = torch.empty((B, M, W), dtype=torch.uint8, device=dev)

    for i in range(1, M + 1):
        p = pats[:, i - 1:i]
        trow = texts[:, i - 1:i - 1 + W]
        mmv = mm_scalar if mm is None else mm[:, i - 1:i]
        tidx = (i - 1) + kcol
        in_text = tidx < tlen[:, None]
        sub = torch.where(in_text, _subst_scores(p, trow, match, mmv), neg)
        diag = H + sub
        if hamming:
            Erow = torch.full((B, W), neg, dtype=torch.int32, device=dev)
            Hrow = diag.clamp(min=0) if local else diag
            ext = 0
        else:
            Ep = torch.cat([E[:, 1:], neg_col], dim=1) + pe
            Hp = torch.cat([H[:, 1:], neg_col], dim=1) + po
            Erow = torch.maximum(Ep, Hp)
            H0 = torch.maximum(diag, Erow)
            if local:
                H0 = H0.clamp(min=0)
            F = (_exclusive_running_max(H0 + (to - te * kcol))
                 + te * (kcol - 1))
            f_ext = F == torch.cat([neg_col, F[:, :-1]], dim=1) + te
            Hrow = torch.maximum(H0, F)
            ext = ((Ep >= Hp).to(torch.int32) << 2) | \
                (f_ext.to(torch.int32) << 3)
        hdir = torch.where(Hrow == diag, 0, torch.where(Hrow == Erow, 1, 2))
        if local:
            hdir = torch.where(Hrow == 0, 3, hdir)
        dirs[:, i - 1] = (hdir | ext).to(torch.uint8)
        final = torch.where((plen == i)[:, None], Hrow, final)
        if local:
            masked = torch.where((i <= plen)[:, None] & in_text, Hrow, neg)
            row_best = masked.max(dim=1).values
            row_arg = torch.argmax(masked, dim=1).to(torch.int32)
            upd = row_best > best
            best = torch.where(upd, row_best, best)
            sink = torch.where(
                upd[:, None],
                torch.stack([torch.full_like(row_arg, i), row_arg], dim=1),
                sink)
        H, E = Hrow, Erow
    return dirs, final, best, sink


_ST_H, _ST_E, _ST_F = 0, 1, 2


def batch_traceback_banded(patterns, pattern_lens, texts, text_lens, aligner,
                           band: int, mismatch_scores=None) -> TracebackResult:
    """Score + traceback of a banded alignment (the semantics of
    ``align.batch.batch_score_banded``, every aligner and type): ops in
    forward order, plain op codes (B, M + W) int32. Port of the JAX
    function (``traceback.py:163-281``): the walk starts at GLOBAL's last
    band cell, SEMI_GLOBAL's first max or LOCAL's best cell and takes
    exactly M + W steps; a GLOBAL walk on row 0 emits the leading text gap
    as D; LOCAL stops at a zero cell only in the H state. A cell index
    past the direction plane reads 255, one before it wraps, as the JAX
    gather does."""
    B, M = patterns.shape
    W = band
    dev = patterns.device
    atype = AlignmentType(aligner.type)
    local = atype == AlignmentType.LOCAL
    glob = atype == AlignmentType.GLOBAL
    plen = pattern_lens.to(torch.int32)

    dirs, final, best, sink = _banded_forward_dirs(
        patterns, plen, texts, text_lens, aligner, band, mismatch_scores)
    dirs = dirs.reshape(B, M * W)
    if local:
        score, i0, k0 = best, sink[:, 0], sink[:, 1]
    elif glob:
        score, i0 = final[:, W - 1], plen
        k0 = torch.full((B,), W - 1, dtype=torch.int32, device=dev)
    else:
        score, i0 = final.max(dim=1).values, plen
        k0 = torch.argmax(final, dim=1).to(torch.int32)

    MAXS = M + W
    i, k = i0, k0
    st = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    ops_rev = torch.empty((B, MAXS), dtype=torch.int32, device=dev)
    for step in range(MAXS):
        cell = _take_jax(dirs, (i - 1).clamp(0, M - 1) * W + k,
                         255).to(torch.int32)
        hdir = cell & 3
        e_ext = (cell >> 2) & 1
        f_ext = (cell >> 3) & 1
        at_edge = (i == 0) & (k > 0) if glob else torch.zeros_like(done)
        stop = (i == 0) | (local & (hdir == 3) & (st == _ST_H))
        stop = done | (~at_edge & stop)
        # the move: a GLOBAL leading text gap is a D
        sel = torch.where(at_edge, 2, torch.where(
            st == _ST_E, 1, torch.where(st == _ST_F, 2, hdir)))
        ops_rev[:, step] = torch.where(stop, OP_NONE, torch.where(
            sel == 0, OP_M, torch.where(sel == 1, OP_I, OP_D)))
        di = torch.where(sel <= 1, -1, 0)
        dk = torch.where(sel == 0, 0, torch.where(sel == 1, 1, -1))
        new_st = torch.where(sel == 0, _ST_H, torch.where(
            sel == 1, torch.where(e_ext == 1, _ST_E, _ST_H),
            torch.where(f_ext == 1, _ST_F, _ST_H)))
        new_st = torch.where(at_edge, _ST_H, new_st)
        i = torch.where(stop, i, i + di).to(torch.int32)
        k = torch.where(stop, k, k + dk).to(torch.int32)
        st = torch.where(stop, st, new_st).to(torch.int32)
        done = done | stop

    # END->START -> forward order, left-aligned
    n_ops = (ops_rev != OP_NONE).sum(dim=1, dtype=torch.int32)
    idx = n_ops[:, None] - 1 - torch.arange(MAXS, dtype=torch.int32,
                                            device=dev)[None, :]
    ops = torch.where(idx >= 0, torch.gather(
        ops_rev, 1, idx.clamp(0, MAXS - 1).to(torch.int64)), OP_NONE)
    return TracebackResult(score=score, ops=ops, n_ops=n_ops,
                           pattern_start=i, pattern_end=i0,
                           text_start=i + k, text_end=i0 + k0)


def batch_traceback_full_scan(patterns, pattern_lens, texts, text_lens,
                              aligner,
                              mismatch_scores=None) -> TracebackResult:
    """Full-matrix traceback of the scan route: ``batch_traceback_banded``
    at band T + M over the text left-padded by M never-match symbols (8),
    text coordinates shifted back by M; forward-ordered ops. Port of the
    JAX function (``traceback.py:482-498``)."""
    B, M = patterns.shape
    pad = M
    texts_p = torch.cat([torch.full((B, pad), 8, dtype=torch.int32,
                                    device=texts.device),
                         texts.to(torch.int32)], dim=1)
    tb = batch_traceback_banded(patterns, pattern_lens, texts_p,
                                text_lens.to(torch.int32) + pad, aligner,
                                texts.shape[1] + pad, mismatch_scores)
    return tb._replace(text_start=tb.text_start - pad,
                       text_end=tb.text_end - pad)


def cigar_to_string(ops: np.ndarray, n_ops: int, reverse: bool = False) -> str:
    """Run-length encode an op array into a CIGAR string (host-side).
    ``reverse=True`` consumes END->START op arrays. Accepts packed MD
    entries (op in bits 0-1) as well as plain op codes."""
    n = int(n_ops)
    if n == 0:
        return "*"
    ops = np.asarray(ops)[:n] & 3
    if reverse:
        ops = ops[::-1]
    bounds = np.nonzero(ops[1:] != ops[:-1])[0]
    chars = "?MID"
    if not len(bounds):  # single-run fast path (most reads: all-M)
        return f"{n}{chars[int(ops[0])]}"
    edges = [0, *(bounds + 1).tolist(), n]
    return "".join(
        f"{edges[i + 1] - edges[i]}{chars[int(ops[edges[i]])]}"
        for i in range(len(edges) - 1)
    )


def ops_to_chars(ops: np.ndarray, n_ops: int) -> str:
    """Expand a forward op array to an 'MID' character string."""
    return "".join("?MID"[o & 3] for o in np.asarray(ops)[:int(n_ops)])


_MD_BASES = "ACGTNNNNNNNNNNNN"  # codes >= 4 are genome-N variants


def md_from_entries(entries: np.ndarray, n_ops: int, reverse: bool = False):
    """(MD, XM, XO, XG) from packed traceback entries: the SAM MD tag and
    bowtie2's XM (mismatches) / XO (gap opens) / XG (gap extensions)."""
    n = int(n_ops)
    e = np.asarray(entries)[:n]
    if reverse:
        e = e[::-1]
    ops = e & 3
    mism = (e >> 2) & 1
    sym = (e >> 3) & 15
    is_gap = ops != OP_M
    if not is_gap.any():
        # mismatch-only fast path: runs between mismatch sites
        mm_pos = np.flatnonzero(mism)
        if not len(mm_pos):
            return str(n), 0, 0, 0
        runs = np.diff(np.concatenate([[-1], mm_pos])) - 1
        md = "".join(
            f"{r}{_MD_BASES[sym[p]]}" for r, p in zip(runs.tolist(), mm_pos)
        ) + str(n - int(mm_pos[-1]) - 1)
        return md, len(mm_pos), 0, 0
    parts = []
    run = xm = xo = xg = 0
    i = 0
    while i < n:
        op = ops[i]
        if op == OP_M:
            if mism[i]:
                parts.append(f"{run}{_MD_BASES[sym[i]]}")
                run = 0
                xm += 1
            else:
                run += 1
            i += 1
        elif op == OP_D:
            j = i
            while j < n and ops[j] == OP_D:
                j += 1
            parts.append(f"{run}^" + "".join(_MD_BASES[s] for s in sym[i:j]))
            run = 0
            xo += 1
            xg += j - i
            i = j
        else:  # insertion: MD skips read-only bases
            j = i
            while j < n and ops[j] == OP_I:
                j += 1
            xo += 1
            xg += j - i
            i = j
    parts.append(str(run))
    return "".join(parts), xm, xo, xg
