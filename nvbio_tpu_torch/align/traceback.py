"""Banded and full-matrix traceback entry points and the host CIGAR/MD
formatters.

``batch_traceback_banded_fast`` is the port of the JAX function of the same
name (``nvbio_tpu/align/traceback.py:378``): one call of the fused
traceback kernel (``align.kernels.banded_traceback``; its plain version for
CPU tensors), returning ``(TracebackResult, nm)`` with ops END->START.
``batch_traceback_full`` (``traceback.py:436``) is the same kernel at band
T+M over left-padded text, in its wide form
(``align.kernels.banded_traceback_wide``). ``cigar_to_string`` and
``md_from_entries`` are copies of the JAX package's numpy helpers.

Packed op entry layout: bits 0-1 op (1/2/3 = M/I/D), bit 2 mismatch (M
cells only), bits 3-6 the reference symbol under the cell.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nvbio_tpu_torch.align.kernels import (
    banded_traceback,
    banded_traceback_wide,
)
from nvbio_tpu_torch.align.types import GotohScoring

OP_NONE, OP_M, OP_I, OP_D = 0, 1, 2, 3


class TracebackResult(NamedTuple):
    score: torch.Tensor          # (B,) int32
    ops: torch.Tensor            # (B, MAXS) int32 packed entries, END->START
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
