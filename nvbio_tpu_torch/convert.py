"""Carry the JAX package's state across to the port.

Takes numpy arrays and plain values only — never JAX or ``nvbio_tpu``
objects — so both packages can be held against each other on the same
tables: ``np.asarray`` a JAX ``QGramIndex``'s fields and packed genome
words, a JAX ``FMIndex``'s arrays, or ``dataclasses.asdict`` a JAX
``MapParams``, and pass them here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nvbio_tpu_torch.align.types import GotohScoring
from nvbio_tpu_torch.bowtie.params import MapParams
from nvbio_tpu_torch.device import resolve_device
from nvbio_tpu_torch.fmi.index import FMIndex
from nvbio_tpu_torch.packed import words_to_tensor
from nvbio_tpu_torch.qgram import QGramIndex


def qgram_index_from_arrays(q: int, n: int, offsets: np.ndarray,
                            positions: np.ndarray,
                            mid_pos: np.ndarray | None = None,
                            device=None) -> QGramIndex:
    """The port's index from a JAX ``QGramIndex``'s ``q``, ``n``,
    ``offsets``, ``positions`` and ``mid_pos`` (int32, or uint32 past 2^31
    symbols; empty ``mid_pos`` buckets hold the dtype's max), on ``cuda``
    unless ``device="cpu"`` is asked for."""
    return QGramIndex.from_arrays(q, n, offsets, positions,
                                  mid_pos).to(resolve_device(device))


def fmindex_from_arrays(bwt_words, occ, count, primary: int, n: int,
                        sa_interval: int, ssa_marks, ssa_cum, ssa_vals,
                        ftab_k: int = 0, ftab_lo=None, ftab_hi=None,
                        device=None) -> FMIndex:
    """The port's FM index from a JAX ``FMIndex``'s fields (numpy arrays:
    ``np.asarray`` each), with its rank and SSA rows built and the k-mer
    table carried when ``ftab_lo``/``ftab_hi`` are given, on ``cuda``
    unless ``device="cpu"`` is asked for."""
    return FMIndex.from_arrays(
        bwt_words, occ, count, primary, n, sa_interval, ssa_marks, ssa_cum,
        ssa_vals, ftab_k, ftab_lo, ftab_hi).to(resolve_device(device))


def genome_words_from_array(words: np.ndarray, device=None) -> torch.Tensor:
    """The port's genome tensor (int32 bits) from packed uint32 words, on
    ``cuda`` unless ``device="cpu"`` is asked for."""
    return words_to_tensor(np.asarray(words, dtype=np.uint32),
                           resolve_device(device))


def map_params_from_fields(fields) -> MapParams:
    """The port's ``MapParams`` from field values: a mapping (e.g.
    ``dataclasses.asdict`` of the JAX ``MapParams``) or any object with the
    same attributes. ``scoring`` may be a mapping or an object with the six
    Gotoh fields."""
    names = [f.name for f in dataclasses.fields(MapParams)]
    get = (fields.__getitem__ if isinstance(fields, dict)
           else lambda k: getattr(fields, k))
    kw = {k: get(k) for k in names}
    sc = kw["scoring"]
    sc_names = [f.name for f in dataclasses.fields(GotohScoring)]
    kw["scoring"] = GotohScoring(**{
        k: int(sc[k] if isinstance(sc, dict) else getattr(sc, k))
        for k in sc_names})
    return MapParams(**kw)
