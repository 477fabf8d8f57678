"""Carry the JAX package's state across to the port.

Takes numpy arrays and plain values only — never JAX or ``nvbio_tpu``
objects — so both packages can be held against each other on the same
tables: ``np.asarray`` a JAX ``QGramIndex``'s fields and packed genome
words, a JAX ``FMIndex``'s arrays, or ``dataclasses.asdict`` a JAX
``MapParams``, and pass them here. The library's host tables (sorted
dictionaries, CSR and suffix tries, De Bruijn graphs) come back as numpy
dataclasses, as the JAX package holds them; the device indexes (wavelet
tree, protein FM index, q-gram set index) as tensors on ``cuda`` unless
``device="cpu"`` is asked for.
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


def sorted_dictionary_from_arrays(keys, payload, bits: int = 2,
                                  max_len: int = 10):
    """The port's ``SortedDictionary`` (host numpy form; ``.to(device)``
    moves it) from a JAX one's ``keys``, ``payload``, ``bits`` and
    ``max_len``."""
    from nvbio_tpu_torch.trie import SortedDictionary

    return SortedDictionary(np.asarray(keys, np.int64), np.asarray(payload),
                            int(bits), int(max_len))


def csr_trie_from_arrays(children, terminal):
    """The port's ``CsrTrie`` from a JAX one's ``children``/``terminal``."""
    from nvbio_tpu_torch.trie import CsrTrie

    return CsrTrie(np.asarray(children, np.int32),
                   np.asarray(terminal, np.int32))


def suffix_trie_from_arrays(children, mask, first_child, count, depth,
                            sa_lo):
    """The port's ``SuffixTrie`` from a JAX one's six arrays."""
    from nvbio_tpu_torch.trie import SuffixTrie

    return SuffixTrie(
        children=np.asarray(children, np.int32),
        mask=np.asarray(mask, np.uint8),
        first_child=np.asarray(first_child, np.int32),
        count=np.asarray(count, np.int32), depth=np.asarray(depth, np.int32),
        sa_lo=np.asarray(sa_lo, np.int32))


def wavelet_tree_from_arrays(bits: int, n: int, levels_words, levels_cum,
                             zeros, device=None):
    """The port's ``WaveletTree`` from a JAX one's fields (uint32 words
    keep their bits as int32), on ``cuda`` unless ``device="cpu"``."""
    from nvbio_tpu_torch.wavelet import WaveletTree

    w = np.ascontiguousarray(levels_words, np.uint32).view(np.int32)
    return WaveletTree(
        int(bits), int(n), torch.from_numpy(w.copy()),
        torch.from_numpy(np.asarray(levels_cum, np.int32).copy()),
        torch.from_numpy(np.asarray(zeros, np.int32).copy()),
    ).to(resolve_device(device))


def protein_fmindex_from_arrays(bits: int, n: int, levels_words, levels_cum,
                                zeros, count, primary: int, n_symbols: int,
                                device=None):
    """The port's ``ProteinFMIndex`` from a JAX one's wavelet-tree fields,
    ``count``, ``primary``, ``n`` and ``n_symbols``, on ``cuda`` unless
    ``device="cpu"``."""
    from nvbio_tpu_torch.fmi.protein import ProteinFMIndex

    dev = resolve_device(device)
    wt = wavelet_tree_from_arrays(bits, n, levels_words, levels_cum, zeros,
                                  dev)
    return ProteinFMIndex(
        wt, torch.from_numpy(np.asarray(count, np.int64).copy()).to(dev),
        int(primary), int(n), int(n_symbols))


def qgram_set_index_from_arrays(q: int, qgrams, slots, coord_str, coord_pos,
                                qlut: int, lut, max_probe: int, device=None):
    """The port's ``QGramSetIndex`` from a JAX one's fields, on ``cuda``
    unless ``device="cpu"``."""
    from nvbio_tpu_torch.qgram import QGramSetIndex

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32).copy())

    return QGramSetIndex(
        q=int(q), qgrams=t(qgrams), slots=t(slots), coord_str=t(coord_str),
        coord_pos=t(coord_pos), qlut=int(qlut), lut=t(lut),
        max_probe=int(max_probe)).to(resolve_device(device))


def debruijn_graph_from_arrays(**fields):
    """The port's ``DebruijnGraph`` from a JAX one's fields (numpy arrays
    and the ints ``k``/``n_regions``: ``dataclasses.asdict`` of it), so
    ``k_best_haplotypes`` can be held against the JAX graph."""
    from nvbio_tpu_torch.assembly.graph import DebruijnGraph

    kw = {f.name: fields[f.name] for f in dataclasses.fields(DebruijnGraph)}
    kw = {k: (int(v) if k in ("k", "n_regions") else np.asarray(v))
          for k, v in kw.items()}
    return DebruijnGraph(**kw)
