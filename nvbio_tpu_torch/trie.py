"""Tries over small string dictionaries.

Port of ``nvbio_tpu.trie`` (the reference's ``nvbio/trie``,
``suffix_trie.h:77-295``, ``sorted_dictionary.h``). The sorted dictionary
is primary: a sorted array of packed keys, so membership and prefix range
are batched ``searchsorted`` calls, on numpy keys (host) or on key tensors
(their device). The CSR node tables (``CsrTrie``, ``SuffixTrie``) are
built on the host, as in the JAX package, and walked with dense gathers on
a device.

``CsrTrie.walk`` clamps each query symbol into the table, as JAX's gather
clamps an out-of-range index: an N code (4) walks as T (3).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def pack_keys(strings, bits: int = 2, max_len: int = 10) -> np.ndarray:
    """Pack code arrays into length-tagged int64 keys preserving lexicographic
    order: (symbols, MSB-first) then shorter-is-smaller via a length pad.

    Each slot uses bits+1 bits (symbols stored as code+1 so the 0 pad sorts
    below any symbol)."""
    sbits = bits + 1
    if sbits * max_len > 62:
        raise ValueError("max_len too large for int64 keys")
    out = np.zeros(len(strings), dtype=np.int64)
    for i, s in enumerate(strings):
        if len(s) > max_len:
            raise ValueError("key too long")
        v = 0
        for c in s:
            v = (v << sbits) | (int(c) + 1)  # +1 so 0 pads below any symbol
        v <<= sbits * (max_len - len(s))
        out[i] = v
    return out


def _walk_inputs(queries, qlens, device):
    """(queries, qlens) as int64 tensors: on the queries' device when they
    are a tensor, else on ``device`` (cuda unless the caller asks for the
    CPU)."""
    if isinstance(queries, torch.Tensor):
        dev = queries.device
    else:
        from nvbio_tpu_torch.device import resolve_device

        dev = resolve_device(device)
    return (torch.as_tensor(queries, device=dev).to(torch.int64),
            torch.as_tensor(qlens, device=dev).to(torch.int64), dev)


@dataclasses.dataclass
class SortedDictionary:
    """Sorted-dictionary trie: batched lookups via searchsorted."""

    keys: Any                 # int64[n] sorted packed keys (numpy or tensor)
    payload: Any              # int32[n] user values
    bits: int = 2
    max_len: int = 10

    @classmethod
    def build(cls, strings, payload=None, bits: int = 2, max_len: int = 10):
        keys = pack_keys(strings, bits, max_len)
        order = np.argsort(keys, kind="stable")
        pay = (np.arange(len(strings), dtype=np.int32) if payload is None
               else np.asarray(payload, dtype=np.int32))
        return cls(keys[order], pay[order], bits, max_len)

    def to(self, device) -> "SortedDictionary":
        """Keys and payload as tensors on ``device``. Keys wider than 31
        bits are refused, as the JAX package's ``.device()`` refuses them,
        so the contract does not widen."""
        if (self.bits + 1) * self.max_len > 31:
            raise ValueError(
                "keys wider than 31 bits cannot round-trip through the "
                "x64-disabled device; use a smaller max_len"
            )
        return SortedDictionary(
            torch.as_tensor(self.keys).to(device),
            torch.as_tensor(self.payload).to(device), self.bits,
            self.max_len)

    def find(self, queries):
        """Batched exact lookup of packed query keys.

        Returns (found bool[...], payload[...]): numpy on numpy keys,
        tensors on the keys' device otherwise."""
        if isinstance(self.keys, np.ndarray):
            idx = np.searchsorted(self.keys, queries)
            idx_c = np.clip(idx, 0, len(self.keys) - 1)
            hit = np.take(self.keys, idx_c) == queries
            return hit, np.where(hit, np.take(self.payload, idx_c), -1)
        q = torch.as_tensor(queries, device=self.keys.device).to(
            self.keys.dtype)
        idx_c = torch.searchsorted(self.keys, q).clamp(0, len(self.keys) - 1)
        hit = self.keys[idx_c] == q
        return hit, torch.where(hit, self.payload[idx_c], -1)

    def prefix_range(self, prefix_codes):
        """[lo, hi) of dictionary entries starting with the given prefix."""
        sbits = self.bits + 1
        plen = len(prefix_codes)
        v = 0
        for c in prefix_codes:
            v = (v << sbits) | (int(c) + 1)
        lo_key = v << (sbits * (self.max_len - plen))
        hi_key = (v + 1) << (sbits * (self.max_len - plen))
        if isinstance(self.keys, np.ndarray):
            return (int(np.searchsorted(self.keys, lo_key)),
                    int(np.searchsorted(self.keys, hi_key)))
        b = torch.tensor([lo_key, hi_key], dtype=self.keys.dtype,
                         device=self.keys.device)
        lo, hi = torch.searchsorted(self.keys, b).tolist()
        return int(lo), int(hi)


@dataclasses.dataclass
class CsrTrie:
    """Explicit trie in CSR form for node-level traversal (host build)."""

    children: np.ndarray   # int32[n_nodes, n_symbols] child ids (-1 = none)
    terminal: np.ndarray   # int32[n_nodes] payload (-1 = internal)

    @classmethod
    def build(cls, strings, payload=None, n_symbols: int = 4):
        children = [np.full(n_symbols, -1, np.int32)]
        terminal = [-1]
        for i, s in enumerate(strings):
            node = 0
            for c in s:
                nxt = children[node][c]
                if nxt < 0:
                    nxt = len(children)
                    children[node][c] = nxt
                    children.append(np.full(n_symbols, -1, np.int32))
                    terminal.append(-1)
                node = nxt
            terminal[node] = i if payload is None else int(payload[i])
        return cls(np.stack(children), np.asarray(terminal, np.int32))

    def walk(self, queries, qlens, device=None):
        """Batched walk (dense gathers): returns payloads (int64 tensor).

        Runs on the queries' device when they are a tensor, else on
        ``device`` (cuda unless the caller asks for the CPU). Symbols are
        clamped into the table, as the JAX gather clamps them."""
        q, ql, dev = _walk_inputs(queries, qlens, device)
        ch = torch.as_tensor(self.children, device=dev).to(torch.int64)
        term = torch.as_tensor(self.terminal, device=dev).to(torch.int64)
        B, L = q.shape
        node = torch.zeros((B,), dtype=torch.int64, device=dev)
        for j in range(L):
            step = ch[node.clamp(0, ch.shape[0] - 1),
                      q[:, j].clamp(0, ch.shape[1] - 1)]
            node = torch.where((j < ql) & (node >= 0), step, node)
        return torch.where(node >= 0, term[node.clamp(0, len(term) - 1)], -1)


# ---------------------------------------------------------------------------
# Suffix trie over a text, backed by the FM index (suffix_trie.h:77-295
# parity): a breadth-first frontier sweep. Every level extends all frontier
# nodes by all 4 symbols in one batched rank call (fmi.search
# .extend_backward_all over the REVERSED text's index, so right-extension of
# the node label is one backward step) on the device; node allocation is a
# host loop in symbol order, as in the JAX package.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SuffixTrie:
    """CSR suffix trie: node 0 is the root (empty string).

    ``children[u, c]`` = child node of u under symbol c (-1 none);
    ``mask``/``first_child`` carry the compressed TrieNode form
    (suffix_trie.h:76-133 m_mask/m_child). ``count[u]`` (m_size) =
    occurrences of u's label as a substring; ``sa_lo[u]`` = the label's
    first row in the reversed-text FM interval (locate hook)."""

    children: np.ndarray    # (n_nodes, 4) int32
    mask: np.ndarray        # (n_nodes,) uint8 active-children bits
    first_child: np.ndarray  # (n_nodes,) int32 (-1 = leaf)
    count: np.ndarray       # (n_nodes,) int32 subtree occurrence count
    depth: np.ndarray       # (n_nodes,) int32 label length
    sa_lo: np.ndarray       # (n_nodes,) int32 rev-FM interval start

    @classmethod
    def build(cls, text_codes: np.ndarray, max_depth: int | None = None,
              min_count: int = 1, device=None) -> "SuffixTrie":
        """Build from a 2-bit text. Nodes with a unique occurrence
        (count == 1) become leaves; ``max_depth`` bounds the label length;
        ``min_count`` prunes rare substrings. The reversed text's FM index
        and every level's expansion live on ``device`` (cuda unless the
        caller asks for the CPU)."""
        from nvbio_tpu_torch.device import resolve_device
        from nvbio_tpu_torch.fmi.index import build_fmindex
        from nvbio_tpu_torch.fmi.search import extend_backward_all

        dev = resolve_device(device)
        text = np.asarray(text_codes, np.uint8)
        n = len(text)
        if max_depth is None:
            max_depth = n
        fmi = build_fmindex(text[::-1].copy()).to(dev)

        children = [np.full(4, -1, np.int32)]
        mask = [0]
        count = [n + 1]
        depth = [0]
        sa_lo = [0]
        frontier_nodes = np.array([0], np.int64)
        lo = np.array([0], np.int64)
        hi = np.array([n + 1], np.int64)

        for d in range(1, max_depth + 1):
            if not len(frontier_nodes):
                break
            lo4_t, hi4_t = extend_backward_all(fmi, torch.from_numpy(lo).to(
                dev), torch.from_numpy(hi).to(dev))
            lo4 = lo4_t.cpu().numpy()
            sz4 = (hi4_t - lo4_t).cpu().numpy()
            # expandable = real child AND worth descending into
            live = sz4 >= max(min_count, 1)
            if not live.any():
                break
            new_lo, new_hi, new_nodes = [], [], []
            for row, u in enumerate(frontier_nodes):
                m = 0
                for c in range(4):
                    if not live[row, c]:
                        continue
                    v = len(children)
                    children[u][c] = v
                    m |= 1 << c
                    children.append(np.full(4, -1, np.int32))
                    mask.append(0)
                    count.append(int(sz4[row, c]))
                    depth.append(d)
                    sa_lo.append(int(lo4[row, c]))
                    # unique labels are leaves: the subtree is a bare path
                    if sz4[row, c] > 1 and d < max_depth:
                        new_nodes.append(v)
                        new_lo.append(int(lo4[row, c]))
                        new_hi.append(int(lo4[row, c] + sz4[row, c]))
                mask[u] = m
            frontier_nodes = np.asarray(new_nodes, np.int64)
            lo = np.asarray(new_lo, np.int64)
            hi = np.asarray(new_hi, np.int64)

        ch = np.stack(children)
        # m_child = the FIRST active child id (children are allocated in
        # symbol order, so it is the min over active slots)
        act = np.where(ch >= 0, ch, np.iinfo(np.int32).max)
        first = np.where(np.asarray(mask, np.uint8) != 0,
                         act.min(axis=1), -1).astype(np.int32)
        return cls(children=ch, mask=np.asarray(mask, np.uint8),
                   first_child=first, count=np.asarray(count, np.int32),
                   depth=np.asarray(depth, np.int32),
                   sa_lo=np.asarray(sa_lo, np.int32))

    def is_leaf(self, u: int) -> bool:
        return self.mask[u] == 0

    def nth_child(self, u: int, i: int) -> int:
        """i-th ACTIVE child (compressed-layout accessor: popcount select,
        suffix_trie.h TrieNode::nth_child)."""
        m = int(self.mask[u])
        for c in range(4):
            if m & (1 << c):
                if i == 0:
                    return int(self.children[u, c])
                i -= 1
        return -1

    def walk(self, queries, qlens, device=None):
        """Batched descent (dense gathers): the node id reached by each
        query (-1 = fell off the trie) and its count, int64 tensors on the
        queries' device, or on ``device`` for numpy queries (cuda unless
        the caller asks for the CPU)."""
        q, ql, dev = _walk_inputs(queries, qlens, device)
        ch = torch.as_tensor(self.children, device=dev).to(torch.int64)
        cnt = torch.as_tensor(self.count, device=dev).to(torch.int64)
        B, L = q.shape
        node = torch.zeros((B,), dtype=torch.int64, device=dev)
        for j in range(L):
            step = ch[node.clamp(0, ch.shape[0] - 1), q[:, j].clamp(0, 3)]
            node = torch.where((j < ql) & (node >= 0), step, node)
        ok = node >= 0
        return node, torch.where(ok, cnt[node.clamp(0, len(cnt) - 1)], 0)
