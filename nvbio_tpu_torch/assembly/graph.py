"""Batched De Bruijn assembly graphs in CSR form.

Port of ``nvbio_tpu.assembly.graph`` (the reference's
``nvMicroAssembly/assembly_graph.h:35-160``, ``assembly_graph_inl.h``:
construction via k-mer enumeration + sort, degrees, edge counts, weights
and ref flags, topological sort, cycle detection).

All sequences of a region batch are one dense (S, L) code matrix; the
k-mer values and validity masks are one int64 tensor pass on the device
(``_kmer_scan``). Node and edge discovery (sort + unique over packed
``region << 2k | kmer`` keys), the weights and the Kahn peel stay host
numpy in the JAX package's order of operations, so stable-sort ties and
float sums come out the same.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

MAX_K = 25  # 2*K + region bits must fit a uint64 sort key


def _kmer_scan(codes, lengths, quals, k: int, min_qual: int, device):
    """Rolling k-mer values + validity over a dense (S, L) code matrix, as
    one int64 tensor pass on ``device`` (k <= 25: 50 bits).

    Returns (vals uint64, valid bool) numpy arrays of shape (S, L): the
    packed 2-bit value of the k-mer starting at p; valid requires an
    in-bounds window, all codes < 4 (no N), and all base qualities >=
    min_qual (the reference's ASSEMBLY_MIN_BASE_QUALITY gate,
    ``assembly_graph.h:32``). Values are defined only where valid: the
    window wraps around the row end (as ``jnp.roll`` does) and an N's
    third bit reaches its neighbour's field, and the JAX package's
    uint32 halves truncate that bit differently."""
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device).to(
        torch.int64)
    q = torch.from_numpy(np.ascontiguousarray(quals)).to(device)
    ln = torch.from_numpy(np.asarray(lengths, np.int64)).to(device)
    S, L = c.shape
    ok = (c < 4) & (q.to(torch.int64) >= min_qual)
    vals = torch.zeros((S, L), dtype=torch.int64, device=device)
    good = torch.ones((S, L), dtype=torch.bool, device=device)
    for j in range(k):
        vals = (vals << 2) | torch.roll(c, -j, dims=1)
        good = good & torch.roll(ok, -j, dims=1)
    pos = torch.arange(L, device=device)[None, :]
    good = good & (pos + k <= ln[:, None])
    return (vals.cpu().numpy().astype(np.uint64), good.cpu().numpy())


@dataclasses.dataclass
class DebruijnGraph:
    """CSR graph over k-mer nodes of a batch of active regions.

    Mirrors ``debruijn_graph`` (``assembly_graph.h:35-100``): adjacency map +
    offsets, in/out degrees, edge counts/weights/ref-flags, per-region
    source/sink, topological order, cycle flags.
    """

    k: int
    n_regions: int
    # nodes
    node_kmers: np.ndarray       # (N,) uint64 packed k-mer value
    node_region: np.ndarray      # (N,) int32 owning region (subgraph) id
    # CSR out-adjacency
    adj: np.ndarray              # (E,) int32 destination node ids
    adj_offsets: np.ndarray      # (N+1,) int64
    edge_counts: np.ndarray      # (E,) int32 multiplicities
    edge_weights: np.ndarray     # (E,) float32 transition probabilities
    edge_ref_flags: np.ndarray   # (E,) bool — edge present in ref haplotype
    in_degrees: np.ndarray       # (N,) int32
    out_degrees: np.ndarray      # (N,) int32
    # per-region entry points (first/last ref-haplotype k-mer)
    source_ids: np.ndarray       # (R,) int64, -1 if region had no ref kmers
    sink_ids: np.ndarray         # (R,) int64
    # topological structure
    topo_order: np.ndarray       # (N,) int64 node ids, level-ordered per region
    topo_level: np.ndarray       # (N,) int32 Kahn level of each node (-1 in cycle)
    cycle_flags: np.ndarray      # (R,) bool — subgraph contains a cycle

    @property
    def n_nodes(self) -> int:
        return len(self.node_kmers)

    @property
    def n_edges(self) -> int:
        return len(self.adj)

    def kmer_string(self, node: int) -> str:
        from nvbio_tpu_torch.alphabet import codes_to_string

        return codes_to_string(self.node_codes(node))

    def node_codes(self, node: int) -> np.ndarray:
        v = int(self.node_kmers[node])
        return np.array([(v >> (2 * (self.k - 1 - j))) & 3
                         for j in range(self.k)], np.uint8)

    def out_edges(self, node: int):
        s, e = self.adj_offsets[node], self.adj_offsets[node + 1]
        return slice(int(s), int(e))

    def to_dot(self, region: int | None = None) -> str:
        """Graphviz dump (reference ``print_dot_graph``)."""
        lines = ["digraph debruijn {"]
        for u in range(self.n_nodes):
            if region is not None and self.node_region[u] != region:
                continue
            sl = self.out_edges(u)
            for v, c, rf in zip(self.adj[sl], self.edge_counts[sl],
                                self.edge_ref_flags[sl]):
                style = ' color="red"' if rf else ""
                lines.append(
                    f'  "{self.kmer_string(u)}" -> "{self.kmer_string(int(v))}"'
                    f' [label="{int(c)}"{style}];')
        lines.append("}")
        return "\n".join(lines)


def _kahn_levels(n_nodes, adj, adj_offsets, in_degrees, node_region, n_regions):
    """Batched Kahn peel: levels, level-major order, per-region cycle flags."""
    indeg = in_degrees.astype(np.int64).copy()
    level = np.full(n_nodes, -1, np.int32)
    frontier = np.flatnonzero(indeg == 0)
    lvl = 0
    order = []
    while len(frontier):
        level[frontier] = lvl
        order.append(frontier)
        nxt = []
        for u in frontier:
            dsts = adj[adj_offsets[u]:adj_offsets[u + 1]]
            for v in dsts:
                indeg[v] -= 1
                if indeg[v] == 0:
                    nxt.append(v)
        frontier = np.asarray(sorted(nxt), np.int64)
        lvl += 1
    cycle_flags = np.zeros(n_regions, bool)
    leftover = level < 0
    if leftover.any():
        np.logical_or.at(cycle_flags, node_region[leftover], True)
    topo = (np.concatenate(order) if order else np.zeros(0, np.int64))
    return topo.astype(np.int64), level, cycle_flags


def build_debruijn_graph(codes, lengths, region_ids, is_ref, quals=None, *,
                         k: int, min_qual: int = 6, min_count: int = 1,
                         device=None) -> DebruijnGraph:
    """Build the batched graph from dense region sequences.

    Args:
      codes: (S, L) uint8 2-bit codes (>=4 marks N/invalid).
      lengths: (S,) per-sequence lengths.
      region_ids: (S,) region (subgraph) id per sequence.
      is_ref: (S,) bool — sequence is the region's reference haplotype.
      k: k-mer size (<= MAX_K).
      quals: (S, L) base qualities; ref haplotypes are exempt from the gate.
      min_count: prune non-ref edges with multiplicity < min_count.
      device: where the k-mer scan runs (cuda unless the caller asks for
        the CPU).
    """
    from nvbio_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    codes = np.ascontiguousarray(codes, np.uint8)
    S, L = codes.shape
    if not 0 < k <= MAX_K:
        raise ValueError(f"k must be in (0, {MAX_K}]")
    n_regions = int(region_ids.max()) + 1 if S else 0
    if n_regions > (1 << (63 - 2 * k)):
        raise ValueError("too many regions for this k (key overflow)")
    if quals is None:
        quals = np.full((S, L), 0xFF, np.uint8)
    else:
        quals = np.where(np.asarray(is_ref)[:, None], np.uint8(0xFF),
                         np.asarray(quals, np.uint8))

    vals, valid = _kmer_scan(codes, lengths, quals, k, min_qual, dev)

    # composite sort keys: region << 2k | kmer (reference builds per-region
    # coordinate sets the same way, kmers_inl.h)
    keys = (region_ids.astype(np.uint64)[:, None] << np.uint64(2 * k)) | vals

    flat_keys = keys[valid]
    node_keys = np.unique(flat_keys)
    node_kmers = node_keys & np.uint64((1 << (2 * k)) - 1)
    node_region = (node_keys >> np.uint64(2 * k)).astype(np.int32)
    n_nodes = len(node_keys)

    # edges: consecutive valid k-mers within each sequence
    src_valid = valid[:, :-1] & valid[:, 1:] if L > 1 else valid[:, :0]
    e_from = keys[:, :-1][src_valid]
    e_to = keys[:, 1:][src_valid]
    e_ref = np.broadcast_to(np.asarray(is_ref, bool)[:, None],
                            src_valid.shape)[src_valid]
    from_ids = np.searchsorted(node_keys, e_from)
    to_ids = np.searchsorted(node_keys, e_to)

    # unique (from, to) with multiplicities and ref flags
    ekey = from_ids.astype(np.int64) * n_nodes + to_ids if n_nodes else \
        np.zeros(0, np.int64)
    order = np.argsort(ekey, kind="stable")
    ekey_s = ekey[order]
    uniq_mask = np.ones(len(ekey_s), bool)
    if len(ekey_s):
        uniq_mask[1:] = ekey_s[1:] != ekey_s[:-1]
    starts = np.flatnonzero(uniq_mask)
    bounds = np.append(starts, len(ekey_s))
    counts = np.diff(bounds).astype(np.int32)
    first = order[starts]
    edge_from = from_ids[first].astype(np.int64)
    edge_to = to_ids[first].astype(np.int64)
    ref_sorted = e_ref[order]
    ref_any = np.logical_or.reduceat(ref_sorted, starts) if len(starts) else \
        np.zeros(0, bool)

    keep = ref_any | (counts >= min_count)
    edge_from, edge_to = edge_from[keep], edge_to[keep]
    counts, ref_any = counts[keep], ref_any[keep]

    # CSR by source (edge_from already sorted since ekey sorts by from first)
    adj_offsets = np.zeros(n_nodes + 1, np.int64)
    np.add.at(adj_offsets, edge_from + 1, 1)
    adj_offsets = np.cumsum(adj_offsets)
    out_degrees = np.diff(adj_offsets).astype(np.int32)
    in_degrees = np.zeros(n_nodes, np.int32)
    np.add.at(in_degrees, edge_to, 1)

    # transition probabilities (compute_edge_weights, assembly_graph_inl.h:480)
    out_total = np.zeros(n_nodes, np.int64)
    np.add.at(out_total, edge_from, counts.astype(np.int64))
    weights = counts / np.maximum(out_total[edge_from], 1)

    # region sources/sinks = first/last valid ref-haplotype k-mer
    source_ids = np.full(n_regions, -1, np.int64)
    sink_ids = np.full(n_regions, -1, np.int64)
    for s in np.flatnonzero(np.asarray(is_ref, bool)):
        vpos = np.flatnonzero(valid[s])
        if not len(vpos):
            continue
        r = int(region_ids[s])
        source_ids[r] = np.searchsorted(node_keys, keys[s, vpos[0]])
        sink_ids[r] = np.searchsorted(node_keys, keys[s, vpos[-1]])

    topo, level, cycles = _kahn_levels(
        n_nodes, edge_to, adj_offsets, in_degrees, node_region, n_regions)

    return DebruijnGraph(
        k=k, n_regions=n_regions,
        node_kmers=node_kmers, node_region=node_region,
        adj=edge_to.astype(np.int32), adj_offsets=adj_offsets,
        edge_counts=counts, edge_weights=weights.astype(np.float32),
        edge_ref_flags=ref_any,
        in_degrees=in_degrees, out_degrees=out_degrees,
        source_ids=source_ids, sink_ids=sink_ids,
        topo_order=topo, topo_level=level, cycle_flags=cycles,
    )
