"""K-best haplotype path enumeration over assembly graphs.

Port of ``nvbio_tpu.assembly.paths``, host numpy as there (the reference's
``find_k_best_paths`` ``nvMicroAssembly/assembly_graph_inl.h:100-160,
596-608``): for each acyclic region subgraph, find the k highest-weight
source->sink paths, where a path's score is the sum of log transition
probabilities (product of edge weights), and decode them back into haplotype
sequences.

The DP runs over the Kahn topological order: each node keeps its top-k
(score, predecessor, predecessor-slot) triples; the sink's slots backtrack
into complete paths. ``log_w`` is the float32 ``np.log`` of the float32
weights, added to float64 scores, exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nvbio_tpu_torch.assembly.graph import DebruijnGraph

NEG_INF = -np.inf


@dataclasses.dataclass
class Haplotype:
    region: int
    score: float          # sum of log edge weights
    codes: np.ndarray     # assembled sequence (2-bit codes)
    n_nodes: int

    def __str__(self) -> str:
        from nvbio_tpu_torch.alphabet import codes_to_string

        return codes_to_string(self.codes)


def k_best_haplotypes(graph: DebruijnGraph, k_best: int = 8,
                      max_path_nodes: int = 10_000):
    """Top-k haplotypes per region: list of lists (cyclic regions -> [])."""
    results = [[] for _ in range(graph.n_regions)]
    if graph.n_nodes == 0:
        return results

    N = graph.n_nodes
    scores = np.full((N, k_best), NEG_INF, np.float64)
    prev_node = np.full((N, k_best), -1, np.int64)
    prev_slot = np.full((N, k_best), -1, np.int64)

    for r in range(graph.n_regions):
        if graph.cycle_flags[r] or graph.source_ids[r] < 0:
            continue
        scores[graph.source_ids[r], 0] = 0.0

    log_w = np.log(np.maximum(graph.edge_weights, 1e-30))

    # relax edges in topological order (levels guarantee sources first)
    for u in graph.topo_order:
        u = int(u)
        if scores[u, 0] == NEG_INF:
            continue
        sl = graph.out_edges(u)
        dsts = graph.adj[sl]
        ws = log_w[sl]
        for v, w in zip(dsts, ws):
            v = int(v)
            # merge u's top-k extended by w into v's top-k
            cand_scores = np.concatenate([scores[v], scores[u] + w])
            cand_pn = np.concatenate([prev_node[v],
                                      np.full(k_best, u, np.int64)])
            cand_ps = np.concatenate([prev_slot[v],
                                      np.arange(k_best, dtype=np.int64)])
            top = np.argsort(-cand_scores, kind="stable")[:k_best]
            scores[v] = cand_scores[top]
            prev_node[v] = np.where(scores[v] > NEG_INF, cand_pn[top], -1)
            prev_slot[v] = np.where(scores[v] > NEG_INF, cand_ps[top], -1)

    for r in range(graph.n_regions):
        if graph.cycle_flags[r]:
            continue
        sink = int(graph.sink_ids[r])
        src = int(graph.source_ids[r])
        if sink < 0 or src < 0:
            continue
        if sink == src:
            if scores[src, 0] > NEG_INF:
                results[r].append(Haplotype(
                    r, 0.0, graph.node_codes(src), 1))
            continue
        for slot in range(k_best):
            if scores[sink, slot] == NEG_INF:
                break
            # backtrack node chain
            chain = [sink]
            u, s = sink, slot
            ok = True
            while u != src:
                pu, ps = int(prev_node[u, s]), int(prev_slot[u, s])
                if pu < 0 or len(chain) > max_path_nodes:
                    ok = False
                    break
                chain.append(pu)
                u, s = pu, ps
            if not ok:
                continue
            chain.reverse()
            # de Bruijn decode: full first k-mer, then 1 symbol per node
            codes = [graph.node_codes(chain[0])]
            last2 = np.uint64(3)
            for v in chain[1:]:
                codes.append(
                    np.array([int(graph.node_kmers[v] & last2)], np.uint8))
            results[r].append(Haplotype(
                r, float(scores[sink, slot]),
                np.concatenate(codes), len(chain)))
    return results
