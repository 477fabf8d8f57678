"""`nvbio_tpu_torch assemble` — local de-novo micro-assembly (nvMicroAssembly).

    python -m nvbio_tpu_torch assemble ref.fa alns.bam|sam [--regions N]
        [--start POS] [--dot | --support] [--device cpu]

Port of ``nvbio_tpu/apps/assemble_app.py``, the reference's assembly app
(``nvMicroAssembly/haplotype_caller.cu:95-118``): tiles active regions over
a contig, builds the batched De Bruijn graph from overlapping reads + the
reference haplotype, reports nodes/edges/cycles, and emits the k best
haplotypes per region as FASTA (or a dot graph with --dot), the bytes the
JAX command writes. The
k-mer scan runs on the CUDA card unless ``--device cpu`` is given (it
raises where there is no card); the rest is host numpy, as there.
"""

from __future__ import annotations

import sys
import time


def add_parser(sub):
    p = sub.add_parser("assemble",
                       help="active-region De Bruijn assembly -> haplotypes")
    p.add_argument("reference", help="reference FASTA")
    p.add_argument("alignments", help="position-sorted SAM/BAM")
    p.add_argument("-o", "--output", default="-",
                   help="haplotype FASTA output (default stdout)")
    p.add_argument("--regions", type=int, default=4, help="number of regions")
    p.add_argument("--region-size", type=int, default=200)
    p.add_argument("--start", type=int, default=1,
                   help="1-based start position of the first region")
    p.add_argument("--contig", type=int, default=0)
    p.add_argument("-k", "--kmer", type=int, default=15)
    p.add_argument("--k-best", type=int, default=8)
    p.add_argument("--min-qual", type=int, default=6)
    p.add_argument("--min-count", type=int, default=1,
                   help="prune non-ref edges below this multiplicity")
    p.add_argument("--dot", action="store_true",
                   help="emit graphviz dot instead of haplotypes")
    p.add_argument("--support", action="store_true",
                   help="count per-haplotype read support (trie-dictionary "
                        "k-mer votes) and tag each FASTA record with it")
    p.add_argument("--support-k", type=int, default=10,
                   help="k-mer length for support voting (<=20)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=run)
    return p


def run(args):
    from nvbio_tpu_torch.assembly import (build_debruijn_graph,
                                          k_best_haplotypes,
                                          load_active_regions)
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.console import log_info, log_stats

    dev = resolve_device(args.device)
    t0 = time.time()
    ref = Reference.from_fasta(args.reference)
    regions, codes, lengths, region_ids, is_ref, quals = load_active_regions(
        args.alignments, ref, args.regions, args.region_size,
        start_pos=args.start - 1, contig=args.contig)
    if not regions:
        raise SystemExit("no active regions (empty contig range?)")
    log_info(f"{len(regions)} regions, {len(codes)} sequences loaded "
             f"in {time.time()-t0:.1f}s")

    t0 = time.time()
    graph = build_debruijn_graph(codes, lengths, region_ids, is_ref,
                                 k=args.kmer, quals=quals,
                                 min_qual=args.min_qual,
                                 min_count=args.min_count, device=dev)
    log_stats(f"graph: {graph.n_nodes} nodes, {graph.n_edges} edges, "
              f"{int(graph.cycle_flags.sum())}/{graph.n_regions} cyclic "
              f"({time.time()-t0:.2f}s)")

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        if args.dot:
            out.write(graph.to_dot())
            out.write("\n")
            return 0
        haps = k_best_haplotypes(graph, args.k_best)
        supp = None
        if args.support:
            from nvbio_tpu_torch.assembly import haplotype_support

            t0 = time.time()
            supp = haplotype_support(haps, codes, lengths, region_ids,
                                     is_ref, k=args.support_k)
            n_assigned = sum(int((s.best_hap >= 0).sum())
                             for s in supp if s is not None)
            log_stats(f"read support voted in {time.time()-t0:.2f}s "
                      f"({n_assigned} reads assigned)")
        n_h = 0
        for r, region in enumerate(regions):
            for j, h in enumerate(haps[r]):
                tag = ""
                if supp is not None and supp[r] is not None \
                        and j < len(supp[r].support):
                    tag = (f" support={int(supp[r].support[j])}"
                           f"/{supp[r].n_reads}")
                out.write(f">region{r}_{region.start+1}-{region.stop}"
                          f"_hap{j} score={h.score:.3f} "
                          f"nodes={h.n_nodes}{tag}\n")
                out.write(str(h) + "\n")
                n_h += 1
        log_stats(f"{n_h} haplotypes emitted")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0
