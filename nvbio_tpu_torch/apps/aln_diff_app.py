"""`nvbio_tpu_torch aln-diff` — compare two SAM alignment files.

Equivalent of nvbio-aln-diff (``nvbio-aln-diff/nvbio-aln-diff.cpp:51-321``):
pairs records by read name, reports position/strand/CIGAR/mapq/score
agreement and histograms of the differences.

Port of ``nvbio_tpu/apps/aln_diff_app.py`` (host only), over the port's
``io.output.read_alignments``: the same text, ``--json`` and ``--html``
output.
"""

from __future__ import annotations

import collections
import json


def add_parser(sub):
    p = sub.add_parser("aln-diff", help="compare two SAM/BAM files")
    p.add_argument("sam_l", help="left SAM/BAM")
    p.add_argument("sam_r", help="right SAM/BAM")
    p.add_argument("--pos-tolerance", type=int, default=0)
    p.add_argument("--json", action="store_true", help="emit machine-readable JSON")
    p.add_argument("--html", help="write an HTML comparison report")
    p.set_defaults(func=run)
    return p


def _index_sam(path):
    from nvbio_tpu_torch.io.output import read_alignments

    _, recs = read_alignments(path)
    out = {}
    for r in recs:
        flag = int(r[1])
        if flag & 0x100 or flag & 0x800:
            continue  # primary only
        mate = 2 if flag & 0x80 else 1
        out[(r[0], mate)] = r
    return out


def diff_stats(sam_l: str, sam_r: str, pos_tolerance: int = 0) -> dict:
    L = _index_sam(sam_l)
    R = _index_sam(sam_r)
    keys = set(L) & set(R)
    stats = dict(
        n_left=len(L), n_right=len(R), n_common=len(keys),
        both_mapped=0, both_unmapped=0, only_left=0, only_right=0,
        same_pos=0, same_strand=0, same_cigar=0, same_mapq=0,
    )
    mapq_hist = collections.Counter()
    pos_diff_hist = collections.Counter()
    for k in keys:
        l, r = L[k], R[k]
        lm = not int(l[1]) & 0x4
        rm = not int(r[1]) & 0x4
        if lm and rm:
            stats["both_mapped"] += 1
            same_chr = l[2] == r[2]
            dpos = abs(int(l[3]) - int(r[3])) if same_chr else 1 << 30
            if same_chr and dpos <= pos_tolerance:
                stats["same_pos"] += 1
            pos_diff_hist[min(dpos, 10)] += 1
            if (int(l[1]) & 0x10) == (int(r[1]) & 0x10):
                stats["same_strand"] += 1
            if l[5] == r[5]:
                stats["same_cigar"] += 1
            if l[4] == r[4]:
                stats["same_mapq"] += 1
            mapq_hist[int(l[4]) - int(r[4])] += 1
        elif lm:
            stats["only_left"] += 1
        elif rm:
            stats["only_right"] += 1
        else:
            stats["both_unmapped"] += 1
    stats["mapq_diff_hist"] = dict(sorted(mapq_hist.items()))
    stats["pos_diff_hist"] = {str(k): v for k, v in sorted(pos_diff_hist.items())}
    return stats


def _html_report(stats, left, right) -> str:
    """Self-contained HTML diff report (reference aln-diff HTML output)."""
    bm = max(stats["both_mapped"], 1)
    rows = "".join(
        f"<tr><td>{k.replace('_', ' ')}</td><td>{stats[k]}</td>"
        f"<td>{100.0 * stats[k] / bm:.2f}%</td></tr>"
        for k in ("same_pos", "same_strand", "same_cigar", "same_mapq"))
    hist = "".join(
        f"<tr><td>{k}</td><td>{v}</td></tr>"
        for k, v in stats["pos_diff_hist"].items())
    return f"""<!DOCTYPE html><html><head><title>aln-diff</title><style>
body{{font-family:sans-serif;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 10px;text-align:right}}
th{{background:#eee}}</style></head><body>
<h1>alignment diff</h1>
<p>L: <code>{left}</code> ({stats['n_left']} records)<br>
R: <code>{right}</code> ({stats['n_right']} records)<br>
common: {stats['n_common']}, both mapped: {stats['both_mapped']},
L-only: {stats['only_left']}, R-only: {stats['only_right']}</p>
<table><tr><th>agreement</th><th>count</th><th>% of both-mapped</th></tr>
{rows}</table>
<h2>position-difference histogram</h2>
<table><tr><th>|dpos| (10 = &ge;10)</th><th>count</th></tr>{hist}</table>
</body></html>"""


def run(args):
    stats = diff_stats(args.sam_l, args.sam_r, args.pos_tolerance)
    if args.html:
        with open(args.html, "w") as f:
            f.write(_html_report(stats, args.sam_l, args.sam_r))
    if args.json:
        print(json.dumps(stats))
        return 0
    bm = max(stats["both_mapped"], 1)
    print(f"records:       L={stats['n_left']}  R={stats['n_right']}  "
          f"common={stats['n_common']}")
    print(f"both mapped:   {stats['both_mapped']}")
    print(f"both unmapped: {stats['both_unmapped']}")
    print(f"L-only mapped: {stats['only_left']}   R-only mapped: {stats['only_right']}")
    print(f"same position: {stats['same_pos']} ({100.0*stats['same_pos']/bm:.2f}%)")
    print(f"same strand:   {stats['same_strand']} ({100.0*stats['same_strand']/bm:.2f}%)")
    print(f"same CIGAR:    {stats['same_cigar']} ({100.0*stats['same_cigar']/bm:.2f}%)")
    print(f"same MAPQ:     {stats['same_mapq']} ({100.0*stats['same_mapq']/bm:.2f}%)")
    return 0
