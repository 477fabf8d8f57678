"""Alignment statistics + HTML report.

Parity with nvBowtie's AlignmentStats (mapped/unique/multiple counts, mapq &
edit-distance histograms, ``nvBowtie/bowtie2/cuda/stats.h:45-174``) and the
live HTML report emitters (``nvbio/basic/html.h``, ``stats.cpp``).

A copy of ``nvbio_tpu.utils.stats``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class AlignmentStats:
    n_reads: int = 0
    n_mapped: int = 0
    n_unique: int = 0
    n_multiple: int = 0
    n_proper_pairs: int = 0
    n_discordant: int = 0
    mapq_hist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(61, dtype=np.int64)
    )
    nm_hist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(33, dtype=np.int64)
    )
    wall_s: float = 0.0

    def update_from_result(self, res: dict, lens: np.ndarray) -> None:
        """Accumulate from an align_batch_core result dict (numpy views)."""
        real = np.asarray(lens) > 0
        mapped = np.asarray(res["mapped"]) & real
        self.n_reads += int(real.sum())
        self.n_mapped += int(mapped.sum())
        if "has_second" in res:
            second = np.asarray(res["has_second"]) & mapped
            self.n_unique += int((mapped & ~second).sum())
            self.n_multiple += int(second.sum())
        mq = np.asarray(res["mapq"])[mapped]
        np.add.at(self.mapq_hist, np.clip(mq, 0, 60), 1)
        if "nm" in res:
            nm = np.asarray(res["nm"])[mapped]
            np.add.at(self.nm_hist, np.clip(nm, 0, 32), 1)

    def merge(self, other: "AlignmentStats") -> "AlignmentStats":
        out = AlignmentStats()
        for f in ("n_reads", "n_mapped", "n_unique", "n_multiple",
                  "n_proper_pairs", "n_discordant"):
            setattr(out, f, getattr(self, f) + getattr(other, f))
        out.mapq_hist = self.mapq_hist + other.mapq_hist
        out.nm_hist = self.nm_hist + other.nm_hist
        out.wall_s = max(self.wall_s, other.wall_s)
        return out

    def summary(self) -> str:
        n = max(self.n_reads, 1)
        lines = [
            f"reads:    {self.n_reads:,}",
            f"mapped:   {self.n_mapped:,} ({100.0*self.n_mapped/n:.2f}%)",
            f"unique:   {self.n_unique:,} ({100.0*self.n_unique/n:.2f}%)",
            f"multiple: {self.n_multiple:,} ({100.0*self.n_multiple/n:.2f}%)",
        ]
        if self.n_proper_pairs:
            lines.append(f"proper pairs: {self.n_proper_pairs:,}")
        if self.n_discordant:
            lines.append(f"discordant pairs: {self.n_discordant:,}")
        if self.wall_s > 0:
            lines.append(f"throughput: {self.n_reads/self.wall_s:,.0f} reads/s")
        return "\n".join(lines)


def _hist_rows(hist, label):
    rows = []
    total = max(int(hist.sum()), 1)
    for i, v in enumerate(hist):
        if v:
            bar = "&#9608;" * max(1, int(40 * v / hist.max()))
            rows.append(
                f"<tr><td>{label} {i}</td><td>{int(v):,}</td>"
                f"<td>{100.0*v/total:.2f}%</td>"
                f"<td style='color:#36c'>{bar}</td></tr>"
            )
    return "\n".join(rows)


def html_report(stats: AlignmentStats, stage_stats=(), title="nvbio_tpu_torch report") -> str:
    """Self-contained HTML report (the reference's live report equivalent)."""
    n = max(stats.n_reads, 1)
    stage_rows = "\n".join(
        f"<tr><td>{s.name}</td><td>{s.time:.2f}s</td><td>{s.calls}</td>"
        f"<td>{s.avg_speed:,.0f}/s</td></tr>"
        for s in stage_stats
    )
    return f"""<!DOCTYPE html>
<html><head><title>{title}</title>
<style>
 body {{ font-family: monospace; background:#111; color:#ddd; margin:2em; }}
 table {{ border-collapse: collapse; margin: 1em 0; }}
 td, th {{ border: 1px solid #444; padding: 4px 10px; text-align: left; }}
 th {{ background:#222; }}
 h2 {{ color:#6cf; }}
</style></head><body>
<h1>{title}</h1>
<h2>Mapping</h2>
<table>
<tr><th>metric</th><th>count</th><th>%</th></tr>
<tr><td>reads</td><td>{stats.n_reads:,}</td><td>100%</td></tr>
<tr><td>mapped</td><td>{stats.n_mapped:,}</td><td>{100.0*stats.n_mapped/n:.2f}%</td></tr>
<tr><td>unique</td><td>{stats.n_unique:,}</td><td>{100.0*stats.n_unique/n:.2f}%</td></tr>
<tr><td>multiple</td><td>{stats.n_multiple:,}</td><td>{100.0*stats.n_multiple/n:.2f}%</td></tr>
<tr><td>proper pairs</td><td>{stats.n_proper_pairs:,}</td><td></td></tr>
<tr><td>discordant pairs</td><td>{stats.n_discordant:,}</td><td></td></tr>
</table>
<h2>MAPQ histogram</h2>
<table><tr><th>bin</th><th>count</th><th>%</th><th></th></tr>
{_hist_rows(stats.mapq_hist, "mapq")}
</table>
<h2>Edit-distance histogram</h2>
<table><tr><th>bin</th><th>count</th><th>%</th><th></th></tr>
{_hist_rows(stats.nm_hist, "NM")}
</table>
<h2>Stages</h2>
<table><tr><th>stage</th><th>time</th><th>calls</th><th>speed</th></tr>
{stage_rows}
</table>
<p>generated {time.strftime('%Y-%m-%d %H:%M:%S')} &middot; throughput
{stats.n_reads/max(stats.wall_s,1e-9):,.0f} reads/s</p>
</body></html>
"""
