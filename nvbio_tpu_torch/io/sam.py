"""SAM alignment output (+ a minimal reader for diff tooling).

Counterpart of the reference's OutputFile/SamOutput
(``io/output/output_sam.h:43-125``): header with @SQ per contig, standard
11-column records with AS/XS/NM/MD/XM/XO/XG/YT tags and typed aux values.
Copy of ``nvbio_tpu.io.sam``; the binary sibling (BAM over the BGZF codec)
lives in io/bam.py / io/bgzf.py. Per-writer IOStats mirror
``output_stats.h``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST_IN_PAIR = 0x40
FLAG_SECOND_IN_PAIR = 0x80
FLAG_SECONDARY = 0x100


@dataclasses.dataclass(frozen=True)
class TypedTag:
    """Aux tag value whose SAM type code can't be inferred from the Python
    type: 'A' (single char), 'H' (hex string), 'B' (numeric array).
    Preserves the code through SAM<->BAM round-trips (the reference keeps
    raw typed aux blobs, ``io/output/output_databuffer.h``)."""

    code: str      # 'A', 'H', or 'B'
    value: object  # A/H: str; B: (subtype_char, tuple_of_numbers)

    def sam_str(self) -> str:
        if self.code == "B":
            sub, vals = self.value
            return ",".join([sub] + [str(v) for v in vals])
        return str(self.value)


def parse_tag_value(typ: str, v: str):
    """SAM text aux value -> typed Python value (round-trip-safe)."""
    if typ == "i":
        return int(v)
    if typ == "f":
        return float(v)
    if typ in ("A", "H"):
        return TypedTag(typ, v)
    if typ == "B":
        parts = v.split(",")
        sub = parts[0]
        conv = float if sub == "f" else int
        return TypedTag("B", (sub, tuple(conv(x) for x in parts[1:])))
    return v  # Z


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int          # 1-based leftmost mapping position (0 if unmapped)
    mapq: int
    cigar: str
    seq: str
    qual: str
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    tags: dict | None = None

    def line(self) -> str:
        cols = [
            self.qname, str(self.flag), self.rname, str(self.pos),
            str(self.mapq), self.cigar, self.rnext, str(self.pnext),
            str(self.tlen), self.seq, self.qual,
        ]
        if self.tags:
            for k, v in self.tags.items():
                if isinstance(v, TypedTag):
                    cols.append(f"{k}:{v.code}:{v.sam_str()}")
                elif isinstance(v, (int, np.integer)):
                    cols.append(f"{k}:i:{v}")
                elif isinstance(v, (float, np.floating)):
                    # .9g round-trips float32 exactly (htslib's %g loses
                    # the low digits); still valid SAM
                    cols.append(f"{k}:f:{v:.9g}")
                else:
                    cols.append(f"{k}:Z:{v}")
        return "\t".join(cols)


class SamWriter:
    def __init__(self, path_or_file, ref_names, ref_lengths, program="nvbio_tpu_torch",
                 sort_order="unsorted"):
        self._own = isinstance(path_or_file, str)
        self.f = open(path_or_file, "w") if self._own else path_or_file
        self.f.write(f"@HD\tVN:1.6\tSO:{sort_order}\n")
        for name, length in zip(ref_names, ref_lengths):
            self.f.write(f"@SQ\tSN:{name}\tLN:{int(length)}\n")
        self.f.write(f"@PG\tID:{program}\tPN:{program}\n")
        self.n_records = 0
        self.n_bytes = 0
        self.n_unmapped = 0

    def write(self, rec: SamRecord) -> None:
        line = rec.line() + "\n"
        self.f.write(line)
        self.n_records += 1
        self.n_bytes += len(line)
        if rec.flag & 0x4:
            self.n_unmapped += 1

    @property
    def io_stats(self) -> dict:
        """Writer-side IOStats (``io/output/output_stats.h`` surface)."""
        return dict(records=self.n_records, bytes=self.n_bytes,
                    unmapped=self.n_unmapped)

    def close(self) -> None:
        if self._own:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def quals_to_string(quals: np.ndarray, length: int) -> str:
    q = np.asarray(quals[:length], dtype=np.uint8) + 33
    return q.tobytes().decode()


def read_sam(path: str):
    """Minimal SAM reader -> (header_lines, list of column lists)."""
    header, recs = [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                header.append(line)
            else:
                recs.append(line.split("\t"))
    return header, recs
