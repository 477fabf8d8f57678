"""VCF 4.x variant loader -> packed SNP database arrays.

A copy of ``nvbio_tpu.io.vcf``, the counterpart of the reference's ``io/vcf.{h,cpp}`` (``SNPDatabase``,
``loadVCF``): parses VCF records (plain or gzip), expands multi-allele ALT
lists, honors ``END=`` info tags, and produces dense numpy arrays — contig
ids, [start, stop) positions, packed reference/variant sequences in a shared
code buffer with a CSR-style index, and per-variant qualities — ready for
``torch.from_numpy`` device upload.
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np

from nvbio_tpu_torch.alphabet import Alphabet, string_to_codes

DNA_IUPAC = Alphabet.DNA_IUPAC


@dataclasses.dataclass
class SNPDatabase:
    """Column-oriented variant store (reference ``io/vcf.h:61-96``)."""

    contig_names: list            # unique contig names, index = contig id
    contig_ids: np.ndarray        # (N,) int32 per-variant contig id
    positions: np.ndarray         # (N, 2) int64 [start, stop) 1-based start
    seqs: np.ndarray              # shared uint8 code buffer (DNA_IUPAC codes)
    index: np.ndarray             # (N, 4) int64 ref_start, ref_len, var_start, var_len
    qualities: np.ndarray         # (N,) uint8 (capped at 255, '.' -> 0xFF)

    def __len__(self) -> int:
        return len(self.contig_ids)

    def ref_seq(self, i: int) -> np.ndarray:
        s, n = self.index[i, 0], self.index[i, 1]
        return self.seqs[s:s + n]

    def var_seq(self, i: int) -> np.ndarray:
        s, n = self.index[i, 2], self.index[i, 3]
        return self.seqs[s:s + n]


def _parse_end_tag(info: str):
    for entry in info.split(";"):
        if entry.startswith("END="):
            try:
                return int(entry[4:])
            except ValueError:
                return None
    return None


def load_vcf(path: str, db: SNPDatabase | None = None) -> SNPDatabase:
    """Parse a VCF file; appends to ``db`` if given (reference loadVCF)."""
    opener = gzip.open if path.endswith(".gz") else open
    names = list(db.contig_names) if db else []
    name_ids = {n: i for i, n in enumerate(names)}
    contig_ids, positions, quals, index = [], [], [], []
    chunks = [db.seqs] if db and len(db.seqs) else []
    offset = len(db.seqs) if db else 0

    with opener(path, "rt") as f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            cols = line.split("\t")
            if len(cols) < 8:
                raise ValueError(f"{path}:{line_no}: truncated VCF record")
            chrom, pos_s, _id, ref, alts, qual_s, _filt, info = cols[:8]
            if chrom not in name_ids:
                name_ids[chrom] = len(names)
                names.append(chrom)
            cid = name_ids[chrom]
            pos = int(pos_s)
            end = _parse_end_tag(info)
            try:
                q = min(int(float(qual_s)), 255) if qual_s != "." else 0xFF
            except ValueError:
                raise ValueError(f"{path}:{line_no}: bad QUAL {qual_s!r}")
            ref_codes = string_to_codes(ref, DNA_IUPAC)
            stop = end if end is not None else pos + len(ref)
            # one database row per ALT allele (reference vcf.cpp splits on ',')
            for alt in alts.split(","):
                if alt in (".", "<NON_REF>", "*"):
                    continue
                var_codes = string_to_codes(alt, DNA_IUPAC)
                contig_ids.append(cid)
                positions.append((pos, stop))
                quals.append(q)
                index.append((offset, len(ref_codes),
                              offset + len(ref_codes), len(var_codes)))
                chunks.append(ref_codes)
                chunks.append(var_codes)
                offset += len(ref_codes) + len(var_codes)

    if db:
        contig_ids = np.concatenate([db.contig_ids,
                                     np.asarray(contig_ids, np.int32)])
        positions = (np.concatenate([db.positions,
                                     np.asarray(positions, np.int64).reshape(-1, 2)])
                     if positions else db.positions)
        index = (np.concatenate([db.index,
                                 np.asarray(index, np.int64).reshape(-1, 4)])
                 if index else db.index)
        quals = np.concatenate([db.qualities, np.asarray(quals, np.uint8)])
    else:
        contig_ids = np.asarray(contig_ids, np.int32)
        positions = np.asarray(positions, np.int64).reshape(-1, 2)
        index = np.asarray(index, np.int64).reshape(-1, 4)
        quals = np.asarray(quals, np.uint8)
    seqs = (np.concatenate(chunks).astype(np.uint8)
            if chunks else np.zeros(0, np.uint8))
    return SNPDatabase(names, contig_ids, positions, seqs, index, quals)
