"""BAM binary alignment I/O over BGZF.

Counterpart of the reference's ``io/output/output_bam.h:75-118`` (writer) and
``io/reads/bam.cpp`` / contrib bamtools (reader): full BAM1 record codec —
reg2bin, packed 4-bit sequence, binary CIGAR, typed aux tags — behind the
same record type as the SAM path, so every app can emit/ingest either format.

A copy of ``nvbio_tpu.io.bam`` (default ``program`` ``nvbio_tpu_torch``).
"""

from __future__ import annotations

import struct

import numpy as np

from nvbio_tpu_torch.io.bgzf import BgzfReader, BgzfWriter
from nvbio_tpu_torch.io.sam import SamRecord

_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CODE = {c: i for i, c in enumerate(_CIGAR_OPS)}
_SEQ_NYBBLE = "=ACMGRSVTWYHKDBN"
_SEQ_CODE = {c: i for i, c in enumerate(_SEQ_NYBBLE)}
_SEQ_CODE.update({c.lower(): i for i, c in enumerate(_SEQ_NYBBLE)})


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (SAM spec §5.3; reference output_bam.cpp)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _parse_cigar(cigar: str):
    ops = []
    if cigar == "*":
        return ops
    n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            ops.append((n, ch))
            n = 0
    return ops


def _cigar_ref_span(ops) -> int:
    return sum(n for n, op in ops if op in "MDN=X")


def _encode_seq(seq: str) -> bytes:
    if seq == "*":
        return b""
    n = len(seq)
    out = bytearray((n + 1) // 2)
    for i, ch in enumerate(seq):
        code = _SEQ_CODE.get(ch, 15)
        if i & 1:
            out[i >> 1] |= code
        else:
            out[i >> 1] = code << 4
    return bytes(out)


def _decode_seq(data: bytes, n: int) -> str:
    out = []
    for i in range(n):
        b = data[i >> 1]
        out.append(_SEQ_NYBBLE[(b >> 4) if not i & 1 else (b & 0xF)])
    return "".join(out)


def _encode_tags(tags) -> bytes:
    out = bytearray()
    if not tags:
        return bytes(out)
    from nvbio_tpu_torch.io.sam import TypedTag

    for k, v in tags.items():
        kb = k.encode()[:2]
        if isinstance(v, TypedTag):
            if v.code == "A":
                out += kb + b"A" + str(v.value).encode()[:1]
            elif v.code == "H":
                out += kb + b"H" + str(v.value).encode() + b"\x00"
            elif v.code == "B":
                sub, vals = v.value
                fmt, _ = _TAG_FMT[sub.encode()]
                out += kb + b"B" + sub.encode() + struct.pack("<I", len(vals))
                for x in vals:
                    out += struct.pack(fmt, x)
            else:
                out += kb + b"Z" + str(v.value).encode() + b"\x00"
        elif isinstance(v, (int, np.integer)):
            out += kb + b"i" + struct.pack("<i", int(v))
        elif isinstance(v, (float, np.floating)):
            out += kb + b"f" + struct.pack("<f", v)
        else:
            out += kb + b"Z" + str(v).encode() + b"\x00"
    return bytes(out)


_TAG_FMT = {
    b"c": ("<b", 1), b"C": ("<B", 1), b"s": ("<h", 2), b"S": ("<H", 2),
    b"i": ("<i", 4), b"I": ("<I", 4), b"f": ("<f", 4), b"A": ("<c", 1),
}


def _decode_tags(data: bytes) -> dict:
    from nvbio_tpu_torch.io.sam import TypedTag

    tags, i = {}, 0
    while i + 3 <= len(data):
        key = data[i:i + 2].decode()
        typ = data[i + 2:i + 3]
        i += 3
        if typ in _TAG_FMT:
            fmt, size = _TAG_FMT[typ]
            (val,) = struct.unpack(fmt, data[i:i + size])
            if typ == b"A":
                val = TypedTag("A", val.decode())
            i += size
        elif typ == b"Z":
            end = data.index(b"\x00", i)
            val = data[i:end].decode()
            i = end + 1
        elif typ == b"H":
            end = data.index(b"\x00", i)
            val = TypedTag("H", data[i:end].decode())
            i = end + 1
        elif typ == b"B":
            sub = data[i:i + 1]
            (count,) = struct.unpack("<I", data[i + 1:i + 5])
            fmt, size = _TAG_FMT[sub]
            vals = tuple(
                struct.unpack(fmt, data[i + 5 + j * size:i + 5 + (j + 1) * size])[0]
                for j in range(count))
            val = TypedTag("B", (sub.decode(), vals))
            i += 5 + count * size
        else:
            raise ValueError(f"unknown BAM tag type {typ!r}")
        tags[key] = val
    return tags


def encode_record(rec: SamRecord, ref_ids: dict) -> bytes:
    """Encode one alignment to the BAM1 wire format (sans block_size)."""
    ref_id = ref_ids.get(rec.rname, -1)
    pos = rec.pos - 1  # BAM is 0-based
    qname = rec.qname.encode() + b"\x00"
    ops = _parse_cigar(rec.cigar)
    span = _cigar_ref_span(ops)
    bin_ = reg2bin(max(pos, 0), max(pos, 0) + max(span, 1))
    next_id = (ref_id if rec.rnext == "=" else ref_ids.get(rec.rnext, -1))
    l_seq = 0 if rec.seq == "*" else len(rec.seq)
    body = struct.pack(
        "<iiBBHHHiiii", ref_id, pos, len(qname), rec.mapq, bin_,
        len(ops), rec.flag, l_seq, next_id, rec.pnext - 1, rec.tlen,
    )
    body += qname
    for n, op in ops:
        body += struct.pack("<I", (n << 4) | _CIGAR_CODE[op])
    body += _encode_seq(rec.seq)
    if rec.qual == "*" or l_seq == 0:
        body += b"\xff" * l_seq
    else:
        body += bytes((min(ord(c) - 33, 93) for c in rec.qual))
    body += _encode_tags(rec.tags)
    return body


def decode_record(body: bytes, ref_names) -> SamRecord:
    (ref_id, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq, next_id,
     next_pos, tlen) = struct.unpack("<iiBBHHHiiii", body[:32])
    i = 32
    qname = body[i:i + l_qname - 1].decode()
    i += l_qname
    ops = []
    for _ in range(n_cigar):
        (v,) = struct.unpack("<I", body[i:i + 4])
        ops.append(f"{v >> 4}{_CIGAR_OPS[v & 0xF]}")
        i += 4
    cigar = "".join(ops) if ops else "*"
    seq = _decode_seq(body[i:], l_seq)
    i += (l_seq + 1) // 2
    qraw = body[i:i + l_seq]
    qual = ("*" if (not l_seq or qraw[:1] == b"\xff")
            else bytes(q + 33 for q in qraw).decode())
    i += l_seq
    tags = _decode_tags(body[i:])
    rname = ref_names[ref_id] if 0 <= ref_id < len(ref_names) else "*"
    rnext = ("*" if next_id < 0
             else ("=" if next_id == ref_id else ref_names[next_id]))
    return SamRecord(
        qname=qname, flag=flag, rname=rname, pos=pos + 1, mapq=mapq,
        cigar=cigar, seq=seq if seq else "*", qual=qual, rnext=rnext,
        pnext=next_pos + 1, tlen=tlen, tags=tags or None,
    )


class BamWriter:
    """Drop-in sibling of ``SamWriter`` producing BGZF-compressed BAM."""

    def __init__(self, path_or_file, ref_names, ref_lengths,
                 program="nvbio_tpu_torch", level: int = 6, sort_order="unsorted"):
        self.bgzf = BgzfWriter(path_or_file, level)
        self.ref_ids = {str(n): i for i, n in enumerate(ref_names)}
        header_text = f"@HD\tVN:1.6\tSO:{sort_order}\n"
        for name, length in zip(ref_names, ref_lengths):
            header_text += f"@SQ\tSN:{name}\tLN:{int(length)}\n"
        header_text += f"@PG\tID:{program}\tPN:{program}\n"
        htext = header_text.encode()
        self.bgzf.write(b"BAM\x01" + struct.pack("<i", len(htext)) + htext)
        self.bgzf.write(struct.pack("<i", len(ref_names)))
        for name, length in zip(ref_names, ref_lengths):
            nb = str(name).encode() + b"\x00"
            self.bgzf.write(struct.pack("<i", len(nb)) + nb
                            + struct.pack("<i", int(length)))
        self.n_records = 0

    def write(self, rec: SamRecord) -> None:
        body = encode_record(rec, self.ref_ids)
        self.bgzf.write(struct.pack("<i", len(body)) + body)
        self.n_records += 1

    def close(self) -> None:
        self.bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamReader:
    def __init__(self, path_or_file):
        self.bgzf = BgzfReader(path_or_file)
        magic = self.bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack("<i", self.bgzf.read(4))
        self.header_text = self.bgzf.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", self.bgzf.read(4))
        self.ref_names, self.ref_lengths = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self.bgzf.read(4))
            self.ref_names.append(self.bgzf.read(l_name)[:-1].decode())
            self.ref_lengths.append(struct.unpack("<i", self.bgzf.read(4))[0])

    def __iter__(self):
        while True:
            raw = self.bgzf.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            body = self.bgzf.read(block_size)
            yield decode_record(body, self.ref_names)

    def close(self) -> None:
        self.bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_bam(path: str):
    """BAM analogue of ``read_sam``: (header_lines, list of column lists)."""
    with BamReader(path) as br:
        header = [ln for ln in br.header_text.split("\n") if ln]
        recs = [r.line().split("\t") for r in br]
    return header, recs
