"""BWA-compatible .pac / .ann / .amb reference artifacts.

Counterpart of the reference's ``nvBWT/nvBWT.cu:280-308`` (``save_pac``:
2-bit packed text with the BWA trailer convention so the file size is always
``l_pac/4 + 2``) and ``nvbio/basic/bnt.{h,cpp}`` (``save_bns``/``load_bns``:
the .ann/.amb contig-name/offset/ambiguity sidecars). Files written here are
readable by BWA and vice versa, so indexes interoperate at the artifact
level. A copy of ``nvbio_tpu.io.pac``, with the nvBWT ``.bwt`` artifacts
(``save_bwt``/``load_bwt``, plain or in LZ4 frames).
"""

from __future__ import annotations

import numpy as np


def save_pac(codes: np.ndarray, path: str) -> None:
    """Write 2-bit codes as a BWA .pac file (MSB-first within each byte)."""
    codes = np.asarray(codes, np.uint8) & 3
    n = len(codes)
    n_bytes = (n + 3) // 4
    padded = np.zeros(n_bytes * 4, np.uint8)
    padded[:n] = codes
    grouped = padded.reshape(n_bytes, 4)
    shifts = np.array([6, 4, 2, 0], np.uint8)  # base i at bits (3-i%4)*2
    data = np.bitwise_or.reduce(grouped << shifts, axis=1).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(data.tobytes())
        if n % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([n % 4]))


def load_pac(path: str) -> np.ndarray:
    """Read a BWA .pac file back to 2-bit codes."""
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    if len(raw) < 2:
        raise ValueError(f"{path}: truncated .pac")
    ct = int(raw[-1])
    data = raw[:-1] if ct else raw[:-2]
    n = len(data) * 4 - ((4 - ct) % 4)
    shifts = np.array([6, 4, 2, 0], np.uint8)
    codes = ((data[:, None] >> shifts) & 3).reshape(-1)
    return codes[:n].astype(np.uint8)


def _amb_runs(reference):
    """[(offset, length)] runs of ambiguous (N) bases from the bitmask."""
    if reference.n_mask_words is None:
        return []
    n = reference.total_length
    idx = np.arange(n)
    bits = (reference.n_mask_words[idx // 32] >> (idx % 32).astype(np.uint32)) & 1
    amb = bits.astype(bool)
    if not amb.any():
        return []
    d = np.diff(amb.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if amb[0]:
        starts = np.insert(starts, 0, 0)
    if amb[-1]:
        ends = np.append(ends, n)
    runs = list(zip(starts.tolist(), (ends - starts).tolist()))
    # split runs at contig boundaries: BWA's .ann per-contig n_amb counts
    # holes per contig, so a run straddling an offset must become two holes
    cuts = np.asarray(reference.offsets[1:-1], np.int64)
    out = []
    for s, l in runs:
        e = s + l
        for c in cuts[(cuts > s) & (cuts < e)].tolist():
            out.append((s, c - s))
            s = c
        out.append((s, e - s))
    return out


def save_bns(reference, prefix: str, seed: int = 11) -> None:
    """Write .ann/.amb sidecars (BWA text format; reference bnt.cpp)."""
    holes = _amb_runs(reference)
    n_seqs = len(reference.names)
    l_pac = reference.total_length
    with open(prefix + ".ann", "w") as f:
        f.write(f"{l_pac} {n_seqs} {seed}\n")
        for i, name in enumerate(reference.names):
            off = int(reference.offsets[i])
            length = int(reference.offsets[i + 1]) - off
            n_amb = sum(1 for s, l in holes
                        if off <= s < off + length)
            f.write(f"0 {name} (null)\n")
            f.write(f"{off} {length} {n_amb}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{l_pac} {n_seqs} {len(holes)}\n")
        for s, l in holes:
            f.write(f"{s} {l} N\n")


def load_bns(prefix: str):
    """Read .ann/.amb -> (names, offsets, amb_runs)."""
    names, offsets = [], [0]
    with open(prefix + ".ann") as f:
        header = f.readline().split()
        l_pac, n_seqs = int(header[0]), int(header[1])
        for _ in range(n_seqs):
            name = f.readline().split()[1]
            off, length, _n_amb = map(int, f.readline().split()[:3])
            names.append(name)
            offsets.append(off + length)
    holes = []
    try:
        with open(prefix + ".amb") as f:
            _, _, n_holes = map(int, f.readline().split()[:3])
            for _ in range(n_holes):
                parts = f.readline().split()
                holes.append((int(parts[0]), int(parts[1])))
    except FileNotFoundError:
        pass
    if offsets[-1] != l_pac:
        raise ValueError(f"{prefix}.ann: offsets do not sum to l_pac")
    return names, np.asarray(offsets, np.int64), holes


def save_reference_pac(reference, prefix: str) -> None:
    """Write the full artifact set: .pac + .ann + .amb."""
    save_pac(reference.codes, prefix + ".pac")
    save_bns(reference, prefix)


def load_reference_pac(prefix: str):
    """Load a .pac/.ann/.amb artifact set back into a Reference."""
    from nvbio_tpu_torch.io.reference import Reference

    codes = load_pac(prefix + ".pac")
    names, offsets, holes = load_bns(prefix)
    n_words = (len(codes) + 31) // 32
    mask = np.zeros(n_words, np.uint32)
    for s, l in holes:
        idx = np.arange(s, s + l)
        np.bitwise_or.at(mask, idx // 32,
                         np.uint32(1) << (idx % 32).astype(np.uint32))
    return Reference(names, offsets, codes, mask)


_LZ4_MAGIC = b"NB4\x01"


def save_bwt(bwt_codes: np.ndarray, primary: int, path: str,
             compress: str | None = None) -> None:
    """Write an nvBWT-format .bwt file (``nvBWT/nvBWT.cu:314-330``):
    uint32 primary, uint32 cumFreq[4], then the 2-bit packed BWT words
    (MSB-first within each word, the nvbio/BWA stream convention).

    ``compress="lz4"`` writes the LZ4 variant instead (the reference's
    ``sufsort/file_bwt_lz4.cu``), through ``native/lz4.cpp``: magic
    ``NB4\\x01``, the same header, then [u32 raw_len][u32 comp_len]
    [LZ4 block] frames over the packed word byte stream."""
    import struct

    if compress not in (None, "lz4"):
        raise ValueError(f"unknown compress={compress!r}")
    bwt_codes = np.asarray(bwt_codes, np.uint8)
    n = len(bwt_codes)
    CH = 1 << 26  # symbols per chunk, a multiple of 16
    counts = np.zeros(4, np.int64)
    for s in range(0, n, CH):
        counts += np.bincount(bwt_codes[s:s + CH], minlength=4)[:4]
    cum = np.cumsum(counts).astype(np.uint32)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    with open(path, "wb") as f:
        if compress == "lz4":
            f.write(_LZ4_MAGIC)
        f.write(struct.pack("<I", primary))
        f.write(cum.astype("<u4").tobytes())
        for s in range(0, n, CH):
            seg = bwt_codes[s:s + CH]
            nw = (len(seg) + 15) // 16
            padded = np.zeros(nw * 16, np.uint32)
            padded[:len(seg)] = seg
            words = np.bitwise_or.reduce(
                padded.reshape(nw, 16) << shifts, axis=1).astype(np.uint32)
            raw = words.astype("<u4").tobytes()
            if compress == "lz4":
                from nvbio_tpu_torch import native

                comp = native.lz4_compress(raw)
                f.write(struct.pack("<II", len(raw), len(comp)))
                f.write(comp.tobytes())
            else:
                f.write(raw)


def _lz4_frames(data: bytes):
    """(words, primary, cum) of an LZ4-framed .bwt; ValueError when the
    frames do not parse (a plain file whose primary equals the magic)."""
    import struct

    from nvbio_tpu_torch import native

    primary = struct.unpack("<I", data[4:8])[0]
    cum = np.frombuffer(data[8:24], "<u4").astype(np.int64)
    parts = []
    i = 24
    while i < len(data):
        if i + 8 > len(data):
            raise ValueError("truncated frame header")
        raw_len, comp_len = struct.unpack("<II", data[i:i + 8])
        i += 8
        if i + comp_len > len(data):
            raise ValueError("truncated frame")
        parts.append(native.lz4_decompress(data[i:i + comp_len], raw_len))
        i += comp_len
    words = (np.concatenate(parts).view("<u4").astype(np.uint32)
             if parts else np.zeros(0, np.uint32))
    return words, primary, cum


def load_bwt(path: str):
    """Read an nvBWT .bwt file (plain or LZ4-framed, told apart by the
    ``NB4\\x01`` magic and strict frame parsing) -> (bwt_codes, primary,
    cumFreq)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    parsed = None
    if data[:4] == _LZ4_MAGIC:
        try:
            parsed = _lz4_frames(data)
        except ValueError:
            parsed = None
    if parsed is None:
        primary = struct.unpack("<I", data[:4])[0]
        cum = np.frombuffer(data[4:20], "<u4").astype(np.int64)
        words = np.frombuffer(data[20:], "<u4").astype(np.uint32)
    else:
        words, primary, cum = parsed
    n = int(cum[3])
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    codes = ((words[:, None] >> shifts) & 3).reshape(-1)[:n]
    return codes.astype(np.uint8), int(primary), cum
