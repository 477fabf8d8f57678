"""BWA-compatible .pac / .ann / .amb reference artifacts.

Counterpart of the reference's ``nvBWT/nvBWT.cu:280-308`` (``save_pac``:
2-bit packed text with the BWA trailer convention so the file size is always
``l_pac/4 + 2``) and ``nvbio/basic/bnt.{h,cpp}`` (``save_bns``/``load_bns``:
the .ann/.amb contig-name/offset/ambiguity sidecars). Files written here are
readable by BWA and vice versa, so indexes interoperate at the artifact
level. A copy of the text half of ``nvbio_tpu.io.pac``; the ``.bwt``
artifacts (``save_bwt``/``load_bwt``) belong to the FM index and are not
ported yet.
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
