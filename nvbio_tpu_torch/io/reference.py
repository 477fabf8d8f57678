"""Reference genome container: packed concatenated contigs + metadata.

Counterpart of the reference's SequenceData + BNT metadata
(``io/sequence/sequence.h``, ``basic/bnt.h``): all contigs concatenated into
one 2-bit packed string (the ".pac" view) with offsets/names to map global
coordinates back to (contig, position) for SAM output.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nvbio_tpu_torch import packed
from nvbio_tpu_torch.alphabet import Alphabet, string_to_codes
from nvbio_tpu_torch.io.fasta import read_fasta


@dataclasses.dataclass
class Reference:
    names: list[str]
    offsets: np.ndarray      # int64[n_contigs + 1] global start offsets
    codes: np.ndarray        # uint8[total] 2-bit codes (N folded to A)
    n_mask_words: np.ndarray | None = None  # uint32 bitmask of ambiguous bases

    @classmethod
    def from_fasta(cls, path: str) -> "Reference":
        recs = read_fasta(path)
        return cls.from_records(recs)

    @classmethod
    def from_records(cls, recs) -> "Reference":
        names = [n for n, _ in recs]
        seqs = [string_to_codes(s, Alphabet.DNA) for _, s in recs]
        ambs = []
        for _, s in recs:
            raw = np.frombuffer(s.upper().encode(), dtype=np.uint8)
            ambs.append(~np.isin(raw, np.frombuffer(b"ACGT", dtype=np.uint8)))
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
        codes = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
        amb = np.concatenate(ambs) if ambs else np.zeros(0, bool)
        codes = np.where(amb, 0, codes).astype(np.uint8)  # fold N -> A
        idx = np.nonzero(amb)[0]
        n_words = (len(codes) + 31) // 32
        mask = np.zeros(n_words, dtype=np.uint32)
        if len(idx):
            np.bitwise_or.at(mask, idx // 32, np.uint32(1) << (idx % 32).astype(np.uint32))
        return cls(names, offsets, codes, mask)

    @property
    def total_length(self) -> int:
        return int(self.offsets[-1])

    def n_flags(self) -> np.ndarray | None:
        """Per-position ambiguity (N) flags, or None when the genome has no
        ambiguous bases. Used to exclude N-overlapping q-grams from seeding
        indexes (folded-to-A N runs must not attract seed hits)."""
        if self.n_mask_words is None or len(self.n_mask_words) == 0:
            return None
        if not self.n_mask_words.any():
            return None
        bits = np.unpackbits(
            np.ascontiguousarray(self.n_mask_words).view(np.uint8),
            bitorder="little")
        return bits[:self.total_length].astype(bool)

    def n_mask(self, device):
        """``n_mask_words`` as an int32 tensor of the same bits on
        ``device``, or None when the genome has no ambiguous bases."""
        if self.n_mask_words is None or not self.n_mask_words.any():
            return None
        return packed.words_to_tensor(self.n_mask_words, device)

    def packed_words(self) -> np.ndarray:
        return packed.pack(self.codes, 2)

    def global_to_contig(self, pos: np.ndarray):
        """(contig_index, local_pos) for global positions."""
        pos = np.asarray(pos)
        ci = np.searchsorted(self.offsets, pos, side="right") - 1
        return ci, pos - self.offsets[ci]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            names=np.array(self.names),
            offsets=self.offsets,
            codes=self.codes,
            n_mask_words=self.n_mask_words
            if self.n_mask_words is not None
            else np.zeros(0, np.uint32),
        )

    @classmethod
    def load(cls, path: str) -> "Reference":
        z = np.load(path)
        return cls(
            [str(x) for x in z["names"]], z["offsets"], z["codes"],
            z["n_mask_words"],
        )
