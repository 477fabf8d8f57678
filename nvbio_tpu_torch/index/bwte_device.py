"""Device-resident BWTE: block-incremental read-set BWT on the card.

Port of ``nvbio_tpu.index.bwte_device`` (the reference's GPU BWTE,
``nvbio/sufsort/bwte.h:57-229``). The merged multi-string BWT stays on the
engine's device across blocks; each block of uniform-length reads adds

1. its own BCR suffix order, sorted on the device from the 2-bit packed
   reads (the only upload): one int64 26-symbol base-5 key (the JAX
   engine's two 13-symbol keys) and the owner key wherever the read's '$'
   falls inside the window, as two stable ``torch.sort`` calls; groups
   still tied after those 26 symbols resolve by the port's prefix doubling
   over the block's joined text (``index.device_sa._resolve_ties``: ranks
   of the bootstrap groups, the rows compacted every round). That is the
   only tie path: torch shapes are dynamic, so the JAX engine's capacity
   switch to a full-plane doubling has no counterpart. ``block_sa="host"``
   takes the block's order from host SA-IS instead;
2. a rank walk: every block suffix's rank against the merged BWT by the LF
   recurrence rank(c.T) = C[c] + occ(c, rank(T)), rank($_i) = strings so
   far, one step of torch ops per read position (the JAX ``lax.scan``).
   occ reads the interleaved rank rows of ``fmi.rank`` (SWAR popcounts)
   built over the merged plane with each '$' packed as A; the A count is
   then corrected by the '$' rows before the query, a ``searchsorted`` in
   the sorted side list of '$' positions;
3. a one-pass interleave: block row i lands at its rank + i, the old
   symbols fill the other rows in order (the mask scatter of the host
   engine's ``bwte_merge_block_rank``). The JAX engine sorts the two
   streams instead, because scatters are slow on a TPU
   (``BWTE_MERGE_PROBE.json``); on the card the scatter is O(n) and the
   sort is not needed.

Sentinel identities stay out of the dense plane, as in the JAX engine:
'$' rows hold 0 and their string tags live in a (position, tag) side list
kept sorted by position. The merged plane holds exactly the symbols so far
(no static capacity padding); ``capacity`` stays a limit, below 2^31.
"""

from __future__ import annotations

import numpy as np
import torch

from nvbio_tpu_torch import packed
from nvbio_tpu_torch.device import resolve_device
from nvbio_tpu_torch.fmi.rank import rank, rank_rows_tensor
from nvbio_tpu_torch.index.device_sa import (
    _pack_occ,
    _resolve_ties,
    _run_starts,
    _runs,
)

OCC_K = 64          # capacity granule (symbols), as the JAX engine's
_B13 = 13           # symbols per base-5 key of the JAX engine


def _unpack_reads(rwords: torch.Tensor, L: int) -> torch.Tensor:
    """(m, L) int64 codes from (m, ceil(L/16)) int32 words of 2-bit codes
    (``packed.pack`` layout, LSB first)."""
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=rwords.device)
    w = rwords.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, :, None] >> shifts) & 3).reshape(w.shape[0], -1)[:, :L]


def block_suffix_array(reads: torch.Tensor) -> torch.Tensor:
    """BCR suffix order (int64 positions into the block's joined text,
    read i at [i*(L+1), (i+1)*(L+1)) with its '$' last) of an (m, L) int64
    code matrix, on its device: comparisons stop at a '$', and '$_i' <
    '$_j' for i < j."""
    m, L = reads.shape
    P = L + 1
    bn = m * P
    dev = reads.device
    plane = torch.zeros((m, P + 2 * _B13), dtype=torch.int64, device=dev)
    plane[:, :L] = reads + 1
    key = torch.zeros((m, P), dtype=torch.int64, device=dev)
    for j in range(2 * _B13):
        key.mul_(5).add_(plane[:, j:j + P])
    del plane
    # owner key where the '$' lies within the 26-symbol window
    o = torch.arange(P, device=dev)
    owner = torch.where(o[None, :] > L - 2 * _B13,
                        torch.arange(m, device=dev)[:, None], -1).reshape(bn)
    k3, order = torch.sort(owner, stable=True)
    k26, o2 = torch.sort(key.reshape(bn)[order], stable=True)
    del key, owner
    sa = order[o2]
    rank_sorted, tied = _run_starts(
        _runs(k26, k3[o2]), torch.arange(bn, dtype=torch.int64, device=dev))
    _resolve_ties(sa, rank_sorted, tied, bn)
    return sa


def block_planes(reads: torch.Tensor, sa: torch.Tensor, s: int):
    """(block BWT uint8 over {0:'$', 1..4}, '$' tags int64, -1 elsewhere)
    of the block's suffix order ``sa``; tags count from string ``s``."""
    m, L = reads.shape
    P = L + 1
    at_start = sa % P == 0
    pm1 = (sa - 1).clamp(min=0)
    prev_is_sent = pm1 % P == L
    prev_owner = pm1 // P
    if L:
        prev_sym = reads.reshape(-1)[prev_owner * L
                                     + (pm1 % P).clamp(max=L - 1)]
    else:
        prev_sym = torch.zeros_like(sa)
    is_dollar = at_start | prev_is_sent
    bwt = torch.where(is_dollar, 0, prev_sym + 1).to(torch.uint8)
    tags = torch.where(at_start, sa // P,
                       torch.where(prev_is_sent, prev_owner, -1))
    return bwt, torch.where(tags >= 0, tags + s, -1)


class BwteDevice:
    """Accumulates uniform-length read blocks into a multi-string BWT held
    on ``device`` (cuda unless the caller asks for the CPU). ``capacity``
    symbols (rounded up to 64, below 2^31), ``n_strings`` reads in all."""

    def __init__(self, capacity: int, n_strings: int, device=None):
        CAP = (capacity + OCC_K - 1) // OCC_K * OCC_K
        if CAP >= 2**31:
            raise ValueError("int32 capacity limit; shard the set")
        self.device = resolve_device(device)
        self.capacity = CAP
        self.n_strings = n_strings
        self.M = torch.zeros(0, dtype=torch.uint8, device=self.device)
        self.dpos = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.dtags = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.n = 0            # symbols merged so far
        self.s = 0            # strings merged so far

    def _check(self, m: int, L: int) -> None:
        if self.n + m * (L + 1) > self.capacity:
            raise ValueError("block exceeds capacity")
        if self.s + m > self.n_strings:
            raise ValueError("block exceeds n_strings")

    def add_block_packed(self, rwords: torch.Tensor, m: int, L: int):
        """A block whose 2-bit packed reads (``packed.pack`` layout, (m,
        ceil(L/16)) int32 words) are already on the engine's device."""
        self._check(m, L)
        if m == 0:
            return
        reads = _unpack_reads(rwords.to(self.device), L)
        self._apply_block(reads, block_suffix_array(reads))

    def add_block(self, reads: np.ndarray, block_sa: str = "device"):
        """reads: (m, L) uint8 codes 0..3, uniform length.

        ``block_sa="device"`` (default): only the 2-bit packed reads cross
        the host link (mL/4 bytes); the block's suffix sort and every
        derived plane run on the device. ``"host"``: the block's order from
        native SA-IS on the host (the oracle path the tests cross-check)."""
        reads = np.asarray(reads, np.uint8)
        m, L = reads.shape
        if block_sa == "device":
            self.add_block_packed(
                packed.words_to_tensor(packed.pack(reads, 2), self.device),
                m, L)
            return
        if block_sa != "host":
            raise ValueError(f"unknown block_sa {block_sa!r}")
        from nvbio_tpu_torch.index.setbwt import _bcr_sa

        self._check(m, L)
        if m == 0:
            return
        sa = torch.from_numpy(_bcr_sa(list(reads))[0]).to(self.device)
        self._apply_block(torch.from_numpy(reads.astype(np.int64)).to(
            self.device), sa)

    def _apply_block(self, reads: torch.Tensor, sa: torch.Tensor):
        m, L = reads.shape
        bwt, tags = block_planes(reads, sa, self.s)
        if self.n == 0:
            # block 0 into an empty plane: its own BWT is the merged BWT
            self.M = bwt
            self.dpos = torch.nonzero(tags >= 0).squeeze(1)
            self.dtags = tags[self.dpos]
        else:
            self._merge(reads, sa, bwt, tags)
        self.n += m * (L + 1)
        self.s += m

    def _occ_rows(self):
        """(rank rows of the merged plane with '$' packed as A, C[0..4]
        with C[c] = strings + bases smaller than c)."""
        codes = (self.M.to(torch.int16) - 1).clamp(min=0).to(torch.uint8)
        words, occ, _ = _pack_occ(codes, self.n)
        del codes
        counts = torch.stack([(self.M == c).sum() for c in range(1, 5)])
        C = torch.zeros(5, dtype=torch.int64, device=self.device)
        C[1] = self.s
        C[2:] = self.s + torch.cumsum(counts[:-1], dim=0)
        return rank_rows_tensor(words, self.n, occ), C

    def _merge(self, reads, sa, bwt, tags):
        m, L = reads.shape
        P = L + 1
        bn = m * P
        dev = self.device
        rows, C = self._occ_rows()
        # rank walk over the read positions, last symbol first: the suffix
        # starting j symbols before a read's '$' has rank C[c] + occ(c, r)
        starts = torch.arange(m, dtype=torch.int64, device=dev) * P
        ranks_pos = torch.empty(bn, dtype=torch.int64, device=dev)
        ranks_pos[starts + L] = self.s
        r = torch.full((m,), self.s, dtype=torch.int64, device=dev)
        rev = reads.flip(1) + 1
        for j in range(1, L + 1):
            cs = rev[:, j - 1]
            dollars_before = torch.searchsorted(self.dpos, r)
            occ = rank(rows, cs - 1, r) - torch.where(cs == 1,
                                                      dollars_before, 0)
            r = C[cs] + occ
            ranks_pos[starts + (L - j)] = r
        del rows
        # block row i lands at rank + i (ranks are non-decreasing in suffix
        # order); the old symbols fill the other rows in order
        r_of_row = ranks_pos[sa]
        newpos = r_of_row + torch.arange(bn, dtype=torch.int64, device=dev)
        keep = torch.ones(self.n + bn, dtype=torch.bool, device=dev)
        keep[newpos] = False
        merged = torch.empty(self.n + bn, dtype=torch.uint8, device=dev)
        merged[newpos] = bwt
        merged[keep] = self.M
        self.M = merged
        # an old '$' at p moves past the new rows of rank <= p
        shifted = self.dpos + torch.searchsorted(r_of_row, self.dpos,
                                                 right=True)
        new_d = tags >= 0
        all_pos = torch.cat([shifted, newpos[new_d]])
        all_tags = torch.cat([self.dtags, tags[new_d]])
        order = torch.argsort(all_pos)
        self.dpos, self.dtags = all_pos[order], all_tags[order]

    def sync(self):
        """Block until the device state is materialized."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finalize(self):
        """Fetch (bwt uint8 (n,), tags int64 (n,), -1 off '$' rows)."""
        bwt = self.M.cpu().numpy()
        tags = np.full(self.n, -1, np.int64)
        tags[self.dpos.cpu().numpy()] = self.dtags.cpu().numpy()
        return bwt, tags
