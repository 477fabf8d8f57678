"""Lighter-style error correction with Bloom filters (nvLighter equivalent).

Port of ``nvbio_tpu.lighter`` (the reference's nvLighter,
``nvLighter/nvLighter.cu:417-600``, ``sample_kmers.h``,
``error_correct.h``): three phases over the read set —
  1. sample k-mer *occurrences* at rate 1/alpha_den into Bloom filter A
     (per-occurrence randomness, so high-coverage k-mers are almost surely
     sampled);
  2. mark *trusted* k-mers (every base covered by >= solid_cov sampled
     k-mers) into Bloom filter B;
  3. correct reads: every single-base substitution is evaluated exactly —
     it changes a packed k-mer key by an XOR at a known bit position, so
     all (position x alternative) candidate k-mers are bit math + Bloom
     queries.

All phases are dense (B, P)/(B, L) planes of torch ops on the reads'
device; the filters are ``bloom.ByteBloomFilter`` byte tensors there,
updated in place by index fills (the JAX package donates them). Packed
k-mer halves and hashes are int64 holding uint32 values (``bloom``'s
masking), so ``torch.minimum`` of two keys is the unsigned compare
``jnp.minimum`` makes on uint32. Windows with masked-out keys still insert
the sentinel 0xFFFFFFFF, as the JAX phases do. Phase 3 is ~2000 small
device ops a batch (3 alternatives x k window offsets, each a patch, two
hashes of each half and a 3-probe filter query).
"""

from __future__ import annotations

import dataclasses

import torch

from nvbio_tpu_torch.bloom import M32, ByteBloomFilter, hash1, hash2, mul32

SENTINEL = 0xFFFFFFFF   # the key of a window that inserts nothing real


@dataclasses.dataclass(frozen=True)
class LighterParams:
    k: int = 17
    alpha_den: int = 8          # sample 1/alpha_den of k-mer occurrences
    solid_cov: int = 9          # min sampled k-mers covering a base (> k/2: a true base sees ~k present k-mers, an error base ~k/alpha_den)
    bloom_bits_a: int = 1 << 22
    bloom_bits_b: int = 1 << 22
    max_read_len: int = 128


def _pack_windows(reads, k: int):
    """Packed halves of every k-window, forward and reverse-complement.

    Returns (f1, f2, b1, b2), each (B, P) int64 holding uint32 values,
    P = L - k + 1. The forward symbol at window offset j lives in f1
    (j < 16) or f2 at a fixed bit position; the RC packing mirrors offsets
    (j -> k-1-j) with complemented symbols (complement == XOR 3, so
    single-symbol deltas are strand-equal). k <= 16 leaves f2 and b2 0."""
    B, L = reads.shape
    P = L - k + 1
    r = reads.to(torch.int64)
    rc = 3 - r
    k1 = min(k, 16)

    def pack(x, rev):
        acc1 = torch.zeros((B, P), dtype=torch.int64, device=x.device)
        acc2 = torch.zeros_like(acc1)
        for j in range(k):
            jj = k - 1 - j if rev else j
            sym = x[:, jj:jj + P]
            if j < k1:
                acc1 = ((acc1 << 2) | sym) & M32
            else:
                acc2 = ((acc2 << 2) | sym) & M32
        return acc1, acc2

    f1, f2 = pack(r, rev=False)
    b1, b2 = pack(rc, rev=True)
    return f1, f2, b1, b2


def _fwd_shift(j: int, k: int) -> tuple[int, int]:
    """(half, bit shift) of forward window offset j in the packed halves."""
    k1 = min(k, 16)
    if j < k1:
        return 0, 2 * (k1 - 1 - j)
    return 1, 2 * (k - 1 - j)


def _canonical(f1, f2, b1, b2):
    hf = hash1(f1) ^ hash2(f2)
    hb = hash1(b1) ^ hash2(b2)
    return torch.minimum(hf, hb)


def _kmer_keys(reads, lens, k: int):
    """Canonical k-mer keys (B, P) (int64 holding uint32) + validity."""
    f1, f2, b1, b2 = _pack_windows(reads, k)
    P = f1.shape[1]
    valid = (torch.arange(P, dtype=torch.int64, device=reads.device)[None, :]
             + k) <= lens.to(torch.int64)[:, None]
    return _canonical(f1, f2, b1, b2), valid


def _coverage_from_present(present_i, L: int, k: int):
    """Per-base count of present k-mers covering it (windowed sum)."""
    B, P = present_i.shape
    dev = present_i.device
    csum = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                      torch.cumsum(present_i.to(torch.int64), dim=1)], dim=1)
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    lo = (pos - k + 1).clamp(0, P).expand(B, L)
    hi = (pos + 1).clamp(0, P).expand(B, L)
    return torch.gather(csum, 1, hi) - torch.gather(csum, 1, lo)


def sample_kmers(filter_a_bytes, reads, lens, batch_offset: int,
                 params: LighterParams):
    """Phase 1: per-occurrence subsampling into filter A (updated in place
    and returned). The occurrence id (read index + ``batch_offset``) *
    ``max_read_len`` + window wraps at 2^32, as the JAX package's uint32
    does."""
    P2 = params
    bf = ByteBloomFilter(filter_a_bytes, P2.bloom_bits_a, 3)
    keys, valid = _kmer_keys(reads, lens, P2.k)
    B, P = keys.shape
    dev = keys.device
    row = (torch.arange(B, dtype=torch.int64, device=dev)
           + (int(batch_offset) & M32)) & M32
    occ_id = (mul32(row, P2.max_read_len)[:, None]
              + torch.arange(P, dtype=torch.int64, device=dev)[None, :]) & M32
    # hash1, not hash2: hash2 is forced odd for double hashing, which would
    # make `% den == 0` unsatisfiable
    take = valid & (hash1(keys ^ hash2(occ_id)) % P2.alpha_den == 0)
    masked = torch.where(take, keys, SENTINEL)
    return bf.insert_(masked.reshape(-1)).bytes_


def mark_trusted(filter_a_bytes, filter_b_bytes, reads, lens,
                 params: LighterParams):
    """Phase 2: k-mers whose bases are all solid go into filter B (updated
    in place and returned)."""
    P2 = params
    bfa = ByteBloomFilter(filter_a_bytes, P2.bloom_bits_a, 3)
    bfb = ByteBloomFilter(filter_b_bytes, P2.bloom_bits_b, 3)
    keys, valid = _kmer_keys(reads, lens, P2.k)
    B, L = reads.shape
    dev = keys.device
    lens = lens.to(torch.int64)
    present = (bfa.contains(keys) & valid).to(torch.int64)
    cov = _coverage_from_present(present, L, P2.k)
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    solid = ((cov >= P2.solid_cov) & (pos < lens[:, None])).to(torch.int64)

    scs = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                     torch.cumsum(solid, dim=1)], dim=1)
    Pn = present.shape[1]
    start = torch.arange(Pn, dtype=torch.int64, device=dev)[None, :]
    inwin = (torch.gather(scs, 1, (start + P2.k).expand(B, Pn))
             - torch.gather(scs, 1, start.expand(B, Pn)))
    trusted = (inwin == P2.k) & valid
    masked = torch.where(trusted, keys, SENTINEL)
    return bfb.insert_(masked.reshape(-1)).bytes_


def correct_reads(filter_b_bytes, reads, lens, params: LighterParams):
    """Phase 3: exact single-substitution correction.

    For every read position i and alternative base, count the trusted
    k-mers that would cover i after substituting — computed by
    XOR-patching the packed window keys (both strands). Apply the best
    strictly-improving alternative at uncovered positions. Returns
    (corrected int32 (B, L), n_corrections int64 (B,))."""
    P2 = params
    k = P2.k
    bfb = ByteBloomFilter(filter_b_bytes, P2.bloom_bits_b, 3)
    B, L = reads.shape
    reads = reads.to(torch.int64)
    dev = reads.device
    lens = lens.to(torch.int64)

    f1, f2, b1, b2 = _pack_windows(reads, k)
    P = f1.shape[1]
    valid = (torch.arange(P, dtype=torch.int64, device=dev)[None, :]
             + k) <= lens[:, None]
    base_present = bfb.contains(_canonical(f1, f2, b1, b2)) & valid
    base_cov = _coverage_from_present(base_present.to(torch.int64), L, k)

    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    best_cnt = torch.zeros((B, L), dtype=torch.int64, device=dev)
    best_sym = reads

    for d in range(1, 4):
        # symbol delta per position: old ^ new where new = (old + d) % 4
        new_sym = (reads + d) % 4
        delta = reads ^ new_sym                               # (B, L)
        # trusted k-mers covering position i after the substitution: the
        # window starting at w = i - j covers i at offset j
        cnt = torch.zeros((B, L), dtype=torch.int64, device=dev)
        for j in range(k):
            h, sh = _fwd_shift(j, k)
            hb_, shb = _fwd_shift(k - 1 - j, k)
            dw = delta[:, j:j + P]        # the delta at w + j, by window w
            pf1 = f1 ^ (dw << sh) if h == 0 else f1
            pf2 = f2 ^ (dw << sh) if h == 1 else f2
            pb1 = b1 ^ (dw << shb) if hb_ == 0 else b1
            pb2 = b2 ^ (dw << shb) if hb_ == 1 else b2
            ok = (bfb.contains(_canonical(pf1, pf2, pb1, pb2))
                  & valid).to(torch.int64)   # window w counts toward w + j
            okL = torch.nn.functional.pad(ok, (0, L - P))
            # the JAX package's roll wraps; the wrapped part is masked
            cnt = cnt + torch.roll(okL, j, dims=1) * (pos >= j)

        better = cnt > best_cnt
        best_cnt = torch.where(better, cnt, best_cnt)
        best_sym = torch.where(better, new_sym, best_sym)

    weak = (base_cov == 0) & (pos < lens[:, None])
    apply = weak & (best_cnt > 0)
    corrected = torch.where(apply, best_sym, reads)
    n_corr = (corrected != reads).to(torch.int64).sum(dim=1)
    return corrected.to(torch.int32), n_corr


def correct_batch(reads, lens, params: LighterParams = LighterParams(),
                  device=None):
    """Single-shot three-phase correction of one read set (numpy or
    tensors) on ``device`` (cuda unless the caller asks for the CPU)."""
    from nvbio_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    reads = torch.as_tensor(reads).to(dev)
    lens = torch.as_tensor(lens).to(dev)
    bfa = ByteBloomFilter.empty(params.bloom_bits_a, 3, dev).bytes_
    bfa = sample_kmers(bfa, reads, lens, 0, params)
    bfb = ByteBloomFilter.empty(params.bloom_bits_b, 3, dev).bytes_
    bfb = mark_trusted(bfa, bfb, reads, lens, params)
    return correct_reads(bfb, reads, lens, params)
