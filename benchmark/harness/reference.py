"""The plain reference that decides ``correct``: plain torch and numpy, from
the configuration's stated semantics alone. It imports nothing of the
program and takes nothing the program made: it gets the genome and the
reads that the benchmark made, and reads the program's fetched result
arrays only to judge them.

What it works out again, for a sample of the window's reads (mates):

- the banded semi-global Gotoh score of the read against the window the
  program reports (band ``2 * max_dist + 1`` over a text of ``L + band - 1``
  bases, the pattern aligned end to end, the text free at both ends), with
  bowtie2's quality-aware mismatch penalties;
- the reported alignment itself: its op row walked against the genome
  (each op's mismatch bit and reference symbol), its score, NM, the span
  [0, L) and the band;
- MAPQ by bowtie2's V2 table from that score and the reported second
  best, and the pairing rules of the configuration (FR concordance within
  ``maxins``, rescue windows);
- its own candidates, from a table of the genome's k-mers by key:
  every window that the configuration's seeding has to locate, since its
  seed key occurs at most ``hits_per_seed`` times, on the first pass's
  seed grid and on each reseed pass's shifted grid. Each is scored; the
  best of the first pass is a floor under the reported score, the best of
  the reseed grid places a read that the first pass left unmapped, and
  the best at a locus distinct from the reported one is a floor under the
  second best (and so under what MAPQ is worked out from).
  (Paired-end: the origin's window, where its seed must be located.)

The numbers: ``wrong_fields``, the sampled reads with any field unlike the
reference's (exact, limit 0); and shares of the sampled reads (mates):
``missed_seeded``, with a located window scoring above the reported
alignment; ``missed_second`` (single-end), with a second best below the
reference's own; and, over every
read of the window's first ``pool_batches`` batches whose reseed queue
took every read that needed it, ``missed_reseed`` (single-end): left
unmapped where the reseed grid locates a window at or above the minimum
score (such reads are too rare for a sample).

The k-mer table (``KmerTable``) holds every key position of the genome,
past 2^31 too, and is built a partition of keys at a time, so its memory
is bounded whatever the genome's length. On the genome's device: the
table, 16 bytes a key position (int64 key and position), 51.2 GB at 3.2
Gbp, allocated once; beside it at most one step's scratch, either a
chunk's keys as ``kmer_keys`` builds them (32 bytes a position at its
peak), their partition numbers and masks (5) and the rows taken (16 a
row), about 2.7 GB at the default 2^26 positions, or one partition's
sort (the sorted keys, the order, the radix sort's buffers, the gathered
positions), no more at the default 2^26 rows. On an H100 the scratch
read 2.70 GB at 2^31 + 2^24 bases and at 3.2 Gbp. Only a bucket of more
rows than that (one 8-mer that occurs over 2^26 times) is sorted alone
past the bound. One sort of every key, as the table was first built,
held 48 bytes a base (4.84 GB at 100 Mbp on an H100): 155 GB at 3.2 Gbp.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 40)


# --------------------------------------------------------------- scoring ---

def penalties(quals: np.ndarray, sc: dict) -> np.ndarray:
    """bowtie2's quality-aware mismatch penalty a base (positive): MN +
    floor((MX - MN) * min(Q, cap) / cap)."""
    q = np.minimum(quals.astype(np.int64), sc["qual_cap"])
    return sc["mm_min"] + ((sc["mm_max"] - sc["mm_min"]) * q) // sc["qual_cap"]


def score_min(L: int, sc: dict) -> int:
    """The end-to-end minimum score ceil(const + coeff * L), in float32."""
    v = np.float32(sc["score_min_const"]) + \
        np.float32(sc["score_min_coeff"]) * np.float32(L)
    return int(np.ceil(v))


def oriented(codes: np.ndarray, pen: np.ndarray, rev: np.ndarray):
    """Patterns and penalties as aligned: reverse-complemented (penalties
    reversed) where ``rev``."""
    rc = (3 - codes.astype(np.int64))[:, ::-1]
    pat = np.where(rev[:, None], rc, codes.astype(np.int64))
    pn = np.where(rev[:, None], pen[:, ::-1], pen)
    return np.ascontiguousarray(pat), np.ascontiguousarray(pn)


def windows(genome: torch.Tensor, w0: np.ndarray, TW: int):
    """(texts (N, TW) int64, text lengths (N,)) of windows at ``w0``."""
    n = genome.shape[0]
    w = torch.as_tensor(w0, dtype=torch.int64, device=genome.device)
    idx = (w[:, None] + torch.arange(TW, device=genome.device)).clamp(
        0, n - 1)
    return genome[idx].to(torch.int64), (n - w).clamp(0, TW)


def banded_score(P: torch.Tensor, PN: torch.Tensor, text: torch.Tensor,
                 tlen: torch.Tensor, W: int, sc: dict) -> torch.Tensor:
    """Banded semi-global Gotoh score of each row. Cell (i, k) aligns
    pattern base i with text base i + k, 0 <= k < W; before the first row
    every k starts at 0 (the text is free ahead of the alignment); the
    last row's best cell ends it (free behind). A gap of n bases costs
    ``gap_open + (n - 1) * gap_ext``; text past ``tlen`` scores nothing.
    Patterns ``P`` and penalties ``PN`` are int64 (N, L) on the text's
    device."""
    dev = text.device
    N, L = P.shape
    go, ge, match = sc["gap_open"], sc["gap_ext"], sc["match"]
    k = torch.arange(W, device=dev, dtype=torch.int64)
    H = torch.zeros((N, W), dtype=torch.int64, device=dev)
    E = torch.full((N, W), NEG, dtype=torch.int64, device=dev)
    negc = torch.full((N, 1), NEG, dtype=torch.int64, device=dev)
    for i in range(L):
        t = text[:, i:i + W]
        sub = torch.where(P[:, i:i + 1] == t, match, -PN[:, i:i + 1])
        sub = torch.where((i + k)[None, :] < tlen[:, None], sub, NEG)
        diag = H + sub
        # insertion (pattern base against no text): from cell (i-1, k+1)
        E = torch.maximum(torch.cat([E[:, 1:], negc], 1) - ge,
                          torch.cat([H[:, 1:], negc], 1) - go)
        H0 = torch.maximum(diag, E)
        # deletion (text base against no pattern) within the row:
        # F[k] = max_{k' < k} H0[k'] - go - ge * (k - 1 - k')
        G = torch.cummax(H0 + ge * k, 1).values
        F = torch.cat([negc, G[:, :-1] - go - ge * (k[1:] - 1)], 1)
        H = torch.maximum(H0, F).clamp(min=NEG)
        E = E.clamp(min=NEG)
    return H.max(1).values


# -------------------------------------------------------------- the path ---

def walk(ops, n_ops, ps, pe_, gpos, w0, pat, pen, genome_np, W, sc):
    """Walk each reported alignment against the genome. ``ops`` rows hold
    one entry an op, op | mismatch << 2 | (reference symbol) << 3, op 1 =
    M, 2 = I (a read base against no genome base), 3 = D, written
    END->START (the layout of the kernel route). Returns (score, nm, subs,
    ins, dels, ok): ok is false where the walk leaves the read, the
    window or the band, or an entry's mismatch bit or symbol is wrong."""
    N, S = ops.shape
    L = pat.shape[1]
    j = np.arange(S)[None, :]
    n_ops = n_ops.astype(np.int64)
    valid = j < n_ops[:, None]
    src = np.clip(n_ops[:, None] - 1 - j, 0, S - 1)
    e = np.where(valid, np.take_along_axis(ops.astype(np.int64), src, 1), 0)
    op = e & 3
    is_m, is_i, is_d = op == 1, op == 2, op == 3
    ok = ~np.any(valid & (op == 0), 1)
    pc = ps[:, None] + np.cumsum(is_m | is_i, 1) - 1
    tc = gpos[:, None] + np.cumsum(is_m | is_d, 1) - 1
    pcc = np.clip(pc, 0, L - 1)
    tcc = np.clip(tc, 0, len(genome_np) - 1)
    p = np.take_along_axis(pat, pcc, 1)
    g = genome_np[tcc].astype(np.int64)
    mism = is_m & (p != g)
    ok &= ~np.any(is_m & (((e >> 2) & 1) != mism), 1)
    ok &= ~np.any((is_m | is_d) & (((e >> 3) & 15) != g), 1)
    # every read base and genome base the walk touches lies in bounds
    ok &= ~np.any((is_m | is_i) & ((pc < 0) | (pc >= L)), 1)
    TW = L + W - 1
    ok &= ~np.any((is_m | is_d) & ((tc < w0[:, None])
                                   | (tc >= w0[:, None] + TW)), 1)
    band = (tc - w0[:, None]) - pc
    ok &= ~np.any(is_m & ((band < 0) | (band >= W)), 1)
    n_read = (is_m | is_i).sum(1)
    ok &= (ps + n_read) == pe_
    prev = np.concatenate([np.zeros((N, 1), np.int64), op[:, :-1]], 1)
    opens = (is_i & (prev != 2)) | (is_d & (prev != 3))
    exts = (is_i | is_d) & ~opens
    pn = np.take_along_axis(pen, pcc, 1)
    score = (np.where(is_m & ~mism, sc["match"], 0).sum(1)
             - np.where(mism, pn, 0).sum(1)
             - sc["gap_open"] * opens.sum(1) - sc["gap_ext"] * exts.sum(1))
    subs, ins, dels = mism.sum(1), is_i.sum(1), is_d.sum(1)
    return score, subs + ins + dels, subs, ins, dels, ok


# ------------------------------------------------------------------ MAPQ ---

# bowtie2's BowtieMapq2 (V2), end to end: with no second-best, the first
# share of the score range that best_over reaches; with one, the first
# share of it that best_diff reaches, then best_over's tier.
_ONE = ((0.8, 42), (0.7, 40), (0.6, 24), (0.5, 23), (0.4, 8), (0.3, 3))
# (best_diff share, value if perfect, [(best_over share, value)...], else)
_TWO = ((0.9, 39, (), 33), (0.8, 38, (), 27), (0.7, 37, (), 26),
        (0.6, 36, (), 22), (0.5, 35, ((0.84, 25), (0.68, 16)), 5),
        (0.4, 34, ((0.84, 21), (0.68, 14)), 4),
        (0.3, 32, ((0.88, 18), (0.67, 15)), 3),
        (0.2, 31, ((0.88, 17), (0.67, 11)), 0),
        (0.1, 30, ((0.88, 12), (0.67, 7)), 0))


def mapq_v2(best, second, has_second, smin, perfect_score: int = 0):
    """MAPQ of each read in float32 arithmetic, as the configuration's
    mapper (nvBowtie's ``mapq.h``) computes it."""
    f = np.float32
    best = np.asarray(best).astype(f)
    second = np.asarray(second).astype(f)
    smin = f(smin)
    diff = max(f(perfect_score) - smin, f(1))
    bo = best - smin
    one = np.zeros(best.shape, np.int64)
    for share, v in reversed(_ONE):
        one = np.where(bo >= diff * f(share), v, one)
    bd = np.abs(np.abs(best) - np.abs(second))
    perfect = bo == diff
    two = np.where(bd > 0, np.where(bo >= diff * f(0.67), 6, 2),
                   np.where(bo >= diff * f(0.67), 1, 0))
    for share, vp, tiers, vlow in reversed(_TWO):
        tier = np.full(best.shape, vlow, np.int64)
        for s2, v2 in reversed(tiers):
            tier = np.where(bo >= diff * f(s2), v2, tier)
        two = np.where(bd >= diff * f(share), np.where(perfect, vp, tier),
                       two)
    q = np.where(has_second, two, one)
    return np.where(best < smin, 0, q)


# -------------------------------------------------------------- k-mers ---

def kmer_keys(codes: torch.Tensor, K: int) -> torch.Tensor:
    """int64 keys (first symbol in the high bits) of every K-mer of rows
    of codes, (..., n - K + 1)."""
    n = codes.shape[-1]
    keys = torch.zeros(codes.shape[:-1] + (n - K + 1,), dtype=torch.int64,
                       device=codes.device)
    for j in range(K):
        keys = keys * 4 + codes[..., j:n - K + 1 + j].to(torch.int64)
    return keys


def partitions(counts: list, rows: int) -> tuple[list, list]:
    """Consecutive buckets grouped greedily into partitions of at most
    ``rows`` rows (a bucket of more rows is a partition of its own):
    (the partition of each bucket, the rows of each partition)."""
    part_of, sizes = [], [0]
    for c in counts:
        if c and sizes[-1] and sizes[-1] + c > rows:
            sizes.append(0)
        sizes[-1] += c
        part_of.append(len(sizes) - 1)
    return part_of, sizes


class KmerTable:
    """Every K-mer of the genome with its position, sorted by key and then
    by position: ``keys`` and ``pos``, int64, one row a K-mer (so a key's
    rows list its positions in genome order, as a q-gram index's bucket
    does). A key's bucket is its first ``P = min(K, PREFIX)`` symbols.
    Built in three steps over the genome's key positions, taken in chunks
    of ``chunk`` positions whose genome slices overlap by K - 1 bases (P -
    1 in the first step), so that every position is keyed once, from the
    bases it starts:

    1. count the rows of each bucket;
    2. group consecutive buckets into partitions of at most ``rows`` rows
       (``partitions``): a partition's rows are a contiguous range of the
       table, its keys a contiguous range of key values. Copy each chunk's
       keys and positions, in position order, to the end of their
       partition's range;
    3. sort each partition's range in place by key, stably, carrying the
       positions.
    """

    PREFIX = 8

    def __init__(self, genome: torch.Tensor, K: int, rows: int = 1 << 26,
                 chunk: int = 1 << 26):
        self.K = K
        dev = genome.device
        m = max(genome.shape[0] - K + 1, 0)
        P = min(K, self.PREFIX)
        spans = [(s, min(s + chunk, m)) for s in range(0, m, chunk)]
        counts = torch.zeros(4 ** P, dtype=torch.int64, device=dev)
        for s, e in spans:
            counts += torch.bincount(kmer_keys(genome[s:e + P - 1], P),
                                     minlength=4 ** P)
        part_of, sizes = partitions(counts.tolist(), rows)
        part_of = torch.tensor(part_of, dtype=torch.int32, device=dev)
        first = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
        self.keys = torch.empty(m, dtype=torch.int64, device=dev)
        self.pos = torch.empty(m, dtype=torch.int64, device=dev)
        end = list(first)
        for s, e in spans:
            key = kmer_keys(genome[s:e + K - 1], K)
            part = part_of[key >> 2 * (K - P)]
            for j in range(len(sizes)):
                at = torch.nonzero(part == j).squeeze(1)
                self.keys[end[j]:end[j] + len(at)] = key[at]
                self.pos[end[j]:end[j] + len(at)] = at + s
                end[j] += len(at)
            del key, part
        for lo, size in zip(first, sizes):
            keys, order = torch.sort(self.keys[lo:lo + size], stable=True)
            self.keys[lo:lo + size] = keys
            self.pos[lo:lo + size] = self.pos[lo:lo + size][order]
            del keys, order

    def range(self, keys: torch.Tensor):
        """(first row, occurrences) of each key."""
        lo = torch.searchsorted(self.keys, keys)
        return lo, torch.searchsorted(self.keys, keys, right=True) - lo

    def count(self, keys: torch.Tensor) -> torch.Tensor:
        return self.range(keys)[1]


def seeded(fwd: np.ndarray, origin: np.ndarray, genome: torch.Tensor,
           table: KmerTable, cfg: dict) -> np.ndarray:
    """Reads (forward genome orientation) of which some seed of the
    configuration's grid matches the genome at the origin over the seed
    key and occurs at most ``hits_per_seed`` times: its every occurrence,
    the origin among them, is located."""
    mp = cfg["map_params"]
    K = table.K
    L = fwd.shape[1]
    starts = np.arange(0, L - mp["seed_len"] + 1, mp["seed_stride"])
    dev = genome.device
    n = genome.shape[0]
    f = torch.from_numpy(fwd.astype(np.int64)).to(dev)
    o = torch.from_numpy(origin.astype(np.int64)).to(dev)
    out = torch.zeros(fwd.shape[0], dtype=torch.bool, device=dev)
    for s in starts.tolist():
        seg = f[:, s:s + K]
        gi = (o[:, None] + s + torch.arange(K, device=dev)).clamp(0, n - 1)
        exact = torch.all(seg == genome[gi].to(torch.int64), 1) & \
            (o + s + K <= n)
        key = kmer_keys(seg, K)[:, 0]
        out |= exact & (table.count(key) <= mp["hits_per_seed"])
    return out.cpu().numpy()


def grid_phases(mp: dict) -> list:
    """The seed grid's phase of the first pass and of each reseed pass:
    ``p * seed_stride // (max_reseed + 1)``."""
    return [p * mp["seed_stride"] // (mp["max_reseed"] + 1)
            for p in range(mp["max_reseed"] + 1)]


def required_windows(P: torch.Tensor, table: KmerTable, n: int, mp: dict,
                     phase: int):
    """The candidate windows that the configuration's seeding has to
    locate for patterns ``P`` (N, 2, L) (the read, then its reverse
    complement) on the grid of ``phase``: every occurrence of each seed
    key (the seed's first K bases) that occurs at most ``hits_per_seed``
    times, its window starting ``seed start + max_dist`` bases before it.
    Returns (row, strand, w0), each (M,) int64 on the table's device."""
    dev = table.keys.device
    N, _, L = P.shape
    K, H, md = table.K, mp["hits_per_seed"], mp["max_dist"]
    starts = [phase + i * mp["seed_stride"]
              for i in range(max(1, (mp["max_read_len"] - mp["seed_len"])
                                 // mp["seed_stride"] + 1))]
    starts = torch.tensor([s for s in starts if s + mp["seed_len"] <= L],
                          dtype=torch.int64, device=dev)
    seeds = P[:, :, starts[:, None] + torch.arange(K, device=dev)]
    lo, cnt = table.range(kmer_keys(seeds, K)[..., 0])     # (N, 2, S)
    h = torch.arange(H, device=dev)
    ok = (h < cnt[..., None]) & (cnt[..., None] <= H)       # (N, 2, S, H)
    at = table.pos[(lo[..., None] + h).clamp(max=len(table.pos) - 1)]
    w0 = (at - (starts[None, None, :, None] + md)).clamp(0, max(n - 1, 0))
    row = torch.arange(N, device=dev)[:, None, None, None].expand_as(w0)
    strand = torch.arange(2, device=dev)[None, :, None, None].expand_as(w0)
    return row[ok], strand[ok], w0[ok]


# ---------------------------------------------------------------- judge ---

class Judge:
    """Judges the sampled results of one cell against the reference."""

    def __init__(self, genome_np: np.ndarray, cfg: dict, device):
        self.cfg = cfg
        self.sc = cfg["scoring"]
        self.mp = cfg["map_params"]
        self.W = 2 * self.mp["max_dist"] + 1
        self.genome_np = genome_np
        self.genome = torch.from_numpy(genome_np).to(device)
        mp = self.mp
        K = mp["qgram_q"] if mp["seeding"] == "qgram" else mp["seed_len"]
        self.table = KmerTable(self.genome, K)

    def dp(self, pat, pen, w0):
        L = pat.shape[1]
        dev = self.genome.device
        text, tlen = windows(self.genome, w0, L + self.W - 1)
        return banded_score(torch.from_numpy(pat).to(dev),
                            torch.from_numpy(pen).to(dev), text, tlen,
                            self.W, self.sc).cpu().numpy()

    def own(self, codes, pen, rep_strand, rep_w0, phases) -> dict:
        """The reference's own candidates of each read: the windows that
        the configuration's seeding has to locate (``required_windows``)
        on the grids of ``phases``, each scored. Returns ``best`` (N,
        len(phases)), the best score on each grid, and ``second``, the
        best score on the first pass's grid (phase 0) at a locus distinct
        from the reported one (another strand, or a window start more
        than ``2 * max_dist`` away: the mapper's own rule)."""
        mp, dev = self.mp, self.genome.device
        N, L = codes.shape
        n = self.genome.shape[0]
        both = [oriented(codes, pen, np.full(N, r)) for r in (False, True)]
        P = torch.from_numpy(np.stack([b[0] for b in both], 1)).to(dev)
        PN = torch.from_numpy(np.stack([b[1] for b in both], 1)).to(dev)
        TW = L + self.W - 1
        neg = torch.full((N,), NEG, dtype=torch.int64, device=dev)
        best, second = [], neg.clone()
        rs = torch.from_numpy(rep_strand.astype(np.int64)).to(dev)
        rw = torch.from_numpy(rep_w0.astype(np.int64)).to(dev)
        for phase in phases:
            row, strand, w0 = required_windows(P, self.table, n, mp, phase)
            key = torch.unique((row * 2 + strand) * (n + 1) + w0)
            w0, rs2 = key % (n + 1), key // (n + 1)
            row, strand = rs2 // 2, rs2 % 2
            score = torch.cat([
                banded_score(P[row[c], strand[c]], PN[row[c], strand[c]],
                             *windows(self.genome, w0[c], TW),
                             self.W, self.sc)
                for c in torch.split(torch.arange(len(row), device=dev),
                                     1 << 17)] or [neg[:0]])
            best.append(neg.clone().scatter_reduce(0, row, score, "amax"))
            if phase == 0:
                far = (strand != rs[row]) | \
                    ((w0 - rw[row]).abs() > 2 * mp["max_dist"])
                second.scatter_reduce_(0, row[far], score[far], "amax")
        return dict(best=torch.stack(best, 1).cpu().numpy(),
                    second=second.cpu().numpy())

    def mate(self, s: dict, pre: str) -> dict:
        """Per-read verdicts of one mate's (or the single-end) results:
        the reference's score at the reported window and the walk."""
        codes, quals = s["codes" + pre[:-1]], s["quals" + pre[:-1]]
        L = codes.shape[1]
        pen = penalties(quals, self.sc)
        rev = s[pre + "strand"].astype(bool)
        pat, pn = oriented(codes, pen, rev)
        w0 = s[pre + "window_start"].astype(np.int64)
        ref = self.dp(pat, pn, w0)
        gpos = w0 + s[pre + "text_start"].astype(np.int64)
        score, nm, subs, ins, dels, walk_ok = walk(
            s[pre + "ops"], s[pre + "n_ops"], s[pre + "pattern_start"].astype(
                np.int64), s[pre + "pattern_end"].astype(np.int64), gpos, w0,
            pat, pn, self.genome_np, self.W, self.sc)
        return dict(ref=ref, score=score, nm=nm, subs=subs, ins=ins,
                    dels=dels, walk_ok=walk_ok, L=L, codes=codes, pen=pen)

    def origin(self, s: dict, pre: str, v: dict) -> tuple:
        """(score at the simulated origin, whether seeding must find the
        origin) of one mate."""
        k = pre[:-1]
        tpat, tpn = oriented(v["codes"], v["pen"], s["is_rc" + k].astype(bool))
        origin = s["origin" + k].astype(np.int64)
        tw0 = np.maximum(origin - self.mp["max_dist"], 0)
        return (self.dp(tpat, tpn, tw0),
                seeded(tpat, origin, self.genome, self.table, self.cfg))

    def mate_fields(self, s, pre, v, smin) -> dict:
        """The wrong fields of one mate by kind, a boolean row each."""
        mapped = s[pre + "mapped"].astype(bool)
        best = s[pre + "best_score"].astype(np.int64)
        bad = dict(
            mapped=mapped & (best < smin),
            score=mapped & (v["ref"] != best),
            walk=mapped & ~(v["walk_ok"] & (v["score"] == best)
                            & (v["nm"] == s[pre + "nm"])
                            & (s[pre + "pattern_start"] == 0)
                            & (s[pre + "pattern_end"] == v["L"])),
        )
        for k in ("subs", "ins", "dels"):
            if pre + k in s:
                bad["walk"] |= mapped & (v[k] != s[pre + k])
        bad["mapq_unmapped"] = ~mapped & (s[pre + "mapq"] != 0)
        return bad

    def single(self, s: dict) -> tuple[dict, dict]:
        v = self.mate(s, "")
        smin = score_min(v["L"], self.sc)
        bad = self.mate_fields(s, "", v, smin)
        mapped = s["mapped"].astype(bool)
        best = s["best_score"].astype(np.int64)
        second = s["second_score"].astype(np.int64)
        has2 = s["has_second"].astype(bool)
        bad["mapped"] |= ~mapped & (best >= smin)
        bad["second"] = mapped & ((second > best) | (has2 != (second >= smin)))
        want = mapq_v2(v["ref"], second, has2, smin)
        bad["mapq"] = mapped & (s["mapq"] != want)
        own = self.own(v["codes"], v["pen"], s["strand"], s["window_start"],
                       [0])
        best0 = own["best"][:, 0]
        return bad, dict(
            # a located locus scores above the reported alignment
            missed_seeded=(best0 >= smin) & (~mapped | (best < best0)),
            # a second best below one the reference locates
            missed_second=mapped & (own["second"] >= smin)
            & (second < own["second"]),
            n=len(best))

    def unplaced(self, u: dict) -> float:
        """``missed_reseed``: the share of the judged batches' reads left
        unmapped although a reseed pass's grid locates a window at or
        above the minimum score. ``u`` holds the codes and qualities of
        those batches' unmapped reads and the number of reads judged."""
        codes = u["codes"]
        if not len(codes):
            return 0.0
        L = codes.shape[1]
        n = len(codes)
        phases = grid_phases(self.mp)[1:]
        if not phases:
            return 0.0
        own = self.own(codes, penalties(u["quals"], self.sc),
                       np.zeros(n, bool), np.zeros(n, np.int64), phases)
        hit = own["best"].max(1) >= score_min(L, self.sc)
        return float(hit.sum()) / u["reads"]

    def paired(self, s: dict) -> tuple[dict, dict]:
        mp = self.mp
        v1, v2 = self.mate(s, "1."), self.mate(s, "2.")
        sm1, sm2 = score_min(v1["L"], self.sc), score_min(v2["L"], self.sc)
        b1 = self.mate_fields(s, "1.", v1, sm1)
        b2 = self.mate_fields(s, "2.", v2, sm2)
        bad = {f"{k}1": b1[k] for k in b1} | {f"{k}2": b2[k] for k in b2}
        m1, m2 = s["1.mapped"].astype(bool), s["2.mapped"].astype(bool)
        proper = s["p.proper"].astype(bool)
        w1 = s["1.window_start"].astype(np.int64)
        w2 = s["2.window_start"].astype(np.int64)
        st1, st2 = s["1.strand"].astype(bool), s["2.strand"].astype(bool)
        L1, L2, W = v1["L"], v2["L"], self.W
        r1 = s["p.rescued1"].astype(bool)
        r2 = s["p.rescued2"].astype(bool)
        # FR concordance on the two windows: the upstream mate forward,
        # the other reverse, the fragment inside [minins, maxins] with a
        # band of slack on each side
        endA = w2 + L2
        okA = ~st1 & st2 & (endA + W >= w1 + mp["minins"]) & \
            (endA <= w1 + mp["maxins"] + W)
        endB = w1 + L1
        okB = st1 & ~st2 & (endB + W >= w2 + mp["minins"]) & \
            (endB <= w2 + mp["maxins"] + W)
        # a rescued mate lies, on the other strand, in the window searched
        # beside its anchor: maxins + band bases from the forward anchor's
        # start, or ending band bases past the reverse anchor's end; its
        # banded re-alignment may reach a band past either edge
        RW = mp["maxins"] + W

        def in_rescue_window(wa, sta, La, gr, Lr):
            lo = np.where(sta, np.maximum(wa + La + W - RW, 0), wa)
            return (gr >= lo - W) & (gr + Lr <= lo + RW + W)

        g1 = w1 + s["1.text_start"].astype(np.int64)
        g2 = w2 + s["2.text_start"].astype(np.int64)
        resc_ok = (st1 != st2) & \
            np.where(r2, in_rescue_window(w1, st1, L1, g2, L2), True) & \
            np.where(r1, in_rescue_window(w2, st2, L2, g1, L1), True)
        resc_ok |= ~(r1 | r2)
        pair_score = s["p.pair_score"].astype(np.int64)
        bad["pair"] = proper & ~(m1 & m2 & (okA | okB | r1 | r2) & resc_ok
                                 & (pair_score == v1["ref"] + v2["ref"]))
        bad["rescued"] = (r1 | r2) & ~proper
        disc = s["p.discordant"].astype(bool)
        bad["discordant"] = disc & ~(~proper & m1 & m2
                                     & ~s["1.has_second"].astype(bool)
                                     & ~s["2.has_second"].astype(bool))
        bad["mapq_pair"] = proper & (s["1.mapq"] != s["2.mapq"])
        for pre, v, sm, m in (("1.", v1, sm1, m1), ("2.", v2, sm2, m2)):
            lone = m & ~proper & ~s[pre + "has_second"].astype(bool)
            want = mapq_v2(v["ref"], v["ref"], False, sm)
            bad["mapq" + pre[0]] = lone & (s[pre + "mapq"] != want)
        (tr1, sd1), (tr2, sd2) = self.origin(s, "1.", v1), \
            self.origin(s, "2.", v2)
        t1, t2 = sd1 & (tr1 >= sm1), sd2 & (tr2 >= sm2)
        miss1 = t1 & (~m1 | (~proper & (s["1.best_score"] < tr1)))
        miss2 = t2 & (~m2 | (~proper & (s["2.best_score"] < tr2)))
        pair_miss = t1 & t2 & (~proper | (pair_score < tr1 + tr2))
        return bad, dict(missed_seeded=np.concatenate([miss1 | pair_miss,
                                                       miss2 | pair_miss]),
                         n=2 * len(m1))

    def __call__(self, samples: dict, kind: str,
                 unplaced: dict | None = None) -> dict:
        """The numbers compared and the counts by kind of wrong field."""
        bad, truth = (self.paired if kind == "paired" else self.single)(
            samples)
        if unplaced is not None:
            truth["missed_reseed"] = np.float64(self.unplaced(unplaced))
        rows = np.zeros(len(next(iter(bad.values()))), bool)
        for b in bad.values():
            rows |= b
        examples = []
        for kind_, b in bad.items():
            for r in np.flatnonzero(b)[:2].tolist():
                examples.append(dict(kind=kind_, row=r, **{
                    k: v[r].tolist() for k, v in samples.items()
                    if v.ndim == 1}))
        return dict(wrong_fields=int(rows.sum()), examples=examples,
                    **{k: float(v.mean()) for k, v in truth.items()
                       if k != "n"},
                    sampled=int(truth["n"]),
                    kinds={k: int(b.sum()) for k, b in bad.items()})
