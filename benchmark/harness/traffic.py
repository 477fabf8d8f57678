"""The one read generator: Illumina-like reads with known truth, after
wgsim's error model, from the parameters of a traffic file.

Each read is cut from a haplotype of its own: polymorphisms at
``poly_rate`` a base, ``indel_frac`` of them indels (half insertions, half
deletions), the rest substitutions (wgsim ``-r``, ``-R``). An indel is
extended by one more base with probability ``indel_ext`` (wgsim ``-X``), up
to ``indel_max`` bases. Sequencing substitutions come on top at
``subst_rate`` a base (wgsim ``-e``). Phred qualities are drawn uniformly
in [``qual_lo``, ``qual_hi``]; wgsim gives every base the one quality
round(-10 log10 e) of its error rate, which a traffic file states as
``qual_lo == qual_hi``. ``rc_frac`` of the
reads come from the reverse strand.

``kind: "paired"`` makes FR pairs: fragments of normal length
(``frag_mean``, ``frag_sd``) clipped to [``frag_lo``, ``frag_hi``], mate A
the fragment's first ``read_len`` bases, mate B the reverse complement of
its last; in half the pairs mate 1 is the reverse one. In
``collapse_frac`` of the pairs mate 2 has a quality collapse: qualities in
[``collapse_qual_lo``, ``collapse_qual_hi``] and a substitution every
``collapse_period`` bases, so that it holds no exact seed of that length.

Everything is drawn on ``device`` with one ``torch.Generator`` seeded from
the run's seed, in a few large calls. Truth: ``origin`` is the forward
genome position the read's source starts at, ``is_rc`` its strand.
"""

from __future__ import annotations

import numpy as np
import torch


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of a run's seed (any whole
    number, also past 32 bits)."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Gen:
    """A device generator and the draws the model needs."""

    def __init__(self, seed: int, stream: int, device):
        self.dev = torch.device(device)
        self.g = torch.Generator(device=self.dev)
        self.g.manual_seed(torch_seed(seed, stream))

    def rand(self, *shape):
        return torch.rand(shape, generator=self.g, device=self.dev)

    def randint(self, lo: int, hi: int, *shape):
        """Integers in [lo, hi)."""
        return torch.randint(lo, hi, shape, generator=self.g, device=self.dev)

    def normal(self, mean: float, sd: float, *shape):
        return torch.normal(mean, sd, shape, generator=self.g,
                            device=self.dev)


def haplotype_reads(genome, starts, tr: dict, gen: Gen):
    """Reads of ``read_len`` bases in forward genome orientation, each from
    its own haplotype of the genome at ``starts`` (polymorphisms only, no
    sequencing errors yet). Returns (codes (n, L) int64, origin (n,)
    int64)."""
    n = starts.shape[0]
    L = int(tr["read_len"])
    dmax = int(tr["indel_max"])
    ar = torch.arange(L, device=gen.dev)
    poly = gen.rand(n, L) < tr["poly_rate"]
    indel = poly & (gen.rand(n, L) < tr["indel_frac"])
    snp = poly & ~indel
    ins = indel & (gen.rand(n, L) < 0.5)
    dele = indel & ~ins
    ext = gen.rand(n, L, dmax - 1) < tr["indel_ext"]
    ilen = 1 + torch.cumprod(ext.to(torch.int64), 2).sum(2)
    ins_len = torch.where(ins, ilen, 0)
    inserted = torch.zeros((n, L), dtype=torch.bool, device=gen.dev)
    for t in range(dmax):
        inserted[:, t:] |= ins_len[:, :L - t] > t
    # reference offset of read base j: j, less the bases inserted up to j,
    # plus the bases deleted before it
    off = (ar[None, :] - torch.cumsum(inserted.to(torch.int64), 1)
           + torch.cumsum(torch.where(dele, ilen, 0), 1))
    span = L + 4 * dmax
    off = off.clamp(0, span - 1)
    codes = genome[(starts[:, None] + off)].to(torch.int64)
    codes = torch.where(snp, (codes + gen.randint(1, 4, n, L)) % 4, codes)
    codes = torch.where(inserted, gen.randint(0, 4, n, L), codes)
    origin = starts + torch.where(inserted[:, 0], 0, off[:, 0])
    return codes, origin


def sequence(codes, tr: dict, gen: Gen):
    """Sequencing substitutions and qualities of reads in read order."""
    n, L = codes.shape
    err = gen.rand(n, L) < tr["subst_rate"]
    codes = torch.where(err, (codes + gen.randint(1, 4, n, L)) % 4, codes)
    quals = gen.randint(int(tr["qual_lo"]), int(tr["qual_hi"]) + 1, n, L)
    return codes, quals


def revcomp(codes):
    return (3 - codes).flip(1)


def single_batch(genome, tr: dict, gen: Gen) -> dict:
    """One batch of single-end reads: host arrays codes, quals (uint8),
    origin (int64), is_rc (bool)."""
    n = int(tr["batch"])
    L = int(tr["read_len"])
    span = L + 4 * int(tr["indel_max"])
    starts = gen.randint(0, genome.shape[0] - span, n)
    fwd, origin = haplotype_reads(genome, starts, tr, gen)
    is_rc = gen.rand(n) < tr["rc_frac"]
    codes = torch.where(is_rc[:, None], revcomp(fwd), fwd)
    codes, quals = sequence(codes, tr, gen)
    return host(dict(codes=codes, quals=quals, origin=origin, is_rc=is_rc))


def paired_batch(genome, tr: dict, gen: Gen) -> dict:
    """One batch of FR pairs: per mate k in (1, 2) host arrays codes<k>,
    quals<k>, origin<k>, is_rc<k>, and collapsed (bool) for mate 2."""
    n = int(tr["batch"])
    L = int(tr["read_len"])
    span = L + 4 * int(tr["indel_max"])
    frag = gen.normal(float(tr["frag_mean"]), float(tr["frag_sd"]), n)
    frag = frag.round().clamp(int(tr["frag_lo"]), int(tr["frag_hi"])).to(
        torch.int64)
    fs = gen.randint(0, genome.shape[0] - int(tr["frag_hi"]) - span, n)
    left, o_left = haplotype_reads(genome, fs, tr, gen)
    right, o_right = haplotype_reads(genome, fs + frag - L, tr, gen)
    right = revcomp(right)
    flip = gen.rand(n) < 0.5
    r1 = torch.where(flip[:, None], right, left)
    r2 = torch.where(flip[:, None], left, right)
    out = dict(origin1=torch.where(flip, o_right, o_left),
               origin2=torch.where(flip, o_left, o_right),
               is_rc1=flip, is_rc2=~flip)
    out["codes1"], out["quals1"] = sequence(r1, tr, gen)
    c2, q2 = sequence(r2, tr, gen)
    collapsed = gen.rand(n) < tr["collapse_frac"]
    period = int(tr["collapse_period"])
    hit = (torch.arange(L, device=gen.dev) % period) == period - 1
    kill = collapsed[:, None] & hit[None, :]
    c2 = torch.where(kill, (c2 + gen.randint(1, 4, n, L)) % 4, c2)
    q2 = torch.where(collapsed[:, None],
                     gen.randint(int(tr["collapse_qual_lo"]),
                                 int(tr["collapse_qual_hi"]) + 1, n, L), q2)
    out["codes2"], out["quals2"], out["collapsed"] = c2, q2, collapsed
    return host(out)


def host(arrays: dict) -> dict:
    """Device tensors to host numpy: codes and quals as uint8."""
    out = {}
    for k, v in arrays.items():
        if k.startswith(("codes", "quals")):
            v = v.to(torch.uint8)
        out[k] = v.cpu().numpy()
    return out


def make_pool(genome_np: np.ndarray, tr: dict, seed: int, device) -> list:
    """The ``pool_batches`` distinct batches that the window cycles
    through, made on ``device`` from the run's seed."""
    gen = Gen(seed, 0x7EAD, device)
    genome = torch.from_numpy(genome_np).to(gen.dev)
    make = paired_batch if tr["kind"] == "paired" else single_batch
    pool = [make(genome, tr, gen) for _ in range(int(tr["pool_batches"]))]
    del genome
    return pool
