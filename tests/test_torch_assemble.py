"""Port parity of ``assemble`` (CPU): the k-mer scan (k = 15 and 25, with
N codes, low qualities and reference rows: validity equal, values equal
where valid), every ``DebruijnGraph`` field and dtype, ``k_best_haplotypes``
(scores bit for bit, codes, node counts; a cyclic region), ``haplotype_
support``, ``load_active_regions`` on SAM and BAM, and the CLI's FASTA,
``--dot`` and ``--support`` bytes, each against ``nvbio_tpu`` on the same
seeded inputs. All JAX calls share one dense shape, so the k-mer scan is
traced once per k."""

import dataclasses
import io
import os
import sys

import numpy as np
import pytest
import torch

from nvbio_tpu.__main__ import main as jmain
from nvbio_tpu.alphabet import codes_to_string
from nvbio_tpu.assembly import graph as jgraph
from nvbio_tpu.assembly import (build_debruijn_graph as j_build,
                                haplotype_support as j_support,
                                k_best_haplotypes as j_kbest,
                                load_active_regions as j_load)
from nvbio_tpu.io.output import open_alignment_output
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu.io.sam import SamRecord
from nvbio_tpu_torch import convert
from nvbio_tpu_torch.__main__ import main as tmain
from nvbio_tpu_torch.assembly import graph as tgraph
from nvbio_tpu_torch.assembly import (build_debruijn_graph as t_build,
                                      haplotype_support as t_support,
                                      k_best_haplotypes as t_kbest,
                                      load_active_regions as t_load)
from nvbio_tpu_torch.io.reference import Reference as TReference

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

G = 1400
REGIONS = ("--regions", "6", "--region-size", "200", "--start", "21")


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setattr(sys, "stderr", io.StringIO())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A contig with a 25-base repeat inside one region (a cycle at k=15),
    a second haplotype with a SNP every 90 bases, and 60-base reads from
    both (substitutions, N codes, qualities down to 2) as SAM and BAM."""
    d = tmp_path_factory.mktemp("asm")
    rng = np.random.default_rng(43)
    ref = rng.integers(0, 4, G, dtype=np.uint8)
    ref[700:725] = ref[650:675]
    alt = ref.copy()
    snps = np.arange(60, G, 90)
    alt[snps] = (alt[snps] + 1 + rng.integers(0, 3, len(snps))) % 4
    (d / "r.fa").write_text(">c1\n" + codes_to_string(ref) + "\n")
    recs = []
    for i in range(420):
        src = alt if i % 2 else ref
        p = int(rng.integers(0, G - 60))
        s = src[p:p + 60].copy()
        if i % 6 == 0:
            j = int(rng.integers(0, 60))
            s[j] = (s[j] + 1) % 4
        seq = codes_to_string(s)
        if i % 13 == 0:
            seq = seq[:25] + "N" + seq[26:]
        qual = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, 60))
        if i % 17 == 0:
            qual = "*"
        recs.append(SamRecord(f"r{i}", 0, "c1", p + 1, 60, "60M", seq, qual))
    recs.append(SamRecord("u", 4, "*", 0, 0, "*", "ACGT", "IIII"))
    recs.sort(key=lambda r: r.pos)
    for ext in ("sam", "bam"):
        with open_alignment_output(str(d / f"a.{ext}"), ["c1"], [G]) as w:
            for r in recs:
                w.write(r)
    jref = JReference.from_fasta(str(d / "r.fa"))
    dense = j_load(str(d / "a.sam"), jref, 6, 200, start_pos=20)
    return dict(dir=d, dense=dense)


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_load_active_regions_equals_jax(data, fmt):
    path = str(data["dir"] / f"a.{fmt}")
    fa = str(data["dir"] / "r.fa")
    want = j_load(path, JReference.from_fasta(fa), 6, 200, start_pos=20)
    got = t_load(path, TReference.from_fasta(fa), 6, 200, start_pos=20)
    assert [dataclasses.astuple(r) for r in want[0]] == \
        [dataclasses.astuple(r) for r in got[0]]
    for a, b in zip(want[1:], got[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(data["dense"][1:], got[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [15, 25])
def test_kmer_scan_equals_jax(data, k):
    _, codes, lengths, _, is_ref, quals = data["dense"]
    quals = quals.copy()
    quals[is_ref] = 0xFF
    assert (codes[:, :int(lengths.max())] == 4).any()       # N codes
    assert ((quals < 6) & ~is_ref[:, None]).any()           # low qualities
    jv, jok = jgraph._kmer_scan(codes, lengths, quals, k, 6)
    tv, tok = tgraph._kmer_scan(codes, lengths, quals, k, 6, "cpu")
    np.testing.assert_array_equal(jok, tok)
    np.testing.assert_array_equal(jv[jok], tv[tok])
    assert tv.dtype == jv.dtype and tok.any() and not tok.all()


@pytest.fixture(scope="module")
def graphs(data):
    _, codes, lengths, rid, is_ref, quals = data["dense"]
    out = {}
    for k, mc in ((15, 1), (11, 2)):
        out[k] = (j_build(codes, lengths, rid, is_ref, quals, k=k,
                          min_count=mc),
                  t_build(codes, lengths, rid, is_ref, quals, k=k,
                          min_count=mc, device="cpu"))
    return out


@pytest.mark.parametrize("k", [15, 11])
def test_graph_equals_jax(graphs, k):
    jg, tg = graphs[k]
    for f in dataclasses.fields(jg):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tg.cycle_flags.any() and not tg.cycle_flags.all()
    assert tg.to_dot(2) == jg.to_dot(2)


def _haps_equal(want, got):
    assert len(want) == len(got)
    for hw, hg in zip(want, got):
        assert [(h.region, h.n_nodes) for h in hw] == \
            [(h.region, h.n_nodes) for h in hg]
        np.testing.assert_array_equal(
            np.array([h.score for h in hw], np.float64),
            np.array([h.score for h in hg], np.float64))
        for a, b in zip(hw, hg):
            np.testing.assert_array_equal(a.codes, b.codes)
            assert str(a) == str(b)


@pytest.mark.parametrize("k_best", [8, 2])
def test_k_best_haplotypes_equal_jax(graphs, k_best):
    jg, tg = graphs[15]
    want = j_kbest(jg, k_best)
    # the JAX graph carried across, and the port's own graph
    _haps_equal(want, t_kbest(convert.debruijn_graph_from_arrays(
        **dataclasses.asdict(jg)), k_best))
    got = t_kbest(tg, k_best)
    _haps_equal(want, got)
    cyclic = np.flatnonzero(tg.cycle_flags)
    assert len(cyclic) and all(got[r] == [] for r in cyclic)
    assert max(len(h) for h in got) >= 2                 # variants assembled


@pytest.mark.parametrize("k", [10, 14])
def test_haplotype_support_equals_jax(data, graphs, k):
    _, codes, lengths, rid, is_ref, _ = data["dense"]
    jg, _ = graphs[15]
    haps = j_kbest(jg, 8)
    want = j_support(haps, codes, lengths, rid, is_ref, k=k)
    got = t_support(haps, codes, lengths, rid, is_ref, k=k)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert (a.region, a.n_reads) == (b.region, b.n_reads)
        for f in ("votes", "best_hap", "support"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert sum(int(s.support.sum()) for s in got if s is not None) > 0


@pytest.mark.parametrize("mode", ["fasta", "dot", "support", "kmer-11"])
@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_cli_bytes_equal_jax(data, fmt, mode):
    d = data["dir"]
    extra = {"fasta": [], "dot": ["--dot"], "support": ["--support"],
             "kmer-11": ["-k", "11", "--min-count", "2", "--k-best", "3",
                         "--support", "--support-k", "12"]}[mode]
    args = ["assemble", str(d / "r.fa"), str(d / f"a.{fmt}"), *REGIONS,
            *extra]
    jout, tout = str(d / f"j.{fmt}.{mode}"), str(d / f"t.{fmt}.{mode}")
    assert jmain(args + ["-o", jout]) == 0
    assert tmain(args + ["-o", tout, "--device", "cpu"]) == 0
    with open(jout, "rb") as f:
        want = f.read()
    with open(tout, "rb") as f:
        got = f.read()
    assert got == want
    assert want.startswith(b"digraph" if mode == "dot" else b">region0_21-220")


def test_assemble_needs_a_card_or_cpu(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d = data["dir"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(["assemble", str(d / "r.fa"), str(d / "a.sam"), "-o",
               os.devnull])
    _, codes, lengths, rid, is_ref, quals = data["dense"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build(codes, lengths, rid, is_ref, quals, k=15)
