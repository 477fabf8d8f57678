"""Port parity of the paired-end mapper: nvbio_tpu_torch on the CPU against
nvbio_tpu's kernel path (K4 mate locate + K3 rescore, K2 tracebacks,
Pallas in interpret mode) — align_paired_core field by field and
map_pair_batch's SAM records under the fr, rf and ff policies and in local
mode — and the PE command line against ``nvbio_tpu map`` (no rescue).

In local mode the port's CIGARs carry the mates' soft clips, which the JAX
package leaves out; the records are otherwise identical."""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alphabet import Alphabet, codes_to_string
from nvbio_tpu.bowtie import paired as jpaired
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.bowtie.pipeline import ReadMapper as JReadMapper
from nvbio_tpu.io.fastq import batch_from_records as j_batch
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.bowtie import paired as tpaired
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.bowtie.pipeline import ReadMapper as TReadMapper
from nvbio_tpu_torch.io.fastq import batch_from_records as t_batch
from nvbio_tpu_torch.io.reference import Reference as TReference
from nvbio_tpu_torch.utils.simgenome import sample_pairs
from tests.jax_kernel_path import kernel_path

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 80
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5, maxins=400)
CONFIGS = {"fr": {}, "rf": {"pe_policy": "rf"}, "ff": {"pe_policy": "ff"},
           "local": {"local": True}}
KINDS = ("concordant", "concordant", "rescue-only", "half-mapped",
         "discordant")


def _rc(r):
    return (3 - r)[::-1]


def pair_dataset(seed=41, n_pairs=60):
    """Two contigs and FR pairs (fragments of 150-350 bp) of five kinds,
    by pair index mod 5: concordant (twice), rescue-only (mate 2 has a
    substitution every 10 bases, one in the 12-base q-gram key of every
    seed on either strand, so it has no candidate), half-mapped (mate 2 is
    random), discordant (mate 2 5-9 kbp from mate 1, opposite strand).
    Some mates carry a read N."""
    rng = np.random.default_rng(seed)
    G = 40000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    recs = [("c1", codes_to_string(codes[:22000])),
            ("c2", codes_to_string(codes[22000:]))]
    r1, r2, s1, _s2, rc1, _rc2 = sample_pairs(codes, n_pairs, L, 150, 350,
                                              seed=seed, subst_rate=0.01)
    reads1, reads2 = [], []
    for i in range(n_pairs):
        a, b = r1[i].copy(), r2[i].copy()
        kind = KINDS[i % 5]
        if kind == "rescue-only":
            b[9::10] = (b[9::10] + 1) % 4
        elif kind == "half-mapped":
            b = rng.integers(0, 4, L)
        elif kind == "discordant":
            p = int(np.clip(s1[i] + rng.integers(5000, 9000), 0, G - L))
            b = codes[p:p + L].astype(np.int32)
            b = b if rc1[i] else _rc(b)
        sa, sb = (codes_to_string(np.asarray(x, np.uint8)) for x in (a, b))
        if i % 7 == 0:
            sa = sa[:30] + "N" + sa[31:]
        qa, qb = ("".join(chr(33 + int(x)) for x in rng.integers(2, 41, L))
                  for _ in range(2))
        reads1.append((f"p{i}", sa, qa))
        reads2.append((f"p{i}", sb, qb))
    return recs, reads1, reads2


def _params(pkg, config, **extra):
    kw = {**PARAMS, **CONFIGS[config], **extra}
    local = kw.pop("local", False)
    if pkg == "jax":
        kw["extension"] = "pallas"
        cls = JMapParams
    else:
        cls = TMapParams
    return cls.local(**kw) if local else cls(**kw)


@pytest.fixture(scope="module")
def dataset():
    return pair_dataset()


def _jax_run(dataset, config):
    """The JAX kernel path's align_paired_core and SAM records."""
    recs, reads1, reads2 = dataset
    jm = JReadMapper.build(JReference.from_records(recs),
                           _params("jax", config))
    jb1, jb2 = (j_batch(r, L, Alphabet.DNA_N) for r in (reads1, reads2))
    jres = jpaired.align_paired_core(
        jm.index, jm.genome_words, jm.n_genome_dev,
        *(jnp.asarray(x) for b in (jb1, jb2)
          for x in (b.codes, b.lengths, b.quals)), jm.params)
    jsam = [r.line() for r in jpaired.map_pair_batch(jm, jb1, jb2)]
    return jres, jsam


@pytest.fixture(scope="module")
def jax_runs(dataset):
    """Every config's JAX run, traced and compiled on parallel threads
    (XLA compiles without the GIL; compiling dominates these runs)."""
    with kernel_path(), ThreadPoolExecutor(len(CONFIGS)) as pool:
        futures = {c: pool.submit(_jax_run, dataset, c) for c in CONFIGS}
        return {c: f.result() for c, f in futures.items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def mapped(request, dataset, jax_runs):
    recs, reads1, reads2 = dataset
    config = request.param
    jres, jsam = jax_runs[config]
    tm = TReadMapper.build(TReference.from_records(recs),
                           _params("torch", config), device="cpu")
    tb1, tb2 = (t_batch(r, L, Alphabet.DNA_N) for r in (reads1, reads2))
    tres = tpaired.dispatch_pair_batch(tm, tb1, tb2)
    tsam = [r.line() for r in tpaired.format_pair_batch(tm, tb1, tb2, tres)]
    return dict(config=config, jres=jres, tres=tres, jsam=jsam, tsam=tsam)


def test_align_paired_core_field_by_field(mapped):
    for jd, td, what in zip(mapped["jres"], mapped["tres"],
                            ("mate1", "mate2", "pairing")):
        clips = set() if what == "pairing" else {"pattern_start",
                                                 "pattern_end"}
        assert set(td) == set(jd) | clips, what
        for k in sorted(jd):   # ops too: both END->START (kernel path)
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                          err_msg=f"{what} {k}")
    pinfo = mapped["tres"][2]
    if mapped["config"] in ("fr", "local"):
        kinds = np.array([KINDS[i % 5] for i in range(len(pinfo["proper"]))])
        proper = pinfo["proper"].numpy()
        assert proper[kinds == "concordant"].mean() >= 0.9
        assert pinfo["rescued2"].numpy()[kinds == "rescue-only"].mean() >= 0.9
        assert pinfo["discordant"].numpy()[kinds == "discordant"].mean() >= 0.5
        assert not proper[kinds == "half-mapped"].any()


def _cigar_query_len(cigar):
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIS=X])", cigar))


def test_map_pair_batch_sam_identical(mapped):
    jsam, tsam = mapped["jsam"], mapped["tsam"]
    assert len(tsam) == len(jsam) == 2 * 60
    if mapped["config"] == "local":
        # identical but for the soft clips the port adds to the CIGAR
        n_clipped = 0
        for t, j in zip(tsam, jsam):
            tf, jf = t.split("\t"), j.split("\t")
            assert tf[:5] + tf[6:] == jf[:5] + jf[6:]
            assert re.sub(r"^\d+S|\d+S$", "", tf[5]) == jf[5]
            n_clipped += tf[5] != jf[5]
        assert n_clipped >= 5
    else:
        assert tsam == jsam
    for line in tsam:   # a mapped mate's CIGAR spans its SEQ
        f = line.split("\t")
        if f[5] != "*":
            assert _cigar_query_len(f[5]) == len(f[9]), line
    yts = {line.split("YT:Z:")[1][:2] for line in tsam if "YT:Z:" in line}
    if mapped["config"] in ("fr", "local"):      # the data's orientation
        flags = [int(line.split("\t")[1]) for line in tsam]
        assert sum(f & 0x2 != 0 for f in flags) >= 60      # proper pairs
        assert yts == {"CP", "DP", "UP"}


def _run(module, args, cwd):
    from tests.conftest import cpu_subprocess_env

    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=cpu_subprocess_env(REPO), capture_output=True,
                          text=True, timeout=600)


def test_pe_cli_matches_jax_cli(tmp_path, dataset):
    recs, reads1, reads2 = dataset
    (tmp_path / "ref.fa").write_text(
        "".join(f">{n}\n{s}\n" for n, s in recs))
    for name, reads in (("r1.fq", reads1), ("r2.fq", reads2)):
        (tmp_path / name).write_text(
            "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    r = _run("nvbio_tpu", ["index", "ref.fa", "idx", "-q", "10"], tmp_path)
    assert r.returncode == 0, r.stderr
    common = ["-1", "r1.fq", "-2", "r2.fq", "--max-read-len", str(L),
              "--seed-len", "16", "--seed-stride", "10", "--batch", "40",
              "--max-dist", "5", "-X", "400", "--no-rescue"]
    r = _run("nvbio_tpu", ["map", "idx", *common, "-o", "jax.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _run("nvbio_tpu_torch", ["map", "idx", *common, "-o", "port.sam",
                                 "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr

    def body(name):
        lines = (tmp_path / name).read_text().splitlines()
        return ([ln for ln in lines if ln.startswith("@SQ")],
                [ln for ln in lines if not ln.startswith("@")])

    jsq, jrec = body("jax.sam")
    tsq, trec = body("port.sam")
    assert len(jrec) == 2 * len(reads1)
    assert tsq == jsq
    assert trec == jrec


def test_paired_rescue_refuses_reads_over_128(tmp_path):
    """Mate rescue of reads over 128 bases, once refused, runs: the -1/-2
    command line at --max-read-len 150 with rescue on writes the records
    that map_pair_batch gives at that width (test_torch_rescue.py holds
    those against the JAX kernel path); only an unknown orientation policy
    is refused."""
    from nvbio_tpu_torch.__main__ import main

    tpaired.check_paired_supported(TMapParams(max_read_len=150), 150)
    with pytest.raises(ValueError, match="pe_policy"):
        tpaired.check_paired_supported(TMapParams(pe_policy="xx"), 150)
    recs, reads1, reads2 = pair_dataset(n_pairs=8)
    (tmp_path / "ref.fa").write_text(
        "".join(f">{n}\n{s}\n" for n, s in recs))
    for name, reads in (("r1.fq", reads1), ("r2.fq", reads2)):
        (tmp_path / name).write_text(
            "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    main(["map", str(tmp_path / "ref.fa"), "-1", str(tmp_path / "r1.fq"),
          "-2", str(tmp_path / "r2.fq"), "--max-read-len", "150",
          "--seed-len", "16", "--seed-stride", "10", "--batch", "8",
          "--max-dist", "5", "-X", "400", "-o", str(tmp_path / "out.sam"),
          "--device", "cpu"])
    got = [ln for ln in (tmp_path / "out.sam").read_text().splitlines()
           if not ln.startswith("@")]
    tm = TReadMapper.build(TReference.from_records(recs),
                           TMapParams(**{**PARAMS, "max_read_len": 150}),
                           device="cpu")
    b1, b2 = (t_batch(r, 150, Alphabet.DNA_N) for r in (reads1, reads2))
    want = [r.line() for r in tpaired.map_pair_batch(tm, b1, b2)]
    assert got == want and len(got) == 16
    # the rescue-only pairs (index 2 and 7 of 8) are rescued
    flags = [int(ln.split("\t")[1]) for ln in got]
    assert flags[2 * 2 + 1] & 0x2 and flags[2 * 7 + 1] & 0x2
