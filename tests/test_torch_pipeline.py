"""Port parity of the single-end mapper: nvbio_tpu_torch against nvbio_tpu
on the CPU — per-read result fields, SAM records, and the CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nvbio_tpu.alphabet import Alphabet, codes_to_string
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.bowtie.pipeline import ReadMapper as JReadMapper
from nvbio_tpu.io.fastq import batch_from_records as j_batch
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.bowtie.pipeline import ReadMapper as TReadMapper
from nvbio_tpu_torch.io.fastq import batch_from_records as t_batch
from nvbio_tpu_torch.io.reference import Reference as TReference

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 80
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5)


def _dataset(seed=5, n_reads=96):
    """Two contigs (one with an N run) and reads of six kinds: exact, 3
    SNPs, a 1 bp deletion, a 1 bp insertion, SNP-dense (a SNP in every seed
    window: only the 1-mismatch reseed pass maps them), random; some carry
    a read N; odd reads are reverse-complemented."""
    rng = np.random.default_rng(seed)
    G = 30000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    seq = codes_to_string(codes)
    seq = seq[:9000] + "N" * 40 + seq[9040:]
    recs = [("c1", seq[:18000]), ("c2", seq[18000:])]
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, G - L - 10))
        r = list(codes[p:p + L + 5])
        kind = i % 6
        if kind == 1:
            for m in rng.integers(0, L, 3):
                r[m] = (r[m] + 1) % 4
        elif kind == 2:
            del r[30]
        elif kind == 3:
            r.insert(40, 2)
        elif kind == 4:
            for m in range(5, 75, 9):
                r[m] = (r[m] + 1) % 4
        elif kind == 5:
            r = list(rng.integers(0, 4, L))
        s = codes_to_string(np.array(r[:L], np.uint8))
        if i % 7 == 0:
            s = s[:10] + "N" + s[11:]
        if i % 2:
            s = s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
        q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, L))
        reads.append((f"r{i}_{p}", s, q))
    return recs, reads


@pytest.fixture(scope="module")
def mapped():
    recs, reads = _dataset()
    out = {}
    for mode in ("sw", "ed"):
        if mode == "ed":
            jp = JMapParams.edit_distance(**{**PARAMS, "max_dist": 8})
            tp = TMapParams.edit_distance(**{**PARAMS, "max_dist": 8})
        else:
            jp, tp = JMapParams(**PARAMS), TMapParams(**PARAMS)
        jm = JReadMapper.build(JReference.from_records(recs), jp)
        tm = TReadMapper.build(TReference.from_records(recs), tp,
                               device="cpu")
        jb = j_batch(reads, L, Alphabet.DNA_N)
        tb = t_batch(reads, L, Alphabet.DNA_N)
        jres = {k: np.asarray(v) for k, v in jm.dispatch(jb).items()}
        tres = {k: v.numpy() for k, v in tm.dispatch(tb).items()}
        out[mode] = dict(
            jres=jres, tres=tres,
            jsam=[r.line() for r in jm.format_batch(jb, jm.dispatch(jb))],
            tsam=[r.line() for r in tm.format_batch(tb, tm.dispatch(tb))])
    return out


@pytest.mark.parametrize("mode", ["sw", "ed"])
def test_align_batch_core_field_by_field(mapped, mode):
    jres, tres = mapped[mode]["jres"], mapped[mode]["tres"]
    assert set(tres) == set(jres)
    for k in sorted(jres):
        if k == "ops":
            continue
        np.testing.assert_array_equal(tres[k], jres[k], err_msg=k)
    # ops: the JAX CPU path is forward-ordered, the kernel path END->START
    for b in range(len(jres["n_ops"])):
        n = int(jres["n_ops"][b])
        np.testing.assert_array_equal(tres["ops"][b, :n][::-1],
                                      jres["ops"][b, :n], err_msg=f"ops {b}")
    assert int(jres["reseed_overflow"][0]) > 0   # the reseed queue filled
    assert (jres["ins"] > 0).any() and (jres["dels"] > 0).any()


@pytest.mark.parametrize("mode", ["sw", "ed"])
def test_map_batch_sam_identical(mapped, mode):
    jsam, tsam = mapped[mode]["jsam"], mapped[mode]["tsam"]
    assert tsam == jsam
    flags = [int(line.split("\t")[1]) for line in tsam]
    assert sum(not f & 4 for f in flags) >= 60
    # SNP-dense reads (kind 4) map only through the 1-mismatch reseed pass
    dense = [line for i, line in enumerate(tsam) if i % 6 == 4]
    assert any(not int(line.split("\t")[1]) & 4 for line in dense)


def _run(module, args, cwd):
    from tests.conftest import cpu_subprocess_env

    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=cpu_subprocess_env(REPO), capture_output=True,
                          text=True, timeout=600)


def test_cli_map_matches_jax_cli(tmp_path):
    recs, reads = _dataset(seed=11, n_reads=60)
    (tmp_path / "ref.fa").write_text(
        "".join(f">{n}\n{s}\n" for n, s in recs))
    (tmp_path / "reads.fq").write_text(
        "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    r = _run("nvbio_tpu", ["index", "ref.fa", "idx", "-q", "10"], tmp_path)
    assert r.returncode == 0, r.stderr
    common = ["reads.fq", "--max-read-len", str(L), "--seed-len", "16",
              "--seed-stride", "10", "--batch", "32", "--max-dist", "5"]
    r = _run("nvbio_tpu", ["map", "idx", *common, "-o", "jax.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _run("nvbio_tpu_torch", ["map", "idx", *common, "-o", "port.sam",
                                 "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _run("nvbio_tpu_torch", ["map", "ref.fa", *common, "-o",
                                 "port_fa.sam", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr

    def body(name):
        lines = (tmp_path / name).read_text().splitlines()
        return ([ln for ln in lines if ln.startswith("@SQ")],
                [ln for ln in lines if not ln.startswith("@")])

    jsq, jrec = body("jax.sam")
    assert len(jrec) == len(reads)
    for name in ("port.sam", "port_fa.sam"):
        tsq, trec = body(name)
        assert tsq == jsq
        assert trec == jrec


def test_cli_rejects_what_is_not_ported(tmp_path):
    from nvbio_tpu_torch.__main__ import main

    # the multi-host flags are ported: a group without its coordinator
    # stops by name, and --dist with nothing configured is a
    # single-process run (it goes on to read the reference)
    for flag, what in ((["--num-processes", "2"], "coordinator"),
                       (["-1", "a.fq", "-2", "b.fq", "--dist"], "ref.fa")):
        with pytest.raises((SystemExit, FileNotFoundError), match=what):
            main(["map", "ref.fa", "reads.fq", *flag])
    # BAM output and .pac prefixes are ported: a prefix with neither
    # artifact stops by name
    with pytest.raises(SystemExit, match="nope.pac"):
        main(["map", str(tmp_path / "nope"), "reads.fq", "-o", "x.bam",
              "--device", "cpu"])
    # FM seeding and randomized hit selection are ported: an option file
    # that selects randomized selection maps as nvbio_tpu's CLI does, and
    # mappers of either seeding built with it write nvbio_tpu's records
    recs, reads = _dataset(seed=11, n_reads=30)
    (tmp_path / "ref.fa").write_text(
        "".join(f">{n}\n{s}\n" for n, s in recs))
    (tmp_path / "reads.fq").write_text(
        "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    (tmp_path / "rand.txt").write_text("select_mode=randomized\n")
    common = ["reads.fq", "--max-read-len", str(L), "--seed-len", "16",
              "--seed-stride", "10", "--batch", "32", "--max-dist", "5",
              "--config", "rand.txt", "--all"]
    r = _run("nvbio_tpu", ["map", "ref.fa", *common, "-o", "jax.sam"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    assert main(["map", str(tmp_path / "ref.fa"),
                 *(str(tmp_path / a) if a.endswith((".fq", ".txt")) else a
                   for a in common),
                 "-o", str(tmp_path / "port.sam"), "--device", "cpu"]) == 0

    def records(name):
        return [ln for ln in (tmp_path / name).read_text().splitlines()
                if not ln.startswith("@")]

    assert records("port.sam") == records("jax.sam")
    assert len(records("port.sam")) >= len(reads)
    for seeding in ("qgram", "fmi"):
        kw = {**PARAMS, "seeding": seeding, "select_mode": "randomized"}
        tm = TReadMapper.build(TReference.from_records(recs),
                               TMapParams(**kw), device="cpu")
        jm = JReadMapper.build(JReference.from_records(recs), JMapParams(**kw))
        tsam = [r.line() for r in tm.map_batch(t_batch(reads, L,
                                                       Alphabet.DNA_N))]
        jsam = [r.line() for r in jm.map_batch(j_batch(reads, L,
                                                       Alphabet.DNA_N))]
        assert tsam == jsam, seeding
    assert torch.device("cpu") == TReadMapper.build(
        TReference.from_records([("c", "ACGT" * 50)]),
        TMapParams(pe_full_traceback=True), device="cpu").device


def test_map_batch_sam_identical_on_repeat_rich_genome():
    """A repeat-rich genome with a 20 kbp tandem array (a 50 bp unit 400
    times): the array's q-gram buckets hold ~400 positions, so seeds of the
    reads drawn from it take the stratified sampler's wide-bucket branch
    (buckets over 128); the other half come from dispersed repeats and map.
    SAM records must be identical."""
    from nvbio_tpu_torch.utils.simgenome import repeat_rich_genome

    codes = repeat_rich_genome(1_300_000, seed=9)
    codes[1_250_000:1_270_000] = np.tile(codes[5000:5050], 400)
    recs = [("chrR", codes_to_string(codes))]
    rng = np.random.default_rng(12)
    reads = []
    for i in range(64):
        lo, hi = ((1_250_000, 1_269_900) if i % 2 else
                  (1_000_000, 1_240_000))
        p = int(rng.integers(lo, hi - L - 5))
        r = list(codes[p:p + L + 2])
        if i % 3 == 1:
            del r[25]
        for m in rng.integers(0, L, 2):
            r[m] = (r[m] + 1) % 4
        s = codes_to_string(np.array(r[:L], np.uint8))
        if i % 4 >= 2:
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append((f"q{i}_{p}", s, "I" * L))
    kw = {**PARAMS, "qgram_q": 8, "hits_per_seed": 16}
    jm = JReadMapper.build(JReference.from_records(recs), JMapParams(**kw))
    tm = TReadMapper.build(TReference.from_records(recs), TMapParams(**kw),
                           device="cpu")
    assert (np.diff(tm.index.offsets.numpy()) > 128).sum() >= 40
    jsam = [r.line() for r in jm.map_batch(j_batch(reads, L))]
    tsam = [r.line() for r in tm.map_batch(t_batch(reads, L))]
    assert tsam == jsam
    mapped = [not int(x.split("\t")[1]) & 4 for x in tsam]
    assert sum(mapped[0::2]) >= 24
