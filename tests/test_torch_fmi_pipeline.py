"""Port parity of FM-index seeding (``seeding="fmi"``): nvbio_tpu_torch on
the CPU against nvbio_tpu's kernel path (Pallas in interpret mode, a batch
that is not a multiple of 1024) — single-end with the reseed pass and its
1-mismatch hybrid search, with the whole-read exact pass 0 on and off,
local, paired-end with rescue, ``--all`` single- and paired-end — field by
field and on SAM records; the port's records with a k-mer table attached
equal those without. The command line is in ``test_torch_fmi_cli.py``."""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alphabet import Alphabet
from nvbio_tpu.bowtie import paired as jpaired
from nvbio_tpu.bowtie import pipeline as jpipe
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.bowtie.pipeline import ReadMapper as JReadMapper
from nvbio_tpu.io.fastq import batch_from_records as j_batch
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.bowtie import paired as tpaired
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.bowtie.pipeline import ReadMapper as TReadMapper
from nvbio_tpu_torch.fmi.index import FMIndex, attach_ftab
from nvbio_tpu_torch.io.fastq import batch_from_records as t_batch
from nvbio_tpu_torch.io.reference import Reference as TReference
from tests.jax_kernel_path import kernel_path
from tests.test_torch_all import all_dataset
from tests.test_torch_paired import pair_dataset
from tests.test_torch_pipeline import _dataset as se_dataset

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

L = 80
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5, maxins=400, seeding="fmi")
# run -> (dataset, kind, MapParams overrides); every batch is 60-96 rows
RUNS = {
    "se": ("se", "se", {}),
    "se-no-pass0": ("se", "se", {"whole_read_exact": False}),
    "local": ("se", "se", {"local": True}),
    "pe": ("pe", "pe", {}),
    "se-all": ("all", "se-all", {}),
    "pe-all": ("all", "pe-all", {}),
}


@pytest.fixture(scope="module")
def datasets():
    recs, reads = se_dataset()
    prec, r1, r2 = pair_dataset()
    arec, areads, (m1, m2) = all_dataset()
    return {"se": (recs, (reads,)), "pe": (prec, (r1, r2)),
            "all": (arec, (areads,)), "all-pe": (arec, (m1, m2))}


def _data(datasets, run):
    ds, kind, _ = RUNS[run]
    return datasets["all-pe" if kind == "pe-all" else ds]


def _params(pkg, run):
    kw = {**PARAMS, **RUNS[run][2]}
    local = kw.pop("local", False)
    cls = JMapParams if pkg == "jax" else TMapParams
    if pkg == "jax":
        kw["extension"] = "pallas"
    return cls.local(**kw) if local else cls(**kw)


def _map(pkg, mapper, kind, reads):
    """(result tensors or arrays, SAM lines) of one run."""
    mk = j_batch if pkg == "jax" else t_batch
    b = [mk(r, L, Alphabet.DNA_N) for r in reads]
    if kind == "se":
        res = mapper.dispatch(b[0])
        return res, [r.line() for r in mapper.format_batch(b[0], res)]
    if pkg == "jax":
        args = (mapper.index, mapper.genome_words, mapper.n_genome_dev,
                *(jnp.asarray(x) for bb in b
                  for x in (bb.codes.astype(np.int32), bb.lengths,
                            bb.quals)), mapper.params)
    if kind == "se-all":
        res = (jpipe.align_batch_all(*args) if pkg == "jax"
               else mapper.dispatch_all(b[0]))
        return res, [r.line() for r in mapper.map_batch_all(b[0])]
    pmod = jpaired if pkg == "jax" else tpaired
    if kind == "pe-all":
        res = (jpaired.align_paired_all(*args) if pkg == "jax"
               else tpaired.dispatch_pair_batch_all(mapper, *b))
        return res, [r.line() for r in pmod.map_pair_batch_all(mapper, *b)]
    if pkg == "jax":
        res = jpaired.align_paired_core(*args)
        return res, [r.line() for r in jpaired.map_pair_batch(mapper, *b)]
    res = tpaired.dispatch_pair_batch(mapper, *b)
    return res, [r.line() for r in tpaired.format_pair_batch(mapper, *b, res)]


def _jax_run(datasets, run):
    recs, reads = _data(datasets, run)
    jm = JReadMapper.build(JReference.from_records(recs), _params("jax", run))
    return _map("jax", jm, RUNS[run][1], reads)


@pytest.fixture(scope="module")
def jax_runs(datasets):
    """Every run of the JAX kernel path, traced and compiled on parallel
    threads (compiling dominates them)."""
    with kernel_path(), ThreadPoolExecutor(len(RUNS)) as pool:
        futures = {r: pool.submit(_jax_run, datasets, r) for r in RUNS}
        return {r: f.result() for r, f in futures.items()}


@pytest.fixture(scope="module", params=sorted(RUNS))
def mapped(request, datasets, jax_runs):
    run = request.param
    recs, reads = _data(datasets, run)
    tm = TReadMapper.build(TReference.from_records(recs),
                           _params("torch", run), device="cpu")
    assert isinstance(tm.index, FMIndex) and tm.index.ftab_lo is None
    tres, tsam = _map("torch", tm, RUNS[run][1], reads)
    jres, jsam = jax_runs[run]
    return dict(run=run, mapper=tm, reads=reads, jres=jres, tres=tres,
                jsam=jsam, tsam=tsam)


def _fields_equal(td, jd, what):
    """Every field of the JAX result (nested dicts and tuples walked; op
    rows END->START in both, the kernel path's order) in the port's."""
    if isinstance(jd, (tuple, list)):
        for i, (t, j) in enumerate(zip(td, jd)):
            _fields_equal(t, j, f"{what}[{i}]")
        return
    assert set(jd) <= set(td), what
    for k in sorted(jd):
        if isinstance(jd[k], dict):
            _fields_equal(td[k], jd[k], f"{what}.{k}")
        else:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                          err_msg=f"{what}.{k}")


def test_results_field_by_field(mapped):
    run, jres, tres = mapped["run"], mapped["jres"], mapped["tres"]
    _fields_equal(tres, jres, run)
    kind = RUNS[run][1]
    if kind == "se":
        assert set(tres) == set(jres)
        assert int(jres["reseed_overflow"][0]) > 0  # the reseed queue filled
    elif kind == "pe":
        assert tres[2]["rescued2"].numpy().any()
    else:
        assert (tres["keep"].numpy().sum(axis=1) >= 2).sum() >= 5


def test_sam_identical(mapped):
    run, jsam, tsam = mapped["run"], mapped["jsam"], mapped["tsam"]
    assert tsam == jsam
    flags = [int(line.split("\t")[1]) for line in tsam]
    assert sum(not f & 4 for f in flags) >= len(mapped["reads"][0]) // 2
    if run == "se":
        # SNP-dense reads (a SNP in every seed window) map only through the
        # reseed pass's 1-mismatch hybrid search
        dense = [ln for i, ln in enumerate(tsam) if i % 6 == 4]
        assert any(not int(ln.split("\t")[1]) & 4 for ln in dense)
    if run.endswith("all"):
        assert any(f & 0x100 for f in flags)   # secondaries


@pytest.mark.parametrize("run", ["se", "pe", "local"])
def test_sam_identical_with_the_ftab(datasets, jax_runs, run):
    """The k-mer table changes where a search starts, not what it finds:
    the port's records with it attached (k = 6, a 16-base seed starts 6
    symbols in) equal the JAX package's, which never attaches it on the
    CPU."""
    recs, reads = _data(datasets, run)
    tm = TReadMapper.build(TReference.from_records(recs),
                           _params("torch", run), device="cpu")
    tm.index = attach_ftab(tm.index, k=6)
    _, tsam = _map("torch", tm, RUNS[run][1], reads)
    assert tsam == jax_runs[run][1]
