"""Port parity of the mapper's scan route (``extension="scan"``): the
port's ``ReadMapper`` on the CPU against ``nvbio_tpu``'s with
``extension="scan"`` (its engine off the accelerator: the aligner
library's banded scorer, scan traceback and, for mate rescue, the
full-matrix wavefront ``batch_score_full``; no Pallas kernel, no
interpret-mode rebinding) — single-end with q-gram and with FM seeding,
``--local``, paired-end with seedless mates (rescued by the wavefront),
the paired full-matrix traceback, ``--all`` single- and paired-end on a
genome with repeats — field by field (ops forward in both) and on SAM
records, which must be identical. ``extension="auto"`` and ``"pallas"``
keep the kernel route. The JAX runs are traced on parallel threads."""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alphabet import Alphabet
from nvbio_tpu.bowtie import paired as jpaired
from nvbio_tpu.bowtie import pipeline as jpipe
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.io.fastq import batch_from_records as j_batch
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.bowtie import paired as tpaired
from nvbio_tpu_torch.bowtie import pipeline as tpipe
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.io.fastq import batch_from_records as t_batch
from nvbio_tpu_torch.io.reference import Reference as TReference
from tests.test_torch_all import all_dataset
from tests.test_torch_paired import KINDS as PAIR_KINDS
from tests.test_torch_paired import pair_dataset
from tests.test_torch_pipeline import _dataset as se_dataset

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

L = 80
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5, maxins=400, extension="scan")
# run -> (dataset, kind, MapParams overrides)
RUNS = {
    "se": ("se", "se", {}),
    "se-fmi": ("se", "se", {"seeding": "fmi"}),
    "local": ("se", "se", {"local": True}),
    "pe": ("pe", "pe", {}),
    "pe-full": ("pe", "pe", {"pe_full_traceback": True}),
    "se-all": ("all", "se-all", {}),
    "pe-all": ("all-pe", "pe-all", {}),
}


@pytest.fixture(scope="module")
def datasets():
    recs, reads = se_dataset()
    prec, r1, r2 = pair_dataset()
    arec, areads, (m1, m2) = all_dataset()
    return {"se": (recs, (reads,)), "pe": (prec, (r1, r2)),
            "all": (arec, (areads,)), "all-pe": (arec, (m1, m2))}


def _params(pkg, run, **extra):
    kw = {**PARAMS, **RUNS[run][2], **extra}
    local = kw.pop("local", False)
    cls = JMapParams if pkg == "jax" else TMapParams
    return cls.local(**kw) if local else cls(**kw)


def _map(pkg, mapper, kind, reads):
    """(result tensors or arrays, SAM lines) of one run."""
    b = [(j_batch if pkg == "jax" else t_batch)(r, L, Alphabet.DNA_N)
         for r in reads]
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


def _torch_mapper(datasets, run, **extra):
    recs, reads = datasets[RUNS[run][0]]
    return tpipe.ReadMapper.build(TReference.from_records(recs),
                                  _params("torch", run, **extra),
                                  device="cpu"), reads


def _numpy(x):
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    return x.numpy()


def _jax_run(datasets, run):
    recs, reads = datasets[RUNS[run][0]]
    jm = jpipe.ReadMapper.build(JReference.from_records(recs),
                                _params("jax", run))
    assert not jpipe.use_pallas_extension(jm.params)
    return _map("jax", jm, RUNS[run][1], reads)


@pytest.fixture(scope="module")
def jax_runs(datasets):
    """Every run of the JAX scan route, traced and compiled on parallel
    threads (compiling dominates them)."""
    with ThreadPoolExecutor(len(RUNS)) as pool:
        futures = {r: pool.submit(_jax_run, datasets, r) for r in RUNS}
        return {r: f.result() for r, f in futures.items()}


@pytest.fixture(scope="module", params=sorted(RUNS))
def mapped(request, datasets, jax_runs):
    run = request.param
    tm, reads = _torch_mapper(datasets, run)
    assert not tpipe.use_pallas_extension(tm.params)
    tres, tsam = _map("torch", tm, RUNS[run][1], reads)
    jres, jsam = jax_runs[run]
    return dict(run=run, reads=reads, jres=jres, tres=tres, jsam=jsam,
                tsam=tsam)


def _fields_equal(td, jd, what):
    """Every field of the JAX result (nested dicts and tuples walked; op
    rows forward in both, the scan route's order) in the port's."""
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
        assert int(jres["reseed_overflow"][0]) > 0  # the reseed queue filled
        assert (jres["ins"] > 0).any() and (jres["dels"] > 0).any()
    elif kind == "pe":
        # the wavefront rescue places the seedless mates
        kinds = np.array([PAIR_KINDS[i % 5]
                          for i in range(len(tres[2]["proper"]))])
        rescued = tres[2]["rescued2"].numpy()
        assert rescued[kinds == "rescue-only"].mean() >= 0.9
    else:
        assert (tres["keep"].numpy().sum(axis=1) >= 2).sum() >= 5


def test_sam_identical(mapped):
    run, jsam, tsam = mapped["run"], mapped["jsam"], mapped["tsam"]
    assert tsam == jsam
    flags = [int(line.split("\t")[1]) for line in tsam]
    assert sum(not f & 4 for f in flags) >= len(mapped["reads"][0]) // 2
    if RUNS[run][1] == "se":
        # SNP-dense reads (a SNP in every seed window) map only through the
        # reseed pass's 1-mismatch search
        dense = [ln for i, ln in enumerate(tsam) if i % 6 == 4]
        assert any(not int(ln.split("\t")[1]) & 4 for ln in dense)
    if run.endswith("all"):
        assert any(f & 0x100 for f in flags)   # secondaries
    if run == "local":
        assert any("S" in ln.split("\t")[5] for ln in tsam)   # soft clips


@pytest.mark.parametrize("run", ["se", "pe"])
def test_auto_and_pallas_take_the_kernel_route(datasets, jax_runs, run):
    """``"auto"`` (the default) and ``"pallas"`` keep the kernel route: the
    same records and fields as each other, op rows END->START (the reverse
    of the scan route's where both routes pick the same alignment)."""
    out = {}
    for ext in ("auto", "pallas"):
        tm, reads = _torch_mapper(datasets, run, extension=ext)
        assert tpipe.use_pallas_extension(tm.params)
        out[ext] = _map("torch", tm, RUNS[run][1], reads)
    assert out["auto"][1] == out["pallas"][1]
    _fields_equal(out["auto"][0], _numpy(out["pallas"][0]), run)
    kernel = out["auto"][0] if run == "se" else out["auto"][0][0]
    scan = jax_runs[run][0] if run == "se" else jax_runs[run][0][0]
    same = ((kernel["n_ops"].numpy() == np.asarray(scan["n_ops"]))
            & (kernel["nm"].numpy() > 0))
    assert same.sum() >= 5
    for b in np.flatnonzero(same):
        n = int(scan["n_ops"][b])
        k_ops = kernel["ops"][b, :n].numpy()
        s_ops = np.asarray(scan["ops"][b, :n])
        if (k_ops[::-1] & 3).tolist() == (s_ops & 3).tolist():
            break
    else:
        pytest.fail("no alignment whose kernel-route ops reverse the scan's")
