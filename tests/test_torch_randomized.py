"""Port parity of randomized hit selection (``select_mode="randomized"``):
nvbio_tpu_torch on the CPU against nvbio_tpu's kernel path (Pallas in
interpret mode, a batch that is not a multiple of 1024), field by field and
on SAM records — single-end with the q-gram index, the Q-Group index and
the FM index (pass 0 on, and the reseed pass with its 1-mismatch seeding),
paired-end with rescue, and ``--all`` single- and paired-end on a genome
with repeats (wide seed ranges, so the SumTree draws pick among many
slots). The draws come from ``nvbio_tpu_torch.threefry``,
bit-equal to ``jax.random`` (``tests/test_torch_threefry.py``)."""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.bowtie.pipeline import ReadMapper as JReadMapper
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu.qgram import build_qgroup_index as j_build_qgroup
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.bowtie.pipeline import ReadMapper as TReadMapper
from nvbio_tpu_torch.io.reference import Reference as TReference
from nvbio_tpu_torch.qgram import QGroupIndex, build_qgroup_index
from tests.jax_kernel_path import kernel_path
from tests.test_torch_fmi_pipeline import _fields_equal, _map

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

L = 80
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5, maxins=400, select_mode="randomized")
QGROUP_Q = 12
# run -> (dataset, kind, MapParams overrides, index: None = the mapper's)
RUNS = {
    "se": ("se", "se", {}, None),
    "se-qgroup": ("se", "se", {}, "qgroup"),
    "se-fmi": ("se", "se", {"seeding": "fmi"}, None),
    "pe": ("pe", "pe", {}, None),
    "se-all": ("all", "se-all", {}, None),
    "pe-all": ("all", "pe-all", {}, None),
}


@pytest.fixture(scope="module")
def datasets():
    from tests.test_torch_all import all_dataset
    from tests.test_torch_paired import pair_dataset
    from tests.test_torch_pipeline import _dataset as se_dataset

    recs, reads = se_dataset()
    prec, r1, r2 = pair_dataset()
    arec, areads, (m1, m2) = all_dataset()
    return {"se": (recs, (reads,)), "pe": (prec, (r1, r2)),
            "all": (arec, (areads,)), "all-pe": (arec, (m1, m2))}


def _data(datasets, run):
    ds, kind, _, _ = RUNS[run]
    return datasets["all-pe" if kind == "pe-all" else ds]


def _params(pkg, run):
    kw = {**PARAMS, **RUNS[run][2]}
    if pkg == "jax":
        return JMapParams(**kw, extension="pallas")
    return TMapParams(**kw)


def _jax_run(datasets, run):
    recs, reads = _data(datasets, run)
    ref = JReference.from_records(recs)
    index = (j_build_qgroup(ref.codes, QGROUP_Q) if RUNS[run][3]
             else None)
    jm = JReadMapper.build(ref, _params("jax", run), index=index)
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
    ref = TReference.from_records(recs)
    index = (build_qgroup_index(ref.codes, QGROUP_Q) if RUNS[run][3]
             else None)
    tm = TReadMapper.build(ref, _params("torch", run), index=index,
                           device="cpu")
    assert isinstance(tm.index, QGroupIndex) == bool(RUNS[run][3])
    tres, tsam = _map("torch", tm, RUNS[run][1], reads)
    jres, jsam = jax_runs[run]
    return dict(run=run, reads=reads, jres=jres, tres=tres, jsam=jsam,
                tsam=tsam)


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
    if run.endswith("all"):
        assert any(f & 0x100 for f in flags)   # secondaries


def test_draws_differ_from_stratified_selection(datasets, jax_runs):
    """Randomized selection is a path of its own: the same reads under
    stratified selection place some read elsewhere or score it
    differently on the repeat genome."""
    recs, reads = _data(datasets, "se-all")
    tm = TReadMapper.build(TReference.from_records(recs),
                           TMapParams(**{**PARAMS,
                                         "select_mode": "stratified"}),
                           device="cpu")
    _, strat = _map("torch", tm, "se-all", reads)
    assert strat != jax_runs["se-all"][1]
