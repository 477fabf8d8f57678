"""Port parity of the full-matrix traceback (K2 at band T+M, the port's
K2-WIDE): ``batch_traceback_full`` against nvbio_tpu's with the Pallas
kernel in interpret mode, the paired-end mapper with
``pe_full_traceback=True`` against the JAX kernel path (fr and local,
field by field and SAM records). Integer outputs: exactly equal. (``map
--config`` setting it: ``tests/test_torch_options.py``.)

In local mode the port's CIGARs carry the mates' soft clips, which the JAX
package leaves out; the records are otherwise identical."""

import re
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.align.traceback import batch_traceback_full as j_full
from nvbio_tpu.align.types import GotohScoring as JScoring
from nvbio_tpu.alphabet import Alphabet
from nvbio_tpu.bowtie import paired as jpaired
from nvbio_tpu.bowtie.pipeline import ReadMapper as JReadMapper
from nvbio_tpu.io.fastq import batch_from_records as j_batch
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.traceback import batch_traceback_full as t_full
from nvbio_tpu_torch.align.traceback import cigar_to_string
from nvbio_tpu_torch.align.types import GotohScoring
from nvbio_tpu_torch.bowtie import paired as tpaired
from nvbio_tpu_torch.bowtie.pipeline import ReadMapper as TReadMapper
from nvbio_tpu_torch.io.fastq import batch_from_records as t_batch
from nvbio_tpu_torch.io.reference import Reference as TReference
from tests.jax_kernel_path import kernel_path
from tests.test_torch_paired import L, _params, pair_dataset

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

SEMI = (0, -3, -5, -1, -5, -1)      # tests/test_align.py's full-matrix case
LOCAL = (2, -6, -8, -3, -8, -3)     # bowtie2 --local
TB_FIELDS = ("score", "ops", "n_ops", "pattern_start", "pattern_end",
             "text_start", "text_end")
CONFIGS = ("fr", "local")


def _full_inputs(rng):
    """tests/test_align.py's construction (B=16, M=70, T=150): even rows
    carry a 25 bp deletion far outside any practical band, odd rows an
    offset copy with two mismatches; one short pattern and one short text."""
    B, M, T = 16, 70, 150
    texts = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    pats = np.zeros((B, M), np.int32)
    for b in range(B):
        if b % 2 == 0:
            seg = np.concatenate([texts[b, 10:10 + 35],
                                  texts[b, 70:70 + M - 35]])
        else:
            seg = texts[b, 30:30 + M].copy()
            seg[5] = (seg[5] + 1) % 4
            seg[40] = (seg[40] + 2) % 4
        pats[b] = seg[:M]
    plens = np.full(B, M, np.int32)
    tlens = np.full(B, T, np.int32)
    plens[-1], tlens[-3] = M - 9, T - 40
    mm = -rng.integers(2, 7, size=(B, M)).astype(np.int32)
    return pats, plens, texts, tlens, mm


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("with_mm", [False, True])
def test_batch_traceback_full_matches_pallas_interpret(rng, local, with_mm):
    pats, plens, texts, tlens, mm = _full_inputs(rng)
    sc = LOCAL if local else SEMI
    want, want_nm = j_full(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(texts),
        jnp.asarray(tlens), JScoring(*sc),
        jnp.asarray(mm) if with_mm else None, interpret=True, local=local)
    got, got_nm = t_full(
        torch.from_numpy(pats), torch.from_numpy(plens),
        torch.from_numpy(texts), torch.from_numpy(tlens), GotohScoring(*sc),
        torch.from_numpy(mm) if with_mm else None, local=local)
    for name in TB_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got_nm.numpy(), np.asarray(want_nm))
    assert got.ops.shape == (16, (70 + 220 + 7) // 8 * 8)   # band T+M=220
    assert K.banded_traceback_wide.launches == 0
    cig = [cigar_to_string(got.ops[b].numpy(), int(got.n_ops[b]),
                           reverse=True) for b in range(16)]
    if not local:   # the 25 bp deletion, far outside any practical band
        assert all("25D" in c for c in cig[0:14:2]), cig
        assert (got.text_start.numpy()[1:14:2] == 30).all()


def _jax_run(dataset, config):
    recs, reads1, reads2 = dataset
    jm = JReadMapper.build(JReference.from_records(recs),
                           _params("jax", config, pe_full_traceback=True))
    jb1, jb2 = (j_batch(r, L, Alphabet.DNA_N) for r in (reads1, reads2))
    jres = jpaired.align_paired_core(
        jm.index, jm.genome_words, jm.n_genome_dev,
        *(jnp.asarray(x) for b in (jb1, jb2)
          for x in (b.codes, b.lengths, b.quals)), jm.params)
    jsam = [r.line() for r in jpaired.map_pair_batch(jm, jb1, jb2)]
    return jres, jsam


@pytest.fixture(scope="module")
def dataset():
    return pair_dataset()


@pytest.fixture(scope="module")
def jax_runs(dataset):
    with kernel_path(), ThreadPoolExecutor(len(CONFIGS)) as pool:
        futures = {c: pool.submit(_jax_run, dataset, c) for c in CONFIGS}
        return {c: f.result() for c, f in futures.items()}


@pytest.fixture(scope="module", params=CONFIGS)
def mapped(request, dataset, jax_runs):
    recs, reads1, reads2 = dataset
    jres, jsam = jax_runs[request.param]
    tm = TReadMapper.build(
        TReference.from_records(recs),
        _params("torch", request.param, pe_full_traceback=True),
        device="cpu")
    tb1, tb2 = (t_batch(r, L, Alphabet.DNA_N) for r in (reads1, reads2))
    tres = tpaired.dispatch_pair_batch(tm, tb1, tb2)
    tsam = [r.line() for r in tpaired.format_pair_batch(tm, tb1, tb2, tres)]
    return dict(config=request.param, jres=jres, tres=tres, jsam=jsam,
                tsam=tsam)


def test_full_traceback_pe_core_field_by_field(mapped):
    for jd, td, what in zip(mapped["jres"], mapped["tres"],
                            ("mate1", "mate2", "pairing")):
        for k in sorted(jd):
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                          err_msg=f"{what} {k}")
    # the band is T+M: each mate's op row is round8(M + (L+W-1) + M) wide
    assert mapped["tres"][0]["ops"].shape[1] == (3 * L + 11 - 1 + 7) // 8 * 8
    assert mapped["tres"][2]["proper"].numpy().mean() >= 0.5


def _cigar_query_len(cigar):
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIS=X])", cigar))


def test_full_traceback_pe_sam_identical(mapped):
    jsam, tsam = mapped["jsam"], mapped["tsam"]
    assert len(tsam) == len(jsam) == 120
    if mapped["config"] == "local":   # all but the port's soft clips
        for t, j in zip(tsam, jsam):
            tf, jf = t.split("\t"), j.split("\t")
            assert tf[:5] + tf[6:] == jf[:5] + jf[6:]
            assert re.sub(r"^\d+S|\d+S$", "", tf[5]) == jf[5]
    else:
        assert tsam == jsam
    for line in tsam:
        f = line.split("\t")
        if f[5] != "*":
            assert _cigar_query_len(f[5]) == len(f[9]), line
