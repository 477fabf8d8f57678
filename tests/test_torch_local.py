"""Port parity of the local-mode single-end mapper (bowtie2 --local):
nvbio_tpu_torch on the CPU against nvbio_tpu's kernel path (K3 LOCAL over
the candidates, K2-LOCAL traceback, Pallas in interpret mode) — per-read
result fields and SAM records."""

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
from tests.jax_kernel_path import kernel_path

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

L = 80
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5)


def local_dataset(seed=31, n_reads=90):
    """Two contigs and reads of six kinds: exact, 3 SNPs, a random 15-base
    tail on the genome-right end (soft-clipped), a random 12-base head, a
    1 bp deletion plus a tail, random; some carry a read N; odd reads are
    reverse-complemented."""
    rng = np.random.default_rng(seed)
    G = 30000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    seq = codes_to_string(codes)
    recs = [("c1", seq[:16000]), ("c2", seq[16000:])]
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, G - L - 10))
        r = list(codes[p:p + L + 5])
        kind = i % 6
        if kind == 1:
            for m in rng.integers(0, L, 3):
                r[m] = (r[m] + 1) % 4
        elif kind == 2:
            r[L - 15:L] = rng.integers(0, 4, 15)
        elif kind == 3:
            r[:12] = rng.integers(0, 4, 12)
        elif kind == 4:
            del r[35]
            r[L - 10:L] = rng.integers(0, 4, 10)
        elif kind == 5:
            r = list(rng.integers(0, 4, L))
        s = codes_to_string(np.array(r[:L], np.uint8))
        if i % 7 == 0:
            s = s[:20] + "N" + s[21:]
        if i % 2:
            s = s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
        q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, L))
        reads.append((f"l{i}_{p}", s, q))
    return recs, reads


@pytest.fixture(scope="module")
def mapped():
    recs, reads = local_dataset()
    jm = JReadMapper.build(JReference.from_records(recs),
                           JMapParams.local(**PARAMS, extension="pallas"))
    tm = TReadMapper.build(TReference.from_records(recs),
                           TMapParams.local(**PARAMS), device="cpu")
    jb = j_batch(reads, L, Alphabet.DNA_N)
    tb = t_batch(reads, L, Alphabet.DNA_N)
    with kernel_path():
        jdev = jm.dispatch(jb)
        jres = {k: np.asarray(v) for k, v in jdev.items()}
        jsam = [r.line() for r in jm.format_batch(jb, jdev)]
    tdev = tm.dispatch(tb)
    tres = {k: v.numpy() for k, v in tdev.items()}
    tsam = [r.line() for r in tm.format_batch(tb, tdev)]
    return dict(jres=jres, tres=tres, jsam=jsam, tsam=tsam)


def test_local_align_batch_core_field_by_field(mapped):
    jres, tres = mapped["jres"], mapped["tres"]
    assert set(tres) == set(jres)
    for k in sorted(jres):      # ops too: both END->START (kernel path)
        np.testing.assert_array_equal(tres[k], jres[k], err_msg=k)
    assert (tres["pattern_start"] > 0).any()       # clipped heads
    assert (tres["pattern_end"] < L).any()         # clipped tails


def test_local_map_batch_sam_identical(mapped):
    jsam, tsam = mapped["jsam"], mapped["tsam"]
    assert tsam == jsam
    recs = [line.split("\t") for line in tsam]
    mapped_recs = [r for r in recs if not int(r[1]) & 4]
    assert len(mapped_recs) >= 60
    assert sum("S" in r[5] for r in mapped_recs) >= 20   # soft clips
    assert len({int(r[4]) for r in mapped_recs}) >= 2    # local MAPQ values
