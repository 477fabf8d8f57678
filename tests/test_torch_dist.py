"""The port's multi-process runtime (``nvbio_tpu_torch.parallel.dist``),
``map --dist`` and the worker, on the CPU.

The single-process helpers as ``tests/test_parallel.py`` holds the JAX
package's (no group configured: ``init_distributed()`` is False, the
stripes, the shard paths), ``merge_sam_shards`` byte for byte against
``nvbio_tpu.parallel.dist.merge_sam_shards``. Then real process groups,
all started at once: ``python -m nvbio_tpu_torch map ... --dist`` as two
gloo processes (``--coordinator``/``--num-processes``/``--process-id``,
``--device cpu``), whose merged SAM equals ``nvbio_tpu map``'s
single-process records in stripe order (rank 0's batches, then rank 1's);
the same run with ``-o x.bam``, which ends as SAM text in ``x.bam`` (the
JAX package writes a shard by its ``.shardNNNN`` name, so as SAM, and
concatenates text); and the worker (``-m nvbio_tpu_torch.parallel.worker``,
two ranks, with the dry run)."""

import json
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from nvbio_tpu.parallel import dist as jdist
from nvbio_tpu_torch.parallel import dist as tdist
from tests.test_torch_pipeline import L, _dataset

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BATCH = 16
N_READS = 64            # 4 batches: rank 0 maps 0 and 2, rank 1 maps 1 and 3
ARGS = ["ref.fa", "reads.fq", "--max-read-len", str(L), "--seed-len", "16",
        "--seed-stride", "10", "--max-dist", "5", "--batch", str(BATCH)]


def test_single_process_helpers(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.init_distributed() is False
    assert tdist.process_index() == 0 and tdist.process_count() == 1
    assert list(tdist.host_stripe(range(10))) == list(range(10))
    for pid in range(3):
        assert list(tdist.host_stripe(range(10), pid, 3)) == \
            list(jdist.host_stripe(range(10), pid, 3))
    assert list(tdist.host_stripe(range(10), 1, 3)) == [1, 4, 7]
    assert tdist.shard_path("out.sam", 7) == jdist.shard_path("out.sam", 7) \
        == "out.sam.shard0007"
    assert tdist.shard_path("out.sam") == "out.sam.shard0000"
    with pytest.raises(ValueError, match="number of processes"):
        tdist.init_distributed("127.0.0.1:1")
    # a text too long for one q-gram index points at the sharded one
    from nvbio_tpu_torch.qgram import position_dtype

    with pytest.raises(ValueError, match="parallel.sharded_index"):
        position_dtype(1 << 32)


def test_merge_sam_shards_bytes(tmp_path):
    header = "@HD\tVN:1.6\n@SQ\tSN:ref\tLN:100\n"
    bodies = ["r0\t0\tref\t1\t60\t4M\t*\t0\t0\tACGT\tIIII\n" * 3,
              "", "r9\t16\tref\t5\t1\t4M\t*\t0\t0\tACGT\tIIII\n"]
    paths = []
    for i, body in enumerate(bodies):
        p = tmp_path / f"s{i}.sam"
        p.write_text(header + body)
        paths.append(str(p))
    n_t = tdist.merge_sam_shards(paths, str(tmp_path / "t.sam"))
    n_j = jdist.merge_sam_shards(paths, str(tmp_path / "j.sam"))
    assert n_t == n_j == 4
    assert (tmp_path / "t.sam").read_bytes() == \
        (tmp_path / "j.sam").read_bytes()
    assert tdist.merge_sam_shards(paths, str(tmp_path / "r.sam"),
                                  remove=True) == 4
    assert not any(pathlib.Path(p).exists() for p in paths)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    from tests.conftest import cpu_subprocess_env

    return {**cpu_subprocess_env(str(REPO)), "OMP_NUM_THREADS": "1"}


def _start(args, cwd):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _dist_map(out, cwd):
    coord = f"127.0.0.1:{_free_port()}"
    return [_start(["nvbio_tpu_torch", "map", *ARGS, "-o", out, "--device",
                    "cpu", "--dist", "--coordinator", coord,
                    "--num-processes", "2", "--process-id", str(r)], cwd)
            for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process of the file's runs, started together: the JAX CLI,
    two 2-process ``map --dist`` runs (SAM and .bam output) and the 2-rank
    worker. Returns the directory and each run's (rc, stdout, stderr)."""
    d = tmp_path_factory.mktemp("dist")
    recs, reads = _dataset(seed=21, n_reads=N_READS)
    (d / "ref.fa").write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    (d / "reads.fq").write_text(
        "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    coord = f"127.0.0.1:{_free_port()}"
    procs = {
        "jax": [_start(["nvbio_tpu", "map", *ARGS, "-o", "jax.sam"], d)],
        "sam": _dist_map("dist.sam", d),
        "bam": _dist_map("dist.bam", d),
        "worker": [_start(["nvbio_tpu_torch.parallel.worker", "--outdir",
                           "work", "--device", "cpu", "--dryrun",
                           "--coordinator", coord, "--num-processes", "2",
                           "--process-id", str(r)], d) for r in range(2)],
    }
    out = {}
    for name, ps in procs.items():
        out[name] = []
        for p in ps:
            so, se = p.communicate(timeout=600)
            out[name].append((p.returncode, so, se))
    return d, out


def _records(path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("@")]


def _stripe_order(records):
    """Single-process records reordered as the merge writes them: rank 0's
    batches (0, 2, ...), then rank 1's (1, 3, ...)."""
    batches = [records[i:i + BATCH] for i in range(0, len(records), BATCH)]
    return [r for rank in range(2) for b in batches[rank::2] for r in b]


@pytest.mark.parametrize("out", ["sam", "bam"])
def test_dist_map_merges_in_stripe_order(runs, out):
    d, res = runs
    for rc, _, se in res["jax"] + res[out]:
        assert rc == 0, se
    want = _stripe_order(_records(d / "jax.sam"))
    assert len(want) == N_READS
    merged = d / f"dist.{out}"
    text = merged.read_text()        # .bam too: SAM text, as in JAX
    assert text.startswith("@HD") and text.count("@HD") == 1
    assert _records(merged) == want
    assert not list(d.glob(f"dist.{out}.shard*"))
    assert "merged 2 SAM shards" in res[out][0][2]
    assert sum(not int(r.split("\t")[1]) & 4 for r in want) >= N_READS // 2


def test_worker_end_to_end(runs):
    d, res = runs
    for rank, (rc, so, se) in enumerate(res["worker"]):
        assert rc == 0, se
        assert f"[{rank}] DISTRIBUTED_OK mapped=64/64 procs=2" in so
    info = json.loads((d / "work" / "DIST.json").read_text())
    assert info["verified"] and info["records"] == 64
    dry = info["dryrun"]
    assert dry["se_sharded_qgram"] == dry["se"]
    assert dry["se_sharded_fmi"]["n_mapped"] == 16
    assert dry["pe"]["n_proper"] >= 15
    assert len(_records(d / "work" / "out.sam")) == 64
