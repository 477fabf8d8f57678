"""``map --all`` of nvbio_tpu_torch on the CPU against ``nvbio_tpu map
--all`` on the same files: single-end and paired-end SAM records, on the
repeat genome of ``tests/test_torch_all.py``."""

import pytest
import torch

from tests.test_torch_all import L, all_dataset
from tests.test_torch_paired import _run

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

COMMON = ["--max-read-len", str(L), "--seed-len", "16", "--seed-stride",
          "10", "--batch", "40", "--max-dist", "5", "--all"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    recs, reads, (m1, m2) = all_dataset()
    d = tmp_path_factory.mktemp("all_cli")
    (d / "ref.fa").write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    for name, rs in (("se.fq", reads), ("r1.fq", m1), ("r2.fq", m2)):
        (d / name).write_text(
            "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in rs))
    r = _run("nvbio_tpu", ["index", "ref.fa", "idx", "-q", "10"], d)
    assert r.returncode == 0, r.stderr
    return d


def _records(path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("@")]


@pytest.mark.parametrize("reads", [["se.fq"], ["-1", "r1.fq", "-2", "r2.fq",
                                                "-X", "400"]],
                         ids=["se", "pe"])
def test_cli_all_matches_jax_cli(workdir, reads):
    tag = "pe" if "-1" in reads else "se"
    r = _run("nvbio_tpu", ["map", "idx", *reads, *COMMON, "-o",
                           f"jax_{tag}.sam"], workdir)
    assert r.returncode == 0, r.stderr
    r = _run("nvbio_tpu_torch", ["map", "idx", *reads, *COMMON, "-o",
                                 f"port_{tag}.sam", "--device", "cpu"],
             workdir)
    assert r.returncode == 0, r.stderr
    jrec = _records(workdir / f"jax_{tag}.sam")
    trec = _records(workdir / f"port_{tag}.sam")
    assert trec == jrec
    secondary = [ln for ln in trec if int(ln.split("\t")[1]) & 0x100]
    assert len(secondary) >= 10
    assert all(ln.split("\t")[9] == "*" for ln in secondary)
