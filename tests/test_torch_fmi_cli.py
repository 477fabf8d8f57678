"""Port parity of FM-index seeding through the command line (CPU):
``nvbio_tpu_torch map --seeding fmi --device cpu`` on a JAX ``index --fmi``
prefix (its ``.fmi.npz`` loaded), on the FASTA (the FM index built on the
fly) and with ``--config`` selecting FM seeding, against ``nvbio_tpu map
--seeding fmi``: identical SAM records."""

import os
import subprocess
import sys

import torch

from tests.test_torch_pipeline import _dataset as se_dataset

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 80


def _start(module, args, cwd):
    from tests.conftest import cpu_subprocess_env

    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=cwd,
                            env=cpu_subprocess_env(REPO), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _wait(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    return err


def _records(path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("@PG")]


def test_cli_seeding_fmi_matches_jax_cli(tmp_path):
    recs, reads = se_dataset(seed=11, n_reads=60)
    (tmp_path / "ref.fa").write_text(
        "".join(f">{n}\n{s}\n" for n, s in recs))
    (tmp_path / "reads.fq").write_text(
        "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    (tmp_path / "fmi.cfg").write_text("# FM seeding\nseeding=fmi\n")
    common = ["reads.fq", "--max-read-len", str(L), "--seed-len", "16",
              "--seed-stride", "10", "--batch", "32", "--max-dist", "5"]
    # the port's FASTA run needs no index: it starts beside the JAX index
    fasta = _start("nvbio_tpu_torch", ["map", "ref.fa", *common,
                                       "--seeding", "fmi", "-o",
                                       "port_fa.sam", "--device", "cpu"],
                   tmp_path)
    _wait(_start("nvbio_tpu", ["index", "ref.fa", "idx", "-q", "10",
                               "--fmi"], tmp_path))
    assert (tmp_path / "idx.fmi.npz").exists()
    runs = [_start("nvbio_tpu", ["map", "idx", *common, "--seeding", "fmi",
                                 "-o", "jax.sam"], tmp_path)]
    for out, extra in (("port.sam", ["--seeding", "fmi"]),
                       ("port_cfg.sam", ["--config", "fmi.cfg"])):
        runs.append(_start("nvbio_tpu_torch",
                           ["map", "idx", *common, *extra, "-o", out,
                            "--device", "cpu"], tmp_path))
    _wait(runs[0])
    for proc in (fasta, *runs[1:]):
        assert "seeding=fmi" in _wait(proc)
    want = _records(tmp_path / "jax.sam")
    assert sum(not ln.startswith("@") for ln in want) == len(reads)
    for out in ("port.sam", "port_fa.sam", "port_cfg.sam"):
        assert _records(tmp_path / out) == want, out
