"""The port stands alone: it imports neither JAX nor nvbio_tpu, runs on
CUDA unless asked for the CPU, and its kernel wrappers take their plain
versions only for CPU tensors."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import GotohScoring
from nvbio_tpu_torch.bowtie.params import MapParams
from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
from nvbio_tpu_torch.device import resolve_device
from nvbio_tpu_torch.io.reference import Reference

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import nvbio_tpu_torch
for m in pkgutil.walk_packages(nvbio_tpu_torch.__path__, "nvbio_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke  # noqa: F401  (module import only; main() is not run)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "nvbio_tpu" or k.startswith("nvbio_tpu."))
n = sum(k.startswith("nvbio_tpu_torch") for k in sys.modules)
print(n, bad)
"""


def test_importing_the_port_loads_no_jax_and_no_nvbio_tpu():
    from tests.conftest import cpu_subprocess_env

    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       env=cpu_subprocess_env(str(REPO)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.split(" ", 1)
    assert int(n) >= 20          # every module of the port was imported
    assert bad.strip() == "[]"


_SHARDED_PROBE = r"""
import importlib, os, sys, tempfile
for m in ("parallel", "parallel.mesh", "parallel.sharded_index",
          "parallel.dist", "parallel.dryrun", "parallel.worker",
          "fmi.sharded"):
    importlib.import_module("nvbio_tpu_torch." + m)
for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    os.environ.pop(v, None)
from nvbio_tpu_torch.parallel import worker
try:  # the entry point's imports run before it finds no process group
    worker.main(["--outdir", tempfile.mkdtemp(), "--device", "cpu"])
except SystemExit as e:
    print("exit:", e)
print(sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "nvbio_tpu" or k.startswith("nvbio_tpu.")))
"""


def test_sharded_modules_and_worker_load_no_jax():
    """The multi-GPU modules and the worker's entry point, run as far as
    its process-group check, load neither JAX nor nvbio_tpu."""
    from tests.conftest import cpu_subprocess_env

    r = subprocess.run([sys.executable, "-c", _SHARDED_PROBE], cwd=REPO,
                       env=cpu_subprocess_env(str(REPO)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    exit_line, bad = r.stdout.strip().splitlines()
    assert "no process group configured" in exit_line
    assert bad == "[]"


_NAMES_PROBE = r"""
import sys
from nvbio_tpu_torch.bowtie import MapParams, ReadMapper
from nvbio_tpu_torch import Alphabet
from nvbio_tpu_torch.fmi import (FMIndex, build_fmindex, rank, rank2,
                                 backward_search, locate_batch)
from nvbio_tpu_torch.index import suffix_array
from nvbio_tpu_torch.io import (read_fasta, write_fasta, read_fastq,
                                fastq_batches, Reference, SamWriter,
                                BamReader, BamWriter, open_alignment_output,
                                read_alignments, SNPDatabase, load_vcf)
from nvbio_tpu_torch.utils import (log_debug, log_error, log_info, log_stats,
                                   log_verbose, log_visible, set_verbosity,
                                   Timer)
print(sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "nvbio_tpu" or k.startswith("nvbio_tpu.")))
"""


def test_package_level_names_load_no_jax():
    """The names the port's packages re-export, imported through their
    packages first in a fresh interpreter, load neither JAX nor
    nvbio_tpu."""
    from tests.conftest import cpu_subprocess_env

    r = subprocess.run([sys.executable, "-c", _NAMES_PROBE], cwd=REPO,
                       env=cpu_subprocess_env(str(REPO)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_port_sources_name_no_jax_module():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|nvbio_tpu\b(?!_torch))",
                     re.M)
    files = list((REPO / "nvbio_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_cuda_is_the_default_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    ref = Reference.from_records([("c", "ACGT" * 100)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ReadMapper.build(ref, MapParams())


def test_convert_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA card")
    from nvbio_tpu_torch import convert

    offsets = np.zeros(4 + 1, np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.qgram_index_from_arrays(1, 0, offsets, np.zeros(0, np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.genome_words_from_array(np.zeros(2, np.uint32))
    idx = convert.qgram_index_from_arrays(1, 0, offsets,
                                          np.zeros(0, np.int32), device="cpu")
    assert idx.offsets.device == torch.device("cpu")


def test_wrappers_on_cpu_take_the_plain_version_uncounted():
    rng = np.random.default_rng(0)
    B, L, C, W = 16, 20, 4, 7
    genome = rng.integers(0, 4, size=500, dtype=np.uint8)
    from nvbio_tpu_torch.packed import pack, words_to_tensor

    words = words_to_tensor(pack(genome, 2), "cpu")
    reads = torch.from_numpy(rng.integers(0, 4, size=(B, L)).astype(np.int32))
    lens = torch.full((B,), L, dtype=torch.int32)
    w0 = torch.from_numpy(rng.integers(0, 480, size=(B, C)))
    wlens = torch.full((B, C), L + W - 1, dtype=torch.int32)
    sc = GotohScoring(0, -6, -8, -3, -8, -3)
    before = (K.banded_score_cands.launches, K.banded_traceback.launches)
    got = K.banded_score_cands(reads, reads, lens, w0, wlens, words, sc, W, 2)
    want = K.banded_score_cands_plain(reads, reads, lens, w0, wlens, words,
                                      sc, W, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    texts = torch.from_numpy(rng.integers(0, 4, size=(B, L + W - 1))
                             .astype(np.int32))
    got = K.banded_traceback(reads, lens, texts, lens + W - 1, sc, W)
    want = K.banded_traceback_plain(reads, lens, texts, lens + W - 1, sc, W)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (K.banded_score_cands.launches,
            K.banded_traceback.launches) == before


def test_chip_smoke_alone_exits_nonzero_without_result(tmp_path):
    """Copied alone into an empty directory (or run without a card) the
    on-card check fails and prints no result line."""
    from tests.conftest import cpu_subprocess_env

    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = cpu_subprocess_env(str(tmp_path))
    for cwd in (tmp_path, REPO):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           env={**env, "PYTHONPATH": str(cwd)},
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        if torch.cuda.is_available():
            break
