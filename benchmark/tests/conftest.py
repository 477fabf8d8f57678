"""Fixtures of the benchmark's own tests: a checkout-like root that holds
the benchmark's data files at a size a CPU test run can hold.

Run here with ``python -m pytest benchmark/tests -q``; the tests marked
``gpu`` run on a machine with a CUDA card and skip elsewhere."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# a tiny genome and small batches: the CPU path of every cell in seconds
TINY_GENOME = dict(length=300_000, unique_prefix=65_536)
TINY_TRAFFIC = dict(batch=200, pool_batches=2, sample_per_batch=64)
# the paired-end cells that BENCHMARK.json leaves out until the program's
# rescue keeps a rescued mate inside its window (PERF.md, Open questions);
# their data files stay, and the tests drive the harness's paired path
PE_CELLS = [
    dict(name="qgram-pe150", config="g100m-qgram", traffic="pe150", chips=1,
         why="PE 2x150"),
    dict(name="fmi-pe150", config="g100m-fmi", traffic="pe150", chips=1,
         why="PE 2x150"),
]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_root(dst: str, bench: dict | None = None) -> str:
    """A root holding BENCHMARK.json and the benchmark's data files, with
    every configuration's genome and every traffic mix cut to
    ``TINY_*``."""
    src = os.path.join(REPO, "benchmark")
    for sub in ("metrics", "limits", "configs", "traffic"):
        shutil.copytree(os.path.join(src, sub),
                        os.path.join(dst, "benchmark", sub))
    if bench is None:
        with open(os.path.join(REPO, "BENCHMARK.json")) as f:
            bench = json.load(f)
        have = {w["name"] for w in bench["workloads"]}
        bench["workloads"] += [w for w in PE_CELLS if w["name"] not in have]
    for c in bench["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["genome"].update(TINY_GENOME)
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(dst, "benchmark", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            tr = json.load(f)
        tr.update(TINY_TRAFFIC)
        with open(path, "w") as f:
            json.dump(tr, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path))
