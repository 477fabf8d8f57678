"""The benchmark's data and arithmetic, on the CPU: BENCHMARK.json against
its contract, generators that repeat by seed, K1's work and bytes from
shapes, the rate as all work over all time, the top-level import check."""

import ast
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import genome, roofline, runner, traffic
from benchmark.tests.conftest import REPO

torch.set_num_threads(1)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in names
        for d, ext in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(REPO, "benchmark", d,
                                               ext + ".json"))
        names.append(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip() == m["layer"]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def genome_spec(**kw):
    """The configurations' genome block, cut to a CPU test's size."""
    with open(os.path.join(REPO, "benchmark", "configs",
                           "g100m-qgram.json")) as f:
        return json.load(f)["genome"] | kw


def test_generators_repeat_by_seed():
    spec = genome_spec(length=200_000, unique_prefix=50_000)
    big = 2 ** 31 + 12345
    g1, g2 = genome.make_genome(spec, big), genome.make_genome(spec, big)
    assert np.array_equal(g1, g2)
    assert not np.array_equal(g1, genome.make_genome(spec, big + 1))
    with open(os.path.join(REPO, "benchmark", "traffic", "pe150.json")) as f:
        tr = json.load(f)
    tr.update(batch=64, pool_batches=2)
    p1 = traffic.make_pool(g1, tr, big, "cpu")
    p2 = traffic.make_pool(g1, tr, big, "cpu")
    p3 = traffic.make_pool(g1, tr, big + 1, "cpu")
    for k in p1[0]:
        assert all(np.array_equal(a[k], b[k]) for a, b in zip(p1, p2))
    assert not np.array_equal(p1[0]["codes1"], p3[0]["codes1"])
    assert not np.array_equal(p1[0]["codes1"], p1[1]["codes1"])


def test_reads_sit_at_their_origin():
    """A read without errors or polymorphisms equals the genome at its
    origin (reverse-complemented on the reverse strand)."""
    g = genome.make_genome(genome_spec(length=100_000, unique_prefix=50_000),
                           3)
    with open(os.path.join(REPO, "benchmark", "traffic", "se150.json")) as f:
        tr = json.load(f)
    tr.update(batch=50, pool_batches=1, subst_rate=0.0, poly_rate=0.0)
    b = traffic.make_pool(g, tr, 5, "cpu")[0]
    for r, o, rc in zip(b["codes"], b["origin"], b["is_rc"]):
        want = g[o:o + 150]
        assert np.array_equal(r, (3 - want)[::-1] if rc else want)
    assert 10 < b["is_rc"].sum() < 40


def test_genome_has_the_stated_composition_and_repeat_shares():
    """GC content and the shares of bases in each kind of repeat come out
    as the configuration states them (copies' substitutions drift the GC
    content a little towards one half)."""
    spec = genome_spec(length=4_000_000, unique_prefix=200_000)
    kinds = []
    orig = genome.diverge

    def diverge(rng, seg, lo, hi):
        kinds.append(len(seg))
        return orig(rng, seg, lo, hi)

    genome.diverge = diverge
    try:
        g = genome.make_genome(spec, 11)
    finally:
        genome.diverge = orig
    assert len(g) == 4_000_000 and g.max() <= 3
    assert abs(np.isin(g, (1, 2)).mean() - spec["gc"]) < 0.01
    stated = sum(spec[k] for k in genome.KINDS)
    # every repeat segment passes through diverge once
    assert sum(kinds) / len(g) == pytest.approx(stated, rel=0.03)


def test_k1_work_and_bytes_from_shapes():
    w = roofline.k1_call(B=1000, C=16, L=150, W=31, genome_words=100)
    assert w["cells"] == 1000 * 16 * 150 * 31
    assert w["bytes"] == (4 * 1000 * 150 * 4 + 4 * 1000 + 16000 * 12
                          + 400 + 16000 * 8)
    t, by = roofline.least_time(w["cells"], w["bytes"])
    assert by == "issue"
    assert t == pytest.approx(w["cells"] * 1.5 / (132 * 128 * 1.98e9))
    t, by = roofline.least_time(1, 1e9)
    assert by == "bytes" and t == pytest.approx(1e9 / 3.35e12)


class FakeSystem:
    """A dispatch costs 10 ms of host time; its results take 30 ms more."""

    def __init__(self, B):
        self.B = B

    def dispatch(self, item, kind):
        time.sleep(0.01)
        B = self.B

        class Fetched:
            def wait(self):
                time.sleep(0.03)
                return {"mapped": np.ones(B, bool),
                        "strand": np.zeros(B, bool),
                        "window_start": np.zeros(B, np.int64),
                        "text_start": np.zeros(B, np.int64)}
        return Fetched()


def test_rate_is_all_work_over_all_time():
    from types import SimpleNamespace

    from benchmark.metrics import reads_per_s

    B = 100
    pool = [dict(is_rc=np.zeros(B, bool), origin=np.zeros(B, np.int64))]
    spec = SimpleNamespace(config={"map_params": {"max_dist": 15}},
                           traffic={"sample_per_batch": 8})
    win = runner.Window(FakeSystem(B), [None], pool, "single", spec, 1,
                        False)
    t = time.perf_counter()
    w = win.run(seconds=0.3)
    wall = time.perf_counter() - t
    # every dispatched batch is drained and counted, and the window's time
    # runs to the last batch's results
    assert win.reads == w["batches"] * B
    assert w["seconds"] == pytest.approx(wall, abs=0.01)
    assert w["seconds"] >= 0.3 + 0.03
    ctx = SimpleNamespace(reads=win.reads, window=w)
    assert reads_per_s.read(ctx) == pytest.approx(
        w["batches"] * B / w["seconds"])
    assert win.placed == win.reads


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    for name in list(sys.modules):
        if name.split(".")[0] in runner.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "nvbio_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxish", object())
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "nvbio_tpu.bowtie", object())
    assert runner.forbidden_modules() == ["jax", "nvbio_tpu"]


YARDSTICK = ("genome.py", "traffic.py", "reference.py", "roofline.py",
             "trace.py", "spec.py")


def test_yardstick_imports_nothing_of_the_program():
    """The reference and the rest of the yardstick import neither JAX nor
    either package: by their sources, and by what a fresh interpreter holds
    after importing them and judging a result."""
    for f in YARDSTICK:
        with open(os.path.join(REPO, "benchmark", "harness", f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "flax", "nvbio_tpu",
                                    "nvbio_tpu_torch"}, (f, tops)
    code = (
        "import sys, numpy as np\n"
        "from benchmark.harness import reference, traffic, genome, trace\n"
        "g = np.random.default_rng(0).integers(0, 4, 5000).astype(np.uint8)\n"
        "r = reference.KmerTable(__import__('torch').from_numpy(g), 12)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'nvbio_tpu', 'nvbio_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """With no CUDA card (this machine), and in a directory that holds only
    BENCHMARK.json and the benchmark, a run exits non-zero and prints no
    result line."""
    import shutil

    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "qgram-se150",
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
