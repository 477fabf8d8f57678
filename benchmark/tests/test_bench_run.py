"""Whole runs of the harness on the CPU, at a tiny size, with the look for
a card skipped: the reference agrees with the port's CPU path in every
cell, and ``correct`` comes out false under the control and under each
fault a mapping cell can have. A cell, configuration, traffic mix and
metric added as data files alone are picked up."""

import json
import os
import shutil
import time

import pytest
import torch

from benchmark.harness import runner
from benchmark.harness.system import System
from benchmark.tests.conftest import REPO, make_root

torch.set_num_threads(1)
SEED = 2 ** 33 + 7


def run(root, capsys, workload, *extra, trace=0):
    rc = runner.main(["--workload", workload, "--seed", str(SEED),
                      "--seconds", "0.5", "--trace", str(trace), *extra],
                     root, time.time(), device="cpu")
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert list(res)[-1] == "check"
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return res


@pytest.mark.parametrize("workload", ["qgram-se150", "fmi-se150",
                                      "qgram-pe150", "fmi-pe150"])
def test_reference_agrees_with_the_port(tiny_root, capsys, workload):
    res = run(tiny_root, capsys, workload)
    assert res["correct"], res
    assert res["check"]["wrong_fields"]["value"] == 0
    se = ["missed_second", "missed_reseed"] if "se" in workload else []
    assert set(res["check"]) == {"wrong_fields", "missed_seeded", *se}
    assert set(res["metrics"]) == {"reads_per_s", "sensitivity", "setup_s"}
    assert res["metrics"]["sensitivity"]["value"] > 0.9
    assert res["attempted"] > 0 and res["failed"] == 0


def test_traced_run_reports_the_per_layer_metrics(tiny_root, capsys):
    res = run(tiny_root, capsys, "qgram-se150", trace=1)
    assert res["correct"]
    # on the CPU the trace holds no device op: those metrics stay silent
    assert set(res["metrics"]) == {"dispatch_host_ms", "index_build_s"}
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res


def test_control_fails(tiny_root, capsys):
    """The control: the program with quality-blind mismatch penalties, a
    guarantee the configuration states."""
    for workload in ("qgram-se150", "qgram-pe150"):
        res = run(tiny_root, capsys, workload,
                  "--control", "use_quality_penalties=false")
        assert not res["correct"]
        assert res["check"]["wrong_fields"]["value"] > 0
        assert res["check"]["missed_seeded"]["value"] > 0


def broken(monkeypatch, fault):
    """Break the timed path underneath the harness: rewrite the fetched
    host arrays of every batch as ``fault`` says."""
    orig = System.dispatch
    first = {}

    def dispatch(self, item, kind):
        fetched = orig(self, item, kind)
        wait = fetched.wait

        def broken_wait():
            host = {k: v.copy() for k, v in wait().items()}
            keys = [k for k in host if k.endswith("mapped")]
            B = len(host[keys[0]])
            if fault == "unchanged":
                # a step that leaves its state as it was: the results of
                # the batch before
                prev = first.get("host", host)
                first["host"] = host
                return prev
            if fault == "half":
                # half the batch left out: reported unmapped
                for k in host:
                    if k.endswith(("mapped", "proper", "rescued1",
                                   "rescued2", "discordant")):
                        host[k][B // 2:] = False
                    elif k.endswith(("best_score", "pair_score")):
                        host[k][B // 2:] = -(1 << 24)
                    elif k.endswith("mapq"):
                        host[k][B // 2:] = 0
                return host
            # an answer altered where it is produced: one read in eight
            # placed a base further on
            for k in host:
                if k.endswith("window_start"):
                    host[k][::8] += 1
            return host

        fetched.wait = broken_wait
        return fetched

    monkeypatch.setattr(System, "dispatch", dispatch)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["qgram-se150", "qgram-pe150"])
def test_faults_fail(tiny_root, capsys, monkeypatch, fault, workload):
    broken(monkeypatch, fault)
    res = run(tiny_root, capsys, workload)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("workload", ["qgram-se150", "fmi-se150"])
def test_second_best_dropped_fails(tiny_root, capsys, monkeypatch,
                                   workload):
    """The mapper stops tracking the second best: every MAPQ moves to the
    one-hit table, consistently with the second reported, and only the
    reference's own second best shows it."""
    from nvbio_tpu_torch.bowtie import pipeline

    orig = pipeline._reduce_best2

    def no_second(cands, params):
        best, pos, strand, second = orig(cands, params)
        return best, pos, strand, torch.full_like(second, pipeline.NEG_INF)

    monkeypatch.setattr(pipeline, "_reduce_best2", no_second)
    res = run(tiny_root, capsys, workload)
    assert res["check"]["wrong_fields"]["value"] == 0
    assert not res["correct"], res["check"]
    assert res["check"]["missed_second"]["value"] > \
        res["check"]["missed_second"]["limit"]


@pytest.mark.parametrize("workload", ["qgram-se150", "fmi-se150"])
def test_reseed_skipped_fails(tmp_path, capsys, workload):
    """The reseed pass skipped (``max_reseed=0``). At 2% errors the tiny
    genome's seeds leave the reseed pass nothing to place, so the traffic
    here has 12% errors; the sound program stays correct on it."""
    root = make_root(str(tmp_path))
    path = os.path.join(root, "benchmark", "traffic", "se150.json")
    with open(path) as f:
        tr = json.load(f)
    tr["subst_rate"] = 0.12
    with open(path, "w") as f:
        json.dump(tr, f)
    assert run(root, capsys, workload)["correct"]
    res = run(root, capsys, workload, "--control", "max_reseed=0")
    assert not res["correct"], res["check"]
    assert res["check"]["missed_reseed"]["value"] > \
        res["check"]["missed_reseed"]["limit"]


def test_cell_from_data_files_alone(tmp_path, capsys):
    """A new configuration, traffic mix, cell and per-layer metric: files
    and entries only, no edit of any file already there."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    root = make_root(str(tmp_path), bench)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "g100m-qgram.json")) as f:
        cfg = json.load(f)
    cfg["map_params"].update(max_dist=10, hits_per_seed=6)
    with open(os.path.join(bdir, "configs", "g100m-qgram-w21.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "se150.json")) as f:
        tr = json.load(f)
    tr.update(read_len=120, subst_rate=0.05)
    cfg["map_params"]["max_read_len"] = 120
    with open(os.path.join(bdir, "configs", "g100m-qgram-w21.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "se120-err5.json"), "w") as f:
        json.dump(tr, f)
    shutil.copy(os.path.join(bdir, "limits", "qgram-se150.json"),
                os.path.join(bdir, "limits", "w21-se120.json"))
    with open(os.path.join(bdir, "metrics", "batches_in_window.py"),
              "w") as f:
        f.write("def read(ctx):\n"
                "    if ctx.spec.cell['name'] != 'w21-se120':\n"
                "        return None\n"
                "    return ctx.window['batches']\n")
    bench["configs"].append(dict(
        name="g100m-qgram-w21", source="https://example.org/new",
        file="benchmark/configs/g100m-qgram-w21.json",
        reduced=[], why="band 21"))
    bench["workloads"].append(dict(
        name="w21-se120", config="g100m-qgram-w21", traffic="se120-err5",
        chips=1, why="5% errors at band 21"))
    bench["per_layer"].append(dict(
        name="batches_in_window", unit="batches", better="higher",
        source="host_clock", layer="app loop", moves="reads_per_s",
        workloads=["w21-se120"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res = run(root, capsys, "w21-se120", trace=1)
    assert res["correct"]
    assert res["metrics"]["batches_in_window"]["value"] >= 1
    res = run(root, capsys, "qgram-se150", trace=1)
    assert "batches_in_window" not in res["metrics"]


def test_judge_catches_a_wrong_mapq_and_a_wrong_nm(tiny_root, capsys,
                                                   monkeypatch):
    """Fields that the score check alone does not see."""
    for field, delta in (("mapq", 1), ("nm", 1)):
        orig = System.dispatch

        def dispatch(self, item, kind, field=field, delta=delta):
            fetched = orig(self, item, kind)
            wait = fetched.wait

            def w():
                host = {k: v.copy() for k, v in wait().items()}
                host[field][host["mapped"]] += delta
                return host

            fetched.wait = w
            return fetched

        monkeypatch.setattr(System, "dispatch", dispatch)
        res = run(tiny_root, capsys, "qgram-se150")
        assert res["check"]["wrong_fields"]["value"] > 0, field
        monkeypatch.setattr(System, "dispatch", orig)


@pytest.mark.gpu
def test_control_fails_on_the_card(card, capsys):
    """On a card, at the cell's own size: the control is not correct."""
    res = runner.main(["--workload", "qgram-se150", "--seed", "11",
                       "--seconds", "5", "--trace", "0", "--control",
                       "use_quality_penalties=false"], REPO, time.time())
    out = capsys.readouterr()
    assert res == 0
    assert not json.loads(out.out.strip().splitlines()[-1])["correct"]
