"""Port parity of ``utils/options.py`` (the option files of ``map
--config``): ``Options`` and ``apply_to_params`` of nvbio_tpu_torch against
nvbio_tpu's on the same option file, and ``map --config`` end to end (the
full-matrix mate traceback it selects)."""

import dataclasses

import pytest
import torch

from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.utils import options as jopt
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.utils import options as topt
from tests.test_torch_paired import L, _run, pair_dataset

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

OPTION_FILE = """\
# bowtie2-style overrides, one per line
pe_full_traceback=1
max_dist = 8
score_min_coeff=-0.4
pe_policy=rf
mate_rescue=off
seeding_1mm
not_a_field=7

  # an indented comment, then a blank line

reseed_frac=0.25
"""


@pytest.fixture
def option_file(tmp_path):
    path = tmp_path / "opts.txt"
    path.write_text(OPTION_FILE)
    return str(path)


def test_options_parse_like_jax(option_file):
    j, t = jopt.Options.load(option_file), topt.Options.load(option_file)
    assert dict(t.items()) == dict(j.items())
    assert len(dict(t.items())) == 8
    for name in ("max_dist", "not_a_field", "missing"):
        assert t.int(name, 3) == j.int(name, 3)
        assert t.uint(name, 3) == j.uint(name, 3)
    for name in ("pe_full_traceback", "mate_rescue", "seeding_1mm",
                 "missing"):
        assert t.flag(name, True) == j.flag(name, True)
    assert t.float("reseed_frac") == j.float("reseed_frac") == 0.25
    assert t.string("pe_policy") == j.string("pe_policy") == "rf"
    assert ("max_dist" in t) and ("missing" not in t)


@pytest.mark.parametrize("preset", ["default", "local", "edit_distance"])
def test_apply_to_params_like_jax(option_file, preset):
    """Each MapParams field the file names is overlaid with the field's
    type, after the preset, to the same values in both packages."""
    opts_j = jopt.Options.load(option_file)
    opts_t = topt.Options.load(option_file)
    mk_j = JMapParams if preset == "default" else getattr(JMapParams, preset)
    mk_t = TMapParams if preset == "default" else getattr(TMapParams, preset)
    pj = jopt.apply_to_params(opts_j, mk_j(max_read_len=100))
    pt = topt.apply_to_params(opts_t, mk_t(max_read_len=100))
    for f in dataclasses.fields(pt):
        if f.name == "scoring":
            assert dataclasses.astuple(pt.scoring) == \
                dataclasses.astuple(pj.scoring)
        else:
            assert getattr(pt, f.name) == getattr(pj, f.name), f.name
    assert pt.pe_full_traceback is True and pt.mate_rescue is False
    assert pt.max_dist == 8 and pt.band == 17 and pt.pe_policy == "rf"
    untouched = topt.apply_to_params(topt.Options(["unknown=1"]),
                                     TMapParams())
    assert untouched == TMapParams()


def test_cli_config_full_traceback_matches_jax_cli(tmp_path):
    """``map --config`` with ``pe_full_traceback=1`` (and the rescue off in
    the same file): the port's SAM equals ``nvbio_tpu map --config``'s."""
    recs, reads1, reads2 = pair_dataset()
    (tmp_path / "ref.fa").write_text(
        "".join(f">{n}\n{s}\n" for n, s in recs))
    for name, reads in (("r1.fq", reads1), ("r2.fq", reads2)):
        (tmp_path / name).write_text(
            "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    (tmp_path / "opts.txt").write_text(
        "# full-matrix mate traceback\npe_full_traceback=1\nmate_rescue=0\n")
    r = _run("nvbio_tpu", ["index", "ref.fa", "idx", "-q", "10"], tmp_path)
    assert r.returncode == 0, r.stderr
    common = ["-1", "r1.fq", "-2", "r2.fq", "--max-read-len", str(L),
              "--seed-len", "16", "--seed-stride", "10", "--batch", "40",
              "--max-dist", "5", "-X", "400", "--config", "opts.txt"]
    r = _run("nvbio_tpu", ["map", "idx", *common, "-o", "jax.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = _run("nvbio_tpu_torch", ["map", "idx", *common, "-o", "port.sam",
                                 "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr

    def records(name):
        return [ln for ln in (tmp_path / name).read_text().splitlines()
                if not ln.startswith("@")]

    assert len(records("jax.sam")) == 2 * len(reads1)
    assert records("port.sam") == records("jax.sam")

