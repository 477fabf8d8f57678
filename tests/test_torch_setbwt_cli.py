"""``nvbio_tpu_torch setbwt --device cpu`` against ``nvbio_tpu setbwt`` on
the same FASTQ: the one-shot SA-IS build with ``--txt --bgz --lz4`` and
``--incremental`` under every ``--method`` (``device`` runs the port's
BWTE engine on the CPU, the JAX one on its CPU backend). ``.setbwt.npz``
arrays must be equal key for key, ``.setbwt.txt`` and ``.setbwt.lz4``
byte for byte, ``.setbwt.txt.bgz`` once inflated. Without ``--device cpu``
and without a card the app stops with a message."""

import gzip
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import _run

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

N_READS, L = 300, 48
RUNS = {
    "whole": ["--txt", "--bgz", "--lz4"],
    "native": ["--incremental", "64", "--method", "native", "--txt",
               "--lz4"],
    "device": ["--incremental", "64", "--method", "device", "--txt"],
    "rank": ["--incremental", "100", "--method", "rank"],
    "paged": ["--incremental", "100", "--method", "paged"],
    "merge": ["--incremental", "100", "--method", "merge"],
}
OUTPUTS = {"whole": ("npz", "txt", "txt.bgz", "lz4"),
           "native": ("npz", "txt", "lz4"), "device": ("npz", "txt"),
           "rank": ("npz",), "paged": ("npz",), "merge": ("npz",)}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Both CLIs on 300 reads of 48 bp (a tenth of them duplicated), three
    processes at a time."""
    d = tmp_path_factory.mktemp("setbwt_cli")
    rng = np.random.default_rng(41)
    codes = rng.integers(0, 4, size=(N_READS, L))
    codes[::10] = codes[1::10]
    with open(d / "reads.fq", "w") as f:
        for i, r in enumerate(codes):
            f.write(f"@r{i}\n{''.join('ACGT'[c] for c in r)}\n+\n"
                    f"{'I' * L}\n")

    def one(pkg, kind):
        extra = ["--device", "cpu"] if pkg == "nvbio_tpu_torch" else []
        tag = "j" if pkg == "nvbio_tpu" else "t"
        return _run(pkg, ["setbwt", "reads.fq", f"{tag}_{kind}",
                          *RUNS[kind], *extra], d)

    with ThreadPoolExecutor(3) as pool:
        runs = [pool.submit(one, pkg, kind) for kind in RUNS
                for pkg in ("nvbio_tpu", "nvbio_tpu_torch")]
        for r in [f.result() for f in runs]:
            assert r.returncode == 0, r.stderr
    return d


@pytest.mark.parametrize("kind", list(RUNS))
def test_setbwt_outputs_equal(work, kind):
    d = work
    present = sorted(p.name for p in d.glob(f"t_{kind}.*"))
    assert present == sorted(p.name.replace("j_", "t_", 1)
                             for p in d.glob(f"j_{kind}.*"))
    assert present == sorted(f"t_{kind}.setbwt.{e}" for e in OUTPUTS[kind])
    for ext in OUTPUTS[kind]:
        j, t = d / f"j_{kind}.setbwt.{ext}", d / f"t_{kind}.setbwt.{ext}"
        if ext == "npz":
            a, b = np.load(j), np.load(t)
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif ext == "txt.bgz":
            assert gzip.decompress(t.read_bytes()) == \
                gzip.decompress(j.read_bytes())
        else:
            assert t.read_bytes() == j.read_bytes(), ext
    bwt = np.load(d / f"t_{kind}.setbwt.npz")["bwt"]
    n_dollar = N_READS + 1 if kind == "whole" else N_READS
    assert int((bwt == 0).sum()) == n_dollar
    assert len(bwt) == N_READS * (L + 1) + (kind == "whole")


def test_setbwt_stops_without_a_card(tmp_path):
    from nvbio_tpu_torch.__main__ import main
    from nvbio_tpu_torch.index.blockwise import blockwise_bwt
    from nvbio_tpu_torch.index.bwte_device import BwteDevice

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    (tmp_path / "r.fq").write_text("@a\nACGT\n+\nIIII\n")
    for extra in ([], ["--incremental", "1", "--method", "device"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["setbwt", str(tmp_path / "r.fq"), str(tmp_path / "x"),
                  *extra])
    assert not list(tmp_path.glob("x.*"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BwteDevice(capacity=64, n_strings=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blockwise_bwt(np.zeros(8, np.uint8))
