"""``nvbio_tpu_torch index --device cpu`` against ``nvbio_tpu index`` on
the same FASTA, and each package's ``map`` on the other's prefix.

The genome (two contigs, an N run) carries a 1.5 kbp segment copied eight
times, every other copy with a substitution every 14 bases, so 12-mer
buckets hold more entries than ``hits_per_seed`` while most 16-mer buckets
do not. Two index runs per package: ``--no-qgram --qgroup 16 --fmi
--sa-backend device --pac --bwt --bwt-lz4`` (prefixes ``jq``, ``tq``) and
``-q 10 --fmi --sa-backend host --bwt`` (``jh``, ``th``). Every ``.npz``
array is compared key for key, the ``.bwt``, ``.pac``, ``.ann`` and ``.amb``
files byte for byte, and the SAM records of both packages' ``map`` on each
prefix must be identical. A ``--qgroup 16 --no-qgram`` prefix maps through
its ``QGroupIndex`` (q 16), as the JAX package's loader does."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from nvbio_tpu.alphabet import codes_to_string
from nvbio_tpu.io.pac import load_bwt as j_load_bwt
from tests.test_torch_pipeline import _run

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

L = 80
INDEX_FLAGS = {
    "q": ["--no-qgram", "--qgroup", "16", "--fmi", "--sa-backend", "device",
          "--pac", "--bwt", "--bwt-lz4"],
    "h": ["-q", "10", "--fmi", "--sa-backend", "host", "--bwt"],
}
MAP_ARGS = ["reads.fq", "--max-read-len", str(L), "--seed-len", "16",
            "--seed-stride", "10", "--batch", "45", "--max-dist", "5"]
# (package, prefix, seeding): every map run the tests read
MAPS = [(pkg, pre, seeding)
        for pkg in ("nvbio_tpu", "nvbio_tpu_torch")
        for pre, seeding in (("jq", "qgram"), ("tq", "qgram"), ("jh", "qgram"),
                             ("th", "qgram"), ("jq", "fmi"), ("th", "fmi"))]


def repeat_dataset(seed=29, n_reads=90):
    """(FASTA records, reads): 60 kbp over two contigs with an N run, a
    1.5 kbp segment pasted at eight loci (odd copies mutated every 14
    bases), reads of 80 bp with 2% substitutions (a third from the
    segment, odd reads reverse-complemented)."""
    rng = np.random.default_rng(seed)
    G = 60000
    g = rng.integers(0, 4, G).astype(np.uint8)
    seg = g[2000:3500].copy()
    for k, d in enumerate(range(10000, 58000, 6000)):
        c = seg.copy()
        if k % 2:
            c[7::14] = (c[7::14] + 1 + k % 3) % 4
        g[d:d + len(c)] = c
    s = codes_to_string(g)
    s = s[:30000] + "N" * 30 + s[30030:]
    recs = [("chrA", s[:25000]), ("chrB", s[25000:])]
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(2000, 3400) if i % 3 == 0
                else rng.integers(0, G - L))
        r = np.where(rng.random(L) < 0.02, (g[p:p + L] + 1) % 4, g[p:p + L])
        st = codes_to_string(r.astype(np.uint8))
        if i % 2:
            st = st[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
        q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, L))
        reads.append((f"r{i}_{p}", st, q))
    return recs, reads


def _tag(pkg):
    return "jax" if pkg == "nvbio_tpu" else "port"


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("index_cli")
    recs, reads = repeat_dataset()
    (d / "ref.fa").write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    (d / "reads.fq").write_text(
        "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))

    def index(pkg, kind):
        extra = ["--device", "cpu"] if pkg == "nvbio_tpu_torch" else []
        pre = ("j" if pkg == "nvbio_tpu" else "t") + kind
        return _run(pkg, ["index", "ref.fa", pre,
                          *INDEX_FLAGS[kind], *extra], d)

    def mapping(pkg, pre, seeding):
        extra = ["--device", "cpu"] if pkg == "nvbio_tpu_torch" else []
        return _run(pkg, ["map", pre, *MAP_ARGS, "--seeding", seeding, "-o",
                          f"{_tag(pkg)}_{pre}_{seeding}.sam", *extra], d)

    # at most three processes at a time: a q = 16 Q-Group index is ~1 GB
    with ThreadPoolExecutor(3) as pool:
        runs = [pool.submit(index, pkg, kind)
                for pkg in ("nvbio_tpu", "nvbio_tpu_torch")
                for kind in INDEX_FLAGS]
        logs = {"index": [f.result() for f in runs]}
        runs = [pool.submit(mapping, *m) for m in MAPS]
        logs["map"] = [f.result() for f in runs]
    for r in logs["index"] + logs["map"]:
        assert r.returncode == 0, r.stderr
    return d, reads, logs


def _npz_equal(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert a.files == b.files, (a.files, b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{a_path} {k}")


@pytest.mark.parametrize("kind,artifacts", [
    ("q", ("ref.npz", "qgroup.npz", "fmi.npz", "pac", "ann", "amb", "bwt")),
    ("h", ("ref.npz", "qgram.npz", "fmi.npz", "bwt")),
])
def test_index_artifacts_equal(work, kind, artifacts):
    d, _, _ = work
    present = sorted(p.name[3:] for p in d.glob(f"j{kind}.*"))
    assert present == sorted(artifacts)
    assert sorted(p.name[3:] for p in d.glob(f"t{kind}.*")) == present
    for ext in artifacts:
        j, t = d / f"j{kind}.{ext}", d / f"t{kind}.{ext}"
        if ext.endswith(".npz"):
            _npz_equal(j, t)
        else:
            assert j.read_bytes() == t.read_bytes(), ext


def test_index_logs_every_stage(work):
    _, _, logs = work
    port = [r.stderr for r in logs["index"][2:]]
    stages = port[0].split("stages: ")[1].splitlines()[0]
    for name in ("reference", "qgroup", "pac", "fm_upload_s",
                 "fm_bootstrap_s", "fm_tie_s", "fm_tied_rows", "fm_rounds",
                 "fm_planes_s", "fm_rows_s", "fm_fetch", "fm_save", "bwt"):
        assert f"{name} " in stages, name
    assert "fm_host" in port[1] and "qgram" in port[1]


def test_bwt_files_hold_the_fm_index_bwt(work):
    from nvbio_tpu_torch import packed
    from nvbio_tpu_torch.io.pac import load_bwt, save_bwt

    d, _, _ = work
    z = np.load(d / "tq.fmi.npz")
    bwt = packed.unpack(z["bwt_words"], int(z["n"]), 2)
    for name in ("tq.bwt", "th.bwt"):          # LZ4 frames, plain
        codes, primary, cum = load_bwt(str(d / name))
        jcodes, jprimary, jcum = j_load_bwt(str(d / name))
        np.testing.assert_array_equal(codes, bwt)
        np.testing.assert_array_equal(codes, jcodes)
        assert primary == jprimary == int(z["primary"])
        np.testing.assert_array_equal(cum, jcum)
        assert int(cum[3]) == len(bwt)
    assert (d / "tq.bwt").read_bytes()[:4] == b"NB4\x01"
    # a plain file whose primary reads as the LZ4 magic parses as plain
    odd = d / "odd.bwt"
    save_bwt(bwt, int.from_bytes(b"NB4\x01", "little"), str(odd))
    codes, primary, _ = load_bwt(str(odd))
    np.testing.assert_array_equal(codes, bwt)
    assert primary == int.from_bytes(b"NB4\x01", "little")


def _records(path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("@") or ln.startswith("@SQ")]


def test_qgroup_prefix_maps_through_its_qgroup_index(work):
    """The port's ``map`` on a ``nvbio_tpu index --no-qgram --qgroup 16``
    prefix seeds through that Q-Group index (q 16), as ``nvbio_tpu map``
    does, and writes its SAM records; a q = 12 q-gram table built on the
    fly (what the loader fell back to) places these reads otherwise."""
    from nvbio_tpu_torch.alphabet import Alphabet
    from nvbio_tpu_torch.apps.map_app import _load_reference
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.fastq import batch_from_records
    from nvbio_tpu_torch.qgram import QGroupIndex

    d, reads, _ = work
    ref, index = _load_reference(str(d / "jq"), "qgram")
    assert isinstance(index, QGroupIndex) and index.q == 16
    params = MapParams(max_read_len=L, seed_len=16, seed_stride=10,
                       max_dist=5)
    mapper = ReadMapper.build(ref, params, index=index, device="cpu")
    assert isinstance(mapper.index, QGroupIndex) and mapper.index.q == 16
    jax_sam = _records(d / "jax_jq_qgram.sam")
    assert _records(d / "port_jq_qgram.sam") == jax_sam
    batch = batch_from_records(reads, L, Alphabet.DNA_N)
    q12 = ReadMapper.build(ref, params, device="cpu")
    lines = [r.line() for r in q12.map_batch(batch)]
    body = [ln for ln in jax_sam if not ln.startswith("@")]
    assert len(lines) == len(body) and lines != body


@pytest.mark.parametrize("pre,seeding", [("jq", "qgram"), ("tq", "qgram"),
                                         ("jh", "qgram"), ("th", "qgram"),
                                         ("jq", "fmi"), ("th", "fmi")])
def test_each_package_maps_each_prefix_alike(work, pre, seeding):
    d, reads, _ = work
    want = _records(d / f"jax_{pre}_{seeding}.sam")
    assert sum(1 for ln in want if not ln.startswith("@")) == len(reads)
    assert _records(d / f"port_{pre}_{seeding}.sam") == want
    twin = ("t" if pre[0] == "j" else "j") + pre[1]
    other = d / f"jax_{twin}_{seeding}.sam"
    if other.exists():      # the other package's prefix of the same flags
        assert _records(other) == want


def test_index_stops_by_name_and_without_a_card(work, tmp_path):
    """``--bwt-blockwise`` (once refused by name) writes the ``.bwt`` bytes
    of ``nvbio_tpu index --fmi --bwt [--bwt-lz4]`` (the BWT is unique),
    plain and LZ4; without ``--device cpu`` and without a card the app
    stops with a message and writes nothing."""
    from nvbio_tpu_torch.__main__ import main

    d, _, _ = work
    for name, lz4 in (("jq", ["--bwt-lz4"]), ("jh", [])):
        pre = tmp_path / f"b{name}"
        assert main(["index", str(d / "ref.fa"), str(pre), "--no-qgram",
                     "--bwt-blockwise", *lz4, "--device", "cpu"]) == 0
        assert (tmp_path / f"b{name}.bwt").read_bytes() == \
            (d / f"{name}.bwt").read_bytes(), name
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    (tmp_path / "ref.fa").write_text(">c\nACGTACGTTT\n")
    for argv in (["index", str(tmp_path / "ref.fa"), str(tmp_path / "x")],
                 ["index", str(tmp_path / "ref.fa"), str(tmp_path / "x"),
                  "--sa-backend", "host", "--fmi"],
                 ["index", str(tmp_path / "ref.fa"), str(tmp_path / "x"),
                  "--no-qgram", "--bwt-blockwise"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(argv)
    assert not list(tmp_path.glob("x.*"))
