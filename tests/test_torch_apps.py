"""Port parity of the apps ``extract``, ``aln-diff``, ``sort`` and ``serve``
(CPU): each command of nvbio_tpu_torch against the same command of
nvbio_tpu, both run in this process on the same inputs, their outputs
compared byte for byte (SAM/BAM: header and records, but the ``@PG``
program line): ``extract`` on FASTA, FASTQ and gzip input with and without
``--rc``; ``aln-diff`` text, ``--json`` and ``--html`` on SAM and BAM;
``sort`` from SAM and BAM in one run and in >= 3 spilled runs, with
(ref, pos) ties, unmapped records and an RNAME missing from the header;
``serve``: the export directory (file names, dtypes, shapes, values and
JSON) of an ``nvbio_tpu index --fmi`` prefix, the live server's answers,
and ``FMClient.get`` into the port's classes against their ``.npz``
loads, across the two packages' servers."""

import gzip
import io
import json
import os
import shutil
import socket
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from nvbio_tpu.__main__ import main as jmain
from nvbio_tpu_torch.__main__ import main as tmain

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

REFS = (("chr1", 5000), ("chr2", 3000))


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setattr(sys, "stderr", io.StringIO())


def _seqs(rng, n=40):
    """Reads of 1-90 bases over ACGT with some N and lowercase bases."""
    out = []
    for i in range(n):
        s = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 91))))
        if i % 4 == 0:
            s = s[:len(s) // 2] + "N" + s[len(s) // 2 + 1:]
        if i % 5 == 0:
            s = s.lower()
        out.append(s)
    return out


def _write(path, text):
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("ext", ["fa", "fq", "fa.gz", "fq.gz"])
def test_extract(tmp_path, ext, rc):
    rng = np.random.default_rng(7)
    seqs = _seqs(rng)
    if ext.startswith("fa"):
        text = "".join(f">s{i} desc\n{s[:50]}\n{s[50:]}\n"
                       for i, s in enumerate(seqs))
    else:
        text = "".join(f"@s{i}\n{s}\n+\n{'I' * len(s)}\n"
                       for i, s in enumerate(seqs))
    src = str(tmp_path / f"reads.{ext}")
    _write(src, text)
    flags = ["--rc"] if rc else []
    assert jmain(["extract", src, "-o", str(tmp_path / "j.txt"),
                  *flags]) == 0
    assert tmain(["extract", src, "-o", str(tmp_path / "t.txt"),
                  *flags]) == 0
    want = (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t.txt").read_bytes() == want
    assert want.count(b"\n") == len(seqs)


def _records(seed, n=200):
    """SAM records over two references: (ref, pos) ties on a narrow range
    of positions, unmapped records (some with an RNAME and POS left in),
    records on an RNAME missing from the header, secondaries, mate-2
    records, and tags of the types i, Z and f."""
    from nvbio_tpu.io.sam import SamRecord

    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        kind = int(rng.integers(0, 10))
        rname = ("chr1", "chr2", "chrX")[int(rng.integers(0, 3))] \
            if kind else "*"
        flag = int(rng.choice([0, 16, 256, 0x80 | 0x1]))
        pos = int(rng.integers(1, 40))
        if kind in (0, 1):
            flag |= 0x4
            if kind == 0:
                pos = 0
        seq = "".join(rng.choice(list("ACGT"), 12))
        recs.append(SamRecord(
            f"r{i % (n // 2)}", flag, rname, pos,
            int(rng.integers(0, 61)), "*" if flag & 4 else "12M", seq,
            "I" * 12, tags={"AS": int(rng.integers(-20, 13)),
                            "XA": f"chr1,+{pos},12M,0;", "XF": 1.5}))
    return recs


def _write_alignments(path, recs):
    from nvbio_tpu.io.output import open_alignment_output

    with open_alignment_output(path, [r[0] for r in REFS],
                               [r[1] for r in REFS]) as w:
        for r in recs:
            w.write(r)


def _read(path):
    """(header without @PG, records) through the port's reader."""
    from nvbio_tpu_torch.io.output import read_alignments

    header, recs = read_alignments(path)
    return [h for h in header if not h.startswith("@PG")], recs


@pytest.mark.parametrize("run_size", [1_000_000, 50])
@pytest.mark.parametrize("src,dst", [("sam", "sam"), ("bam", "bam"),
                                     ("sam", "bam")])
def test_sort(tmp_path, src, dst, run_size):
    recs = _records(seed=3)
    inp = str(tmp_path / f"in.{src}")
    _write_alignments(inp, recs)
    common = ["--run-size", str(run_size), "--tmp-dir", str(tmp_path)]
    assert jmain(["sort", inp, str(tmp_path / f"j.{dst}"), *common]) == 0
    stats = {}
    from nvbio_tpu_torch.io.bamsort import sort_alignments

    assert sort_alignments(inp, str(tmp_path / f"s.{dst}"), run_size,
                           str(tmp_path), device="cpu",
                           stats=stats) == len(recs)
    assert tmain(["sort", inp, str(tmp_path / f"t.{dst}"), *common,
                  "--device", "cpu"]) == 0
    want = _read(str(tmp_path / f"j.{dst}"))
    assert _read(str(tmp_path / f"t.{dst}")) == want
    assert _read(str(tmp_path / f"s.{dst}")) == want
    assert stats["runs"] == (1 if run_size > len(recs) else 4)
    # (ref, pos) non-decreasing, unmapped and unknown RNAMEs last
    rank = {"chr1": 0, "chr2": 1}
    keys = [(0x7FFFFFFF, 0) if int(r[1]) & 4 or r[2] not in rank
            else (rank[r[2]], int(r[3])) for r in want[1]]
    assert keys == sorted(keys) and len(keys) == len(recs)
    assert any(k[0] == 0x7FFFFFFF for k in keys)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_sort_needs_a_card_unless_asked(tmp_path):
    inp = str(tmp_path / "in.sam")
    _write_alignments(inp, _records(seed=4, n=10))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(["sort", inp, str(tmp_path / "out.sam")])


def _diff_inputs(tmp_path, right_ext):
    """Left and right alignments of the same reads: the right moves some
    positions (within and past the tolerance), flips strands, CIGARs and
    MAPQs, unmaps some, maps others, and changes chromosomes."""
    from nvbio_tpu.io.sam import SamRecord

    rng = np.random.default_rng(9)
    left, right = [], []
    for i in range(120):
        flag = int(rng.choice([0, 16, 0x41, 0x81, 4]))
        pos = int(rng.integers(1, 4000))
        rec = SamRecord(f"q{i}", flag, "*" if flag & 4 else "chr1",
                        0 if flag & 4 else pos, int(rng.integers(0, 61)),
                        "*" if flag & 4 else "10M", "ACGTACGTAC",
                        "IIIIIIIIII")
        left.append(rec)
        kind = i % 8
        r = SamRecord(**vars(rec))
        if kind == 1 and not flag & 4:
            r.pos += int(rng.integers(1, 15))
        elif kind == 2:
            r.flag ^= 0x10
        elif kind == 3 and not flag & 4:
            r.cigar = "4S6M"
        elif kind == 4:
            r.mapq = (r.mapq + 7) % 61
        elif kind == 5:
            r.flag, r.rname, r.pos, r.cigar = 4, "*", 0, "*"
        elif kind == 6 and flag & 4:
            r.flag, r.rname, r.pos, r.cigar = 0, "chr2", 77, "10M"
        elif kind == 7 and not flag & 4:
            r.rname = "chr2"
        right.append(r)
        if i % 9 == 0:   # secondaries are skipped
            left.append(SamRecord(f"q{i}", 0x100, "chr2", 5, 0, "10M", "*",
                                  "*"))
    right.append(SamRecord("only_r", 0, "chr1", 9, 30, "10M", "ACGTACGTAC",
                           "IIIIIIIIII"))
    lp, rp = str(tmp_path / "l.sam"), str(tmp_path / f"r.{right_ext}")
    _write_alignments(lp, left)
    _write_alignments(rp, right)
    return lp, rp


@pytest.mark.parametrize("mode,right_ext", [("text", "sam"),
                                            ("json", "sam"),
                                            ("html", "sam"),
                                            ("json", "bam")])
def test_aln_diff(tmp_path, capsys, mode, right_ext):
    lp, rp = _diff_inputs(tmp_path, right_ext)
    outs = {}
    for name, main in (("j", jmain), ("t", tmain)):
        flags = ["--pos-tolerance", "5"]
        if mode == "json":
            flags.append("--json")
        if mode == "html":
            flags += ["--html", str(tmp_path / f"{name}.html")]
        capsys.readouterr()
        assert main(["aln-diff", lp, rp, *flags]) == 0
        outs[name] = capsys.readouterr().out
        if mode == "html":
            outs[name] += (tmp_path / f"{name}.html").read_text()
    assert outs["t"] == outs["j"]
    if mode == "json":
        stats = json.loads(outs["t"])
        assert stats["only_left"] and stats["only_right"]
        assert 0 < stats["same_pos"] < stats["both_mapped"]


@pytest.fixture(scope="module")
def jax_prefix(tmp_path_factory):
    """An ``nvbio_tpu index --fmi -q 8`` prefix of two seeded contigs."""
    d = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(13)
    text = "".join(
        f">c{i}\n{''.join(rng.choice(list('ACGT'), n))}\n"
        for i, n in enumerate((3000, 1234)))
    (d / "ref.fa").write_text(text)
    assert jmain(["index", str(d / "ref.fa"), str(d / "idx"), "--fmi",
                  "-q", "8"]) == 0
    return d, str(d / "idx")


def _jax_export(prefix, dirpath):
    """What ``nvbio_tpu serve`` exports before it serves."""
    from nvbio_tpu.fmi.index import FMIndex
    from nvbio_tpu.io.reference import Reference
    from nvbio_tpu.io.server import export_shared
    from nvbio_tpu.qgram import QGramIndex

    export_shared(dirpath, "reference", Reference.load(prefix + ".ref.npz"))
    export_shared(dirpath, "qgramindex", QGramIndex.load(prefix + ".qgram.npz"))
    export_shared(dirpath, "fmindex", FMIndex.load(prefix + ".fmi.npz"))


def _wait_for(cond, what, timeout=60):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, what
        time.sleep(0.02)


@pytest.fixture(scope="module")
def servers(jax_prefix):
    """The port's ``serve`` command on a thread and a JAX ``FMServer`` over
    the JAX export, each on a socket in a short temporary directory (the
    AF_UNIX path limit is 108 bytes)."""
    from nvbio_tpu.io.server import FMServer
    from nvbio_tpu_torch.apps import server_app

    d, prefix = jax_prefix
    short = tempfile.mkdtemp(prefix="nvbt")
    jdir, tdir = str(d / "jax.shared"), str(d / "port.shared")
    jsock, tsock = os.path.join(short, "j.sock"), os.path.join(short, "t.sock")
    _jax_export(prefix, jdir)
    jserver = FMServer(jdir, jsock).start()
    threads = [threading.Thread(target=jserver.serve_forever, daemon=True),
               threading.Thread(target=tmain, daemon=True, args=(
                   ["serve", prefix, "--dir", tdir, "--socket", tsock],))]
    for t in threads:
        t.start()
    _wait_for(lambda: server_app.current is not None
              and os.path.exists(tsock), "the port's server to start")
    try:
        yield (jdir, jsock), (tdir, tsock), prefix
    finally:
        jserver._stop = True   # the JAX loop ends at its next accept timeout
        threads[0].join(timeout=10)
        jserver.stop()
        server_app.current.stop()
        threads[1].join(timeout=10)
        assert server_app.current is None
        shutil.rmtree(short, ignore_errors=True)


def test_serve_export_dir_equal(servers):
    (jdir, _), (tdir, _), _ = servers
    names = sorted(f for f in os.listdir(jdir) if not f.endswith(".sock"))
    assert sorted(f for f in os.listdir(tdir)
                  if not f.endswith(".sock")) == names
    assert {"reference.json", "qgramindex.json", "fmindex.json",
            "fmindex.bwt_words.npy", "reference.codes.npy"} <= set(names)
    for f in names:
        a, b = os.path.join(jdir, f), os.path.join(tdir, f)
        if f.endswith(".json"):
            assert open(b).read() == open(a).read(), f
        else:
            want, got = np.load(a), np.load(b)
            assert (got.dtype, got.shape) == (want.dtype, want.shape), f
            assert np.array_equal(got, want), f


def _ask(sock, line):
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock)
        s.sendall(line.encode())
        s.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = s.recv(65536)
            if not b:
                break
            chunks.append(b)
    return b"".join(chunks).decode()


@pytest.mark.parametrize("request_line", [
    "PING", "LIST", "GET reference", "GET fmindex", "GET qgramindex",
    "GET nothing", "HELLO"])
def test_serve_answers_as_jax(servers, request_line):
    (_, jsock), (_, tsock), _ = servers
    want = _ask(jsock, request_line)
    assert _ask(tsock, request_line) == want
    assert want.endswith("\n")


@pytest.mark.parametrize("side", ["port", "jax"])
def test_serve_client_loads(servers, side):
    """``FMClient.get`` of the port, on either package's server and export,
    into the port's classes: equal to their loads of the ``.npz``."""
    from nvbio_tpu_torch.fmi.index import FMIndex
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.io.server import FMClient, load_shared
    from nvbio_tpu_torch.qgram import QGramIndex

    (jdir, jsock), (tdir, tsock), prefix = servers
    d, sock = (tdir, tsock) if side == "port" else (jdir, jsock)
    client = FMClient(sock, d)
    assert client.ping()
    assert client.list() == ["fmindex", "qgramindex", "reference"]
    for name, cls, suffix in (("fmindex", FMIndex, ".fmi.npz"),
                              ("qgramindex", QGramIndex, ".qgram.npz")):
        want = cls.load(prefix + suffix)
        for got in (client.get(name, cls), load_shared(d, name, cls)):
            for f, v in vars(want).items():
                g = getattr(got, f)
                if isinstance(v, torch.Tensor):
                    assert g.dtype == v.dtype and torch.equal(g, v), f
                else:
                    assert g == v, f
    want = Reference.load(prefix + ".ref.npz")
    got = client.get("reference", Reference)
    assert got.names == want.names
    for f in ("offsets", "codes", "n_mask_words"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
