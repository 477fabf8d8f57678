"""``nvbio_tpu_torch map --device cpu`` against ``nvbio_tpu map`` on the same
files, through the surface ported last: BAM output, a ``.pac`` reference,
``--mapq-filter``, ``--report``, ``--debug-output`` and ``--profile``.

Single-end: the SE dataset of ``tests/test_torch_pipeline.py`` (two
contigs, an N run, reads with SNPs, indels and none to find), its
reference written as ``.pac/.ann/.amb`` by the JAX package's
``save_reference_pac``. Paired-end: the pair dataset of
``tests/test_torch_paired.py`` (concordant, rescue-only, half-mapped and
discordant pairs). Each configuration runs each CLI once (module
fixtures); the tests compare the decoded BAM records, the uncompressed BAM
record stream after the header, the debug file's bytes and the report's
counts (the HTML itself carries wall times)."""

import json
import re
import struct

import pytest
import torch

from nvbio_tpu.io.pac import save_reference_pac
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.io.bam import read_bam
from nvbio_tpu_torch.io.bgzf import BgzfReader
from tests.test_torch_paired import L, _run, pair_dataset
from tests.test_torch_pipeline import _dataset

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

COMMON = ["--max-read-len", str(L), "--seed-len", "16", "--seed-stride",
          "10", "--max-dist", "5"]
SE_ARGS = ["se", "se.fq", *COMMON, "--batch", "32", "-o", "{}.bam",
           "--mapq-filter", "20", "--report", "{}.html",
           "--debug-output", "{}.dbg"]
PE_ARGS = ["pe.fa", "-1", "r1.fq", "-2", "r2.fq", *COMMON, "--batch", "40",
           "-X", "400", "-o", "{}.bam", "--report", "{}.html"]


def _fastq(path, reads):
    path.write_text("".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))


def _both(d, args):
    """Run ``nvbio_tpu map`` and ``nvbio_tpu_torch map --device cpu`` with
    outputs named jax.* and port.* (the port also writes a profile)."""
    for module, tag, extra in (
            ("nvbio_tpu", "jax", []),
            ("nvbio_tpu_torch", "port",
             ["--device", "cpu", "--profile", "prof"])):
        r = _run(module, ["map", *(a.format(tag) for a in args), *extra], d)
        assert r.returncode == 0, r.stderr
    return d


@pytest.fixture(scope="module")
def se_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("map_cli_se")
    recs, reads = _dataset(seed=11, n_reads=60)
    save_reference_pac(JReference.from_records(recs), str(d / "se"))
    _fastq(d / "se.fq", reads)
    return _both(d, SE_ARGS)


@pytest.fixture(scope="module")
def pe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("map_cli_pe")
    recs, reads1, reads2 = pair_dataset()
    (d / "pe.fa").write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    _fastq(d / "r1.fq", reads1)
    _fastq(d / "r2.fq", reads2)
    return _both(d, PE_ARGS)


def _bam_records(path):
    """The uncompressed BAM stream after the header (magic, text and
    reference list): the records' bytes."""
    with BgzfReader(str(path)) as r:
        data = r.read_all()
    assert data[:4] == b"BAM\x01"
    (l_text,) = struct.unpack("<i", data[4:8])
    i = 8 + l_text
    (n_ref,) = struct.unpack("<i", data[i:i + 4])
    i += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", data[i:i + 4])
        i += 4 + l_name + 4
    return data[i:]


_ROW = re.compile(r"<tr><td>([a-zA-Z ]+?) ?(\d*)</td><td>([\d,]+)</td>")


def _report_counts(path):
    """{metric: count} of the HTML report's mapping table and histogram
    rows (``mapq 42``, ``NM 3``)."""
    return {(name, b): int(n.replace(",", ""))
            for name, b, n in _ROW.findall(path.read_text())}


@pytest.mark.parametrize("config", ["se", "pe"])
def test_bam_records_equal_the_jax_cli(se_dir, pe_dir, config):
    d = se_dir if config == "se" else pe_dir
    jhead, jrec = read_bam(str(d / "jax.bam"))
    thead, trec = read_bam(str(d / "port.bam"))
    assert trec == jrec
    assert [h for h in thead if h.startswith("@SQ")] == \
        [h for h in jhead if h.startswith("@SQ")]
    assert "@PG\tID:nvbio_tpu_torch\tPN:nvbio_tpu_torch" in thead
    assert _bam_records(d / "port.bam") == _bam_records(d / "jax.bam")
    flags = [int(r[1]) for r in trec]
    if config == "se":
        assert len(trec) == 60
        # the filter wrote some mapped reads as unmapped, none below 20
        assert all(int(r[4]) >= 20 for r in trec if not int(r[1]) & 4)
        assert 0 < sum(f & 4 for f in flags) // 4 < 60
    else:
        assert len(trec) == 120
        assert sum(bool(f & 2) for f in flags) >= 60


@pytest.mark.parametrize("config", ["se", "pe"])
def test_report_counts_equal_the_jax_cli(se_dir, pe_dir, config):
    d = se_dir if config == "se" else pe_dir
    got = _report_counts(d / "port.html")
    assert got == _report_counts(d / "jax.html")
    n_reads = got[("reads", "")]
    assert n_reads == (60 if config == "se" else 120)
    assert sum(v for (k, _), v in got.items() if k == "mapq") == \
        got[("mapped", "")] > 0
    if config == "pe":
        assert got[("proper pairs", "")] > 0
        assert got[("discordant pairs", "")] > 0


def test_debug_output_bytes_equal_the_jax_cli(se_dir):
    from nvbio_tpu_torch.io.debug import MAGIC, read_debug

    port = (se_dir / "port.dbg").read_bytes()
    assert port == (se_dir / "jax.dbg").read_bytes()
    assert port.startswith(MAGIC)
    rec = read_debug(str(se_dir / "port.dbg"))
    # one record per batch row (padding included), as the JAX writer does
    assert len(rec) == 64 and (rec["ref_id"] == 1).any()
    assert ((rec["subs"] > 0) & (rec["flag"] == 0)).any()


def test_profile_leaves_a_parseable_trace(se_dir):
    traces = list((se_dir / "prof").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(ev.get("ph") == "X" for ev in events)


def test_fmi_seeding_and_multi_host_stop_by_name(se_dir):
    from nvbio_tpu_torch.__main__ import main

    # FM seeding and randomized hit selection (which a config file selects)
    # are ported: the port's SAM records equal nvbio_tpu's on the .pac
    # reference; the multi-host flags are ported too: a one-process group
    # writes the same records, and an incomplete one stops by name
    (se_dir / "rand.cfg").write_text("seeding=fmi\nselect_mode=randomized\n")
    args = ["map", "se", "se.fq", *COMMON, "--batch", "32", "--seeding",
            "fmi", "--config", "rand.cfg", "-o"]
    r = _run("nvbio_tpu", [*args, "rand_jax.sam"], se_dir)
    assert r.returncode == 0, r.stderr
    assert main([*(str(se_dir / a) if a in ("se", "se.fq", "rand.cfg")
                   else a for a in args),
                 str(se_dir / "rand_port.sam"), "--device", "cpu"]) == 0

    def records(name):
        return [ln for ln in (se_dir / name).read_text().splitlines()
                if not ln.startswith("@")]

    assert records("rand_port.sam") == records("rand_jax.sam")
    assert sum(not int(ln.split("\t")[1]) & 4
               for ln in records("rand_port.sam")) >= 30
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    port_args = [str(se_dir / a) if a in ("se", "se.fq", "rand.cfg") else a
                 for a in args]
    assert main([*port_args, str(se_dir / "rand_dist.sam"), "--device",
                 "cpu", "--dist", f"--coordinator=127.0.0.1:{port}",
                 "--num-processes", "1", "--process-id", "0"]) == 0
    assert records("rand_dist.sam") == records("rand_jax.sam")
    assert not list(se_dir.glob("rand_dist.sam.shard*"))
    for flag, missing in ((["--coordinator=h:1"], "number of processes"),
                          (["--num-processes", "2"], "coordinator")):
        with pytest.raises(SystemExit, match=missing):
            main(["map", "ref.fa", "reads.fq", *flag])


def test_mapq_filter_matches_the_recorded_sam(tmp_path):
    """The recorded ``tests/data/expected_mapqfilt.sam`` (the JAX package's
    records filtered at Q 20) from the port's CLI, through BAM."""
    import os

    from nvbio_tpu.alphabet import codes_to_string
    from tests.conformance_data import L as CL
    from tests.conformance_data import build_dataset

    ref, se, _, _ = build_dataset()
    (tmp_path / "conf.fa").write_text(
        f">{ref.names[0]}\n{codes_to_string(ref.codes)}\n")
    _fastq(tmp_path / "conf.fq", [
        (n, codes_to_string(se.codes[i, :se.lengths[i]]),
         "".join(chr(33 + int(q)) for q in se.quals[i, :se.lengths[i]]))
        for i, n in enumerate(se.names)])
    r = _run("nvbio_tpu_torch", [
        "map", "conf.fa", "conf.fq", "--max-read-len", str(CL),
        "--hits-per-seed", "8", "--batch", "64", "--mapq-filter", "20",
        "-o", "conf.bam", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    with open(os.path.join(data, "expected_mapqfilt.sam")) as f:
        want = f.read().splitlines()
    got = ["\t".join(rec) for rec in read_bam(str(tmp_path / "conf.bam"))[1]]
    assert got == want
