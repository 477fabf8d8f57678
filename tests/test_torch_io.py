"""The host I/O copied into the port, held against the JAX package on the
same inputs: the BGZF writer (native and Python zlib), BAM records with
typed tags, ``.pac/.ann/.amb`` artifacts, ``DebugOutput`` records, the
alignment stats, and the map app's batch-size gauging."""

import io

import numpy as np
import pytest
import torch

from nvbio_tpu.io import bam as jbam
from nvbio_tpu.io import bgzf as jbgzf
from nvbio_tpu.io import debug as jdebug
from nvbio_tpu.io import pac as jpac
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu.io.sam import SamRecord as JSamRecord
from nvbio_tpu.io.sam import TypedTag as JTypedTag
from nvbio_tpu.native import bgzf_available as j_bgzf_available
from nvbio_tpu.utils.stats import AlignmentStats as JStats
from nvbio_tpu_torch.io import bam as tbam
from nvbio_tpu_torch.io import bgzf as tbgzf
from nvbio_tpu_torch.io import debug as tdebug
from nvbio_tpu_torch.io import pac as tpac
from nvbio_tpu_torch.io.reference import Reference as TReference
from nvbio_tpu_torch.io.sam import SamRecord, TypedTag
from nvbio_tpu_torch.native import bgzf_available
from nvbio_tpu_torch.utils.stats import AlignmentStats

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)


def _stream():
    """1.5 MB: incompressible and compressible halves across many blocks
    (the stream of ``tests/test_native.py``)."""
    rng = np.random.default_rng(2)
    return (rng.integers(0, 255, size=1_000_000, dtype=np.uint8).tobytes()
            + b"A" * 500_000)


def _bgzf_bytes(cls, data, native: bool) -> bytes:
    buf = io.BytesIO()
    w = cls(buf, threads=4)
    if not native:
        w._lib = None  # force the Python block loop
    for i in range(0, len(data), 100_000):
        w.write(data[i:i + 100_000])
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_bgzf_writer_bytes_equal_the_jax_writer(native):
    if native and not (bgzf_available() and j_bgzf_available()):
        pytest.skip("no C++ compiler or zlib headers: Python zlib only")
    data = _stream()
    got = _bgzf_bytes(tbgzf.BgzfWriter, data, native)
    assert got == _bgzf_bytes(jbgzf.BgzfWriter, data, native)
    with tbgzf.BgzfReader(io.BytesIO(got)) as r:
        assert r.read_all() == data
    import gzip

    assert gzip.decompress(got) == data
    w = tbgzf.BgzfWriter(io.BytesIO())
    assert w.compressor == ("native" if bgzf_available() else "python")


def _records(rec_cls, tag_cls):
    return [
        rec_cls(qname="r1", flag=0, rname="c1", pos=101, mapq=42,
                cigar="10M2I38M", seq="ACGTN" * 10, qual="I" * 50,
                tags={"AS": -7, "NM": 2, "MD": "48", "XF": 1.25,
                      "YA": tag_cls("A", "x"), "YH": tag_cls("H", "1AE3"),
                      "YB": tag_cls("B", ("s", (-3, 0, 7))),
                      "YF": tag_cls("B", ("f", (0.5, -2.0)))}),
        rec_cls(qname="r2", flag=0x63, rname="c2", pos=7, mapq=0,
                cigar="3S20M1D5M", seq="A" * 28, qual="*", rnext="=",
                pnext=40, tlen=61, tags={"YT": "CP"}),
        rec_cls(qname="r3", flag=4, rname="*", pos=0, mapq=0, cigar="*",
                seq="ACG", qual="!!#"),
    ]


def _bam_bytes(writer_cls, recs, program) -> bytes:
    buf = io.BytesIO()
    w = writer_cls(buf, ["c1", "c2"], [1000, 500], program=program)
    for r in recs:
        w.write(r)
    w.bgzf.flush()
    return buf.getvalue()


def test_bam_writer_bytes_equal_the_jax_writer_and_round_trip_tags():
    recs = _records(SamRecord, TypedTag)
    got = _bam_bytes(tbam.BamWriter, recs, "p")
    assert got == _bam_bytes(jbam.BamWriter, _records(JSamRecord, JTypedTag),
                             "p")
    with tbam.BamReader(io.BytesIO(got)) as r:
        back = list(r)
        assert r.ref_names == ["c1", "c2"] and r.ref_lengths == [1000, 500]
    assert [b.line() for b in back] == [r.line() for r in recs]
    assert back[0].tags["YB"] == TypedTag("B", ("s", (-3, 0, 7)))
    assert back[0].tags["YA"] == TypedTag("A", "x")


def test_bam_default_program_is_the_port(tmp_path):
    from nvbio_tpu_torch.io.output import open_alignment_output, \
        read_alignments

    path = str(tmp_path / "x.bam")
    with open_alignment_output(path, ["c1"], [100]) as w:
        w.write(_records(SamRecord, TypedTag)[2])
    header, recs = read_alignments(path)
    assert "@PG\tID:nvbio_tpu_torch\tPN:nvbio_tpu_torch" in header
    assert recs == [_records(SamRecord, TypedTag)[2].line().split("\t")]


def _genome():
    rng = np.random.default_rng(7)
    s = "".join("ACGT"[c] for c in rng.integers(0, 4, 3001))
    # N holes: inside a contig, at a contig's start and across a boundary
    s = s[:100] + "N" * 37 + s[137:1990] + "N" * 20 + s[2010:]
    return [("c1", s[:2000]), ("c2", s[2000:2999]), ("c3", s[2999:])]


def test_pac_artifacts_equal_the_jax_functions(tmp_path):
    recs = _genome()
    tref, jref = TReference.from_records(recs), JReference.from_records(recs)
    tpac.save_reference_pac(tref, str(tmp_path / "t"))
    jpac.save_reference_pac(jref, str(tmp_path / "j"))
    for ext in (".pac", ".ann", ".amb"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    np.testing.assert_array_equal(tpac.load_pac(str(tmp_path / "j.pac")),
                                  jpac.load_pac(str(tmp_path / "j.pac")))
    got = tpac.load_reference_pac(str(tmp_path / "j"))
    want = jpac.load_reference_pac(str(tmp_path / "j"))
    assert isinstance(got, TReference)
    assert got.names == want.names == ["c1", "c2", "c3"]
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.n_mask_words, want.n_mask_words)
    np.testing.assert_array_equal(got.n_mask_words, tref.n_mask_words)
    assert got.n_flags().sum() == 57
    assert tpac.load_bns(str(tmp_path / "t"))[2] == \
        [(100, 37), (1990, 10), (2000, 10)]


def _result(rng, B):
    return dict(
        mapped=rng.random(B) < 0.8, strand=rng.random(B) < 0.5,
        mapq=rng.integers(0, 300, B).astype(np.int32),
        nm=rng.integers(0, 40, B).astype(np.int32),
        subs=rng.integers(0, 300, B).astype(np.int32),
        ins=rng.integers(0, 3, B).astype(np.int32),
        dels=rng.integers(0, 3, B).astype(np.int32),
        has_second=rng.random(B) < 0.3,
        best_score=-rng.integers(0, 60, B).astype(np.int32),
        second_score=-rng.integers(0, 1 << 30, B).astype(np.int32))


def test_debug_output_bytes_equal_the_jax_writer(tmp_path):
    for mod, name in ((tdebug, "t.dbg"), (jdebug, "j.dbg")):
        rng = np.random.default_rng(5)
        with mod.DebugOutput(str(tmp_path / name)) as d:
            for B in (37, 64):
                res = _result(rng, B)
                d.process_batch(res, rng.integers(0, 70000, B),
                                rng.integers(1, 1 << 31, B))
    assert (tmp_path / "t.dbg").read_bytes() == \
        (tmp_path / "j.dbg").read_bytes()
    rec = tdebug.read_debug(str(tmp_path / "t.dbg"))
    assert len(rec) == 101 and rec["read_id"][-1] == 100
    assert rec.dtype == jdebug.DEBUG_DTYPE and tdebug.MAGIC == jdebug.MAGIC


def test_alignment_stats_equal_the_jax_stats():
    rng = np.random.default_rng(9)
    t, j = AlignmentStats(), JStats()
    for B in (50, 13):
        res = _result(rng, B)
        lens = rng.integers(0, 3, B) * 50
        t.update_from_result(res, lens)
        j.update_from_result(res, lens)
    t.n_proper_pairs = j.n_proper_pairs = 4
    for f in ("n_reads", "n_mapped", "n_unique", "n_multiple",
              "n_proper_pairs"):
        assert getattr(t, f) == getattr(j, f)
    np.testing.assert_array_equal(t.mapq_hist, j.mapq_hist)
    np.testing.assert_array_equal(t.nm_hist, j.nm_hist)
    assert t.summary() == j.summary()


class _Probe:
    """A mapper whose dispatch fails above ``fits`` rows with ``error``."""

    def __init__(self, fits, error):
        self.fits, self.error, self.calls = fits, error, []

    def dispatch(self, batch):
        self.calls.append(len(batch.names))
        assert not batch.lengths.any()   # the probe is all padding
        if len(batch.names) > self.fits:
            raise self.error
        return {"mapped": torch.zeros(len(batch.names), dtype=torch.bool)}


def test_gauge_batch_size_halves_on_out_of_memory():
    """Batch-size gauging backs off on device OOM and re-raises anything
    else (``tests/test_cli.py::test_gauge_batch_halving`` for the port)."""
    from nvbio_tpu_torch.apps.map_app import gauge_batch_size

    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    p = _Probe(128, oom)
    assert gauge_batch_size(p, 1024, 100) == 128
    assert p.calls == [1024, 512, 256, 128]
    p = _Probe(100, RuntimeError("CUDA error: out of memory"))
    assert gauge_batch_size(p, 1024, 100) == 64
    p = _Probe(0, oom)            # nothing fits: raised at the floor
    with pytest.raises(torch.cuda.OutOfMemoryError):
        gauge_batch_size(p, 256, 100)
    assert p.calls == [256, 128, 64]
    p = _Probe(0, RuntimeError("CUDA error: an illegal memory access"))
    with pytest.raises(RuntimeError, match="illegal"):
        gauge_batch_size(p, 1024, 100)
    assert p.calls == [1024]
    p = _Probe(0, ValueError("bad"))
    with pytest.raises(ValueError):
        gauge_batch_size(p, 1024, 100)
