"""Port parity of the public surface: the package-level names of the six
``nvbio_tpu`` packages that re-export them, ``packed.PackedArray`` and
``packed.gather_symbols``, ``fmi.rank.rank2``, ``qgram.attach_midpos``
and the native probes — each held exactly to its JAX counterpart on the
CPU (tolerance 0)."""

import ast
import dataclasses
import importlib
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu import native as jnative
from nvbio_tpu import packed as jpacked
from nvbio_tpu import qgram as jq
from nvbio_tpu_torch import native as tnative
from nvbio_tpu_torch import packed as tpacked
from nvbio_tpu_torch import qgram as tq

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# ``nvbio_tpu.fmi`` re-exports functions named like its modules
jidx = importlib.import_module("nvbio_tpu.fmi.index")
jrank = importlib.import_module("nvbio_tpu.fmi.rank")
trank = importlib.import_module("nvbio_tpu_torch.fmi.rank")

# package -> {name: the port's defining module}
NAMES = {
    "": {"Alphabet": "alphabet"},
    "bowtie": {"MapParams": "bowtie.params",
               "ReadMapper": "bowtie.pipeline"},
    "fmi": {"FMIndex": "fmi.index", "build_fmindex": "fmi.index",
            "rank": "fmi.rank", "rank2": "fmi.rank",
            "backward_search": "fmi.search", "locate_batch": "fmi.search"},
    "index": {"suffix_array": "index.sa"},
    "io": {"read_fasta": "io.fasta", "write_fasta": "io.fasta",
           "read_fastq": "io.fastq", "fastq_batches": "io.fastq",
           "Reference": "io.reference", "SamWriter": "io.sam",
           "BamReader": "io.bam", "BamWriter": "io.bam",
           "open_alignment_output": "io.output",
           "read_alignments": "io.output", "SNPDatabase": "io.vcf",
           "load_vcf": "io.vcf"},
    "utils": {"log_debug": "utils.console", "log_error": "utils.console",
              "log_info": "utils.console", "log_stats": "utils.console",
              "log_verbose": "utils.console", "log_visible": "utils.console",
              "set_verbosity": "utils.console", "Timer": "utils.timers"},
}
CASES = [(pkg, name, mod) for pkg, names in NAMES.items()
         for name, mod in names.items()]


def _pkg(base, sub):
    return importlib.import_module(f"{base}.{sub}" if sub else base)


def _jax_reexports(pkg) -> set:
    path = REPO / "nvbio_tpu" / pkg.replace(".", "/") / "__init__.py"
    tree = ast.parse(path.read_text())
    return {a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


def test_thirty_names_are_the_jax_packages_reexports():
    assert len(CASES) == 30
    for pkg, names in NAMES.items():
        assert _jax_reexports(pkg) == set(names), pkg


@pytest.mark.parametrize("pkg,name,mod", CASES,
                         ids=[f"{p or 'top'}.{n}" for p, n, _ in CASES])
def test_package_name_is_its_modules_object(pkg, name, mod):
    got = getattr(_pkg("nvbio_tpu_torch", pkg), name)
    assert got is getattr(_pkg("nvbio_tpu_torch", mod), name)
    # the JAX package's name of the same kind (a class or a function)
    want = getattr(_pkg("nvbio_tpu", pkg), name)
    assert isinstance(got, type) == isinstance(want, type)
    assert callable(got) and callable(want)


def test_fmi_rank_is_the_function_as_in_jax():
    from nvbio_tpu.fmi import rank as j_rank
    from nvbio_tpu_torch.fmi import rank as t_rank

    assert callable(j_rank) and callable(t_rank)
    assert t_rank is trank.rank
    assert j_rank is jrank.rank


@pytest.mark.parametrize("first", ["nvbio_tpu_torch.parallel.mesh",
                                   "nvbio_tpu_torch.fmi.sharded",
                                   "nvbio_tpu_torch.parallel.sharded_index"])
def test_first_import_in_a_fresh_interpreter(first):
    """These close the bowtie -> fmi.sharded -> parallel.mesh -> bowtie
    cycle unless ``bowtie.ReadMapper`` resolves lazily."""
    from tests.conftest import cpu_subprocess_env

    code = (f"import {first}\nfrom nvbio_tpu_torch.bowtie import "
            f"ReadMapper\nprint(ReadMapper.__module__)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=cpu_subprocess_env(str(REPO)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "nvbio_tpu_torch.bowtie.pipeline"


# ----------------------------------------------------------------------
# packed


@pytest.mark.parametrize("on", ["numpy", "tensor"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_gather_symbols(bits, on):
    rng = np.random.default_rng(bits)
    n = 1001                                    # not a multiple of spw
    syms = rng.integers(0, 1 << bits, size=(3, n)).astype(np.uint8)
    words = jpacked.pack(syms, bits)            # (3, n_words) uint32
    idx1 = np.concatenate([[0, n - 1], rng.integers(0, n, 200)])
    idx2 = rng.integers(0, n, (7, 9))
    idx2[0, 0], idx2[-1, -1] = 0, n - 1
    cases = [(words[1], idx1, syms[1][idx1]),
             (words[2], idx2, syms[2][idx2]),
             (words, idx1, syms[:, idx1]), (words, idx2, syms[:, idx2])]
    for w, idx, syms_at in cases:
        want = jpacked.gather_symbols(w, idx, bits)
        if on == "numpy":
            got = tpacked.gather_symbols(w, idx, bits)
            assert isinstance(got, np.ndarray)
        else:
            got = tpacked.gather_symbols(tpacked.words_to_tensor(w, "cpu"),
                                         torch.from_numpy(idx), bits)
            assert isinstance(got, torch.Tensor)
            got = got.numpy()
        assert got.dtype == np.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, syms_at)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_packed_array(bits):
    rng = np.random.default_rng(100 + bits)
    syms = rng.integers(0, 1 << bits, size=333).astype(
        np.uint16 if bits == 16 else np.uint8)
    j = jpacked.PackedArray.from_codes(syms, bits)
    t = tpacked.PackedArray.from_codes(syms, bits)
    np.testing.assert_array_equal(t.words, j.words)
    assert t.words.dtype == j.words.dtype == np.uint32
    assert (t.length, t.bits, t.spw) == (j.length, j.bits, j.spw)
    np.testing.assert_array_equal(t.to_codes(), j.to_codes())
    on = t.to("cpu")
    assert isinstance(on.words, torch.Tensor)
    assert on.words.dtype == torch.int32
    np.testing.assert_array_equal(on.to_codes(), j.to_codes())
    assert torch.equal(on.to("cpu").words, on.words)


# ----------------------------------------------------------------------
# rank2


@pytest.mark.parametrize("n", [1000, 1024])   # 1024: a multiple of 64
def test_rank2_equals_jax(n):
    from nvbio_tpu_torch.fmi.index import build_fmindex

    rng = np.random.default_rng(n)
    text = rng.integers(0, 4, n, dtype=np.uint8)
    jf = jidx.build_fmindex(text)
    tf = build_fmindex(text)
    a, b = rng.integers(0, n + 1, (2, 500))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[:3], hi[:3] = [0, 0, n], [0, n, n]
    c = rng.integers(0, 4, 500)
    jlo, jhi = jrank.rank2(jnp.asarray(jf.bwt_words), jnp.asarray(jf.occ),
                           jnp.asarray(c, jnp.int32),
                           jnp.asarray(lo, jnp.int32),
                           jnp.asarray(hi, jnp.int32))
    tlo, thi = trank.rank2(tf.rank_rows, torch.from_numpy(c),
                           torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    # a symbol for the whole batch broadcasts against lo and hi
    slo, shi = trank.rank2(tf.rank_rows, torch.tensor(2),
                           torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(
        slo.numpy(), trank.rank(tf.rank_rows, torch.tensor(2),
                                torch.from_numpy(lo)).numpy())
    np.testing.assert_array_equal(
        shi.numpy(), trank.rank(tf.rank_rows, torch.tensor(2),
                                torch.from_numpy(hi)).numpy())


# ----------------------------------------------------------------------
# q-gram mid_pos API and the native probes


def _jax_form(idx):
    """The port's index as the JAX package holds it: tables in
    ``position_dtype(n)``, an empty ``mid_pos`` bucket as the dtype's max."""
    dt = tq.position_dtype(idx.n)
    mid = None
    if idx.mid_pos is not None:
        mp = idx.mid_pos.numpy()
        mid = np.where(mp < 0, np.iinfo(dt).max, mp).astype(dt)
    return (idx.offsets.numpy().astype(dt), idx.positions.numpy().astype(dt),
            mid)


def _assert_index_equal(t, j):
    assert (t.q, t.n) == (j.q, j.n)
    for got, want in zip(_jax_form(t), (j.offsets, j.positions, j.mid_pos)):
        if want is None:
            assert got is None
            continue
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))


def _genome(seed=5, n=6000):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[4000:4800] = codes[100:900]            # buckets of several
    flags = np.zeros(n, bool)
    flags[[17, 2500, 2501, 5990]] = True
    return codes, flags


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("q", [6, 7])            # 7: empty buckets
def test_build_qgram_index_midpos_equals_jax(q, flags):
    codes, nf = _genome()
    nf = nf if flags else None
    _assert_index_equal(tq.build_qgram_index(codes, q, n_flags=nf),
                        jq.build_qgram_index(codes, q, n_flags=nf))
    _assert_index_equal(
        tq.build_qgram_index_large(codes, q, chunk=1000, n_flags=nf),
        jq.build_qgram_index_large(codes, q, chunk=1000, n_flags=nf))


def test_attach_midpos_equals_jax():
    codes, _ = _genome()
    built = tq.build_qgram_index(codes, 7)
    bare = dataclasses.replace(built, mid_pos=None)
    got = tq.attach_midpos(bare)
    assert got.offsets is bare.offsets and got.positions is bare.positions
    assert torch.equal(got.mid_pos, built.mid_pos)
    _assert_index_equal(got, jq.attach_midpos(
        jq.build_qgram_index(codes, 7, midpos=False)))
    assert int((got.mid_pos < 0).sum()) > 0       # empty buckets at q = 7


def test_attach_midpos_uint32_positions():
    """A table of a text past 2^31 symbols (uint32 positions): the empty
    bucket sentinel is 0xFFFFFFFF in JAX and -1 in the port."""
    rng = np.random.default_rng(3)
    n = 2**31 + 100
    cnt = rng.integers(0, 4, 16)
    cnt[[0, 5, 15]] = 0
    offsets = np.zeros(17, np.uint32)
    offsets[1:] = np.cumsum(cnt)
    positions = np.sort(rng.integers(2**31, n - 2, int(cnt.sum()))
                        ).astype(np.uint32)
    j = jq.attach_midpos(jq.QGramIndex(2, offsets, positions, n))
    t = tq.attach_midpos(tq.QGramIndex.from_arrays(2, n, offsets,
                                                   positions))
    assert t.mid_pos.dtype == torch.int64
    assert (t.mid_pos.numpy() == -1).sum() == (cnt == 0).sum() >= 3
    _assert_index_equal(t, j)


def test_numpy_build_where_the_native_library_does_not_build(monkeypatch):
    """The JAX package and the port without their native q-gram library:
    the probe says so, and both fall back to the numpy builder, whose
    tables and ``mid_pos`` equal the native builds'."""
    import subprocess as sp

    codes, nf = _genome(seed=9)
    want = jq.build_qgram_index(codes, 6, n_flags=nf)

    def no_toolchain():
        raise sp.CalledProcessError(1, ["g++"])

    monkeypatch.setattr(tnative, "get_qgram", no_toolchain)
    monkeypatch.setattr(jnative, "get_qgram", no_toolchain)
    assert tnative.qgram_available() is False
    got = tq.build_qgram_index(codes, 6, n_flags=nf)
    _assert_index_equal(got, want)
    _assert_index_equal(got, jq.build_qgram_index(codes, 6, n_flags=nf))


@pytest.mark.parametrize("name", ["sais_available", "qgram_available"])
def test_native_probes_are_bools_as_in_jax(name):
    got = getattr(tnative, name)()
    assert type(got) is bool
    assert got == getattr(jnative, name)()
