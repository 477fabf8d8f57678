"""Port parity of the aligner library: nvbio_tpu_torch.align against
nvbio_tpu.align on the CPU, on seeded numpy inputs — every aligner
(EditDistance, SmithWaterman, Gotoh, Hamming) x type (GLOBAL, SEMI_GLOBAL,
LOCAL) through ``batch_score_full`` and ``batch_score_banded`` (bands 5, 9
and 15), per-position mismatch scores, BLOSUM62, ``batch_traceback_banded``
(every ``TracebackResult`` field), ``batch_traceback_full_scan`` and the
XLA Myers at M = 4, 33 and 100 over 4 and 5 symbols. Every batch carries
the edge lengths plen/tlen in {0, 1}. Integer scores and ops must be
equal. The JAX functions are traced on parallel threads (XLA compiles
without the GIL), once per case."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvbio_tpu.align as jalign
import nvbio_tpu_torch.align as talign
from nvbio_tpu.align import batch as jbatch
from nvbio_tpu.align import myers as jmyers
from nvbio_tpu.align import scoring as jscoring
from nvbio_tpu.align import traceback as jtb
from nvbio_tpu.align import types as jtypes
from nvbio_tpu_torch.align import batch as tbatch
from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align import myers as tmyers
from nvbio_tpu_torch.align import scoring as tscoring
from nvbio_tpu_torch.align import traceback as ttb
from nvbio_tpu_torch.align import types as ttypes

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

KINDS = ("ed", "sw", "gotoh", "hamming")
TYPES = ("GLOBAL", "SEMI_GLOBAL", "LOCAL")
FULL_SHAPES = ((8, 16, 24), (4, 33, 47))    # tests/test_align.py's
BANDS = (5, 9, 15)
# (plen, tlen) planted in rows 0-3 of every batch
EDGES = ((0, 0), (0, 1), (1, 0), (1, 1))


def _aligner(mod, kind, atype):
    """The aligner ``kind`` of type ``atype`` from the types module ``mod``
    (either package's), with tests/test_align.py's scorings."""
    t = mod.AlignmentType[atype]
    if kind == "ed":
        return mod.make_edit_distance_aligner(t)
    if kind == "sw":
        return mod.make_smith_waterman_aligner(
            t, mod.SWScoring(match=2, mismatch=-1, deletion=-2,
                             insertion=-2))
    gotoh = mod.GotohScoring(match=2, mismatch=-1, pattern_gap_open=-3,
                             pattern_gap_ext=-1, text_gap_open=-3,
                             text_gap_ext=-1)
    if kind == "gotoh":
        return mod.make_gotoh_aligner(t, gotoh)
    return mod.make_hamming_aligner(t)


def _batch(seed, B, M, N, n_sym=4, edges=True):
    """Patterns mutated from the texts' starts (tests/test_align.py's
    ``_random_batch``), lengths from half to full, EDGES planted."""
    rng = np.random.default_rng(seed)
    texts = rng.integers(0, n_sym, size=(B, N), dtype=np.int32)
    pats = texts[:, :M].copy()
    n_mut = max(1, M // 8)
    for b in range(B):
        pats[b, rng.integers(0, M, size=n_mut)] = rng.integers(
            0, n_sym, size=n_mut)
    plens = rng.integers(max(1, M // 2), M + 1, size=B).astype(np.int32)
    tlens = rng.integers(max(1, N // 2), N + 1, size=B).astype(np.int32)
    if edges:
        for b, (p, t) in enumerate(EDGES[:B]):
            plens[b], tlens[b] = p, t
    return pats, plens, texts, tlens


def _mm(seed, B, M):
    return -np.random.default_rng(seed).integers(1, 7, size=(B, M)).astype(
        np.int32)


# ---- the cases: name -> (JAX call, port call), both on numpy inputs ------

def _full_case(kind, atype, shape, mm=False, matrix=False):
    B, M, N = shape
    if matrix:      # tests/test_protein.py's proteinsw configuration
        rng = np.random.default_rng(11)
        pats = rng.integers(0, 24, size=(B, M)).astype(np.int32)
        texts = rng.integers(0, 24, size=(B, N)).astype(np.int32)
        texts[:3, 5:5 + M] = pats[:3]     # planted hits
        plens = np.full(B, M, np.int32)
        tlens = np.full(B, N, np.int32)
        plens[3], tlens[4] = 1, 0
    else:
        pats, plens, texts, tlens = _batch(
            KINDS.index(kind) * 100 + TYPES.index(atype) * 10 + M, B, M, N)
    args = (pats, plens, texts, tlens)
    mms = _mm(5, B, M) if mm else None

    def run(pkg):
        mod, fn = ((jtypes, jbatch.batch_score_full) if pkg == "jax"
                   else (ttypes, tbatch.batch_score_full))
        if matrix:
            sc = mod.GotohScoring(0, 0, -5, -3, -5, -3)
            aligner = mod.make_gotoh_aligner(mod.AlignmentType[atype], sc)
            table = (jscoring.BLOSUM62 if pkg == "jax"
                     else tscoring.BLOSUM62)
        else:
            aligner, table = _aligner(mod, kind, atype), None
        return fn(*_inputs(pkg, args), aligner,
                  mismatch_scores=_opt(pkg, mms),
                  subst_matrix=_opt(pkg, table))
    return run


def _banded_case(kind, atype, band, mm=False, matrix=False):
    B, M = 8, 20
    T = M + band - 1
    if matrix:
        rng = np.random.default_rng(12)
        pats = rng.integers(0, 24, size=(B, M)).astype(np.int32)
        texts = rng.integers(0, 24, size=(B, T)).astype(np.int32)
        plens = np.full(B, M, np.int32)
        tlens = np.full(B, T, np.int32)
        plens[2], tlens[3] = 0, 1
    else:
        pats, plens, texts, _ = _batch(band * 31 + KINDS.index(kind), B, M,
                                       T)
        tlens = np.minimum(plens + band - 1, T).astype(np.int32)
        tlens[:4] = [t for _, t in EDGES]
        tlens[5] = plens[5] // 2          # a window shorter than the read
    args = (pats, plens, texts, tlens)
    mms = _mm(6, B, M) if mm else None

    def run(pkg):
        mod, fn = ((jtypes, jbatch.batch_score_banded) if pkg == "jax"
                   else (ttypes, tbatch.batch_score_banded))
        if matrix:
            aligner = mod.make_gotoh_aligner(
                mod.AlignmentType[atype], mod.GotohScoring(0, 0, -5, -3, -5,
                                                           -3))
            table = jscoring.BLOSUM62 if pkg == "jax" else tscoring.BLOSUM62
        else:
            aligner, table = _aligner(mod, kind, atype), None
        return fn(*_inputs(pkg, args), aligner, band,
                  mismatch_scores=_opt(pkg, mms),
                  subst_matrix=_opt(pkg, table))
    return run


def _traceback_case(kind, atype, mm=False):
    B, M, band = 16, 24, 9       # tests/test_align.py's traceback config
    T = M + band - 1
    pats, plens, texts, _ = _batch(KINDS.index(kind) * 7 + TYPES.index(atype),
                                   B, M, T)
    tlens = np.minimum(plens + band - 1, T).astype(np.int32)
    tlens[:4] = [t for _, t in EDGES]
    # a read with a 2-base deletion, and one 3 bases into its window with
    # a 2-base insertion (an I moves the walk one band cell left)
    pats[6] = np.concatenate([texts[6, :8], texts[6, 10:10 + M - 8]])
    pats[7] = np.concatenate([texts[7, 3:11], [1, 2],
                              texts[7, 11:11 + M - 10]])
    plens[6:8] = M
    tlens[6:8] = T
    args = (pats, plens, texts, tlens)
    mms = _mm(7, B, M) if mm else None

    def run(pkg):
        mod, fn = ((jtypes, jtb.batch_traceback_banded) if pkg == "jax"
                   else (ttypes, ttb.batch_traceback_banded))
        return fn(*_inputs(pkg, args), _aligner(mod, kind, atype), band,
                  mismatch_scores=_opt(pkg, mms))
    return run


def _full_traceback_case(atype):
    B, M, T = 8, 30, 64
    rng = np.random.default_rng(8)
    texts = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    pats = np.zeros((B, M), np.int32)
    for b in range(B):
        s = 3 + 2 * b
        if b % 2:     # a 12-base deletion, outside any practical band
            pats[b] = np.concatenate([texts[b, s:s + 15],
                                      texts[b, s + 27:s + 42]])
        else:
            pats[b] = texts[b, s:s + M]
    pats[1, 3] = (pats[1, 3] + 1) % 4
    plens = np.full(B, M, np.int32)
    tlens = np.full(B, T, np.int32)
    plens[2], tlens[3] = 1, 0
    args = (pats, plens, texts, tlens)
    mms = _mm(9, B, M)

    def run(pkg):
        mod, fn = ((jtypes, jtb.batch_traceback_full_scan) if pkg == "jax"
                   else (ttypes, ttb.batch_traceback_full_scan))
        return fn(*_inputs(pkg, args), _aligner(mod, "gotoh", atype),
                  mismatch_scores=_opt(pkg, mms))
    return run


# gap penalties so large that rows past the text's end fall below NEG_INF
# within a few rows: there the library's unfloored prefix max (no floor at
# NEG_INF, unlike K3's) sets other F-extension bits, which the walks read
HEAVY = 1_000_000


def _heavy_inputs():
    B, M, band = 8, 40, 5
    pats, plens, texts, _ = _batch(77, B, M, M + band - 1)
    plens[:] = M
    tlens = np.full(B, M + band - 1, np.int32)
    tlens[4:] = (1, 2, 3, 10)        # rows past the text's end
    return (pats, plens, texts, tlens), band


def _heavy_case(atype, fn_name):
    args, band = _heavy_inputs()

    def run(pkg):
        mod, fn = ((jtypes, getattr(jbatch, fn_name, None)
                    or getattr(jtb, fn_name)) if pkg == "jax" else
                   (ttypes, getattr(tbatch, fn_name, None)
                    or getattr(ttb, fn_name)))
        sc = mod.GotohScoring(2, -1, -HEAVY, -HEAVY, -HEAVY, -HEAVY)
        return fn(*_inputs(pkg, args),
                  mod.make_gotoh_aligner(mod.AlignmentType[atype], sc), band)
    return run


def _myers_inputs(M, n_symbols):
    B, N = 12, 90 + M
    pats, plens, texts, tlens = _batch(M * 10 + n_symbols, B, M, N,
                                       n_sym=n_symbols, edges=False)
    plens[0] = 0                 # the pattern's last row is word -1
    texts[0, 0] = n_symbols      # an N at the text's start: distance -1
    pats[1, 2] = 2               # the read over an N: an exact hit in the
    texts[1, 20:20 + M] = pats[1]    # XLA Myers, where the N matches every
    texts[1, 22] = n_symbols         # symbol; one mismatch (N as A) in K4
    plens[1], tlens[1] = M, N
    texts[2, ::9] = n_symbols
    plens[3], tlens[4] = 1, 0
    if M > 4:                    # an exact hit at 40
        texts[5, 40:40 + M] = pats[5]
        plens[5], tlens[5] = M, N
    return pats, plens, texts, tlens


def _myers_case(M, n_symbols):
    args = _myers_inputs(M, n_symbols)

    def run(pkg):
        fn = (jmyers.myers_semiglobal if pkg == "jax"
              else tmyers.myers_semiglobal)
        return fn(*_inputs(pkg, args), n_symbols=n_symbols)
    return run


def _inputs(pkg, arrays):
    return tuple(_opt(pkg, a) for a in arrays)


def _opt(pkg, a):
    if a is None:
        return None
    return jnp.asarray(a) if pkg == "jax" else torch.from_numpy(
        np.ascontiguousarray(a))


CASES = {}
for _k in KINDS:
    for _t in TYPES:
        for _s in FULL_SHAPES:
            CASES[f"full-{_k}-{_t}-{_s[1]}x{_s[2]}"] = _full_case(_k, _t, _s)
        for _w in BANDS:
            CASES[f"banded-{_k}-{_t}-W{_w}"] = _banded_case(_k, _t, _w)
        CASES[f"traceback-{_k}-{_t}"] = _traceback_case(_k, _t)
for _t in TYPES:
    CASES[f"full-mm-{_t}"] = _full_case("gotoh", _t, FULL_SHAPES[0], mm=True)
    CASES[f"banded-mm-{_t}"] = _banded_case("gotoh", _t, 9, mm=True)
    CASES[f"full-blosum62-{_t}"] = _full_case(None, _t, (6, 25, 40),
                                              matrix=True)
    CASES[f"banded-blosum62-{_t}"] = _banded_case(None, _t, 9, matrix=True)
    CASES[f"traceback-mm-{_t}"] = _traceback_case("gotoh", _t, mm=True)
    CASES[f"traceback-full-scan-{_t}"] = _full_traceback_case(_t)
for _t in ("GLOBAL", "SEMI_GLOBAL"):
    CASES[f"banded-heavy-gaps-{_t}"] = _heavy_case(_t, "batch_score_banded")
    CASES[f"traceback-heavy-gaps-{_t}"] = _heavy_case(
        _t, "batch_traceback_banded")
for _m in (4, 33, 100):
    for _n in (4, 5):
        CASES[f"myers-M{_m}-S{_n}"] = _myers_case(_m, _n)


@pytest.fixture(scope="module")
def jax_results():
    """Every case's JAX result as numpy arrays, traced on parallel threads."""
    def one(name):
        return tuple(np.asarray(x) for x in CASES[name]("jax"))

    with ThreadPoolExecutor(8) as pool:
        futures = {n: pool.submit(one, n) for n in CASES}
        return {n: f.result() for n, f in futures.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_library_equals_jax(jax_results, name):
    got = CASES[name]("torch")
    want = jax_results[name]
    assert len(got) == len(want)
    for field, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.int32, (name, field)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name} {field}")
    if name.startswith("traceback"):
        for b in range(len(want[1])):    # ops, n_ops
            assert (ttb.ops_to_chars(got.ops[b].numpy(), got.n_ops[b])
                    == jtb.ops_to_chars(want[1][b], want[2][b]))
            assert (ttb.cigar_to_string(got.ops[b].numpy(), got.n_ops[b])
                    == jtb.cigar_to_string(want[1][b], want[2][b]))


def test_cases_reach_their_branches(jax_results):
    """The inputs reach what they are there for: GLOBAL's small-length
    recomputation, LOCAL's zero stop, indels in the walks, the XLA Myers'
    -1 at plen = 0 and an N matching a pattern."""
    got = jax_results["full-gotoh-GLOBAL-16x24"][0]
    assert got[0] == 0 and got[1] == -3 and got[2] == -3   # (0,0) (0,1) (1,0)
    for t in TYPES[1:]:
        chars = [jtb.ops_to_chars(o, n) for o, n in
                 zip(*jax_results[f"traceback-gotoh-{t}"][1:3])]
        assert "DD" in chars[6] and "II" in chars[7], (t, chars[6:8])
    glob = jax_results["traceback-gotoh-GLOBAL"]      # the whole text
    assert glob[6][6] - glob[5][6] == 32 and glob[2][6] >= 32
    loc = jax_results["traceback-gotoh-LOCAL"]
    assert (loc[3] > 0).any() or (loc[4] < 24).any()       # clipped ends
    full = jax_results["traceback-full-scan-SEMI_GLOBAL"]
    assert "12D" in jtb.cigar_to_string(full[1][1], full[2][1])
    for m in (4, 33, 100):
        dist = jax_results[f"myers-M{m}-S4"][0]
        assert dist[0] == -1, m


@pytest.mark.parametrize("M", (33, 100))
def test_myers_differs_from_k4_only_where_jax_gathers_out_of_range(M):
    """The XLA Myers (the port's ``align.myers``) and K4's contract
    (``align.kernels.myers_semiglobal_plain``) agree on every row but the
    two where the XLA gathers leave their arrays: plen = 0 (word -1, bit
    31) and a text N (a code past the Peq table matches every symbol in
    the XLA function, and reads as A in K4)."""
    pats, plens, texts, tlens = _myers_inputs(M, 4)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (pats, plens, texts, tlens)]
    xla = tmyers.myers_semiglobal(*t)
    k4 = K.myers_semiglobal_plain(*t)
    differ = ((xla.distance != k4[0]) | (xla.text_end != k4[1])).numpy()
    assert differ[0] and differ[1]          # plen 0; the read over an N
    has_n = (np.where(np.arange(texts.shape[1])[None, :] < tlens[:, None],
                      texts, 0) == 4).any(axis=1)
    assert not differ[~has_n & (plens > 0)].any()
    assert xla.distance[0] == -1 and k4[0][0] == 0
    assert xla.distance[1] == 0 and k4[0][1] == 1


def test_myers_golden_copy():
    rng = np.random.default_rng(3)
    for _ in range(5):
        p = rng.integers(0, 4, rng.integers(1, 12))
        t = rng.integers(0, 4, rng.integers(1, 30))
        assert tmyers.myers_golden(p, t) == jmyers.myers_golden(p, t)


def test_exports_match_jax():
    """``nvbio_tpu_torch.align`` exports ``nvbio_tpu.align``'s names, and
    the modules hold the library's other public names."""
    jnames = {n for n in dir(jalign) if not n.startswith("_")}
    tnames = {n for n in dir(talign) if not n.startswith("_")}
    assert jnames - {"golden", "pallas_kernels"} <= tnames
    for mod, names in ((tscoring, ["BLOSUM62"]),
                       (tmyers, ["myers_semiglobal", "MyersResult",
                                 "myers_golden"]),
                       (ttb, ["batch_traceback_full_scan", "ops_to_chars",
                              "batch_traceback_banded"]),
                       (tbatch, ["BestSink", "batch_score_full",
                                 "batch_score_banded"])):
        for n in names:
            assert hasattr(mod, n), (mod.__name__, n)
    np.testing.assert_array_equal(tscoring.BLOSUM62, jscoring.BLOSUM62)
    for kind in KINDS:     # frozen, hashable, the JAX package's values
        for t in TYPES:
            a, b = _aligner(ttypes, kind, t), _aligner(jtypes, kind, t)
            assert hash(a) == hash(_aligner(ttypes, kind, t))
            assert a.type == b.type
            assert (dataclasses.astuple(a.scoring)
                    == dataclasses.astuple(b.scoring))
    assert ttypes.EditDistanceAligner().scoring == ttypes.SWScoring(0, -1,
                                                                     -1, -1)
    assert ttypes.SmithWatermanAligner().type == ttypes.LOCAL
    assert ttypes.HammingAligner().type == ttypes.SEMI_GLOBAL
