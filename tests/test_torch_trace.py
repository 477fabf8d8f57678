"""The mapper's stage spans and counters (``utils.timers``), on the CPU:
under a CPU ``torch.profiler`` an SE q-gram batch, an SE FM batch and a
PE batch open the ``nvbio.*`` spans with the right names and nesting; with
no profiler a span is the shared null context, no ``record_function`` is
entered and nothing is counted; the counters equal counts made apart from
them; ``map --profile`` logs the counters. (The benchmark's
``harness/stage_trace.py`` reads a profile of them: its tests are under
``benchmark/tests``.)"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nvbio_tpu_torch.bowtie import paired, pipeline
from nvbio_tpu_torch.bowtie.params import MapParams
from nvbio_tpu_torch.io.fastq import ReadBatch
from nvbio_tpu_torch.io.reference import Reference
from nvbio_tpu_torch.utils import timers

torch.set_num_threads(1)

L = 80
G = 30000
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5, maxins=400)


def _rc(codes):
    return (3 - codes)[::-1]


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(19).integers(0, 4, G).astype(np.uint8)


def _batch(codes):
    B = len(codes)
    codes = np.asarray(codes, np.uint8)
    quals = np.full(codes.shape, 30, np.uint8)
    return ReadBatch([f"r{i}" for i in range(B)], codes, quals,
                     np.full(B, L, np.int32))


@pytest.fixture(scope="module")
def se_batch(genome):
    """48 reads: exact, 2% substitutions, one in every seed window (only
    the reseed pass's 1-mismatch seeds place them), random; odd ones
    reverse-complemented."""
    rng = np.random.default_rng(7)
    reads = []
    for i in range(48):
        p = int(rng.integers(0, G - L))
        r = genome[p:p + L].copy()
        kind = i % 4
        if kind == 1:
            m = rng.random(L) < 0.02
            r[m] = (r[m] + 1) % 4
        elif kind == 2:
            r[5:75:9] = (r[5:75:9] + 1) % 4
        elif kind == 3:
            r = rng.integers(0, 4, L).astype(np.uint8)
        reads.append(_rc(r) if i % 2 else r)
    return _batch(reads)


@pytest.fixture(scope="module")
def pe_batches(genome):
    """24 FR pairs, fragments of 200-300 bp; every third mate 2 has a
    substitution every 10 bases (rescue places it)."""
    rng = np.random.default_rng(8)
    r1, r2 = [], []
    for i in range(24):
        frag = int(rng.integers(200, 300))
        p = int(rng.integers(0, G - frag))
        a, b = genome[p:p + L].copy(), _rc(genome[p + frag - L:p + frag])
        if i % 3 == 0:
            b = b.copy()
            b[9::10] = (b[9::10] + 1) % 4
        r1.append(a)
        r2.append(b)
    return _batch(r1), _batch(r2)


def _mapper(genome, seeding):
    ref = Reference(["t"], np.array([0, G], np.int64), genome, None)
    return pipeline.ReadMapper.build(
        ref, MapParams(**PARAMS, seeding=seeding), device="cpu")


@pytest.fixture(scope="module")
def mappers(genome):
    return {s: _mapper(genome, s) for s in ("qgram", "fmi")}


def _profiled(fn):
    """(fn's result, the nvbio spans of its profile as (name, parent)
    pairs in start order; parent None at the top), counters reset first."""
    timers.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(timers.SPAN_PREFIX):
            start = ev.start_ns()
            spans.append((ev.name(), start, start + ev.duration_ns()))
    spans.sort(key=lambda s: (s[1], -s[2]))
    pairs = []
    for name, s, e in spans:
        around = [sp for sp in spans if sp[1] <= s and e <= sp[2]
                  and sp != (name, s, e)]
        parent = min(around, key=lambda sp: sp[2] - sp[1])[0] \
            if around else None
        pairs.append((name, parent))
    return out, pairs


D, U, S, V, X, R, F = (f"nvbio.{n}" for n in (
    "dispatch", "upload", "seed", "vote", "extend", "reseed", "finalize"))
# a single-end batch: the first pass in the dispatch, the reseed pass's
# seed, vote and extend inside the reseed span; then fetch and wait
SE_SPANS = [(D, None), (U, D), (S, D), (V, D), (X, D), (R, D), (S, R),
            (V, R), (X, R), (F, D), ("nvbio.fetch", None),
            ("nvbio.wait", None)]


@pytest.mark.parametrize("seeding", ["qgram", "fmi"])
def test_se_batch_spans(mappers, se_batch, seeding):
    m = mappers[seeding]
    host, pairs = _profiled(lambda: m.fetch(m.dispatch(se_batch)).wait())
    assert pairs == SE_SPANS
    assert host["mapped"].sum() >= 24


def test_pe_batch_spans(mappers, pe_batches):
    m = mappers["qgram"]
    (_, _, pinfo), pairs = _profiled(
        lambda: paired.dispatch_pair_batch(m, *pe_batches))
    assert pairs == [(D, None), (U, D), (U, D), (S, D), (V, D), (X, D),
                     (S, D), (V, D), (X, D), ("nvbio.rescue", D), (F, D)]
    assert pinfo["rescued2"].any() and pinfo["proper"].sum() >= 20


def test_dispatch_ordinal_joins_a_batch(mappers, se_batch):
    m = mappers["qgram"]
    first = m.dispatched
    res = m.fetch(m.dispatch(se_batch))
    assert m.dispatched == first + 1 and res.ordinal == first


def test_off_without_a_profiler(mappers, se_batch, monkeypatch):
    def entered(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(timers, "record_function", entered)
    timers.reset_counters()
    assert not torch.autograd._profiler_enabled()
    assert timers.span("seed") is timers.span("wait", 3)
    assert isinstance(timers.span("seed"), contextlib.nullcontext)
    timers.count("cand_valid", torch.ones(3, dtype=torch.bool))
    m = mappers["fmi"]
    m.fetch(m.dispatch(se_batch)).wait()
    paired.dispatch_pair_batch(m, se_batch, se_batch)
    assert timers.counters() == {}


def test_counters_equal_independent_counts(mappers, se_batch, monkeypatch):
    """Each read_candidates call's valid slots and B x C, the reseed
    queue's B2 rows and the first pass's reads below score_min."""
    m = mappers["qgram"]
    calls = []
    orig = pipeline.read_candidates

    def seen(*a, **k):
        calls.append(orig(*a, **k))
        return calls[-1]

    monkeypatch.setattr(pipeline, "read_candidates", seen)
    _profiled(lambda: m.dispatch(se_batch))
    got = timers.counters()
    first, second = calls
    B = len(se_batch.names)
    B2 = max(8, min(B, round(B * m.params.reseed_frac / 8) * 8))
    best = pipeline._reduce_best2(first, m.params)[0]
    below = (best < pipeline.score_min_of(first["lens"], m.params)) & \
        (first["lens"] >= m.params.seed_len)
    assert second["reads"].shape[0] == B2
    assert got == dict(
        cand_valid=int(first["valid"].sum() + second["valid"].sum()),
        cand_slots=first["valid"].numel() + second["valid"].numel(),
        reseed_rows=B2, reseed_needed=int(below.sum()))
    # a quarter of the reads are random and a quarter need the 1-mismatch
    # seeds: more than the queue's 8 rows (the overflow)
    assert got["reseed_needed"] > B2
    assert 0 < got["cand_valid"] < got["cand_slots"]
    # read again: the device values were read back once, the totals stay
    assert timers.counters() == got


def test_count_holds_ints_counts_and_masks():
    """Host ints, 0-dim counts and masks are held as they are, with no op,
    until the counters are read; then each tensor's elements are added."""
    timers.reset_counters()
    four = torch.tensor(4, dtype=torch.int32)
    mask = torch.tensor([[True, True], [False, True]])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timers.recording()
        timers.count("a", 3)
        timers.count("a", four)
        timers.count("a", mask)
        timers.count("b", 0)
    assert timers._counters["a"][1] is four
    assert timers._counters["a"][2] is mask
    assert not [ev for ev in prof.events() if ev.name.startswith("aten::")]
    assert not timers.recording()
    assert timers.counters() == {"a": 10, "b": 0}
    timers.reset_counters()
    assert timers.counters() == {}


def test_map_profile_logs_counters(tmp_path, genome, se_batch, capsys):
    from nvbio_tpu_torch.__main__ import main
    from nvbio_tpu_torch.alphabet import codes_to_string

    ref = tmp_path / "g.fa"
    ref.write_text(">t\n" + codes_to_string(genome) + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("".join(
        f"@r{i}\n{codes_to_string(c)}\n+\n{'I' * L}\n"
        for i, c in enumerate(se_batch.codes)))
    rc = main(["map", str(ref), str(fq), "-o", str(tmp_path / "o.sam"),
               "--device", "cpu", "--batch", "32", "--max-read-len", str(L),
               "--seed-len", "16", "--seed-stride", "10", "--profile",
               str(tmp_path / "prof")])
    assert rc == 0
    line = next(ln for ln in capsys.readouterr().err.splitlines()
                if "] counters: " in ln)
    got = dict(kv.split("=") for kv in line.split("] counters: ")[1].split())
    assert set(got) == {"cand_valid", "cand_slots", "reseed_rows",
                        "reseed_needed"}
    assert int(got["reseed_rows"]) == 2 * 8
