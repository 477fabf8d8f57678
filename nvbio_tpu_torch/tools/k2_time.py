"""K2 (``kernels.banded_traceback``), K2-WIDE (``banded_traceback_wide``),
the local candidate stage, the mate-rescue stage (K4 and K3) and K5
(``regtile_score_blocked``) timed on the card, for comparing two checkouts
and for choosing K2's and K4's lanes per read.

    python nvbio_tpu_torch/tools/k2_time.py [--root DIR]
        [--what k2,wide,local,rescue,k5] [--sweep] [--out FILE]

Times the wrappers of the checkout at ``--root`` (default: the one holding
this file) on seeded inputs: the median of 7 single calls (CUDA events
around each call, so the host's work before the launch counts) and the
per-call time of 10 calls queued back to back (median of 5; the card's
time). Each output is checked bit for bit against the plain version (or,
for the local stage, the two routes against each other) once. Only the
wrappers' contracts are used, so an older checkout runs too: time two
checkouts in one machine by running this once per checkout, in
alternation. ``--what`` (default ``k2``) picks, comma-separated:

- ``k2``: K2 at the single-end shape, B=32768 reads of M=100 against their
  windows of M+W-1 at W=31, SEMI_GLOBAL and LOCAL (every other read ending
  in 15 random bases).
- ``wide``: K2-WIDE and K2-WIDE-LOCAL at the full-matrix mate traceback's
  shape, the same reads against their windows left-padded by M never-match
  symbols, W = T+M = 230.
- ``local``: the local candidate stage at B=32768, C=24, L=100, W=31
  (--local scoring, slots split forward/reverse at 12, windows at the
  truth, near it and at random): the route of the flat scorer (the
  (B*C, L) patterns and penalties by torch.where, the (B*C, L+W-1)
  windows by extract_window, K3-LOCAL) and, where the checkout's
  ``banded_score_cands`` takes ``local=``, the candidate kernel's LOCAL
  route; each with its peak device memory above what was allocated before.
- ``rescue``: the mate-rescue stage of ``bowtie/paired.py`` for both mates
  of B=32768 pairs (M=100, the mate in a window of maxins + W = 531
  bases; K4 locates it, K3 rescores it at W=31 over M+W-1 = 130 bases),
  with its peak device memory: the window route (``extract_window``, then
  the contract-form ``myers_semiglobal`` and ``banded_score``) and, where
  the checkout has them, the packed entries (``myers_semiglobal_windows``,
  ``banded_score_windows``, the route of the mapping path); then each
  kernel alone, and K4's packed entry at M=100 and 150.
- ``k5``: K5 as bench.py's GCUPS leg runs it (bench.py:421-467): G=4096
  blocks of 1024 alignments, L=100, W=31 and 17, seq_f, full_text and
  uniform_plen, random codes in [0, 4) and the flat mismatch plane, made
  on the card from a seed (``k5_operands.bench_operands``, of the checkout
  holding this file); GCUPS = alignments * L * W over the queued time.

``--sweep`` also times, queued, every batch size of ``SWEEP_B`` under each
group size of ``kernels.K2_GROUPS`` (the checkout's wrapper must take
``group=``): where ``kernels.k2_group`` switches from 4 lanes per read to 1.
Prints one JSON object as its last line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

if __package__:
    from .k5_operands import G_BENCH, L_BENCH, bench_operands
else:  # run as a script: this file's directory leads sys.path
    from k5_operands import G_BENCH, L_BENCH, bench_operands

B, M, MAX_DIST = 32768, 100, 15
W = 2 * MAX_DIST + 1
SWEEP_B = (2048, 4096, 8192, 12288, 16384, 20480, 24576, 32768)
GENOME_LEN = 4_000_000
SEED = 20261017
C, NCH = 24, 12


def cuda_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_queued(fn, calls: int = 10, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def inputs(dev):
    """Reads of M bases with ~1% substitutions, a third with a 1-base
    deletion and a third with an insertion, against their true windows;
    per-position mismatch penalties from random qualities; the LOCAL
    patterns end in 15 random bases on every other read."""
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, size=GENOME_LEN, dtype=np.int32)
    TW = M + W - 1
    starts = rng.integers(MAX_DIST, GENOME_LEN - 2 * M, size=B)
    win = genome[starts[:, None] + np.arange(M + 1)]
    kind = rng.integers(0, 3, size=B)
    cut = rng.integers(10, M - 10, size=B)[:, None]
    j = np.arange(M)[None, :]
    dele = np.where(j < cut, win[:, :M], win[:, 1:])
    ins = np.where(j < cut, win[:, :M],
                   np.where(j == cut, rng.integers(0, 4, size=(B, 1)),
                            np.take_along_axis(win, np.maximum(j - 1, 0), 1)))
    pats = np.where((kind == 1)[:, None], dele,
                    np.where((kind == 2)[:, None], ins, win[:, :M]))
    sub = rng.random((B, M)) < 0.01
    pats = np.where(sub, (pats + rng.integers(1, 4, size=(B, M))) % 4, pats)
    tailed = pats.copy()
    tailed[::2, M - 15:] = rng.integers(0, 4, size=(B // 2, 15))
    texts = genome[(starts - MAX_DIST)[:, None] + np.arange(TW)]
    mm = -(2 + (4 * rng.integers(2, 41, size=(B, M))) // 40)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    # local candidates: reads on either strand, slot 0 of their half at the
    # truth, slot 1 near it, the rest at random
    is_rc = rng.random(B) < 0.5
    reads = np.where(is_rc[:, None], (3 - tailed)[:, ::-1], tailed)
    w0 = rng.integers(0, GENOME_LEN - TW, size=(B, C))
    half = np.where(is_rc, NCH, 0)
    w0[np.arange(B), half] = starts - MAX_DIST
    w0[np.arange(B), half + 1] = np.clip(
        starts - MAX_DIST + rng.integers(-9, 10, B), 0, GENOME_LEN - TW)
    return dict(starts=starts, pats=t(pats), tailed=t(tailed),
                lens=t(np.full(B, M)),
                texts=t(texts), tlens=t(np.full(B, TW)), mm=t(mm),
                genome=genome, reads=t(reads), rc=t((3 - reads)[:, ::-1]),
                mm_rc=t(mm[:, ::-1]),
                w0=torch.from_numpy(w0).to(dev),
                wlens=t(np.full((B, C), TW)))


def time_k2(K, MapParams, x, res):
    for name, pats, sc, local in (
            ("semiglobal", x["pats"], MapParams().scoring, False),
            ("local", x["tailed"], MapParams.local().scoring, True)):
        args = (pats, x["lens"], x["texts"], x["tlens"], sc, W, x["mm"])
        got = K.banded_traceback(*args, local=local)
        want = K.banded_traceback_plain(*args, local=local)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"k2_time: {name} differs from the plain version")
        fn = lambda: K.banded_traceback(*args, local=local)  # noqa: E731
        res[name] = dict(equal=True, ms=cuda_ms(fn),
                         ms_queued=cuda_ms_queued(fn))
        print(f"[k2] {name}: {res[name]}", flush=True)


def time_wide(K, MapParams, x, res):
    """K2-WIDE at W = T+M over the windows left-padded by M code-8 symbols
    (as traceback.batch_traceback_full builds them)."""
    wf = M + W - 1 + M
    texts = torch.cat([torch.full((B, M), 8, dtype=torch.int32,
                                  device=x["texts"].device), x["texts"]], 1)
    tlens = x["tlens"] + M
    for name, pats, sc, local in (
            ("wide_semiglobal", x["pats"], MapParams().scoring, False),
            ("wide_local", x["tailed"], MapParams.local().scoring, True)):
        args = (pats, x["lens"], texts, tlens, sc, wf, x["mm"])
        got = K.banded_traceback_wide(*args, local=local)
        want = K.banded_traceback_wide_plain(*args, local=local)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"k2_time: {name} differs from the plain version")
        del got, want
        fn = lambda: K.banded_traceback_wide(*args, local=local)  # noqa: E731
        res[name] = dict(W=wf, ms=cuda_ms(fn), ms_queued=cuda_ms_queued(fn))
        print(f"[wide] {name}: {res[name]}", flush=True)


def time_local_stage(K, MapParams, x, res):
    """The local candidate stage: the flat route as the local branch of
    read_candidates built it, and the candidate kernel's LOCAL route."""
    from nvbio_tpu_torch.packed import extract_window, pack, words_to_tensor

    sc = MapParams.local().scoring
    TW = M + W - 1
    words = words_to_tensor(pack(x["genome"], 2), x["reads"].device)
    reads, rc, mm, mm_rc = x["reads"], x["rc"], x["mm"], x["mm_rc"]
    lens, w0, wlens = x["lens"], x["w0"], x["wlens"]

    def flat():
        flip = (torch.arange(C, device=reads.device) >= NCH)[None, :, None]
        pats = torch.where(flip, rc[:, None, :], reads[:, None, :])
        mm_flat = torch.where(flip, mm_rc[:, None, :], mm[:, None, :])
        win = extract_window(words, w0.reshape(B * C), TW)
        s, _ = K.banded_score(pats.reshape(B * C, M),
                              lens[:, None].expand(B, C).reshape(B * C), win,
                              wlens.reshape(B * C), sc, W,
                              mm_flat.reshape(B * C, M), local=True)
        return s.reshape(B, C)

    routes = [("local_stage_flat", flat)]
    if "local" in inspect.signature(K.banded_score_cands).parameters:
        routes.append(("local_stage_cands", lambda: K.banded_score_cands(
            reads, rc, lens, w0, wlens, words, sc, W, NCH, mm, mm_rc,
            local=True)[0]))
    want = None
    for name, fn in routes:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise SystemExit(f"k2_time: {name} differs from the flat route")
        del got
        res[name] = dict(B=B, C=C, ms=cuda_ms(fn),
                         ms_queued=cuda_ms_queued(fn), peak_bytes=peak)
        print(f"[local] {name}: {res[name]}", flush=True)


MAXINS = 500
RW = MAXINS + W                  # K4's window: maxins + band
K5_BANDS = (31, 17)


def time_k5(K, MapParams, res):
    """K5 at bench.py's shape, W = 31 and 17: res["k5_w<W>"]."""
    sc = MapParams().scoring
    dev = torch.device("cuda")
    for wk in K5_BANDS:
        ops = bench_operands(wk, dev, sc.mismatch)
        kw = dict(scoring=sc, band=wk, length=L_BENCH, seq_f=True,
                  full_text=True, uniform_plen=True,
                  unroll=10 if wk == 31 else 4)
        got = K.regtile_score_blocked(*ops, **kw)
        want = K.regtile_score_blocked_plain(*ops, **kw)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"k2_time: K5 W={wk} differs from the plain "
                             f"version")
        del want
        fn = lambda: K.regtile_score_blocked(*ops, **kw)  # noqa: E731,B023
        cells = G_BENCH * 1024 * L_BENCH * wk
        row = dict(G=G_BENCH, L=L_BENCH, W=wk, ms=cuda_ms(fn),
                   ms_queued=cuda_ms_queued(fn))
        row["gcups"] = cells / (row["ms_queued"] * 1e-3) / 1e9
        res[f"k5_w{wk}"] = row
        print(f"[k5] W={wk}: {row}", flush=True)
        del ops, got
        torch.cuda.empty_cache()


def time_rescue(K, MapParams, x, res):
    """The rescue stage (both mates) by the window route and by the packed
    entries, each kernel alone, and K4's lane groups."""
    from nvbio_tpu_torch.packed import extract_window, pack, words_to_tensor

    dev = x["pats"].device
    sc = MapParams().scoring
    n = GENOME_LEN
    words = words_to_tensor(pack(x["genome"], 2), dev)
    rng = np.random.default_rng(SEED + 1)
    starts = x["starts"]
    TWr = M + W - 1
    mates = []
    for _ in range(2):   # each mate's window holds it
        ws = np.clip(starts - rng.integers(0, RW - M, size=B), 0, n - 1)
        mates.append((x["pats"], x["lens"], x["mm"],
                      torch.from_numpy(ws).to(dev)))

    def stage(packed):
        out = []
        for other, olen, omm, wstart in mates:
            wlen = (n - wstart).clamp(min=0, max=RW).to(torch.int32)
            if packed:
                _, tend = K.myers_semiglobal_windows(other, olen, words,
                                                     wstart, wlen, RW)
            else:
                _, tend = K.myers_semiglobal(
                    other, olen, extract_window(words, wstart, RW), wlen)
            rw0 = (wstart + tend.to(torch.int64)
                   - (olen.to(torch.int64) + MAX_DIST)).clamp(min=0)
            rw0 = rw0.clamp(max=n - 1)
            rwlen = (n - rw0).clamp(min=0, max=TWr).to(torch.int32)
            if packed:
                s, _ = K.banded_score_windows(other, olen, words, rw0, rwlen,
                                              sc, W, omm)
            else:
                s, _ = K.banded_score(other, olen,
                                      extract_window(words, rw0, TWr), rwlen,
                                      sc, W, omm)
            out.append(s)
        return torch.stack(out)

    routes = [("rescue_windows", False)]
    if hasattr(K, "myers_semiglobal_windows"):
        routes.append(("rescue_packed", True))
    want = None
    for name, packed in routes:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = stage(packed)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise SystemExit(f"k2_time: {name} differs from the window route")
        fn = lambda: stage(packed)  # noqa: E731,B023
        res[name] = dict(B=B, M=M, T=RW, ms=cuda_ms(fn),
                         ms_queued=cuda_ms_queued(fn), peak_bytes=peak,
                         found=float((got > -60).float().mean()))
        print(f"[rescue] {name}: {res[name]}", flush=True)

    # each kernel alone, at the first mate's windows
    other, olen, omm, wstart = mates[0]
    wlen = (n - wstart).clamp(min=0, max=RW).to(torch.int32)
    win = extract_window(words, wstart, RW)
    rw0 = (wstart + 37).clamp(max=n - 1)
    rwlen = (n - rw0).clamp(min=0, max=TWr).to(torch.int32)
    rwin = extract_window(words, rw0, TWr)
    alone = [("k4", lambda: K.myers_semiglobal(other, olen, win, wlen)),
             ("k3", lambda: K.banded_score(other, olen, rwin, rwlen, sc, W,
                                           omm)),
             ("k3_no_plane", lambda: K.banded_score(other, olen, rwin, rwlen,
                                                    sc, W))]
    if hasattr(K, "myers_semiglobal_windows"):
        alone += [
            ("k4_packed", lambda: K.myers_semiglobal_windows(
                other, olen, words, wstart, wlen, RW)),
            ("k3_packed", lambda: K.banded_score_windows(
                other, olen, words, rw0, rwlen, sc, W, omm)),
            ("k3_packed_no_plane", lambda: K.banded_score_windows(
                other, olen, words, rw0, rwlen, sc, W))]
    for name, fn in alone:
        res[name] = dict(ms=cuda_ms(fn), ms_queued=cuda_ms_queued(fn))
        print(f"[rescue] {name}: {res[name]}", flush=True)
    if not hasattr(K, "myers_semiglobal_windows"):
        return
    # K4's packed entry at M = 100 (4 words) and 150 (5 words)
    for mw in (100, 150):
        pats = torch.from_numpy(x["genome"][
            starts[:, None] + np.arange(mw)].astype(np.int32)).to(dev)
        plen = torch.full((B,), mw, dtype=torch.int32, device=dev)
        fn = lambda: K.myers_semiglobal_windows(  # noqa: E731
            pats, plen, words, wstart, wlen, RW)  # noqa: B023
        key = f"k4_packed_M{mw}"
        res[key] = dict(ms=cuda_ms(fn), ms_queued=cuda_ms_queued(fn))
        print(f"[rescue] {key}: {res[key]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
                    help="checkout whose nvbio_tpu_torch is timed")
    ap.add_argument("--what", default="k2",
                    help="comma-separated: k2, wide, local, rescue, k5")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every SWEEP_B under each group size")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_time: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(a.root))
    from nvbio_tpu_torch.align import kernels as K
    from nvbio_tpu_torch.bowtie.params import MapParams

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    K.build()
    x = inputs("cuda")
    res = dict(root=os.path.abspath(a.root), kernels_file=K.__file__,
               card=card, shape=f"B={B} M={M} W={W}")
    what = a.what.split(",")
    for part, fn in (("k2", time_k2), ("wide", time_wide),
                     ("local", time_local_stage), ("rescue", time_rescue)):
        if part in what:
            fn(K, MapParams, x, res)
    if "k5" in what:
        time_k5(K, MapParams, res)
    if a.sweep:
        if "group" not in inspect.signature(K.banded_traceback).parameters:
            raise SystemExit("k2_time: --sweep needs a wrapper with group=")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        sweep = []
        for nb in SWEEP_B:
            args = (x["pats"][:nb].contiguous(), x["lens"][:nb].contiguous(),
                    x["texts"][:nb].contiguous(), x["tlens"][:nb].contiguous(),
                    MapParams().scoring, W, x["mm"][:nb].contiguous())
            row = dict(B=nb, k2_group=K.k2_group(nb, sms))
            for g in K.K2_GROUPS:
                row[f"group{g}_ms_queued"] = cuda_ms_queued(
                    lambda: K.banded_traceback(*args, group=g))  # noqa: B023
            sweep.append(row)
            print(f"[k2] sweep {row}", flush=True)
        res["sweep"] = sweep
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
