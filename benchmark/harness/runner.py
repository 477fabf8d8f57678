"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the correctness check, and the result line.

Set-up, timed from process start to the first timed batch: the genome and
the read pool made from ``--seed``, the index built by
``ReadMapper.build``, and ``WARM_BATCHES`` batches through the window's
own loop (the first run in a checkout also compiles the kernels there).
The window dispatches batches from the pool for ``--seconds`` seconds and
drains the last; its rate is all reads completed over all its time. With
``--trace 1`` a traced window of ``TRACED_BATCHES`` batches follows it
under ``torch.profiler``. Then the program's state is freed and the plain
reference judges a sample of the window's results.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from types import SimpleNamespace

import numpy as np

from benchmark.harness import genome as genome_mod
from benchmark.harness import traffic as traffic_mod
from benchmark.harness.spec import Spec

WARM_BATCHES = 2
TRACED_BATCHES = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "nvbio_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``nvbio_tpu_torch`` is not ``nvbio_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None, metavar="KEY=JSON",
                   help="run the correctness control: override one "
                        "mapping parameter (e.g. use_quality_penalties="
                        "false); never used by the benchmark's own runs")
    return p.parse_args(argv)


class Window:
    """The app's dispatch-ahead loop over the pool, with the window's
    per-batch consumer: the sensitivity count and what the correctness
    check judges."""

    def __init__(self, system, items, pool, kind, spec, seed, tracing):
        self.system, self.items, self.pool = system, items, pool
        self.kind, self.spec, self.seed = kind, spec, seed
        self.tracing = tracing
        self.max_dist = spec.config["map_params"]["max_dist"]
        self.per_batch = int(spec.traffic["sample_per_batch"])
        self.mates = ("1.", "2.") if kind == "paired" else ("",)
        for batch in pool:
            for pre in self.mates:
                k = pre[:-1]
                batch["origin_lo" + k] = batch["origin" + k] - self.max_dist
        self.reads = self.placed = 0
        self.unplaced, self.unplaced_reads, self.start_batch = [], 0, 0
        self.samples = []
        self.sampling = False

    def span(self, name):
        if not self.tracing:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("bench." + name)

    def consume(self, i: int, host: dict) -> None:
        """What the window's metrics need of batch i's results, without
        copying them (counting in place costs the loop less than copying
        into fresh memory): the count of reads placed on the simulated
        strand within max_dist of the simulated origin; while sampling,
        the sampled rows and, over the first pass through the pool, the
        unmapped reads."""
        truth = self.pool[i % len(self.pool)]
        B = len(host[self.mates[0] + "mapped"])
        self.reads += B * len(self.mates)
        for pre in self.mates:
            k = pre[:-1]
            # position - (origin - max_dist), in [0, 2 max_dist] unsigned
            off = host[pre + "window_start"] - truth["origin_lo" + k]
            off += host[pre + "text_start"]
            ok = off.view(np.uint64) <= 2 * self.max_dist
            ok &= host[pre + "mapped"]
            ok &= host[pre + "strand"] == truth["is_rc" + k]
            self.placed += int(np.count_nonzero(ok))
        if self.sampling:
            rng = np.random.default_rng([self.seed & (2**64 - 1), 0x5A3, i])
            rows = np.sort(rng.choice(B, min(self.per_batch, B),
                                      replace=False))
            # per-read arrays (not the batch's scalars, reseed_overflow)
            s = {key: v[rows] for key, v in host.items() if len(v) == B}
            s |= {key: v[rows] for key, v in truth.items()}
            self.samples.append(s)
            if self.kind != "paired" and i - self.start_batch < len(self.pool) \
                    and not host["reseed_overflow"].any():
                # every unmapped read of one pass over the pool (where the
                # reseed queue took every read that needed it)
                rows = np.flatnonzero(~host["mapped"])
                self.unplaced.append({k: truth[k][rows]
                                      for k in ("codes", "quals")})
                self.unplaced_reads += B

    def run(self, seconds: float | None = None, batches: int | None = None,
            start: int = 0) -> dict:
        """Dispatch batch i+1 (and enqueue its copies) before waiting on
        batch i, for ``seconds`` (then drain) or for ``batches``."""
        clock = time.perf_counter
        t0 = clock()
        pending, i, disp = None, start, []
        while True:
            go = (clock() - t0 < seconds) if batches is None \
                else (i - start < batches)
            nxt = None
            if go:
                with self.span("dispatch"):
                    td = clock()
                    fetched = self.system.dispatch(
                        self.items[i % len(self.items)], self.kind)
                    disp.append(clock() - td)
                nxt, i = (i, fetched), i + 1
            if pending is not None:
                with self.span("wait"):
                    host = pending[1].wait()
                with self.span("consume"):
                    self.consume(pending[0], host)
                del host
            if nxt is None:
                break
            pending = nxt
        return dict(batches=i - start, seconds=clock() - t0,
                    dispatch_s=disp, next=i)


def main(argv, root: str, t_start: float, device=None) -> int:
    """Run one cell; ``device`` None looks for the card (the benchmark's
    runs), a device name skips that look (tests)."""
    args = parse(argv)
    spec = Spec(root, args.workload)
    import torch

    if device is None:
        need = int(spec.cell["chips"])
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            print(f"benchmark: the cell needs {need} CUDA card(s); found "
                  f"{have}", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    from benchmark.harness.system import System

    cfg, tr = spec.config, spec.traffic
    kind = tr["kind"]
    control = None
    if args.control:
        key, val = args.control.split("=", 1)
        control = {key: json.loads(val)}
    genome = genome_mod.make_genome(cfg["genome"], args.seed)
    pool = traffic_mod.make_pool(genome, tr, args.seed, dev)
    system = System(cfg, genome, dev, control)
    index_build_s = system.build()
    items = system.items(pool, kind)
    win = Window(system, items, pool, kind, spec, args.seed, False)
    win.run(batches=WARM_BATCHES)
    if cuda:
        torch.cuda.synchronize()
    win.reads = win.placed = 0
    setup_s = time.time() - t_start

    win.sampling, win.start_batch = True, WARM_BATCHES
    window = win.run(seconds=args.seconds, start=WARM_BATCHES)
    win.sampling = False
    placed, reads = win.placed, win.reads

    trace = k1_calls = None
    if args.trace:
        trace, k1_calls = traced_window(win, system, window["next"], cuda)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    system.close()
    del items, system
    if cuda:
        torch.cuda.empty_cache()

    from benchmark.harness.reference import Judge

    samples = {k: np.concatenate([s[k] for s in win.samples])
               for k in win.samples[0]}
    unplaced = None
    if kind != "paired":
        L = int(tr["read_len"])
        unplaced = {k: np.concatenate([np.empty((0, L), np.uint8)]
                                      + [u[k] for u in win.unplaced])
                    for k in ("codes", "quals")}
        unplaced["reads"] = win.unplaced_reads
    verdict = Judge(genome, cfg, dev)(samples, kind, unplaced)
    checks = {name: dict(value=verdict[name], limit=limit)
              for name, limit in spec.limits.items()
              if isinstance(limit, (int, float))}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    ctx = SimpleNamespace(
        window=window, placed=placed, reads=reads, setup_s=setup_s,
        index_build_s=index_build_s, trace=trace,
        traced_batches=TRACED_BATCHES,
        k1_calls=k1_calls, spec=spec)
    metrics, notes = {}, {}
    for m in spec.metrics(per_layer=bool(args.trace)):
        value = spec.reader(m["name"])(ctx)
        if value is None:
            continue
        if isinstance(value, tuple):
            value, notes[m["name"]] = value
        metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    device_info = dict(
        platform="gpu" if cuda else dev.type,
        kind=torch.cuda.get_device_name(dev) if cuda else dev.type,
        count=1, memory_peak_bytes=int(memory_peak))
    result = dict(correct=bool(correct), attempted=int(reads), failed=0,
                  metrics=metrics, device=device_info)
    if trace is not None:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
        result["breakdown"] = dict(device_ops=trace.top_ops(),
                                   idle_gaps=trace.idle_gaps())
    result["notes"] = dict(kinds=verdict["kinds"],
                           sampled=verdict["sampled"],
                           batches=window["batches"], **notes)
    result["check"] = checks
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for ex in verdict["examples"]:
        print("wrong field: " + json.dumps(ex), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def traced_window(win: Window, system, start: int, cuda: bool):
    """``TRACED_BATCHES`` batches through the same loop under
    ``torch.profiler``, with the K1 shapes they call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness.trace import Trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    win.tracing = True
    with system.k1_recorder() as calls:
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                win.run(batches=TRACED_BATCHES, start=start)
                if cuda:
                    import torch

                    torch.cuda.synchronize()
    win.tracing = False
    return Trace.from_profile(prof, "bench.window"), calls
