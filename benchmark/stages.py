"""Where a cell's batch goes, stage by stage, as the program's spans and
counters tell it.

    python3 benchmark/stages.py --workload <cell> --seed <n> [--windows 3]

from the root of a checkout, on the card the cell asks for. Sets the cell
up as ``run.py`` does, then runs ``--windows`` traced windows of
``runner.TRACED_BATCHES`` batches through the same loop and prints one
JSON line for each (``harness/stage_trace.py``), in ms a batch:
``seed_device_ms`` and ``reseed_device_ms`` (device time of the ops
launched inside ``nvbio.seed`` and ``nvbio.reseed``), ``dispatch_sync_ms``
(host time in waiting CUDA calls inside ``nvbio.dispatch``, split by the
innermost span), each stage's device time, the window's seconds a batch,
device ops a batch, the share of busy time launched inside program spans,
the idle gaps named by the innermost span, and the counters with
``reseed_fill_pct`` and ``cand_fill_pct``. A program without the spans
reads 0 and no counters.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

from benchmark.harness import genome as genome_mod  # noqa: E402
from benchmark.harness import runner  # noqa: E402
from benchmark.harness import traffic as traffic_mod  # noqa: E402
from benchmark.harness.program_counters import MODULE  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402
from benchmark.harness.stage_trace import PROGRAM_PREFIX  # noqa: E402
from benchmark.harness.stage_trace import StageTrace  # noqa: E402

STAGES = ("upload", "seed", "vote", "extend", "reseed", "finalize",
          "rescue", "fetch")


def window(win, start: int, cuda: bool) -> tuple:
    """(StageTrace, counters) of ``runner.TRACED_BATCHES`` batches under
    ``torch.profiler``, from batch ``start``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    timers = sys.modules.get(MODULE)
    if timers is not None and hasattr(timers, "reset_counters"):
        timers.reset_counters()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    win.tracing = True
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            win.run(batches=runner.TRACED_BATCHES, start=start)
            if cuda:
                torch.cuda.synchronize()
    win.tracing = False
    read = getattr(timers, "counters", None)
    return (StageTrace.from_profile(prof, "bench.window"),
            read() if read is not None else {})


def report(st: StageTrace, counts: dict) -> dict:
    nb = runner.TRACED_BATCHES
    sync, by = st.sync_s(PROGRAM_PREFIX + "dispatch")
    out = dict(
        seed_device_ms=1e3 * st.device_s(PROGRAM_PREFIX + "seed") / nb,
        reseed_device_ms=1e3 * st.device_s(PROGRAM_PREFIX + "reseed") / nb,
        dispatch_sync_ms=1e3 * sync / nb,
        dispatch_sync_by={k: 1e3 * v / nb for k, v in by.items()},
        device_ms_by_stage={s: 1e3 * st.device_s(PROGRAM_PREFIX + s) / nb
                            for s in STAGES},
        window_s_per_batch=st.window_s / nb,
        busy_s=st.busy_s(), window_s=st.window_s,
        ops_per_batch=len(st.device) / nb,
        covered_pct=100.0 * st.covered_share(),
        idle_gaps=st.idle_gaps(),
        counters=counts)
    for name, part, whole in (("reseed_fill_pct", "reseed_needed",
                               "reseed_rows"),
                              ("cand_fill_pct", "cand_valid", "cand_slots")):
        if counts.get(whole):
            out[name] = 100.0 * counts.get(part, 0) / counts[whole]
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark/stages.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness.system import System

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    spec = Spec(ROOT, args.workload)
    cfg, tr = spec.config, spec.traffic
    kind = tr["kind"]
    genome = genome_mod.make_genome(cfg["genome"], args.seed)
    pool = traffic_mod.make_pool(genome, tr, args.seed, dev)
    system = System(cfg, genome, dev)
    system.build()
    items = system.items(pool, kind)
    win = runner.Window(system, items, pool, kind, spec, args.seed, False)
    start = win.run(batches=runner.WARM_BATCHES)["next"]
    for _ in range(args.windows):
        st, counts = window(win, start, cuda)
        start += runner.TRACED_BATCHES
        print(json.dumps(dict(workload=args.workload, seed=args.seed,
                              **report(st, counts))), flush=True)
    system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
