"""Checks of the reference's k-mer table on the card, outside the
benchmark's runs.

    python3 benchmark/judge_check.py ab --workload <cell> --seed <n> \
        --seconds <s> [--out FILE]

runs one cell as ``run.py`` does and judges the window's samples and
unplaced reads twice: with ``KmerTable`` and with one sort of every key
(the table's first form). Every check number and every count of wrong
fields has to match; exits 4 where one does not.

    python3 benchmark/judge_check.py scale --config <config> \
        --length <bases> --seed <n> [--reads 65536] [--program] [--out FILE]

makes the configuration's genome at ``--length`` bases and the ``se150``
pool on the card (kept there), builds the reference's table, and judges
``--reads`` reads of the pool (``Judge.own`` on every grid, ``seeded``);
then checks the table's rows of 64 of the genome's own keys, half of
them at positions past 2^31 where the genome reaches that far, against a
scan of the genome. ``--program`` then times ``ReadMapper.build`` of the
configuration at that length. Prints one JSON line of times (host clock,
synchronised) and peaks (``torch.cuda.max_memory_allocated``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import genome as genome_mod  # noqa: E402
from benchmark.harness import reference, runner  # noqa: E402
from benchmark.harness import traffic as traffic_mod  # noqa: E402
from benchmark.harness.spec import load_json  # noqa: E402


class OneSort(reference.KmerTable):
    """The table as one sort of every key."""

    def __init__(self, genome: torch.Tensor, K: int):
        self.K = K
        self.keys, self.pos = torch.sort(reference.kmer_keys(genome, K))


def timed(make, dev) -> tuple:
    """(what ``make()`` returns, its seconds, its peak bytes over what
    was allocated before it)."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    out = make()
    torch.cuda.synchronize(dev)
    return (out, time.perf_counter() - t,
            torch.cuda.max_memory_allocated(dev) - base)


def ab(args) -> int:
    record = {}

    class TwoTables(reference.Judge):
        def __call__(self, samples, kind, unplaced=None):
            dev = self.genome.device
            K = self.table.K
            self.table = None
            torch.cuda.empty_cache()
            self.table, record["bounded_s"], record["bounded_peak"] = \
                timed(lambda: reference.KmerTable(self.genome, K), dev)
            new = super().__call__(samples, kind, unplaced)
            self.table = None
            torch.cuda.empty_cache()
            self.table, record["one_sort_s"], record["one_sort_peak"] = \
                timed(lambda: OneSort(self.genome, K), dev)
            old = super().__call__(samples, kind, unplaced)
            for name, v in (("bounded", new), ("one_sort", old)):
                record[name] = {k: v[k] for k in v if k != "examples"}
            record["same"] = record["bounded"] == record["one_sort"]
            return new

    reference.Judge = TwoTables
    rc = runner.main(["--workload", args.workload, "--seed", str(args.seed),
                      "--seconds", str(args.seconds), "--trace", "0"],
                     ROOT, time.time())
    record.update(workload=args.workload, seed=args.seed, rc=rc,
                  device=torch.cuda.get_device_name(0))
    write(args.out, record)
    return rc or (0 if record.get("same") else 4)


def scan(genome: torch.Tensor, keys: torch.Tensor, K: int,
         chunk: int = 1 << 26) -> dict:
    """Every position of each of ``keys``, by a scan of the genome."""
    m = genome.shape[0] - K + 1
    found = {int(k): [] for k in keys.tolist()}
    for s in range(0, m, chunk):
        ck = reference.kmer_keys(genome[s:min(s + chunk, m) + K - 1], K)
        at = torch.nonzero(torch.isin(ck, keys)).squeeze(1)
        for k, p in zip(ck[at].tolist(), (at + s).tolist()):
            found[k].append(p)
    return found


def scale(args) -> int:
    dev = torch.device("cuda")
    cfg = load_json(os.path.join(ROOT, "benchmark", "configs",
                                 args.config + ".json"))
    cfg["genome"]["length"] = args.length
    tr = load_json(os.path.join(ROOT, "benchmark", "traffic", "se150.json"))
    out = dict(config=args.config, length=args.length, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    t = time.perf_counter()
    genome = genome_mod.make_genome(cfg["genome"], args.seed)
    out["genome_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = traffic_mod.make_pool(genome, tr, args.seed, dev)
    resident = [torch.from_numpy(b[k]).to(dev) for b in pool
                for k in ("codes", "quals")]
    torch.cuda.synchronize(dev)
    out["pool_s"] = time.perf_counter() - t
    out["pool_bytes"] = sum(r.numel() for r in resident)
    judge, out["judge_build_s"], peak = timed(
        lambda: reference.Judge(genome, cfg, dev), dev)
    out["judge_build_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["judge_build_peak_over_pool_bytes"] = peak
    out["table_bytes"] = 16 * len(judge.table.keys)
    out["K"] = judge.table.K

    rng = np.random.default_rng([args.seed & (2 ** 64 - 1), 0x5CA1E])
    cat = {k: np.concatenate([b[k] for b in pool])
           for k in ("codes", "quals", "origin", "is_rc")}
    rows = np.sort(rng.choice(len(cat["codes"]), args.reads, replace=False))
    s = {k: v[rows] for k, v in cat.items()}
    pen = reference.penalties(s["quals"], judge.sc)
    phases = reference.grid_phases(judge.mp)
    n = len(rows)
    own, out["own_s"], _ = timed(
        lambda: judge.own(s["codes"], pen, np.zeros(n, bool),
                          np.zeros(n, np.int64), phases), dev)
    out["own_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    smin = reference.score_min(s["codes"].shape[1], judge.sc)
    out["own_located_share"] = float((own["best"].max(1) >= smin).mean())
    tpat, _ = reference.oriented(s["codes"], pen, s["is_rc"].astype(bool))
    hit, out["seeded_s"], _ = timed(
        lambda: reference.seeded(tpat, s["origin"], judge.genome,
                                 judge.table, cfg), dev)
    out["seeded_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["seeded_share"] = float(hit.mean())
    out["origin_past_2_31_share"] = float((s["origin"] >= 2 ** 31).mean())

    # the table's rows of the genome's own keys against a scan
    K, g = judge.table.K, judge.genome
    m = len(g) - K + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(traffic_mod.torch_seed(args.seed, 0x5CA1E))
    lo_half = torch.randint(0, min(m, 2 ** 31), (32,), generator=gen,
                            device=dev)
    hi_half = torch.randint(min(m - 1, 2 ** 31), m, (32,), generator=gen,
                            device=dev)
    at = torch.cat([lo_half, hi_half])
    keys = torch.unique(reference.kmer_keys(
        g[at[:, None] + torch.arange(K, device=dev)], K)[:, 0])
    t = time.perf_counter()
    truth = scan(g, keys, K)
    out["scan_s"] = time.perf_counter() - t
    lo, cnt = judge.table.range(keys)
    same = all(sorted(judge.table.pos[a:a + c].tolist()) == truth[k]
               for k, a, c in zip(keys.tolist(), lo.tolist(), cnt.tolist()))
    out.update(scan_keys=len(keys), scan_same=same,
               scan_positions=int(cnt.sum()),
               scan_positions_past_2_31=sum(p >= 2 ** 31 for v in
                                            truth.values() for p in v))
    del judge, own, hit, lo, cnt
    torch.cuda.empty_cache()
    write(args.out, out)
    if args.program:
        from benchmark.harness.system import System

        system = System(cfg, genome, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out["program_build_s"] = system.build()
        out["program_build_peak_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        system.close()
        write(args.out, out)
    return 0 if same else 4


def write(path, record: dict) -> None:
    line = json.dumps(record)
    print(line)
    sys.stdout.flush()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(line + "\n")


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark/judge_check.py")
    sub = p.add_subparsers(dest="mode", required=True)
    a = sub.add_parser("ab")
    a.add_argument("--workload", required=True)
    a.add_argument("--seed", type=int, required=True)
    a.add_argument("--seconds", type=float, default=10)
    a.add_argument("--out", default=None)
    b = sub.add_parser("scale")
    b.add_argument("--config", default="g100m-qgram")
    b.add_argument("--length", type=int, required=True)
    b.add_argument("--seed", type=int, required=True)
    b.add_argument("--reads", type=int, default=1 << 16)
    b.add_argument("--program", action="store_true")
    b.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("judge_check: needs a CUDA card", file=sys.stderr)
        return 2
    return ab(args) if args.mode == "ab" else scale(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
