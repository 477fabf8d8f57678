"""The reference's k-mer table, built a partition at a time, against one
sort of every key (the table's first form): the same rows for every key,
every key position once, k-mers across chunk boundaries, and, on a card,
a genome past 2^31 bases with its planted k-mers at their exact int64
positions in bounded memory."""

import json
import os

import pytest
import torch

from benchmark.harness import genome as genome_mod
from benchmark.harness.reference import KmerTable, kmer_keys, partitions
from benchmark.judge_check import OneSort, scan
from benchmark.tests.conftest import REPO, TINY_GENOME

torch.set_num_threads(1)


def genome_block(config: str) -> dict:
    with open(os.path.join(REPO, "benchmark", "configs",
                           config + ".json")) as f:
        return json.load(f)["genome"]


def tiny_genome(config: str, seed: int) -> torch.Tensor:
    return torch.from_numpy(genome_mod.make_genome(
        genome_block(config) | TINY_GENOME, seed))


def rows(table: KmerTable, keys: torch.Tensor) -> list:
    """Each key's count and sorted positions, through ``range``."""
    lo, cnt = table.range(keys)
    return [(c, sorted(table.pos[a:a + c].tolist()))
            for a, c in zip(lo.tolist(), cnt.tolist())]


def test_partitions_are_greedy_and_bounded():
    part_of, sizes = partitions([3, 0, 2, 6, 1, 1, 9, 0, 2], 5)
    assert sizes == [5, 6, 2, 9, 2]
    assert part_of == [0, 0, 0, 1, 2, 2, 3, 3, 4]
    assert partitions([], 5) == ([], [0])


@pytest.mark.parametrize("config", ["g100m-qgram", "g100m-fmi"])
@pytest.mark.parametrize("K", [12, 22])
def test_bounded_table_equals_one_sort(config, K):
    """Many small partitions and chunks that do not divide the genome:
    the same rows as one stable sort of every key (keys, then positions in
    genome order), and for a sample of seed keys (of the genome's own
    k-mers, present, and drawn at random, mostly absent at K = 22) the
    same count and the same set of positions as one sort of every key,
    stable or not."""
    g = tiny_genome(config, 2 ** 40 + K)
    one = OneSort(g, K)
    table = KmerTable(g, K, rows=4099, chunk=7919)
    assert torch.equal(table.keys, one.keys)
    assert torch.equal(table.pos,
                       torch.sort(kmer_keys(g, K), stable=True).indices)
    gen = torch.Generator().manual_seed(K)
    at = torch.randint(0, len(g) - K + 1, (1500,), generator=gen)
    sample = torch.cat([kmer_keys(g[at[:, None] + torch.arange(K)], K)[:, 0],
                        torch.randint(0, 4 ** K, (1500,), generator=gen)])
    assert torch.equal(table.count(sample), one.count(sample))
    assert rows(table, sample) == rows(one, sample)
    assert any(c > 1 for c, _ in rows(table, sample))


@pytest.mark.parametrize("K", [12, 22])
def test_kmer_across_a_chunk_boundary_counted_once(K):
    """A k-mer planted across the boundary of two chunks is found once, at
    its position, and no key position is keyed twice or left out."""
    chunk = 10_000
    g = tiny_genome("g100m-qgram", 5)
    p = 3 * chunk - K // 2
    planted = torch.tensor([3, 3, 0, 1] * 6, dtype=torch.uint8)[:K]
    g[p:p + K] = planted
    key = int(kmer_keys(planted[None], K)[0, 0])
    truth = scan(g, torch.tensor([key]), K)[key]
    assert p in truth
    table = KmerTable(g, K, rows=50_000, chunk=chunk)
    assert rows(table, torch.tensor([key])) == [(len(truth), truth)]
    assert torch.equal(torch.sort(table.pos).values,
                       torch.arange(len(g) - K + 1))
    if K == 22:
        assert truth == [p]


@pytest.mark.gpu
def test_table_past_2_31_on_the_card(card):
    """A genome of 2^31 + 2^24 bases (the ``g100m-qgram`` genome block,
    its length changed) with a 12-mer and a 22-mer planted past 2^31, each
    found nowhere else by a scan: both tables locate it at its exact int64
    position with a count of 1, and each build stays within the table's 16
    bytes a key position and 4 GiB of scratch."""
    n = 2 ** 31 + 2 ** 24
    g = genome_mod.make_genome(genome_block("g100m-qgram") | {"length": n},
                               2 ** 33 + 21)
    gd = torch.from_numpy(g).cuda()
    del g
    # absent 12-mers, by a histogram of every 12-mer of the genome
    hist = torch.zeros(4 ** 12, dtype=torch.int64, device="cuda")
    for s in range(0, n - 11, 1 << 26):
        hist += torch.bincount(kmer_keys(gd[s:min(s + (1 << 26), n - 11)
                                            + 11], 12), minlength=4 ** 12)
    absent = torch.nonzero(hist == 0).squeeze(1)[:2].tolist()
    del hist
    assert len(absent) == 2

    def codes(key, K):
        return [(key >> 2 * (K - 1 - j)) & 3 for j in range(K)]

    p12 = 2 ** 31 + 123_457
    p22 = 2 ** 31 + 2 ** 23 + 7
    k12 = absent[0]
    k22 = (absent[1] << 20) | 0x5A3C9
    for p, key, K in ((p12, k12, 12), (p22, k22, 22)):
        gd[p:p + K] = torch.tensor(codes(key, K), dtype=torch.uint8)
    for p, key, K in ((p12, k12, 12), (p22, k22, 22)):
        assert scan(gd, torch.tensor([key], device="cuda"), K)[key] == [p]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        table = KmerTable(gd, K)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        lo, cnt = table.range(torch.tensor([key], device="cuda"))
        assert int(cnt[0]) == 1
        assert int(table.pos[lo[0]]) == p
        assert table.pos.dtype == torch.int64
        assert peak <= 16 * (n - K + 1) + 4 * 2 ** 30, peak
        print(f"K={K}: peak {peak} bytes over the genome, table "
              f"{16 * (n - K + 1)}")
        del table, lo, cnt
        torch.cuda.empty_cache()
