"""Port parity: nvbio_tpu_torch.qgram against nvbio_tpu.qgram (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu import packed as jpacked
from nvbio_tpu import qgram as jq
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.utils.simgenome import repeat_rich_genome as j_repeat_genome
from nvbio_tpu_torch import convert
from nvbio_tpu_torch import packed as tpacked
from nvbio_tpu_torch import qgram as tq
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.utils.simgenome import repeat_rich_genome

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

Q = 7
NS, H = 12, 6


@pytest.fixture(scope="module")
def repeat_tables():
    """A repeat-rich genome indexed by both packages; at q=7 over 2 Mbp
    buckets straddle 128 entries (both slot branches are exercised) and
    the repeats past the 1 Mbp unique prefix widen them further."""
    codes = repeat_rich_genome(2_000_000, seed=7)
    jidx = jq.build_qgram_index(codes, Q)
    tidx = tq.build_qgram_index(codes, Q)
    return codes, jidx, tidx


def _mid_to_port(mid):
    mid = np.asarray(mid)
    return np.where(mid == np.iinfo(mid.dtype).max, -1, mid)


def test_repeat_genome_copy_identical():
    np.testing.assert_array_equal(repeat_rich_genome(300_000, seed=3),
                                  j_repeat_genome(300_000, seed=3))


def test_native_table_identical(repeat_tables):
    codes, jidx, tidx = repeat_tables
    assert tidx.q == jidx.q and tidx.n == jidx.n
    np.testing.assert_array_equal(tidx.offsets.numpy(),
                                  np.asarray(jidx.offsets))
    np.testing.assert_array_equal(tidx.positions.numpy(),
                                  np.asarray(jidx.positions))
    np.testing.assert_array_equal(tidx.mid_pos.numpy(),
                                  _mid_to_port(jidx.mid_pos))
    assert (np.diff(np.asarray(jidx.offsets)) > 128).mean() > 0.1


def test_convert_and_load_carry_the_jax_table(repeat_tables, tmp_path):
    codes, jidx, tidx = repeat_tables
    conv = convert.qgram_index_from_arrays(
        jidx.q, jidx.n, np.asarray(jidx.offsets), np.asarray(jidx.positions),
        np.asarray(jidx.mid_pos), device="cpu")
    jidx.save(str(tmp_path / "t.qgram.npz"))
    loaded = tq.QGramIndex.load(str(tmp_path / "t.qgram.npz"))
    for other in (conv, loaded):
        for f in ("offsets", "positions", "mid_pos"):
            assert torch.equal(getattr(other, f), getattr(tidx, f))
    words = jpacked.pack(codes, 2)
    gw = convert.genome_words_from_array(words, device="cpu")
    assert gw.dtype == torch.int32
    np.testing.assert_array_equal(gw.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(
        tpacked.extract_window(gw, torch.tensor([0, 17]), 40).numpy(),
        np.stack([codes[:40], codes[17:57]]))


def test_n_flags_exclude_qgrams(rng):
    codes = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    flags = np.zeros(len(codes), bool)
    flags[5000:5100] = True
    jidx = jq.build_qgram_index(codes, 8, n_flags=flags)
    tidx = tq.build_qgram_index(codes, 8, n_flags=flags)
    np.testing.assert_array_equal(tidx.positions.numpy(),
                                  np.asarray(jidx.positions))


def test_keys_ranges_and_stratified_slots(repeat_tables, rng):
    codes, jidx, tidx = repeat_tables
    B, s = 256, 10
    # seeds drawn from the repeat half of the genome, a few random ones
    at = rng.integers(1_000_000, len(codes) - s, size=(B, NS))
    seeds = codes[at[..., None] + np.arange(s)].astype(np.int32)
    seeds[:8] = rng.integers(0, 4, size=(8, NS, s))
    jkeys = jq.seed_keys_from_batch(jnp.asarray(seeds), Q)
    tkeys = tq.seed_keys_from_batch(torch.from_numpy(seeds), Q)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))

    jd = jidx.device()
    jlo, jhi = jq.qgram_range(jd, jkeys)
    tlo, thi = tq.qgram_range(tidx, tkeys)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    rsz = np.maximum(np.asarray(jhi) - np.asarray(jlo), 0)
    # both slot branches are exercised: buckets above and below 128
    assert 0.1 < (rsz > 128).mean() < 0.9

    jpos = np.asarray(jq.stratified_locate_rows(
        jd, jlo, jnp.asarray(rsz.astype(np.int32)), H, NS))
    tpos = tq.stratified_locate_rows(
        tidx, tlo, torch.from_numpy(rsz.astype(np.int64)), H, NS).numpy()
    valid = np.arange(H)[None, None, :] < rsz[..., None]
    np.testing.assert_array_equal(tpos[valid], jpos[valid])

    joff = np.asarray(jq.stratified_offsets(jnp.asarray(
        rsz.astype(np.int32)), H, NS))
    toff = tq.stratified_offsets(torch.from_numpy(rsz.astype(np.int64)), H,
                                 NS).numpy()
    np.testing.assert_array_equal(toff, joff)


def test_midpos_lookup_matches_bucket_middle(repeat_tables, rng):
    _, jidx, tidx = repeat_tables
    keys = torch.from_numpy(rng.integers(0, 4 ** Q, size=4096)
                            .astype(np.int32))
    mid, nonempty = tq.midpos_lookup(tidx, keys)
    jmid = np.asarray(jidx.mid_pos)[keys.numpy()]
    sent = np.iinfo(jmid.dtype).max
    np.testing.assert_array_equal(nonempty.numpy(), jmid != sent)
    np.testing.assert_array_equal(mid.numpy()[jmid != sent],
                                  jmid[jmid != sent])


def test_map_params_from_jax_fields():
    jp = JMapParams(max_read_len=90, seed_len=18, hits_per_seed=6,
                    max_dist=8, reseed_frac=0.25, seeding_1mm=False)
    tp = convert.map_params_from_fields(dataclasses.asdict(jp))
    assert tp == TMapParams(max_read_len=90, seed_len=18, hits_per_seed=6,
                            max_dist=8, reseed_frac=0.25, seeding_1mm=False)
    assert convert.map_params_from_fields(jp) == tp
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    je = JMapParams.edit_distance(max_read_len=80)
    te = convert.map_params_from_fields(je)
    assert dataclasses.asdict(te) == dataclasses.asdict(je)
