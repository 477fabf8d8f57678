"""The dedup vote on the CPU: ``align.kernels.vote_reps_plain`` against the
tournament written out row by row and against the JAX package's own
``dedup_half``, at the mapper's widths and at each edge
(``tools/vote_operands.edge_rows``); the wrapper's routing of CPU tensors
to it; the mapper's call of both strands as one set of rows. The kernel
(``csrc/vote_reps.cu``) is held to the plain version on the card
(``tests/test_torch_gpu.py``)."""

import types

import numpy as np
import pytest
import torch

from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.bowtie import pipeline
from nvbio_tpu_torch.tools.vote_operands import (EDGE_NS, TOL, edge_rows,
                                                 path_operands)
from nvbio_tpu_torch.utils import timers

torch.set_num_threads(1)

BIG = 2**63 - 1


def _wrap64(x: int) -> int:
    return (x + 2**63) % 2**64 - 2**63


def tournament(pos, ok, tol, n_reps):
    """One row's reps and their validity, as the mapper's vote defines
    them, in Python integers."""
    p = [x if o else BIG for x, o in zip(pos, ok)]
    n = len(p)

    def near(a, b):
        return _wrap64(max(a, b) - min(a, b)) <= tol

    votes = [sum(ok[j] and near(p[i], p[j]) for j in range(n)) if ok[i]
             else -1 for i in range(n)]
    reps, valids = [], []
    for _ in range(n_reps):
        m = max(votes)
        if m < 1:
            reps.append(0)
            valids.append(False)
            continue
        sel = min(p[i] for i in range(n) if votes[i] == m)
        members = [i for i in range(n) if votes[i] >= 0 and near(p[i], sel)]
        rep = min((p[i] for i in members), default=BIG)
        reps.append(rep if rep < BIG else 0)
        valids.append(rep < BIG)
        for i in members:
            votes[i] = -1
    return reps, valids


@pytest.mark.parametrize("n_reps", [2, 8])
@pytest.mark.parametrize("n", EDGE_NS)
def test_plain_vote_is_the_tournament(n, n_reps):
    """Every edge row (all invalid, one valid, neighbours tol and tol + 1
    apart, a member left of sel, ties in votes, fewer clusters than reps,
    a cluster of 40, positions past 2^31) and random clustered rows, at
    the mapper's widths and around whole warps of 32."""
    pv, valid, names = edge_rows(n)
    reps, rep_valid = K.vote_reps_plain(pv, valid, TOL, n_reps)
    assert reps.dtype == torch.int64 and rep_valid.dtype == torch.bool
    assert reps.shape == rep_valid.shape == (len(names), n_reps)
    for r, name in enumerate(names):
        want = tournament(pv[r].tolist(), valid[r].tolist(), TOL, n_reps)
        assert (reps[r].tolist(), rep_valid[r].tolist()) == want, name
    if n >= 3:
        i = names.index("member left of sel")
        assert reps[i, 0] == pv[i][valid[i]].min()
        i = names.index("two apart by tol + 1")
        assert rep_valid[i, :2].all()
    if n >= 40:
        assert rep_valid[names.index("big cluster")].tolist() == \
            [True] + [False] * (n_reps - 1)
    assert not rep_valid[names.index("all invalid")].any()
    assert (reps[rep_valid] >= 2**31).any()


def jax_dedup_half(tol: int, n_reps: int):
    """The JAX package's vote, ``dedup_half``, the closure inside
    ``nvbio_tpu.bowtie.pipeline.read_candidates``, bound to ``tol``,
    ``n_reps`` reps and uint32 positions (its dtype for genomes past
    2^31): its own code object, run eagerly on (rows, n) arrays."""
    import jax.numpy as jnp

    from nvbio_tpu.bowtie import pipeline as jp

    code = next(c for c in jp.read_candidates.__code__.co_consts
                if isinstance(c, types.CodeType)
                and c.co_name == "dedup_half")
    free = dict(NCH=n_reps, pdt=jnp.dtype("uint32"), tol=tol)
    cells = tuple(types.CellType(free[v]) for v in code.co_freevars)
    return types.FunctionType(code, vars(jp), "dedup_half", None, cells)


@pytest.mark.parametrize("n_reps", [2, 8])
@pytest.mark.parametrize("n", EDGE_NS)
def test_plain_vote_equals_the_jax_dedup(n, n_reps):
    """The plain version against the JAX package's ``dedup_half`` on the
    edge rows (a neighbour tol + 1 apart, a member left of sel, ties,
    positions past 2^31) and on clustered rows of a 3.1 Gbp genome: the
    same reps and validity, the JAX package's uint32 positions widened."""
    import jax.numpy as jnp

    pv, valid, _ = edge_rows(n)
    cpv, cvalid = path_operands(48, n, 0.6, 7 + n, "cpu")
    pv, valid = torch.cat([pv, cpv]), torch.cat([valid, cvalid])
    assert 0 <= int(pv.min()) and int(pv.max()) < 2**32 - TOL - 1
    reps, rep_valid = K.vote_reps_plain(pv, valid, TOL, n_reps)
    dedup = jax_dedup_half(TOL, n_reps)
    j_reps, j_valid = dedup(jnp.asarray(pv.numpy().astype(np.uint32)),
                            jnp.asarray(valid.numpy()))
    assert np.array_equal(np.asarray(j_valid), rep_valid.numpy())
    assert np.array_equal(np.asarray(j_reps).astype(np.int64),
                          reps.numpy())
    assert (reps[rep_valid] >= 2**31).any()


def test_wrapper_routes_cpu_to_the_plain_version():
    """CPU tensors take the plain version and count no launch; the rounds
    output is the kernel's alone."""
    pv, valid = path_operands(64, 36, 0.7, 3, "cpu")
    n0 = K.vote_reps.launches
    got = K.vote_reps(pv, valid, TOL, 8)
    want = K.vote_reps_plain(pv, valid, TOL, 8)
    assert K.vote_reps.launches == n0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="cuda only"):
        K.vote_reps(pv, valid, TOL, 8, torch.zeros(64, dtype=torch.int32))
    assert K.VOTE_MAX_COLS == 19360


def test_both_strands_as_one_set_of_rows():
    """The mapper's one call over (2B, CH) rows equals a call per strand
    over (B, CH), side by side; on the CPU it holds no counter even while
    a profiler records."""
    from torch.profiler import ProfilerActivity, profile

    B, CH, NCH = 96, 54, 8
    pv, valid = path_operands(B, 2 * CH, 0.3, 5, "cpu")
    timers.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        w0, ok = pipeline._vote_reps(pv.reshape(2 * B, CH),
                                     valid.reshape(2 * B, CH), TOL, NCH)
    assert "vote_rounds" not in timers.counters()
    timers.reset_counters()
    f = K.vote_reps_plain(pv[:, :CH], valid[:, :CH], TOL, NCH)
    r = K.vote_reps_plain(pv[:, CH:], valid[:, CH:], TOL, NCH)
    assert torch.equal(w0.reshape(B, 2 * NCH), torch.cat([f[0], r[0]], 1))
    assert torch.equal(ok.reshape(B, 2 * NCH), torch.cat([f[1], r[1]], 1))
