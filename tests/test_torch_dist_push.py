"""The push direction, the normal equations and CG over a ``DistComm`` whose
processes hold only some of the ranks.

Eight ranks held as world × p_local = 2 × 4 and 4 × 2 gloo processes.  Each
world spawns once from this file (``python tests/test_torch_dist_push.py
RANK WORLD INIT OUT``); every process builds the same host plans, runs its
own ranks through every case and writes its rows:

* ``IrregularScatter`` on every rung × ``reduce`` add/set/max ×
  ``use_kernel`` on ``tests/test_torch_scatter.py``'s two patterns (the
  handle protocol too);
* ``DistributedSpMV(transpose=True)`` on every rung × ``use_kernel`` on
  that file's matrix, integer-valued and float;
* ``normal_equations_step`` on every rung × ``use_kernel`` and 50
  iterations of ``ConjugateGradient`` on ``tests/test_torch_schedule.py``'s
  cases.

The processes' rows, stacked, must be the ``LoopbackComm(8)`` results of
the same cases bit for bit (run in this process while the ranks run).  The
JAX package's outputs come from those two files' own ``run_reference``,
run once in an 8-device subprocess of this file (``python
tests/test_torch_dist_push.py jax SCATTER_OUT SCHEDULE_OUT``), and are held
at those files' tolerances: the scatters and the integer-valued products
bit for bit, the float transposed SpMV within 3e-5, CG within 1e-5.
"""
import sys

import numpy as np
import pytest

import test_torch_scatter as tsc
import test_torch_schedule as tsd
from test_torch_dist_comm import init_gloo, run_worlds

P, SHARDS_PER_NODE = 8, 4
WORLDS = (2, 4)
WORLD_IDS = ["2x4", "4x2"]


def _scatter_plans():
    """Each scatter case's ``ScatterPlan``, shared by its rungs."""
    from repro_torch.comm.plan import Topology, build_comm_plan
    plans = {}
    for case in tsc.CASES:
        idx, _ = tsc._case(case)
        n, _, _, _, blocksize, _ = tsc.CASES[case]
        plans[case] = build_comm_plan(
            idx, n, P, blocksize=blocksize,
            topology=Topology(P, SHARDS_PER_NODE)).transpose()
    return plans


def _results(comm) -> dict:
    """Every case's output on ``comm``'s rows, by key."""
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.plan import Topology, build_comm_plan
    from repro_torch.comm.scatter import IrregularScatter
    from repro_torch.core import matrix as tmatrix
    from repro_torch.core.solvers import ConjugateGradient
    from repro_torch.core.spmv import DistributedSpMV, normal_equations_step

    res = {}
    splans = _scatter_plans()
    for case, strategy, reduce, use_kernel in tsc.SCATTER_COMBOS:
        idx, vals = tsc._case(case)
        s = IrregularScatter(
            AccessPattern.from_indices(idx, n=tsc.CASES[case][0]), comm,
            strategy=strategy, reduce=reduce, use_kernel=use_kernel,
            scatter_plan=splans[case])
        tv = s.shard_values(vals)
        assert tv.shape[0] == comm.p_local
        y = s(tv)
        y2 = s.start_local(tv, *s.plan_args).finish()
        assert np.array_equal(y.numpy(), y2.numpy())
        res[tsc._skey(case, strategy, reduce, use_kernel)] = y.numpy()

    m, _ = tsc._matrix(tmatrix, "float")
    base = build_comm_plan(m.cols, tsc.N, P, blocksize=tsc.BLOCKSIZE,
                           topology=Topology(P, SHARDS_PER_NODE))
    splan = base.transpose()
    for kind, strategy, use_kernel in tsc.SPMV_COMBOS:
        m, x = tsc._matrix(tmatrix, kind)
        eng = DistributedSpMV(m, comm, strategy=strategy,
                              shards_per_node=SHARDS_PER_NODE,
                              use_kernel=use_kernel, transpose=True,
                              base_plan=base, scatter_plan=splan)
        res[tsc._tkey(kind, strategy, use_kernel)] = eng(
            eng.shard_vector(x)).numpy()

    m, x = tsd._ne_case(tmatrix)
    plans = {}
    for strategy, use_kernel in tsd.NE_COMBOS:
        step = normal_equations_step(m, comm, strategy=strategy,
                                     blocksize=16, use_kernel=use_kernel,
                                     plans=plans, use_plan_cache=False)
        res[f"ne-{strategy}-{int(use_kernel)}"] = step(
            step.shard_vector(x)).numpy()
    m, b = tsd._cg_case(tmatrix)
    plans = {}
    for strategy, use_kernel in tsd.NE_COMBOS:
        cg = ConjugateGradient(m, comm, strategy=strategy, blocksize=8,
                               use_kernel=use_kernel, plans=plans,
                               use_plan_cache=False)
        res[f"cg-{strategy}-{int(use_kernel)}"] = cg.solve(
            b, n_steps=tsd.CG_STEPS).numpy()
    return res


def _worker(rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm

    init_gloo(rank, world, init)
    comm = DistComm(P // world, device="cpu")
    assert comm.rank_offset == rank * (P // world)
    res = _results(comm)
    dist.destroy_process_group()
    np.savez(f"{out}-{rank}.npz", **res)


def _jax(scatter_out: str, schedule_out: str) -> None:
    tsc.run_reference(scatter_out)
    tsd.run_reference(schedule_out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' rows stacked, the ``LoopbackComm(8)`` results (run in
    this process while the ranks run) and the JAX package's."""
    from repro_torch.comm.communicator import LoopbackComm

    tmp = tmp_path_factory.mktemp("dist_push")
    ref = [tmp / "scatter.npz", tmp / "schedule.npz"]
    loop, ranks = run_worlds(
        __file__, WORLDS, tmp, ref,
        lambda: _results(LoopbackComm(P, device="cpu")))
    out = {w: {k: np.concatenate([r[k] for r in ranks[w]]) for k in loop}
           for w in WORLDS}
    out.update(loopback=loop, scatter=dict(np.load(ref[0])),
               schedule=dict(np.load(ref[1])))
    return out


def _equal_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("case,strategy,reduce,use_kernel",
                         tsc.SCATTER_COMBOS)
def test_dist_scatter_is_loopback_and_jax(runs, world, case, strategy,
                                          reduce, use_kernel):
    key = tsc._skey(case, strategy, reduce, use_kernel)
    got = runs[world][key]
    _equal_bits(got, runs["loopback"][key])
    n = tsc.CASES[case][0]
    flat = got.reshape((n,) + got.shape[2:])
    np.testing.assert_array_equal(flat, runs["scatter"][key])
    idx, vals = tsc._case(case)
    np.testing.assert_array_equal(flat, tsc._numpy_ref(idx, vals, n, reduce))


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("kind,strategy,use_kernel", tsc.SPMV_COMBOS)
def test_dist_transposed_spmv_is_loopback_and_jax(runs, world, kind,
                                                  strategy, use_kernel):
    key = tsc._tkey(kind, strategy, use_kernel)
    got = runs[world][key]
    _equal_bits(got, runs["loopback"][key])
    want = runs["scatter"][key]
    if kind == "int":
        np.testing.assert_array_equal(got.reshape(-1), want)
    else:
        np.testing.assert_allclose(got.reshape(-1), want, **tsc.TOL)


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("strategy,use_kernel", tsd.NE_COMBOS)
def test_dist_normal_equations_is_loopback_and_jax(runs, world, strategy,
                                                   use_kernel):
    key = f"ne-{strategy}-{int(use_kernel)}"
    got = runs[world][key]
    _equal_bits(got, runs["loopback"][key])
    np.testing.assert_array_equal(got.reshape(-1),
                                  runs["schedule"][f"ne-{strategy}"])


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("strategy,use_kernel", tsd.NE_COMBOS)
def test_dist_cg_is_loopback_and_jax(runs, world, strategy, use_kernel):
    key = f"cg-{strategy}-{int(use_kernel)}"
    got = runs[world][key]
    _equal_bits(got, runs["loopback"][key])
    jx = runs["schedule"][f"cg-{strategy}"]
    assert np.abs(got.reshape(-1) - jx).max() / np.abs(jx).max() < 1e-5


@pytest.mark.parametrize("n", [1, 5, 64, 1000])
def test_cg_partial_dots_are_the_loopback_row_sums(n):
    """CG's partial dots (``solvers._rank_sums``): a process holding
    p_local of the 8 ranks, at every offset, gets the rows of the 8-rank
    sum, bit for bit."""
    import types

    import torch

    from repro_torch.core.solvers import _rank_sums
    t = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (P, n)).astype(np.float32))
    want = t.sum(-1).numpy()
    for p_local in (1, 2, 4, P):
        for off in range(0, P, p_local):
            rows = slice(off, off + p_local)
            comm = types.SimpleNamespace(p=P, p_local=p_local,
                                         local_rows=rows)
            got = _rank_sums(t[rows].contiguous(), comm).numpy()
            _equal_bits(got, want[rows])


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax(sys.argv[2], sys.argv[3])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4])
