"""The port's push direction at P = 8 against the JAX engines and numpy.

``IrregularScatter`` on every rung × ``reduce`` add/set/max × ``use_kernel``
(a square pattern, and an ``m != n`` pattern with feature dims), and
``DistributedSpMV(transpose=True)`` on every rung × ``use_kernel``, on CPU
tensors with ``LoopbackComm(8, device="cpu")``.  The JAX engines need eight
devices, so they run once in a subprocess of this file (``python
tests/test_torch_scatter.py OUT.npz`` with
``--xla_force_host_platform_device_count=8``, Pallas in interpret mode).
Both sides run the same plans: the port's come from the reference's by
``convert.from_reference``.

Scatter contributions are integer-valued floats, so every sum is exact in
any order and the port must equal the JAX engine and the numpy ground truth
bit for bit.  The transposed SpMV is bit-equal on integer-valued data; on
random float32 it is held within rtol/atol 3e-5 of the JAX engine and of
``spmv_t_ref_np`` (the replicate rung's all-reduce adds the ranks in
another order than XLA's psum).
"""
import dataclasses
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

P, SHARDS_PER_NODE = 8, 4
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")
REDUCES = ("add", "set", "max")
# name: (n, m, r, feature dims, blocksize, seed)
CASES = {"square": (512, 512, 5, (), 16, 0),
         "mn_feat": (512, 128, 3, (4,), 8, 1)}
SCATTER_COMBOS = list(itertools.product(CASES, STRATEGIES, REDUCES,
                                        (False, True)))
N, R_NZ, BLOCKSIZE = 2048, 8, 64
SPMV_COMBOS = list(itertools.product(("int", "float"), STRATEGIES,
                                     (False, True)))
TOL = dict(rtol=3e-5, atol=3e-5)


def _case(name):
    n, m, r, feat, _, seed = CASES[name]
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (m, r)).astype(np.int32)
    vals = rng.integers(-4, 5, (m, r) + feat).astype(np.float32)
    return idx, vals


def _numpy_ref(idx, vals, n, reduce):
    """Ground truth of every reduce (``tests/test_irregular_scatter.py``)."""
    feat = vals.shape[2:]
    if reduce == "add":
        y = np.zeros((n,) + feat, vals.dtype)
        np.add.at(y, idx.ravel(), vals.reshape((-1,) + feat))
        return y
    if reduce == "max":
        y = np.full((n,) + feat, -np.inf, vals.dtype)
        np.maximum.at(y, idx.ravel(), vals.reshape((-1,) + feat))
        return np.where(np.isneginf(y), 0.0, y).astype(vals.dtype)
    y = np.zeros((n,) + feat, vals.dtype)   # "set": last writer wins
    for i, v in zip(idx.ravel(), vals.reshape((-1,) + feat)):
        y[i] = v
    return y


def _matrix(matrix_mod, kind):
    """The SpMV matrix and x; ``int`` rounds vals, diag and x to small
    integers, so every sum is exact."""
    m = matrix_mod.make_mesh_like_matrix(
        N, R_NZ, locality_window=N // 16, long_range_frac=0.03, seed=6)
    x = np.random.default_rng(6).standard_normal(N).astype(np.float32)
    if kind == "int":
        m = dataclasses.replace(m, diag=np.round(m.diag * 4),
                                vals=np.round(m.vals * 4))
        x = np.round(x * 4)
    return m, x


def _skey(case, strategy, reduce, use_kernel):
    return f"s-{case}-{strategy}-{reduce}-{int(use_kernel)}"


def _tkey(kind, strategy, use_kernel):
    return f"t-{kind}-{strategy}-{int(use_kernel)}"


def run_reference(out_path: str) -> None:
    """The JAX engines on every combination (needs 8 host devices)."""
    import jax

    from repro.comm import AccessPattern, IrregularScatter
    from repro.core import matrix as jmatrix
    from repro.core.spmv import DistributedSpMV

    assert len(jax.devices()) == P, jax.devices()
    mesh = jax.make_mesh((P,), ("data",))
    out = {}
    for case, strategy, reduce, use_kernel in SCATTER_COMBOS:
        idx, vals = _case(case)
        n, _, _, _, blocksize, _ = CASES[case]
        s = IrregularScatter(AccessPattern.from_indices(idx, n=n), mesh,
                             strategy=strategy, blocksize=blocksize,
                             shards_per_node=SHARDS_PER_NODE, reduce=reduce,
                             use_kernel=use_kernel, use_plan_cache=False)
        out[_skey(case, strategy, reduce, use_kernel)] = np.asarray(
            s(s.shard_values(vals)))
    for kind, strategy, use_kernel in SPMV_COMBOS:
        m, x = _matrix(jmatrix, kind)
        eng = DistributedSpMV(m, mesh, strategy=strategy, blocksize=BLOCKSIZE,
                              shards_per_node=SHARDS_PER_NODE,
                              use_kernel=use_kernel, transpose=True,
                              use_plan_cache=False)
        out[_tkey(kind, strategy, use_kernel)] = np.asarray(
            eng(eng.shard_vector(x)))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_scatter") / "ref.npz"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def scatter_plans():
    """Each case's reference ScatterPlan, carried across to the port."""
    from repro.comm import plan as jplan
    from repro_torch import convert

    plans = {}
    for case in CASES:
        idx, _ = _case(case)
        n, _, _, _, blocksize, _ = CASES[case]
        jp = jplan.build_comm_plan(idx, n, P, blocksize=blocksize,
                                   topology=jplan.Topology(P,
                                                           SHARDS_PER_NODE))
        plans[case] = convert.from_reference(None, jp.transpose())[1]
    return plans


@pytest.fixture(scope="module")
def spmv_plans():
    """The SpMV matrix's reference plans (the same for both kinds of
    data: the pattern is the column table), carried across."""
    from repro.comm import plan as jplan
    from repro.core import matrix as jmatrix
    from repro_torch import convert

    m, _ = _matrix(jmatrix, "float")
    jp = jplan.build_comm_plan(m.cols, N, P, blocksize=BLOCKSIZE,
                               topology=jplan.Topology(P, SHARDS_PER_NODE))
    return convert.from_reference(None, jp.transpose())[1]


@pytest.mark.parametrize("case,strategy,reduce,use_kernel", SCATTER_COMBOS)
def test_scatter_matches_jax_and_numpy(reference, scatter_plans, case,
                                       strategy, reduce, use_kernel):
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.scatter import IrregularScatter
    from repro_torch.kernels import ops as kops

    idx, vals = _case(case)
    n, m = CASES[case][:2]
    splan = scatter_plans[case]
    s = IrregularScatter(AccessPattern.from_indices(idx, n=n),
                         LoopbackComm(P, device="cpu"), strategy=strategy,
                         reduce=reduce, use_kernel=use_kernel,
                         scatter_plan=splan)
    assert s.direction == "put" and s.splan is splan
    assert s.counts is splan.counts
    assert (s.tables is not None) == use_kernel
    kops.reset_launch_counts()
    tv = s.shard_values(vals)
    assert tuple(tv.shape) == (P, m // P) + vals.shape[1:]
    y = s(tv)
    assert tuple(y.shape) == (P, n // P) + vals.shape[2:]
    # the handle protocol gives the same result
    y2 = s.start_local(tv, *s.plan_args).finish()
    assert not any(kops.launch_counts().values())      # CPU: plain versions
    got = y.reshape((n,) + vals.shape[2:]).numpy()
    np.testing.assert_array_equal(got, y2.reshape(got.shape).numpy())
    np.testing.assert_array_equal(
        got, reference[_skey(case, strategy, reduce, use_kernel)])
    np.testing.assert_array_equal(got, _numpy_ref(idx, vals, n, reduce))


@pytest.mark.parametrize("kind,strategy,use_kernel", SPMV_COMBOS)
def test_transposed_spmv_matches_jax_engine(reference, spmv_plans, kind,
                                            strategy, use_kernel):
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.core import matrix as tmatrix
    from repro_torch.core.spmv import DistributedSpMV

    m, x = _matrix(tmatrix, kind)
    eng = DistributedSpMV(m, LoopbackComm(P, device="cpu"),
                          strategy=strategy, shards_per_node=SHARDS_PER_NODE,
                          use_kernel=use_kernel, transpose=True,
                          base_plan=spmv_plans.base, scatter_plan=spmv_plans)
    assert eng.transpose and eng.blocksize == BLOCKSIZE
    assert eng.counts is spmv_plans.counts
    y = eng(eng.shard_vector(x)).reshape(-1).numpy()
    want = reference[_tkey(kind, strategy, use_kernel)]
    if kind == "int":
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(y, tmatrix.spmv_t_ref_np(m, x))
    else:
        np.testing.assert_allclose(y, want, **TOL)
        np.testing.assert_allclose(y, tmatrix.spmv_t_ref_np(m, x), **TOL)


def test_scatter_refusals(scatter_plans):
    import torch

    from repro_torch.comm import plan as tplan
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.scatter import IrregularScatter
    from repro_torch.core import matrix as tmatrix
    from repro_torch.core.spmv import DistributedSpMV

    idx, _ = _case("square")
    pattern = AccessPattern.from_indices(idx, n=CASES["square"][0])
    comm = LoopbackComm(P, device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        IrregularScatter(pattern, comm, strategy="condensed", reduce="min")
    s = IrregularScatter(pattern, comm, strategy="condensed",
                         scatter_plan=scatter_plans["square"])
    # per-batch tables (A9): derived from the same indices, the plan's own
    derived = s.derive_plan_args(torch.as_tensor(idx))
    assert all(got.dtype == want.dtype and torch.equal(got, want)
               for got, want in zip(derived, s.plan_args))
    assert len(derived) == len(s.plan_args) == 5
    other = tplan.build_comm_plan(idx, CASES["square"][0], P, blocksize=32)
    with pytest.raises(AssertionError, match="different base plan"):
        IrregularScatter(pattern, comm, strategy="condensed", base_plan=other,
                         scatter_plan=scatter_plans["square"])
    m, _ = _matrix(tmatrix, "float")
    with pytest.raises(AssertionError, match="materialize"):
        DistributedSpMV(m, comm, transpose=True, materialize="full")
    eng = DistributedSpMV(m, comm, transpose=True, blocksize=BLOCKSIZE)
    with pytest.raises(AssertionError, match="never gathers"):
        eng.gather_x_copy(eng.shard_vector(np.zeros(N, np.float32)))


def test_loopback_all_reduce():
    """The replicate put rung's psum/pmax: every rank gets the reduction;
    sum adds the ranks in ascending order, max keeps XLA's semantics."""
    import torch

    from repro_torch.comm.communicator import LoopbackComm

    comm = LoopbackComm(3, device="cpu")
    x = torch.tensor([[1e8, -0.0, 1.0, float("nan")],
                      [1.0, 0.0, 2.0, 1.0],
                      [-1e8, -0.0, -5.0, 2.0]])
    total = comm.all_reduce(x).wait()
    assert total.shape == x.shape
    want = (x[0] + x[1]) + x[2]
    for q in range(3):
        assert torch.equal(total[q, :3], want[:3])
        assert total[q, 3].isnan()
    assert float(total[0, 0]) == 0.0           # (1e8 + 1) - 1e8 in float32
    high = comm.all_reduce(x, "max", async_op=True).wait()
    assert torch.equal(high[:, :3], torch.tensor([[1e8, 0.0, 2.0]] * 3))
    assert not torch.signbit(high[:, 1]).any()  # +0.0 beats -0.0
    assert high[:, 3].isnan().all()
    with pytest.raises(ValueError, match="op"):
        comm.all_reduce(x, "min")


if __name__ == "__main__":
    run_reference(sys.argv[1])
