"""The port's ``DistributedSpMV`` at P = 8 against the JAX engine and numpy.

All four rungs × ``materialize`` full/dest × ``use_kernel``, on CPU tensors
with ``LoopbackComm(8, device="cpu")``.  The JAX engine needs eight
devices, which the test run does not configure, so it runs once in a
subprocess of this file (``python tests/test_torch_spmv.py OUT.npz`` with
``--xla_force_host_platform_device_count=8``, Pallas in interpret mode)
and writes every rank's ``x_copy`` and ``y`` for every combination.  Both
sides run the same matrix through the same plan: the port's comes from the
reference's by ``convert.from_reference``.

``x_copy`` must match bit for bit outside the dump slots (index >= n);
``y`` within rtol/atol 3e-5, the reference's own SpMV tolerance.
"""
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

N, R_NZ, P, BLOCKSIZE, SHARDS_PER_NODE = 2048, 8, 8, 64, 4
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")
COMBOS = list(itertools.product(STRATEGIES, ("full", "dest"), (False, True)))
TOL = dict(rtol=3e-5, atol=3e-5)


def _inputs(matrix_mod):
    m = matrix_mod.make_mesh_like_matrix(
        N, R_NZ, locality_window=N // 16, long_range_frac=0.03, seed=5)
    x = np.random.default_rng(5).standard_normal(N).astype(np.float32)
    return m, x


def _key(strategy, materialize, use_kernel):
    return f"{strategy}-{materialize}-{int(use_kernel)}"


def run_reference(out_path: str) -> None:
    """The JAX engine on every combination (needs 8 host devices)."""
    import jax

    from repro.core import matrix as jmatrix
    from repro.core.spmv import DistributedSpMV

    assert len(jax.devices()) == P, jax.devices()
    mesh = jax.make_mesh((P,), ("data",))
    m, x = _inputs(jmatrix)
    out = {}
    for strategy, materialize, use_kernel in COMBOS:
        eng = DistributedSpMV(m, mesh, strategy=strategy, blocksize=BLOCKSIZE,
                              shards_per_node=SHARDS_PER_NODE,
                              use_kernel=use_kernel, materialize=materialize,
                              use_plan_cache=False)
        xs = eng.shard_vector(x)
        k = _key(strategy, materialize, use_kernel)
        out["y-" + k] = np.asarray(eng(xs))
        out["xc-" + k] = np.asarray(eng.gather_x_copy(xs))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_spmv") / "ref.npz"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def shared():
    """The reference's matrix and base plan, carried across to the port."""
    from repro.comm import plan as jplan
    from repro.core import matrix as jmatrix
    from repro_torch import convert

    m, x = _inputs(jmatrix)
    jp = jplan.build_comm_plan(m.cols, N, P, blocksize=BLOCKSIZE,
                               topology=jplan.Topology(P, SHARDS_PER_NODE))
    tm, tp = convert.from_reference(m, jp)
    return tm, tp, x


@pytest.mark.parametrize("strategy,materialize,use_kernel", COMBOS)
def test_port_matches_jax_engine(reference, shared, strategy, materialize,
                                 use_kernel):
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.core.matrix import spmv_ref_np
    from repro_torch.core.spmv import DistributedSpMV
    from repro_torch.kernels import ops as kops

    tm, tp, x = shared
    eng = DistributedSpMV(tm, LoopbackComm(P, device="cpu"),
                          strategy=strategy, shards_per_node=SHARDS_PER_NODE,
                          use_kernel=use_kernel, materialize=materialize,
                          base_plan=tp)
    assert eng.blocksize == BLOCKSIZE
    kops.reset_launch_counts()
    xs = eng.shard_vector(x)
    assert tuple(xs.shape) == (P, N // P)
    y = eng(xs).reshape(-1).numpy()
    xc = eng.gather_x_copy(xs).numpy()
    assert not any(kops.launch_counts().values())      # CPU: plain versions
    k = _key(strategy, materialize, use_kernel)
    want_xc = reference["xc-" + k]
    assert xc.shape == want_xc.shape
    np.testing.assert_array_equal(xc[:, :N], want_xc[:, :N])
    np.testing.assert_allclose(y, reference["y-" + k], **TOL)
    np.testing.assert_allclose(y, spmv_ref_np(tm, x), **TOL)


def test_port_engine_refuses_later_slices(shared):
    import torch

    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.core.spmv import DistributedSpMV

    from repro_torch.core.perfmodel import ABEL

    tm, tp, _ = shared
    comm = LoopbackComm(P, device="cpu")
    # "auto" came with the §5 models (rung and blocksize resolve) ...
    eng = DistributedSpMV(tm, comm, strategy="auto", base_plan=tp, hw=ABEL)
    assert eng.requested_strategy == "auto" and eng.strategy in STRATEGIES
    assert eng.predicted_times[eng.strategy] == min(
        eng.predicted_times.values())
    eng = DistributedSpMV(tm, comm, blocksize="auto", hw=ABEL,
                          use_plan_cache=False)
    assert tm.n // P % eng.blocksize == 0
    # ... and per-batch scatter tables came with the dynamic patterns
    # (A9): derived on the device from the matrix's own columns, they are
    # the host plan's tables bit for bit
    t = DistributedSpMV(tm, comm, transpose=True, base_plan=tp)
    derived = t.scatter.derive_plan_args(torch.as_tensor(tm.cols))
    assert len(derived) == len(t.scatter.plan_args)
    for got, want in zip(derived, t.scatter.plan_args):
        assert got.dtype == want.dtype and torch.equal(got, want)


if __name__ == "__main__":
    run_reference(sys.argv[1])
