"""The forward SpMV over a ``DistComm`` of 2 gloo processes × 4 ranks.

``tests/helpers/check_strategies.py``'s matrix (n = 8·512, r_nz 16,
window 300, 2 % long-range, seed 3; x from seed 0), every gather rung ×
blocksizes 64 and 512 × ``materialize`` full and dest, ``use_kernel=False``
on the CPU.  Each process builds the same host plan and runs its own four
ranks (``python tests/test_torch_dist_spmv.py RANK 2 INIT OUT``), writing
its rows of ``y`` and ``x_copy``:

* against the ``LoopbackComm(8)`` engine's rows, bit for bit (``x_copy``
  below n: slot n is the padding dump, garbage by contract);
* against the JAX ``DistributedSpMV`` on 8 forced host devices (run once
  in a subprocess of this file, ``python tests/test_torch_dist_spmv.py
  jax OUT``, as the other SpMV tests run it): ``x_copy`` bit for bit below
  n, ``y`` within ``check_strategies.py``'s 2e-5;
* ``strategy="auto"``: the same rung and the same predicted times on both
  processes (the calibration's maximum over ranks, ``core.tune``), and
  that rung's ``y`` bit for bit with the loopback engine's;
* the per-batch consumers, once refused over a process holding some of
  the ranks, build over the partial communicator and run one call each
  with no refusal (their outputs are held in
  ``tests/test_torch_dist_per_batch.py``); the push direction, the normal
  equations, CG and Heat2D run over it (``tests/test_torch_dist_push.py``,
  ``tests/test_torch_dist_heat2d.py``).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_dist_comm import ROOT, init_gloo, run_ranks

N, R_NZ, P, WORLD, SHARDS_PER_NODE = 8 * 512, 16, 8, 2, 4
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")
BLOCKSIZES = (64, 512)
MATERIALIZE = ("full", "dest")
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(matrix_mod):
    m = matrix_mod.make_mesh_like_matrix(N, r_nz=R_NZ, locality_window=300,
                                         long_range_frac=0.02, seed=3)
    x = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    return m, x


def _key(strategy, bs, materialize="full"):
    return f"{strategy}-{bs}-{materialize}"


def _engines(comm, m):
    from repro_torch.core.spmv import DistributedSpMV
    for strategy in STRATEGIES:
        for bs in BLOCKSIZES:
            for mat in MATERIALIZE:
                yield _key(strategy, bs, mat), DistributedSpMV(
                    m, comm, strategy=strategy, blocksize=bs,
                    shards_per_node=SHARDS_PER_NODE, materialize=mat,
                    use_plan_cache=False)


def _once_refused(comm, m, x):
    """The per-batch consumers that once refused a process holding some of
    the ranks: each builds over ``comm`` and runs one call on its rows.
    Returns the names of those that ran (every one: a refusal raises)."""
    import torch

    from repro_torch.comm.dynamic import DynamicPattern
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.core import perfmodel as pm
    from repro_torch.models.gnn import GNNNeighborAggregate
    from repro_torch.models import moe

    pattern = AccessPattern.from_ellpack(m)
    top_e = np.repeat(np.arange(16, dtype=np.int32)[:, None] % 8, 2, 1)
    top_e[:, 1] = (top_e[:, 1] + 1) % 8
    top_w = np.full((16, 2), 0.5, np.float32)
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal((8, 4, 4)).astype(np.float32)
              for k in ("w1", "w2")}
    tokens = rng.standard_normal((16, 4)).astype(np.float32)
    kw = dict(strategy="condensed", hw=pm.ABEL, use_plan_cache=False)

    def dynamic():
        g = IrregularGather(DynamicPattern.from_template(pattern, P), comm,
                            **kw)
        return g(g.shard_vector(x))

    def derive_plan_args():
        g = IrregularGather(DynamicPattern.from_template(pattern, P), comm,
                            **kw)
        args = g.derive_plan_args(torch.as_tensor(pattern.indices))
        return g.local(g.shard_vector(x), *args)

    def gnn():
        layer = GNNNeighborAggregate(m.cols, N, comm, **kw)
        return layer(layer.shard_features(x[:, None]))

    def moe_dispatch():
        g = moe.MoEDispatchGather(top_e, 16, 8, 4, comm, **kw)
        return g(g.shard_tokens(tokens))

    def moe_combine():
        c = moe.MoECombineScatter(top_e, top_w, 16, 8, 4, comm, **kw)
        return c(c.shard_expert_buf(np.ones((8, 4, 4), np.float32)))

    def moe_layer():
        layer = moe.MoELayer(params, top_e, top_w, 16, 8, 4, comm, **kw)
        return layer(layer.shard_tokens(tokens))

    def dynamic_moe():
        layer = moe.DynamicMoELayer(params, top_e, 16, 8, 4, comm, **kw)
        return layer(layer.shard_tokens(tokens), top_e, top_w)

    ran = []
    for build in (dynamic, derive_plan_args, gnn, moe_dispatch, moe_combine,
                  moe_layer, dynamic_moe):
        out = build()
        assert out.shape[0] == comm.p_local and torch.isfinite(
            out.float()).all(), build.__name__
        ran.append(build.__name__)
    return ran


def _worker(rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm
    from repro_torch.core import matrix
    from repro_torch.core.spmv import DistributedSpMV

    init_gloo(rank, world, init)
    comm = DistComm(P // world, device="cpu")
    m, x = _inputs(matrix)
    res = {}
    for key, eng in _engines(comm, m):
        xs = eng.shard_vector(x)
        assert tuple(xs.shape) == (P // world, N // P)
        res["y-" + key] = eng(xs).numpy()
        res["xc-" + key] = eng.gather_x_copy(xs).numpy()
    auto = DistributedSpMV(m, comm, strategy="auto", blocksize=64,
                           shards_per_node=SHARDS_PER_NODE,
                           use_plan_cache=False)
    res["y-auto"] = auto(auto.shard_vector(x)).numpy()
    meta = {"auto": auto.strategy, "predicted": auto.predicted_times,
            "ran": _once_refused(comm, m, x)}
    dist.destroy_process_group()
    np.savez(f"{out}-{rank}.npz", **res)
    pathlib.Path(f"{out}-{rank}.json").write_text(json.dumps(meta))


def run_reference(out_path: str) -> None:
    """The JAX engine on every rung × blocksize (needs 8 host devices)."""
    import jax

    from repro.core import matrix as jmatrix
    from repro.core.spmv import DistributedSpMV

    assert len(jax.devices()) == P, jax.devices()
    mesh = jax.make_mesh((P,), ("data",))
    m, x = _inputs(jmatrix)
    out = {}
    for strategy in STRATEGIES:
        for bs in BLOCKSIZES:
            eng = DistributedSpMV(m, mesh, strategy=strategy, blocksize=bs,
                                  shards_per_node=SHARDS_PER_NODE,
                                  use_plan_cache=False)
            xs = eng.shard_vector(x)
            out["y-" + _key(strategy, bs)] = np.asarray(eng(xs))
            out["xc-" + _key(strategy, bs)] = np.asarray(
                eng.gather_x_copy(xs))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_spmv")
    run_ranks(__file__, WORLD, tmp, tmp / "rank", timeout=300)
    return [(dict(np.load(tmp / f"rank-{r}.npz")),
             json.loads((tmp / f"rank-{r}.json").read_text()))
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dist_spmv") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, "jax", str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def loopback():
    """The ``LoopbackComm(8)`` engines' ``y`` and ``x_copy``."""
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.core import matrix

    m, x = _inputs(matrix)
    out = {}
    for key, eng in _engines(LoopbackComm(P, device="cpu"), m):
        xs = eng.shard_vector(x)
        out["y-" + key] = eng(xs).numpy()
        out["xc-" + key] = eng.gather_x_copy(xs).numpy()
    return out


def _stacked(ranks, name):
    return np.concatenate([res[name] for res, _ in ranks])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("bs", BLOCKSIZES)
@pytest.mark.parametrize("materialize", MATERIALIZE)
def test_dist_spmv_is_the_loopback_engine_and_the_jax_one(
        ranks, loopback, reference, strategy, bs, materialize):
    key = _key(strategy, bs, materialize)
    y = _stacked(ranks, "y-" + key)
    xc = _stacked(ranks, "xc-" + key)
    np.testing.assert_array_equal(y, loopback["y-" + key])
    # slot n is the padding dump: garbage by contract
    np.testing.assert_array_equal(xc[:, :N], loopback["xc-" + key][:, :N])
    want_xc = reference["xc-" + _key(strategy, bs)]
    np.testing.assert_array_equal(xc[:, :N], want_xc[:, :N])
    np.testing.assert_allclose(y.reshape(-1),
                               reference["y-" + _key(strategy, bs)], **TOL)


def test_dist_auto_picks_one_rung_on_every_rank(ranks, loopback):
    (_, meta0), (_, meta1) = ranks
    assert meta0["auto"] == meta1["auto"] in STRATEGIES
    assert meta0["predicted"] == meta1["predicted"]
    np.testing.assert_array_equal(
        _stacked(ranks, "y-auto"),
        loopback["y-" + _key(meta0["auto"], 64, "dest")])


def test_dist_refuses_the_consumers_of_later_slices(ranks):
    """None is refused now: each of the once-refused consumers built over
    the partial communicator and ran one call (``_once_refused``)."""
    for _, meta in ranks:
        assert meta["ran"] == [
            "dynamic", "derive_plan_args", "gnn", "moe_dispatch",
            "moe_combine", "moe_layer", "dynamic_moe"]


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        run_reference(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4])
