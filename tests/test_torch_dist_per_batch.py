"""The per-batch consumers over a ``DistComm`` whose processes hold only some
of the ranks.

Eight ranks held as world × p_local = 2 × 4 and 4 × 2 gloo processes.  Each
world spawns once from this file (``python
tests/test_torch_dist_per_batch.py RANK WORLD INIT OUT``); every process
derives the per-batch tables from each batch's whole table, runs its own
ranks through every case and writes its rows:

* a ``DynamicPattern`` ``IrregularGather`` (float32 and int32) and
  ``IrregularScatter`` (``reduce`` add/set/max, float32 and int32),
  condensed and overlap, ``use_kernel`` both ways (on the CPU the kernels'
  plain versions), over ``tests/test_torch_dynamic_kernels.py``'s
  template and three batches through one exchange, the template's own
  plan args first;
* ``MoEDispatchGather`` on every rung × dest/full, ``MoECombineScatter``
  and ``MoELayer`` on every rung, at ``tests/test_torch_moe.py``'s sizes;
* ``DynamicMoELayer.__call__`` and ``.apply`` (the whole ``(T, d)``
  output in every process) over three routings through one layer;
* ``GNNNeighborAggregate`` on every rung and ``auto``;
* the reduced mixtral engine of ``tests/test_torch_serve_moe.py`` with the
  MoE decode hook over the process's ``DistComm``, on the JAX package's
  weights (each process initialises them as the reference does), and
  ``launch.serve --moe-comm --mesh 8`` under the group, which builds the
  ``DistComm`` itself (``launch.serve.make_comm``); and, in two processes
  started as a launcher starts them (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``/``MASTER_PORT`` on localhost), ``launch.serve.main``
  initialising the group itself and destroying it after.

The processes' rows, stacked, must be the ``LoopbackComm(8)`` results of
the same cases bit for bit (run in this process while the ranks run), and
every process's engine tokens the loopback engine's.  The JAX package's
outputs come from those three files' own ``run_reference``, each run once
in an 8-device subprocess of this file, the three at once (``python
tests/test_torch_dist_per_batch.py jax DYN_OUT MOE_OUT SERVE_DIR``), and
are held at those files' tolerances: the dynamic exchanges bit for bit,
``DynamicMoELayer`` and the GNN within 1e-5, the engine's tokens exactly.
The host-planned MoE layers are held against the numpy oracles
(``moe_dispatch_ref``, ``moe_combine_ref``): the JAX ``MoECombineScatter``
and ``MoELayer`` fail on this tree.
"""
import json
import sys

import numpy as np
import pytest

import test_torch_dynamic_kernels as tdk
import test_torch_moe as tmo
import test_torch_serve_moe as tsm
from test_torch_dist_comm import ROOT, init_gloo, run_worlds

P = 8
WORLDS = (2, 4)
WORLD_IDS = ["2x4", "4x2"]
# three batches through one exchange; the JAX side holds the first two
BATCH_SEEDS = tdk.BATCH_SEEDS + (13,)
KERNEL_ARMS = (False, True)
DISPATCH_CAP = 8        # test_torch_moe's dispatch and combine capacity
SERVE_ARGV = ["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu",
              "--requests", "8", "--slots", "8", "--prompt-len", "10",
              "--gen", "3", "--prefill-chunk", "4", "--moe-comm",
              "--experts", "8", "--mesh", str(P)]


def _gkey(strategy, dtype, use_kernel, seed):
    return f"g-{strategy}-{dtype}-{int(use_kernel)}-{seed}"


def _skey(strategy, reduce, dtype, use_kernel, seed):
    return f"s-{strategy}-{reduce}-{dtype}-{int(use_kernel)}-{seed}"


def _dynamic(comm, res) -> None:
    """The ``DynamicPattern`` exchanges: the template's own plan args,
    then each batch's ``derive_plan_args`` of its whole table."""
    import torch

    from repro_torch.comm import dynamic as tdyn
    from repro_torch.comm import plan_cache
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.scatter import IrregularScatter

    n = tdk.N_TOK
    template = tdk._routing(*tdk.FRONT, tdk.TEMPLATE_SEED, P)
    dp = tdyn.DynamicPattern.from_template(
        AccessPattern.from_indices(template, n=n), P)
    base = plan_cache.get_envelope_plan(template, n, P, s_max=dp.s_max,
                                        cache=False)
    batches = {seed: torch.as_tensor(tdk._routing(*tdk.FRONT, seed, P))
               for seed in BATCH_SEEDS}

    def run(ex, v, args, overlap):
        if overlap:
            return ex.start_local(v, *args).finish()
        return ex.local(v, *args)

    for strategy, dtype in tdk.GATHER_COMBOS:
        for use_kernel in KERNEL_ARMS:
            g = IrregularGather(dp, comm, strategy=strategy,
                                use_kernel=use_kernel, base_plan=base)
            tmpl = g.derive_plan_args(torch.as_tensor(template))
            assert all(torch.equal(a, b) for a, b in zip(tmpl[:2],
                                                         g.plan_args[:2]))
            assert g.plan_args[0].shape[0] == comm.p_local
            cases = [(tdk.TEMPLATE_SEED, g.plan_args)] + [
                (seed, g.derive_plan_args(cols))
                for seed, cols in batches.items()]
            for seed, args in cases:
                x = g.shard_vector(tdk._values(dtype, n, seed))
                got = run(g, x, args, strategy == "overlap")
                res[_gkey(strategy, dtype, use_kernel, seed)] = got[
                    :, :n].numpy()
    for strategy, reduce, dtype in tdk.SCATTER_COMBOS:
        for use_kernel in KERNEL_ARMS:
            s = IrregularScatter(dp, comm, strategy=strategy, reduce=reduce,
                                 use_kernel=use_kernel, base_plan=base)
            tmpl = s.derive_plan_args(torch.as_tensor(template))
            assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(
                tmpl[:5], s.plan_args[:5]))
            cases = [(tdk.TEMPLATE_SEED, template, s.plan_args)]
            for seed, cols in batches.items():
                whole = tdyn.derive_gather_tables(cols, n, P, dp.s_max)
                args = s.derive_plan_args(cols, gather_tables=whole)
                alone = s.derive_plan_args(cols)
                assert all(torch.equal(a, b) for a, b in zip(args[:5],
                                                             alone[:5]))
                cases.append((seed, cols, args))
            for seed, cols, args in cases:
                vals = s.shard_values(tdk._values(dtype, tuple(cols.shape),
                                                  seed + 100))
                assert vals.shape[0] == comm.p_local
                got = run(s, vals, args, strategy == "overlap")
                res[_skey(strategy, reduce, dtype, use_kernel,
                          seed)] = got.numpy()


def _moe(comm, res) -> None:
    """The three host-planned MoE layers, ``DynamicMoELayer`` and the GNN
    at ``tests/test_torch_moe.py``'s sizes."""
    import torch

    from repro_torch.core import perfmodel as pm
    from repro_torch.models import moe as TM
    from repro_torch.models.gnn import GNNNeighborAggregate

    kw = dict(hw=pm.ABEL, use_plan_cache=False)
    x = tmo._tokens()
    te3, _ = tmo._routing(k=3)
    for strategy in tmo.STRATEGIES:
        for mat in ("dest", "full"):
            g = TM.MoEDispatchGather(te3, tmo.N_TOK, tmo.E, DISPATCH_CAP,
                                     comm, strategy=strategy,
                                     materialize=mat, **kw)
            res[f"dispatch-{strategy}-{mat}"] = g(g.shard_tokens(x)).numpy()
        for data in ("integer", "float"):
            c, buf = _combine_case(comm, strategy, data, **kw)
            res[f"combine-{strategy}-{data}"] = c(
                c.shard_expert_buf(buf)).numpy()
    params = tmo._moe_params()
    te, tw = tmo._routing()
    for strategy in tmo.STRATEGIES:
        layer = TM.MoELayer(params, te, tw, tmo.N_TOK, tmo.E, tmo.CAP, comm,
                            act="swiglu", strategy=strategy, **kw)
        res[f"layer-{strategy}"] = layer(layer.shard_tokens(x)).numpy()

    te0, _ = TM.random_router(0, tmo.N_TOK, tmo.E, tmo.K)
    layer = TM.DynamicMoELayer(params, te0, tmo.N_TOK, tmo.E, tmo.CAP, comm,
                               act="swiglu", strategy="auto", **kw)
    assert layer._weights[0].shape[0] == tmo.E // P * comm.p_local
    res["dyn-strategies"] = np.array([layer.strategies["dispatch"],
                                      layer.strategies["combine"]])
    w = [torch.as_tensor(params[k]) for k in ("w1", "w2", "w3")]
    for seed in tmo.ROUTING_SEEDS:
        te, tw = TM.random_router(seed, tmo.N_TOK, tmo.E, tmo.K)
        res[f"dyn-{seed}"] = layer(layer.shard_tokens(x), te, tw).numpy()
        res[f"dyn-apply-{seed}"] = layer.apply(
            torch.as_tensor(x), torch.as_tensor(te), torch.as_tensor(tw),
            *w).numpy()

    nbrs, h = tmo._graph()
    for strategy in tmo.STRATEGIES + ("auto",):
        gnn = GNNNeighborAggregate(nbrs, tmo.GNN_N, comm, strategy=strategy,
                                   **kw)
        res[f"gnn-{strategy}"] = gnn(gnn.shard_features(h)).numpy()


def _combine_case(comm, strategy, data, **kw):
    """``test_torch_moe``'s combine case: the layer and its host buffer."""
    from repro_torch.models import moe as TM

    integer = data == "integer"
    te, tw = tmo._routing(k=3, int_weights=integer)
    rng = np.random.default_rng(2)
    buf = (rng.integers(-4, 5, (tmo.E, tmo.CAP, tmo.D)) if integer
           else rng.standard_normal((tmo.E, tmo.CAP, tmo.D))).astype(
               np.float32)
    return TM.MoECombineScatter(te, tw, tmo.N_TOK, tmo.E, tmo.CAP, comm,
                                strategy=strategy, **kw), buf


def _jax_weights(cfg):
    """The reference engine's weights, initialised as its
    ``run_reference`` does (``PRNGKey(0)``), in the port's layout."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.models.transformer import Model as JModel
    from repro.models.transformer import RunCtx as JCtx
    from repro_torch.convert import model_params_from_reference

    jmodel = JModel(tsm._cfg(jreg), JCtx(remat="none",
                                         act_dtype=jnp.float32))
    jparams = jax.tree.map(np.asarray,
                           jmodel.init_params(jax.random.PRNGKey(0)))
    return model_params_from_reference(cfg, jparams)


def _serve(comm, res) -> None:
    """The reduced mixtral engine with the MoE decode hook over ``comm``
    on the reference's weights, the reference's two batches in turn; then
    ``launch.serve --moe-comm --mesh 8`` (its own communicator)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import serve as tserve
    from repro_torch.models.transformer import Model, RunCtx
    from repro_torch.serve import Request, ServeEngine

    cfg = tsm._cfg(registry)
    model = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    params = model.load_params(_jax_weights(cfg))
    layer = tserve.build_moe_layer(model, params, tsm.NUM_SLOTS, comm)
    engine = ServeEngine(model, params, num_slots=tsm.NUM_SLOTS,
                         cache_len=tsm.CACHE_LEN, prefill_chunk=tsm.CHUNK,
                         moe_layer=layer, cache_dtype=torch.float32)
    rng = np.random.default_rng(2)
    for tag, gen in (("warm", 2), ("req", 4)):
        reqs = tsm._batch(cfg, rng, tag, gen)
        for r in reqs:
            engine.submit(Request(**r))
        out = engine.run().outputs
        res[f"engine-{tag}"] = np.array([out[r["id"]] for r in reqs])
    rep = tserve.main(SERVE_ARGV)
    res["launch"] = np.array([rep.outputs[f"req{i}"] for i in range(8)])


def _results(comm) -> dict:
    """Every case's output on ``comm``'s rows, by key."""
    res = {}
    _dynamic(comm, res)
    _moe(comm, res)
    _serve(comm, res)
    return res


def _worker(rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm
    from repro_torch.launch import serve as tserve

    init_gloo(rank, world, init)
    comm = DistComm(P // world, device="cpu")
    assert comm.rank_offset == rank * (P // world)
    res = _results(comm)
    # a rank count the world does not split is refused
    refused = False
    try:
        tserve.make_comm(str(2 * world + 1), "cpu")
    except ValueError as e:
        refused = "do not split" in str(e)
    assert refused
    made = tserve.make_comm(str(P), "cpu")
    assert (made.kind, made.p, made.p_local) == ("dist", P, P // world)
    dist.destroy_process_group()
    np.savez(f"{out}-{rank}.npz", **res)


JAX_REFERENCES = {"dynamic": tdk.run_reference, "moe": tmo.run_reference,
                  "serve": tsm.run_reference}


def _launched(out: str) -> None:
    """One process started as a launcher starts it: ``launch.serve.main``
    initialises the group from the environment and destroys it after."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import serve as tserve

    rep = tserve.main(SERVE_ARGV)
    assert not dist.is_initialized()
    np.save(f"{out}-{os.environ['RANK']}.npy",
            np.array([rep.outputs[f"req{i}"] for i in range(8)]))


def _jax(*outs: str) -> None:
    """The three files' ``run_reference`` at once, one subprocess each
    (``python tests/test_torch_dist_per_batch.py jax-one NAME OUT``)."""
    import os
    import subprocess

    env = dict(os.environ, REPRO_PLAN_CACHE="0")
    procs = [subprocess.Popen([sys.executable, __file__, "jax-one", name,
                               out], env=env, stderr=subprocess.PIPE,
                              text=True)
             for name, out in zip(JAX_REFERENCES, outs)]
    errs = [proc.communicate(timeout=800)[1] for proc in procs]
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' rows (stacked, and each process's own), the
    ``LoopbackComm(8)`` results (run in this process while the ranks run)
    and the JAX package's."""
    from repro_torch.comm import plan_cache
    from repro_torch.comm.communicator import LoopbackComm

    tmp = tmp_path_factory.mktemp("dist_per_batch")
    serve_dir = tmp / "serve"
    serve_dir.mkdir()
    ref = [tmp / "dynamic.npz", tmp / "moe.npz", serve_dir]
    with pytest.MonkeyPatch.context() as mp:
        # no plan cache in this process, the ranks or the JAX subprocess
        mp.setenv("REPRO_TORCH_PLAN_CACHE", "0")
        plan_cache.clear_memory_cache()
        loop, ranks = run_worlds(
            __file__, WORLDS, tmp, ref,
            lambda: _results(LoopbackComm(P, device="cpu")))
    out = {w: {"stacked": {k: np.concatenate([r[k] for r in ranks[w]])
                           for k in loop},
               "ranks": ranks[w]} for w in WORLDS}
    with np.load(ref[1]) as data:
        jmoe = {k: data[k] for k in data.files}
    out.update(loopback=loop, dynamic=dict(np.load(ref[0])), moe=jmoe,
               serve=json.loads((serve_dir / "out.json").read_text()))
    return out


def _equal_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    view = {4: np.int32, 2: np.int16}
    if got.dtype.kind == "f":
        got, want = got.view(view[got.itemsize]), want.view(
            view[want.itemsize])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("use_kernel", KERNEL_ARMS, ids=["plain", "kernel"])
@pytest.mark.parametrize("strategy,dtype", tdk.GATHER_COMBOS)
def test_dist_dynamic_gather_is_loopback_and_jax(runs, world, strategy,
                                                 dtype, use_kernel):
    for seed in (tdk.TEMPLATE_SEED,) + BATCH_SEEDS:
        key = _gkey(strategy, dtype, use_kernel, seed)
        got = runs[world]["stacked"][key]
        _equal_bits(got, runs["loopback"][key])
        if seed in tdk.BATCH_SEEDS:
            want = runs["dynamic"][tdk._gkey(strategy, dtype, seed)]
            np.testing.assert_array_equal(got, want[:, :tdk.N_TOK])


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("use_kernel", KERNEL_ARMS, ids=["plain", "kernel"])
@pytest.mark.parametrize("strategy,reduce,dtype", tdk.SCATTER_COMBOS)
def test_dist_dynamic_scatter_is_loopback_and_jax(runs, world, strategy,
                                                  reduce, dtype, use_kernel):
    for seed in (tdk.TEMPLATE_SEED,) + BATCH_SEEDS:
        key = _skey(strategy, reduce, dtype, use_kernel, seed)
        got = runs[world]["stacked"][key]
        _equal_bits(got, runs["loopback"][key])
        if seed in tdk.BATCH_SEEDS:
            want = runs["dynamic"][tdk._skey(strategy, reduce, dtype, seed)]
            np.testing.assert_array_equal(got.reshape(-1), want)


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("materialize", ["dest", "full"])
@pytest.mark.parametrize("strategy", tmo.STRATEGIES)
def test_dist_moe_dispatch_is_loopback_and_the_oracle(runs, world, strategy,
                                                      materialize):
    from repro_torch.models import moe as TM

    key = f"dispatch-{strategy}-{materialize}"
    got = runs[world]["stacked"][key]
    _equal_bits(got, runs["loopback"][key])
    te, _ = tmo._routing(k=3)
    idx, valid = TM.moe_dispatch_pattern(te, tmo.N_TOK, tmo.E, DISPATCH_CAP,
                                         P)
    np.testing.assert_array_equal(
        got.reshape(tmo.E, DISPATCH_CAP, tmo.D),
        TM.moe_dispatch_ref(tmo._tokens(), idx, valid, tmo.E, DISPATCH_CAP))


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("data", ["integer", "float"])
@pytest.mark.parametrize("strategy", tmo.STRATEGIES)
def test_dist_moe_combine_is_loopback_and_the_oracle(runs, world, strategy,
                                                     data):
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.models import moe as TM

    key = f"combine-{strategy}-{data}"
    got = runs[world]["stacked"][key]
    _equal_bits(got, runs["loopback"][key])
    c, buf = _combine_case(LoopbackComm(P, device="cpu"), strategy, data,
                           use_plan_cache=False)
    want = TM.moe_combine_ref(buf, c.idx, c.valid, c.w_slot, tmo.N_TOK)
    got = got.reshape(tmo.N_TOK, tmo.D)
    if data == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("strategy", tmo.STRATEGIES)
def test_dist_moe_layer_is_loopback_and_the_oracle(runs, world, strategy):
    import torch

    from repro_torch.models import moe as TM

    key = f"layer-{strategy}"
    got = runs[world]["stacked"][key]
    _equal_bits(got, runs["loopback"][key])
    # the oracle: dispatch, the experts on every slot, the weighted combine
    params, x = tmo._moe_params(), tmo._tokens()
    te, tw = tmo._routing()
    idx, valid = TM.moe_dispatch_pattern(te, tmo.N_TOK, tmo.E, tmo.CAP, P)
    w_slot = TM.moe_combine_weights(te, tw, tmo.N_TOK, tmo.E, tmo.CAP)
    buf = TM.moe_dispatch_ref(x, idx, valid, tmo.E, tmo.CAP)
    out = TM.moe_expert_local(*(torch.as_tensor(a) for a in (
        buf, params["w1"], params["w2"], params["w3"])), act="swiglu")
    want = TM.moe_combine_ref(out.numpy(), idx, valid, w_slot, tmo.N_TOK)
    np.testing.assert_allclose(got.reshape(tmo.N_TOK, tmo.D), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("seed", tmo.ROUTING_SEEDS)
def test_dist_dynamic_moe_layer_is_loopback_and_jax(runs, world, seed):
    """``__call__``'s rows stacked, and ``apply``'s whole output in every
    process, are the loopback layer's bits and within 1e-5 of the JAX
    ``DynamicMoELayer``."""
    stacked, loop = runs[world]["stacked"], runs["loopback"]
    assert list(stacked["dyn-strategies"][:2]) == list(
        runs["moe"]["dyn_strategies"])
    got = stacked[f"dyn-{seed}"]
    _equal_bits(got, loop[f"dyn-{seed}"])
    flat = got.reshape(tmo.N_TOK, tmo.D)
    np.testing.assert_allclose(flat, runs["moe"][f"dyn_{seed}"], **tmo.TOL)
    for res in runs[world]["ranks"]:
        _equal_bits(res[f"dyn-apply-{seed}"], loop[f"dyn-apply-{seed}"])
        _equal_bits(res[f"dyn-apply-{seed}"], flat)


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
@pytest.mark.parametrize("strategy", tmo.STRATEGIES + ("auto",))
def test_dist_gnn_is_loopback_and_jax(runs, world, strategy):
    from repro_torch.models.gnn import gnn_ref_np

    key = f"gnn-{strategy}"
    got = runs[world]["stacked"][key]
    _equal_bits(got, runs["loopback"][key])
    flat = got.reshape(tmo.GNN_N, tmo.GNN_D)
    nbrs, h = tmo._graph()
    np.testing.assert_allclose(flat, gnn_ref_np(h, nbrs), **tmo.TOL)
    np.testing.assert_allclose(flat, runs["moe"][f"gnn_{strategy}"],
                               **tmo.TOL)


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
def test_dist_engine_emits_the_loopback_and_jax_tokens(runs, world):
    serve = runs["serve"]
    for tag in ("warm", "req"):
        want = np.array([serve[tag]["outputs"][r["id"]]
                         for r in serve[tag]["requests"]])
        _equal_bits(runs["loopback"][f"engine-{tag}"], want)
        for res in runs[world]["ranks"]:
            _equal_bits(res[f"engine-{tag}"], want)


@pytest.mark.parametrize("world", WORLDS, ids=WORLD_IDS)
def test_dist_launch_serve_moe_comm_is_loopback(runs, world):
    """``launch.serve --moe-comm --mesh 8`` under a group of ``world``
    processes serves every request to the one-process run's tokens."""
    want = runs["loopback"]["launch"]
    assert want.shape == (8, 3)
    for res in runs[world]["ranks"]:
        _equal_bits(res["launch"], want)


def test_launch_serve_initialises_its_group_under_a_launcher(runs, tmp_path):
    """Two processes with a launcher's environment (``env://`` on a free
    localhost port): ``launch.serve.main`` makes the gloo group, serves
    over ``DistComm(4)`` each, emits the one-process run's tokens."""
    import os
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", REPRO_TORCH_PLAN_CACHE="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "launched", str(tmp_path / "r")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [proc.communicate(timeout=240)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
    for r in range(2):
        _equal_bits(np.load(tmp_path / f"r-{r}.npy"),
                    runs["loopback"]["launch"])


if __name__ == "__main__":
    if sys.argv[1] == "launched":
        _launched(sys.argv[2])
    elif sys.argv[1] == "jax":
        _jax(*sys.argv[2:5])
    elif sys.argv[1] == "jax-one":
        JAX_REFERENCES[sys.argv[2]](sys.argv[3])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4])
