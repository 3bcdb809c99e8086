"""``launch.train --mesh D``: FSDP storage sharding over gloo processes.

Reduced llama3-8b (dense), mixtral-8x22b (expert weights split on their
model dimension), falcon-mamba-7b (ssm), whisper-tiny (the encoder stack)
and llama-3.2-vision-90b (the groups), and the reduced llama3-8b with a
tied embedding (no registered config ties it: one gather serves the
lookup and the head), float32, batch 4 of 16 tokens.
The ranks spawn from this file (``python tests/test_torch_fsdp.py RANK
WORLD INIT OUT CKPT``), first two, then four, and for each arch:

* train two steps through ``launch.train.setup`` at ``--mesh WORLD`` (one
  microbatch a rank), each rank assembling the parameters and the AdamW
  state after each step (``Placed.whole``), the two-rank run writing a
  checkpoint after its second step; at two ranks also two steps at
  ``--accum 2`` (two microbatches a rank);
* count the bytes of the distinct storages that a rank's parameters and
  AdamW state hold, at init and after a step, and keep its parts at init;
* at four ranks, resume the two-rank checkpoint and take a third step;
* ``DistComm.reduce_scatter`` and ``all_reduce`` against
  ``LoopbackComm(P)`` at ``p_local`` 1 and 2.

In this process the same steps run at ``--mesh local --accum D``:

* the assembled state, the loss and ``grad_norm`` after each step equal
  the local run's bit for bit at one microbatch a rank (the gather's
  backward sums the ranks' gradients in rank order, as the local
  accumulation sums its microbatches; the global norm sees each
  gradient whole); at two microbatches a rank each rank sums its own two
  before the ranks are summed, another order, so the step holds at
  ``STEP_TOL`` (``tests/test_torch_train_dp.py``'s 1e-5);
* a rank stores exactly ``1/D`` of the bytes of the split leaves of the
  parameters and of ``m`` and ``v``, and the whole of the others; its
  parts at init are the local init's cut by ``sharding.take_tree``, and
  that cut is the reference's: the ``addressable_shards`` of
  ``param_shardings`` on the reference's ``--mesh 2x1`` (its ``--mesh 2``
  refuses the rule table's model axis), computed in a JAX subprocess on
  two forced host devices;
* the two-rank checkpoint restores at four ranks (each rank's parts of
  the written state; its next step is ``--mesh local --accum 4``'s from
  the same checkpoint) and at ``--mesh local`` (the next step is the
  uninterrupted local run's), and ``repro.checkpoint.manager.restore``
  reads it;
* a sharded step retries nothing.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_dist_comm import ROOT, bits, init_gloo, inputs, run_ranks

ARCHS = ("llama3-8b", "mixtral-8x22b", "falcon-mamba-7b", "whisper-tiny",
         "llama-3.2-vision-90b")
TIED = "llama3-8b-tied"
TRAINED = ARCHS + (TIED,)
WORLDS = (2, 4)
BATCH, SEQ = 4, 16
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _argv(arch, *more):
    return ["--arch", arch, "--reduced", "--batch", str(BATCH), "--seq",
            str(SEQ), "--device", "cpu", "--steps", "3", *more]


def _paths(tree, keys=()):
    """``(keys, leaf)`` in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], keys + (k,))]
    return [(keys, tree)]


def _state(tr):
    return {"params": tr.params, "opt": tr.opt_state}


def _assembled(tr):
    """The rank's state, every leaf whole (a collective)."""
    return [tr.placed.whole(k, t).numpy().copy()
            for k, t in _paths(_state(tr))]


def _distinct_bytes(tree) -> int:
    """The bytes of the distinct storages that ``tree``'s leaves hold."""
    seen = {}
    for _, t in _paths(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _config(arch):
    from repro_torch.configs.registry import get_config
    if arch == TIED:
        return dataclasses.replace(get_config("llama3-8b", reduced=True),
                                   tie_embeddings=True)
    return get_config(arch, reduced=True)


def _rules(cfg, parts):
    from repro_torch.launch import train
    return train.fsdp_rules(cfg, parts)


# ---- the ranks ------------------------------------------------------------

def _worker(rank, world, init, out, ckpt):
    import torch.distributed as dist

    torch.set_num_threads(1)
    init_gloo(rank, world, init)
    res = _collectives(rank, world)
    for arch in TRAINED:
        res.update({f"{arch}/{k}": v for k, v in _arch_steps(
            rank, world, pathlib.Path(ckpt) / arch, arch).items()})
    np.savez(f"{out}-{rank}.npz", **res)
    dist.destroy_process_group()


def _collectives(rank, world):
    """``reduce_scatter`` and ``all_reduce`` against ``LoopbackComm``'s
    rows for this process's ranks (asserted here)."""
    from repro_torch.comm.communicator import DistComm, LoopbackComm

    checked = 0
    for p_local in (1, 2):
        comm = DistComm(p_local, device="cpu")
        p = comm.p
        loop = LoopbackComm(p, device="cpu")
        mine = comm.local_rows
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            x = inputs(dtype, (p, p * 3, 2))
            for op in ("sum", "max"):
                for async_op in (False, True):
                    got = comm.reduce_scatter(x[mine].clone(), op,
                                              async_op=async_op).wait()
                    want = loop.reduce_scatter(x, op).wait()[mine]
                    assert got.shape == (p_local, 3, 2)
                    assert torch.equal(bits(got), bits(want)), (dtype, op)
                    got = comm.all_reduce(x[mine].clone(), op,
                                          async_op=async_op).wait()
                    want = loop.all_reduce(x, op).wait()[mine]
                    assert torch.equal(bits(got), bits(want)), (dtype, op)
                    checked += 2
    return {"collectives_checked": np.int64(checked)}


def _arch_steps(rank, world, ckpt, arch):
    from repro_torch.launch import train

    cfg = _config(arch)
    res = {}
    more = ["--ckpt-dir", str(ckpt), "--save-every", "2"] if world == 2 \
        else []
    tr = train.setup(cfg, train.parse_args(_argv(arch, "--mesh", str(world),
                                                 *more)))
    res["retries"] = np.int64(tr.step_fn.retries)
    res["bytes0"] = np.int64(_distinct_bytes(_state(tr)))
    for i, (_, t) in enumerate(_paths(tr.params)):
        res[f"part{i}"] = t.numpy().copy()
    for step in range(2):
        met = tr.step()
        tr.save(step + 1)
        res[f"loss{step}"] = met["loss"].numpy()
        res[f"gnorm{step}"] = met["grad_norm"].numpy()
        whole = _assembled(tr)
        if rank == 0:
            res.update({f"s{step}-{i}": a for i, a in enumerate(whole)})
    res["bytes1"] = np.int64(_distinct_bytes(_state(tr)))
    if tr.mgr is not None:
        tr.mgr.wait()
    del tr
    if world == 2:
        tr = train.setup(cfg, train.parse_args(_argv(
            arch, "--mesh", str(world), "--accum", "2")))
        for step in range(2):
            met = tr.step()
            res[f"acc-loss{step}"] = met["loss"].numpy()
            res[f"acc-gnorm{step}"] = met["grad_norm"].numpy()
            whole = _assembled(tr)
            if rank == 0:
                res.update({f"acc{step}-{i}": a for i, a in enumerate(whole)})
    else:
        # the two-rank checkpoint, spawned before, resumed at four ranks
        tr = train.setup(cfg, train.parse_args(_argv(
            arch, "--mesh", str(world), "--ckpt-dir", str(ckpt))))
        assert tr.start_step == 2
        for i, (_, t) in enumerate(_paths(_state(tr))):
            res[f"resumed{i}"] = t.numpy().copy()
        met = tr.step()
        res["resumed-loss"] = met["loss"].numpy()
        whole = _assembled(tr)
        if rank == 0:
            res.update({f"next-{i}": a for i, a in enumerate(whole)})
    return res


# ---- the reference's placement ---------------------------------------------

def _jax_worker(out):
    """The reference's ``--mesh 2x1`` placement of every arch's parameters
    and AdamW state: each leaf's whole value, and each device's shard
    (data and index), keyed by path."""
    import jax

    from repro.configs import registry as jregistry
    from repro.launch import train as jtrain
    from repro.models.transformer import Model as JModel
    from repro.models.transformer import RunCtx as JRunCtx
    from repro.optim.adamw import AdamW as JAdamW
    from repro.runtime import sharding as jsh

    import jax.numpy as jnp

    assert jax.device_count() == 2
    mesh = jtrain.make_mesh("2x1")
    res = {}
    for arch in ARCHS:
        cfg = jregistry.get_config(arch, reduced=True)
        rules = jsh.ShardingRules(mesh=mesh, fsdp_axes="data",
                                  ep_mode=cfg.is_moe
                                  and cfg.num_experts >= 1)
        params = JModel(cfg, JRunCtx(act_dtype=jnp.float32)).init_params(
            jax.random.PRNGKey(0))
        state = {"params": params, "opt": JAdamW(lr=1e-3).init(params)}
        shard = jsh.param_shardings(rules, jax.eval_shape(lambda: state))
        placed = jax.tree.map(jax.device_put, state, shard)
        for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
            key = f"{arch}{jax.tree_util.keystr(path)}"
            if key.startswith(f"{arch}['params']"):
                res[f"whole{key}"] = np.asarray(leaf)
            for s in leaf.addressable_shards:
                idx = [(sl.start or 0, leaf.shape[d] if sl.stop is None
                        else sl.stop) for d, sl in enumerate(s.index)]
                res[f"index{s.device.id}{key}"] = np.array(
                    idx, dtype=np.int64).reshape(-1, 2)
                if key.startswith(f"{arch}['params']"):
                    res[f"shard{s.device.id}{key}"] = np.asarray(s.data)
    np.savez(out, **res)


def _run_jax(out):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, __file__, "jax", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


# ---- this process --------------------------------------------------------

def _local(arch, accum, steps, ckpt=None):
    """``--mesh local --accum accum``: the parameters at init (before any
    step) and ``(loss, grad_norm, state)`` after each step."""
    from repro_torch.launch import train

    more = ["--ckpt-dir", str(ckpt)] if ckpt else []
    tr = train.setup(_config(arch),
                     train.parse_args(_argv(arch, "--accum", str(accum),
                                            *more)))
    init = {k: t.clone() for k, t in _paths(tr.params)}
    out = []
    for _ in range(steps):
        met = tr.step()
        out.append((float(met["loss"]), float(met["grad_norm"]),
                    [t.numpy().copy() for _, t in _paths(_state(tr))]))
    return tr, init, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawned ranks (two, then four, beside the JAX subprocess) and
    the local runs, once for this module."""
    tmp = tmp_path_factory.mktemp("fsdp")
    ckpt = tmp / "ckpt"

    def spawn(world):
        d = tmp / f"world-{world}"
        d.mkdir()
        run_ranks(__file__, world, d, d / "r", ckpt, timeout=400)
        return [dict(np.load(d / f"r-{r}.npz")) for r in range(world)]

    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_jax, tmp / "jax.npz")
        ranks = {2: pool.submit(spawn, 2)}
        local = {arch: {d: _local(arch, d, 3 if d == 2 else 2)[1:]
                        for d in (2, 4)} for arch in TRAINED}
        ranks[2] = ranks[2].result()
        ranks[4] = spawn(4)
        return types.SimpleNamespace(ranks=ranks, local=local, ckpt=ckpt,
                                     ref=ref.result())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", TRAINED)
def test_mesh_d_is_local_accum_d_bit_for_bit(arch, world, runs):
    ranks = runs.ranks[world]
    _, steps = runs.local[arch][world]
    for step in range(2):
        loss, gnorm, state = steps[step]
        for res in ranks:
            assert float(res[f"{arch}/loss{step}"]) == loss
            assert float(res[f"{arch}/gnorm{step}"]) == gnorm
        for i, want in enumerate(state):
            np.testing.assert_array_equal(ranks[0][f"{arch}/s{step}-{i}"],
                                          want)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_microbatches_a_rank_hold_at_step_tol(arch, runs):
    """``--mesh 2 --accum 2`` against ``--mesh local --accum 4``: each
    rank sums its two microbatches before the gather's backward sums the
    ranks, where the local step sums the four in one order."""
    ranks = runs.ranks[2]
    _, steps = runs.local[arch][4]
    for step in range(2):
        loss, gnorm, state = steps[step]
        for res in ranks:
            np.testing.assert_allclose(float(res[f"{arch}/acc-loss{step}"]),
                                       loss, **STEP_TOL)
            np.testing.assert_allclose(float(res[f"{arch}/acc-gnorm{step}"]),
                                       gnorm, **STEP_TOL)
        for i, want in enumerate(state):
            np.testing.assert_allclose(ranks[0][f"{arch}/acc{step}-{i}"],
                                       want, **STEP_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", TRAINED)
def test_a_rank_stores_its_parts(arch, world, runs):
    """Distinct storage = (split bytes of params, m, v) / D + the whole
    leaves' bytes, at init and after a step; the parts at init are the
    local init's cut by ``take_tree`` under ``fsdp_rules``."""
    from repro_torch.runtime import sharding

    init, _ = runs.local[arch][world]
    cfg = _config(arch)
    params = {}
    for keys, t in init.items():
        node = params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    dims = sharding.data_dims(_rules(cfg, world), params)
    split = whole = 0
    for (_, t), (_, d) in zip(_paths(params), _paths(dims)):
        if d is None:
            whole += 3 * t.nbytes          # the parameter, m and v
        else:
            split += 3 * t.nbytes
    assert split and split % world == 0
    want = split // world + whole + 4      # + AdamW's int32 step
    for rank, res in enumerate(runs.ranks[world]):
        assert int(res[f"{arch}/bytes0"]) == want
        assert int(res[f"{arch}/bytes1"]) == want
        parts = _paths(sharding.take_tree(params, dims, rank, world))
        for i, (_, t) in enumerate(parts):
            np.testing.assert_array_equal(res[f"{arch}/part{i}"], t.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_parts_are_the_reference_param_shardings(arch, runs):
    """``take_tree`` under ``fsdp_rules`` at two ranks cuts the reference's
    parameters into its ``addressable_shards`` bit for bit, and places
    every AdamW leaf where the reference's ``param_shardings`` does."""
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime import sharding

    cfg = get_config(arch, reduced=True)
    ref = runs.ref
    prefix = f"whole{arch}['params']"
    params, paths = {}, {}
    for key in ref:
        if key.startswith(prefix):
            keys = tuple(re.findall(r"\['([^']*)'\]", key[len(prefix):]))
            node = params
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = torch.from_numpy(ref[key])
            paths[keys] = key[len(prefix):]
    dims = sharding.data_dims(_rules(cfg, 2), params)
    state_dims = {"params": dims, "opt": {"m": dims, "v": dims,
                                          "step": None}}
    split = 0
    for rank in range(2):
        for keys, t in _paths(sharding.take_tree(params, dims, rank, 2)):
            np.testing.assert_array_equal(
                t.numpy(), ref[f"shard{rank}{arch}['params']{paths[keys]}"])
        for keys, d in _paths(state_dims):
            key = f"index{rank}{arch}" + sharding.path_str(keys)
            shape = ref[key][:, 1] - ref[key][:, 0]
            if d is None:
                want = [[0, n] for n in shape]
            else:
                want = [[0, n] for n in shape]
                want[d] = [rank * shape[d], (rank + 1) * shape[d]]
                split += 1
            np.testing.assert_array_equal(
                ref[key], np.array(want, dtype=np.int64).reshape(-1, 2))
    assert split


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_2_checkpoint_restores_at_mesh_4_and_local(arch, runs):
    import jax

    from repro.checkpoint import manager as jmanager
    from repro.configs import registry as jregistry
    from repro.models.transformer import Model as JModel
    from repro.models.transformer import RunCtx as JRunCtx
    from repro.optim.adamw import AdamW as JAdamW
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime import sharding

    import jax.numpy as jnp

    ckpt = runs.ckpt / arch
    written = [runs.ranks[2][0][f"{arch}/s1-{i}"]
               for i in range(len(runs.local[arch][2][1][0][2]))]
    # four ranks: each restored its parts of the written state, and its
    # step is --mesh local --accum 4's from the same checkpoint
    tr4, _, after = _local(arch, 4, 1, ckpt=ckpt)
    assert tr4.start_step == 2
    cfg = get_config(arch, reduced=True)
    dims = sharding.data_dims(_rules(cfg, 4), tr4.params)
    state_dims = {"params": dims, "opt": {"m": dims, "v": dims,
                                          "step": None}}
    for rank, res in enumerate(runs.ranks[4]):
        for i, ((_, d), a) in enumerate(zip(_paths(state_dims), written)):
            want = sharding.take(torch.from_numpy(a), d, rank, 4)
            np.testing.assert_array_equal(res[f"{arch}/resumed{i}"],
                                          want.numpy())
        assert float(res[f"{arch}/resumed-loss"]) == after[0][0]
    for i, want in enumerate(after[0][2]):
        np.testing.assert_array_equal(runs.ranks[4][0][f"{arch}/next-{i}"],
                                      want)
    # --mesh local: the restored state is the written one, and its next
    # step is the uninterrupted local run's third
    tr, _, after = _local(arch, 2, 1, ckpt=ckpt)
    assert tr.start_step == 2 and tr.comm is None
    loss, _, state = runs.local[arch][2][1][2]
    assert after[0][0] == loss
    for got, want in zip(after[0][2], state):
        np.testing.assert_array_equal(got, want)
    # the reference reads it
    jcfg = jregistry.get_config(arch, reduced=True)
    jp = jax.eval_shape(lambda: JModel(jcfg, JRunCtx(
        act_dtype=jnp.float32)).init_params(jax.random.PRNGKey(0)))
    target = {"params": jp, "opt": jax.eval_shape(
        lambda: JAdamW(lr=1e-3).init(jp))}
    tree, extra = jmanager.restore(str(ckpt), 2, target)
    assert extra["data"]["step"] == 2
    for got, want in zip(jax.tree.leaves(tree), written):
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_sharded_step_retries_nothing(arch, runs):
    """``setup`` builds a sharded step with no retry however many it is
    given; ``build_train_step`` refuses retries with split leaves; every
    rank's collectives were held against ``LoopbackComm``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model, RunCtx
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.steps import build_train_step

    for world in WORLDS:
        for res in runs.ranks[world]:
            assert int(res[f"{arch}/retries"]) == 0
            assert int(res["collectives_checked"]) == 48
    model = Model(get_config(arch, reduced=True),
                  RunCtx(act_dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="retries nothing"):
        build_train_step(model, AdamW(), retries=1,
                         dims={"embed": {"w": -1}})
    assert build_train_step(model, AdamW(), retries=1).retries == 1


@pytest.mark.parametrize("arch", ("llama3-8b", "falcon-mamba-7b"))
def test_cast_params_once_gathers_the_activation_dtype(arch, tmp_path):
    """``RunCtx.cast_params_once`` under the gather (a one-process gloo
    group, one part the whole leaf): the layers' gathers move bfloat16,
    the reduce-scatters sum float32 (the gather's backward casts each
    gradient back to its master's dtype first), and every master's
    gradient is the unsharded model's bit for bit."""
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model, RunCtx, tree_leaves
    from repro_torch.runtime import sharding
    from repro_torch.runtime.steps import build_grad_fn

    cfg = get_config(arch, reduced=True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, SEQ + 1)))
    batch = (tokens[:, :-1], tokens[:, 1:])
    ctx = RunCtx(act_dtype=torch.bfloat16, cast_params_once=True)
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        comm = DistComm(1, device="cpu")
        gather = sharding.make_gather(_rules(cfg, 1), comm)
        moved, summed = [], []
        all_gather, reduce_scatter = comm.all_gather, comm.reduce_scatter
        comm.all_gather = lambda x, **kw: (moved.append(x.dtype),
                                           all_gather(x, **kw))[1]
        comm.reduce_scatter = lambda x, **kw: (summed.append(x.dtype),
                                               reduce_scatter(x, **kw))[1]
        runs = []
        for g in (None, gather):
            model = Model(cfg, dataclasses.replace(ctx, gather=g),
                          device="cpu")
            params = model.init_params(torch.Generator().manual_seed(0),
                                       master=True)
            runs.append(build_grad_fn(model)(params, batch))
    finally:
        dist.destroy_process_group()
    assert torch.bfloat16 in moved and torch.float32 in moved
    assert set(summed) == {torch.float32}
    (want, want_loss), (got, got_loss) = runs
    assert torch.equal(got_loss, want_loss)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_worker(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4], sys.argv[5])
