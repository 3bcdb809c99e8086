"""The pod axis: ``launch.train`` and ``launch.serve`` over a ``pod x data x
model`` mesh (``--mesh multipod``'s layout at small sizes), with
``opt_fsdp_axes`` under the reference's dry-run train rules, over gloo
processes.

Reduced llama3-8b (dense), mixtral-8x22b (4 experts on a model axis of 2:
``ep_mode``) and falcon-mamba-7b (ssm), float32, batch 4 of 16 tokens.
The ranks spawn from this file (``python tests/test_torch_pod.py RANK
WORLD INIT OUT CKPT``), global rank ``r = (p·D + d)·M + m``: eight at
``Mesh((2, 2, 2), ("pod", "data", "model"))``, then four at ``(2, 2,
1)``.  A test reaches these meshes by passing the ``launch.mesh.Mesh`` as
``args.mesh``, where the CLI takes a spec.  The eight:

* hold their batch and pod groups' collectives against
  ``LoopbackComm``;
* train each arch two steps through ``launch.train.setup``, writing a
  checkpoint after the second; again under ``hierarchical_rules`` (the
  reference's dry-run train rules: ``opt_fsdp_axes=("pod", "data")``);
  then resume the checkpoint at ``--mesh 2x4`` and take a step;
* serve llama3-8b, mixtral-8x22b and falcon-mamba-7b at the reference's
  serve limit (no ZeRO) and llama3-8b and mixtral-8x22b under a limit of
  one byte (ZeRO-inference over ``("pod", "data")``): the prefill's and
  two decode steps' logits on each rank's lanes, and the engine's tokens
  for the dense and MoE archs.

The four train each arch two steps at ``(2, 2, 1)`` and resume the
checkpoint at ``--mesh 4``.  Beside them, a JAX subprocess on eight
forced host devices runs the reference's sharded step on the ``(2, 2,
2)`` mesh under ``launch.train``'s rules from the port's initial
parameters, and gives each device's shard index under the dry-run's
``make_rules(cfg, mesh, "train")``.  The checks:

* ``(2, 2, 1)`` is ``--mesh local --accum 4`` bit for bit (the HSDP
  reduction sums the batch group in its order, as the local accumulation
  folds its microbatches); ``(2, 2, 2)`` holds it at ``STEP_TOL`` and the
  reference's sharded step at ``check_sharded_model.py``'s tolerances;
  the parts at init are the reference's ``addressable_shards``;
* ``opt_fsdp_axes`` is the step without it bit for bit, and the AdamW
  state's blocks are the reference's ``make_rules`` shards;
* the ``(2, 2, 2)`` checkpoint restores at ``2x4``, ``4`` and ``local``;
* the served logits are ``--mesh local``'s within ``SERVE_TOL`` (relative
  L2) and the tokens are its tokens;
* without processes, each leaf's block at ``pod`` and ``multipod``, under
  the train rules, the dry-run's multipod train rules and the serve rule
  at ``SERVE_RESIDENCY_LIMIT``, is the reference's ``shard_shape`` for
  every config (a JAX subprocess on 512 forced host devices, the
  reference's production meshes, ``eval_shape`` only).
"""
import os
import pathlib
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCH_NAMES
from test_torch_dist_comm import ROOT, bits, init_gloo, inputs, run_ranks
from test_torch_fsdp import _assembled, _distinct_bytes, _paths, _state
from test_torch_tp import _local, _resume, _tree

ARCHS = ("llama3-8b", "mixtral-8x22b", "falcon-mamba-7b")
SERVED = ("llama3-8b", "mixtral-8x22b")      # the engine's tokens too
ZERO = ("llama3-8b", "mixtral-8x22b")
POD, POD1 = (2, 2, 2), (2, 2, 1)
AXES = ("pod", "data", "model")
BATCH, SEQ = 4, 16
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
REF_LOSS_TOL = dict(rtol=2e-3, atol=2e-3)    # check_sharded_model.py's
REF_LEAF_TOL = dict(rtol=5e-3, atol=5e-3)
SERVE_TOL = 1e-4                             # relative L2, float32
LIMIT = 12e9                                 # the reference's serve limit
B, PROMPT, CACHE, STEPS = 4, 4, 16, 2
ENGINE_ARGV = ["--reduced", "--device", "cpu", "--requests", "4",
               "--slots", "4", "--prompt-len", "8", "--gen", "4"]


def _config(arch):
    from repro_torch.configs.registry import get_config
    return get_config(arch, reduced=True)


def _mesh(shape):
    from repro_torch.launch.mesh import Mesh
    return Mesh(shape, AXES)


def _args(arch, mesh=None, *more):
    """``launch.train``'s arguments; ``mesh`` (a ``Mesh``) as ``--mesh``."""
    from repro_torch.launch import train
    args = train.parse_args(["--arch", arch, "--reduced", "--batch",
                             str(BATCH), "--seq", str(SEQ), "--device",
                             "cpu", "--steps", "3", *more])
    if mesh is not None:
        args.mesh = mesh
    return args


# ---- the ranks ------------------------------------------------------------

def _worker(rank, world, init, out, ckpt):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_PLAN_CACHE"] = "0"
    init_gloo(rank, world, init)
    res = {}
    if world == 8:
        res["collectives_checked"] = np.int64(_collectives(rank))
        for arch in ARCHS:
            res.update({f"{arch}/{k}": v for k, v in _pod_steps(
                rank, pathlib.Path(ckpt) / arch, arch).items()})
        res.update(_serving(rank))
    else:
        for arch in ARCHS:
            res.update({f"{arch}/{k}": v for k, v in _pod1_steps(
                rank, pathlib.Path(ckpt) / arch, arch).items()})
    np.savez(f"{out}-{rank}.npz", **res)
    dist.destroy_process_group()


def _collectives(rank):
    """The grid's place and its batch and pod groups' collectives against
    ``LoopbackComm``'s row of the rank."""
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.launch import mesh as mesh_mod

    g = mesh_mod.grid(_mesh(POD), "cpu")
    pp, dd, mm = POD
    pd, m = divmod(rank, mm)
    assert (g.p, g.d, g.m) == (pd // dd, pd % dd, m)
    assert (g.batch.p, g.batch.rank) == (pp * dd, pd)
    assert (g.pod.p, g.pod.rank) == (pp, pd // dd)
    assert (g.data.p, g.data.rank, g.model.p, g.model.rank) == (dd, g.d,
                                                                mm, m)
    checked = 0
    for comm in (g.batch, g.pod):
        p, r = comm.p, comm.rank
        loop = LoopbackComm(p, device="cpu")
        x = inputs(torch.float32, (p, p * 3, 2))
        got = comm.all_gather(x[r:r + 1].clone()).wait()
        assert torch.equal(bits(got[0]), bits(loop.all_gather(x).wait()[r]))
        got = comm.reduce_scatter(x[r:r + 1].clone()).wait()
        assert torch.equal(bits(got[0]),
                           bits(loop.reduce_scatter(x).wait()[r]))
        got = comm.all_reduce(x[r:r + 1].clone()).wait()
        assert torch.equal(bits(got[0]), bits(loop.all_reduce(x).wait()[r]))
        checked += 3
    return checked


def _steps(tr, res, prefix, rank, steps=2, save=False):
    """``steps`` steps of trainer ``tr``: the losses, gradient norms and
    (rank 0) the assembled state after each."""
    for step in range(steps):
        met = tr.step()
        if save:
            tr.save(step + 1)
        res[f"{prefix}loss{step}"] = met["loss"].numpy()
        res[f"{prefix}gnorm{step}"] = met["grad_norm"].numpy()
        whole = _assembled(tr)
        if rank == 0:
            res.update({f"{prefix}s{step}-{i}": a
                        for i, a in enumerate(whole)})


def _pod_steps(rank, ckpt, arch):
    from repro_torch.launch import train

    cfg, mesh, res = _config(arch), _mesh(POD), {}
    tr = train.setup(cfg, _args(arch, mesh, "--ckpt-dir", str(ckpt),
                                "--save-every", "2"))
    res["bytes0"] = np.int64(_distinct_bytes(_state(tr)))
    for i, (_, t) in enumerate(_paths(tr.params)):
        res[f"part{i}"] = t.numpy().copy()
    _steps(tr, res, "", rank, save=True)
    tr.mgr.wait()
    del tr
    # the reference's dry-run train rules: the AdamW state over pod x data
    zero = train.hierarchical_rules(cfg, mesh)
    opt_ckpt = str(ckpt) + "-opt"
    tr = train.setup(cfg, _args(arch, mesh, "--ckpt-dir", opt_ckpt,
                                "--save-every", "2"), rules=zero)
    gather = tr.model.ctx.gather
    assert gather.odims is not None
    res["opt-bytes0"] = np.int64(_distinct_bytes(_state(tr)))
    res["opt-sent"], res["opt-due"] = _count_exchange(tr, gather)
    _steps(tr, res, "opt-", rank, save=True)
    tr.mgr.wait()
    for i, (_, t) in enumerate(_paths(tr.opt_state)):
        res[f"opt-block{i}"] = t.numpy().copy()
    del tr
    # the checkpoint written without opt_fsdp_axes, restored with them
    tr = train.setup(cfg, _args(arch, mesh, "--ckpt-dir", str(ckpt)),
                     rules=zero)
    assert tr.start_step == 2
    for i, (_, t) in enumerate(_paths(tr.opt_state)):
        res[f"opt-resumed{i}"] = t.numpy().copy()
    del tr
    # the checkpoint at 2x4, these eight processes
    tr = train.setup(cfg, _args(arch, None, "--mesh", "2x4", "--ckpt-dir",
                                str(ckpt)))
    assert tr.start_step == 2
    for i, (_, t) in enumerate(_paths(_state(tr))):
        res[f"at2x4-resumed{i}"] = t.numpy().copy()
    _steps(tr, res, "at2x4-", rank, steps=1)
    return res


def _count_exchange(tr, gather):
    """Counts, from here on, the elements that the update's block exchange
    sends (``DistComm.sendrecv`` over the batch group); and returns, beside
    that count's cell, the elements of the blocks that leave a parameter's
    part each step: a parameter's and a gradient's (``to_wide``) and the
    updated parameter's (``from_wide``)."""
    from repro_torch.runtime import sharding

    moved, send = np.zeros((), np.int64), gather.wide.sendrecv

    def counted(x, dst, src):
        moved[...] += x.numel()
        return send(x, dst, src)

    gather.wide.sendrecv = counted
    pods = gather.wide.p // gather.comm.p
    blocks = sum(3 * t.numel() // pods for keys, t in _paths(tr.params)
                 if sharding._at(gather.odims, keys) is not None
                 and not gather.same_block(sharding._at(gather.dims, keys),
                                           sharding._at(gather.odims, keys)))
    return moved, np.int64(blocks)


def _pod1_steps(rank, ckpt, arch):
    from repro_torch.launch import train

    cfg, res = _config(arch), {}
    tr = train.setup(cfg, _args(arch, _mesh(POD1)))
    assert tr.comm.p == 4 and tr.model.ctx.model.size == 1
    _steps(tr, res, "", rank)
    del tr
    tr = train.setup(cfg, _args(arch, None, "--mesh", "4", "--ckpt-dir",
                                str(ckpt)))
    assert tr.start_step == 2
    for i, (_, t) in enumerate(_paths(_state(tr))):
        res[f"at4-resumed{i}"] = t.numpy().copy()
    _steps(tr, res, "at4-", rank, steps=1)
    return res


def _inputs(cfg):
    """The prompt (B, PROMPT) and the decode steps' tokens (STEPS, B, 1)
    from the seed."""
    rng = np.random.default_rng(1)
    return (rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32))


def _run(model, params, cfg, lanes):
    """Prefill then ``STEPS`` decode steps on ``lanes``: their logits."""
    from repro_torch.launch.serve import prefill_into_cache

    prompt, steps = _inputs(cfg)
    cache = model.init_cache(B, CACHE, dtype=torch.float32)
    out = []
    with torch.no_grad():
        tokens = torch.from_numpy(prompt[lanes])
        if cfg.family in ("dense", "moe"):
            logits, cache = model.prefill(params, cache, tokens)
        else:
            cache, logits = prefill_into_cache(model, params, cache, tokens)
        out.append(logits.numpy().copy())
        for step in steps:
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(step[lanes]))
            out.append(logits.numpy().copy())
    return out


def _serving(rank):
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model, RunCtx, tree_leaves

    mesh, res = _mesh(POD), {}
    grid = mesh_mod.grid(mesh, "cpu")
    for arch in ARCHS:
        for limit, tag in ((LIMIT, ""), (1.0, "+zero")):
            if tag and arch not in ZERO:
                continue
            cfg = _config(arch)
            ctx = serve.serving_ctx(cfg, RunCtx(act_dtype=torch.float32),
                                    mesh, grid, limit=limit)
            gather = ctx.gather
            pre = f"serve/{arch}{tag}"
            res[f"{pre}/fsdp"] = np.array(
                [str(gather.rules.fsdp_axes)])
            res[f"{pre}/lanes"] = np.array([gather.lanes(B).start,
                                            gather.lanes(B).stop])
            model = Model(cfg, ctx, device="cpu")
            params = model.init_params(torch.Generator().manual_seed(0))
            res[f"{pre}/bytes"] = np.int64(sum(
                t.numel() * t.element_size() for t in tree_leaves(params)))
            for i, o in enumerate(_run(model, params, cfg,
                                       gather.lanes(B))):
                res[f"{pre}/logits{i}"] = o
            if arch in SERVED:
                args = serve.parse_args(["--arch", arch] + ENGINE_ARGV)
                args.mesh = mesh
                serve.sharding.serve_limit, keep = (
                    lambda device=None: limit), serve.sharding.serve_limit
                try:
                    report = serve.make_engine(cfg, RunCtx(
                        act_dtype=torch.float32), args, grid=grid).run()
                finally:
                    serve.sharding.serve_limit = keep
                res[f"{pre}/tokens"] = np.array(
                    [report.outputs[f"req{i}"] for i in range(4)])
    return res


# ---- the reference --------------------------------------------------------

def _jax_worker(out):
    """On eight devices, the ``(2, 2, 2)`` mesh: each device's shard of
    the port's initial parameters and the reference's two sharded steps
    under ``launch.train``'s rules; each device's index of the AdamW
    state under the dry-run's ``make_rules(cfg, mesh, "train")``."""
    import jax
    import jax.numpy as jnp

    assert jax.device_count() == 8        # before dryrun sets its flags
    from repro import compat
    from repro.configs import registry as jregistry
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.launch.dryrun import make_rules
    from repro.models.transformer import Model as JModel
    from repro.models.transformer import RunCtx as JRunCtx
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.adamw import cosine_schedule as jcosine
    from repro.runtime import sharding as jsh
    from repro.runtime import steps as jsteps
    from repro_torch.models.transformer import Model, RunCtx, tree_map

    mesh = compat.make_mesh(POD, AXES, axis_types=compat.auto_axis_types(3))
    args = _args("llama3-8b")
    res = {}
    for arch in ARCHS:
        cfg = _config(arch)
        jcfg = jregistry.get_config(cfg.name, reduced=True)
        rules = jsh.ShardingRules(mesh=mesh, fsdp_axes="data",
                                  ep_mode=cfg.num_experts >= POD[2]
                                  if cfg.is_moe else False)
        params = tree_map(lambda t: jnp.asarray(t.numpy()), Model(
            cfg, RunCtx(act_dtype=torch.float32), device="cpu").init_params(
                torch.Generator().manual_seed(args.seed), master=True))
        opt = JAdamW(lr=jcosine(args.lr, args.warmup, args.steps),
                     weight_decay=0.01)
        ostate = opt.init(params)
        pshard = jsh.param_shardings(rules, jax.eval_shape(lambda: params))
        oshard = jsh.param_shardings(rules, jax.eval_shape(lambda: ostate))
        p = jax.tree.map(jax.device_put, params, pshard)
        o = jax.tree.map(jax.device_put, ostate, oshard)
        for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            key = f"{arch}{jax.tree_util.keystr(path)}"
            for s in leaf.addressable_shards:
                res[f"shard{s.device.id}{key}"] = np.asarray(s.data)
        # the dry-run's rules: each device's index of m and v
        zrules = make_rules(jcfg, mesh, "train")
        assert zrules.opt_fsdp_axes == ("pod", "data")
        zshard = jsh.param_shardings(zrules, jax.eval_shape(lambda: ostate))
        for path, sh in jax.tree_util.tree_flatten_with_path(zshard)[0]:
            key = f"{arch}{jax.tree_util.keystr(path)}"
            leaf = ostate
            for k in path:
                leaf = leaf[k.key]
            for dev, idx in sh.devices_indices_map(leaf.shape).items():
                res[f"oindex{dev.id}{key}"] = np.array(
                    [(sl.start or 0, leaf.shape[i] if sl.stop is None
                      else sl.stop) for i, sl in enumerate(idx)],
                    dtype=np.int64).reshape(-1, 2)
        ctx = JRunCtx(moe_groups=max(1, min(POD[0] * POD[1], BATCH)),
                      remat="full", constrain=jsh.make_constrain(rules),
                      act_dtype=jnp.float32, vocab_shards=POD[2])
        step = jax.jit(jsteps.build_train_step(JModel(jcfg, ctx), opt,
                                               grad_shardings=pshard))
        data = JSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=args.seed)
        for i in range(2):
            tokens, labels = data.batch_at(i)
            bshard = jsh.batch_sharding(rules, tokens.shape)
            p, o, met = step(p, o, (jax.device_put(tokens, bshard),
                                    jax.device_put(labels, bshard)), None)
            res[f"{arch}/loss{i}"] = np.asarray(met["loss"])
            res[f"{arch}/gnorm{i}"] = np.asarray(met["grad_norm"])
            for j, leaf in enumerate(jax.tree.leaves({"params": p,
                                                      "opt": o})):
                res[f"{arch}/s{i}-{j}"] = np.asarray(leaf)
    np.savez(out, **res)


def _jax_shapes(out):
    """On 512 devices, the reference's production meshes: every config's
    parameter and AdamW-state shard shapes under ``launch.train``'s rules
    (``pod``, ``multipod``), the dry-run's multipod train rules and its
    serve rule (``eval_shape`` only, nothing materialised)."""
    import jax
    from repro.configs import registry as jregistry
    from repro.launch.dryrun import make_rules
    from repro.launch.mesh import make_production_mesh
    from repro.models.transformer import Model as JModel
    from repro.models.transformer import RunCtx as JRunCtx
    from repro.optim.adamw import AdamW as JAdamW
    from repro.runtime import sharding as jsh

    assert jax.device_count() == 512
    res = {}
    for name in jregistry.ARCH_NAMES:
        cfg = jregistry.get_config(name)
        params = jax.eval_shape(JModel(cfg, JRunCtx()).init_params,
                                jax.random.PRNGKey(0))
        opt = jax.eval_shape(JAdamW(lr=1e-3, mixed_precision=True).init,
                             params)
        for spec, multi in (("pod", False), ("multipod", True)):
            mesh = make_production_mesh(multi_pod=multi)
            train = jsh.ShardingRules(
                mesh=mesh, fsdp_axes="data",
                ep_mode=cfg.is_moe
                and cfg.num_experts >= mesh.shape["model"])
            rule_sets = {"train": train,
                         "serve": make_rules(cfg, mesh, "decode")}
            if multi:
                rule_sets["zero"] = make_rules(cfg, mesh, "train")
            for what, rules in rule_sets.items():
                res[f"{name}/{spec}/{what}/fsdp"] = np.array(
                    [str(rules.fsdp_axes), str(rules.opt_fsdp_axes),
                     str(rules.ep_mode)])
                for tree_name, tree in (("params", params), ("opt", opt)):
                    if what == "serve" and tree_name == "opt":
                        continue
                    shard = jsh.param_shardings(rules, tree)
                    for path, sh in jax.tree_util.tree_flatten_with_path(
                            shard)[0]:
                        leaf = tree
                        for k in path:
                            leaf = leaf[k.key]
                        key = (f"{name}/{spec}/{what}/{tree_name}"
                               f"{jax.tree_util.keystr(path)}")
                        res[key] = np.array(sh.shard_shape(leaf.shape),
                                            dtype=np.int64)
    np.savez(out, **res)


def _run_jax(what, devices, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run([sys.executable, __file__, what, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


# ---- this process ---------------------------------------------------------

def _local_serve(arch):
    """``--mesh local``'s logits of the prefill and each step, and the
    engine's tokens."""
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model, RunCtx

    cfg = _config(arch)
    model = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    out = {"logits": _run(model, params, cfg, slice(None))}
    if arch in SERVED:
        report = serve.make_engine(cfg, RunCtx(act_dtype=torch.float32),
                                   serve.parse_args(["--arch", arch]
                                                    + ENGINE_ARGV)).run()
        out["tokens"] = np.array([report.outputs[f"req{i}"]
                                  for i in range(4)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawned ranks (eight at ``(2, 2, 2)``, then four at ``(2, 2,
    1)``, beside the JAX subprocess) and the local runs, once for this
    module."""
    tmp = tmp_path_factory.mktemp("pod")
    ckpt = tmp / "ckpt"

    def spawn(world):
        d = tmp / f"world-{world}"
        d.mkdir()
        run_ranks(__file__, world, d, d / "r", ckpt, timeout=500)
        return [dict(np.load(d / f"r-{r}.npz")) for r in range(world)]

    def spawn_both():
        return {POD: spawn(8), POD1: spawn(4)}

    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_jax, "jax", 8, tmp / "jax.npz")
        ranks = pool.submit(spawn_both)
        local = {arch: _local(arch, 4, 2)[1:] for arch in ARCHS}
        served = {arch: _local_serve(arch) for arch in ARCHS}
        ranks = ranks.result()
        resumed = {arch: {accum: _resume(arch, accum, ckpt / arch)
                          for accum in (2, 4)} for arch in ARCHS}
        return types.SimpleNamespace(ranks=ranks, local=local, served=served,
                                     resumed=resumed, ckpt=ckpt,
                                     ref=ref.result())


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    return _run_jax("jax-shapes", 512,
                    tmp_path_factory.mktemp("pod_shapes") / "shapes.npz")


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2x1_is_local_accum_4_bit_for_bit(arch, runs):
    """``P x D x 1``: the batch over pod x data, the split leaves'
    gradients summed over the batch group in its order by the HSDP
    reduction, the whole ones averaged over it: ``--mesh local --accum
    P·D``'s two steps bit for bit (state, loss, ``grad_norm``)."""
    ranks = runs.ranks[POD1]
    _, steps = runs.local[arch]
    for step, (loss, gnorm, state) in enumerate(steps):
        for res in ranks:
            assert float(res[f"{arch}/loss{step}"]) == loss
            assert float(res[f"{arch}/gnorm{step}"]) == gnorm
        for i, want in enumerate(state):
            np.testing.assert_array_equal(ranks[0][f"{arch}/s{step}-{i}"],
                                          want)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2x2_is_local_accum_4(arch, runs):
    """``(2, 2, 2)``: every rank the same loss bit for bit, and the loss,
    ``grad_norm`` and state ``--mesh local --accum 4``'s at ``STEP_TOL``
    (the model axis's row-split products add partial sums)."""
    ranks = runs.ranks[POD]
    _, steps = runs.local[arch]
    for step, (loss, gnorm, state) in enumerate(steps):
        for res in ranks:
            for k in ("loss", "gnorm"):
                assert float(res[f"{arch}/{k}{step}"]) == \
                    float(ranks[0][f"{arch}/{k}{step}"])
        np.testing.assert_allclose(float(ranks[0][f"{arch}/loss{step}"]),
                                   loss, **STEP_TOL)
        np.testing.assert_allclose(float(ranks[0][f"{arch}/gnorm{step}"]),
                                   gnorm, **STEP_TOL)
        for i, want in enumerate(state):
            np.testing.assert_allclose(ranks[0][f"{arch}/s{step}-{i}"],
                                       want, **STEP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2x2_is_the_reference_sharded_step(arch, runs):
    """The port's step against the reference's sharded step on the ``(2,
    2, 2)`` mesh under ``launch.train``'s rules (the batch over ``("pod",
    "data")``, ``moe_groups = min(P·D, B)``) from the same parameters:
    every leaf of the parameters and the AdamW state."""
    ref, res = runs.ref, runs.ranks[POD][0]
    n = len(runs.local[arch][1][0][2])
    for step in range(2):
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(float(res[f"{arch}/{k}{step}"]),
                                       float(ref[f"{arch}/{k}{step}"]),
                                       **REF_LOSS_TOL)
        for i in range(n):
            np.testing.assert_allclose(res[f"{arch}/s{step}-{i}"],
                                       ref[f"{arch}/s{step}-{i}"],
                                       **REF_LEAF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2x2_parts_are_the_reference_addressable_shards(arch, runs):
    """Rank ``r = (p·D + d)·M + m``'s part of every parameter at init is
    the reference's shard on device ``r`` bit for bit (replicated over
    the pods), and a rank stores ``1/(D·M)`` of a leaf split over both
    axes."""
    from repro_torch.runtime import sharding
    from repro_torch.launch import train

    init, _ = runs.local[arch]
    tree = _tree(init)
    for rank, res in enumerate(runs.ranks[POD]):
        for i, (keys, _) in enumerate(_paths(tree)):
            key = f"{arch}{sharding.path_str(keys)}"
            np.testing.assert_array_equal(res[f"{arch}/part{i}"],
                                          runs.ref[f"shard{rank}{key}"])
    rules = train.mesh_rules(_config(arch), _mesh(POD))
    want = 4
    for (_, t), (_, dd), (_, md) in zip(
            _paths(tree), _paths(sharding.data_dims(rules, tree)),
            _paths(sharding.model_dims(rules, tree))):
        want += 3 * t.nbytes // ((POD[1] if dd is not None else 1)
                                 * (POD[2] if md is not None else 1))
    for res in runs.ranks[POD]:
        assert int(res[f"{arch}/bytes0"]) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_fsdp_axes_is_the_step_without_it_bit_for_bit(arch, runs):
    """Under ``hierarchical_rules`` (``opt_fsdp_axes=("pod", "data")``)
    the AdamW update runs on the state's blocks over pod x data: the loss,
    ``grad_norm`` and the assembled state are the step without it, bit
    for bit, and a rank holds fewer bytes."""
    for res in runs.ranks[POD]:
        for step in range(2):
            for k in ("loss", "gnorm"):
                assert float(res[f"{arch}/opt-{k}{step}"]) == \
                    float(res[f"{arch}/{k}{step}"])
        assert int(res[f"{arch}/opt-bytes0"]) < int(res[f"{arch}/bytes0"])
    res = runs.ranks[POD][0]
    for step in range(2):
        keys = [k for k in res if k.startswith(f"{arch}/s{step}-")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                res[k.replace(f"{arch}/s", f"{arch}/opt-s")], res[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_fsdp_update_moves_only_blocks(arch, runs):
    """The update under ``opt_fsdp_axes`` exchanges blocks, not whole
    leaves: over its two steps each rank sends, for every parameter whose
    block over pod x data lies outside its part, that block of the
    parameter and of its gradient and the updated block back, and nothing
    more."""
    for res in runs.ranks[POD]:
        blocks = int(res[f"{arch}/opt-due"])
        assert blocks > 0
        assert int(res[f"{arch}/opt-sent"]) == 2 * blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_blocks_are_the_reference_make_rules_shards(arch, runs):
    """Each rank's block of ``m`` and ``v`` after two steps under
    ``hierarchical_rules`` is the assembled state cut at the index of the
    reference's ``make_rules(cfg, mesh, "train")`` shard on its device:
    block ``p·D + d`` of the ``P·D`` over the dim the data axis splits,
    which is not inside the parameter's part ``d``."""
    from repro_torch.runtime import sharding

    whole = runs.ranks[POD][0]
    init, _ = runs.local[arch]
    opt = {"m": _tree(init), "v": _tree(init),
           "step": torch.zeros((), dtype=torch.int32)}
    ostate = list(_paths(opt))
    # the assembled state's leaves in _paths' order: opt, then params
    offset = 0
    moved = 0
    for rank, res in enumerate(runs.ranks[POD]):
        for i, (keys, _) in enumerate(ostate):
            key = f"{arch}{sharding.path_str(keys)}"
            idx = runs.ref[f"oindex{rank}{key}"]
            full = whole[f"{arch}/opt-s1-{offset + i}"]
            want = full[tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_array_equal(res[f"{arch}/opt-block{i}"],
                                          want)
            if keys[0] in ("m", "v") and idx.size and \
                    (idx[:, 1] - idx[:, 0] != np.array(full.shape)).any():
                moved += 1
    assert moved


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_fsdp_checkpoints_assemble_and_restore_the_blocks(arch, runs):
    """A checkpoint written under ``opt_fsdp_axes`` (every rank assembles
    its state blocks over pod x data, rank 0 writes) holds the arrays of
    the one written without them, bit for bit; and the one written
    without them, restored under ``opt_fsdp_axes``, gives each rank its
    state blocks, those the step left there bit for bit."""
    ckpt = runs.ckpt / arch
    with np.load(ckpt / "step_2" / "arrays.npz") as plain, \
            np.load(pathlib.Path(f"{ckpt}-opt") / "step_2" /
                    "arrays.npz") as zero:
        assert sorted(plain) == sorted(zero)
        for k in plain:
            np.testing.assert_array_equal(zero[k], plain[k], err_msg=k)
    for res in runs.ranks[POD]:
        keys = [k for k in res if k.startswith(f"{arch}/opt-block")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                res[k.replace("opt-block", "opt-resumed")], res[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2x2_checkpoint_restores_at_2x4_4_and_local(arch, runs):
    """The ``(2, 2, 2)`` checkpoint (rank 0 of the mesh writes what every
    rank assembles) restores each rank's parts at ``2x4`` (the eight) and
    ``4`` (the four, data-parallel), and at ``--mesh local``; the next
    step at ``4`` is ``--mesh local --accum 4``'s bit for bit, at ``2x4``
    ``--accum 2``'s within ``STEP_TOL``."""
    from repro_torch.launch import train
    from repro_torch.runtime import sharding

    written = [runs.ranks[POD][0][f"{arch}/s1-{i}"]
               for i in range(len(runs.local[arch][1][0][2]))]
    cfg = _config(arch)
    tree = _tree(runs.local[arch][0])
    for spec, ranks, (d, m) in (("at4", runs.ranks[POD1], (4, 1)),
                                ("at2x4", runs.ranks[POD], (2, 4))):
        rules = train.fsdp_rules(cfg, d, m)
        dd = sharding.data_dims(rules, tree)
        md = sharding.model_dims(rules, tree)

        def state(t):
            return {"opt": {"m": t, "step": None, "v": t}, "params": t}

        dims, mdims = list(_paths(state(dd))), list(_paths(state(md)))
        for rank, res in enumerate(ranks):
            for i, a in enumerate(written):
                t = sharding.take(torch.from_numpy(a), mdims[i][1], rank % m,
                                  m)
                t = sharding.take(t, dims[i][1], rank // m, d)
                np.testing.assert_array_equal(
                    res[f"{arch}/{spec}-resumed{i}"], t.numpy())
        start, _, _, after = runs.resumed[arch][4 if spec == "at4" else 2]
        assert start == 2
        for res in ranks:
            if spec == "at4":
                assert float(res[f"{arch}/{spec}-loss0"]) == after[0]
            else:
                np.testing.assert_allclose(float(res[f"{arch}/{spec}-loss0"]),
                                           after[0], **STEP_TOL)
        for i, want in enumerate(after[2]):
            got = ranks[0][f"{arch}/{spec}-s0-{i}"]
            if spec == "at4":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **STEP_TOL)
    # --mesh local restored the written state itself
    for accum in (2, 4):
        start, comm, restored, _ = runs.resumed[arch][accum]
        assert start == 2 and comm is None
        for got, want in zip(restored, written):
            np.testing.assert_array_equal(got, want)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2x2_serving_is_local(arch, runs):
    """Each rank's lanes (its block of pod x data: ``p·D + d``) of the
    prefill's and each decode step's logits within ``SERVE_TOL`` of
    ``--mesh local``'s, the ranks of a model group the same bits; the
    engine over the ``(2, 2, 2)`` mesh emits the local tokens on every
    rank (the next tokens all-gathered over the batch group)."""
    want = runs.served[arch]
    per = B // (POD[0] * POD[1])
    for rank, res in enumerate(runs.ranks[POD]):
        pre = f"serve/{arch}"
        b = rank // POD[2]
        lanes = slice(b * per, (b + 1) * per)
        assert res[f"{pre}/lanes"].tolist() == [lanes.start, lanes.stop]
        assert res[f"{pre}/fsdp"].tolist() == ["None"]
        for i in range(STEPS + 1):
            got = res[f"{pre}/logits{i}"]
            assert _rel(got, want["logits"][i][lanes]) <= SERVE_TOL, (rank,
                                                                      i)
            peer = runs.ranks[POD][rank - rank % POD[2]][f"{pre}/logits{i}"]
            np.testing.assert_array_equal(got, peer)
        if arch in SERVED:
            np.testing.assert_array_equal(res[f"{pre}/tokens"],
                                          want["tokens"])


@pytest.mark.parametrize("arch", ZERO)
def test_2x2x2_zero_inference_over_pod_and_data(arch, runs):
    """A limit of one byte spreads the weights over ``("pod", "data")``
    too (the serve rule's ZeRO-inference on a pod axis: the batch group
    gathers a layer whole): each rank holds under 0.4 of the bytes, the
    logits are those of the model axis alone bit for bit, and the engine
    the local tokens."""
    for res in runs.ranks[POD]:
        pre = f"serve/{arch}"
        assert res[f"{pre}+zero/fsdp"].tolist() == [str(("pod", "data"))]
        assert res[f"{pre}+zero/bytes"] < 0.4 * res[f"{pre}/bytes"]
        for i in range(STEPS + 1):
            np.testing.assert_array_equal(res[f"{pre}+zero/logits{i}"],
                                          res[f"{pre}/logits{i}"])
        np.testing.assert_array_equal(res[f"{pre}+zero/tokens"],
                                      runs.served[arch]["tokens"])


def test_pod_groups_and_collectives(runs):
    """Every rank of ``(2, 2, 2)`` sits at ``(p, d, m)`` with ``r = (p·D
    + d)·M + m``, and its batch and pod groups' collectives are
    ``LoopbackComm``'s (asserted in the rank)."""
    for res in runs.ranks[POD]:
        assert int(res["collectives_checked"]) == 6


def _port_blocks(cfg, rules, opt: bool):
    """Each parameter's (and with ``opt`` each AdamW leaf's) block shape
    that rank 0 keeps under ``rules`` (``Gather.keep`` on meta tensors),
    keyed by the reference's path."""
    from repro_torch.runtime import sharding

    shape = rules.mesh.shape

    class One:                      # rank 0 of a group of p
        def __init__(self, p):
            self.p, self.p_local, self.rank_offset, self.rank = p, 1, 0, 0

    class Axis:
        def __init__(self, m):
            self.size, self.rank = m, 0

    pods = "pod" in shape
    fs = rules.fsdp_axes if rules.fsdp_axes is not None else rules.dp_axes
    batch = One(shape["data"] * shape.get("pod", 1))
    comm = batch if "pod" in sharding.axis_names(fs) else One(shape["data"])
    gather = sharding.Gather(rules, comm, Axis(shape["model"]), batch=batch,
                             pod=One(shape["pod"]) if pods else None)
    out = {}
    for keys, t in _paths(sharding.fake_params(cfg)):
        part = gather.keep(keys, torch.empty(t.shape, device="meta"))
        out[f"params{sharding.path_str(keys)}"] = tuple(part.shape)
        if not opt:
            continue
        odims = gather.dims if gather.odims is None else gather.odims
        wide = gather.odims is not None
        for k in ("master", "m", "v"):
            od = sharding._at(odims, keys)
            md = sharding._at(gather.mdims, keys)
            block = gather.part(torch.empty(t.shape, device="meta"), od,
                                md, wide=wide)
            out[f"opt['{k}']{sharding.path_str(keys)}"] = tuple(block.shape)
    return out


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_production_blocks_are_the_reference_shard_shapes(name, shapes):
    """At ``pod`` and ``multipod``, at the published widths: the port's
    rules (``launch.train.mesh_rules``, ``hierarchical_rules``,
    ``sharding.serve_rules`` at the reference's limit) pick the
    reference's FSDP axes, ``opt_fsdp_axes`` and ``ep_mode``, and the
    block rank 0 keeps of every parameter and AdamW leaf is the
    reference's ``shard_shape``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.runtime import sharding

    cfg = get_config(name)
    for spec in ("pod", "multipod"):
        mesh = mesh_mod.make_mesh(spec)
        rule_sets = {"train": train.mesh_rules(cfg, mesh),
                     "serve": sharding.serve_rules(cfg, mesh, limit=LIMIT)}
        if spec == "multipod":
            rule_sets["zero"] = train.hierarchical_rules(cfg, mesh)
        for what, rules in rule_sets.items():
            pre = f"{name}/{spec}/{what}"
            assert shapes[f"{pre}/fsdp"].tolist() == [
                str(rules.fsdp_axes), str(rules.opt_fsdp_axes),
                str(rules.ep_mode)], pre
            got = _port_blocks(cfg, rules, what != "serve")
            want = {k[len(pre) + 1:]: tuple(v.tolist())
                    for k, v in shapes.items()
                    if k.startswith(f"{pre}/") and not k.endswith("/fsdp")
                    and "['step']" not in k}
            assert got == want, pre


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_worker(sys.argv[2])
    elif sys.argv[1] == "jax-shapes":
        _jax_shapes(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4], sys.argv[5])
