"""``launch.train --mesh DxM``: tensor and expert parallelism over gloo
processes.

Reduced llama3-8b (dense GQA), arctic-480b (expert-parallel MoE with a
dense residual FFN), falcon-mamba-7b (ssm), hymba-1.5b (hybrid),
whisper-tiny (encdec), llama-3.2-vision-90b (vlm), mixtral-8x22b and a
tied-embedding llama3-8b, float32, batch 4 of 16 tokens.  The ranks spawn
from this file (``python tests/test_torch_tp.py RANK WORLD INIT OUT
CKPT``): four at ``--mesh 2x2``, then eight at ``--mesh 2x4``.  Each rank,
global rank ``r = d·M + m``:

* holds ``DistComm`` over its data group and its model group
  (``launch.mesh.grid``) against ``LoopbackComm``'s rows, and each
  primitive of ``runtime.model_axis`` (and the vocab-parallel
  cross-entropy and embedding) against its one-rank composition;
* trains every arch two steps through ``launch.train.setup``, keeping its
  parts at init, the bytes its storage holds, and the widths its layers
  computed with (query heads in ``layers.attention``, MLP columns,
  channels of B9 in ``ops.selective_scan``, experts in
  ``moe.moe_expert_local``), and assembling the state after each step;
* at ``2x2`` writes a checkpoint after the second step and resumes it at
  ``--mesh 4`` (the same four processes, data-parallel only); at ``2x4``
  resumes it, each taking one more step.

In this process, beside two JAX subprocesses on four and eight forced
host devices that run the reference's sharded step with
``launch.train``'s settings (``vocab_shards = M``, ``moe_groups = min(D,
B)``, ``ep_mode``) from the same initial parameters:

* the loss, ``grad_norm`` and the assembled state after each step equal
  ``--mesh local --accum D``'s at ``STEP_TOL`` (the row-split products add
  partial sums over the ranks, another order); every rank of the mesh has
  the same loss bit for bit;
* for llama3-8b, arctic-480b, falcon-mamba-7b and the tied llama they
  equal the reference's sharded step at ``check_sharded_model.py``'s
  tolerances (2e-3 on the loss, 5e-3 on every leaf);
* the parts at init are the reference's ``addressable_shards`` bit for
  bit, device id ``r`` ↔ rank ``r``, for every arch;
* a rank stores ``1/(D·M)`` of a leaf split over both axes;
* the layers computed ``H/M`` heads, ``F/M`` columns, ``di/M`` channels
  and ``E/M`` experts, or the whole where the rules leave a leaf whole;
* the ``2x2`` checkpoint restores each rank's parts at ``2x4`` and at
  ``4``, and at ``--mesh local``; the next step is theirs
  (``--mesh local --accum 2``'s within ``STEP_TOL`` at ``2x4``, ``--mesh
  local --accum 4``'s bit for bit at ``4``);
* ``--mesh 1x1`` in a one-process group is ``--mesh local`` bit for bit:
  the model group's collectives run over one rank;
* ``_VocabEmbed`` composed over two vocabulary parts against ``jax.vjp``
  of the reference's ``onehot_psum`` embedding at ``vocab_shards = 2``;
* the production meshes, the tp_local split and ``opt_fsdp_axes`` are
  accepted (``tests/test_torch_pod.py`` and ``test_torch_tp_local.py``
  run them).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_dist_comm import ROOT, bits, init_gloo, inputs, run_ranks
from test_torch_fsdp import (TIED, _assembled, _config, _distinct_bytes,
                             _paths, _state)

ARCHS = ("llama3-8b", "arctic-480b", "falcon-mamba-7b", "hymba-1.5b",
         "whisper-tiny", "llama-3.2-vision-90b", "mixtral-8x22b")
TRAINED = ARCHS + (TIED,)
HELD = ("llama3-8b", "arctic-480b", "falcon-mamba-7b", TIED)
MESHES = ("2x2", "2x4")
BATCH, SEQ, D = 4, 16, 2
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
REF_LOSS_TOL = dict(rtol=2e-3, atol=2e-3)    # check_sharded_model.py's
REF_LEAF_TOL = dict(rtol=5e-3, atol=5e-3)


def _argv(arch, *more):
    return ["--arch", arch, "--reduced", "--batch", str(BATCH), "--seq",
            str(SEQ), "--device", "cpu", "--steps", "3", *more]


def _mesh(world):
    return f"{D}x{world // D}"


def _rules(cfg, mesh):
    from repro_torch.launch import train
    d, m = (int(x) for x in mesh.split("x"))
    return train.fsdp_rules(cfg, d, m)


# ---- the ranks ------------------------------------------------------------

def _worker(rank, world, init, out, ckpt):
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime.model_axis import ModelAxis

    torch.set_num_threads(1)
    init_gloo(rank, world, init)
    mesh = _mesh(world)
    g = mesh_mod.grid(mesh_mod.make_mesh(mesh), "cpu")
    assert (g.d, g.m) == divmod(rank, world // D)
    res = {"collectives_checked": np.int64(_collectives(g)),
           "primitives_checked": np.int64(_primitives(ModelAxis(g.model)))}
    for arch in TRAINED:
        res.update({f"{arch}/{k}": v for k, v in _arch_steps(
            rank, mesh, pathlib.Path(ckpt) / arch, arch).items()})
    np.savez(f"{out}-{rank}.npz", **res)
    dist.destroy_process_group()


def _collectives(g):
    """``DistComm`` over a sub-group against ``LoopbackComm``'s row of its
    rank: ``all_gather``, ``reduce_scatter`` and ``all_reduce``."""
    from repro_torch.comm.communicator import LoopbackComm

    checked = 0
    for comm in (g.data, g.model):
        p, r = comm.p, comm.rank
        loop = LoopbackComm(p, device="cpu")
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            x = inputs(dtype, (p, p * 3, 2))
            got = comm.all_gather(x[r:r + 1].clone()).wait()
            assert torch.equal(bits(got[0]), bits(loop.all_gather(x).wait()[r]))
            for op in ("sum", "max"):
                got = comm.reduce_scatter(x[r:r + 1].clone(), op).wait()
                want = loop.reduce_scatter(x, op).wait()[r]
                assert torch.equal(bits(got[0]), bits(want)), (dtype, op)
                got = comm.all_reduce(x[r:r + 1].clone(), op).wait()
                want = loop.all_reduce(x, op).wait()[r]
                assert torch.equal(bits(got[0]), bits(want)), (dtype, op)
            checked += 5
    return checked


def _gen(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _primitives(tp):
    """Each primitive over the model group against the one-rank
    composition of the ranks' inputs (every rank draws them all from their
    seeds); returns the count checked."""
    from repro_torch.models.transformer import _VocabEmbed, fused_ce_loss

    m, n = tp.rank, tp.size

    def total(seed, shape):
        acc = _gen(seed, shape)
        for q in range(1, n):
            acc = acc + _gen(seed + q, shape)
        return acc

    # enter: identity forward, backward summed over the ranks in order
    x = _gen(0, (3, 5)).requires_grad_()
    y = tp.enter(x)
    assert torch.equal(y, x)
    y.backward(_gen(10 + m, (3, 5)))
    assert torch.equal(x.grad, total(10, (3, 5)))
    # reduce: summed forward, identity backward
    x = _gen(20 + m, (3, 5)).requires_grad_()
    y = tp.reduce(x)
    assert torch.equal(y, total(20, (3, 5)))
    y.backward(_gen(30, (3, 5)))
    assert torch.equal(x.grad, _gen(30, (3, 5)))
    # gather: concatenated forward, own slice backward
    x = _gen(40 + m, (3, 2)).requires_grad_()
    y = tp.gather(x, 1)
    assert torch.equal(y, torch.cat([_gen(40 + q, (3, 2))
                                     for q in range(n)], 1))
    g = _gen(50, (3, 2 * n))
    y.backward(g)
    assert torch.equal(x.grad, g[:, 2 * m:2 * m + 2])
    # gather_used: concatenated forward, reduce-scatter backward
    x = _gen(60 + m, (2, 3)).requires_grad_()
    y = tp.gather_used(x, 0, 2 * n)
    assert torch.equal(y, torch.cat([_gen(60 + q, (2, 3))
                                     for q in range(n)], 0))
    y.backward(_gen(70 + m, (2 * n, 3)))
    assert torch.equal(x.grad, total(70, (2 * n, 3))[2 * m:2 * m + 2])
    # the vocab-parallel cross-entropy (and its logsumexp) against the
    # whole head's, in chunks of two positions
    v = 8 * n
    labels = torch.from_numpy(np.random.default_rng(80).integers(
        0, v, (2, 4)))
    head = _gen(81, (6, v))
    x = _gen(82, (2, 4, 6)).requires_grad_()
    part = head[:, 8 * m:8 * m + 8].clone().requires_grad_()
    loss = fused_ce_loss(x, part, labels, chunk=2, tp=tp)
    loss.backward()
    x0, h0 = _gen(82, (2, 4, 6)).requires_grad_(), head.requires_grad_()
    want = fused_ce_loss(x0, h0, labels, chunk=2)
    want.backward()
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(loss, want, **tol)
    torch.testing.assert_close(x.grad, x0.grad, **tol)
    torch.testing.assert_close(part.grad, h0.grad[:, 8 * m:8 * m + 8],
                               **tol)
    # the vocab-parallel embedding: masked lookups reduced
    table = _gen(90, (v, 6))
    tokens = torch.from_numpy(np.random.default_rng(91).integers(
        0, v, (2, 5)))
    part = table[8 * m:8 * m + 8].clone().requires_grad_()
    y = tp.reduce(_VocabEmbed.apply(part, tokens, 8 * m, torch.float32))
    assert torch.equal(y, table[tokens])
    g = _gen(92, (2, 5, 6))
    y.backward(g)
    whole = table.clone().requires_grad_()
    torch.nn.functional.embedding(tokens, whole).backward(g)
    torch.testing.assert_close(part.grad, whole.grad[8 * m:8 * m + 8],
                               **tol)
    return 7


class _Widths:
    """What the layers compute with, recorded by wrapping the functions
    they call: query heads (``layers.attention``), MLP columns
    (``layers.mlp_fwd``'s ``w1``), B9's channels and calls
    (``ops.selective_scan``) and experts (``moe.moe_expert_local``)."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import layers, moe
        self.seen = {"heads": set(), "kv_heads": set(), "mlp": set(),
                     "channels": set(), "experts": set(), "scans": 0}
        self.undo = []

        def wrap(mod, name, record):
            fn = getattr(mod, name)

            def call(*a, **kw):
                record(*a, **kw)
                return fn(*a, **kw)

            setattr(mod, name, call)
            self.undo.append((mod, name, fn))

        def scan(x, *a, **kw):
            self.seen["channels"].add(x.shape[-1])
            self.seen["scans"] += 1

        wrap(layers, "attention", lambda q, k, v, **kw: (
            self.seen["heads"].add(q.shape[2]),
            self.seen["kv_heads"].add(k.shape[2])))
        wrap(layers, "mlp_fwd", lambda p, x, **kw: self.seen["mlp"].add(
            p["w1"]["w"].shape[-1]))
        wrap(ops, "selective_scan", scan)
        wrap(moe, "moe_expert_local", lambda buf, *a, **kw:
             self.seen["experts"].add(buf.shape[-3]))

    def restore(self):
        for mod, name, fn in self.undo:
            setattr(mod, name, fn)

    def arrays(self):
        return {f"seen-{k}": np.array(sorted(v) if isinstance(v, set)
                                      else [v], dtype=np.int64)
                for k, v in self.seen.items()}


def _arch_steps(rank, mesh, ckpt, arch):
    from repro_torch.launch import train

    cfg = _config(arch)
    res = {}
    first = mesh == "2x2"
    more = ["--ckpt-dir", str(ckpt), "--save-every", "2"] if first else []
    widths = _Widths()
    try:
        tr = train.setup(cfg, train.parse_args(_argv(arch, "--mesh", mesh,
                                                     *more)))
        res["retries"] = np.int64(tr.step_fn.retries)
        res["bytes0"] = np.int64(_distinct_bytes(_state(tr)))
        for i, (_, t) in enumerate(_paths(tr.params)):
            res[f"part{i}"] = t.numpy().copy()
        for step in range(2):
            met = tr.step()
            if first:
                tr.save(step + 1)
            res[f"loss{step}"] = met["loss"].numpy()
            res[f"gnorm{step}"] = met["grad_norm"].numpy()
            whole = _assembled(tr)
            if rank == 0:
                res.update({f"s{step}-{i}": a for i, a in enumerate(whole)})
    finally:
        widths.restore()
    res.update(widths.arrays())
    res["bytes1"] = np.int64(_distinct_bytes(_state(tr)))
    if tr.mgr is not None:
        tr.mgr.wait()
    del tr
    if arch not in HELD:
        return res
    # the 2x2 checkpoint, resumed at --mesh 4 by these four processes, or
    # at 2x4 by the eight
    spec = "4" if first else mesh
    tr = train.setup(cfg, train.parse_args(_argv(
        arch, "--mesh", spec, "--ckpt-dir", str(ckpt))))
    assert tr.start_step == 2
    for i, (_, t) in enumerate(_paths(_state(tr))):
        res[f"resumed{i}"] = t.numpy().copy()
    met = tr.step()
    res["resumed-loss"] = met["loss"].numpy()
    whole = _assembled(tr)
    if rank == 0:
        res.update({f"next-{i}": a for i, a in enumerate(whole)})
    return res


# ---- the reference ------------------------------------------------------

def _jax_worker(devices, out):
    """The reference's placement of every arch's initial parameters (the
    port's, drawn from the seed as ``launch.train.setup`` draws them) on
    the ``2 x devices/2`` mesh, each device's shard, and for the ``HELD``
    archs two sharded train steps with ``launch.train``'s settings."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs import registry as jregistry
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.models.transformer import Model as JModel
    from repro.models.transformer import RunCtx as JRunCtx
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.adamw import cosine_schedule as jcosine
    from repro.runtime import sharding as jsh
    from repro.runtime import steps as jsteps
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model, RunCtx, tree_map

    assert jax.device_count() == devices
    d, m = D, devices // D
    mesh = compat.make_mesh((d, m), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))
    args = train.parse_args(_argv("llama3-8b"))
    res = {}
    for arch in TRAINED:
        cfg = _config(arch)
        jcfg = jregistry.get_config(cfg.name, reduced=True)
        jcfg = dataclasses.replace(jcfg, tie_embeddings=cfg.tie_embeddings)
        rules = jsh.ShardingRules(mesh=mesh, fsdp_axes="data",
                                  ep_mode=cfg.is_moe
                                  and cfg.num_experts >= m)
        params = tree_map(lambda t: jnp.asarray(t.numpy()), Model(
            cfg, RunCtx(act_dtype=torch.float32), device="cpu").init_params(
                torch.Generator().manual_seed(args.seed), master=True))
        opt = JAdamW(lr=jcosine(args.lr, args.warmup, args.steps),
                     weight_decay=0.01)
        state = {"params": params, "opt": opt.init(params)}
        shard = jsh.param_shardings(rules, jax.eval_shape(lambda: state))
        placed = jax.tree.map(jax.device_put, state, shard)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                placed["params"])[0]:
            key = f"{arch}{jax.tree_util.keystr(path)}"
            for s in leaf.addressable_shards:
                idx = [(sl.start or 0, leaf.shape[i] if sl.stop is None
                        else sl.stop) for i, sl in enumerate(s.index)]
                res[f"index{s.device.id}{key}"] = np.array(
                    idx, dtype=np.int64).reshape(-1, 2)
                res[f"shard{s.device.id}{key}"] = np.asarray(s.data)
        if arch not in HELD:
            continue
        ctx = JRunCtx(moe_groups=max(1, min(d, BATCH)), remat="full",
                      constrain=jsh.make_constrain(rules),
                      act_dtype=jnp.float32, vocab_shards=m)
        step = jax.jit(jsteps.build_train_step(
            JModel(jcfg, ctx), opt, grad_shardings=shard["params"]))
        data = JSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=args.seed)
        p, o = placed["params"], placed["opt"]
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


def _run_jax(devices, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run([sys.executable, __file__, "jax", str(devices),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


# ---- this process --------------------------------------------------------

def _local(arch, accum, steps, ckpt=None):
    """``--mesh local --accum accum``: the parameters at init and ``(loss,
    grad_norm, state)`` after each step."""
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


def _resume(arch, accum, ckpt):
    """``--mesh local --accum accum`` resumed from ``ckpt``: the step it
    resumed at, its communicator (None), the restored state and ``(loss,
    grad_norm, state)`` after its next step."""
    from repro_torch.launch import train

    tr = train.setup(_config(arch), train.parse_args(_argv(
        arch, "--accum", str(accum), "--ckpt-dir", str(ckpt))))
    restored = [t.numpy().copy() for _, t in _paths(_state(tr))]
    met = tr.step()
    return tr.start_step, tr.comm, restored, (
        float(met["loss"]), float(met["grad_norm"]),
        [t.numpy().copy() for _, t in _paths(_state(tr))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawned ranks (2x2, then 2x4, beside the two JAX subprocesses)
    and the local runs, once for this module."""
    tmp = tmp_path_factory.mktemp("tp")
    ckpt = tmp / "ckpt"

    def spawn(world):
        d = tmp / f"world-{world}"
        d.mkdir()
        run_ranks(__file__, world, d, d / "r", ckpt, timeout=400)
        return [dict(np.load(d / f"r-{r}.npz")) for r in range(world)]

    def spawn_both():
        return {"2x2": spawn(4), "2x4": spawn(8)}

    with ThreadPoolExecutor(4) as pool:
        refs = {mesh: pool.submit(_run_jax, 2 * int(mesh[2:]),
                                  tmp / f"jax-{mesh}.npz")
                for mesh in MESHES}
        ranks = pool.submit(spawn_both)
        local = {arch: _local(arch, D, 2)[1:] for arch in TRAINED}
        ranks = ranks.result()
        resumed = {arch: {accum: _resume(arch, accum, ckpt / arch)
                          for accum in (D, 4)} for arch in HELD}
        return types.SimpleNamespace(
            ranks=ranks, local=local, ckpt=ckpt, resumed=resumed,
            ref={k: f.result() for k, f in refs.items()})


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", TRAINED)
def test_mesh_dxm_is_local_accum_d(arch, mesh, runs):
    ranks = runs.ranks[mesh]
    _, steps = runs.local[arch]
    for step in range(2):
        loss, gnorm, state = steps[step]
        for res in ranks:
            assert float(res[f"{arch}/loss{step}"]) == \
                float(ranks[0][f"{arch}/loss{step}"])
            assert float(res[f"{arch}/gnorm{step}"]) == \
                float(ranks[0][f"{arch}/gnorm{step}"])
        np.testing.assert_allclose(float(ranks[0][f"{arch}/loss{step}"]),
                                   loss, **STEP_TOL)
        np.testing.assert_allclose(float(ranks[0][f"{arch}/gnorm{step}"]),
                                   gnorm, **STEP_TOL)
        for i, want in enumerate(state):
            np.testing.assert_allclose(ranks[0][f"{arch}/s{step}-{i}"],
                                       want, **STEP_TOL)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", HELD)
def test_mesh_dxm_is_the_reference_sharded_step(arch, mesh, runs):
    """The port's ``--mesh DxM`` step from its initial parameters against
    the reference's sharded step on the ``D x M`` mesh from the same
    parameters, every leaf of the parameters and the AdamW state."""
    ref, res = runs.ref[mesh], runs.ranks[mesh][0]
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


def _tree(flat):
    tree = {}
    for keys, t in flat.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return tree


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", TRAINED)
def test_parts_are_the_reference_addressable_shards(arch, mesh, runs):
    """Rank ``r = d·M + m``'s part of every parameter at init is the
    reference's shard on device ``r``, bit for bit, and the whole
    parameter cut at the reference's index for that device."""
    from repro_torch.runtime import sharding

    ref = runs.ref[mesh]
    init, _ = runs.local[arch]
    for rank, res in enumerate(runs.ranks[mesh]):
        for i, (keys, t) in enumerate(_paths(_tree(init))):
            key = f"{arch}{sharding.path_str(keys)}"
            np.testing.assert_array_equal(res[f"{arch}/part{i}"],
                                          ref[f"shard{rank}{key}"])
            idx = ref[f"index{rank}{key}"]
            want = t.numpy()[tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_array_equal(res[f"{arch}/part{i}"], want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", TRAINED)
def test_a_rank_stores_its_block(arch, mesh, runs):
    """Distinct storage = each leaf's bytes (the parameter, m and v) over
    D where the data axis splits it and over M where the model axis does,
    + AdamW's int32 step, at init and after two steps; a leaf split over
    both axes is held at 1/(D·M) of its bytes."""
    from repro_torch.runtime import sharding

    init, _ = runs.local[arch]
    tree = _tree(init)
    rules = _rules(_config(arch), mesh)
    m = int(mesh[2:])
    want, both = 4, 0
    for (_, t), (_, dd), (_, md) in zip(
            _paths(tree), _paths(sharding.data_dims(rules, tree)),
            _paths(sharding.model_dims(rules, tree))):
        n = 3 * t.nbytes
        n //= (D if dd is not None else 1) * (m if md is not None else 1)
        want += n
        if dd is not None and md is not None:
            both += 1
    assert both
    for rank, res in enumerate(runs.ranks[mesh]):
        assert int(res[f"{arch}/bytes0"]) == want
        assert int(res[f"{arch}/bytes1"]) == want
        for i, ((_, t), (_, dd), (_, md)) in enumerate(zip(
                _paths(tree), _paths(sharding.data_dims(rules, tree)),
                _paths(sharding.model_dims(rules, tree)))):
            if dd is not None and md is not None:
                assert res[f"{arch}/part{i}"].size * D * m == t.numel()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", TRAINED)
def test_the_layers_compute_their_parts(arch, mesh, runs):
    """Query heads ``H/M`` (the whole ``H`` where ``H % M``), KV heads
    ``Hkv/M`` (a KV head a query head where ``Hkv % M``: read by index),
    MLP columns ``F/M``, B9 on ``di/M`` channels (its calls: layers ×
    (forward + recomputed forward) × two steps), experts ``E/M``."""
    cfg = _config(arch)
    m = int(mesh[2:])
    for res in runs.ranks[mesh]:
        seen = {k[len(arch) + 6:]: set(res[k].tolist())
                for k in res if k.startswith(f"{arch}/seen-")}
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        if h:
            assert seen["heads"] == {h // m if h % m == 0 else h}
            kv = hkv // m if hkv % m == 0 else h // m
            assert seen["kv_heads"] == {kv if h % m == 0 else hkv}
        if cfg.family in ("dense", "hybrid", "encdec", "vlm"):
            assert seen["mlp"] == {cfg.d_ff // m}
        if cfg.ssm_state:
            assert seen["channels"] == {cfg.d_inner // m}
            assert seen["scans"] == {cfg.num_layers * 2 * 2}
        else:
            assert not seen["channels"]
        if cfg.is_moe:
            assert seen["experts"] == {cfg.num_experts // m}
            if cfg.dense_residual:
                assert seen["mlp"] == {cfg.residual_d_ff // m}


@pytest.mark.parametrize("arch", HELD)
def test_2x2_checkpoint_restores_at_2x4_4_and_local(arch, runs):
    from repro_torch.runtime import sharding

    written = [runs.ranks["2x2"][0][f"{arch}/s1-{i}"]
               for i in range(len(runs.local[arch][1][0][2]))]
    cfg = _config(arch)
    init, _ = runs.local[arch]
    tree = _tree(init)
    for spec, ranks in (("4", runs.ranks["2x2"]), ("2x4", runs.ranks["2x4"])):
        d, m = (4, 1) if spec == "4" else (2, 4)
        rules = _rules(cfg, f"{d}x{m}")
        dd = sharding.data_dims(rules, tree)
        md = sharding.model_dims(rules, tree) if spec != "4" else None

        def state(t):
            return None if t is None else {"opt": {"m": t, "step": None,
                                                   "v": t}, "params": t}

        dims = list(_paths(state(dd)))
        mdims = list(_paths(state(md))) if md is not None else None
        for rank, res in enumerate(ranks):
            for i, a in enumerate(written):
                t = torch.from_numpy(a)
                if mdims is not None:
                    t = sharding.take(t, mdims[i][1], rank % m, m)
                t = sharding.take(t, dims[i][1], rank // m, d)
                np.testing.assert_array_equal(res[f"{arch}/resumed{i}"],
                                              t.numpy())
        start, _, _, after = runs.resumed[arch][d if spec == "4" else D]
        assert start == 2
        if spec == "4":        # data-parallel only: bit for bit
            for res in ranks:
                assert float(res[f"{arch}/resumed-loss"]) == after[0]
            for i, want in enumerate(after[2]):
                np.testing.assert_array_equal(ranks[0][f"{arch}/next-{i}"],
                                              want)
        else:
            for res in ranks:
                np.testing.assert_allclose(
                    float(res[f"{arch}/resumed-loss"]), after[0],
                    **STEP_TOL)
            for i, want in enumerate(after[2]):
                np.testing.assert_allclose(ranks[0][f"{arch}/next-{i}"],
                                           want, **STEP_TOL)
    # --mesh local restored the written state itself
    start, comm, restored, _ = runs.resumed[arch][D]
    assert start == 2 and comm is None
    for got, want in zip(restored, written):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES)
def test_groups_collectives_and_primitives(mesh, runs):
    """Every rank held its data and model groups' collectives against
    ``LoopbackComm`` and each model-axis primitive against its one-rank
    composition (asserted in the rank); a sharded step retries nothing."""
    for res in runs.ranks[mesh]:
        assert int(res["collectives_checked"]) == 30
        assert int(res["primitives_checked"]) == 7
        for arch in TRAINED:
            assert int(res[f"{arch}/retries"]) == 0


@pytest.mark.parametrize("arch", HELD)
def test_mesh_1x1_is_local_bit_for_bit(arch, tmp_path):
    """``--mesh 1x1`` in a one-process gloo group: every model-axis
    collective runs over one rank, and two steps are ``--mesh local``'s
    bit for bit (state, loss, ``grad_norm``)."""
    import torch.distributed as dist

    from repro_torch.launch import train

    _, _, want = _local(arch, 1, 2)
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        tr = train.setup(_config(arch), train.parse_args(_argv(
            arch, "--mesh", "1x1")))
        assert tr.model.ctx.model.size == 1 and tr.model.ctx.vocab_shards == 1
        for loss, gnorm, state in want:
            met = tr.step()
            assert float(met["loss"]) == loss
            assert float(met["grad_norm"]) == gnorm
            for got, w in zip(_assembled(tr), state):
                np.testing.assert_array_equal(got, w)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vocab_embed_is_the_reference_onehot_psum(dtype):
    """``_VocabEmbed`` over two vocabulary parts, composed (the lookups
    added, the table gradients concatenated), against ``jax.vjp`` of the
    reference's ``_embed_fwd`` at ``vocab_shards = 2`` (its ``onehot_psum``
    path) over 1280 positions (one chunk: 512 does not divide them) and
    1536 (three chunks of 512): the lookup exactly, the table gradient at
    ``STEP_TOL`` in float32 and, in bfloat16, within one bfloat16 spacing
    of each chunk's sum (each chunk's float32 sum is rounded once, and
    the reference's one-hot matmul adds a chunk's rows in another order,
    so the two roundings may land on neighbours)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import transformer as jtr
    from repro_torch.models.transformer import _VocabEmbed

    cfg = jregistry.get_config("llama3-8b", reduced=True)
    act = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    v, d = cfg.vocab_size, cfg.d_model
    for s in (1280, 1536):
        rng = np.random.default_rng(s)
        table = rng.standard_normal((v, d)).astype(np.float32)
        tokens = rng.integers(0, v, (2, s))
        g = rng.standard_normal((2, s, d)).astype(np.float32)
        ctx = jtr.RunCtx(act_dtype=act[0], vocab_shards=2)
        y, vjp = jax.vjp(lambda w: jtr._embed_fwd({"w": w}, jnp.asarray(
            tokens), cfg, ctx), jnp.asarray(table))
        want_g, = vjp(jnp.asarray(g).astype(act[0]))
        outs, grads = [], []
        for m in range(2):
            part = torch.from_numpy(table[m * v // 2:(m + 1) * v // 2]
                                    ).requires_grad_()
            out = _VocabEmbed.apply(part, torch.from_numpy(tokens),
                                    m * v // 2, act[1])
            out.backward(torch.from_numpy(g).to(act[1]))
            outs.append(out)
            grads.append(part.grad)
        got = (outs[0] + outs[1]).detach().float().numpy()
        np.testing.assert_array_equal(got, np.asarray(y.astype(jnp.float32)))
        got_g = torch.cat(grads).numpy()
        want_g = np.asarray(want_g)
        if dtype == "float32":
            np.testing.assert_allclose(got_g, want_g, **STEP_TOL)
        else:
            chunk = 512 if s % 512 == 0 else s
            gb = torch.from_numpy(g).to(torch.bfloat16).double().numpy()
            bound = np.zeros((v, d))
            for c in range(s // chunk):
                sl = slice(c * chunk, (c + 1) * chunk)
                part = np.zeros((v, d))
                np.add.at(part, tokens[:, sl].reshape(-1),
                          gb[:, sl].reshape(-1, d))
                bound += 2 ** -7 * np.abs(part)
            assert (np.abs(got_g - want_g) <= bound + 1e-6).all()


@pytest.mark.parametrize("spec,shape", [("pod", (16, 16)),
                                        ("multipod", (2, 16, 16)),
                                        ("1x8", (1, 8))])
def test_production_meshes_and_tp_local_are_accepted(spec, shape, tmp_path,
                                                     monkeypatch):
    """The production meshes, and an MoE config with fewer experts (4,
    reduced mixtral) than the model axis (its tp_local split), are
    ported: ``ported_mesh`` gives the reference's mesh, ``main`` without
    a launcher asks for a process group, and in a one-process group the
    mesh refuses the world of one (``pod`` needs 256 processes,
    ``multipod`` 512)."""
    import torch.distributed as dist

    from repro_torch.launch import train
    cfg = _config("mixtral-8x22b")
    mesh = train.ported_mesh(spec)
    assert mesh.axis_sizes == shape
    assert train.mesh_rules(cfg, mesh).ep_mode == (cfg.num_experts
                                                   >= shape[-1])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torch.distributed group"):
        train.main(_argv("mixtral-8x22b", "--mesh", spec))
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        with pytest.raises(ValueError, match="process group has 1"):
            train.ported_mesh(spec)
        with pytest.raises(ValueError, match="process group has 1"):
            train.setup(cfg, train.parse_args(_argv("mixtral-8x22b",
                                                    "--mesh", spec)))
    finally:
        dist.destroy_process_group()


def test_opt_fsdp_axes_and_pod_serving_are_accepted(tmp_path):
    """``opt_fsdp_axes`` places the optimizer state (``Gather.odims``),
    and serving takes the production meshes: ``make_comm("pod")`` in a
    one-process group refuses the world of one, not the mesh."""
    import torch.distributed as dist

    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.launch import serve
    from repro_torch.runtime import sharding

    cfg = _config("llama3-8b")
    rules = dataclasses.replace(_rules(cfg, "1x1"), opt_fsdp_axes="data")
    gather = sharding.make_gather(rules, LoopbackComm(1, device="cpu"))
    assert gather.odims == {} and gather.wide is gather.comm
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        with pytest.raises(ValueError, match="process group has 1"):
            serve.make_comm("pod", "cpu")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_worker(int(sys.argv[2]), sys.argv[3])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4], sys.argv[5])
