"""The reference's ``tp_local`` MoE split: an MoE config with fewer experts
than the model axis (``ep_mode=False``), in training and in serving, over
gloo processes.

Reduced mixtral-8x22b (4 experts, ``F`` = 128) at ``--mesh 1x8`` and a
2-expert variant at ``--mesh 2x4``, float32, batch 4 of 16 tokens.  Eight
ranks spawn from this file (``python tests/test_torch_tp_local.py RANK
WORLD INIT OUT``), global rank ``r = d·M + m``.  Each trains both meshes
two steps through ``launch.train.setup``, keeping its parts at init and
the widths its experts ran (``moe.moe_expert_local``), and serves the
4-expert config at ``1x8``: a prefill and two decode steps' logits, the
engine's tokens, and the engine's tokens with the decode hook
(``--moe-comm``: ``serve.engine.moe_decode_hook`` gathers the experts
whole over the model group).  Beside them, a JAX subprocess on eight
forced host devices runs the reference's sharded step at both meshes
(``ShardingRules(fsdp_axes="data", ep_mode=False)``, ``launch.train``'s
settings) from the port's initial parameters.  The checks:

* the loss, ``grad_norm`` and the assembled state after each step are
  ``--mesh local --accum D``'s at ``STEP_TOL`` and the reference's
  sharded step at ``check_sharded_model.py``'s tolerances;
* the parts at init are the reference's ``addressable_shards`` of the
  ``ep_mode=False`` placement, block for block (``w1``/``w3`` ``P(None,
  data, model)``, ``w2`` ``P(None, model, data)``);
* every rank runs all ``E`` experts on ``F/M`` columns;
* the served logits are ``--mesh local``'s within ``SERVE_TOL`` and the
  tokens are its tokens, with the decode hook too;
* without processes: the rules leave ``ep_mode`` off and split ``F``
  (replicated where the axis does not divide it), ``moe_fwd``'s column
  blocks sum to the whole layer, and ``whole_experts`` gathers the dim
  that the rules split.
"""
import dataclasses
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_dist_comm import ROOT, init_gloo, run_ranks
from test_torch_fsdp import _assembled, _paths, _state
from test_torch_tp import _tree

MESHES = {"1x8": 4, "2x4": 2}          # the mesh and its config's experts
BATCH, SEQ = 4, 16
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
REF_LOSS_TOL = dict(rtol=2e-3, atol=2e-3)    # check_sharded_model.py's
REF_LEAF_TOL = dict(rtol=5e-3, atol=5e-3)
SERVE_TOL = 1e-4
B, PROMPT, CACHE, STEPS = 4, 4, 16, 2
ENGINE_ARGV = ["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu",
               "--requests", "4", "--slots", "4", "--prompt-len", "8",
               "--gen", "4"]


def _config(experts):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("mixtral-8x22b", reduced=True),
                               num_experts=experts)


def _args(mesh="local", *more):
    from repro_torch.launch import train
    return train.parse_args(["--arch", "mixtral-8x22b", "--reduced",
                             "--batch", str(BATCH), "--seq", str(SEQ),
                             "--device", "cpu", "--steps", "3", "--mesh",
                             mesh, *more])


class _Experts:
    """The experts and the columns ``moe.moe_expert_local`` ran."""

    def __init__(self):
        from repro_torch.models import moe
        self.seen = {"experts": set(), "columns": set()}
        self.fn = moe.moe_expert_local

        def call(buf, w1, *a, **kw):
            self.seen["experts"].add(buf.shape[-3])
            self.seen["columns"].add(w1.shape[-1])
            return self.fn(buf, w1, *a, **kw)

        moe.moe_expert_local = call

    def restore(self):
        from repro_torch.models import moe
        moe.moe_expert_local = self.fn


# ---- the ranks ------------------------------------------------------------

def _worker(rank, world, init, out):
    import torch.distributed as dist

    from repro_torch.launch import train

    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_PLAN_CACHE"] = "0"
    init_gloo(rank, world, init)
    res = {}
    for mesh, experts in MESHES.items():
        seen = _Experts()
        try:
            tr = train.setup(_config(experts), _args(mesh))
            assert not tr.model.ctx.gather.rules.ep_mode
            for i, (_, t) in enumerate(_paths(tr.params)):
                res[f"{mesh}/part{i}"] = t.numpy().copy()
            for step in range(2):
                met = tr.step()
                res[f"{mesh}/loss{step}"] = met["loss"].numpy()
                res[f"{mesh}/gnorm{step}"] = met["grad_norm"].numpy()
                whole = _assembled(tr)
                if rank == 0:
                    res.update({f"{mesh}/s{step}-{i}": a
                                for i, a in enumerate(whole)})
        finally:
            seen.restore()
        for k, v in seen.seen.items():
            res[f"{mesh}/seen-{k}"] = np.array(sorted(v), dtype=np.int64)
        del tr
    res.update(_serving())
    np.savez(f"{out}-{rank}.npz", **res)
    dist.destroy_process_group()


def _run(model, params, cfg):
    """Prefill then ``STEPS`` decode steps: their logits."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    cache = model.init_cache(B, CACHE, dtype=torch.float32)
    out = []
    with torch.no_grad():
        logits, cache = model.prefill(params, cache, torch.from_numpy(prompt))
        out.append(logits.numpy().copy())
        for step in steps:
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(step))
            out.append(logits.numpy().copy())
    return out


def _tokens(report):
    return np.array([report.outputs[f"req{i}"] for i in range(4)])


def _serving():
    """At ``1x8``: the logits, the engine's tokens, with the hook too."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model, RunCtx

    cfg, res = _config(MESHES["1x8"]), {}
    mesh = mesh_mod.make_mesh("1x8")
    grid = mesh_mod.grid(mesh, "cpu")
    ctx = serve.serving_ctx(cfg, RunCtx(act_dtype=torch.float32), mesh, grid)
    assert not ctx.gather.rules.ep_mode
    model = Model(cfg, ctx, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    seen = _Experts()
    try:
        for i, o in enumerate(_run(model, params, cfg)):
            res[f"serve/logits{i}"] = o
    finally:
        seen.restore()
    for k, v in seen.seen.items():
        res[f"serve/seen-{k}"] = np.array(sorted(v), dtype=np.int64)
    for tag, more in (("", []), ("+hook", ["--moe-comm"])):
        args = serve.parse_args(ENGINE_ARGV + more + ["--mesh", "1x8"])
        res[f"serve/tokens{tag}"] = _tokens(serve.make_engine(
            cfg, RunCtx(act_dtype=torch.float32), args, grid=grid).run())
    return res


# ---- the reference --------------------------------------------------------

def _jax_worker(out):
    """The reference's ``ep_mode=False`` placement of the port's initial
    parameters at both meshes, each device's shard, and two sharded steps
    with ``launch.train``'s settings."""
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
    from repro_torch.models.transformer import Model, RunCtx, tree_map

    assert jax.device_count() == 8
    args = _args()
    res = {}
    for spec, experts in MESHES.items():
        d, m = (int(x) for x in spec.split("x"))
        mesh = compat.make_mesh((d, m), ("data", "model"),
                                axis_types=compat.auto_axis_types(2))
        cfg = _config(experts)
        jcfg = dataclasses.replace(jregistry.get_config(
            "mixtral-8x22b", reduced=True), num_experts=experts)
        rules = jsh.ShardingRules(mesh=mesh, fsdp_axes="data",
                                  ep_mode=experts >= m)
        assert not rules.ep_mode
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
            key = f"{spec}{jax.tree_util.keystr(path)}"
            for s in leaf.addressable_shards:
                res[f"shard{s.device.id}{key}"] = np.asarray(s.data)
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
            res[f"{spec}/loss{i}"] = np.asarray(met["loss"])
            res[f"{spec}/gnorm{i}"] = np.asarray(met["grad_norm"])
            for j, leaf in enumerate(jax.tree.leaves({"params": p,
                                                      "opt": o})):
                res[f"{spec}/s{i}-{j}"] = np.asarray(leaf)
    np.savez(out, **res)


def _run_jax(out):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, "jax", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


# ---- this process ---------------------------------------------------------

def _local(experts, accum):
    """``--mesh local --accum accum``: the parameters at init and ``(loss,
    grad_norm, state)`` after each of two steps."""
    from repro_torch.launch import train

    tr = train.setup(_config(experts), _args("local", "--accum", str(accum)))
    init = {k: t.clone() for k, t in _paths(tr.params)}
    out = []
    for _ in range(2):
        met = tr.step()
        out.append((float(met["loss"]), float(met["grad_norm"]),
                    [t.numpy().copy() for _, t in _paths(_state(tr))]))
    return init, out


def _local_serve():
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model, RunCtx

    cfg = _config(MESHES["1x8"])
    model = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    out = {"logits": _run(model, params, cfg)}
    for tag, more in (("", []), ("+hook", ["--moe-comm"])):
        out[f"tokens{tag}"] = _tokens(serve.make_engine(
            cfg, RunCtx(act_dtype=torch.float32),
            serve.parse_args(ENGINE_ARGV + more)).run())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_local")

    def spawn():
        run_ranks(__file__, 8, tmp, tmp / "r", timeout=500)
        return [dict(np.load(tmp / f"r-{r}.npz")) for r in range(8)]

    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_jax, tmp / "jax.npz")
        ranks = pool.submit(spawn)
        local = {mesh: _local(experts, int(mesh.split("x")[0]))
                 for mesh, experts in MESHES.items()}
        served = _local_serve()
        return types.SimpleNamespace(ranks=ranks.result(), local=local,
                                     served=served, ref=ref.result())


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_local_is_local_accum_d(mesh, runs):
    """Every rank the same loss bit for bit; the loss, ``grad_norm`` and
    the state ``--mesh local --accum D``'s at ``STEP_TOL`` (the experts'
    partial sums are added over the model axis)."""
    _, steps = runs.local[mesh]
    ranks = runs.ranks
    for step, (loss, gnorm, state) in enumerate(steps):
        for res in ranks:
            for k in ("loss", "gnorm"):
                assert float(res[f"{mesh}/{k}{step}"]) == \
                    float(ranks[0][f"{mesh}/{k}{step}"])
        np.testing.assert_allclose(float(ranks[0][f"{mesh}/loss{step}"]),
                                   loss, **STEP_TOL)
        np.testing.assert_allclose(float(ranks[0][f"{mesh}/gnorm{step}"]),
                                   gnorm, **STEP_TOL)
        for i, want in enumerate(state):
            np.testing.assert_allclose(ranks[0][f"{mesh}/s{step}-{i}"],
                                       want, **STEP_TOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_local_is_the_reference_sharded_step(mesh, runs):
    ref, res = runs.ref, runs.ranks[0]
    n = len(runs.local[mesh][1][0][2])
    for step in range(2):
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(float(res[f"{mesh}/{k}{step}"]),
                                       float(ref[f"{mesh}/{k}{step}"]),
                                       **REF_LOSS_TOL)
        for i in range(n):
            np.testing.assert_allclose(res[f"{mesh}/s{step}-{i}"],
                                       ref[f"{mesh}/s{step}-{i}"],
                                       **REF_LEAF_TOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_local_parts_are_the_reference_shards(mesh, runs):
    """Rank ``r``'s part of every parameter at init is the reference's
    shard on device ``r`` under ``ep_mode=False``, bit for bit: each
    expert weight its ``F/M`` block over the model axis (and ``D/D``
    over the data axis), every expert on every rank."""
    from repro_torch.runtime import sharding

    init, _ = runs.local[mesh]
    d, m = (int(x) for x in mesh.split("x"))
    experts = 0
    for rank, res in enumerate(runs.ranks):
        for i, (keys, t) in enumerate(_paths(_tree(init))):
            key = f"{mesh}{sharding.path_str(keys)}"
            part = res[f"{mesh}/part{i}"]
            np.testing.assert_array_equal(part, runs.ref[f"shard{rank}{key}"])
            if keys[-1] in ("w1", "w2", "w3"):
                f = -1 if keys[-1] != "w2" else -2
                assert part.shape[-3] == t.shape[-3]
                assert part.shape[f] * m == t.shape[f]
                experts += 1
    assert experts


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_local_experts_run_on_f_over_m_columns(mesh, runs):
    m, experts = int(mesh.split("x")[1]), MESHES[mesh]
    cfg = _config(experts)
    for res in runs.ranks:
        assert res[f"{mesh}/seen-experts"].tolist() == [experts]
        assert res[f"{mesh}/seen-columns"].tolist() == [cfg.d_ff // m]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_tp_local_serving_is_local(runs):
    """At ``1x8``: every rank's logits within ``SERVE_TOL`` of ``--mesh
    local``'s and the same bits on every rank, its experts all ``E`` on
    ``F/8`` columns; the engine emits the local tokens, and so does it
    with the decode hook (the experts gathered whole over the model
    group)."""
    want = runs.served
    cfg = _config(MESHES["1x8"])
    for res in runs.ranks:
        for i in range(STEPS + 1):
            got = res[f"serve/logits{i}"]
            assert _rel(got, want["logits"][i]) <= SERVE_TOL, i
            np.testing.assert_array_equal(got, runs.ranks[0][
                f"serve/logits{i}"])
        assert res["serve/seen-experts"].tolist() == [cfg.num_experts]
        assert res["serve/seen-columns"].tolist() == [cfg.d_ff // 8]
        for tag in ("", "+hook"):
            np.testing.assert_array_equal(res[f"serve/tokens{tag}"],
                                          want[f"tokens{tag}"])


@pytest.mark.parametrize("d_ff", [128, 100])
def test_tp_local_rules_split_f_or_leave_it_whole(d_ff):
    """``ep_mode`` is off where the experts are fewer than the model axis,
    in training (``mesh_rules``) and serving (``serve_rules``); the expert
    weights' model dim is ``F`` (``w1``/``w3`` the last, ``w2`` the one
    before), and where 8 does not divide ``F`` the rules leave it whole
    and no model dim is split."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.runtime import sharding

    cfg = dataclasses.replace(_config(4), d_ff=d_ff)
    mesh = mesh_mod.make_mesh("1x8")
    for rules in (train.mesh_rules(cfg, mesh),
                  sharding.serve_rules(cfg, mesh, limit=12e9)):
        assert not rules.ep_mode
        for name, shape, at in (("w1", (2, 4, 64, d_ff), -1),
                                ("w3", (2, 4, 64, d_ff), -1),
                                ("w2", (2, 4, d_ff, 64), -2)):
            path = f"['layers']['moe']['{name}']"
            want = at if d_ff % 8 == 0 else None
            assert sharding.model_dim(rules, path, shape) == want


class _Block:
    """A model axis of ``size`` ranks seen from rank ``rank`` with no
    collective: ``enter`` and ``reduce`` as they are (the caller sums)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def enter(self, x):
        return x

    def reduce(self, x):
        return x

    def gather(self, x, dim):
        raise AssertionError("tp_local gathers no expert output")


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_fwd_column_blocks_sum_to_the_whole_layer(act):
    """``moe_fwd`` on each of four ranks' ``F/4`` columns (``w2`` the same
    rows), the partial outputs added, is ``moe_fwd`` on the whole experts
    within float32 rounding, and its gradient with respect to each block
    is the whole gradient's block."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(_config(2), act=act)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 12, cfg.d_model), generator=gen)
    g = torch.randn((1, 12, cfg.d_model), generator=gen)
    p = moe.init_moe(gen, cfg)
    names = [k for k in ("w1", "w2", "w3") if k in p]
    whole = {k: p[k].clone().requires_grad_() for k in names}
    want = moe.moe_fwd(dict(p, **whole), x, cfg)
    want.backward(g)
    split = {k: p[k].clone().requires_grad_() for k in names}
    n = cfg.d_ff // 4
    got = 0
    for r in range(4):
        cut = slice(r * n, (r + 1) * n)
        block = {k: split[k][:, cut] if k == "w2" else split[k][..., cut]
                 for k in names}
        got = got + moe.moe_fwd(dict(p, **block), x, cfg, tp=_Block(r, 4))
    got.backward(g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for k in names:
        torch.testing.assert_close(split[k].grad, whole[k].grad, rtol=1e-5,
                                   atol=1e-5)


def test_whole_experts_gathers_the_dim_the_rules_split():
    """The decode hook's weights whole from a rank's part: the experts'
    dim under ``ep_mode``, ``F`` under ``tp_local``, none where whole."""
    from repro_torch.models import moe

    cfg = _config(4)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    class Axis:
        def full(self, t, dim, n):
            return ("full", dim, n)

    for name, shape, want in (
            ("w1", (e // 2, d, f), ("full", 0, e)),
            ("w1", (e, d, f // 8), ("full", 2, f)),
            ("w2", (e, f // 8, d), ("full", 1, f)),
            ("w3", (e, d, f // 8), ("full", 2, f))):
        assert moe.whole_experts(Axis(), cfg, name,
                                 torch.empty(shape)) == want
    t = torch.empty((e, d, f))
    assert moe.whole_experts(Axis(), cfg, "w1", t) is t


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_worker(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4])
