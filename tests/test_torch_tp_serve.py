"""``launch.serve --mesh DxM``: serving over the model axis, with the
reference's serve placement and its flash-decoding cache layout, over
gloo processes.

Four ranks spawn from this file (``python tests/test_torch_tp_serve.py
RANK WORLD INIT OUT``), global rank ``r = d·M + m``.  At ``2x2`` and at
``1x4`` each rank places every arch's parameters by ``sharding.
serve_rules`` (the limit the reference's 12e9, so no ZeRO) and its block
of a shared-position cache of 4 lanes and 16 slots by ``cache_specs``,
fills the cross cache of whisper-tiny and llama-3.2-vision-90b
(``prefill_cross``), prefills a prompt of 4 tokens (``Model.prefill`` for
the attention stacks, the decode scan for the others) and takes two
decode steps on its lanes; reduced llama3-8b runs again on a ring of 10
slots, which the model axis splits at ``2x2`` and leaves whole at
``1x4``.  At ``2x2`` llama3-8b and mixtral-8x22b run once more under a
limit of one byte, which spreads the weights over the data axis too
(ZeRO-inference), and the ranks serve ``launch.serve.main`` for reduced
llama3-8b (at the reference's limit and, ``sharding.serve_limit``
patched, at one byte) and, with
``--moe-comm --experts 4``, mixtral-8x22b.

Beside them, two JAX subprocesses: one on four forced host devices runs
the reference's sharded decode step (``ShardingRules(fsdp_axes=None,
ep_mode=E >= M)``, ``RunCtx(constrain=make_constrain(rules),
vocab_shards=M)``, the parameters by ``param_shardings``, the cache by
``cache_shardings``, ``jax.jit`` of ``prefill``/``prefill_cross``/
``decode_step``) from the port's parameters on the same inputs, and
the serve branch of its ``make_rules`` for every arch at its published
widths; one on eight runs the reference's ``launch.serve --mesh 2x2``
(its ``Model.init_params`` giving the port's parameters).  The checks:

* every arch's prefill and decode logits at ``2x2`` and ``1x4`` within
  ``STEP_TOL`` (relative L2) of the reference's sharded step and of the
  port's ``--mesh local``; every rank of a model group the same bits;
* each rank's cache block the reference's ``addressable_shards`` of
  ``cache_shardings`` (device id ``r`` ↔ rank ``r``) within ``STEP_TOL``,
  its parameter parts bit for bit those of ``param_shardings``;
* the compute split: the ring's ``S/M`` slots (or all where the axis
  does not divide them) and B8's partial entry called once a layer and
  step on them, ``di/M`` mamba channels, ``H/M`` query heads, ``F/M``
  MLP columns, ``E/M`` experts;
* ``serve_rules`` is the reference's ``make_rules`` at 12e9 for every
  arch at its published widths, and the ZeRO-inference branch keeps the
  step's logits and the served tokens;
* a lane that another data rank prefilled gets the owner's ``slot_pos``
  block, for prompts that wrap the ring too;
* ``launch.serve --mesh 2x2`` emits the reference ``launch.serve``'s
  tokens on every rank, and its batched demo (falcon-mamba-7b,
  whisper-tiny) ``--mesh local``'s; ``--mesh 1x1`` in a one-process group
  is ``--mesh local`` bit for bit (the step's logits, the served tokens);
* the production meshes and the tp_local split are served (the pod
  axis and tp_local run in ``test_torch_pod.py`` and
  ``test_torch_tp_local.py``); ``seq_parallel`` still refuses.
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

ARCHS = ("llama3-8b", "mixtral-8x22b", "arctic-480b", "falcon-mamba-7b",
         "hymba-1.5b", "whisper-tiny", "llama-3.2-vision-90b")
RING10 = "llama3-8b@10"                  # a ring of 10 slots
CASES = ARCHS + (RING10,)
ZERO = ("llama3-8b", "mixtral-8x22b")
MESHES = ("2x2", "1x4")
WORLD = 4
B, PROMPT, CACHE, STEPS, SEED = 4, 4, 16, 2, 0
STEP_TOL = 1e-4                          # relative L2, float32
LIMIT = 12e9                             # the reference's serve limit
SERVE_ARGV = ["--reduced", "--device", "cpu", "--requests", "4",
              "--slots", "4", "--prompt-len", "8", "--gen", "4"]
SERVED = {"llama3-8b": ["--arch", "llama3-8b"],
          "mixtral-8x22b": ["--arch", "mixtral-8x22b", "--moe-comm",
                            "--experts", "4"]}
# the batched demo (ssm, hybrid, encdec, vlm): its batch over the data axis
DEMO = ("falcon-mamba-7b", "whisper-tiny")
DEMO_ARGV = ["--reduced", "--device", "cpu", "--batch", "4", "--prompt-len",
             "4", "--gen", "3"]


def _config(case):
    from repro_torch.configs.registry import get_config
    return get_config(case.split("@")[0], reduced=True)


def _cache_len(case):
    return int(case.split("@")[1]) if "@" in case else CACHE


def _inputs(cfg):
    """The prompt (B, PROMPT), the decode steps' tokens (STEPS, B, 1) and
    the cross context (B, T, d) or None, from the seed."""
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    t = cfg.encoder_seq or cfg.num_image_tokens or 0
    ctx = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32) \
        if t else None
    return prompt, steps, ctx


def _params(cfg):
    """The port's serving parameters from the seed, whole, float32."""
    from repro_torch.models.transformer import Model, RunCtx
    return Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu") \
        .init_params(torch.Generator().manual_seed(SEED))


def _paths(tree, keys=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], keys + (k,))]
    return [(keys, tree)]


def _key(keys):
    from repro_torch.runtime.sharding import path_str
    return path_str(keys)


def _run(model, params, cfg, lanes, cache_len):
    """Prefill then ``STEPS`` decode steps on ``lanes``: the logits of
    each, and the cache."""
    from repro_torch.launch.serve import prefill_into_cache

    prompt, steps, ctx = _inputs(cfg)
    t = 0 if ctx is None else ctx.shape[1]
    cache = model.init_cache(B, cache_len, cross_len=t, dtype=torch.float32)
    out = []
    with torch.no_grad():
        if ctx is not None:
            cache = model.prefill_cross(params, cache,
                                        torch.from_numpy(ctx[lanes]))
        tokens = torch.from_numpy(prompt[lanes])
        if cfg.family in ("dense", "moe"):
            logits, cache = model.prefill(params, cache, tokens)
        else:
            cache, logits = prefill_into_cache(model, params, cache, tokens)
        out.append(logits.numpy().copy())
        for step in steps:
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(step[lanes]))
            out.append(logits.numpy().copy())
    return out, cache


class _Seen:
    """The widths the serving layers ran: query heads a rank projects
    (``layers.serve_attention``), MLP columns, experts, and the K/V slots
    of every call of B8's partial entry."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import layers, moe
        self.seen = {"heads": set(), "mlp": set(), "experts": set(),
                     "partial_slots": set(), "partial_calls": 0}
        self.undo = []

        def wrap(mod, name, record, after=False):
            fn = getattr(mod, name)

            def call(*a, **kw):
                out = fn(*a, **kw)
                record(out if after else None, *a, **kw)
                return out

            setattr(mod, name, call)
            self.undo.append((mod, name, fn))

        def partial(_, q, k, *a, **kw):
            self.seen["partial_slots"].add(k.shape[1])
            self.seen["partial_calls"] += 1

        wrap(layers, "serve_attention",
             lambda out, *a, **kw: self.seen["heads"].add(out[1]), True)
        wrap(layers, "mlp_fwd", lambda _, p, x, **kw: self.seen["mlp"].add(
            p["w1"]["w"].shape[-1]))
        wrap(moe, "moe_expert_local", lambda _, buf, *a, **kw:
             self.seen["experts"].add(buf.shape[-3]))
        wrap(ops, "decode_attention_partial", partial)

    def restore(self):
        for mod, name, fn in self.undo:
            setattr(mod, name, fn)

    def arrays(self, prefix):
        return {f"{prefix}/seen-{k}": np.array(
            sorted(v) if isinstance(v, set) else [v], dtype=np.int64)
            for k, v in self.seen.items()}


# ---- the ranks ------------------------------------------------------------

def _serving(case, mesh, grid, limit=LIMIT):
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import serving_ctx
    from repro_torch.models.transformer import Model, RunCtx

    cfg = _config(case)
    ctx = serving_ctx(cfg, RunCtx(act_dtype=torch.float32),
                      mesh_mod.make_mesh(mesh), grid, limit=limit)
    model = Model(cfg, ctx, device="cpu")
    return cfg, model, model.init_params(torch.Generator().manual_seed(SEED))


def _case(res, case, mesh, grid, limit=LIMIT, tag=""):
    from repro_torch.models.transformer import tree_leaves

    cfg, model, params = _serving(case, mesh, grid, limit)
    pre = f"{mesh}/{case}{tag}"
    if not tag and case in ARCHS:
        for keys, t in _paths(params):
            res[f"{pre}/param{_key(keys)}"] = t.numpy().copy()
    res[f"{pre}/fsdp"] = np.array(
        [model.ctx.gather.rules.fsdp_axes is not None])
    res[f"{pre}/bytes"] = np.int64(sum(t.numel() * t.element_size()
                                       for t in tree_leaves(params)))
    seen = _Seen()
    try:
        outs, cache = _run(model, params, cfg, model.ctx.gather.lanes(B),
                           _cache_len(case))
    finally:
        seen.restore()
    res.update(seen.arrays(pre))
    for i, o in enumerate(outs):
        res[f"{pre}/logits{i}"] = o
    if not tag:
        assert cache["whole"] == {"self": min(_cache_len(case), cfg.swa_window
                                                  or _cache_len(case)),
                                  "cross": cfg.encoder_seq
                                  or cfg.num_image_tokens or 0, "batch": B}
        for keys, t in _paths({k: cache[k] for k in ("pos", "layers")}):
            res[f"{pre}/cache{_key(keys)}"] = t.numpy().copy()


def _served(argv):
    """``launch.serve.main`` in this process's group: every request's
    tokens, in request order."""
    from repro_torch.launch import serve
    report = serve.main(argv)
    return np.array([report.outputs[f"req{i}"] for i in range(4)])


def _worker(rank, world, init, out):
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_PLAN_CACHE"] = "0"      # no plan on disk
    init_gloo(rank, world, init)
    res = {}
    for mesh in MESHES:
        grid = mesh_mod.grid(mesh_mod.make_mesh(mesh), "cpu")
        assert (grid.d, grid.m) == divmod(rank, int(mesh.split("x")[1]))
        for case in CASES:
            _case(res, case, mesh, grid)
        if mesh == "2x2":
            for case in ZERO:
                _case(res, case, mesh, grid, limit=1.0, tag="+zero")
    for arch, argv in SERVED.items():
        res[f"served/{arch}"] = _served(argv + SERVE_ARGV + ["--mesh",
                                                             "2x2"])
    from repro_torch.runtime import sharding
    limit = sharding.serve_limit
    sharding.serve_limit = lambda device=None: 1.0     # ZeRO-inference
    try:
        res["served/llama3-8b+zero"] = _served(
            SERVED["llama3-8b"] + SERVE_ARGV + ["--mesh", "2x2"])
    finally:
        sharding.serve_limit = limit
    from repro_torch.launch import serve
    for arch in DEMO:
        res[f"demo/{arch}"] = serve.main(["--arch", arch, "--mesh", "2x2"]
                                         + DEMO_ARGV).numpy()
    np.savez(f"{out}-{rank}.npz", **res)
    dist.destroy_process_group()


# ---- the reference --------------------------------------------------------

def _jax_steps(out):
    """The reference's sharded prefill and decode on four devices at each
    mesh, and its serve rules at the published widths."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs import registry as jregistry
    from repro.launch.dryrun import make_rules
    from repro.launch.serve import prefill_into_cache as jprefill
    from repro.models.transformer import Model as JModel
    from repro.models.transformer import RunCtx as JRunCtx
    from repro.runtime import sharding as jsh
    from repro_torch.models.transformer import tree_map

    res = {}

    def shards(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            for s in leaf.addressable_shards:
                res[f"{prefix}{s.device.id}"
                    f"{jax.tree_util.keystr(path)}"] = np.asarray(s.data)

    for mesh_spec in MESHES:
        d, m = (int(x) for x in mesh_spec.split("x"))
        mesh = compat.make_mesh((d, m), ("data", "model"),
                                axis_types=compat.auto_axis_types(2))
        for case in CASES:
            cfg = _config(case)
            jcfg = jregistry.get_config(cfg.name, reduced=True)
            rules = jsh.ShardingRules(mesh=mesh, fsdp_axes=None,
                                      ep_mode=cfg.is_moe
                                      and cfg.num_experts >= m)
            ctx = JRunCtx(constrain=jsh.make_constrain(rules),
                          vocab_shards=m, act_dtype=jnp.float32)
            model = JModel(jcfg, ctx)
            params = tree_map(lambda t: jnp.asarray(t.numpy()), _params(cfg))
            params = jax.device_put(params, jsh.param_shardings(
                rules, jax.eval_shape(lambda: params)))
            pre = f"{mesh_spec}/{case}"
            if case in ARCHS:
                shards(f"{pre}/param", params)
            prompt, steps, ctxt = _inputs(cfg)
            t = 0 if ctxt is None else ctxt.shape[1]
            cache = model.init_cache(B, _cache_len(case), cross_len=t,
                                     dtype=jnp.float32)
            cshard = jsh.cache_shardings(rules, jax.eval_shape(
                lambda: cache))
            cache = jax.device_put(cache, cshard)
            if ctxt is not None:
                cache = jax.jit(model.prefill_cross)(params, cache,
                                                     jnp.asarray(ctxt))
            if cfg.family in ("dense", "moe"):
                logits, cache = jax.jit(model.prefill)(params, cache,
                                                       jnp.asarray(prompt))
            else:
                cache, logits = jax.jit(lambda p, c, x: jprefill(
                    model, p, c, x))(params, cache, jnp.asarray(prompt))
            res[f"{pre}/logits0"] = np.asarray(logits)
            decode = jax.jit(model.decode_step)
            for i, step in enumerate(steps):
                logits, cache = decode(params, cache, jnp.asarray(step))
                res[f"{pre}/logits{i + 1}"] = np.asarray(logits)
            shards(f"{pre}/cache", jax.device_put(cache, cshard))
    mesh = compat.make_mesh((2, 2), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))
    for arch in ARCHS:
        rules = make_rules(jregistry.get_config(arch), mesh, "decode")
        res[f"rules/{arch}"] = np.array([rules.fsdp_axes is not None,
                                         rules.ep_mode])
    np.savez(out, **res)


def _jax_serve(out):
    """The reference's ``launch.serve --mesh 2x2`` on eight devices, its
    ``Model.init_params`` giving the port's parameters."""
    import jax.numpy as jnp

    from repro.launch import serve as jserve
    from repro.models.transformer import Model as JModel
    from repro_torch.models.transformer import tree_map

    res = {}
    init = JModel.init_params
    try:
        for arch, argv in SERVED.items():
            cfg = _config(arch)
            if "--experts" in argv:
                cfg = dataclasses.replace(cfg, num_experts=4)
            params = tree_map(lambda t: jnp.asarray(t.numpy()), _params(cfg))
            JModel.init_params = lambda self, key, params=params: params
            report = jserve.main(argv + [a for a in SERVE_ARGV
                                         if a not in ("--device", "cpu")]
                                 + ["--mesh", "2x2"])
            res[f"served/{arch}"] = np.array(
                [report.outputs[f"req{i}"] for i in range(4)])
    finally:
        JModel.init_params = init
    np.savez(out, **res)


def _run_jax(what, devices, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               REPRO_PLAN_CACHE="0")
    proc = subprocess.run([sys.executable, __file__, what, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


# ---- this process ---------------------------------------------------------

def _local(case):
    """``--mesh local``: the logits of the prefill and each step."""
    from repro_torch.models.transformer import Model, RunCtx

    cfg = _config(case)
    model = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    return _run(model, params, cfg, slice(None), _cache_len(case))[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")

    def spawn():
        run_ranks(__file__, WORLD, tmp, tmp / "r", timeout=400)
        return [dict(np.load(tmp / f"r-{r}.npz")) for r in range(WORLD)]

    with ThreadPoolExecutor(3) as pool:
        steps = pool.submit(_run_jax, "jax-steps", 4, tmp / "jax-steps.npz")
        served = pool.submit(_run_jax, "jax-serve", 8, tmp / "jax-serve.npz")
        ranks = pool.submit(spawn)
        local = {case: _local(case) for case in CASES}
        return types.SimpleNamespace(
            ranks=ranks.result(), local=local,
            ref={**steps.result(), **served.result()})


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _lanes(mesh, rank):
    d, m = (int(x) for x in mesh.split("x"))
    per = B // d
    return slice(rank // m * per, (rank // m + 1) * per)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_sharded_step_is_the_reference_and_local(case, mesh, runs):
    """Each rank's logits (its lanes) of the prefill and of each decode
    step against the reference's sharded step and ``--mesh local``; the
    ranks of a model group agree bit for bit."""
    m = int(mesh.split("x")[1])
    for rank, res in enumerate(runs.ranks):
        lanes = _lanes(mesh, rank)
        for i in range(STEPS + 1):
            got = res[f"{mesh}/{case}/logits{i}"]
            want = runs.ref[f"{mesh}/{case}/logits{i}"][lanes]
            assert _rel(got, want) <= STEP_TOL, (rank, i)
            assert _rel(got, runs.local[case][i][lanes]) <= STEP_TOL, (rank,
                                                                      i)
            peer = runs.ranks[rank - rank % m][f"{mesh}/{case}/logits{i}"]
            np.testing.assert_array_equal(got, peer)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_blocks_are_the_reference_addressable_shards(case, mesh, runs):
    """The parameter parts bit for bit, and the cache blocks after the
    steps within ``STEP_TOL``, the reference's shards of device ``r`` ↔
    rank ``r``."""
    for rank, res in enumerate(runs.ranks):
        pre = f"{mesh}/{case}"
        params = [k for k in res if k.startswith(f"{pre}/param")]
        caches = [k for k in res if k.startswith(f"{pre}/cache")]
        assert caches and (params or case not in ARCHS)
        for k in params:
            want = runs.ref[f"{pre}/param{rank}{k[len(pre) + 6:]}"]
            np.testing.assert_array_equal(res[k], want, err_msg=k)
        for k in caches:
            want = runs.ref[f"{pre}/cache{rank}{k[len(pre) + 6:]}"]
            assert res[k].shape == want.shape, k
            if res[k].dtype.kind == "f":
                err = np.abs(res[k] - want).max(initial=0.0)
                assert err <= STEP_TOL * max(np.abs(want).max(initial=0.0),
                                             1.0), k
            else:
                np.testing.assert_array_equal(res[k], want, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_the_compute_is_split(case, mesh, runs):
    """The ring's blocks and B8's partial entry on them, the mamba state's
    channels, and the widths the layers ran."""
    cfg = _config(case)
    m = int(mesh.split("x")[1])
    s = _cache_len(case)
    if cfg.swa_window:
        s = min(s, cfg.swa_window)
    for res in runs.ranks:
        pre = f"{mesh}/{case}"
        seen = {k.split("seen-")[1]: res[k].tolist()
                for k in res if k.startswith(f"{pre}/seen-")}
        # the decode steps; the decode scan prefills the other families
        calls = STEPS + (0 if cfg.family in ("dense", "moe") else PROMPT)
        # B8 calls a step: each self-attention layer, each cross one
        cross = (cfg.num_layers if cfg.is_encdec else
                 cfg.num_layers // cfg.cross_attn_period if cfg.is_vlm
                 else 0)
        rings = 0 if not cfg.num_heads else cfg.num_layers - (
            cross if cfg.is_vlm else 0)
        if rings:
            k = res[f"{pre}/cache['layers']['self']['k']" if cfg.is_vlm
                    else f"{pre}/cache['layers']['k']"]
            split = m > 1 and s % m == 0
            assert k.shape[-3] == (s // m if split else s)
            assert seen["partial_calls"] == [calls * (rings + cross)
                                             if split else 0]
            if split:
                assert s // m in seen["partial_slots"]
        if cfg.ssm_state:
            h = res[next(k for k in res if k.startswith(f"{pre}/cache")
                         and k.endswith("['h']"))]
            assert h.shape[-2] == cfg.d_inner // m
        if cfg.num_heads:
            want = cfg.num_heads // m if cfg.num_heads % m == 0 \
                else cfg.num_heads
            assert seen["heads"] == [want]
        if cfg.d_ff and not cfg.is_moe:
            assert seen["mlp"] == [cfg.d_ff // m]
        if cfg.is_moe:
            assert seen["experts"] == [cfg.num_experts // m]


def test_serve_rules_are_the_reference_make_rules(runs):
    """At the reference's limit, on a 2x2 mesh, at every arch's published
    widths: the same ZeRO-inference pick and ``ep_mode``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import sharding

    mesh = Mesh((2, 2), ("data", "model"))
    picks = set()
    for arch in ARCHS:
        rules = sharding.serve_rules(get_config(arch), mesh, limit=LIMIT)
        got = [rules.fsdp_axes is not None, rules.ep_mode]
        assert got == runs.ref[f"rules/{arch}"].tolist(), arch
        picks.add(got[0])
    assert picks == {True, False}          # both branches are held


@pytest.mark.parametrize("case", ZERO)
def test_zero_inference(case, runs):
    """A limit of one byte spreads the weights over the data axis too:
    each rank holds about half the bytes, and the logits are those of the
    model axis alone, bit for bit (the data group gathers them whole)."""
    for res in runs.ranks:
        pre = f"2x2/{case}"
        assert res[f"{pre}+zero/fsdp"].tolist() == [True]
        assert res[f"{pre}/fsdp"].tolist() == [False]
        assert res[f"{pre}+zero/bytes"] < 0.6 * res[f"{pre}/bytes"]
        for i in range(STEPS + 1):
            np.testing.assert_array_equal(res[f"{pre}+zero/logits{i}"],
                                          res[f"{pre}/logits{i}"])


@pytest.mark.parametrize("arch", list(SERVED))
def test_launch_serve_2x2_emits_the_reference_tokens(arch, runs):
    want = runs.ref[f"served/{arch}"]
    assert want.shape == (4, 4)
    for res in runs.ranks:
        np.testing.assert_array_equal(res[f"served/{arch}"], want)
    for res in runs.ranks:               # ZeRO-inference serves the same
        if arch == "llama3-8b":
            np.testing.assert_array_equal(res["served/llama3-8b+zero"], want)


@pytest.mark.parametrize("arch", DEMO)
def test_batch_demo_2x2_is_local(arch, runs):
    """``launch.serve``'s batched demo at ``2x2``: each data rank decodes
    its two lanes with its model group, and every rank returns the whole
    batch's tokens, ``--mesh local``'s."""
    from repro_torch.launch import serve
    want = serve.main(["--arch", arch] + DEMO_ARGV).numpy()
    assert want.shape == (B, 3)
    for res in runs.ranks:
        np.testing.assert_array_equal(res[f"demo/{arch}"], want)


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "whisper-tiny"])
def test_mesh_1x1_is_local_bit_for_bit(arch, tmp_path, monkeypatch):
    """``--mesh 1x1`` in a one-process gloo group: the steps' logits and
    the cache are ``--mesh local``'s bit for bit (every model-axis
    collective over one rank, B8's whole entry, no merge), and so are
    ``launch.serve``'s tokens."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", "0")
    want = _local(arch)
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        grid = mesh_mod.grid(mesh_mod.make_mesh("1x1"), "cpu")
        cfg, model, params = _serving(arch, "1x1", grid)
        assert model.ctx.model.size == 1
        got, _ = _run(model, params, cfg, model.ctx.gather.lanes(B), CACHE)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if arch in SERVED:
            argv = SERVED[arch] + SERVE_ARGV
            np.testing.assert_array_equal(_served(argv + ["--mesh", "1x1"]),
                                          _served(argv))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("plen", [3, 8, 13, 16, 19])
def test_a_lane_another_rank_prefilled_has_the_owners_slot_pos(plen):
    """A data rank that does not own an admitted lane writes its
    ``slot_pos`` block (``serve.engine._insert`` without a prefix) as the
    owner's chunked prefill leaves it, at 2x2 and 1x4 (each model rank's
    block of a ring of 8), for prompts shorter than the ring, as long, and
    longer, which wrap it: slot ``s`` holds the last position ``p < plen``
    with ``p % 8 == s``, or -1."""
    from repro_torch.models.transformer import Model, RunCtx
    from repro_torch.serve.engine import _insert, _prefill

    ring, slot, lanes = 8, 1, slice(2, 4)    # lane 1 is data rank 0's
    cfg = _config("llama3-8b")
    model = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, plen)).astype(np.int32))
    with torch.no_grad():
        prefix, _ = _prefill(model, params, prompt, cache_len=ring, chunk=4,
                             dtype=torch.float32)
    owner = prefix["layers"]["slot_pos"][:, 0].numpy()          # (L, 8)
    want = np.array([max((p for p in range(plen) if p % ring == s),
                         default=-1) for s in range(ring)])
    np.testing.assert_array_equal(owner, np.broadcast_to(want, owner.shape))
    for m in (2, 4):
        n = ring // m
        for r in range(m):
            cache = {"pos": torch.zeros(B, dtype=torch.int32),
                     "layers": {"slot_pos": torch.full(
                         (cfg.num_layers, B, n), -1, dtype=torch.int32)},
                     "whole": {"self": ring, "cross": 0, "batch": B}}
            tokens = torch.zeros((2, 1), dtype=torch.int32)
            _insert(cache, None, slot, None, tokens, lanes=lanes,
                    ring=torch.arange(r * n, (r + 1) * n, dtype=torch.int32),
                    plen=plen)
            np.testing.assert_array_equal(
                cache["layers"]["slot_pos"][:, slot].numpy(),
                owner[:, r * n:(r + 1) * n], err_msg=f"1x{m} rank {r}")
            assert int(cache["pos"][slot]) == plen


@pytest.mark.parametrize("spec,experts", [("pod", 8), ("multipod", 8),
                                          ("1x8", 4)])
def test_production_meshes_and_tp_local_serve(spec, experts, tmp_path,
                                              monkeypatch):
    """The production meshes, and an MoE config with fewer experts than
    the model axis (the reference's tp_local split), are served:
    ``serve_mesh`` gives the reference's mesh, whose serve rule leaves
    ``ep_mode`` off where the experts are fewer, and in a one-process
    group ``launch.serve`` refuses the world of one, not the mesh."""
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.runtime import sharding
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", "0")
    cfg = dataclasses.replace(_config("mixtral-8x22b"), num_experts=experts)
    mesh = serve.serve_mesh(spec)
    m = mesh.shape["model"]
    assert mesh.size == {"pod": 256, "multipod": 512, "1x8": 8}[spec]
    rules = sharding.serve_rules(cfg, mesh, limit=LIMIT)
    assert rules.ep_mode == (experts >= m)
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        with pytest.raises(ValueError, match="process group has 1"):
            serve.main(["--arch", "mixtral-8x22b", "--mesh", spec]
                       + SERVE_ARGV + (["--experts", "4"] if experts == 4
                                       else []))
    finally:
        dist.destroy_process_group()


def test_seq_parallel_refuses_names_a22c_d():
    """``seq_parallel`` (the reference's activation constraint, which no
    entry point sets) still refuses, naming ROADMAP A22c (d);
    ``opt_fsdp_axes`` places the optimizer state."""
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import sharding

    rules = sharding.serve_rules(_config("llama3-8b"),
                                 Mesh((1, 1), ("data", "model")))
    with pytest.raises(NotImplementedError, match=r"ROADMAP A22c \(d\)"):
        sharding.make_gather(dataclasses.replace(rules, seq_parallel=True),
                             LoopbackComm(1, device="cpu"))
    gather = sharding.make_gather(dataclasses.replace(
        rules, opt_fsdp_axes="data"), LoopbackComm(1, device="cpu"))
    assert gather.odims == {}


if __name__ == "__main__":
    if sys.argv[1] == "jax-steps":
        _jax_steps(sys.argv[2])
    elif sys.argv[1] == "jax-serve":
        _jax_serve(sys.argv[2])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                sys.argv[4])
