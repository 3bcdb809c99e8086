"""The port's sharding rules and mesh grammar against the reference's.

For every registered config, reduced and at its published size, on the
meshes (8,), (4, 2), (2, 2), (2, 4), (16, 16) and (2, 16, 16), under FSDP over the data
axes or none, ``opt_fsdp_axes`` set or not and ``ep_mode`` on and off:
the spec of every parameter, optimizer-state and decode-cache leaf, and
of batches, equals the reference's ``ShardingRules``.  The reference runs
on a ``jax.sharding.AbstractMesh`` (no devices) over ``jax.eval_shape``'d
trees, and its ``NamedSharding.spec`` is compared entry by entry.  The
port's rules read the same trees' shapes and paths; for the reduced
configs the port's own parameter, optimizer and cache trees are first
held to the reference's paths and shapes.  On (8,), with no model axis,
both tables refuse a parameter or cache rule that names one (KeyError).
At ``launch.train --mesh DxM``'s 2 x 2, 2 x 4 and 4 x 2, the port's
``data_dim``/``model_dim`` of every leaf and the block cut over both axes
are the reference's spec and shard shape.

``launch.mesh.make_mesh`` against ``repro.launch.train.make_mesh``: the
same axis names and sizes for every spec of the grammar (the reference's
mesh constructor captured, since this process has one device).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import compat
from repro.configs import registry as jregistry
from repro.launch import train as jtrain
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro.optim.adamw import AdamW as JAdamW
from repro.runtime import sharding as jsh
from repro_torch.configs import registry as tregistry
from repro_torch.launch import mesh as tmesh
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import sharding as tsh

MESHES = [((8,), ("data",)), ((4, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CASES = [(name, reduced) for name in jregistry.ARCH_NAMES
         for reduced in (True, False)]


def _cross_len(cfg):
    return 8 if (cfg.is_encdec or cfg.is_vlm) else 0


@functools.lru_cache(maxsize=None)
def _jax_trees(name, reduced):
    """The reference's parameter, AdamW-state and cache shapes."""
    cfg = jregistry.get_config(name, reduced=reduced)
    model = JModel(cfg, JRunCtx(act_dtype=jnp.float32))
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    opt = jax.eval_shape(lambda: JAdamW(lr=1e-3).init(params))
    cache = jax.eval_shape(lambda: model.init_cache(
        4, 64, cross_len=_cross_len(cfg)))
    return params, opt, cache


def _flat_jax(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree, keys=()):
    """A tree of nested dicts as ``{path: leaf}``, paths as keystr's."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, keys + (k,)))
        return out
    return {tsh.path_str(keys): tree}


def _shapes(flat):
    return {k: tuple(v.shape) for k, v in flat.items()}


def _variants(names):
    dp = ("pod", "data") if "pod" in names else "data"
    for fsdp in (None, "data", dp):
        for opt in (None, dp):
            for ep in (False, True):
                yield dict(fsdp_axes=fsdp, opt_fsdp_axes=opt, ep_mode=ep)


@pytest.mark.parametrize("name,reduced", CASES)
def test_specs_equal_the_reference(name, reduced):
    params, opt, cache = _jax_trees(name, reduced)
    flat = {"params": _flat_jax(params), "opt": _flat_jax(opt),
            "cache": _flat_jax(cache)}
    if reduced:
        # the port's own trees: the reference's paths and shapes
        cfg = tregistry.get_config(name, reduced=True)
        tm = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
        tp = tm.init_params(torch.Generator().manual_seed(0), master=True)
        mine = {"params": _flat(tp), "opt": _flat(AdamW(lr=1e-3).init(tp)),
                "cache": _flat(tm.init_cache(
                    4, 64, cross_len=_cross_len(cfg),
                    dtype=torch.float32))}
        for k in flat:
            assert _shapes(mine[k]) == _shapes(flat[k]), k
    # the eval_shape'd trees are nested dicts: the port's rules take them
    trees = {"params": params, "opt": opt, "cache": cache}
    for shape, names in MESHES:
        mesh = AbstractMesh(shape, names)
        tmesh_ = tmesh.Mesh(shape, names)
        for kw in _variants(names):
            jr = jsh.ShardingRules(mesh=mesh, **kw)
            tr = tsh.ShardingRules(mesh=tmesh_, **kw)
            for b in ((256, 4096), (6, 128), (1,)):
                assert tsh.batch_spec(tr, b) == tuple(
                    jsh.batch_sharding(jr, b).spec), (b, kw)
            for what, tree in trees.items():
                port = (tsh.cache_specs if what == "cache"
                        else tsh.param_specs)
                ref = (jsh.cache_shardings if what == "cache"
                       else jsh.param_shardings)
                if "model" not in names:
                    with pytest.raises(KeyError):
                        ref(jr, tree)
                    with pytest.raises(KeyError):
                        port(tr, tree)
                    continue
                want = {p: tuple(s.spec) for p, s in
                        _flat_jax(ref(jr, tree)).items()}
                assert _flat(port(tr, tree)) == want, (what, shape, kw)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 2)])
@pytest.mark.parametrize("name,reduced", CASES)
def test_model_dim_and_the_2d_cut_are_the_reference_specs(name, reduced,
                                                          shape):
    """``launch.train --mesh DxM``'s rules (``fsdp_rules``: ``ep_mode``
    where the experts are at least M): every parameter and AdamW leaf's
    ``data_dim`` and ``model_dim`` are where the reference's spec names
    ``data`` and ``model``, and the block that ``take`` cuts over both
    axes has the reference's shard shape (``NamedSharding.shard_shape``
    on the abstract mesh)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from repro_torch.launch import train as ttrain

    params, opt, _ = _jax_trees(name, reduced)
    cfg = tregistry.get_config(name, reduced=reduced)
    d, m = shape
    mesh = AbstractMesh(shape, ("data", "model"))
    jr = jsh.ShardingRules(mesh=mesh, fsdp_axes="data",
                           ep_mode=cfg.is_moe and cfg.num_experts >= m)
    tr = ttrain.fsdp_rules(cfg, d, m)
    assert tr.ep_mode == jr.ep_mode and tr.mesh.shape == dict(mesh.shape)
    tree = {"params": params, "opt": opt}
    specs = _flat_jax(jsh.param_shardings(jr, tree))
    for path, leaf in _flat_jax(tree).items():
        spec = tuple(specs[path].spec)
        spec += (None,) * (len(leaf.shape) - len(spec))
        for axis, fn in (("data", tsh.data_dim), ("model", tsh.model_dim)):
            at = [i - len(spec) for i, a in enumerate(spec) if a == axis]
            assert fn(tr, path, leaf.shape) == (at[0] if at else None), (
                path, axis)
        t = torch.empty(leaf.shape, device="meta")
        cut = tsh.take(tsh.take(t, tsh.model_dim(tr, path, leaf.shape),
                                m - 1, m),
                       tsh.data_dim(tr, path, leaf.shape), d - 1, d)
        want = NamedSharding(mesh, PartitionSpec(*spec)).shard_shape(
            leaf.shape)
        assert tuple(cut.shape) == tuple(want), path


MESH_SPECS = ["local", "pod", "16x16", "multipod", "2x16x16", "8", "4x2",
              "2x1", "1"]


@pytest.mark.parametrize("spec", MESH_SPECS)
def test_mesh_grammar_is_the_reference(spec, monkeypatch):
    made = []

    def capture(shape, axes, axis_types=None):
        made.append((tuple(shape), tuple(axes)))
        return AbstractMesh(tuple(shape), tuple(axes))

    monkeypatch.setattr(compat, "make_mesh", capture)
    jtrain.make_mesh(spec)
    mesh = tmesh.make_mesh(spec)
    assert [(mesh.axis_sizes, mesh.axis_names)] == made
    assert mesh.shape == dict(zip(*made[0][::-1]))


def test_mesh_refuses_what_the_grammar_lacks():
    with pytest.raises(ValueError):
        tmesh.make_mesh("data")
    with pytest.raises(ValueError):
        tmesh.make_mesh("2x2x2")      # three axes need the pod spelling
