"""Sharding rules: the parameter, batch and cache layouts of every family.

The reference's rule table (``repro.runtime.sharding``) as plain Python
over a mesh shape: ``mesh.shape`` maps each axis name to its size
(``launch.mesh.Mesh``), and a spec is a tuple with one entry a dimension,
``None`` (replicated), an axis name or a tuple of axis names (the
reference's ``PartitionSpec`` entries).

Principles, as the reference's:
  * train: FSDP over the data axes (("pod","data") when multi-pod) + tensor
    parallel over "model"; every 2D weight is sharded on both of its dims.
  * decode KV caches: batch over data axes, sequence over "model"
    (flash-decoding layout — the only layout divisible for GQA kv_heads <
    model-axis size).
  * every spec passes through ``fit_spec``, which drops axes that do not
    divide the dimension (replication instead of an error).

The rules match name patterns on the parameter's path, written as the
reference writes it (``['layers']['attn']['wq']['w']``), with any number
of stacked leading dims (layers, vlm groups) skipped.

The port's trainer runs the data axis (``launch.train --mesh D``): FSDP
storage sharding.  At ``--mesh D`` it builds the reference's rules
(``fsdp_axes="data"``, ``ep_mode`` for an MoE config, no
``opt_fsdp_axes``) on the ``D x 1`` mesh: the rule table names the model
axis, which a one-axis mesh lacks (the reference's ``--mesh D`` raises a
``KeyError`` in ``param_shardings``; its ``--mesh Dx1`` is this
placement).  At ``--mesh DxM`` the rules are the ``D x M`` mesh's, and a
rank keeps the block of a leaf at its place ``(d, m)`` over both axes.
``data_dim`` and ``model_dim`` read which dimension of a leaf each axis
splits, ``take`` cuts a rank's part, and ``make_gather`` gives the hook
that stands where the reference's ``make_constrain`` tags activations for
XLA's partitioner: eager PyTorch has no partitioner, so each layer's
weights are all-gathered over the data group where they are computed and
their gradients reduce-scattered in rank order (``_GatherFn``); a layer
then computes with its model-axis part (``runtime.model_axis``).
``batch_spec`` gives each rank its rows.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch

__all__ = ["ShardingRules", "fit_spec", "param_specs", "batch_spec",
           "cache_specs", "path_str", "data_dim", "data_dims", "model_dim",
           "model_dims", "take",
           "take_tree", "Gather", "make_gather", "Placed"]


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def fit_spec(mesh, shape, spec: tuple) -> tuple:
    """Drop spec axes that don't divide their dim (replicate instead)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, parts):
        if axes is not None and dim % _axes_size(mesh, axes) != 0:
            axes = None
        out.append(axes)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                 # anything with .shape: {axis: size}
    fsdp_axes: Any            # e.g. ("pod","data") or "data" or None
    tp_axis: str = "model"
    ep_mode: bool = False     # expert-parallel MoE (experts on tp axis)
    seq_parallel: bool = False  # the reference's activation constraint only
    opt_fsdp_axes: Any = None   # distinct FSDP axes for optimizer state
    # (master/m/v): hierarchical ZeRO, as the reference's
    ep_axes: Any = None         # expert-parallel axes (default: tp_axis)

    @property
    def dp_axes(self):
        """axes that shard the batch — always the full data parallelism
        (pod+data when multi-pod), independent of how far the *weights*
        spread (fsdp_axes)."""
        return ("pod", "data") if "pod" in self.mesh.shape else "data"

    # ---- rule table: pattern over the LAST dims of the param ----
    def _rules(self):
        fs, tp = self.fsdp_axes, self.tp_axis
        ep = self.ep_axes if self.ep_axes is not None else tp
        # fsdp axes used on expert weights must not collide with ep axes
        ep_set = {ep} if isinstance(ep, str) else set(ep)
        fs_moe = fs
        if fs is not None and not isinstance(fs, str):
            fs_moe = tuple(a for a in fs if a not in ep_set) or None
        elif isinstance(fs, str) and fs in ep_set:
            fs_moe = None
        moe_w1 = (ep, fs_moe, None) if self.ep_mode else (None, fs, tp)
        moe_w2 = (ep, None, fs_moe) if self.ep_mode else (None, tp, fs)
        return [
            (r"embed.*\['w'\]", (tp, fs)),           # (V, D) vocab-sharded
            (r"lm_head.*\['w'\]", (fs, tp)),         # (D, V)
            (r"\['moe'\].*\['w1'\]", moe_w1),        # (E, D, F)
            (r"\['moe'\].*\['w3'\]", moe_w1),
            (r"\['moe'\].*\['w2'\]", moe_w2),        # (E, F, D)
            (r"\['router'\].*\['w'\]", (fs, None)),  # (D, E)
            (r"\['(wq|wk|wv)'\].*\['w'\]", (fs, tp)),
            (r"\['(wq|wk|wv)'\].*\['b'\]", (tp,)),
            (r"\['wo'\]\['w'\]", (tp, fs)),
            (r"\['w1'\]\['w'\]", (fs, tp)),          # mlp (D, F)
            (r"\['w3'\]\['w'\]", (fs, tp)),
            (r"\['w2'\]\['w'\]", (tp, fs)),          # mlp (F, D)
            (r"\['in_proj'\]\['w'\]", (fs, tp)),     # ssm (D, 2di)
            (r"\['conv_w'\]", (None, tp)),           # (K, di)
            (r"\['conv_b'\]", (tp,)),
            (r"\['x_proj'\]\['w'\]", (tp, None)),    # (di, dr+2st)
            (r"\['dt_proj'\]\['w'\]", (None, tp)),   # (dr, di)
            (r"\['dt_proj'\]\['b'\]", (tp,)),
            (r"\['a_log'\]", (tp, None)),            # (di, st)
            (r"\['d_skip'\]", (tp,)),
            (r"\['out_proj'\]\['w'\]", (tp, fs)),    # (di, D)
        ]

    def spec_for(self, path: str, shape) -> tuple:
        for pat, rule in self._rules():
            if re.search(pat, path):
                lead = len(shape) - len(rule)
                return fit_spec(self.mesh, shape, (None,) * lead + rule)
        return ()  # norms, biases, scalars: replicate


def path_str(keys) -> str:
    """A leaf's path as the reference's ``jax.tree_util.keystr`` writes a
    dict path: ``['layers']['attn']``."""
    return "".join(f"[{k!r}]" for k in keys)


def _map_with_path(fn, tree, keys=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, keys + (k,))
                for k, v in tree.items()}
    return fn(path_str(keys), tree)


def param_specs(rules: ShardingRules, params):
    """The spec of every leaf of a parameter (or optimizer-state) tree of
    nested dicts; a leaf is anything with ``.shape``.

    When ``opt_fsdp_axes`` is set, leaves under an optimizer-state subtree
    (path starts with 'master'/'m'/'v') use those axes instead
    (hierarchical ZeRO: optimizer spreads wider than the compute copy)."""
    opt_rules = (dataclasses.replace(rules, fsdp_axes=rules.opt_fsdp_axes)
                 if rules.opt_fsdp_axes is not None else None)

    def one(path, leaf):
        r = rules
        if opt_rules is not None and re.match(r"^\['(master|m|v)'\]", path):
            r = opt_rules
        return r.spec_for(path, tuple(leaf.shape))

    return _map_with_path(one, params)


def batch_spec(rules: ShardingRules, shape) -> tuple:
    """A batch's rows over the data axes (replicated if they don't
    divide)."""
    return fit_spec(rules.mesh, shape, (rules.dp_axes,))


def cache_specs(rules: ShardingRules, cache):
    """Decode caches: batch->dp, seq->tp (flash-decoding layout); SSM state
    channel dim -> tp."""
    mesh, dp, tp = rules.mesh, rules.dp_axes, rules.tp_axis

    def one(path, leaf):
        nd = len(leaf.shape)
        if re.search(r"\['(k|v|cross_k|cross_v)'\]", path):
            # (..., B, S, H, hd)
            spec = (None,) * (nd - 4) + (dp, tp, None, None)
        elif re.search(r"\['h'\]", path):       # ssm state (..., B, di, st)
            spec = (None,) * (nd - 3) + (dp, tp, None)
        elif re.search(r"\['conv'\]", path):    # (..., B, K-1, di)
            spec = (None,) * (nd - 3) + (dp, None, tp)
        elif re.search(r"\['slot_pos'\]", path):  # (..., S)
            spec = (None,) * (nd - 1) + (tp,)
        else:                                   # pos scalar etc.
            spec = ()
        return fit_spec(mesh, tuple(leaf.shape), spec)

    return _map_with_path(one, cache)


# ---------------------------------------------------------------------------
# FSDP placement over the data axes
# ---------------------------------------------------------------------------

def _names(axes) -> set:
    if axes is None:
        return set()
    return {axes} if isinstance(axes, str) else set(axes)


def _axis_dim(spec, names: set) -> int | None:
    for i, axes in enumerate(spec):
        if _names(axes) & names:
            return i - len(spec)
    return None


def data_dim(rules: ShardingRules, path: str, shape) -> int | None:
    """The dimension of a leaf of whole ``shape`` at ``path`` that
    ``rules``' FSDP axes split, counted from the end (so a layer of a
    stacked leaf has its stack's), or None where the leaf stays whole."""
    return _axis_dim(rules.spec_for(path, tuple(shape)),
                     _names(rules.fsdp_axes))


def data_dims(rules: ShardingRules, tree):
    """``data_dim`` of every leaf of a tree of whole leaves."""
    return _map_with_path(lambda path, leaf: data_dim(rules, path,
                                                      leaf.shape), tree)


def model_dim(rules: ShardingRules, path: str, shape) -> int | None:
    """``data_dim``'s counterpart for the model axis (``tp_axis``, and the
    expert-parallel axes of an MoE layer's expert weights)."""
    names = _names(rules.tp_axis) | _names(rules.ep_axes)
    return _axis_dim(rules.spec_for(path, tuple(shape)), names)


def model_dims(rules: ShardingRules, tree):
    """``model_dim`` of every leaf of a tree of whole leaves."""
    return _map_with_path(lambda path, leaf: model_dim(rules, path,
                                                       leaf.shape), tree)


def take(t: torch.Tensor, dim: int | None, rank: int, parts: int):
    """Rank ``rank``'s part of ``t`` along ``dim`` (``parts`` equal parts,
    in rank order) in storage of its own, so that the whole is freed; ``t``
    itself where ``dim`` is None."""
    if dim is None:
        return t
    n = t.shape[dim] // parts
    return t.narrow(dim, rank * n, n).clone(
        memory_format=torch.contiguous_format)


def _zip(fn, tree, dims):
    """``fn(leaf, dim)`` over a tree and its dims (the tree's keys)."""
    if isinstance(tree, dict):
        return {k: _zip(fn, v, dims[k]) for k, v in tree.items()}
    return fn(tree, dims)


def take_tree(tree, dims, rank: int, parts: int):
    """``take`` of every leaf."""
    return _zip(lambda t, d: take(t, d, rank, parts), tree, dims)


def _gathered(comm, shards, dims):
    """Each shard all-gathered whole (its data dim ``parts`` times
    longer, the ranks' parts in order): one flat ``all_gather`` a dtype."""
    p, out = comm.p, [None] * len(shards)
    for dtype in dict.fromkeys(s.dtype for s in shards):
        idx = [i for i, s in enumerate(shards) if s.dtype == dtype]
        flat = torch.cat([shards[i].reshape(-1) for i in idx])[None]
        got = comm.all_gather(flat).wait().view(p, -1)
        off = 0
        for i in idx:
            s = shards[i]
            d = dims[i] % s.dim()
            whole = list(s.shape)
            whole[d] *= p
            out[i] = got[:, off:off + s.numel()].reshape(
                (p,) + tuple(s.shape)).movedim(0, d).reshape(whole)
            off += s.numel()
    return out


def _scattered(comm, grads, dims):
    """Each whole gradient reduce-scattered to this rank's part, the ranks
    summed in ascending order: one flat ``reduce_scatter`` a dtype."""
    p, out = comm.p, [None] * len(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        rows = []
        for i in idx:
            g = grads[i]
            d = dims[i] % g.dim()
            split = g.shape[:d] + (p, g.shape[d] // p) + g.shape[d + 1:]
            rows.append(g.reshape(split).movedim(d, 0).reshape(p, -1))
        got = comm.reduce_scatter(torch.cat(rows, 1).reshape(1, -1)).wait()
        for i, part in zip(idx, got[0].split([r.shape[1] for r in rows])):
            g = grads[i]
            d = dims[i] % g.dim()
            shape = list(g.shape)
            shape[d] //= p
            out[i] = part.view(shape)
    return out


class _GatherFn(torch.autograd.Function):
    """Shards -> whole weights (``_gathered``), cast to ``dtype`` first
    when one is given; backward: the whole weights' gradients, cast back
    to each shard's dtype (a float32 master's gradient is summed in
    float32, as the replicated path's is), ``_scattered``."""

    @staticmethod
    def forward(ctx, comm, dims, dtype, *shards):
        ctx.comm, ctx.dims = comm, dims
        ctx.dtypes = [s.dtype for s in shards]
        if dtype is not None:
            shards = [s.to(dtype) if s.is_floating_point() else s
                      for s in shards]
        return tuple(_gathered(comm, shards, dims))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.to(dt) for g, dt in zip(grads, ctx.dtypes)]
        return (None, None, None) + tuple(_scattered(ctx.comm, grads,
                                                     ctx.dims))


def _flat(tree, dims, keys=()):
    """``(keys, leaf, dim)`` of a tree and its dims, in the tree's order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _flat(v, dims[k], keys + (k,))]
    return [(keys, tree, dims)]


def _at(tree, keys):
    """The subtree of ``tree`` at ``keys``."""
    for k in keys:
        tree = tree[k]
    return tree


def _rebuild(tree, values, keys=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, keys + (k,)) for k, v in tree.items()}
    return values[keys]


class Gather:
    """``make_gather``'s hook: rank ``rank`` of ``parts`` over ``comm``
    (the data group, one rank a process), FSDP over ``rules``' data axes,
    and with ``model`` (a ``runtime.model_axis.ModelAxis`` over the model
    group) the model axis's part of each leaf too.

    ``keep(keys, t, shape)`` is ``Model.init_params``'s: the rank's part
    of a leaf at ``keys`` whose whole shape is ``shape`` (a block of a
    stacked leaf passes the stack's shape), its block over the model axis
    and then over the data axis, recording the leaf's data dim in
    ``dims`` and its model dim in ``mdims``, trees like the parameters'.
    ``gather(tree, keys, dtype)`` (the hook, ``RunCtx.gather``) gives a
    subtree of shards at ``keys`` of the parameter tree (one layer of a
    stack too) whole over the data group: the split leaves through
    ``_GatherFn``, one all-gather a dtype, the others as they are; each
    leaf keeps its model-axis part, with which the layer computes.
    ``whole`` and ``part`` assemble and cut one leaf outside autograd (the
    global norm, checkpoints): over the data group first, then over the
    model group."""

    def __init__(self, rules: ShardingRules, comm, model=None):
        if rules.opt_fsdp_axes is not None:
            raise NotImplementedError(
                "opt_fsdp_axes: the optimizer state is placed as the "
                "parameters (ROADMAP A22b)")
        if comm.p_local != 1:
            raise ValueError("FSDP holds one rank a process")
        size = _axes_size(rules.mesh, rules.fsdp_axes)
        if size != comm.p:
            raise ValueError(f"the FSDP axes span {size} ranks; the "
                             f"communicator has {comm.p}")
        msize = _axes_size(rules.mesh, rules.tp_axis) \
            if rules.tp_axis in rules.mesh.shape else 1
        if model is not None and model.size != msize:
            raise ValueError(f"the model axis spans {msize} ranks; the "
                             f"model group has {model.size}")
        self.rules, self.comm, self.model = rules, comm, model
        self.rank, self.parts = comm.rank_offset, comm.p
        self.dims: dict = {}
        self.mdims: dict | None = {} if model is not None else None

    @staticmethod
    def _record(tree, keys, d):
        for k in keys[:-1]:
            tree = tree.setdefault(k, {})
        tree[keys[-1]] = d

    def keep(self, keys, t: torch.Tensor, shape=None) -> torch.Tensor:
        path = path_str(keys)
        shape = t.shape if shape is None else shape
        d = data_dim(self.rules, path, shape)
        self._record(self.dims, keys, d)
        if self.model is not None:
            md = model_dim(self.rules, path, shape)
            self._record(self.mdims, keys, md)
            t = take(t, md, self.model.rank, self.model.size)
        return take(t, d, self.rank, self.parts)

    def at(self, keys):
        """The dims of the subtree at ``keys``."""
        return _at(self.dims, keys)

    def __call__(self, tree, keys=(), dtype=None):
        flat = _flat(tree, self.at(keys))
        split = [(k, t, d) for k, t, d in flat if d is not None]
        values = {k: (t.to(dtype) if dtype is not None
                      and t.is_floating_point() else t)
                  for k, t, d in flat if d is None}
        if split:
            wholes = _GatherFn.apply(self.comm, [d for _, _, d in split],
                                     dtype, *[t for _, t, _ in split])
            values.update(zip([k for k, _, _ in split], wholes))
        return _rebuild(tree, values)

    def whole(self, t: torch.Tensor, dim: int | None,
              mdim: int | None = None) -> torch.Tensor:
        """One leaf whole (a collective where it is split): over the data
        group along ``dim``, then over the model group along ``mdim``."""
        with torch.no_grad():
            if dim is not None:
                t = _gathered(self.comm, [t], [dim])[0]
            if mdim is not None:
                t = _gathered(self.model.comm, [t], [mdim])[0]
        return t

    def part(self, t: torch.Tensor, dim: int | None,
             mdim: int | None = None) -> torch.Tensor:
        if mdim is not None:
            t = take(t, mdim, self.model.rank, self.model.size)
        return take(t, dim, self.rank, self.parts)

    @property
    def writer(self) -> bool:
        """Rank 0 of the mesh: rank 0 of its data group and of its model
        group."""
        return self.rank == 0 and (self.model is None
                                   or self.model.rank == 0)


def make_gather(rules: ShardingRules, comm, model=None) -> Gather:
    """The FSDP hook of ``rules`` over ``comm`` (``Gather``), with
    ``model`` the model axis's: the port's counterpart of the reference's
    ``make_constrain``."""
    return Gather(rules, comm, model)


@dataclasses.dataclass(frozen=True)
class Placed:
    """A tree of this rank's parts: ``dims`` its data dims (a tree like
    it), ``mdims`` its model dims (None without a model axis), ``gather``
    the hook that placed it.  ``whole(keys, leaf)`` and ``part(keys, t)``
    assemble and cut the leaf at ``keys`` over both axes; rank 0 of the
    mesh writes what is assembled (``writer``)."""

    gather: Gather
    dims: Any
    mdims: Any = None

    def _dims(self, keys):
        return (_at(self.dims, keys),
                None if self.mdims is None else _at(self.mdims, keys))

    def whole(self, keys, leaf):
        return self.gather.whole(leaf, *self._dims(keys))

    def part(self, keys, t):
        return self.gather.part(t, *self._dims(keys))

    @property
    def writer(self) -> bool:
        return self.gather.writer
