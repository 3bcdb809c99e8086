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
On a ``pod x data x model`` mesh (``--mesh multipod``) the train rules
keep FSDP on ``"data"``: a rank keeps the block of its ``(d, m)`` on
every pod, the batch splits over ``dp_axes = ("pod", "data")`` (the
batch group), and a split leaf's gradient is summed over the batch group
by the HSDP reduction (``_scattered``'s ``hier``: a reduce-scatter over
the batch group, then an all-gather over the pod group).
``opt_fsdp_axes`` (the reference's hierarchical ZeRO) keeps the
optimizer state at its block over those axes (``Gather.odims``; the
update's blocks moved out of the parts and back by ``Gather.to_wide`` and
``from_wide``).
``data_dim`` and ``model_dim`` read which dimension of a leaf each axis
splits, ``take`` cuts a rank's part, and ``make_gather`` gives the hook
that stands where the reference's ``make_constrain`` tags activations for
XLA's partitioner: eager PyTorch has no partitioner, so each layer's
weights are all-gathered over the data group where they are computed and
their gradients reduce-scattered in rank order (``_GatherFn``); a layer
then computes with its model-axis part (``runtime.model_axis``).
``batch_spec`` gives each rank its rows.

Serving (``launch.serve --mesh DxM``) places the weights by the
reference's serve rule (``serve_rules``, the serve branch of its
``launch/dryrun.py`` ``make_rules``): over the model axis only, and over
the data axis too (ZeRO-inference) only when a model-axis part would not
fit; and the decode caches by ``cache_specs`` (``cache_dim`` reads which
dimension each axis splits, ``Gather.cache_shape`` and ``cache_part``
give a rank's block, ``cache_whole`` assembles one).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any

import torch

__all__ = ["ShardingRules", "fit_spec", "param_specs", "batch_spec",
           "cache_specs", "cache_spec", "cache_dim", "path_str", "data_dim",
           "data_dims", "model_dim", "model_dims", "take", "take_tree",
           "gathered", "Gather", "make_gather", "Placed", "SERVE_RESIDENCY_LIMIT",
           "SERVE_MEMORY_FRACTION", "serving_bytes", "serve_limit",
           "serve_rules", "axis_names", "block_shape", "OPT_STATE_KEYS",
           "tree_zip"]

# the optimizer-state subtrees that ``opt_fsdp_axes`` places
OPT_STATE_KEYS = ("master", "m", "v")

# The reference's bytes a device of serving weights may hold before its
# serve rule spreads them over the data axis too (ZeRO-inference): a TPU's
# figure (``launch/dryrun.py``), which the tests pass to hold the rule to
# the reference's.  On the card the limit is this share of the card's own
# memory (the rest holds the caches and the activations).
SERVE_RESIDENCY_LIMIT = 12e9
SERVE_MEMORY_FRACTION = 0.5


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


def cache_spec(rules: ShardingRules, path: str, shape) -> tuple:
    """The spec of one cache leaf of whole ``shape`` at ``path``: batch
    over the data axes, sequence over the model axis (the flash-decoding
    layout), the SSM state's and conv window's channels over the model
    axis."""
    dp, tp = rules.dp_axes, rules.tp_axis
    nd = len(shape)
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
    return fit_spec(rules.mesh, tuple(shape), spec)


def cache_specs(rules: ShardingRules, cache):
    """Decode caches: batch->dp, seq->tp (flash-decoding layout); SSM state
    channel dim -> tp."""
    return _map_with_path(lambda path, leaf: cache_spec(
        rules, path, tuple(leaf.shape)), cache)


def cache_dim(rules: ShardingRules, path: str, shape, axis: str):
    """The dimension of a cache leaf (counted from the end) that the data
    axes (``axis="data"``) or the model axis (``"model"``) split, or
    None."""
    names = (axis_names(rules.dp_axes) if axis == "data"
             else axis_names(rules.tp_axis))
    return _axis_dim(cache_spec(rules, path, shape), names)


# ---------------------------------------------------------------------------
# FSDP placement over the data axes
# ---------------------------------------------------------------------------

def axis_names(axes) -> set:
    """The axis names of a spec entry (None, a name or a tuple)."""
    if axes is None:
        return set()
    return {axes} if isinstance(axes, str) else set(axes)


def _axis_dim(spec, names: set) -> int | None:
    for i, axes in enumerate(spec):
        if axis_names(axes) & names:
            return i - len(spec)
    return None


def block_shape(rules: ShardingRules, spec, shape) -> tuple:
    """The shape of a rank's block of a leaf of whole ``shape`` under
    ``spec`` (``param_specs``' or ``cache_specs``'): each dimension over
    the size of the axes that split it."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _axes_size(rules.mesh, a) for n, a in zip(shape,
                                                                  spec))


def data_dim(rules: ShardingRules, path: str, shape) -> int | None:
    """The dimension of a leaf of whole ``shape`` at ``path`` that
    ``rules``' FSDP axes split, counted from the end (so a layer of a
    stacked leaf has its stack's), or None where the leaf stays whole."""
    return _axis_dim(rules.spec_for(path, tuple(shape)),
                     axis_names(rules.fsdp_axes))


def data_dims(rules: ShardingRules, tree):
    """``data_dim`` of every leaf of a tree of whole leaves."""
    return _map_with_path(lambda path, leaf: data_dim(rules, path,
                                                      leaf.shape), tree)


def model_dim(rules: ShardingRules, path: str, shape) -> int | None:
    """``data_dim``'s counterpart for the model axis (``tp_axis``, and the
    expert-parallel axes of an MoE layer's expert weights)."""
    names = axis_names(rules.tp_axis) | axis_names(rules.ep_axes)
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


def tree_zip(fn, tree, *rest):
    """``fn(leaf, *others)`` over a tree of nested dicts and trees like it
    (its dims: their leaves may be None), keyed by the tree's keys."""
    if isinstance(tree, dict):
        return {k: tree_zip(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def take_tree(tree, dims, rank: int, parts: int):
    """``take`` of every leaf."""
    return tree_zip(lambda t, d: take(t, d, rank, parts), tree, dims)


def gathered(comm, shards, dims):
    """Each of this rank's tensors ``shards`` all-gathered over ``comm``
    along its dim in ``dims`` (that dim ``comm.p`` times longer, the
    ranks' parts in rank order): one flat ``all_gather`` a dtype.  The
    weights' gathers, the model axis's (``ModelAxis.gather_all``) and the
    serving paths' gathers of tokens and routings over a data group."""
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


def _scattered(comm, grads, dims, hier=None):
    """Each whole gradient reduce-scattered to this rank's part over
    ``comm``, the ranks summed in ascending order: one flat
    ``reduce_scatter`` a dtype.

    ``hier = (batch, pod)`` (HSDP: the parts replicated over ``P`` pods,
    ``comm`` the data group of ``D`` ranks): the sum runs over the ``P·D``
    ranks of the batch group, in its order ``p·D + d``.  Each rank's flat
    part row (padded to a multiple of ``P``) is cut into ``P`` pieces;
    batch rank ``p·D + d`` receives piece ``p`` of data part ``d`` summed
    (one ``reduce_scatter`` over the batch group), and the pod group
    all-gathers the ``P`` pieces back into the part (one ``all_gather``)."""
    p, out = comm.p, [None] * len(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        rows = []
        for i in idx:
            g = grads[i]
            d = dims[i] % g.dim()
            split = g.shape[:d] + (p, g.shape[d] // p) + g.shape[d + 1:]
            rows.append(g.reshape(split).movedim(d, 0).reshape(p, -1))
        flat = torch.cat(rows, 1)
        if hier is None:
            got = comm.reduce_scatter(flat.reshape(1, -1)).wait()[0]
        else:
            batch, pod = hier
            n, pods = flat.shape[1], pod.p
            c = -(-n // pods)
            flat = torch.nn.functional.pad(flat, (0, c * pods - n))
            send = flat.view(p, pods, c).transpose(0, 1).reshape(1, -1)
            piece = batch.reduce_scatter(send).wait()
            got = pod.all_gather(piece).wait()[0, :n]
        for i, part in zip(idx, got.split([r.shape[1] for r in rows])):
            g = grads[i]
            d = dims[i] % g.dim()
            shape = list(g.shape)
            shape[d] //= p
            out[i] = part.view(shape)
    return out


class _GatherFn(torch.autograd.Function):
    """Shards -> whole weights (``gathered``), cast to ``dtype`` first
    when one is given; backward: the whole weights' gradients, cast back
    to each shard's dtype (a float32 master's gradient is summed in
    float32, as the replicated path's is), ``_scattered`` (with ``hier``,
    over the batch and pod groups)."""

    @staticmethod
    def forward(ctx, comm, dims, dtype, hier, *shards):
        ctx.comm, ctx.dims, ctx.hier = comm, dims, hier
        ctx.dtypes = [s.dtype for s in shards]
        if dtype is not None:
            shards = [s.to(dtype) if s.is_floating_point() else s
                      for s in shards]
        return tuple(gathered(comm, shards, dims))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.to(dt) for g, dt in zip(grads, ctx.dtypes)]
        return (None, None, None, None) + tuple(_scattered(
            ctx.comm, grads, ctx.dims, ctx.hier))


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
    """``make_gather``'s hook: FSDP over ``comm`` (the group that
    ``rules.fsdp_axes`` span, one rank a process: the data group, or on a
    pod axis the batch group where they name the pod axis too; the group
    of ``dp_axes`` where they are None), with ``model`` (a
    ``runtime.model_axis.ModelAxis`` over the model group) the model
    axis's part of each leaf too.  ``batch`` is the group that
    ``dp_axes`` span (the batch's rows and the cache's lanes; ``comm``
    where it is not given) and ``pod`` the pod group, which the gradients'
    reduction joins where the weights are replicated over pods (``hier``).

    ``keep(keys, t, shape)`` is ``Model.init_params``'s: the rank's part
    of a leaf at ``keys`` whose whole shape is ``shape`` (a block of a
    stacked leaf passes the stack's shape), its block over the model axis
    and then over the FSDP axes, recording the leaf's FSDP dim in
    ``dims``, its model dim in ``mdims`` and, under ``opt_fsdp_axes``, the
    dim that those split in ``odims``, trees like the parameters'.
    ``gather(tree, keys, dtype)`` (the hook, ``RunCtx.gather``) gives a
    subtree of shards at ``keys`` of the parameter tree (one layer of a
    stack too) whole over ``comm``: the split leaves through
    ``_GatherFn``, one all-gather a dtype, the others as they are; each
    leaf keeps its model-axis part, with which the layer computes.
    ``whole`` and ``part`` assemble and cut one leaf outside autograd (the
    global norm, checkpoints): over ``comm`` (``wide``: the group of
    ``opt_fsdp_axes``) first, then over the model group."""

    def __init__(self, rules: ShardingRules, comm, model=None, *,
                 batch=None, pod=None):
        if rules.seq_parallel:
            raise NotImplementedError(
                "seq_parallel: the activations are not split over the "
                "model axis (ROADMAP A22c (d))")
        if comm.p_local != 1:
            raise ValueError("FSDP holds one rank a process")
        mesh, batch = rules.mesh, comm if batch is None else batch
        fs = rules.fsdp_axes if rules.fsdp_axes is not None \
            else rules.dp_axes
        size = _axes_size(mesh, fs)
        if size != comm.p:
            raise ValueError(f"the FSDP axes span {size} ranks; the "
                             f"communicator has {comm.p}")
        size = _axes_size(mesh, rules.dp_axes)
        if size != batch.p:
            raise ValueError(f"the data axes span {size} ranks; the batch "
                             f"group has {batch.p}")
        self.hier = None
        if "pod" in mesh.shape and "pod" not in axis_names(fs):
            if pod is None or pod.p != mesh.shape["pod"]:
                raise ValueError(f"the pod axis spans {mesh.shape['pod']} "
                                 "ranks; give its pod group")
            self.hier = (batch, pod)
        msize = _axes_size(mesh, rules.tp_axis) \
            if rules.tp_axis in mesh.shape else 1
        if model is not None and model.size != msize:
            raise ValueError(f"the model axis spans {msize} ranks; the "
                             f"model group has {model.size}")
        self.rules, self.comm, self.model = rules, comm, model
        self.batch, self.pod = batch, pod
        self.rank, self.parts = comm.rank_offset, comm.p
        self.dims: dict = {}
        self.mdims: dict | None = {} if model is not None else None
        self.wide, self.odims, self.opt_rules = comm, None, None
        if rules.opt_fsdp_axes is not None:
            names = axis_names(rules.opt_fsdp_axes)
            if not names <= axis_names(rules.dp_axes):
                raise ValueError(f"opt_fsdp_axes {rules.opt_fsdp_axes} are "
                                 "not data axes")
            self.wide = batch if "pod" in names else comm
            size = _axes_size(mesh, rules.opt_fsdp_axes)
            if size != self.wide.p:
                raise ValueError(f"opt_fsdp_axes span {size} ranks; the "
                                 f"group has {self.wide.p}")
            self.odims = {}
            self.opt_rules = dataclasses.replace(
                rules, fsdp_axes=rules.opt_fsdp_axes)

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
        if self.odims is not None:
            self._record(self.odims, keys,
                         data_dim(self.opt_rules, path, shape))
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
                                     dtype, self.hier,
                                     *[t for _, t, _ in split])
            values.update(zip([k for k, _, _ in split], wholes))
        return _rebuild(tree, values)

    def whole(self, t: torch.Tensor, dim: int | None,
              mdim: int | None = None, *, wide=False) -> torch.Tensor:
        """One leaf whole (a collective where it is split): over ``comm``
        (``wide``: the group of ``opt_fsdp_axes``) along ``dim``, then over
        the model group along ``mdim``."""
        with torch.no_grad():
            if dim is not None:
                t = gathered(self.wide if wide else self.comm, [t], [dim])[0]
            if mdim is not None:
                t = gathered(self.model.comm, [t], [mdim])[0]
        return t

    def part(self, t: torch.Tensor, dim: int | None,
             mdim: int | None = None, *, wide=False) -> torch.Tensor:
        if mdim is not None:
            t = take(t, mdim, self.model.rank, self.model.size)
        comm = self.wide if wide else self.comm
        return take(t, dim, comm.rank_offset, comm.p)

    # ---- the optimizer state over ``opt_fsdp_axes`` ----
    def _blocks(self):
        """``(P, p, b)`` under ``opt_fsdp_axes`` over pod × data: the
        pods, this rank's pod and its batch rank ``b = p·D + d``.  Block
        ``b`` of the ``P·D`` is piece ``b % P`` of the ``P`` in part ``b //
        P`` of the ``D``: the rank at pod ``b % P`` and data ``b // P``
        (batch rank ``(b % P)·D + b // P``) holds it in its part."""
        pods, b = self.wide.p // self.parts, self.wide.rank_offset
        return pods, b // self.parts, b

    def to_wide(self, t: torch.Tensor, dim, odim) -> torch.Tensor:
        """A leaf's part placed as the parameters (its FSDP ``dim``) cut
        to its block over ``opt_fsdp_axes`` (``odim``): ``t`` itself where
        the two are the same block; the leaf whole (a gather over
        ``comm``) where those axes leave it whole; else each rank sends
        piece ``p`` of its part ``d`` to the rank whose block it is and
        receives its own block (``DistComm.sendrecv`` over the batch
        group), so that only blocks move."""
        if self.same_block(dim, odim):
            return t
        with torch.no_grad():
            if odim is None:
                return gathered(self.comm, [t], [dim])[0]
            if odim != dim:
                raise ValueError(f"an FSDP dim {dim} and an opt_fsdp_axes "
                                 f"dim {odim}")
            pods, p, b = self._blocks()
            s = t.shape[dim] // pods
            return self.wide.sendrecv(
                t.narrow(dim, p * s, s), self.rank * pods + p,
                (b % pods) * self.parts + b // pods)

    def from_wide(self, w: torch.Tensor, dim, odim) -> torch.Tensor:
        """``to_wide``'s inverse: the part cut from the whole leaf, or each
        block sent back as the piece it is, the pieces all-gathered over
        the pod group into the part."""
        if self.same_block(dim, odim):
            return w
        with torch.no_grad():
            if odim is None:
                return take(w, dim, self.rank, self.parts)
            pods, p, b = self._blocks()
            piece = self.wide.sendrecv(w, (b % pods) * self.parts
                                       + b // pods, self.rank * pods + p)
            return gathered(self.pod, [piece], [dim])[0]

    def same_block(self, dim, odim) -> bool:
        """Whether a leaf's FSDP part and its block over
        ``opt_fsdp_axes`` are the same tensor."""
        return dim == odim and (dim is None or self.wide.p == self.comm.p)

    @property
    def splits_data(self) -> bool:
        """Whether a leaf kept so far is split over ``comm`` (FSDP, or the
        serve rule's ZeRO-inference): its layers then gather over it,
        which every rank of it must join."""
        def split(dims):
            if isinstance(dims, dict):
                return any(split(d) for d in dims.values())
            return dims is not None
        return split(self.dims)

    # ---- the decode caches (``cache_specs``) ----
    def _cache_cuts(self, keys, shape):
        """``(dim, rank, parts)`` of the cache leaf at ``keys`` of whole
        ``shape``, over the model group then the batch group (the data
        axes)."""
        path = path_str(keys)
        m = self.model
        return [(cache_dim(self.rules, path, shape, "model"),
                 0 if m is None else m.rank, 1 if m is None else m.size),
                (cache_dim(self.rules, path, shape, "data"),
                 self.batch.rank_offset, self.batch.p)]

    def cache_shape(self, keys, shape) -> tuple:
        """This rank's block shape of the cache leaf at ``keys`` (its path
        in the cache tree, ``("layers", "k")``) of whole ``shape``."""
        out = list(shape)
        for dim, _, parts in self._cache_cuts(keys, tuple(shape)):
            if dim is not None:
                out[dim] //= parts
        return tuple(out)

    def cache_part(self, keys, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole cache leaf ``t`` at ``keys``."""
        for dim, rank, parts in self._cache_cuts(keys, tuple(t.shape)):
            t = take(t, dim, rank, parts)
        return t

    def cache_whole(self, keys, t: torch.Tensor, shape) -> torch.Tensor:
        """The cache leaf at ``keys`` whole (``shape``), from every rank's
        block ``t``: over the batch group, then the model group."""
        (mdim, _, _), (ddim, _, _) = self._cache_cuts(keys, tuple(shape))
        with torch.no_grad():
            if ddim is not None:
                t = gathered(self.batch, [t], [ddim])[0]
            if mdim is not None:
                t = gathered(self.model.comm, [t], [mdim])[0]
        return t

    def lanes(self, batch: int) -> slice:
        """This rank's lanes (or rows) of a cache (a batch) of ``batch``
        lanes over the data axes: its block in the batch group's order
        (every lane where the data axes do not divide them)."""
        dim = cache_dim(self.rules, "['k']", (batch, 1, 1, 1), "data")
        if dim is None:
            return slice(0, batch)
        per = batch // self.batch.p
        r = self.batch.rank_offset
        return slice(r * per, (r + 1) * per)

    @property
    def writer(self) -> bool:
        """Rank 0 of the mesh: rank 0 of its batch group and of its model
        group."""
        return self.batch.rank_offset == 0 and (self.model is None
                                                or self.model.rank == 0)


@functools.lru_cache(maxsize=16)
def fake_params(cfg):
    """``cfg``'s parameter tree from ``Model.init_params`` under a
    fake-tensor mode: the shapes, no memory, nothing drawn (one per
    config: drawing a published tree takes seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import Model, RunCtx
    with FakeTensorMode():
        return Model(cfg, RunCtx(), device="cpu").init_params(
            torch.Generator())


def serving_bytes(cfg, rules: ShardingRules | None = None) -> int:
    """The reference's count of a model's serving bytes: two bytes (bf16)
    for every element of every leaf of its parameter tree
    (``fake_params``); with ``rules``, a rank's share (each leaf over the
    axes its spec splits it on)."""
    from repro_torch.models.transformer import tree_leaves
    params = fake_params(cfg)
    specs = tree_leaves(param_specs(rules, params)) if rules else None
    return sum(2 * math.prod(t.shape) // (1 if specs is None else
                                          math.prod(_axes_size(rules.mesh, a)
                                                    for a in specs[i]))
               for i, t in enumerate(tree_leaves(params)))


def serve_limit(device=None) -> float:
    """The serve rule's bytes a rank of weights: ``SERVE_MEMORY_FRACTION``
    of the card's memory on a CUDA ``device``, else the reference's
    ``SERVE_RESIDENCY_LIMIT``."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        return SERVE_MEMORY_FRACTION * torch.cuda.get_device_properties(
            device).total_memory
    return SERVE_RESIDENCY_LIMIT


def serve_rules(cfg, mesh, *, limit: float | None = None,
                device=None) -> ShardingRules:
    """The reference's serve placement of ``cfg`` on ``mesh`` (``make_rules``
    in ``launch/dryrun.py``, mode decode or prefill): the weights over the
    model axis only, unless ``serving_bytes / M`` exceeds ``limit`` (then
    over the data axes too: ZeRO-inference), ``ep_mode`` for an MoE config
    with at least ``M`` experts.  ``limit`` defaults to ``serve_limit(
    device)``."""
    if limit is None:
        limit = serve_limit(device)
    m = mesh.shape["model"]
    fsdp = ("pod", "data") if "pod" in mesh.shape else "data"
    if serving_bytes(cfg) / m <= limit:
        fsdp = None             # fits with the model axis alone
    return ShardingRules(mesh=mesh, fsdp_axes=fsdp,
                         ep_mode=cfg.is_moe and cfg.num_experts >= m)


def make_gather(rules: ShardingRules, comm, model=None, *, batch=None,
                pod=None) -> Gather:
    """The FSDP hook of ``rules`` over ``comm`` (``Gather``), with
    ``model`` the model axis's and, on a pod axis, ``batch`` and ``pod``
    its groups (``launch.mesh.Grid.gather_for`` picks them): the port's
    counterpart of the reference's ``make_constrain``."""
    return Gather(rules, comm, model, batch=batch, pod=pod)


@dataclasses.dataclass(frozen=True)
class Placed:
    """A tree of this rank's parts: ``dims`` its FSDP dims (a tree like
    it), ``mdims`` its model dims (None without a model axis), ``wide``
    a tree of flags, true where a leaf's dim in ``dims`` is over
    ``opt_fsdp_axes`` (None: nowhere), ``gather`` the hook that placed it.
    ``whole(keys, leaf)`` and ``part(keys, t)`` assemble and cut the leaf
    at ``keys`` over both axes; rank 0 of the mesh writes what is
    assembled (``writer``)."""

    gather: Gather
    dims: Any
    mdims: Any = None
    wide: Any = None

    def _dims(self, keys):
        return (_at(self.dims, keys),
                None if self.mdims is None else _at(self.mdims, keys))

    def _wide(self, keys) -> bool:
        return self.wide is not None and bool(_at(self.wide, keys))

    def whole(self, keys, leaf):
        return self.gather.whole(leaf, *self._dims(keys),
                                 wide=self._wide(keys))

    def part(self, keys, t):
        return self.gather.part(t, *self._dims(keys), wide=self._wide(keys))

    @property
    def writer(self) -> bool:
        return self.gather.writer
