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
import math
import re
from typing import Any

import torch

__all__ = ["ShardingRules", "fit_spec", "param_specs", "batch_spec",
           "cache_specs", "cache_spec", "cache_dim", "path_str", "data_dim",
           "data_dims", "model_dim", "model_dims", "take", "take_tree",
           "gathered", "Gather", "make_gather", "Placed", "SERVE_RESIDENCY_LIMIT",
           "SERVE_MEMORY_FRACTION", "serving_bytes", "serve_limit",
           "serve_rules"]

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
    names = (_names(rules.dp_axes) if axis == "data"
             else _names(rules.tp_axis))
    return _axis_dim(cache_spec(rules, path, shape), names)


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
    """Shards -> whole weights (``gathered``), cast to ``dtype`` first
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
        return tuple(gathered(comm, shards, dims))

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
                "parameters (ROADMAP A22c)")
        if rules.seq_parallel:
            raise NotImplementedError(
                "seq_parallel: the activations are not split over the "
                "model axis (ROADMAP A22c)")
        if comm.p_local != 1:
            raise ValueError("FSDP holds one rank a process")
        size = _axes_size(rules.mesh, rules.dp_axes)
        if rules.fsdp_axes is not None:
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
                t = gathered(self.comm, [t], [dim])[0]
            if mdim is not None:
                t = gathered(self.model.comm, [t], [mdim])[0]
        return t

    def part(self, t: torch.Tensor, dim: int | None,
             mdim: int | None = None) -> torch.Tensor:
        if mdim is not None:
            t = take(t, mdim, self.model.rank, self.model.size)
        return take(t, dim, self.rank, self.parts)

    @property
    def splits_data(self) -> bool:
        """Whether a leaf kept so far is split over the data group (FSDP,
        or the serve rule's ZeRO-inference): its layers then gather over
        the data group, which every data rank must join."""
        def split(dims):
            if isinstance(dims, dict):
                return any(split(d) for d in dims.values())
            return dims is not None
        return split(self.dims)

    # ---- the decode caches (``cache_specs``) ----
    def _cache_cuts(self, keys, shape):
        """``(dim, rank, parts)`` of the cache leaf at ``keys`` of whole
        ``shape``, over the model group then the data group."""
        path = path_str(keys)
        m = self.model
        return [(cache_dim(self.rules, path, shape, "model"),
                 0 if m is None else m.rank, 1 if m is None else m.size),
                (cache_dim(self.rules, path, shape, "data"), self.rank,
                 self.parts)]

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
        block ``t``: over the data group, then the model group."""
        (mdim, _, _), (ddim, _, _) = self._cache_cuts(keys, tuple(shape))
        return self.whole(t, ddim, mdim)

    def lanes(self, batch: int) -> slice:
        """This rank's lanes of a cache of ``batch`` lanes (every lane
        where the data axes do not divide them)."""
        dim = cache_dim(self.rules, "['k']", (batch, 1, 1, 1), "data")
        if dim is None:
            return slice(0, batch)
        per = batch // self.parts
        return slice(self.rank * per, (self.rank + 1) * per)

    @property
    def writer(self) -> bool:
        """Rank 0 of the mesh: rank 0 of its data group and of its model
        group."""
        return self.rank == 0 and (self.model is None
                                   or self.model.rank == 0)


def serving_bytes(cfg, rules: ShardingRules | None = None) -> int:
    """The reference's count of a model's serving bytes: two bytes (bf16)
    for every element of every leaf of its parameter tree, whose shapes
    come from ``Model.init_params`` under a fake-tensor mode (no memory,
    nothing drawn); with ``rules``, a rank's share (each leaf over the
    axes its spec splits it on)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import Model, RunCtx, tree_leaves
    with FakeTensorMode():
        params = Model(cfg, RunCtx(), device="cpu").init_params(
            torch.Generator())
        specs = tree_leaves(param_specs(rules, params)) if rules else None
        return sum(2 * math.prod(t.shape) // (1 if specs is None else
                                              math.prod(_axes_size(
                                                  rules.mesh, a)
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
