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

The port's trainer uses the data axis only (``launch.train --mesh D``:
``batch_spec`` gives each rank its rows; parameters stay replicated).  The
rest of the table serves the FSDP and model-axis items to come (ROADMAP
A21, A22).  The reference's ``make_constrain`` is not ported: it tags
activations with ``with_sharding_constraint`` for XLA's partitioner, and
eager PyTorch has no partitioner to tell.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

__all__ = ["ShardingRules", "fit_spec", "param_specs", "batch_spec",
           "cache_specs", "path_str"]


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
