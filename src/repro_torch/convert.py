"""Carry the JAX reference's data across to the port.

The communication layer's "weights" are the matrix and the plans:
``from_reference`` reads the reference's ``EllpackMatrix``, ``CommPlan``
and ``ScatterPlan`` duck-typed — as plain numpy fields, never importing
the reference — and returns the port's host-side equivalents, so that
both packages can run the same matrix through the same plan
(``DistributedSpMV(..., base_plan=plan)``, ``IrregularScatter(...,
scatter_plan=splan)``).  All of them are host (numpy) state in either
package; they reach a device only when an engine is built on them.  The
serving model's weights come across through
``model_params_from_reference``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.plan import CommPlan, GatherCounts, ScatterPlan, Topology
from repro_torch.core.matrix import EllpackMatrix

__all__ = ["from_reference", "model_params_from_reference"]


def _copy(cls, obj, **overrides):
    """``cls`` built from the same-named fields of ``obj`` (arrays copied)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in overrides:
            kw[f.name] = overrides[f.name]
            continue
        v = getattr(obj, f.name)
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return cls(**kw)


def _comm_plan(plan) -> CommPlan:
    return _copy(CommPlan, plan, topology=_copy(Topology, plan.topology),
                 counts=_copy(GatherCounts, plan.counts))


def from_reference(matrix, plan=None):
    """``(EllpackMatrix | None, plan | None)`` of the port, equal field for
    field to the reference's ``matrix`` and (optional) ``plan``.

    ``plan`` is a ``CommPlan`` (any ``Destination`` arrays attached to it
    come along) or a ``ScatterPlan``, whose base ``CommPlan`` is carried
    across with it: pass the result's ``.base`` as ``base_plan=`` beside
    ``scatter_plan=``.  ``matrix`` may be None for a pattern that is not a
    matrix."""
    port_matrix = None if matrix is None else _copy(EllpackMatrix, matrix)
    if plan is None:
        return port_matrix, None
    if hasattr(plan, "tgt_global"):              # a ScatterPlan
        return port_matrix, _copy(ScatterPlan, plan,
                                  base=_comm_plan(plan.base),
                                  counts=_copy(GatherCounts, plan.counts))
    return port_matrix, _comm_plan(plan)


def model_params_from_reference(cfg, params):
    """The reference's ``Model(cfg).init_params`` tree, given as numpy
    arrays (``jax.tree.map(np.asarray, params)``), as the port's master
    tree: float32 CPU tensors of the same structure, with the layers
    stacked on the leading axis (a MoE layer's ``router`` and expert
    weights ``w1``/``w2``/``w3``, ``(L, E, ...)``, among them).
    ``Model.load_params`` places it on the model's device in its dtypes.
    Checks the tree against ``cfg``."""
    want = {"embed": (cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        want["lm_head"] = (cfg.d_model, cfg.vocab_size)
    for name, shape in want.items():
        got = tuple(np.shape(params[name]["w"]))
        if got != shape:
            raise ValueError(f"{name} is {got}, the config says {shape}")

    def copy(tree, path):
        if isinstance(tree, dict):
            return {k: copy(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree, dtype=np.float32)
        if path[0] == "layers" and (a.ndim == 0
                                    or a.shape[0] != cfg.num_layers):
            raise ValueError(f"{'/'.join(path)} has shape {a.shape}, not "
                             f"{cfg.num_layers} stacked layers")
        return torch.from_numpy(a.copy())

    return copy(params, ())
