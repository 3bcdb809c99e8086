"""Carry the JAX reference's data across to the port.

The system runs no model, so the "weights" the two packages must share are
the matrix and the communication plan.  ``from_reference`` reads the
reference's ``EllpackMatrix`` and ``CommPlan`` duck-typed — as plain numpy
fields, never importing the reference — and returns the port's host-side
equivalents, so that both packages can run the same matrix through the same
plan (``DistributedSpMV(..., base_plan=plan)``).  Both objects are host
(numpy) state in either package; they reach a device only when an engine
is built on them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.comm.plan import CommPlan, GatherCounts, Topology
from repro_torch.core.matrix import EllpackMatrix

__all__ = ["from_reference"]


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


def from_reference(matrix, plan=None):
    """``(EllpackMatrix, CommPlan | None)`` of the port, equal field for
    field to the reference's ``matrix`` and (optional) ``plan``, including
    any ``Destination`` arrays attached to the plan."""
    port_matrix = _copy(EllpackMatrix, matrix)
    if plan is None:
        return port_matrix, None
    port_plan = _copy(CommPlan, plan,
                      topology=_copy(Topology, plan.topology),
                      counts=_copy(GatherCounts, plan.counts))
    return port_matrix, port_plan
