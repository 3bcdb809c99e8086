"""IrregularScatter — the push-direction front door to the strategy ladder.

The paper's condensing/consolidation strategies and §5 cost models apply
symmetrically to puts and gets: the performance formulas hinge only on
message volumes, not direction.  ``IrregularScatter`` is the put-side dual
of ``IrregularGather``: accessor row i's slot j *contributes* a value to
global element ``pattern.indices[i, j]`` of a sharded vector, duplicate
targets combine under a ``reduce`` semantic, and every rung moves exactly
the same per-pair message sets as the gather of the same pattern — the plan
is the gather plan with send/recv tables swapped (``CommPlan.transpose()``).

Reduce semantics (all deterministic, see ``strategies.SCATTER_REDUCES``):

* ``"add"`` — y[t] = sum of contributions (0 where none); the
  SpMV-transpose accumulate.
* ``"max"`` — y[t] = max of contributions (0 where none).
* ``"set"`` — y[t] = the last contribution in row-major accessor order
  (0 where none), via the plan's precomputed winner mask.

Composition mirrors the gather:

* standalone: ``y = scatter(vals)`` with ``vals`` the ``(P, rows, r, ...)``
  contribution table (``scatter.shard_values`` places a host ``(m, r,
  ...)`` one); returns the combined vector sharded over owners, ``(P,
  shard, ...)``;
* fused: ``scatter.local(vals, *scatter.plan_args)`` inside a consumer's
  step — or the handle protocol, to hide the exchange behind local
  compute::

      handle = scatter.start_local(vals, *scatter.plan_args)   # issued
      extra = ...              # anything that doesn't need the landed msgs
      y = handle.finish() + extra    # own-accumulate + landed foreign

  ``finish`` runs the own-shard accumulate first: it has no dependency on
  the collective, which on the card runs on a side stream meanwhile.

``strategy="auto"`` ranks the rungs with the put-direction §5 models on
the ``ScatterPlan``'s transposed counts.  The ``ScatterPlan`` comes from
the plan cache (``plan_cache.get_scatter_plan``: a delta derived from, and
stored against, the base plan), or is shared between engines with
``scatter_plan=``.  Per-batch patterns (``derive_plan_args``,
``DynamicPattern``) come with ROADMAP A9.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.comm import plan_cache
from repro_torch.comm import strategies as strat
from repro_torch.comm.exchange import IrregularExchange
from repro_torch.comm.plan import CommPlan, ScatterPlan

__all__ = ["IrregularScatter", "ScatterHandle"]


@dataclasses.dataclass
class ScatterHandle:
    """An in-flight scatter: the packed contributions are on the wire, the
    owned slices are not yet combined.  ``finish()`` returns every rank's
    combined ``y`` ``(P, shard, ...)``."""

    vals_local: torch.Tensor
    _finish: Callable[[], torch.Tensor]

    def finish(self) -> torch.Tensor:
        return self._finish()


class IrregularScatter(IrregularExchange):
    """Plan + strategy + device state for scattering contributions to one
    ``AccessPattern``'s targets over the ranks of one communicator.

    The pattern plays the transposed role: its (m, r) indices are *write*
    targets.  Accessor rows and vector elements are partitioned contiguously
    over the same ranks as for the gather, so a gather and a scatter of the
    same pattern share one base plan.
    """

    direction = "put"

    def __init__(self, pattern, where, *, reduce: str = "add",
                 scatter_plan: ScatterPlan | None = None, **kwargs):
        """``reduce`` picks the duplicate-combining semantic (``"add"`` /
        ``"set"`` / ``"max"``).  ``scatter_plan`` shares an already-derived
        ``ScatterPlan`` (its ``base`` then serves as ``base_plan`` unless
        one is given).  Remaining keyword arguments (``strategy``,
        ``blocksize``, ``shards_per_node``, ``topology``, ``hw``,
        ``use_plan_cache``, ``base_plan``, ``scan_steps``, ``use_kernel``)
        are the shared ``IrregularExchange`` surface."""
        if reduce not in strat.SCATTER_REDUCES:
            raise ValueError(
                f"reduce must be one of {strat.SCATTER_REDUCES}")
        self.reduce = reduce
        self._scatter_plan_arg = scatter_plan
        if scatter_plan is not None and kwargs.get("base_plan") is None:
            kwargs["base_plan"] = scatter_plan.base
        super().__init__(pattern, where, **kwargs)

    def _prepare(self, base_plan: CommPlan) -> None:
        # the transpose-derived executor tables are strategy-independent,
        # so they are resolved (cached as a delta, or shared) before the §5
        # ranking, whose put-direction counts they carry
        splan = self._scatter_plan_arg
        if splan is None:
            splan = plan_cache.get_scatter_plan(
                self.pattern.indices, base_plan.n, base_plan.p,
                blocksize=base_plan.blocksize, topology=base_plan.topology,
                base=base_plan, cache=self._use_plan_cache)
        else:
            b = splan.base
            assert (b.n, b.p, b.m, b.blocksize, b.s_max, b.b_max) == (
                base_plan.n, base_plan.p, base_plan.m, base_plan.blocksize,
                base_plan.s_max, base_plan.b_max), (
                "scatter_plan was derived from a different base plan")
        self.splan = splan

    def _ranking_plan(self, base_plan: CommPlan):
        return self.splan

    def _bind(self, base_plan: CommPlan, strategy: str) -> None:
        self.plan = base_plan  # the shared (direction-agnostic) base plan
        self.plan_args = strat.to_device(
            strat.scatter_plan_device_args(self.splan, strategy),
            self.device)
        # the kernel arm's segment tables: built once here, on the device,
        # from the static plan arrays — never per step
        self.tables = (strat.scatter_segment_tables(self.splan, strategy,
                                                    self.plan_args)
                       if self.use_kernel else None)
        self._start, self._finish = strat.make_scatter_start_local(
            self.splan, strategy, self.comm, self.reduce,
            use_kernel=self.use_kernel, tables=self.tables)

    @property
    def counts(self):
        """Put-direction per-shard volume counts (§5 put-model inputs)."""
        return self.splan.counts

    # ---- rank-stacked surface (compose inside a consumer's step) ----
    def local(self, vals: torch.Tensor, *plan_args) -> torch.Tensor:
        """One-shot scatter: contributions ``(P, rows, r, ...)`` ->
        combined owned slices ``(P, shard, ...)``."""
        work = self._start(vals, *plan_args)
        return self._finish(work, vals, *plan_args)

    def start_local(self, vals: torch.Tensor, *plan_args) -> ScatterHandle:
        """Pack + issue the exchange; compute while it flies.  The
        own-shard accumulate runs inside ``finish`` and needs nothing from
        the collective."""
        work = self._start(vals, *plan_args, async_op=True)

        def finish():
            return self._finish(work, vals, *plan_args)

        return ScatterHandle(vals_local=vals, _finish=finish)

    def derive_plan_args(self, cols, gather_tables=None) -> tuple:
        """Per-batch executor tables for a dynamic pattern: not ported."""
        raise NotImplementedError(
            "derive_plan_args (per-batch scatter tables derived on the "
            "device) comes with the dynamic-pattern slice of the port "
            "(ROADMAP A9)")

    # ---- standalone surface ----
    def shard_values(self, vals) -> torch.Tensor:
        """Place a host ``(m, r, ...)`` contribution table on the device as
        ``(P, m / P, r, ...)``, sharded over accessor rows like the plan."""
        vals = torch.as_tensor(np.asarray(vals))
        assert vals.shape[0] == self.pattern.m, (tuple(vals.shape),
                                                 self.pattern.m)
        return vals.reshape((self.p, -1) + tuple(vals.shape[1:])).to(
            self.device).contiguous()

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        """Combined vector ``(P, shard, ...)``, row q owned by rank q:
        y[t] = reduce of all contributions targeting t."""
        return self.local(vals, *self.plan_args)
