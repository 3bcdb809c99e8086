"""IrregularGather — the pull-direction front door to the strategy ladder.

One object owns everything the paper's §4 machinery needs for one access
pattern over one communicator: the one-time ``CommPlan`` (persistently
cached, ``comm.plan_cache``), the resolved rung (any ladder rung or
``"auto"`` through the §5 models), the device-resident plan arrays, and the
rank-stacked gather functions.

Consumers compose it two ways:

* standalone: ``x_copy_all = gather(x)`` returns every rank's private copy
  stacked (row q = rank q's ``mythread_x_copy``);
* fused: the consumer calls ``gather.local(x, *gather.plan_args)`` inside
  its own step — or, to hide the exchange behind own-shard compute (the
  own/foreign split of the ``overlap`` rung), the ``OverlapHandle``
  protocol::

      handle = gather.start_local(x, *gather.plan_args)   # issued
      y_own = ...                                # depends on x only
      x_copy = handle.finish()                   # unpack landed messages
      y = y_own + foreign_part(x_copy)

  On the card the loopback all_to_all of ``start_local`` runs on a side
  stream, so the own compute enqueued before ``finish`` overlaps it.

With a ``Destination`` descriptor (named consumer slots, e.g. EllPack
rows), ``finish()`` / ``local()`` default to ``materialize="dest"``: the
landed recv buffer goes straight into the named slots and comes back as
``{name: (P, *slot_shape, ...)}`` — no full-length ``x_copy``.
``materialize="full"`` keeps the classic assembled copy, bit-identically.
``materialize="landed"`` hands back the landed buffer with the plan's four
dest arrays (``strategies.Landed``) for a consumer that fuses the delivery
into its own compute (``kernels.unpack_dest_spmv``).  With
``use_kernel=True`` the delivery reads the plan's dest table, which a
``kernels.DestOrder`` of the gather builds at its first call on a card.
``strategy="auto"`` prices whichever unpack the consumer will run: the
targeted one with a ``Destination``, the paper's in-place one without.
"""
from __future__ import annotations

import torch

from repro_torch.comm import plan_cache
from repro_torch.comm import strategies as strat
from repro_torch.comm.exchange import IrregularExchange, OverlapHandle
from repro_torch.comm.pattern import AccessPattern, Destination
from repro_torch.comm.plan import CommPlan
from repro_torch.kernels import ops as kops

__all__ = ["IrregularGather", "OverlapHandle"]


class IrregularGather(IrregularExchange):
    """Plan + strategy + device state for gathering one ``AccessPattern``
    over the ranks of one communicator."""

    def __init__(self, pattern: AccessPattern, where, *,
                 destination: Destination | None = None,
                 dest_slots: int | None = None, **kwargs):
        """``destination`` may be a ``Destination`` or a callable
        ``(resolved_strategy, base_plan) -> Destination`` for consumers
        whose slot layout depends on the resolved rung (e.g. SpMV targets
        foreign slots only under ``overlap``); it is materialized and
        attached once, after strategy resolution, so no throwaway plan
        entry is ever cached.  ``dest_slots`` is the flattened slot count
        the auto ranking prices when ``destination`` is a callable (a
        plain ``Destination`` knows its own).  Remaining keyword arguments
        (``strategy``, ``blocksize``, ``shards_per_node``, ``topology``,
        ``hw``, ``use_plan_cache``, ``base_plan``, ``scan_steps``,
        ``use_kernel``) are the shared ``IrregularExchange`` surface."""
        self._destination_arg = destination
        self._dest_slots = dest_slots
        super().__init__(pattern, where, **kwargs)

    def _price_kwargs(self) -> dict:
        kw = super()._price_kwargs()
        destination = self._destination_arg
        if destination is None:
            return kw
        # with a destination, price the targeted O(slots + recv) unpack
        # instead of the O(n) full-copy assembly
        if callable(destination):
            if self._dest_slots is None:
                raise ValueError(
                    'strategy="auto" with a callable destination '
                    "requires dest_slots= — the flattened slot "
                    "count the ranking prices (otherwise the "
                    "targeted unpack would be priced at 0 slots "
                    "and skew the rung selection)")
            slots = self._dest_slots
        else:
            slots = destination.num_slots
        kw.update(materialize="dest", dest_slots=slots)
        return kw

    def _bind(self, base_plan: CommPlan, strategy: str) -> None:
        p, n = self.p, self.pattern.n
        destination = self._destination_arg
        if callable(destination):
            destination = destination(strategy, base_plan)
        if destination is not None:
            assert destination.p == p, (
                f"destination has {destination.p} per-rank slot tables "
                f"for {p} ranks")
            assert destination.indices.max() < n, (
                "destination indices must lie in [-1, n)")
            self.plan: CommPlan = plan_cache.get_comm_plan(
                self.pattern.indices, n, p, blocksize=base_plan.blocksize,
                topology=base_plan.topology, destination=destination,
                base=base_plan, cache=self._use_plan_cache)
        else:
            self.plan = base_plan
        self.destination = destination
        self.plan_args = strat.to_device(
            strat.plan_device_args(self.plan, strategy,
                                   with_dest=destination is not None),
            self.device)
        self._start, self._finish = strat.make_start_local(
            self.plan, strategy, self.comm, use_kernel=self.use_kernel)
        self._dest_order = kops.DestOrder() if self.use_kernel else None

    def _resolve_materialize(self, materialize: str | None) -> str:
        if materialize is None:
            return "dest" if self.destination is not None else "full"
        if materialize not in ("dest", "full", "landed"):
            raise ValueError(f"unknown materialize mode {materialize!r}")
        if materialize != "full" and self.destination is None:
            raise ValueError(
                f'materialize="{materialize}" requires constructing the '
                "gather with a Destination descriptor")
        return materialize

    def _deliver(self, out, mode: str):
        """The finish's result in ``mode``: a targeted finish's ``Landed``
        goes into the named slots for ``"dest"``."""
        if mode != "dest":
            return out
        if self.use_kernel:
            slots = kops.unpack_dest(*out,
                                     table=self._dest_order(*out[2:]))
        else:
            slots = strat.dest_gather_local(*out)
        return self.destination.split(slots)

    # ---- rank-stacked surface (compose inside a consumer's step) ----
    def local(self, x: torch.Tensor, *plan_args,
              materialize: str | None = None):
        """One-shot gather.

        ``materialize="full"`` (default without a destination): x
        ``(P, shard, ...)`` -> x_copy ``(P, >= n, ...)``.
        ``materialize="dest"`` (default with one): -> ``{name: slots}``
        named consumer buffers, no full-length intermediate.
        ``materialize="landed"``: -> ``strategies.Landed``, undelivered.
        """
        mode = self._resolve_materialize(materialize)
        work = self._start(x, *plan_args)
        out = self._finish(work, x, *plan_args,
                           materialize="full" if mode == "full" else "dest")
        return self._deliver(out, mode)

    def start_local(self, x: torch.Tensor, *plan_args) -> OverlapHandle:
        """Issue the exchange; compute on ``x`` while it flies."""
        work = self._start(x, *plan_args, async_op=True)

        def finish(*, extra_slots=0, copy_own=True, materialize=None):
            mode = self._resolve_materialize(materialize)
            out = self._finish(work, x, *plan_args, extra_slots=extra_slots,
                               copy_own=copy_own,
                               materialize="full" if mode == "full"
                               else "dest")
            return self._deliver(out, mode)

        return OverlapHandle(x_local=x, _finish=finish)

    # ---- standalone surface ----
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``(P, >= n, ...)``: row q is rank q's private x_copy.

        Always the full materialization, regardless of any ``Destination``.
        """
        return self.local(x, *self.plan_args, materialize="full")
