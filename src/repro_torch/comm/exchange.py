"""Direction-agnostic exchange core.

``IrregularExchange`` owns what every exchange of one ``AccessPattern`` over
one communicator needs: partitioning checks, BLOCKSIZE resolution (fixed or
the eq.-11 ``"auto"``), the destination-independent base ``CommPlan``
(from the persistent plan cache, ``comm.plan_cache``, or handed in as
``base_plan=``), strategy resolution (any rung, or ``"auto"`` through
``select.rank_strategies`` with the subclass's direction — the get models
for ``IrregularGather``, the put models for ``IrregularScatter``), the
hardware calibration memo (``measure_hw``), and the ``OverlapHandle``
protocol type.  Subclasses — ``IrregularGather`` (``direction = "get"``)
and ``IrregularScatter`` (``"put"``) — derive their direction's plan state
in ``_prepare`` and implement ``_bind`` to wire the resolved rung to their
direction's rank-stacked functions (``repro_torch.comm.strategies``).

Per-batch patterns (the reference's ``DynamicPattern``) are not ported
(ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.comm import plan_cache
from repro_torch.comm import select
from repro_torch.comm import strategies as strat
from repro_torch.comm.pattern import AccessPattern
from repro_torch.comm.plan import CommPlan, Topology
from repro_torch.comm.shared import SharedVector

__all__ = ["IrregularExchange", "OverlapHandle", "measure_hw",
           "clear_hw_memo"]


def clear_hw_memo() -> None:
    """Forget every calibration (``tune.clear_hardware_cache``)."""
    from repro_torch.core import tune
    tune.clear_hardware_cache()


def measure_hw(comm):
    """§5.4 hardware parameters for one rank of ``comm``, memoized per
    (device, rank count) in ``repro_torch.core.tune`` — constructing several
    exchanges over the same communicator calibrates once."""
    # function-level import: core.tune sits above the comm layer
    from repro_torch.core import tune
    return tune.measure_hardware(comm)


@dataclasses.dataclass
class OverlapHandle:
    """An in-flight exchange: the collective has been issued, the landed
    messages are not yet delivered.  Everything computed before ``finish``
    that only reads the local operand runs inside the communication window
    (on the card the loopback copy runs on a side stream meanwhile).

    ``finish`` has two materializations:

    * ``materialize="full"`` — assemble every rank's private ``x_copy``
      ``(P, >= n, ...)``, indexable with global indices;
    * ``materialize="dest"`` — requires the gather to own a ``Destination``:
      land the recv buffer straight in the consumer's named slots and return
      ``{name: (P, *slot_shape, ...)}``.  No full-length intermediate.
    * ``materialize="landed"`` — as ``"dest"``, but undelivered: the landed
      buffer and the plan's four dest arrays (``strategies.Landed``), for a
      consumer that fuses the delivery into its compute.

    The default is ``"dest"`` when the gather was constructed with a
    ``Destination``, else ``"full"``.
    """

    x_local: torch.Tensor
    _finish: Callable[..., torch.Tensor]

    def finish(self, *, extra_slots: int = 0, copy_own: bool = True,
               materialize: str | None = None):
        """Deliver the landed messages (see class docstring for modes).

        ``extra_slots`` (full mode): number of guaranteed-zero slots
        appended after the recv dump — x_copy[:, n+1 .. n+extra_slots] read
        as 0 for any strategy, so consumers can point padding indices there.
        ``copy_own=False`` (full mode) skips the eq.-14 own-shard copy for
        consumers that read their own shard from ``x_local`` directly.
        """
        return self._finish(extra_slots=extra_slots, copy_own=copy_own,
                            materialize=materialize)


class IrregularExchange:
    """Plan + strategy + device state for one ``AccessPattern`` over the
    ranks of one communicator (``LoopbackComm``) or ``SharedVector``, in
    one direction: ``"get"`` (accessors pull the elements they index) or
    ``"put"`` (accessors push contributions to them)."""

    direction = "get"

    def __init__(
        self,
        pattern: AccessPattern,
        where,
        *,
        strategy: str = "auto",
        blocksize: int | str | None = None,
        shards_per_node: int | None = None,
        topology: Topology | None = None,
        hw=None,
        use_plan_cache: bool = True,
        base_plan: CommPlan | None = None,
        scan_steps: int | None = None,
        use_kernel: bool = False,
    ):
        # ``use_kernel`` swaps the plain pack/unpack around the collective
        # for the CUDA kernels (repro_torch.kernels), bit-identical on
        # every rung; the §5 ranking prices the kernelized compute terms so
        # strategy="auto" stays honest either way
        self.use_kernel = use_kernel
        if isinstance(where, SharedVector):
            assert where.n == pattern.n, (where.n, pattern.n)
            comm = where.comm
            topology = topology or where.topology
        else:
            comm = where
        valid = strat.STRATEGIES + ("auto",)
        if strategy not in valid:
            raise ValueError(f"strategy must be one of {valid}")
        self.pattern = pattern
        self.comm = comm
        self.device = comm.device
        p = comm.p
        self.p = p
        n = pattern.n
        assert n % p == 0, "pad the vector so n divides the rank count"
        assert pattern.m % p == 0, "pad the pattern so m divides the ranks"
        if topology is None:
            topology = Topology(p, shards_per_node or p)

        if base_plan is not None:
            # an already-built destination-independent base plan (e.g. one
            # shared by several engines over the same pattern): skip the
            # cache probe and any blocksize sweep
            assert (base_plan.n == n and base_plan.p == p
                    and base_plan.m == pattern.m), (
                "base_plan was built for a different pattern/partitioning: "
                f"{(base_plan.n, base_plan.p, base_plan.m)} != "
                f"{(n, p, pattern.m)}")
            blocksize = base_plan.blocksize
        else:
            if blocksize == "auto":
                if hw is None:
                    hw = measure_hw(comm)
                blocksize = select.choose_blocksize(
                    pattern.indices, n, p, topology=topology, hw=hw)
            # destination-independent base plan first: the strategy resolves
            # against it, and any direction- or consumer-specific delta (the
            # scatter executor tables, a Destination descriptor) is attached
            # only afterwards
            base_plan = plan_cache.get_comm_plan(
                pattern.indices, n, p, blocksize=blocksize,
                topology=topology, cache=use_plan_cache)
        self._use_plan_cache = use_plan_cache
        self._prepare(base_plan)

        self.requested_strategy = strategy
        self.scan_steps = scan_steps
        self.predicted_times: dict[str, float] | None = None
        if strategy == "auto":
            if hw is None:
                hw = measure_hw(comm)
            # scan_steps (a ScanSchedule resolving this stage) prices the
            # rungs on the n-step steady-state loop cost
            ranked = select.rank_strategies(
                self._ranking_plan(base_plan), pattern.r, hw,
                direction=self.direction, scan_steps=scan_steps,
                **self._price_kwargs())
            self.predicted_times = dict(ranked)
            strategy = ranked[0][0]
        self.strategy = strategy
        self.hw = hw
        self._bind(base_plan, strategy)

    # ---- subclass hooks ----
    def _prepare(self, base_plan: CommPlan) -> None:
        """Derive direction-specific plan state before strategy resolution."""

    def _ranking_plan(self, base_plan: CommPlan):
        """The plan whose counts feed the §5 ranking (base by default)."""
        return base_plan

    def _price_kwargs(self) -> dict:
        """Extra ``rank_strategies`` kwargs (e.g. gather unpack pricing)."""
        return {"use_kernel": self.use_kernel}

    def _bind(self, base_plan: CommPlan, strategy: str) -> None:
        """Wire the resolved strategy: set ``self.plan`` / ``plan_args`` and
        the rank-stacked start+finish."""
        raise NotImplementedError

    # ---- shared surface ----
    def shard_vector(self, x) -> torch.Tensor:
        """Place host values (length n, plus feature dims) on the device in
        the plan's contiguous layout, ``(P, shard_size, ...)``."""
        return SharedVector(self.comm, self.pattern.n).put(x)

    @property
    def counts(self):
        """The plan's exact per-shard volume counts (§5.2 model inputs)."""
        return self.plan.counts
