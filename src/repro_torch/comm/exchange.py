"""Direction-agnostic exchange core.

``IrregularExchange`` owns what every exchange of one ``AccessPattern`` over
one communicator needs: partitioning checks, BLOCKSIZE resolution, the
destination-independent base ``CommPlan`` (built once, or handed in as
``base_plan=``), strategy validation, and the ``OverlapHandle`` protocol
type.  Subclasses — ``IrregularGather`` (``direction = "get"``) and
``IrregularScatter`` (``"put"``) — derive their direction's plan state in
``_prepare`` and implement ``_bind`` to wire the resolved rung to their
direction's rank-stacked functions (``repro_torch.comm.strategies``).

This slice takes fixed rungs only.  ``strategy="auto"`` and
``blocksize="auto"`` — the §5 models pricing the rungs from hardware
parameters measured on the card — and the persistent plan cache come with
later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.comm import strategies as strat
from repro_torch.comm.pattern import AccessPattern
from repro_torch.comm.plan import CommPlan, Topology, build_comm_plan
from repro_torch.comm.shared import SharedVector

__all__ = ["IrregularExchange", "OverlapHandle"]

_AUTO_LATER = ("{what}='auto' is not ported yet: the §5 models, priced "
               "with CUDA-event probes of the card (perfmodel / select / "
               "tune), come with the next slice of the port (ROADMAP A5); "
               "pick {choice} explicitly")


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
        base_plan: CommPlan | None = None,
        use_kernel: bool = False,
    ):
        # ``use_kernel`` swaps the plain pack/unpack around the collective
        # for the CUDA kernels (repro_torch.kernels), bit-identical on
        # every rung
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
        if strategy == "auto":
            raise NotImplementedError(_AUTO_LATER.format(
                what="strategy", choice=f"one of {strat.STRATEGIES}"))
        if blocksize == "auto":
            raise NotImplementedError(_AUTO_LATER.format(
                what="blocksize", choice="an integer blocksize"))
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
            # shared by several engines over the same pattern)
            assert (base_plan.n == n and base_plan.p == p
                    and base_plan.m == pattern.m), (
                "base_plan was built for a different pattern/partitioning: "
                f"{(base_plan.n, base_plan.p, base_plan.m)} != "
                f"{(n, p, pattern.m)}")
        else:
            base_plan = build_comm_plan(pattern.indices, n, p,
                                        blocksize=blocksize,
                                        topology=topology)
        self._prepare(base_plan)
        self.strategy = strategy
        self._bind(base_plan, strategy)

    # ---- subclass hooks ----
    def _prepare(self, base_plan: CommPlan) -> None:
        """Derive direction-specific plan state before the rung is bound."""

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
