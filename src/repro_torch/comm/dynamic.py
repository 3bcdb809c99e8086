"""Device-side plan derivation for capacity-bounded dynamic patterns.

Every other module in ``repro_torch.comm`` assumes the paper's premise:
the access pattern is known once, up front, so the O(nnz) preparation step
(§4.3.1) runs on the host exactly once.  MoE token→expert routing breaks
that premise: it changes *every batch*, and a host build per batch puts
the plan and its content hash on the hot path.

Capacity-bounded patterns have a *fixed shape*: a router always produces
``(num_experts, capacity)`` slots over ``num_tokens`` tokens, so every
executor table of the condensed rung has a static bound, the **envelope**
``s_max`` (no per-pair unique count can exceed ``min(shard_size,
rows_per_shard * r)``).  With ``s_max`` fixed, the tables themselves are
fixed-shape tensor computations on the device:

* ``derive_gather_tables`` reproduces ``plan.build_comm_plan``'s condensed
  tables (``send_local_idx`` / ``recv_global_idx`` / ``send_counts``),
  bit for bit with the host build at the same ``s_max``;
* ``derive_scatter_tables`` reproduces ``plan.derive_scatter_plan``'s put
  duals (``cond_msg_idx`` / ``own_tgt_idx`` / ``win_mask`` / ``touched``)
  from the same sort, so a dispatch→combine pair derives both directions
  from one pass (the ``CommPlan.transpose()`` economy, on the device).

Every step keeps static shapes and makes no host synchronisation: sorts,
scatters into buffers with a dump slot, cumulative sums and batched
``searchsorted`` over the ranks, never ``unique``, ``nonzero``, boolean
indexing, ``bincount`` or ``.item()``.  The tables of all ``P`` readers
are one ``(P, rows·r)`` batch.

``DynamicPattern`` is the front door: it wraps a representative
*template* ``AccessPattern`` (fixing ``m``, ``r``, ``n`` and the envelope)
and is accepted by ``IrregularGather`` / ``IrregularScatter`` /
``Schedule`` wherever an ``AccessPattern`` is.  The host-side envelope
plan the front doors resolve (``plan_cache.get_envelope_plan``, the
bucketed-reuse tier) provides the static sizes and the §5 pricing; the
per-batch tables come from the front doors' ``derive_plan_args(cols)``.
``models.moe.DynamicMoELayer`` is the consumer.

Over a ``DistComm`` whose process holds ``p_local`` of the ``P`` ranks,
every process derives the same global tables from the batch's whole
``(m, r)`` table, as the reference derives them outside its ``shard_map``,
and then keeps its own rows (``local_gather_tables``): a sender's tables
are the transposes of every reader's sorted lists, and the ``"set"``
winners come from one sort of all accessor rows, so no process could
derive its rows from its own readers alone.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.comm.pattern import AccessPattern

__all__ = ["DYNAMIC_STRATEGIES", "DynamicPattern", "DynamicGatherTables",
           "DynamicScatterTables", "envelope_s_max", "derive_gather_tables",
           "derive_scatter_tables", "local_gather_tables"]

# Rungs whose executor tables the device derivation covers: condensed and
# its own/foreign-split consumption (overlap) share the same two tables.
DYNAMIC_STRATEGIES = ("condensed", "overlap")


def envelope_s_max(m: int, r: int, n: int, p: int) -> int:
    """The capacity bound on any per-pair unique count.

    Reader shard q can need at most ``rows_per_shard * r`` distinct
    elements in total, and owner shard s only owns ``shard_size`` elements
    — whichever is smaller bounds every (s, q) message for every routing
    the pattern shape admits.

    >>> envelope_s_max(m=64, r=1, n=1024, p=8)   # 8 slots/shard, 1 idx each
    8
    >>> envelope_s_max(m=4096, r=2, n=64, p=8)   # tiny vector: shard wins
    8
    """
    assert n % p == 0 and m % p == 0, (n, m, p)
    return max(1, min(n // p, (m // p) * r))


@dataclasses.dataclass(frozen=True)
class DynamicPattern:
    """A capacity-bounded family of access patterns, one member per batch.

    ``template`` is any representative member: it fixes the static facts
    every batch shares — accessor count ``m``, row width ``r``, vector
    length ``n`` — and seeds the envelope plan the front doors resolve
    against.  ``s_max`` is the envelope bound on per-pair unique counts;
    the default (``envelope_s_max``) is always safe.  The per-batch index
    table goes to ``derive_plan_args``, never to the constructor.
    """

    template: AccessPattern
    s_max: int

    def __post_init__(self):
        assert isinstance(self.template, AccessPattern), type(self.template)
        assert self.s_max >= 1, self.s_max

    @classmethod
    def from_template(cls, template: AccessPattern, p: int,
                      s_max: int | None = None) -> "DynamicPattern":
        """Wrap a representative pattern; ``p`` (the rank count) fixes the
        envelope.  Pass ``s_max`` to tighten it when the workload
        guarantees a smaller bound (e.g. expert capacity < shard size)."""
        env = envelope_s_max(template.m, template.r, template.n, p)
        if s_max is None:
            s_max = env
        assert 1 <= s_max <= env, (
            f"s_max={s_max} must lie in [1, {env}] — above the envelope it "
            "wastes padded volume for nothing, and a bound the routing can "
            "exceed would silently drop table entries")
        return cls(template=template, s_max=s_max)

    # -- AccessPattern-shaped surface (the front doors read these) --
    @property
    def indices(self) -> np.ndarray:
        return self.template.indices

    @property
    def n(self) -> int:
        return self.template.n

    @property
    def m(self) -> int:
        return self.template.m

    @property
    def r(self) -> int:
        return self.template.r


class DynamicGatherTables(NamedTuple):
    """Device-derived condensed gather tables (``CommPlan`` field names)."""

    send_local_idx: torch.Tensor   # (P, P, s_max) int32, pad 0
    recv_global_idx: torch.Tensor  # (P, P, s_max) int32, pad n (dump slot)
    send_counts: torch.Tensor      # (P, P) int32; [src, dst]


class DynamicScatterTables(NamedTuple):
    """Device-derived put-direction duals (``ScatterPlan`` field names)."""

    cond_msg_idx: torch.Tensor     # (m, r) int32 into (P*s_max); owned -> dump
    own_tgt_idx: torch.Tensor      # (m, r) int32 into own shard; foreign -> dump
    win_mask: torch.Tensor         # (m, r) int8, reduce="set" winner slots
    touched: torch.Tensor          # (P, shard_size) int8


def local_gather_tables(g: DynamicGatherTables,
                        comm) -> DynamicGatherTables:
    """``g``'s rows for the ranks this process holds (``comm.local_rows``):
    ``send_local_idx`` and ``send_counts`` by sender row,
    ``recv_global_idx`` by reader row.  ``g`` itself where the process
    holds every rank."""
    assert g.send_counts.shape[0] == comm.p, (
        "local_gather_tables cuts the whole batch's tables, derived from "
        "its whole cols")
    if comm.p_local == comm.p:
        return g
    rows = comm.local_rows
    return DynamicGatherTables(send_local_idx=g.send_local_idx[rows],
                               recv_global_idx=g.recv_global_idx[rows],
                               send_counts=g.send_counts[rows])


def _cols(cols) -> torch.Tensor:
    """The batch's (m, r) index table as an int32 tensor, on the device it
    already lives on (a host array becomes a CPU tensor)."""
    if not isinstance(cols, torch.Tensor):
        cols = torch.as_tensor(np.asarray(cols))
    cols = cols.to(torch.int32)
    return cols[:, None] if cols.dim() == 1 else cols


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``x.cumsum(1)`` of an integer ``(P, K)`` tensor as one flat scan:
    the card scans a few long rows one block a row."""
    flat = x.reshape(-1).cumsum(0).reshape(x.shape)
    return flat - torch.cat([flat.new_zeros(1), flat[:-1, -1]])[:, None]


def derive_gather_tables(cols, n: int, p: int,
                         s_max: int) -> DynamicGatherTables:
    """The condensed tables of §4.3.1 as a fixed-shape computation on the
    device of ``cols``.

    ``cols`` is the batch's (m, r) global index table.  Bit for bit with
    ``build_comm_plan(cols, n, p, s_max=s_max)``'s condensed arrays: per
    reader q and owner s, the sorted unique foreign globals, padded to
    ``s_max`` with the dump conventions (``recv`` pads to ``n``, ``send``
    pads to 0).

    One sort per reader replaces the host's per-pair unique lists: foreign
    globals sort ascending (own accesses keyed to ``n`` fall to the end),
    first-occurrence masking dedups, and a per-owner segment rank places
    each unique at ``(owner, rank)``.  A rank past ``s_max`` (a routing
    outside the envelope), like every entry that is no unique, lands in a
    dump slot of its own past ``p·s_max``, which is cut off.
    """
    cols = _cols(cols)
    m = cols.shape[0]
    assert n % p == 0 and m % p == 0, (n, m, p)
    shard = n // p
    dev = cols.device
    i64 = torch.int64
    cq = cols.reshape(p, -1).to(i64)                       # (P, rows*r)
    reader = torch.arange(p, device=dev, dtype=i64)[:, None]
    # own accesses keyed past every real global sort to the tail
    key = torch.where(cq // shard != reader, cq, n)
    skey = torch.sort(key, dim=1).values
    first = torch.ones_like(skey, dtype=torch.bool)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    uniq = (first & (skey < n)).to(i64)
    sowner = torch.clamp(skey // shard, 0, p - 1)
    # each owner's keys are one stretch of the sorted row: its unique
    # count is the cumulative sum's rise over the stretch (a scatter_add_
    # would pile a hot owner's adds onto one counter)
    seen = torch.cat([uniq.new_zeros((p, 1)), _row_cumsum(uniq)], dim=1)
    edges = torch.searchsorted(skey, (torch.arange(
        p + 1, device=dev, dtype=i64) * shard).expand(p, -1).contiguous())
    per_owner = seen.gather(1, edges[:, 1:]) - seen.gather(1, edges[:, :-1])
    start = per_owner.cumsum(1) - per_owner
    rank = seen[:, 1:] - 1 - start.gather(1, sowner)
    # every entry that places no unique lands in a dump slot of its own,
    # cut off with the rest (one shared slot would serialize the writes)
    lane = torch.arange(skey.shape[1], device=dev, dtype=i64)
    pos = torch.where((uniq > 0) & (rank < s_max), sowner * s_max + rank,
                      p * s_max + lane)
    recv = torch.full((p, p * s_max + skey.shape[1]), n, dtype=i64,
                      device=dev)
    recv.scatter_(1, pos, skey)
    recv_global_idx = recv[:, :p * s_max].reshape(p, p, s_max)
    owner_base = (torch.arange(p, device=dev, dtype=i64) * shard)[None, :,
                                                                   None]
    send_local_idx = torch.where(recv_global_idx != n,
                                 recv_global_idx - owner_base, 0)
    return DynamicGatherTables(
        send_local_idx=send_local_idx.transpose(0, 1).to(
            torch.int32).contiguous(),
        recv_global_idx=recv_global_idx.to(torch.int32),
        send_counts=torch.clamp(per_owner, max=s_max).T.to(
            torch.int32).contiguous(),
    )


def derive_scatter_tables(cols, n: int, p: int, s_max: int,
                          gather: DynamicGatherTables | None = None,
                          ) -> DynamicScatterTables:
    """The put-direction duals of ``derive_scatter_plan``, on the device.

    Pass the ``gather`` tables when both directions are derived from one
    pattern (the fused dispatch→combine shape): the scatter's message-slot
    positions are ``searchsorted`` probes into the gather's already sorted
    per-pair lists.  Bit for bit with the host ``derive_scatter_plan`` on
    the matching envelope plan.
    """
    cols = _cols(cols)
    m, r = cols.shape
    shard = n // p
    dev = cols.device
    i64 = torch.int64
    if gather is None:
        gather = derive_gather_tables(cols, n, p, s_max)
    recv = gather.recv_global_idx.to(i64)                  # (P, P, s_max)
    flat = cols.reshape(p, -1).to(i64)                     # (P, rows*r)
    reader = torch.arange(p, device=dev, dtype=i64)[:, None]
    owner = flat // shard
    own = owner == reader
    # rank of each foreign target inside its (reader <- owner) sorted
    # unique list; rows pad with n > any target, so the probe lands
    # exactly.  Keyed owner·(n+1) + value, a reader's P lists in owner
    # order are one ascending row, so one probe of owner·(n+1) + target
    # counts the owner·s_max entries before its list and the ones below it
    # in it: owner·s_max + rank, in O(rows·r) memory a reader
    base = torch.arange(p, device=dev, dtype=i64)[None, :, None] * (n + 1)
    keys = (recv + base).reshape(p, p * s_max)
    probe = torch.clamp(owner, 0, p - 1) * (n + 1) + flat
    cond = torch.where(own, p * s_max, torch.searchsorted(keys, probe))
    own_tgt = torch.where(own, flat - reader * shard, shard)

    # reduce="set" winner: the last contribution in row-major accessor
    # order, global across shards (duplicates may span senders): the last
    # of its target's stretch in a stable sort, and a target is touched
    # where the sorted targets hold it (no scatter onto a hot target)
    flat_t = cols.reshape(-1).to(i64)
    st, order = torch.sort(flat_t, stable=True)
    last = torch.ones_like(st, dtype=torch.int8)
    last[:-1] = (st[:-1] != st[1:]).to(torch.int8)
    win_mask = torch.zeros(m * r, dtype=torch.int8, device=dev).scatter_(
        0, order, last).reshape(m, r)
    targets = torch.arange(n, device=dev, dtype=i64)
    at = torch.searchsorted(st, targets).clamp_(max=max(m * r - 1, 0))
    touched = ((st[at] == targets) if m * r else torch.zeros_like(
        targets, dtype=torch.bool)).to(torch.int8)
    return DynamicScatterTables(
        cond_msg_idx=cond.reshape(m, r).to(torch.int32),
        own_tgt_idx=own_tgt.reshape(m, r).to(torch.int32),
        win_mask=win_mask,
        touched=touched.reshape(p, shard),
    )
