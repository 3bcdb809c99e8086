"""Communication planning — the paper's "one-time preparation step" (§4.3.1).

Given the access pattern of an indirectly indexed computation (any global
index set ``cols``; the column index table ``J`` of an EllPack SpMV is one
instance), this module computes — on the host, once, exactly like the paper's
preparation step — everything the communication strategies need at run time:

* ``condensed``  (paper UPCv3): per (sender, receiver) pair, the exact sorted
  list of **unique** owned elements the receiver needs; messages are condensed
  (only needed values) and consolidated (one message per pair).
* ``blockwise``  (paper UPCv2): per receiver, the bitmap of *virtual blocks*
  (``blocksize`` elements each, the paper's BLOCKSIZE dial) containing at
  least one needed element; whole blocks are moved.
* ``replicate``  (naive baseline): no plan — the whole vector is all-gathered.

The access pattern is ``m`` accessor rows of ``r`` global indices each into a
shared vector of length ``n``; accessor rows and vector elements are both
partitioned contiguously over the same ``p`` shards.  For SpMV ``m == n``
(row i's accesses); for a token→expert dispatch ``m`` is the number of
expert-capacity slots while ``n`` is the number of tokens.

Ragged per-pair messages are padded to the plan-wide maximum (``s_max`` /
``b_max``), as in the JAX reference, whose static shapes required it; the
port keeps the padding because bit identity with the reference's tables and
recv buffers depends on it.  The padding volume is *counted and exposed*
(``padded_*`` fields) so the performance model can price it.

The plan also produces every count the paper's performance models (§5.2) need:
``C_local_indv`` / ``C_remote_indv`` (UPCv1, eq. 10), ``B_local`` /
``B_remote`` (UPCv2, eq. 11), and ``S_*`` / ``C_remote_out`` (UPCv3,
eqs. 12–15), split intra-node vs inter-node through a ``Topology``.

A numpy-only copy of ``repro.comm.plan`` (gather plans, and the push-side
``ScatterPlan`` derived from them), kept in the port so that it imports no
JAX.  Every array it builds equals the reference's, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Topology", "GatherCounts", "CommPlan", "ScatterPlan",
           "build_comm_plan", "blockwise_block_counts", "attach_destination",
           "pattern_cols", "derive_scatter_plan", "transpose_counts"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Maps shards ("threads") to nodes, like the paper's Abel layout.

    In the port's loopback runs all shards share one card; the topology
    still splits the §5 counts intra-node vs inter-node as the paper's
    compute nodes do.
    """

    num_shards: int
    shards_per_node: int

    def __post_init__(self):
        assert self.num_shards % self.shards_per_node == 0

    @property
    def num_nodes(self) -> int:
        return self.num_shards // self.shards_per_node

    def node_of(self, shard: np.ndarray | int):
        return np.asarray(shard) // self.shards_per_node


@dataclasses.dataclass(frozen=True)
class GatherCounts:
    """Per-shard communication counts feeding the §5 performance models.

    All arrays have length P (num shards).  Sizes are in *elements*.
    """

    # UPCv1 (eq. 10): occurrences of non-owned accesses (duplicates counted).
    c_local_indv: np.ndarray
    c_remote_indv: np.ndarray
    # UPCv2 (eq. 11): needed blocks by residence (own-node blocks include the
    # shard's own blocks — the diagonal term makes every own block needed).
    b_local: np.ndarray
    b_remote: np.ndarray
    blocksize: int
    # UPCv3 (eqs. 12–15): per-shard unique-value message volumes.
    s_local_out: np.ndarray
    s_remote_out: np.ndarray
    s_local_in: np.ndarray
    s_remote_in: np.ndarray
    c_remote_out: np.ndarray  # number of outgoing inter-node messages
    # padding tax: total elements actually moved by the padded collectives.
    padded_condensed_per_shard: int
    padded_blockwise_per_shard: int

    def total_condensed_volume(self) -> int:
        return int((self.s_local_out + self.s_remote_out).sum())

    def total_blockwise_volume(self) -> int:
        return int((self.b_local + self.b_remote).sum() * self.blocksize)


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Static gather plan for one access pattern over one partitioning."""

    n: int                     # global vector length
    p: int                     # number of shards on the comm axis
    shard_size: int            # n // p
    blocksize: int             # virtual block size (paper BLOCKSIZE)
    topology: Topology
    m: int                     # accessor rows (== n for SpMV-like patterns)

    # --- condensed (UPCv3) ---
    s_max: int
    send_counts: np.ndarray     # (P, P) int32; [src, dst]
    send_local_idx: np.ndarray  # (P, P, s_max) int32, local idx into src shard
    recv_global_idx: np.ndarray # (P, P, s_max) int32; [dst, src, k] -> global
                                # position in x_copy; padding -> n (dump slot)

    # --- blockwise (UPCv2) ---
    b_max: int
    send_block_counts: np.ndarray  # (P, P) int32
    send_local_blk: np.ndarray     # (P, P, b_max) int32, local block id in src
    recv_global_blk: np.ndarray    # (P, P, b_max) int32; [dst, src, j] ->
                                   # global block id; padding -> nblks (dump)

    # --- overlap (own/foreign compute split) ---
    # Per-row compaction of ``cols`` into own-shard accesses (resolvable from
    # x_local alone, while the all_to_all is in flight) and foreign accesses
    # (resolvable only after the condensed exchange lands).  ``*_src`` maps
    # each compacted slot back to its original r_nz slot so the engine can
    # split ``vals`` the same way on the host.
    r_loc_max: int
    r_rem_max: int
    loc_cols: np.ndarray  # (m, r_loc_max) int32 shard-local; padding -> shard_size
    loc_src: np.ndarray   # (m, r_loc_max) int32 original slot; padding -> 0
    rem_cols: np.ndarray  # (m, r_rem_max) int32 global; padding -> n + 1
    rem_src: np.ndarray   # (m, r_rem_max) int32 original slot; padding -> 0

    counts: GatherCounts

    # --- consumer-targeted unpack (optional ``Destination`` descriptor) ---
    # Precomputed recv-buffer -> consumer-slot gathers so ``finish`` can land
    # messages straight in the consumer's named buffers (O(L) slots) instead
    # of assembling the full-length x_copy.  All arrays are (P, L); each slot
    # is exactly one of {owned, foreign, zero}: ``dest_own_idx`` reads
    # x_local, ``dest_cond_src`` / ``dest_blk_src`` read the flattened
    # condensed / blockwise recv buffer, ``dest_global_idx`` reads the
    # replicate all-gather; the two int8 masks zero out the other source.
    dest_len: int = 0
    dest_own_idx: np.ndarray | None = None    # (P, L) int32 into x_local
    dest_own_mask: np.ndarray | None = None   # (P, L) int8, 1 where owned
    dest_rem_mask: np.ndarray | None = None   # (P, L) int8, 1 where foreign
    dest_cond_src: np.ndarray | None = None   # (P, L) int32 into (P*s_max)
    dest_blk_src: np.ndarray | None = None    # (P, L) into (P*b_max*BS)
    dest_global_idx: np.ndarray | None = None  # (P, L) int32 global ids

    @property
    def nblks(self) -> int:
        return self.n // self.blocksize

    @property
    def blocks_per_shard(self) -> int:
        return self.shard_size // self.blocksize

    @property
    def rows_per_shard(self) -> int:
        """Accessor rows owned by each shard (== shard_size when m == n)."""
        return self.m // self.p

    def transpose(self) -> "ScatterPlan":
        """The push-direction (put/scatter) plan for the same access pattern.

        The paper's condensing/consolidation machinery is direction-agnostic:
        its per-pair message lists depend only on *which* elements cross each
        (sender, receiver) boundary, not on which side initiates.  The
        transposed plan therefore reuses this plan's tables with the roles
        swapped — the gather's unpack table (``recv_global_idx``) becomes the
        scatter's pack table, and the gather's pack table (``send_local_idx``)
        becomes the scatter's accumulate-unpack table — plus a few O(m·r)
        derived arrays (message-slot positions per contribution, the
        ``reduce="set"`` winner mask, the touched-element mask).

        ``transpose()`` of the result returns this plan again (an involution).
        """
        return derive_scatter_plan(self)


def pattern_cols(plan: CommPlan) -> np.ndarray:
    """Reconstruct the (m, r) global index table the plan was built from.

    The overlap-split arrays (``loc_cols``/``loc_src``/``rem_cols``/
    ``rem_src``) are a lossless per-row compaction of the original ``cols``:
    valid owned slots carry local indices (< shard_size, padding ==
    shard_size), valid foreign slots carry global indices (< n, padding ==
    n + 1), and the ``*_src`` maps give each compacted slot's original
    position.  Inverting them recovers ``cols`` exactly, so a scatter plan
    can be derived from a cached gather plan without re-supplying the
    pattern.
    """
    m, shard = plan.m, plan.shard_size
    rows_shard = np.repeat(np.arange(plan.p), plan.rows_per_shard)
    lvalid = plan.loc_cols != shard
    rvalid = plan.rem_cols != plan.n + 1
    r = int(lvalid[0].sum() + rvalid[0].sum())
    cols = np.zeros((m, r), np.int64)
    li, lk = np.nonzero(lvalid)
    cols[li, plan.loc_src[li, lk]] = (plan.loc_cols[li, lk]
                                      + rows_shard[li] * shard)
    ri, rk = np.nonzero(rvalid)
    cols[ri, plan.rem_src[ri, rk]] = plan.rem_cols[ri, rk]
    return cols.astype(np.int32)


def transpose_counts(plan: CommPlan) -> GatherCounts:
    """Put-direction §5 volume counts: send and recv roles swapped.

    Per-shard outgoing volume in the put direction equals the gather's
    incoming volume (``s_*_in``) and vice versa; the outgoing inter-node
    message count becomes the number of distinct inter-node *receivers* this
    shard contributes to; block counts become the blocks this shard pushes,
    split by the receiver's node.  The fine-grained occurrence counts
    (``c_*_indv``) are unchanged — they count the accessor shard's foreign
    touches, which is the sender in the put direction.
    """
    p = plan.p
    node = plan.topology.node_of(np.arange(p))
    c = plan.counts
    sc = plan.send_counts          # [src, dst] in the gather direction
    sbc = plan.send_block_counts
    same = node[:, None] == node[None, :]   # [src, dst]
    # put sender q's message to s has the gather pair (s -> q)'s size
    c_rem_out = ((sc > 0) & ~same).sum(axis=0).astype(np.int64)
    b_local = (np.where(same, sbc, 0).sum(axis=0)
               + plan.blocks_per_shard).astype(np.int64)
    b_remote = np.where(same, 0, sbc).sum(axis=0).astype(np.int64)
    return GatherCounts(
        c_local_indv=c.c_local_indv,
        c_remote_indv=c.c_remote_indv,
        b_local=b_local,
        b_remote=b_remote,
        blocksize=plan.blocksize,
        s_local_out=c.s_local_in,
        s_remote_out=c.s_remote_in,
        s_local_in=c.s_local_out,
        s_remote_in=c.s_remote_out,
        c_remote_out=c_rem_out,
        padded_condensed_per_shard=c.padded_condensed_per_shard,
        padded_blockwise_per_shard=c.padded_blockwise_per_shard,
    )


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """Static push-direction (put/scatter) executor tables for one pattern.

    Derived from a gather ``CommPlan`` by ``CommPlan.transpose()`` — the
    base plan's per-pair tables are reused with send/recv roles swapped, so
    the O(nnz) preparation step is never repeated for the reverse direction.
    Accessor row i's slot j *contributes* a value to global element
    ``tgt_global[i, j]``; duplicate targets combine under a ``reduce``
    semantic chosen at execution time (``"add"`` / ``"set"`` / ``"max"``).

    All executor arrays are host numpy with leading dim m or P, sharded
    contiguously like the base plan (``strategies.scatter_plan_device_args``
    gives them the leading rank axis):

    * ``cond_msg_idx``: flat position of each contribution in the sender's
      padded (P, s_max) condensed message buffer (owned targets -> the dump
      slot ``p * s_max``); the receiver accumulates the landed buffer at
      ``base.send_local_idx[me]`` — the gather's pack table, role-swapped.
    * ``blk_msg_idx``: same for the blockwise (P, b_max, BS) buffer.
    * ``own_tgt_idx``: local position of owned targets (foreign -> the dump
      slot ``shard_size``) so own contributions accumulate without touching
      the network.
    * ``win_mask``: 1 on the single contribution slot that wins each target
      under ``reduce="set"`` (the last contributor in row-major accessor
      order) — masking all other slots to the reduce identity makes "set"
      deterministic on every rung.
    * ``touched``: 1 where an owned element receives at least one
      contribution — ``reduce="max"`` returns 0 (not the -inf identity) on
      untouched elements.
    """

    base: CommPlan
    tgt_global: np.ndarray    # (m, r) int32 global target per contribution
    cond_msg_idx: np.ndarray  # (m, r) int32 into (P*s_max); owned -> dump
    blk_msg_idx: np.ndarray   # (m, r) int32 into (P*b_max*BS); owned -> dump
    own_tgt_idx: np.ndarray   # (m, r) int32 into own shard; foreign -> dump
    win_mask: np.ndarray      # (m, r) int8, reduce="set" winner slots
    touched: np.ndarray       # (P, shard_size) int8, >=1 contribution
    counts: GatherCounts      # put-direction counts (see transpose_counts)

    # -- partitioning facts proxied from the base plan --
    @property
    def n(self) -> int:
        return self.base.n

    @property
    def p(self) -> int:
        return self.base.p

    @property
    def m(self) -> int:
        return self.base.m

    @property
    def r(self) -> int:
        return self.tgt_global.shape[1]

    @property
    def shard_size(self) -> int:
        return self.base.shard_size

    @property
    def blocksize(self) -> int:
        return self.base.blocksize

    @property
    def topology(self) -> Topology:
        return self.base.topology

    @property
    def s_max(self) -> int:
        return self.base.s_max

    @property
    def b_max(self) -> int:
        return self.base.b_max

    @property
    def blocks_per_shard(self) -> int:
        return self.base.blocks_per_shard

    @property
    def rows_per_shard(self) -> int:
        return self.base.rows_per_shard

    @property
    def dest_len(self) -> int:
        """Scatter delivery is always owner-targeted; no Destination."""
        return 0

    def transpose(self) -> CommPlan:
        """The pull-direction plan this was derived from (involution)."""
        return self.base


def derive_scatter_plan(plan: CommPlan) -> ScatterPlan:
    """Derive the push-direction executor tables from a gather plan.

    O(m·r·log s_max) searchsorted passes over the base plan's already-sorted
    per-pair lists — never a second O(nnz) planning step.  Prefer
    ``CommPlan.transpose()`` (this function is its implementation).
    """
    cols = pattern_cols(plan)
    p, n, shard = plan.p, plan.n, plan.shard_size
    m, r = cols.shape
    bs = plan.blocksize
    rows_per_shard = plan.rows_per_shard
    rows_shard = np.repeat(np.arange(p), rows_per_shard)
    owner = cols // shard
    own = owner == rows_shard[:, None]

    cond_msg = np.full((m, r), p * plan.s_max, np.int64)       # dump slot
    blk_msg = np.full((m, r), p * plan.b_max * bs, np.int64)   # dump slot
    for q in range(p):
        rows = slice(q * rows_per_shard, (q + 1) * rows_per_shard)
        # group this shard's foreign contributions by owner once (one
        # stable sort), then resolve each owner's contiguous segment —
        # O(m·r·log) total, never p passes over every contribution
        flat_c = cols[rows].ravel()
        foreign = np.flatnonzero(~own[rows].ravel())
        if not len(foreign):
            continue
        fo = owner[rows].ravel()[foreign]
        grp = np.argsort(fo, kind="stable")
        fo, fc, fslot = fo[grp], flat_c[foreign][grp], foreign[grp]
        bounds = np.searchsorted(fo, np.arange(p + 1))
        cflat = cond_msg[rows].reshape(-1)
        bflat = blk_msg[rows].reshape(-1)
        for s in range(p):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            if lo == hi:
                continue
            tgt, slot = fc[lo:hi], fslot[lo:hi]
            # the gather's unpack list for pair (q <- s) IS the put
            # direction's message contents for pair (q -> s): sorted unique
            # globals owned by s that q touches
            k = int(plan.send_counts[s, q])
            need = plan.recv_global_idx[q, s, :k]
            pos = np.searchsorted(need, tgt)
            assert k and (need[np.minimum(pos, k - 1)] == tgt).all(), (
                "gather plan does not cover this pattern")
            cflat[slot] = s * plan.s_max + pos
            kb = int(plan.send_block_counts[s, q])
            bneed = plan.recv_global_blk[q, s, :kb]
            bpos = np.searchsorted(bneed, tgt // bs)
            assert kb and (bneed[np.minimum(bpos, kb - 1)]
                           == tgt // bs).all(), (
                "gather plan is missing a needed block")
            bflat[slot] = s * plan.b_max * bs + bpos * bs + tgt % bs

    own_tgt = np.where(own, cols - rows_shard[:, None] * shard, shard)

    # reduce="set" winner: the last contribution in row-major accessor order
    flat_t = cols.ravel().astype(np.int64)
    order = np.arange(m * r, dtype=np.int64)
    last = np.full(n, -1, np.int64)
    np.maximum.at(last, flat_t, order)
    win = (last[flat_t] == order).reshape(m, r)

    touched = np.zeros(n, np.int8)
    touched[flat_t] = 1

    return ScatterPlan(
        base=plan,
        tgt_global=cols,
        cond_msg_idx=cond_msg.astype(np.int32),
        blk_msg_idx=blk_msg.astype(np.int32),
        own_tgt_idx=own_tgt.astype(np.int32),
        win_mask=win.astype(np.int8),
        touched=touched.reshape(p, shard),
        counts=transpose_counts(plan),
    )


def blockwise_block_counts(
    cols: np.ndarray,
    n: int,
    p: int,
    blocksize: int,
    topology: Topology,
) -> tuple[np.ndarray, np.ndarray]:
    """Eq.-11 block counts (B_local, B_remote per shard) for one BLOCKSIZE.

    A cheap standalone pass (no message arrays) so the autotuner can sweep
    BLOCKSIZE candidates without building a full plan per candidate.
    """
    cols = np.asarray(cols)
    m = cols.shape[0]
    shard_size = n // p
    rows_per_shard = m // p
    node = topology.node_of(np.arange(p))
    b_local = np.zeros(p, np.int64)
    b_remote = np.zeros(p, np.int64)
    own_blocks = shard_size // blocksize
    for q in range(p):
        cq = cols[q * rows_per_shard:(q + 1) * rows_per_shard].ravel()
        uniq = np.unique(cq[(cq // shard_size) != q])
        fblk = np.unique(uniq // blocksize)
        blk_owner_node = node[(fblk * blocksize) // shard_size]
        b_local[q] = int((blk_owner_node == node[q]).sum()) + own_blocks
        b_remote[q] = int((blk_owner_node != node[q]).sum())
    return b_local, b_remote


def attach_destination(plan: CommPlan, destination) -> CommPlan:
    """Precompute the recv→slot gathers for one ``Destination`` descriptor.

    ``destination`` is a ``repro_torch.comm.pattern.Destination`` (anything with a
    ``(P, L)`` int ``indices`` table; sentinel -1 = deliver exactly 0.0).
    For each device the L slots are classified owned / foreign / zero, and
    each foreign slot is resolved to its position in the landed condensed
    recv buffer ``(P, s_max)`` and blockwise recv buffer ``(P, b_max, BS)``.
    Raises ``ValueError`` if a foreign slot's global id is not part of the
    plan's access pattern — that value would never be exchanged.

    Returns a new ``CommPlan`` with the ``dest_*`` fields populated.
    """
    dest_idx = np.asarray(destination.indices)
    p, L = dest_idx.shape
    assert p == plan.p, (p, plan.p)
    shard_size = plan.shard_size
    n = plan.n

    g = dest_idx.astype(np.int64)
    zero = g < 0
    owner = np.where(zero, 0, g) // shard_size
    own = (~zero) & (owner == np.arange(p)[:, None])
    rem = (~zero) & ~own

    own_idx = np.where(
        own, g - (np.arange(p) * shard_size)[:, None], 0).astype(np.int32)
    cond_src = np.zeros((p, L), np.int32)
    blk_src = np.zeros((p, L), np.int32)
    bs = plan.blocksize
    for q in range(p):
        gq = g[q][rem[q]]
        if not len(gq):
            continue
        # condensed: position of each foreign id in the landed (P, s_max)
        rg = plan.recv_global_idx[q].ravel()
        valid = np.flatnonzero(rg != n)
        order = np.argsort(rg[valid], kind="stable")
        sorted_ids, flat_pos = rg[valid][order], valid[order]
        loc = np.searchsorted(sorted_ids, gq)
        hit = np.zeros(len(gq), bool)
        inb = loc < len(sorted_ids)
        hit[inb] = sorted_ids[loc[inb]] == gq[inb]
        if not hit.all():
            missing = np.unique(gq[~hit])[:8]
            raise ValueError(
                f"destination slot(s) on shard {q} read global ids "
                f"{missing.tolist()} that the access pattern never "
                "gathers — every foreign destination index must appear "
                "in the AccessPattern the plan was built from")
        cond_src[q][rem[q]] = flat_pos[loc]
        # blockwise: whole blocks land; position = block slot * BS + offset
        rb = plan.recv_global_blk[q].ravel()
        bvalid = np.flatnonzero(rb != plan.nblks)
        border = np.argsort(rb[bvalid], kind="stable")
        sorted_blk, blk_pos = rb[bvalid][border], bvalid[border]
        bloc = np.searchsorted(sorted_blk, gq // bs)
        assert (sorted_blk[np.minimum(bloc, len(sorted_blk) - 1)]
                == gq // bs).all(), "block plan missing a needed block"
        blk_src[q][rem[q]] = (blk_pos[bloc] * bs + gq % bs).astype(np.int32)

    return dataclasses.replace(
        plan,
        dest_len=L,
        dest_own_idx=own_idx,
        dest_own_mask=own.astype(np.int8),
        dest_rem_mask=rem.astype(np.int8),
        dest_cond_src=cond_src,
        dest_blk_src=blk_src,
        dest_global_idx=np.where(zero, 0, g).astype(np.int32),
    )


def build_comm_plan(
    cols: np.ndarray,
    n: int,
    p: int,
    *,
    blocksize: int | None = None,
    topology: Topology | None = None,
    destination=None,
    s_max: int | None = None,
) -> CommPlan:
    """One-time preparation step (paper §4.3.1).

    ``cols``: (m, r) global indices accessed while computing accessor row i.
    Vector elements are partitioned contiguously: shard q owns elements
    ``[q*shard_size, (q+1)*shard_size)``; accessor rows likewise: shard q owns
    rows ``[q*rows_per_shard, (q+1)*rows_per_shard)``.  ``m == n`` for
    SpMV-like patterns where every element is also an accessor.

    ``s_max`` widens the condensed padding to an *envelope* bound (≥ the
    pattern's natural per-pair maximum); the padded volume grows
    accordingly and is priced by ``counts.padded_*``.
    """
    assert n % p == 0, f"n={n} must divide into p={p} shards (pad upstream)"
    shard_size = n // p
    if blocksize is None:
        blocksize = shard_size
    assert shard_size % blocksize == 0, (
        f"shard_size={shard_size} must be a multiple of blocksize={blocksize}"
    )
    if topology is None:
        topology = Topology(num_shards=p, shards_per_node=p)
    assert topology.num_shards == p

    cols = np.asarray(cols)
    if cols.ndim == 1:
        cols = cols[:, None]
    m = cols.shape[0]
    assert m % p == 0, f"m={m} accessor rows must divide into p={p} shards"
    rows_per_shard = m // p
    owner = cols // shard_size  # (m, r_nz) owning shard of each access

    shard_rows = [slice(q * rows_per_shard, (q + 1) * rows_per_shard)
                  for q in range(p)]
    node = topology.node_of(np.arange(p))

    # ---- per-pair unique needed indices (condensed) ----
    # need[q][s] = sorted unique globals owned by s that shard q needs, s != q
    need: list[list[np.ndarray]] = []
    c_local_indv = np.zeros(p, np.int64)
    c_remote_indv = np.zeros(p, np.int64)
    b_local = np.zeros(p, np.int64)
    b_remote = np.zeros(p, np.int64)
    for q in range(p):
        cq = cols[shard_rows[q]].ravel()
        oq = owner[shard_rows[q]].ravel()
        foreign = oq != q
        same_node = node[oq] == node[q]
        c_local_indv[q] = int((foreign & same_node).sum())
        c_remote_indv[q] = int((foreign & ~same_node).sum())

        uniq = np.unique(cq[foreign])
        per_src = [uniq[(uniq // shard_size) == s] for s in range(p)]
        need.append(per_src)

        # blockwise: needed blocks (foreign blocks from J + all own blocks,
        # own blocks are always needed via the diagonal x[offset+k] term)
        fblk = np.unique(uniq // blocksize)
        own_blk_node_local = shard_size // blocksize  # own blocks, same node
        blk_owner_node = node[(fblk * blocksize) // shard_size]
        b_local[q] = int((blk_owner_node == node[q]).sum()) + own_blk_node_local
        b_remote[q] = int((blk_owner_node != node[q]).sum())

    # ---- condensed plan arrays ----
    send_counts = np.zeros((p, p), np.int32)
    for q in range(p):
        for s in range(p):
            send_counts[s, q] = len(need[q][s])
    natural_s_max = max(1, int(send_counts.max()))
    if s_max is None:
        s_max = natural_s_max
    assert s_max >= natural_s_max, (
        f"envelope s_max={s_max} is below the pattern's per-pair maximum "
        f"{natural_s_max}; widening-only (entries would be dropped)")

    send_local_idx = np.zeros((p, p, s_max), np.int32)
    recv_global_idx = np.full((p, p, s_max), n, np.int32)  # dump slot = n
    for q in range(p):
        for s in range(p):
            g = need[q][s]
            k = len(g)
            if k:
                send_local_idx[s, q, :k] = g - s * shard_size
                recv_global_idx[q, s, :k] = g

    # ---- blockwise plan arrays ----
    nblks = n // blocksize
    blocks_per_shard = shard_size // blocksize
    send_block_counts = np.zeros((p, p), np.int32)
    blk_need: list[list[np.ndarray]] = []
    for q in range(p):
        per_src = []
        for s in range(p):
            if len(need[q][s]):
                bl = np.unique(need[q][s] // blocksize)
            else:
                bl = np.zeros(0, np.int64)
            per_src.append(bl)
            send_block_counts[s, q] = len(bl)
        blk_need.append(per_src)
    b_max = max(1, int(send_block_counts.max()))

    send_local_blk = np.zeros((p, p, b_max), np.int32)
    recv_global_blk = np.full((p, p, b_max), nblks, np.int32)  # dump block
    for q in range(p):
        for s in range(p):
            bl = blk_need[q][s]
            k = len(bl)
            if k:
                send_local_blk[s, q, :k] = bl - s * blocks_per_shard
                recv_global_blk[q, s, :k] = bl

    # ---- overlap split: compact each row's accesses into own-shard vs
    # foreign slots (vectorized; stable order preserves the original slot
    # sequence inside each group) ----
    r_nz = cols.shape[1]
    rows_shard = np.repeat(np.arange(p), rows_per_shard)  # owning shard per row
    is_loc = owner == rows_shard[:, None]                 # (m, r_nz)
    loc_count = is_loc.sum(axis=1)
    rem_count = r_nz - loc_count
    r_loc_max = max(1, int(loc_count.max()))
    r_rem_max = max(1, int(rem_count.max()))
    pos = np.arange(r_nz)[None, :]

    order_loc = np.argsort(~is_loc, axis=1, kind="stable")  # own slots first
    cols_by_loc = np.take_along_axis(cols, order_loc, axis=1)
    lvalid = pos < loc_count[:, None]
    # padding -> shard_size: x_local is extended with one zero slot there
    loc_cols = np.where(
        lvalid, cols_by_loc - (rows_shard * shard_size)[:, None], shard_size
    )[:, :r_loc_max].astype(np.int32)
    loc_src = np.where(lvalid, order_loc, 0)[:, :r_loc_max].astype(np.int32)

    order_rem = np.argsort(is_loc, axis=1, kind="stable")   # foreign first
    cols_by_rem = np.take_along_axis(cols, order_rem, axis=1)
    rvalid = pos < rem_count[:, None]
    # padding -> n + 1: x_copy keeps that slot zero (n is the recv dump)
    rem_cols = np.where(rvalid, cols_by_rem, n + 1)[:, :r_rem_max].astype(
        np.int32)
    rem_src = np.where(rvalid, order_rem, 0)[:, :r_rem_max].astype(np.int32)

    # ---- perf-model counts (§5.2) ----
    s_out_l = np.zeros(p, np.int64)
    s_out_r = np.zeros(p, np.int64)
    s_in_l = np.zeros(p, np.int64)
    s_in_r = np.zeros(p, np.int64)
    c_rem_out = np.zeros(p, np.int64)
    for s in range(p):
        for q in range(p):
            k = int(send_counts[s, q])
            if k == 0:
                continue
            if node[s] == node[q]:
                s_out_l[s] += k
                s_in_l[q] += k
            else:
                s_out_r[s] += k
                s_in_r[q] += k
                c_rem_out[s] += 1

    counts = GatherCounts(
        c_local_indv=c_local_indv,
        c_remote_indv=c_remote_indv,
        b_local=b_local,
        b_remote=b_remote,
        blocksize=blocksize,
        s_local_out=s_out_l,
        s_remote_out=s_out_r,
        s_local_in=s_in_l,
        s_remote_in=s_in_r,
        c_remote_out=c_rem_out,
        padded_condensed_per_shard=p * s_max,
        padded_blockwise_per_shard=p * b_max * blocksize,
    )

    plan = CommPlan(
        n=n,
        p=p,
        shard_size=shard_size,
        blocksize=blocksize,
        topology=topology,
        m=m,
        s_max=s_max,
        send_counts=send_counts,
        send_local_idx=send_local_idx,
        recv_global_idx=recv_global_idx,
        b_max=b_max,
        send_block_counts=send_block_counts,
        send_local_blk=send_local_blk,
        recv_global_blk=recv_global_blk,
        r_loc_max=r_loc_max,
        r_rem_max=r_rem_max,
        loc_cols=loc_cols,
        loc_src=loc_src,
        rem_cols=rem_cols,
        rem_src=rem_src,
        counts=counts,
    )
    if destination is not None:
        plan = attach_destination(plan, destination)
    return plan
