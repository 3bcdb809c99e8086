"""The paper's communication-strategy ladder (both directions), rank-stacked.

Each strategy turns a sharded vector ``x`` — one tensor ``(P, shard, ...)``
whose row q is rank q's contiguous shard — into every rank's private copy
``x_copy`` ``(P, >= n, ...)``, the paper's ``mythread_x_copy``, which the
local computation then indexes with *global* indices.  Entries at index
>= n are a padding dump.  ``x`` may carry trailing feature dimensions: every
strategy moves whole feature rows.

The ``*_local`` functions are the reference's ``shard_map``-local functions
written once over the leading rank axis: where the reference reads
``axis_index``, the port reads the row number, and the collectives go
through a communicator (``comm.communicator``).

Strategies (paper §4):
  * ``replicate`` — naive: all-gather the whole vector (volume n per rank).
  * ``blockwise`` — UPCv2: move whole virtual blocks that contain >=1 needed
    element, via a padded block all_to_all (volume = needed blocks × BS).
  * ``condensed`` — UPCv3: pack exactly the unique needed values, one padded
    message per pair, single all_to_all, scatter-unpack (volume = Σ unique).
  * ``overlap``   — beyond paper: same condensed exchange, but the consumer
    splits its compute so the own-shard partial runs while the all_to_all is
    in flight (see ``comm.gather.OverlapHandle``); as a pure gather it is
    identical to ``condensed``.

The ``*_start_local`` / ``*_finish_local`` pairs split each strategy at its
collective so ``OverlapHandle`` can expose an own-compute window between the
two.  When the plan carries a ``Destination`` (``plan.dest_len > 0``), each
strategy also has a *targeted* finish that hands back the landed buffer with
the plan's four dest arrays (``Landed``), which the consumer delivers
straight into its flat slot buffer ``(P, dest_len, ...)``
(``dest_gather_local`` / ``kernels.unpack_dest``) or fuses into its own
compute (``kernels.unpack_dest_spmv``).

The push direction (put / scatter) runs the same rungs with the roles
swapped: see the second half of this module.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.comm.communicator import Work
from repro_torch.comm.plan import CommPlan, ScatterPlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = [
    "STRATEGIES",
    "replicate_gather_local",
    "condensed_start_local",
    "condensed_finish_local",
    "blockwise_start_local",
    "blockwise_finish_local",
    "Landed",
    "dest_gather_local",
    "plan_device_args",
    "make_start_local",
    "SCATTER_REDUCES",
    "replicate_scatter_start_local",
    "replicate_scatter_finish_local",
    "condensed_scatter_start_local",
    "condensed_scatter_finish_local",
    "blockwise_scatter_start_local",
    "blockwise_scatter_finish_local",
    "scatter_plan_device_args",
    "scatter_segment_tables",
    "make_scatter_start_local",
]

STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")


def _tiled_unpack():
    """The kernel arm's full unpack: ``kops.unpack_scatter_set`` through
    the tile tables of the plan it serves (a ``ScatterTiles`` of its own)."""
    tiles = kops.ScatterTiles()

    def unpack(recv, idx, x_own, offsets, *, out_len, copy_own=True):
        row_bytes = math.prod(x_own.shape[2:]) * x_own.element_size()
        return kops.unpack_scatter_set(
            recv, idx, x_own, offsets, out_len=out_len, copy_own=copy_own,
            table=tiles(idx, out_len=out_len, row_bytes=row_bytes))

    return unpack


def own_offsets(p: int, rows: int, device) -> torch.Tensor:
    """``(P,)`` int32: rank q's own rows start at ``q * rows``."""
    return torch.arange(0, p * rows, rows, dtype=torch.int32, device=device)


def replicate_gather_local(x: torch.Tensor, *, comm,
                           async_op: bool = False) -> Work:
    """Naive strategy: materialize the entire shared vector on every rank."""
    return comm.all_gather(x, async_op=async_op)


def condensed_start_local(x, send_local_idx, *, comm, async_op=False,
                          pack=kref.pack_gather_ref) -> Work:
    """UPCv3 pack + consolidated exchange (paper Listing 5 pack loop +
    ``upc_memput``/``upc_barrier``).  ``send_local_idx`` is ``(P, P,
    s_max)``; the landed ``(P, P, s_max, ...)`` recv buffer is not yet
    unpacked."""
    p, _, s_max = send_local_idx.shape
    feat = tuple(x.shape[2:])
    buf = pack(x, send_local_idx.reshape(p, p * s_max))
    return comm.all_to_all(buf.reshape((p, p, s_max) + feat),
                           async_op=async_op)


def condensed_finish_local(recv, x, recv_global_idx, offsets, *, n: int,
                           extra_slots: int = 0, copy_own: bool = True,
                           unpack=kref.unpack_scatter_set_ref):
    """UPCv3 unpack: scatter the landed messages into x_copy.

    Slot ``n`` is the recv padding dump (holds garbage); slots
    ``n+1 .. n+extra_slots`` are guaranteed zero (consumers use them as the
    padding target of their own index tables)."""
    p = x.shape[0]
    feat = tuple(x.shape[2:])
    return unpack(recv.reshape((p, -1) + feat), recv_global_idx.reshape(p, -1),
                  x, offsets, out_len=n + 1 + extra_slots, copy_own=copy_own)


def blockwise_start_local(x, send_local_blk, *, comm, blocksize: int,
                          async_op=False, pack=kref.pack_gather_ref) -> Work:
    """UPCv2 block exchange.  Returns the landed (P, P, b_max, BS, ...)
    blocks."""
    p, _, b_max = send_local_blk.shape
    feat = tuple(x.shape[2:])
    xb = x.reshape((p, -1, blocksize) + feat)
    buf = pack(xb, send_local_blk.reshape(p, p * b_max))
    return comm.all_to_all(buf.reshape((p, p, b_max, blocksize) + feat),
                           async_op=async_op)


def move_dump_block(recv_global_blk, nblks: int):
    """``recv_global_blk`` with the dump block ``nblks`` moved one block
    further (``blockwise_finish_local`` with ``extra_slots``)."""
    return torch.where(recv_global_blk == nblks, nblks + 1, recv_global_blk)


def blockwise_finish_local(recv, x, recv_global_blk, offsets_blk, *, n: int,
                           blocksize: int, extra_slots: int = 0,
                           copy_own: bool = True,
                           unpack=kref.unpack_scatter_set_ref,
                           moved_blk=None):
    """UPCv2 unpack: scatter whole landed blocks into x_copy.

    With ``extra_slots`` the dump block is remapped past the zero-guaranteed
    region so slots ``n+1 .. n+extra_slots`` stay zero (requires
    ``extra_slots < blocksize``); ``moved_blk`` may hand in that remapped
    copy of ``recv_global_blk`` (``move_dump_block``), kept from an earlier
    call.  ``offsets_blk`` counts blocks: rank q's own shard starts at block
    row ``q * blocks_per_shard``."""
    p = x.shape[0]
    feat = tuple(x.shape[2:])
    nblks = n // blocksize
    blk_idx = recv_global_blk.reshape(p, -1)
    if extra_slots:
        assert extra_slots < blocksize, (
            "zero-slot region must fit inside one virtual block")
        # dump block nblks would cover slots [n, n+BS); remap it one block
        # further so [n, n+BS) — including the zero slots — is never written
        blk_idx = (move_dump_block(blk_idx, nblks) if moved_blk is None
                   else moved_blk.reshape(p, -1))
        out_blocks = nblks + 2
    else:
        out_blocks = nblks + 1
    # own copy lands at flat offset q*shard_size == block row
    # q*blocks_per_shard — block-aligned, so the block-unit unpack writes
    # the exact same elements as a flat one
    x_blocks = unpack(recv.reshape((p, -1, blocksize) + feat), blk_idx,
                      x.reshape((p, -1, blocksize) + feat), offsets_blk,
                      out_len=out_blocks, copy_own=copy_own)
    return x_blocks.reshape((p, -1) + feat)


class Landed(NamedTuple):
    """A targeted finish's result: the landed recv buffer ``(P, R, ...)``,
    the local operand, and the plan's four dest arrays ``(P, L)`` — the
    arguments of ``dest_gather_local`` / ``kernels.unpack_dest``, in order."""

    recv_flat: torch.Tensor
    x_local: torch.Tensor
    src_idx: torch.Tensor
    own_idx: torch.Tensor
    own_mask: torch.Tensor
    rem_mask: torch.Tensor


def dest_gather_local(recv_flat, x_local, src_idx, own_idx, own_mask,
                      rem_mask):
    """Consumer-targeted unpack: deliver values straight into the L named
    slots of every rank.  Each slot is exactly one of {owned, foreign,
    zero}: owned slots gather from ``x_local``, foreign slots from the
    landed recv buffer, and zero slots (both masks 0) read exactly 0.0."""
    return kref.unpack_dest_ref(recv_flat, x_local, src_idx, own_idx,
                                own_mask, rem_mask)


def plan_device_args(plan: CommPlan, strategy: str,
                     with_dest: bool = False) -> tuple[Any, ...]:
    """Host (numpy) plan arrays each strategy needs, every one shaped
    ``(P, ...)``: row q is rank q's slice.

    ``with_dest=True`` (requires a plan built with a ``Destination``)
    appends the four targeted-unpack arrays: the strategy's recv-buffer
    source index, the own-shard index, and the owned/foreign masks.
    """
    if strategy == "replicate":
        base = ()
    elif strategy in ("condensed", "overlap"):
        base = (plan.send_local_idx, plan.recv_global_idx)
    elif strategy == "blockwise":
        base = (plan.send_local_blk, plan.recv_global_blk)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    if not with_dest:
        return base
    assert plan.dest_own_idx is not None, (
        "plan has no Destination; build it with destination=")
    src = {"replicate": plan.dest_global_idx,
           "blockwise": plan.dest_blk_src}.get(strategy, plan.dest_cond_src)
    return base + (src, plan.dest_own_idx, plan.dest_own_mask,
                   plan.dest_rem_mask)


def make_start_local(plan: CommPlan, strategy: str, comm, *,
                     use_kernel: bool = False):
    """Returns (start_fn, finish_fn) splitting the strategy at its collective.

    ``start_fn(x, *plan_args, async_op=False) -> Work``; ``finish_fn(work,
    x, *plan_args, extra_slots=..., copy_own=..., materialize=...)``.
    Between the two calls the consumer runs compute that depends only on
    ``x`` — the generalized own/foreign window of the ``overlap`` rung.
    ``plan_args`` are ``plan_device_args`` as tensors on ``comm.device``.

    When the plan args carry the four targeted-unpack arrays, ``finish``
    honors ``materialize``: ``"full"`` assembles the classic x_copy
    ``(P, >= n, ...)``; ``"dest"`` returns the landed buffer with the four
    dest arrays (``Landed``), which the caller delivers into its
    ``(P, dest_len, ...)`` slots with no full-length intermediate.

    ``use_kernel=True`` swaps the plain pack/unpack around the (unchanged)
    collective for the CUDA kernels (``kernels.ops``): bit-identical to the
    plain arm.  Replicate has no pack side and its full finish no unpack.
    """
    if use_kernel:
        pack, unpack_set = kops.pack_gather, _tiled_unpack()
    else:
        pack, unpack_set = kref.pack_gather_ref, kref.unpack_scatter_set_ref
    p, n = plan.p, plan.n
    dev = comm.device

    def deliver(recv_flat, x, dest):
        return Landed(recv_flat, x, *dest)

    if strategy == "replicate":
        def start(x, *args, async_op=False):
            return replicate_gather_local(x, comm=comm, async_op=async_op)

        def finish(work, x, *args, extra_slots=0, copy_own=True,
                   materialize="full"):
            recv = work.wait()
            if materialize == "dest":
                return deliver(recv, x, args)
            if extra_slots:
                pad = recv.new_zeros((p, 1 + extra_slots)
                                     + tuple(x.shape[2:]))
                return torch.cat([recv, pad], dim=1)
            return recv

        return start, finish
    if strategy in ("condensed", "overlap"):
        offsets = own_offsets(p, plan.shard_size, dev)

        def start(x, send_idx, recv_idx, *dest, async_op=False):
            return condensed_start_local(x, send_idx, comm=comm,
                                         async_op=async_op, pack=pack)

        def finish(work, x, send_idx, recv_idx, *dest, extra_slots=0,
                   copy_own=True, materialize="full"):
            recv = work.wait()
            if materialize == "dest":
                return deliver(recv.reshape((p, -1) + tuple(x.shape[2:])),
                               x, dest)
            return condensed_finish_local(
                recv, x, recv_idx, offsets, n=n, extra_slots=extra_slots,
                copy_own=copy_own, unpack=unpack_set)

        return start, finish
    if strategy == "blockwise":
        blocksize = plan.blocksize
        offsets_blk = own_offsets(p, plan.blocks_per_shard, dev)
        # the plan's recv_blk with its dump block moved (extra_slots), made
        # once, so that the tile table built from it serves every call
        moved = []

        def moved_blk(recv_blk):
            if not moved or moved[0] is not recv_blk:
                moved[:] = [recv_blk, move_dump_block(recv_blk, plan.nblks)]
            return moved[1]

        def start(x, send_blk, recv_blk, *dest, async_op=False):
            return blockwise_start_local(x, send_blk, comm=comm,
                                         blocksize=blocksize,
                                         async_op=async_op, pack=pack)

        def finish(work, x, send_blk, recv_blk, *dest, extra_slots=0,
                   copy_own=True, materialize="full"):
            recv = work.wait()
            if materialize == "dest":
                return deliver(recv.reshape((p, -1) + tuple(x.shape[2:])),
                               x, dest)
            return blockwise_finish_local(
                recv, x, recv_blk, offsets_blk, n=n, blocksize=blocksize,
                extra_slots=extra_slots, copy_own=copy_own,
                unpack=unpack_set,
                moved_blk=moved_blk(recv_blk) if extra_slots else None)

        return start, finish
    raise ValueError(f"unknown strategy {strategy!r}")


def to_device(arrays, device) -> tuple[torch.Tensor, ...]:
    """Host plan arrays as tensors on ``device`` (dtypes kept)."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


# --------------------------------------------------------------------------
# Push direction (put / scatter): the same rung ladder, roles swapped.
#
# Each scatter strategy turns a table of *contributions* ``vals`` — one
# tensor ``(P, rows, r, ...)`` whose slot (q, i, j) contributes to global
# element ``tgt_global[q*rows + i, j]`` — into every rank's combined owned
# slice ``y`` ``(P, shard, ...)``.  Duplicate targets combine under
# ``reduce``:
#
#   * "add" — y[t] = sum of contributions (0 where none);
#   * "max" — y[t] = max of contributions (0 where none; the -inf identity
#     is masked out by the plan's static ``touched`` table);
#   * "set" — y[t] = the last contribution in row-major accessor order
#     (0 where none): "add" after the plan's winner mask zeroes every
#     non-winning slot, so it is deterministic and rides the same collective
#     on every rung.
#
# The pack side combines duplicates *before* the wire (sender-side
# condensing); padded message lanes carry the reduce identity, so the
# receiver's accumulate treats them as no-ops without any masking.  Every
# combine goes through an ``accumulate`` (``accumulate_segments`` shape) or
# ``accumulate_into`` callable: the plain PyTorch versions, which start from
# ``kernels.ref.reduce_identity``, or the kernel wrappers bound to their
# segment tables (``make_scatter_start_local``).
# --------------------------------------------------------------------------

SCATTER_REDUCES = ("add", "set", "max")


def _trailing(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask`` with singleton dims appended to broadcast against ``like``."""
    return mask.reshape(tuple(mask.shape) + (1,) * (like.dim() - mask.dim()))


def _apply_set_mask(vals: torch.Tensor, win_mask: torch.Tensor,
                    reduce: str) -> torch.Tensor:
    if reduce != "set":
        return vals
    return vals * _trailing(win_mask, vals).to(vals.dtype)


def _mask_untouched(y: torch.Tensor, touched: torch.Tensor,
                    reduce: str) -> torch.Tensor:
    """reduce="max" leaves the -inf identity on never-written elements;
    the static touched table replaces it with the documented 0."""
    if reduce != "max":
        return y
    return torch.where(_trailing(touched, y) > 0, y,
                       torch.zeros((), dtype=y.dtype, device=y.device))


def _lanes(vals: torch.Tensor) -> torch.Tensor:
    """``(P, rows, r, ...)`` -> ``(P, rows * r, ...)``."""
    return vals.reshape((vals.shape[0], -1) + tuple(vals.shape[3:]))


def own_rows(x_full: torch.Tensor, shard: int) -> torch.Tensor:
    """Rank q's own rows ``x_full[q, q*shard : (q+1)*shard, ...]``."""
    p = x_full.shape[0]
    feat = tuple(x_full.shape[2:])
    blocks = x_full[:, :p * shard].reshape((p, p, shard) + feat)
    ranks = torch.arange(p, device=x_full.device)
    return blocks[ranks, ranks]


def replicate_scatter_start_local(vals, tgt, win_mask, *, comm, n: int,
                                  reduce: str, async_op=False,
                                  accumulate=kref.accumulate_segments_ref
                                  ) -> Work:
    """Naive put: every rank combines ALL its contributions into a private
    full-length accumulator, then a whole-vector all-reduce (sum / max)
    delivers each owner its slice — the push dual of the replicate
    all-gather, O(n) volume per rank."""
    p = vals.shape[0]
    v = _apply_set_mask(vals, win_mask, reduce)
    acc = accumulate(_lanes(v), tgt.reshape(p, -1), out_len=n, reduce=reduce)
    return comm.all_reduce(acc, "max" if reduce == "max" else "sum",
                           async_op=async_op)


def replicate_scatter_finish_local(work, touched, *, shard_size: int,
                                   reduce: str):
    y = own_rows(work.wait(), shard_size)
    return _mask_untouched(y, touched, reduce)


def condensed_scatter_start_local(vals, cond_msg_idx, win_mask, *, comm,
                                  p: int, s_max: int, reduce: str,
                                  async_op=False,
                                  accumulate=kref.accumulate_segments_ref
                                  ) -> Work:
    """UPCv3 put: sender-side segment-combine into one padded message per
    (sender, receiver) pair, then the consolidated exchange (the transpose
    of the gather's pack + ``upc_memput``).  The landed ``(P, P, s_max,
    ...)`` contribution buffer is not yet accumulated."""
    feat = tuple(vals.shape[3:])
    v = _apply_set_mask(vals, win_mask, reduce)
    buf = accumulate(_lanes(v), cond_msg_idx.reshape(p, -1),
                     out_len=p * s_max + 1, reduce=reduce)
    return comm.all_to_all(buf[:, :p * s_max].reshape((p, p, s_max) + feat),
                           async_op=async_op)


def condensed_scatter_finish_local(work, vals, unpack_idx, own_idx,
                                   win_mask, touched, *, shard_size: int,
                                   reduce: str,
                                   accumulate=kref.accumulate_segments_ref,
                                   accumulate_into=kref.accumulate_into_ref):
    """Accumulate-unpack: own contributions combine first, never touching
    the wire (so this runs while the exchange is in flight), then the landed
    foreign contributions combine into the owned slice at the gather's pack
    positions (``unpack_idx`` = base ``send_local_idx``, roles swapped).
    Padded lanes carry the reduce identity, so no masking is needed."""
    p = vals.shape[0]
    feat = tuple(vals.shape[3:])
    v = _apply_set_mask(vals, win_mask, reduce)
    own = accumulate(_lanes(v), own_idx.reshape(p, -1),
                     out_len=shard_size + 1, reduce=reduce)
    recv = work.wait()
    acc = accumulate_into(own, recv.reshape((p, -1) + feat),
                          unpack_idx.reshape(p, -1), reduce=reduce)
    return _mask_untouched(acc[:, :shard_size], touched, reduce)


def blockwise_scatter_start_local(vals, blk_msg_idx, win_mask, *, comm,
                                  p: int, b_max: int, blocksize: int,
                                  reduce: str, async_op=False,
                                  accumulate=kref.accumulate_segments_ref
                                  ) -> Work:
    """UPCv2 put: contributions combine into whole virtual blocks (only
    blocks containing >= 1 target travel); one padded block all_to_all.
    The landed ``(P, P, b_max * BS, ...)`` blocks are not yet combined."""
    feat = tuple(vals.shape[3:])
    v = _apply_set_mask(vals, win_mask, reduce)
    width = b_max * blocksize
    buf = accumulate(_lanes(v), blk_msg_idx.reshape(p, -1),
                     out_len=p * width + 1, reduce=reduce)
    return comm.all_to_all(buf[:, :p * width].reshape((p, p, width) + feat),
                           async_op=async_op)


def blockwise_scatter_finish_local(work, vals, unpack_blk, own_idx, win_mask,
                                   touched, *, shard_size: int,
                                   blocksize: int, reduce: str,
                                   accumulate=kref.accumulate_segments_ref,
                                   accumulate_blocks=(
                                       kref.accumulate_segments_ref)):
    """Own contributions combine first (inside the exchange window), then
    the landed blocks combine whole into the owned blocks at the gather's
    block pack positions (``unpack_blk`` = base ``send_local_blk``)."""
    p = vals.shape[0]
    feat = tuple(vals.shape[3:])
    v = _apply_set_mask(vals, win_mask, reduce)
    own = accumulate(_lanes(v), own_idx.reshape(p, -1),
                     out_len=shard_size + 1, reduce=reduce)
    y_own = own[:, :shard_size]
    blocks_per_shard = shard_size // blocksize
    recv = work.wait()
    accb = accumulate_blocks(recv.reshape((p, -1, blocksize) + feat),
                             unpack_blk.reshape(p, -1),
                             out_len=blocks_per_shard + 1, reduce=reduce)
    y_blocks = accb[:, :blocks_per_shard].reshape((p, shard_size) + feat)
    y = (kref.maximum(y_blocks, y_own) if reduce == "max"
         else y_blocks + y_own)
    return _mask_untouched(y, touched, reduce)


def scatter_plan_device_args(splan: ScatterPlan, strategy: str):
    """Host (numpy) plan arrays each scatter strategy needs, every one
    shaped ``(P, ...)``: row q is rank q's slice.

    The condensed/overlap and blockwise rungs reuse the *base gather plan's*
    pack tables (``send_local_idx`` / ``send_local_blk``) as their
    accumulate-unpack tables — the send/recv role swap made concrete.
    """
    p = splan.p

    def ranked(a):
        return a.reshape((p, -1) + a.shape[1:])

    if strategy == "replicate":
        return (ranked(splan.tgt_global), ranked(splan.win_mask),
                splan.touched)
    if strategy in ("condensed", "overlap"):
        return (ranked(splan.cond_msg_idx), splan.base.send_local_idx,
                ranked(splan.own_tgt_idx), ranked(splan.win_mask),
                splan.touched)
    if strategy == "blockwise":
        return (ranked(splan.blk_msg_idx), splan.base.send_local_blk,
                ranked(splan.own_tgt_idx), ranked(splan.win_mask),
                splan.touched)
    raise ValueError(f"unknown strategy {strategy!r}")


def _padding_lanes(counts: np.ndarray, width: int, device) -> torch.Tensor:
    """``(P, P * width)`` bool: lane j of rank q's row d is padding when
    ``j >= counts[q, d]``."""
    lane = torch.arange(width, device=device)
    filled = torch.as_tensor(counts, device=device)[:, :, None]
    return (lane >= filled).reshape(counts.shape[0], -1)


def scatter_segment_tables(splan: ScatterPlan, strategy: str,
                           plan_args) -> dict:
    """The kernel arm's ``SegmentTable`` for every combine of one rung,
    built once from the rung's plan arrays on their device
    (``plan_args``, as ``scatter_plan_device_args`` orders them):

    * replicate: ``"all"`` (every contribution into the n-long vector);
    * condensed/overlap: ``"pack"`` (dump slot ``P·s_max`` left out),
      ``"own"`` (dump ``shard_size`` left out) and ``"into"`` (the gather's
      padded pack lanes left out, recorded as padding);
    * blockwise: ``"pack"``, ``"own"`` and ``"blocks"`` (padded blocks left
      out, recorded as padding).
    """
    p, shard = splan.p, splan.shard_size
    table = kops.segment_table
    if strategy == "replicate":
        tgt = plan_args[0]
        return {"all": table(tgt.reshape(p, -1), out_len=splan.n)}
    msg, unpack, own = plan_args[:3]
    dev = msg.device
    tables = {"own": table(own.reshape(p, -1), out_len=shard + 1,
                           live_len=shard)}
    if strategy in ("condensed", "overlap"):
        live = p * splan.s_max
        tables["pack"] = table(msg.reshape(p, -1), out_len=live + 1,
                               live_len=live)
        tables["into"] = table(
            unpack.reshape(p, -1), out_len=shard + 1, live_len=shard,
            pad=_padding_lanes(splan.base.send_counts, splan.s_max, dev))
        return tables
    if strategy == "blockwise":
        live = p * splan.b_max * splan.blocksize
        nblk = splan.blocks_per_shard
        tables["pack"] = table(msg.reshape(p, -1), out_len=live + 1,
                               live_len=live)
        tables["blocks"] = table(
            unpack.reshape(p, -1), out_len=nblk + 1, live_len=nblk,
            pad=_padding_lanes(splan.base.send_block_counts, splan.b_max,
                               dev))
        return tables
    raise ValueError(f"unknown strategy {strategy!r}")


def make_scatter_start_local(splan: ScatterPlan, strategy: str, comm,
                             reduce: str, *, use_kernel: bool = False,
                             tables: dict | None = None):
    """Returns (start_fn, finish_fn) splitting the scatter at its collective.

    ``start_fn(vals, *plan_args, async_op=False) -> Work`` packs
    (sender-side combine) and issues the exchange; ``finish_fn(work, vals,
    *plan_args) -> y`` ``(P, shard, ...)`` runs the own-accumulate — which
    depends only on local contributions, so it runs while the exchange is in
    flight (on the card the loopback copy runs on a side stream) — and then
    combines the landed foreign contributions.  The ``overlap`` rung is the
    ``condensed`` exchange consumed through this split.

    ``use_kernel=True`` swaps the plain combines for the CUDA kernels
    (``kernels.ops.accumulate_segments`` for the sender-side pack, the
    own-target accumulate and the blockwise block combine;
    ``accumulate_into`` for the landed-foreign fold), each bound to its
    ``tables`` entry (``scatter_segment_tables``).  Bit-identical to the
    plain arm on every rung × reduce (same combines, same lane order).  The
    winner mask for ``reduce="set"`` stays a PyTorch multiply outside the
    kernels, exactly where the plain arm applies it.
    """
    if reduce not in SCATTER_REDUCES:
        raise ValueError(f"reduce must be one of {SCATTER_REDUCES}")
    if use_kernel and tables is None:
        raise ValueError("use_kernel=True needs the rung's segment tables "
                         "(scatter_segment_tables)")

    def seg(name):
        if not use_kernel:
            return kref.accumulate_segments_ref
        return functools.partial(kops.accumulate_segments,
                                 table=tables[name])

    p, shard = splan.p, splan.shard_size
    if strategy == "replicate":
        acc_all = seg("all")

        def start(vals, tgt, win, touched, *, async_op=False):
            return replicate_scatter_start_local(
                vals, tgt, win, comm=comm, n=splan.n, reduce=reduce,
                async_op=async_op, accumulate=acc_all)

        def finish(work, vals, tgt, win, touched):
            return replicate_scatter_finish_local(
                work, touched, shard_size=shard, reduce=reduce)

        return start, finish
    acc_pack, acc_own = seg("pack"), seg("own")
    if strategy in ("condensed", "overlap"):
        acc_into = (functools.partial(kops.accumulate_into,
                                      table=tables["into"])
                    if use_kernel else kref.accumulate_into_ref)

        def start(vals, msg_idx, unpack_idx, own_idx, win, touched, *,
                  async_op=False):
            return condensed_scatter_start_local(
                vals, msg_idx, win, comm=comm, p=p, s_max=splan.s_max,
                reduce=reduce, async_op=async_op, accumulate=acc_pack)

        def finish(work, vals, msg_idx, unpack_idx, own_idx, win, touched):
            return condensed_scatter_finish_local(
                work, vals, unpack_idx, own_idx, win, touched,
                shard_size=shard, reduce=reduce, accumulate=acc_own,
                accumulate_into=acc_into)

        return start, finish
    if strategy == "blockwise":
        acc_blocks = seg("blocks")

        def start(vals, msg_idx, unpack_blk, own_idx, win, touched, *,
                  async_op=False):
            return blockwise_scatter_start_local(
                vals, msg_idx, win, comm=comm, p=p, b_max=splan.b_max,
                blocksize=splan.blocksize, reduce=reduce, async_op=async_op,
                accumulate=acc_pack)

        def finish(work, vals, msg_idx, unpack_blk, own_idx, win, touched):
            return blockwise_scatter_finish_local(
                work, vals, unpack_blk, own_idx, win, touched,
                shard_size=shard, blocksize=splan.blocksize, reduce=reduce,
                accumulate=acc_own, accumulate_blocks=acc_blocks)

        return start, finish
    raise ValueError(f"unknown strategy {strategy!r}")
