"""The paper's communication-strategy ladder (gather side), rank-stacked.

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
strategy also has a *targeted* finish that gathers the landed buffer
straight into the consumer's flat slot buffer ``(P, dest_len, ...)``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.comm.communicator import Work
from repro_torch.comm.plan import CommPlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = [
    "STRATEGIES",
    "replicate_gather_local",
    "condensed_start_local",
    "condensed_finish_local",
    "blockwise_start_local",
    "blockwise_finish_local",
    "dest_gather_local",
    "plan_device_args",
    "make_start_local",
]

STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")

# the data-movement steps each arm of ``make_start_local`` runs: the plain
# PyTorch versions, or the kernel wrappers (which take the plain version
# only for CPU tensors)
_PLAIN = (kref.pack_gather_ref, kref.unpack_scatter_set_ref,
          kref.unpack_dest_ref)
_KERNEL = (kops.pack_gather, kops.unpack_scatter_set, kops.unpack_dest)


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


def blockwise_finish_local(recv, x, recv_global_blk, offsets_blk, *, n: int,
                           blocksize: int, extra_slots: int = 0,
                           copy_own: bool = True,
                           unpack=kref.unpack_scatter_set_ref):
    """UPCv2 unpack: scatter whole landed blocks into x_copy.

    With ``extra_slots`` the dump block is remapped past the zero-guaranteed
    region so slots ``n+1 .. n+extra_slots`` stay zero (requires
    ``extra_slots < blocksize``).  ``offsets_blk`` counts blocks: rank q's
    own shard starts at block row ``q * blocks_per_shard``."""
    p = x.shape[0]
    feat = tuple(x.shape[2:])
    nblks = n // blocksize
    blk_idx = recv_global_blk.reshape(p, -1)
    if extra_slots:
        assert extra_slots < blocksize, (
            "zero-slot region must fit inside one virtual block")
        # dump block nblks would cover slots [n, n+BS); remap it one block
        # further so [n, n+BS) — including the zero slots — is never written
        blk_idx = torch.where(blk_idx == nblks, nblks + 1, blk_idx)
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
    ``(P, >= n, ...)``; ``"dest"`` returns the flat ``(P, dest_len, ...)``
    consumer-slot buffer with no full-length intermediate.

    ``use_kernel=True`` swaps the plain pack/unpack around the (unchanged)
    collective for the CUDA kernels (``kernels.ops``): bit-identical to the
    plain arm.  Replicate has no pack side, so only its targeted unpack
    runs a kernel.
    """
    pack, unpack_set, unpack_dest = _KERNEL if use_kernel else _PLAIN
    p, n = plan.p, plan.n
    dev = comm.device

    def deliver(recv_flat, x, dest):
        src, own_idx, own_mask, rem_mask = dest
        return unpack_dest(recv_flat, x, src, own_idx, own_mask, rem_mask)

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
                unpack=unpack_set)

        return start, finish
    raise ValueError(f"unknown strategy {strategy!r}")


def to_device(arrays, device) -> tuple[torch.Tensor, ...]:
    """Host plan arrays as tensors on ``device`` (dtypes kept)."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(device)
                 for a in arrays)
