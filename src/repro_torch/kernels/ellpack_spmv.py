"""Modified-EllPack SpMV on the rank-stacked private copies.

Wrapper of the CUDA kernel in ``csrc/ellpack_spmv.cu``, which replaces the
Pallas kernel ``ellpack_spmv_windowed`` of ``repro/kernels/ellpack_spmv.py``.
It keeps the reference's one-time window plan (``kernels.ops``) and its
arrays — ``win_blk`` per row block, ``cols_rel`` / ``own_rel`` relative to
the window start — but reads ``x`` in place at the absolute positions
``win_blk * window + rel``: on the card no padded copy of ``x`` is made.
Given the plan's ``order_table`` (r a multiple of 4, at most 32), the card
runs the column-sorted kernel, which reads x in the table's order; without
one it runs the row-order kernel.  The planners keep the table beside their
plan in a ``PlanOrder``, built at the plan's first call on a card.  A CUDA
tensor always goes through a kernel (or the call raises); a CPU tensor
takes the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.pack_gather import on_card, require

__all__ = ["ellpack_spmv_windowed", "order_table", "sortable", "PlanOrder"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows a block of the column-sorted kernel stages (csrc kSortRows)
SORT_ROWS = 1024


def order_table(cols_rel, win_blk, *, window: int, rows_per_block: int,
                group_rows: int):
    """The column-sorted kernel's table: per rank, the entries of every
    group of ``group_rows`` consecutive rows sorted by the x position they
    read (``win_blk * window + cols_rel``; ties in entry order).  Returns
    ``(pos, slot)``, both ``(P, rows * r)``: ``pos`` int32, the position;
    ``slot`` int16 holding the uint16 ``(row - group start) * r + j``.
    Group g's entries fill ``[g * group_rows * r, ...)``, as in
    ``cols_rel``: the table permutes each group's entries in place."""
    p, rows, r = cols_rel.shape
    dev = cols_rel.device
    base = (win_blk.to(torch.int64) * window).repeat_interleave(
        rows_per_block, dim=1)
    pos = (base[:, :, None] + cols_rel).reshape(p, -1)
    entry = torch.arange(rows * r, device=dev)
    group = entry // (group_rows * r)
    order = torch.sort(group * (1 << 32) + pos, dim=1, stable=True).indices
    slot = order - group * (group_rows * r)
    slot = torch.where(slot >= 1 << 15, slot - (1 << 16), slot)
    return (pos.gather(1, order).to(torch.int32).contiguous(),
            slot.to(torch.int16).contiguous())


def sortable(r: int) -> bool:
    """Whether the column-sorted kernel takes rows of ``r`` entries (its
    16-bit slots and its shared memory hold SORT_ROWS rows of at most 32,
    read four at a time)."""
    return r % 4 == 0 and r <= 32


class PlanOrder:
    """A window plan's ``order_table`` on each card, in SORT_ROWS groups:
    built at the plan's first call there, from the plan arrays that call
    gives, and kept beside the plan.  Calling it with other arrays builds
    their table instead."""

    def __init__(self, *, window: int, rows_per_block: int):
        self.window, self.rows_per_block = window, rows_per_block
        self._by_device: dict = {}

    def __call__(self, cols_rel, win_blk):
        """The table of ``(cols_rel, win_blk)``, or None where the kernel
        takes no table (tensors on the CPU, r that is not ``sortable``)."""
        if not on_card(cols_rel, win_blk) or not sortable(cols_rel.shape[2]):
            return None
        hit = self._by_device.get(cols_rel.device)
        if hit is None or hit[0] is not cols_rel or hit[1] is not win_blk:
            hit = (cols_rel, win_blk, order_table(
                cols_rel, win_blk, window=self.window,
                rows_per_block=self.rows_per_block, group_rows=SORT_ROWS))
            self._by_device[cols_rel.device] = hit
        return hit[2]


def ellpack_spmv_windowed(diag, vals, cols_rel, own_rel, win_blk, x, *,
                          window: int, rows_per_block: int,
                          order=None) -> torch.Tensor:
    """``y (P, rows)``: per rank q and row i, ``diag·x[b + own_rel] +
    Σ_j vals·x[b + cols_rel]`` with ``b = win_blk[q, i // rows_per_block] ·
    window``, summed in float32.

    diag ``(P, rows)`` or None (no diagonal term; own_rel then unused),
    vals/cols_rel ``(P, rows, r)``, own_rel ``(P, rows)``, win_blk
    ``(P, rows / rows_per_block)`` int32, x ``(P, Lx)`` whose rows may be
    a strided view.  On the card diag/vals (one dtype, that of y) and x
    are each float32 or bfloat16.  ``order``: the plan's ``order_table`` in
    SORT_ROWS groups (``PlanOrder``), which the card's column-sorted kernel
    reads; None runs the row-order kernel, and the CPU ignores it.  The
    caller guarantees every position lies in ``[0, Lx)`` (the host planners
    check it once)."""
    p, rows, r = vals.shape
    require(rows % rows_per_block == 0, (rows, rows_per_block))
    require(cols_rel.shape == vals.shape, (cols_rel.shape, vals.shape))
    require(win_blk.shape == (p, rows // rows_per_block), win_blk.shape)
    require(x.dim() == 2 and x.shape[0] == p, x.shape)
    if diag is not None:
        require(diag.shape == own_rel.shape == (p, rows),
                (diag.shape, own_rel.shape))
    for t in (cols_rel, win_blk) + (() if diag is None else (own_rel,)):
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")
    dense = (vals, cols_rel, win_blk) + (() if diag is None
                                         else (diag, own_rel))
    if not on_card(*dense) or x.device.type == "cpu":
        require(x.device == vals.device, (x.device, vals.device))
        return kref.ellpack_spmv_ref(diag, vals, cols_rel, own_rel, win_blk,
                                     x, window=window,
                                     rows_per_block=rows_per_block)
    if x.device != vals.device or x.stride(1) != 1:
        raise ValueError("x must lie on the kernel's device with unit "
                         "stride along its rows")
    if diag is not None and diag.dtype != vals.dtype:
        raise TypeError(f"diag ({diag.dtype}) and vals ({vals.dtype}) must "
                        "share a dtype on the card")
    for t in (vals, x):
        if t.dtype not in _DTYPES:
            raise TypeError(f"the card's SpMV takes float32 or bfloat16, "
                            f"got {t.dtype}")
    y = torch.empty((p, rows), dtype=vals.dtype, device=vals.device)
    head = (vals.device, None if diag is None else diag.data_ptr(),
            vals.data_ptr())
    tail = (None if diag is None else own_rel.data_ptr(), win_blk.data_ptr(),
            x.data_ptr(), y.data_ptr(), p, rows, r, rows_per_block, window,
            x.stride(0), _DTYPES[vals.dtype], _DTYPES[x.dtype])
    # the column-sorted kernel where the plan gave its table and vals takes
    # vector loads; the row-order kernel otherwise
    if order is not None:
        pos, slot = order
        require(sortable(r) and pos.shape == slot.shape == (p, rows * r)
                and pos.dtype == torch.int32 and slot.dtype == torch.int16,
                "order is not this plan's order_table")
        on_card(vals, pos, slot)
    if (order is not None
            and vals.data_ptr() % (4 * vals.element_size()) == 0):
        _build.launch("ellpack_spmv_windowed", "rt_ellpack_spmv_sorted",
                      *head, pos.data_ptr(), slot.data_ptr(), *tail)
    else:
        _build.launch("ellpack_spmv_windowed", "rt_ellpack_spmv", *head,
                      cols_rel.data_ptr(), *tail)
    return y
