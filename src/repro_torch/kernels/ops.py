"""Public kernel entry points and the SpMV window planners.

The planners are the reference's one-time host steps (``repro.kernels.ops``)
and build the same arrays bit for bit; the ``local_fn`` closures they return
run the card's SpMV kernel on rank-stacked ``(P, ...)`` tensors.  Unlike the
reference they never pad ``x``: the kernel reads the private copy in place,
and the planner checks once, on the host, that every position it will read
lies inside it.  There is no fallback: a CUDA tensor always goes through its
kernel or the call raises, and a CPU tensor takes the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _b8
from repro_torch.kernels.ellpack_spmv import (PlanOrder,
                                              ellpack_spmv_windowed)
from repro_torch.kernels.pack_gather import (DestOrder, ScatterTiles,
                                             SegmentTable, TileOrder,
                                             accumulate_into,
                                             accumulate_segments,
                                             derive_segment_table,
                                             derive_tile_order,
                                             pack_gather, segment_table,
                                             unpack_dest, unpack_dest_spmv,
                                             unpack_scatter_set)
from repro_torch.kernels import selective_scan as _b9
from repro_torch.kernels.stencil2d import stencil2d

__all__ = [
    "plan_spmv_windows", "ellpack_spmv", "make_spmv_on_copy_sharded",
    "make_spmv_overlap_sharded", "pack_gather", "unpack_dest",
    "unpack_dest_spmv", "DestOrder", "unpack_scatter_set", "ScatterTiles",
    "TileOrder", "derive_tile_order", "ellpack_spmv_windowed",
    "accumulate_segments", "accumulate_into", "SegmentTable",
    "segment_table", "derive_segment_table", "stencil2d",
    "decode_attention", "decode_attention_partial", "selective_scan",
    "launch_counts", "entry_counts",
    "reset_launch_counts",
]


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_build.LAUNCHES)


def entry_counts() -> dict[str, int]:
    """Launches so far by C entry point: which variant of each kernel ran
    (e.g. ``rt_unpack_dest_sorted``, through the plan's table, or
    ``rt_unpack_dest``, without one)."""
    return dict(_build.ENTRIES)


def reset_launch_counts() -> None:
    """Zero both counts."""
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    _build.ENTRIES.clear()


# --------------------------------------------------------------------------
# the model's kernels
# --------------------------------------------------------------------------

def selective_scan(x, dt, bmat, cmat, a, *, payload=torch.float32,
                   chunk=256):
    """The mamba-1 recurrence with its scan payload in ``payload``.
    float32 is B9: in grad mode with an input that requires grad, the scan
    with its backward (``kernels.selective_scan.selective_scan_train``:
    the checkpointing forward and the backward kernel on the card);
    otherwise the serving kernel ``selective_scan`` (``chunk`` is a
    blocking knob of the reference's scan there and changes nothing).
    bfloat16 is the reference's other function, its payload rounded inside
    chunks of ``min(chunk, L)`` steps: B9b, with B9b′ in grad mode
    (``selective_scan_bf16_train``), else ``selective_scan_bf16``."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, bmat, cmat, a))
    if payload == torch.bfloat16:
        if grad:
            return _b9.selective_scan_bf16_train(x, dt, bmat, cmat, a,
                                                 chunk=chunk)
        return _b9.selective_scan_bf16(x, dt, bmat, cmat, a, chunk=chunk)
    if payload != torch.float32:
        raise NotImplementedError(
            f"a {payload} scan payload: the port runs float32 and bfloat16")
    if grad:
        return _b9.selective_scan_train(x, dt, bmat, cmat, a)
    return _b9.selective_scan(x, dt, bmat, cmat, a)


def decode_attention(q, k, v, lengths):
    """``kernels.decode_attention.decode_attention`` (B8), refusing inputs
    that require grad.  B8 is a serving kernel: it launches through ctypes
    and leaves no autograd graph, and the reference never differentiates
    one-token decode, so an input that would lose its gradient without a
    word raises instead (on every device, so that a CPU run fails where a
    card run would)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "decode_attention has no backward: it is a serving kernel, and "
            "one-token decode is never differentiated (train through "
            "Model.loss, whose attention is plain PyTorch)")
    return _b8.decode_attention(q, k, v, lengths)


def decode_attention_partial(q, k, v, lengths):
    """``kernels.decode_attention.decode_attention_partial`` (B8's partial
    entry: the output over a range of slots and its log-sum-exp), refusing
    inputs that require grad as ``decode_attention`` does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "decode_attention_partial has no backward: it is a serving "
            "kernel")
    return _b8.decode_attention_partial(q, k, v, lengths)


# --------------------------------------------------------------------------
# EllPack SpMV
# --------------------------------------------------------------------------

def plan_spmv_windows(
    cols: np.ndarray, *, rows_per_block: int = 256, lane: int = 128
):
    """Host-side one-time window planning (the reference's VMEM window).

    Returns (window, win_blk, cols_rel, own_rel); ``window`` is the static
    tile width (multiple of ``lane``) covering every row block's column span.
    """
    n, _ = cols.shape
    assert n % rows_per_block == 0, "pad rows first"
    nblk = n // rows_per_block
    own = np.arange(n, dtype=np.int64)
    # own row index participates in the span (diagonal term gathers x[i])
    lo = np.minimum(
        cols.reshape(nblk, -1).min(axis=1),
        own.reshape(nblk, rows_per_block).min(axis=1),
    )
    hi = np.maximum(
        cols.reshape(nblk, -1).max(axis=1),
        own.reshape(nblk, rows_per_block).max(axis=1),
    )
    span = int((hi - lo + 1).max())
    window = max(lane, int(np.ceil(span / lane)) * lane)
    win_blk = (lo // window).astype(np.int32)           # (nblk,)
    base = (win_blk.astype(np.int64) * window)          # window start
    cols_rel = (
        cols - np.repeat(base, rows_per_block)[:, None]
    ).astype(np.int32)
    own_rel = (own - np.repeat(base, rows_per_block)).astype(np.int32)
    assert cols_rel.min() >= 0 and cols_rel.max() < 2 * window
    return window, win_blk, cols_rel, own_rel


def _x_long_enough(x: torch.Tensor, need: int, what: str) -> None:
    if x.shape[1] < need:
        raise ValueError(f"{what} has {x.shape[1]} entries per rank; the "
                         f"plan reads up to position {need - 1}")


def ellpack_spmv(diag, vals, cols, x, *, rows_per_block: int = 256,
                 plan=None):
    """y = diag*x + EllPack(vals, cols) @ x for one unsharded matrix.

    ``plan``: optional precomputed ``plan_spmv_windows`` output (amortize the
    one-time prep, exactly like the paper's preparation step).  The plan
    holds no order table, so the card runs the row-order kernel; the
    sharded planners below keep one (``PlanOrder``).
    """
    n = vals.shape[0]
    if plan is None:
        plan = plan_spmv_windows(np.asarray(cols),
                                 rows_per_block=rows_per_block)
    window, win_blk, cols_rel, own_rel = plan
    _x_long_enough(x[None], int(np.asarray(cols).max(initial=n - 1)) + 1,
                   "x")
    dev = vals.device
    return ellpack_spmv_windowed(
        diag[None], vals[None],
        torch.as_tensor(cols_rel, device=dev)[None],
        torch.as_tensor(own_rel, device=dev)[None],
        torch.as_tensor(win_blk, device=dev)[None], x[None],
        window=window, rows_per_block=rows_per_block)[0]


def make_spmv_on_copy_sharded(cols: np.ndarray, p: int, *,
                              rows_per_block: int = 256):
    """Per-shard window plans with one common static window: each rank
    computes its own rows against its private ``x_copy``.

    Returns (local_fn, plan_args) where ``plan_args`` are host arrays shaped
    (P, ...) — equal to the reference's — and ``local_fn(diag, vals, x_copy,
    win_blk, cols_rel, own_rel)`` takes them as rank-stacked tensors.
    """
    n, r_nz = cols.shape
    shard = n // p
    rows_per_block = min(rows_per_block, shard)
    # plan per shard, then unify the static window across shards
    plans = [
        plan_spmv_windows(cols[q * shard:(q + 1) * shard],
                          rows_per_block=rows_per_block)
        for q in range(p)
    ]
    window = max(pl[0] for pl in plans)
    nblk = shard // rows_per_block
    win_blk = np.zeros((p, nblk), np.int32)
    cols_rel = np.zeros((p, shard, r_nz), np.int32)
    own_rel = np.zeros((p, shard), np.int32)
    for q in range(p):
        sub = cols[q * shard:(q + 1) * shard]
        own = np.arange(q * shard, (q + 1) * shard, dtype=np.int64)
        lo = np.minimum(
            sub.reshape(nblk, -1).min(axis=1),
            own.reshape(nblk, rows_per_block).min(axis=1),
        )
        wb = (lo // window).astype(np.int32)
        base = np.repeat(wb.astype(np.int64) * window, rows_per_block)
        win_blk[q] = wb
        cols_rel[q] = (sub - base[:, None]).astype(np.int32)
        own_rel[q] = (own - base).astype(np.int32)
        assert cols_rel[q].min() >= 0 and cols_rel[q].max() < 2 * window
    # positions read: every column and every own row, all < n
    need = max(int(cols.max()), n - 1) + 1
    order = PlanOrder(window=window, rows_per_block=rows_per_block)

    def local_fn(diag, vals, x_copy, win_blk_t, cols_rel_t, own_rel_t):
        _x_long_enough(x_copy, need, "x_copy")
        return ellpack_spmv_windowed(
            diag, vals, cols_rel_t, own_rel_t, win_blk_t, x_copy,
            window=window, rows_per_block=rows_per_block,
            order=order(cols_rel_t, win_blk_t))

    return local_fn, (win_blk, cols_rel, own_rel)


def make_spmv_overlap_sharded(plan, vals: np.ndarray, *,
                              rows_per_block: int = 256):
    """Split-kernel on-copy variant of the ``overlap`` rung.

    The overlap strategy splits the local SpMV into an own-shard partial
    (reads only ``x_local``, runs while the condensed all_to_all is in
    flight) and a foreign partial (reads the landed ``x_copy``).  This
    builds BOTH partials on the SpMV kernel from the plan's own/foreign
    column split:

      * own kernel: columns are the plan's shard-local ``loc_cols`` (padding
        -> the zero slot at ``shard_size``), x is ``x_local`` + 1 pad slot;
      * foreign kernel: columns are ``rem_cols`` with padding redirected to
        an in-window fallback whose value is zeroed out of ``vals``, and no
        diagonal term.

    Returns ``(own_fn, rem_fn, kargs)``: ``kargs`` are 7 host arrays shaped
    (P, ...), equal to the reference's; ``own_fn(diag, x_ext, *kargs[:3])``
    and ``rem_fn(x_copy, *kargs[3:])`` take them as rank-stacked tensors.
    ``rem_own_rel`` (kargs[5]) is kept for that equality only: the foreign
    partial has no diagonal term, so the card never reads it.
    """
    p, n, shard = plan.p, plan.n, plan.shard_size
    rows_per_block = min(rows_per_block, shard)
    assert shard % rows_per_block == 0
    nblk_rows = shard // rows_per_block
    lane = 128

    # ---- own half: local indices in [0, shard]; one static window covers
    # the whole extended shard, so win_blk is identically zero ----
    loc_vals = np.take_along_axis(vals, plan.loc_src, axis=1)
    window_own = max(lane, int(np.ceil((shard + 1) / lane)) * lane)
    loc_vals_s = loc_vals.reshape(p, shard, -1)
    loc_cols_s = plan.loc_cols.reshape(p, shard, -1)
    own_win = np.zeros((p, nblk_rows), np.int32)

    # ---- foreign half: global indices; padding (n + 1) must not join the
    # window span, so redirect padded slots to the block's lowest valid
    # column and zero their vals ----
    rem_vals = np.take_along_axis(vals, plan.rem_src, axis=1)
    valid = plan.rem_cols != (n + 1)
    rem_vals = np.where(valid, rem_vals, 0).astype(vals.dtype)
    r_rem = plan.rem_cols.shape[1]
    cols_v = np.where(valid, plan.rem_cols, np.iinfo(np.int32).max)
    cols_blk = cols_v.reshape(p, nblk_rows, rows_per_block * r_rem)
    lo = cols_blk.min(axis=2)
    lo = np.where(lo == np.iinfo(np.int32).max, 0, lo)      # all-pad block
    hi_blk = np.where(valid, plan.rem_cols, 0).reshape(
        p, nblk_rows, rows_per_block * r_rem)
    hi = np.maximum(hi_blk.max(axis=2), lo)
    span = int((hi - lo + 1).max())
    window_rem = max(lane, int(np.ceil(span / lane)) * lane)
    rem_win = (lo // window_rem).astype(np.int32)            # (P, nblk)
    base = np.repeat(rem_win.astype(np.int64) * window_rem,
                     rows_per_block, axis=1)                 # (P, shard)
    lo_rows = np.repeat(lo.astype(np.int64), rows_per_block, axis=1)
    rem_cols_rel = (
        np.where(valid.reshape(p, shard, r_rem),
                 plan.rem_cols.reshape(p, shard, r_rem),
                 lo_rows[:, :, None]) - base[:, :, None]
    ).astype(np.int32)
    rem_own_rel = (lo_rows - base).astype(np.int32)          # diag=0: any
    assert rem_cols_rel.min() >= 0 and rem_cols_rel.max() < 2 * window_rem
    need_rem = int(hi.max()) + 1
    own_rel_cache: dict = {}    # (device, rows) -> own_rel
    own_order = PlanOrder(window=window_own, rows_per_block=rows_per_block)
    rem_order = PlanOrder(window=window_rem, rows_per_block=rows_per_block)

    def own_fn(diag, x_ext, loc_vals_t, loc_cols_t, own_win_t):
        _x_long_enough(x_ext, shard + 1, "x_ext")
        key = (x_ext.device, x_ext.shape[0])
        own_rel = own_rel_cache.get(key)
        if own_rel is None:
            own_rel = torch.arange(shard, dtype=torch.int32,
                                   device=x_ext.device).repeat(key[1], 1)
            own_rel_cache[key] = own_rel
        return ellpack_spmv_windowed(
            diag, loc_vals_t, loc_cols_t, own_rel, own_win_t, x_ext,
            window=window_own, rows_per_block=rows_per_block,
            order=own_order(loc_cols_t, own_win_t))

    def rem_fn(x_copy, rem_vals_t, rem_cols_t, rem_own_t, rem_win_t):
        _x_long_enough(x_copy, need_rem, "x_copy")
        return ellpack_spmv_windowed(
            None, rem_vals_t, rem_cols_t, None, rem_win_t, x_copy,
            window=window_rem, rows_per_block=rows_per_block,
            order=rem_order(rem_cols_t, rem_win_t))

    kargs = (loc_vals_s, loc_cols_s, own_win,
             rem_vals.reshape(p, shard, r_rem), rem_cols_rel,
             rem_own_rel.reshape(p, shard), rem_win)
    return own_fn, rem_fn, kargs
