"""Modified-EllPack SpMV on the rank-stacked private copies.

Wrapper of the CUDA kernel in ``csrc/ellpack_spmv.cu``, which replaces the
Pallas kernel ``ellpack_spmv_windowed`` of ``repro/kernels/ellpack_spmv.py``.
It keeps the reference's one-time window plan (``kernels.ops``) and its
arrays — ``win_blk`` per row block, ``cols_rel`` / ``own_rel`` relative to
the window start — but reads ``x`` in place at the absolute positions
``win_blk * window + rel``: on the card no padded copy of ``x`` is made.
A CUDA tensor always goes through the kernel (or the call raises); a CPU
tensor takes the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.pack_gather import on_card, require

__all__ = ["ellpack_spmv_windowed"]


def ellpack_spmv_windowed(diag, vals, cols_rel, own_rel, win_blk, x, *,
                          window: int, rows_per_block: int) -> torch.Tensor:
    """``y (P, rows)``: per rank q and row i, ``diag·x[b + own_rel] +
    Σ_j vals·x[b + cols_rel]`` with ``b = win_blk[q, i // rows_per_block] ·
    window``, summed in float32.

    diag ``(P, rows)`` or None (no diagonal term; own_rel then unused),
    vals/cols_rel ``(P, rows, r)``, own_rel ``(P, rows)``, win_blk
    ``(P, rows / rows_per_block)`` int32, x ``(P, Lx)`` float32 whose rows
    may be a strided view.  The caller guarantees every position lies in
    ``[0, Lx)`` (the host planners check it once)."""
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
    for t in (vals, x) + (() if diag is None else (diag,)):
        if t.dtype != torch.float32:
            raise TypeError(f"the card's SpMV runs float32, got {t.dtype}")
    y = torch.empty((p, rows), dtype=torch.float32, device=vals.device)
    _build.launch("ellpack_spmv_windowed", "rt_ellpack_spmv_f32",
                  vals.device, None if diag is None else diag.data_ptr(),
                  vals.data_ptr(), cols_rel.data_ptr(),
                  None if diag is None else own_rel.data_ptr(),
                  win_blk.data_ptr(), x.data_ptr(), y.data_ptr(), p, rows, r,
                  rows_per_block, window, x.stride(0))
    return y
