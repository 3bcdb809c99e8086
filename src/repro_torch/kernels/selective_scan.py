"""The mamba-1 selective scan (the recurrence inside ``models.ssm``).

Wrapper of the CUDA kernel in ``csrc/selective_scan.cu``, which replaces
the Pallas kernel ``selective_scan`` of ``repro/kernels/selective_scan.py``.
The TPU kernel's ``tile_di`` and ``chunk_l`` (its VMEM blocking, which also
required ``di % tile_di == 0`` and ``L % chunk_l == 0``) are not part of
the function and are gone: any ``di, L >= 1`` works.  A CUDA tensor always
goes through the kernel (or the call raises); a CPU tensor takes the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.pack_gather import on_card, require

__all__ = ["selective_scan"]


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``y (B, L, di)`` in ``x.dtype``: from h = 0, per step t
    ``h = exp(dt[t]·a) ⊙ h + (dt[t]·x[t]) ⊗ B[t]`` and ``y[t] = h · C[t]``
    (no gate, no skip), in float32.

    x/dt ``(B, L, di)`` (dt already through softplus), bmat/cmat
    ``(B, L, st)``, a ``(di, st)`` (the negative decay rates).  On the card
    every input is float32 and contiguous, st <= 32; the kernel sums ``y``
    over the states in another order than the plain version (rtol/atol
    2e-4)."""
    require(x.dim() == 3 and dt.shape == x.shape, (x.shape, dt.shape))
    bsz, l, di = x.shape
    require(l >= 1 and di >= 1, x.shape)
    require(bmat.dim() == 3 and bmat.shape == cmat.shape
            and bmat.shape[:2] == (bsz, l), (bmat.shape, cmat.shape))
    st = bmat.shape[2]
    require(tuple(a.shape) == (di, st), a.shape)
    if not on_card(x, dt, bmat, cmat, a):
        return kref.selective_scan_ref(x, dt, bmat, cmat, a)
    for t in (x, dt, bmat, cmat, a):
        if t.dtype != torch.float32:
            raise TypeError(f"the card's selective scan runs float32, got "
                            f"{t.dtype}")
    require(1 <= st <= 32, st)
    y = torch.empty_like(x)
    _build.launch("selective_scan", "rt_selective_scan_f32", x.device,
                  x.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
                  cmat.data_ptr(), a.data_ptr(), y.data_ptr(), bsz, l, di,
                  st)
    return y
