"""The 5-point Jacobi stencil of the heat equation (paper §8, Listing 8).

Wrapper of the CUDA kernel in ``csrc/stencil2d.cu``, which replaces the
Pallas kernel ``stencil2d`` of ``repro/kernels/stencil2d.py``.  The
reference's wrapper (``repro.kernels.ops.stencil2d``) pads the rows to a
band multiple and rewrites the last row; the port keeps the semantics, not
that blocking: any ``(M, N)`` slice, boundary rows and columns copied.  A
CUDA tensor always goes through the kernel (or the call raises); a CPU
tensor takes the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.pack_gather import require

__all__ = ["stencil2d"]


def stencil2d(x: torch.Tensor, *, coef: float) -> torch.Tensor:
    """One Jacobi step on every ``(M, N)`` slice of ``x (..., M, N)``
    float32, one launch for the whole batch; rounding as
    ``kref.stencil2d_ref`` (bit for bit).

    ``x`` may be a strided view whose columns have unit stride (Heat2D's
    ring strips ``padded[:, 0:3, :]`` and ``padded[:, :, 0:3]``): the
    kernel reads it in place.  Other layouts are copied to a contiguous
    tensor first.  The result is a new contiguous tensor."""
    require(x.dim() >= 2, x.shape)
    if x.device.type == "cpu":
        return kref.stencil2d_ref(x, coef)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the card's stencil runs float32, got {x.dtype}")
    m, n = x.shape[-2:]
    x3 = x.reshape((-1, m, n))          # a view for the shapes Heat2D gives
    if x3.stride(2) != 1:
        x3 = x3.contiguous()
    out = torch.empty(x3.shape, dtype=x.dtype, device=x.device)
    _build.launch("stencil2d", "rt_stencil2d_f32", x.device, x3.data_ptr(),
                  out.data_ptr(), x3.shape[0], m, n, x3.stride(0),
                  x3.stride(1), ctypes.c_float(coef))
    return out.reshape(x.shape)
