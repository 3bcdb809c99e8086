"""Int8 error-feedback gradient compression for data-parallel reductions:
the counterpart of ``repro.optim.compress``.

Each data-parallel rank quantizes its local gradient to int8 with a scale
shared by all ranks, all-reduces the int8 payload (summed as int32; one
byte an element on the wire where a link reduces int8), dequantizes, and
keeps the quantization residual locally, adding it back before the next
step's quantization (error feedback makes the scheme unbiased over time).

As in the reference, nothing in the trainer calls it: ``launch.train``
averages float32 gradients (``runtime.steps.mean_over_ranks``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import fma_f32

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum"]


def quantize_int8(x: torch.Tensor):
    """``(q, scale)``: ``x`` in int8 steps of ``max|x| / 127`` (a 0-d
    float32 scale)."""
    xf = x.to(torch.float32)
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, comm):
    """Error-feedback int8 all-reduce of one tensor over ``comm``'s ranks.

    ``g`` and ``residual`` are rank-stacked, ``(p_local, ...)``: row i is
    this process's rank i's gradient and residual.  Returns
    ``(reduced_f32_mean, new_residual)``, both ``(p_local, ...)`` — the
    reference's ``compressed_psum`` on each rank, bit for bit (the
    residual ``gf - q * scale`` rounded once, as XLA fuses it into a
    multiply-add)."""
    gf = g.to(torch.float32) + residual
    lead = (gf.shape[0],) + (1,) * (gf.dim() - 1)
    # shared scale (one scalar a rank on the wire) so the int8 payloads are
    # summable: sum_i q_i * s == s * sum_i q_i exactly
    local_scale = gf.reshape(gf.shape[0], -1).abs().amax(1) / 127.0 + 1e-12
    scale = comm.all_reduce(local_scale, "max").wait().reshape(lead)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_residual = fma_f32(-q.to(torch.float32), scale.expand_as(gf), gf)
    # int8 summed in int32 to avoid overflow
    summed = comm.all_reduce(q.to(torch.int32), "sum").wait()
    return summed.to(torch.float32) * scale / comm.p, new_residual
