"""The mamba-1 selective scan (the recurrence inside ``models.ssm``) and
its gradient.

Wrapper of the CUDA kernels in ``csrc/selective_scan.cu`` (the forward)
and ``csrc/selective_scan_bwd.cu`` (the backward): the forward
replaces the Pallas kernel ``selective_scan`` of
``repro/kernels/selective_scan.py``, the backward replaces what the
reference gets from ``jax.grad`` of its chunked associative scan
(``repro/models/ssm.py:67``).  The TPU kernel's ``tile_di`` and ``chunk_l``
(its VMEM blocking, which also required ``di % tile_di == 0`` and ``L %
chunk_l == 0``) are not part of the function and are gone: any ``di, L >=
1`` works.  A CUDA tensor always goes through the kernels (or the call
raises); a CPU tensor takes the plain versions in ``kernels/ref.py``.

``selective_scan`` is the serving entry.  ``selective_scan_train`` is the
same function as a ``torch.autograd.Function``: its forward also writes
``h`` as it enters every ``CKPT_STEPS``-th step (``selective_scan_ckpt``),
and its backward (``selective_scan_bwd``) restarts from those checkpoints.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.pack_gather import on_card, require

__all__ = ["selective_scan", "selective_scan_ckpt", "selective_scan_bwd",
           "selective_scan_train", "CKPT_STEPS", "lanes_per_channel",
           "bwd_partials"]

# csrc/selective_scan_common.cuh's kCkptSteps and kSpt, and the backward's
# block (csrc/selective_scan_bwd.cu's kThreads)
CKPT_STEPS = 128
_SPT = 4
_BWD_THREADS = 256


def lanes_per_channel(st: int) -> int:
    """Threads a channel (the kernels' kTpc): the power of two that covers
    ``st`` states at 4 a thread."""
    return 1 << max(0, math.ceil(math.log2(-(-st // _SPT))))


def bwd_partials(di: int, st: int) -> int:
    """dB/dC partials a lane of the backward kernel leaves: one a block of
    ``256 / lanes_per_channel(st)`` channels."""
    return -(-di // (_BWD_THREADS // lanes_per_channel(st)))


def _shapes(x, dt, bmat, cmat, a):
    require(x.dim() == 3 and dt.shape == x.shape, (x.shape, dt.shape))
    bsz, l, di = x.shape
    require(l >= 1 and di >= 1, x.shape)
    require(bmat.dim() == 3 and bmat.shape == cmat.shape
            and bmat.shape[:2] == (bsz, l), (bmat.shape, cmat.shape))
    st = bmat.shape[2]
    require(tuple(a.shape) == (di, st), a.shape)
    return bsz, l, di, st


def _card_inputs(st, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the card's selective scan runs float32, got "
                            f"{t.dtype}")
    require(1 <= st <= 32, st)


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
    bsz, l, di, st = _shapes(x, dt, bmat, cmat, a)
    if not on_card(x, dt, bmat, cmat, a):
        return kref.selective_scan_ref(x, dt, bmat, cmat, a)
    _card_inputs(st, x, dt, bmat, cmat, a)
    y = torch.empty_like(x)
    _build.launch("selective_scan", "rt_selective_scan_f32", x.device,
                  x.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
                  cmat.data_ptr(), a.data_ptr(), y.data_ptr(), bsz, l, di,
                  st)
    return y


def selective_scan_ckpt(x, dt, bmat, cmat, a):
    """``(y, hck)``: ``selective_scan``'s ``y`` and, on the card, ``h`` as
    it enters steps 0, 128, 256, … — ``hck (B, ceil(L / 128), di, st)``
    float32, what ``selective_scan_bwd`` restarts from (one launch of the
    forward kernel, counted as ``selective_scan``).  On the CPU ``hck`` is
    None: the plain backward keeps every state itself."""
    bsz, l, di, st = _shapes(x, dt, bmat, cmat, a)
    if not on_card(x, dt, bmat, cmat, a):
        return kref.selective_scan_ref(x, dt, bmat, cmat, a), None
    _card_inputs(st, x, dt, bmat, cmat, a)
    y = torch.empty_like(x)
    hck = torch.empty((bsz, -(-l // CKPT_STEPS), di, st),
                      dtype=torch.float32, device=x.device)
    _build.launch("selective_scan", "rt_selective_scan_ckpt_f32", x.device,
                  x.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
                  cmat.data_ptr(), a.data_ptr(), y.data_ptr(),
                  hck.data_ptr(), bsz, l, di, st)
    return y, hck


def selective_scan_bwd(x, dt, bmat, cmat, a, hck, dy):
    """``(dx, ddt, dB, dC, dA)``: the gradients of ``selective_scan`` for
    the cotangent ``dy (B, L, di)``, ``hck`` as ``selective_scan_ckpt``
    gave it.  On the card one launch of the backward kernel (and its
    fixed-order reduction of the partials): no atomics, so two calls give
    the same bits; against the plain backward within 2e-4 of each
    gradient's largest element.  On the CPU ``selective_scan_bwd_ref``."""
    bsz, l, di, st = _shapes(x, dt, bmat, cmat, a)
    require(dy.shape == x.shape, (dy.shape, x.shape))
    if not on_card(x, dt, bmat, cmat, a, dy):
        return kref.selective_scan_bwd_ref(x, dt, bmat, cmat, a, dy)
    _card_inputs(st, x, dt, bmat, cmat, a, dy)
    require(hck is not None and hck.dtype == torch.float32
            and tuple(hck.shape) == (bsz, -(-l // CKPT_STEPS), di, st)
            and hck.device == x.device and hck.is_contiguous(),
            None if hck is None else hck.shape)
    nblk = bwd_partials(di, st)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    da = torch.empty_like(a)
    pb = torch.empty((2, bsz, nblk, l, st), dtype=torch.float32,
                     device=x.device)
    pa = torch.empty((bsz, di, st), dtype=torch.float32, device=x.device)
    _build.launch("selective_scan_bwd", "rt_selective_scan_bwd_f32",
                  x.device, x.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
                  cmat.data_ptr(), a.data_ptr(), hck.data_ptr(),
                  dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                  db.data_ptr(), dc.data_ptr(), da.data_ptr(),
                  pb[0].data_ptr(), pb[1].data_ptr(), pa.data_ptr(), bsz, l,
                  di, st)
    return dx, ddt, db, dc, da


class _SelectiveScan(torch.autograd.Function):
    """The scan with its backward: the checkpointing forward and the
    backward kernel on the card, the plain versions on the CPU.  Under
    ``torch.utils.checkpoint`` the forward runs twice and gives the same
    bits both times."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a):
        y, hck = selective_scan_ckpt(x, dt, bmat, cmat, a)
        ctx.save_for_backward(x, dt, bmat, cmat, a, hck)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, bmat, cmat, a, hck = ctx.saved_tensors
        return selective_scan_bwd(x, dt, bmat, cmat, a, hck,
                                  dy.contiguous())


def selective_scan_train(x, dt, bmat, cmat, a):
    """``selective_scan`` with a gradient for all five inputs (``a``'s
    reaches ``a_log`` through the caller's ``-exp``)."""
    return _SelectiveScan.apply(x, dt, bmat, cmat, a)
