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

``selective_scan_bf16`` (B9b) and ``selective_scan_bf16_bwd`` (B9b′), in
``csrc/selective_scan_bf16.cu``, are the reference's other function: its
``ssm_fwd(..., scan_dtype=bfloat16)``, whose chunked associative scan
rounds its payload to bfloat16 (``repro/models/ssm.py:97-105``; no Pallas
kernel).  ``selective_scan_bf16_ckpt`` also writes the float32 state
entering every chunk, which the backward restarts from;
``selective_scan_bf16_train`` is the pair as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.pack_gather import on_card, require

__all__ = ["selective_scan", "selective_scan_ckpt", "selective_scan_bwd",
           "selective_scan_train", "CKPT_STEPS", "lanes_per_channel",
           "bwd_partials", "selective_scan_bf16", "selective_scan_bf16_ckpt",
           "selective_scan_bf16_bwd", "selective_scan_bf16_train",
           "BF16_MAX_CHUNK", "bf16_bwd_partials", "bf16_ends_shape"]

# csrc/selective_scan_common.cuh's kCkptSteps and kSpt, and the backward's
# block (csrc/selective_scan_bwd.cu's kThreads)
CKPT_STEPS = 128
_SPT = 4
_BWD_THREADS = 256
# csrc/selective_scan_bf16.cu's kMaxChunk and kThreads
BF16_MAX_CHUNK = 256
_BF16_THREADS = 128
# csrc/selective_scan_bf16.cu's kBwdLow: B9b′ keeps the ends of every
# block of 2^3 steps
_BF16_BWD_BLOCK = 8


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


# --------------------------------------------------------------------------
# the bfloat16 payload (B9b, B9b′)
# --------------------------------------------------------------------------

def _bf16_tpc(st: int) -> int:
    """Threads a channel in B9b and B9b′ (their kTpc): each thread holds
    two states, so half the power of two >= st, at least 1."""
    return max(1, (1 << max(0, math.ceil(math.log2(st)))) // 2)


def bf16_bwd_partials(di: int, st: int) -> int:
    """dB/dC partials a lane of B9b′ leaves: one a block of ``128 / tpc``
    channels (``_bf16_tpc``)."""
    return -(-di // (_BF16_THREADS // _bf16_tpc(st)))


def bf16_ends_shape(bsz: int, l: int, di: int, st: int,
                    c: int) -> tuple:
    """B9b′'s workspace of block ends, 32-bit words: for every block of 8
    steps of every (chunk, lane pair), its last up-value (a, b) and its
    state, a packed bf16 pair each."""
    return (bsz, l // c, -(-c // _BF16_BWD_BLOCK), 3, di * _bf16_tpc(st))


def _card_chunk(l: int, chunk: int) -> int:
    c = kref.scan_chunk_len(l, chunk)
    if c > BF16_MAX_CHUNK:
        raise ValueError(f"the card's bf16 scan takes chunks of at most "
                         f"{BF16_MAX_CHUNK} steps, got {c}")
    return c


def _bf16_forward(x, dt, bmat, cmat, a, chunk, ckpt):
    """One launch of B9b: ``(y, hck)`` (hck None without ``ckpt``)."""
    bsz, l, di, st = _shapes(x, dt, bmat, cmat, a)
    c = _card_chunk(l, chunk)
    _card_inputs(st, x, dt, bmat, cmat, a)
    y = torch.empty_like(x)
    hck = None
    if ckpt:
        hck = torch.empty((bsz, l // c, di, st), dtype=torch.float32,
                          device=x.device)
    _build.launch("selective_scan_bf16", "rt_selective_scan_bf16", x.device,
                  x.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
                  cmat.data_ptr(), a.data_ptr(), y.data_ptr(),
                  0 if hck is None else hck.data_ptr(), bsz, l, di, st, c,
                  int(ckpt))
    return y, hck


def selective_scan_bf16(x, dt, bmat, cmat, a, *, chunk: int = 256):
    """``y (B, L, di)`` float32 of the reference's scan with a bfloat16
    payload (``kref.selective_scan_bf16_ref``: chunks of ``min(chunk,
    L)`` steps, which must divide L).  On the card every input is float32
    and contiguous, st <= 32 and the chunk <= 256; the states and ``y``
    are the plain version's bit for bit (``y`` sums the states in
    ``kref.state_sum``'s order).  A call is one launch of the walk
    kernel, counted as ``selective_scan_bf16``."""
    if not on_card(x, dt, bmat, cmat, a):
        _shapes(x, dt, bmat, cmat, a)
        return kref.selective_scan_bf16_ref(x, dt, bmat, cmat, a,
                                            chunk=chunk)
    return _bf16_forward(x, dt, bmat, cmat, a, chunk, False)[0]


def selective_scan_bf16_ckpt(x, dt, bmat, cmat, a, *, chunk: int = 256):
    """``(y, hck)``: ``selective_scan_bf16``'s ``y`` and the float32 state
    entering every chunk, ``hck (B, L / c, di, st)`` — the reference's
    boundary states, what ``selective_scan_bf16_bwd`` restarts from (one
    launch of B9b, counted as ``selective_scan_bf16``; on the CPU the
    plain version's)."""
    if not on_card(x, dt, bmat, cmat, a):
        _shapes(x, dt, bmat, cmat, a)
        return kref.selective_scan_bf16_states_ref(x, dt, bmat, cmat, a,
                                                   chunk=chunk)
    return _bf16_forward(x, dt, bmat, cmat, a, chunk, True)


def selective_scan_bf16_bwd(x, dt, bmat, cmat, a, hck, dy, *,
                            chunk: int = 256):
    """``(dx, ddt, dB, dC, dA)``: the gradients of ``selective_scan_bf16``
    for the cotangent ``dy``, ``hck`` as ``selective_scan_bf16_ckpt`` gave
    it.  On the card one launch of B9b′ (counted once: its ends kernel,
    its reverse walk and the fixed-order reduction of the partials; no
    atomics, so two calls give the same bits); the bf16 cotangents are the
    plain backward's, the float32 sums run in other orders (2e-4 of each
    gradient's largest element).  On the CPU
    ``kref.selective_scan_bf16_bwd_ref``."""
    bsz, l, di, st = _shapes(x, dt, bmat, cmat, a)
    require(dy.shape == x.shape, (dy.shape, x.shape))
    if not on_card(x, dt, bmat, cmat, a, dy):
        return kref.selective_scan_bf16_bwd_ref(x, dt, bmat, cmat, a, dy,
                                                chunk=chunk)
    c = _card_chunk(l, chunk)
    _card_inputs(st, x, dt, bmat, cmat, a, dy)
    require(hck is not None and hck.dtype == torch.float32
            and tuple(hck.shape) == (bsz, l // c, di, st)
            and hck.device == x.device and hck.is_contiguous(),
            None if hck is None else hck.shape)
    nblk = bf16_bwd_partials(di, st)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    da = torch.empty_like(a)
    pb = torch.empty((2, bsz, nblk, l, st), dtype=torch.float32,
                     device=x.device)
    pa = torch.empty((bsz, di, st), dtype=torch.float32, device=x.device)
    ends = torch.empty(bf16_ends_shape(bsz, l, di, st, c),
                       dtype=torch.int32, device=x.device)
    _build.launch("selective_scan_bf16_bwd", "rt_selective_scan_bf16_bwd",
                  x.device, x.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
                  cmat.data_ptr(), a.data_ptr(), hck.data_ptr(),
                  dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                  db.data_ptr(), dc.data_ptr(), da.data_ptr(),
                  pb[0].data_ptr(), pb[1].data_ptr(), pa.data_ptr(),
                  ends.data_ptr(), bsz, l, di, st, c)
    return dx, ddt, db, dc, da


class _SelectiveScanBf16(torch.autograd.Function):
    """The bf16-payload scan with its backward: B9b's checkpointing entry
    and B9b′ on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, chunk):
        y, hck = selective_scan_bf16_ckpt(x, dt, bmat, cmat, a, chunk=chunk)
        ctx.save_for_backward(x, dt, bmat, cmat, a, hck)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, bmat, cmat, a, hck = ctx.saved_tensors
        return (*selective_scan_bf16_bwd(x, dt, bmat, cmat, a, hck,
                                         dy.contiguous(), chunk=ctx.chunk),
                None)


def selective_scan_bf16_train(x, dt, bmat, cmat, a, *, chunk: int = 256):
    """``selective_scan_bf16`` with a gradient for all five inputs."""
    return _SelectiveScanBf16.apply(x, dt, bmat, cmat, a, chunk)
