"""The exchange fast path: pack and unpack around the all_to_all.

Wrappers of the CUDA kernels in ``csrc/pack_gather.cu`` (which replace the
Pallas kernels of ``repro/kernels/pack_gather.py``):

* ``pack_gather`` — ``out[q, k] = x[q, idx[q, k]]``: each rank's condensed
  messages (or whole virtual blocks) from its owned shard into one
  contiguous send buffer;
* ``unpack_scatter_set`` — the full-materialization unpack: a fresh
  ``x_copy`` per rank, the landed rows scattered in, the owned rows copied
  in at the rank's offset (eq. 15 + eq. 14 in one call);
* ``unpack_dest`` — the ``Destination``-targeted unpack: each of the L slots
  reads the landed buffer, the owned shard, or exactly 0.0.

Every tensor carries the leading rank axis ``(P, ...)`` and one launch
serves all ranks.  A CUDA tensor always goes through the kernel (or the call
raises); a CPU tensor takes the plain version in ``kernels/ref.py``.  Each
wrapper allocates its output with ``torch.empty`` and counts its launches in
``_build.LAUNCHES``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref

__all__ = ["pack_gather", "unpack_scatter_set", "unpack_dest"]


def require(cond: bool, what=None) -> None:
    """Raise ValueError unless ``cond``: the kernels index raw pointers, so
    a shape they do not take must never reach them."""
    if not cond:
        raise ValueError(f"the kernel does not take these inputs: {what}")


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; raises on anything else (mixed devices, other backends)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("the CUDA kernels take contiguous tensors")
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _int32(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[2:]) * t.element_size()


def pack_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[q, k] = x[q, idx[q, k]]``: x ``(P, shard, ...)`` any dtype,
    idx ``(P, m)`` int32 -> ``(P, m, ...)``.  Bit-exact."""
    require(x.dim() >= 2 and idx.dim() == 2, (x.shape, idx.shape))
    require(idx.shape[0] == x.shape[0], (x.shape, idx.shape))
    _int32(idx)
    if not on_card(x, idx):
        return kref.pack_gather_ref(x, idx)
    p, shard = x.shape[:2]
    m = idx.shape[1]
    out = torch.empty((p, m) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    _build.launch("pack_gather", "rt_pack_gather", x.device,
                  x.data_ptr(), idx.data_ptr(), out.data_ptr(), p, shard, m,
                  _row_bytes(x))
    return out


def unpack_scatter_set(recv: torch.Tensor, idx: torch.Tensor,
                       x_own: torch.Tensor, offsets: torch.Tensor, *,
                       out_len: int, copy_own: bool = True) -> torch.Tensor:
    """Per rank q: ``x_copy = zeros(out_len, ...)``, ``x_copy[idx[q]] =
    recv[q]``, then (``copy_own``) ``x_copy[offsets[q] : offsets[q] + rows]
    = x_own[q]`` — the own rows land after (win over) the scatter.

    recv ``(P, R, ...)``, idx ``(P, R)`` int32, x_own ``(P, rows, ...)``,
    offsets ``(P,)`` int32 -> ``(P, out_len, ...)``.  Bit-exact outside
    duplicate targets (the dump rows), whose contents are unspecified."""
    require(recv.dim() == x_own.dim()
            and recv.shape[2:] == x_own.shape[2:], (recv.shape, x_own.shape))
    require(idx.shape == recv.shape[:2], (idx.shape, recv.shape))
    require(offsets.shape == (x_own.shape[0],), offsets.shape)
    require(recv.dtype == x_own.dtype, (recv.dtype, x_own.dtype))
    _int32(idx, offsets)
    if not on_card(recv, idx, x_own, offsets):
        return kref.unpack_scatter_set_ref(recv, idx, x_own, offsets,
                                           out_len=out_len,
                                           copy_own=copy_own)
    p, rows = x_own.shape[:2]
    out = torch.empty((p, out_len) + tuple(x_own.shape[2:]),
                      dtype=x_own.dtype, device=x_own.device)
    _build.launch("unpack_scatter_set", "rt_unpack_scatter_set",
                  x_own.device, recv.data_ptr(), idx.data_ptr(),
                  x_own.data_ptr(), offsets.data_ptr(), out.data_ptr(), p,
                  recv.shape[1], rows, out_len, _row_bytes(x_own),
                  int(copy_own))
    return out


_DEST_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def unpack_dest(recv_flat: torch.Tensor, x_local: torch.Tensor,
                src_idx: torch.Tensor, own_idx: torch.Tensor,
                own_mask: torch.Tensor, rem_mask: torch.Tensor
                ) -> torch.Tensor:
    """Slot l of rank q gets ``recv_flat[q, src[q, l]]·rem[q, l] +
    x_local[q, own[q, l]]·own[q, l]``.

    recv_flat ``(P, R, ...)``, x_local ``(P, shard, ...)``, src/own ``(P, L)``
    int32, masks ``(P, L)`` int8 -> ``(P, L, ...)``; float32 or bfloat16 on
    the card.  Bit-exact, -0.0 and inf included; a NaN stays a NaN (its
    payload bits are the platform's)."""
    require(recv_flat.shape[2:] == x_local.shape[2:],
            (recv_flat.shape, x_local.shape))
    require(recv_flat.dtype == x_local.dtype,
            (recv_flat.dtype, x_local.dtype))
    shape = src_idx.shape
    require(len(shape) == 2 and shape[0] == x_local.shape[0], shape)
    require(own_idx.shape == own_mask.shape == rem_mask.shape == shape,
            (own_idx.shape, own_mask.shape, rem_mask.shape))
    _int32(src_idx, own_idx)
    for m in (own_mask, rem_mask):
        if m.dtype != torch.int8:
            raise TypeError(f"masks must be int8, got {m.dtype}")
    if not on_card(recv_flat, x_local, src_idx, own_idx, own_mask,
                   rem_mask):
        return kref.unpack_dest_ref(recv_flat, x_local, src_idx, own_idx,
                                    own_mask, rem_mask)
    if x_local.dtype not in _DEST_DTYPES:
        raise TypeError(f"unpack_dest runs float32 or bfloat16 on the card, "
                        f"not {x_local.dtype}")
    p, slots = shape
    out = torch.empty((p, slots) + tuple(x_local.shape[2:]),
                      dtype=x_local.dtype, device=x_local.device)
    _build.launch("unpack_dest", "rt_unpack_dest", x_local.device,
                  recv_flat.data_ptr(), x_local.data_ptr(),
                  src_idx.data_ptr(), own_idx.data_ptr(),
                  own_mask.data_ptr(), rem_mask.data_ptr(), out.data_ptr(),
                  p, recv_flat.shape[1], x_local.shape[1], slots,
                  math.prod(x_local.shape[2:]), _DEST_DTYPES[x_local.dtype])
    return out
