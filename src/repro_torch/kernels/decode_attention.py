"""Single-token (decode) GQA attention over the valid prefix of a KV cache.

Wrapper of the CUDA kernel in ``csrc/decode_attention.cu``, which replaces
the Pallas kernel ``decode_attention`` of
``repro/kernels/decode_attention.py``.  The TPU kernel's ``kv_chunk`` (its
VMEM blocking, which also required ``S % kv_chunk == 0``) is not part of
the function and is gone: any cache length works.  The card's kernel
splits the KV axis into ``plan_chunk``'s splits, chosen from the static
shapes alone (the lengths stay on the device: no host sync), and merges the
splits of a (lane, KV head) in the same launch.  A CUDA tensor always goes
through the kernel (or the call raises); a CPU tensor takes the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.pack_gather import on_card, require

__all__ = ["decode_attention", "plan_chunk"]

TILE = 32            # slots of one shared-memory tile on the card
# The split planner's aims: at least TARGET_BLOCKS blocks (four resident on
# each of the card's 132 SMs), and no split longer than MAX_TILES tiles, so
# that long caches make many splits and lanes of different lengths even out.
TARGET_BLOCKS = 4 * 132
MAX_TILES = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (device, stream) -> int32 counters that every launch leaves at zero
_COUNTERS: dict = {}


def plan_chunk(b: int, s: int, hkv: int) -> int:
    """Slots of one split of the KV axis, from the static shapes alone: a
    multiple of ``TILE`` such that ``b * hkv * ceil(s / chunk)`` blocks
    reach ``TARGET_BLOCKS`` where the cache allows, and no split is longer
    than ``MAX_TILES`` tiles.  Split j holds the slots
    ``[j * chunk, min((j + 1) * chunk, n))`` of a lane that attends n
    slots, so the splits below ``ceil(n / chunk)`` cover each slot once."""
    tiles = -(-s // TILE)
    splits = max(-(-TARGET_BLOCKS // max(b * hkv, 1)),
                 -(-tiles // MAX_TILES))
    return TILE * -(-tiles // min(splits, tiles))


def _counters(device, n: int) -> torch.Tensor:
    """Zeroed int32 counters for the launches on ``device``'s current
    stream, kept between calls: each launch leaves them at zero."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """``out (B, H, D)`` in ``q.dtype``: query head h of lane b attends
    slots ``s < lengths[b]`` of KV head ``h // (H / Hkv)``, float32 dot
    products scaled by ``D ** -0.5`` and a float32 softmax.

    q ``(B, H, D)``, k/v ``(B, S, Hkv, D)`` (on the card q and the cache
    float32 or bfloat16 — a float32 query may read a bfloat16 cache, not
    the other way — and D <= 128, the configs' widths), lengths ``(B,)``
    int32, on one device.  Lengths past S count as S.  A length of 0 or less (the model
    never passes one: its lanes always hold their current token) gives
    what the TPU kernel gives, every slot masked alike: the mean of V over
    all S slots.  The card's kernel sums in another order than the plain
    version (rtol/atol 2e-4 in float32); a bfloat16 query on a bfloat16
    cache runs its products on the tensor cores, each probability kept to
    16 bits, within one bfloat16 rounding of the plain version."""
    require(q.dim() == 3 and k.dim() == 4 and k.shape == v.shape,
            (q.shape, k.shape, v.shape))
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    require(k.shape[0] == b and k.shape[3] == d and s >= 1 and hkv >= 1
            and h % hkv == 0, (q.shape, k.shape))
    require(tuple(lengths.shape) == (b,), lengths.shape)
    if not on_card(q, k, v, lengths):
        return kref.decode_attention_ref(q, k, v, lengths)
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if (q.dtype not in _DTYPES or k.dtype not in _DTYPES
            or v.dtype != k.dtype
            or (q.dtype, k.dtype) == (torch.bfloat16, torch.float32)):
        raise TypeError("the card's decode attention takes a float32 or "
                        "bfloat16 query and cache (a float32 query may read "
                        f"a bfloat16 cache), got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    require(d <= 128 and b * hkv <= 65535, (d, b, hkv))
    out = torch.empty_like(q)
    chunk = plan_chunk(b, s, hkv)
    nsplit = -(-s // chunk)
    part_ml = torch.empty((2, b * hkv, nsplit, h // hkv),
                          dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b * hkv, nsplit, h // hkv, d),
                           dtype=torch.float32, device=q.device)
    _build.launch("decode_attention", "rt_decode_attention", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), part_ml[0].data_ptr(),
                  part_ml[1].data_ptr(), part_acc.data_ptr(),
                  _counters(q.device, b * h).data_ptr(), b, s, h, hkv, d,
                  chunk, _DTYPES[q.dtype], _DTYPES[k.dtype],
                  ctypes.c_float(d ** -0.5))
    return out
