"""Plain PyTorch versions of the port's kernels.

Each ``*_ref`` computes what its CUDA kernel computes, on tensors with the
leading rank axis ``(P, ...)``: the CPU tests run them against the JAX
reference, the kernel wrappers run them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

__all__ = ["pack_gather_ref", "unpack_scatter_set_ref", "unpack_dest_ref",
           "ellpack_spmv_ref"]


def _ranks(t: torch.Tensor) -> torch.Tensor:
    return torch.arange(t.shape[0], device=t.device)[:, None]


def pack_gather_ref(x, idx):
    """Message packing (paper Listing 5 pack loop): ``out[q, k] =
    x[q, idx[q, k]]``; x ``(P, shard, ...)``, idx ``(P, m)`` int32."""
    return x[_ranks(x), idx]


def unpack_scatter_set_ref(recv, idx, x_own, offsets, *, out_len,
                           copy_own=True):
    """Full-materialization unpack: zeros ``(P, out_len, ...)``, scatter the
    landed rows ``recv[q, k]`` to ``idx[q, k]``, then copy the owned rows in
    at ``offsets[q]``.  Dump-row contents (duplicate targets) are
    unspecified."""
    p, rest = x_own.shape[0], tuple(x_own.shape[2:])
    out = torch.zeros((p, out_len) + rest, dtype=x_own.dtype,
                      device=x_own.device)
    ranks = _ranks(x_own)
    out[ranks, idx] = recv
    if copy_own:
        rows = offsets.to(torch.int64)[:, None] + torch.arange(
            x_own.shape[1], device=x_own.device)
        out[ranks, rows] = x_own
    return out


def unpack_dest_ref(recv_flat, x_local, src_idx, own_idx, own_mask,
                    rem_mask):
    """Destination-targeted unpack: each of the L slots of rank q reads
    ``recv_flat[q, src]·rem_mask + x_local[q, own]·own_mask`` (both products
    and the add, no select)."""
    nf = x_local.dim() - 2
    dtype = x_local.dtype
    ranks = _ranks(x_local)

    def bmask(m):
        return m.reshape(tuple(m.shape) + (1,) * nf).to(dtype)

    return (recv_flat[ranks, src_idx] * bmask(rem_mask)
            + x_local[ranks, own_idx] * bmask(own_mask))


def ellpack_spmv_ref(diag, vals, cols_rel, own_rel, win_blk, x, *, window,
                     rows_per_block):
    """``y[q, i] = diag[q, i]·x[q, b + own_rel[q, i]] + Σ_j vals[q, i, j]·
    x[q, b + cols_rel[q, i, j]]`` with ``b = win_blk[q, i // rows_per_block]
    · window``, summed in float32.  ``diag=None`` drops the diagonal term
    (``own_rel`` is then not read)."""
    p, rows, r = vals.shape
    base = (win_blk.to(torch.int64) * window).repeat_interleave(
        rows_per_block, dim=1)                               # (P, rows)
    cols = (base[:, :, None] + cols_rel).reshape(p, rows * r)
    gathered = x.gather(1, cols).reshape(p, rows, r)
    acc = (vals.float() * gathered.float()).sum(dim=-1)
    if diag is None:
        return acc.to(vals.dtype)
    own = x.gather(1, base + own_rel)
    return (diag.float() * own.float() + acc).to(diag.dtype)
