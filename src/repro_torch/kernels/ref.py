"""Plain PyTorch versions of the port's kernels.

Each ``*_ref`` computes what its CUDA kernel computes — the exchange and
stencil kernels on tensors with the leading rank axis ``(P, ...)``, the
two model kernels on the model's own layouts: the CPU tests run them
against the JAX reference, the kernel wrappers run them for CPU tensors,
and ``chip_smoke.py`` holds each kernel against its plain version on the
card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["pack_gather_ref", "unpack_scatter_set_ref", "unpack_dest_ref",
           "unpack_dest_spmv_ref",
           "ellpack_spmv_ref", "reduce_identity", "maximum",
           "accumulate_segments_ref", "accumulate_into_ref", "ordered_add",
           "fma_f32",
           "stencil2d_ref", "decode_attention_ref",
           "decode_attention_partial_ref", "selective_scan_ref",
           "selective_scan_bwd_ref", "scan_chunk_bf16", "scan_chunk_len",
           "state_sum", "selective_scan_bf16_states_ref",
           "selective_scan_bf16_ref", "selective_scan_bf16_bwd_ref"]


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


def unpack_dest_spmv_ref(recv_flat, x_local, src_idx, own_idx, own_mask,
                         rem_mask, vals, diag=None):
    """The dest rungs' slot product on ``unpack_dest_ref``'s slots: ``y[q,
    i] = diag[q, i]·x_local[q, i] + Σ_j vals[q, i, j]·slot[q, i·r + j]``;
    vals ``(P, rows, r)``, diag ``(P, rows)`` or None (no diagonal term)."""
    p, rows, r = vals.shape
    slots = unpack_dest_ref(recv_flat, x_local, src_idx, own_idx, own_mask,
                            rem_mask).reshape(p, rows, r)
    acc = (vals * slots).sum(-1)
    return acc if diag is None else diag * x_local + acc


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


# --------------------------------------------------------------------------
# Segment accumulate (push direction).  ``max`` follows XLA's semantics: a
# NaN propagates, and +0.0 is larger than -0.0 (``torch.maximum`` and
# ``scatter_reduce(..., "amax")`` keep whichever zero they meet first).
# --------------------------------------------------------------------------

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float64: torch.int64}


def reduce_identity(dtype: torch.dtype, reduce: str):
    """The value padded lanes carry and accumulators start from: 0 for
    ``add``/``set``, -inf (or the integer minimum) for ``max``."""
    if reduce == "max":
        if dtype.is_floating_point:
            return float("-inf")
        return torch.iinfo(dtype).min
    return 0


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """Float bits as integers ordered like the floats, -0.0 below +0.0."""
    return _flip(t.view(_BITS[t.dtype]))


def _flip(bits: torch.Tensor) -> torch.Tensor:
    """Flip the magnitude bits of the negative ones (an involution)."""
    return torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max with XLA's semantics (``jnp.maximum``)."""
    if not a.dtype.is_floating_point:
        return torch.maximum(a, b)
    out = _flip(torch.maximum(_ordered(a), _ordered(b))).view(a.dtype)
    return torch.where(a.isnan() | b.isnan(), float("nan"), out)


def _combine(acc: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             reduce: str) -> torch.Tensor:
    """Fold ``vals (P, K, ...)`` into ``acc (P, L, ...)`` at ``idx (P, K)``,
    in place.  Every element is indexed on its own (a flat 1-D combine): on
    the CPU a 1-D ``index_add_`` adds the contributions of an element in
    ascending k order, one rounding each, as the reference's ``.at[].add``
    does — a 2-D bfloat16 ``index_add_`` does not.  On the card
    ``index_add_`` adds with atomics, in another order every run, so the
    add goes through ``_card_add``.  ``max`` does not depend on the
    order."""
    p, out_len = acc.shape[:2]
    feat = math.prod(acc.shape[2:])
    flat = acc.view(-1)
    rows = idx.to(torch.int64) + _ranks(idx) * out_len
    index = (rows.reshape(-1, 1) * feat
             + torch.arange(feat, device=acc.device)).reshape(-1)
    src = vals.reshape(-1)
    if reduce != "max":
        if flat.device.type == "cuda":
            _card_add(flat, index, src)
        else:
            flat.index_add_(0, index, src)
        return acc
    if not acc.dtype.is_floating_point:
        flat.scatter_reduce_(0, index, src, "amax", include_self=True)
        return acc
    key = _ordered(flat).scatter_reduce(0, index, _ordered(src), "amax",
                                        include_self=True)
    nan = torch.zeros(flat.shape, dtype=torch.int32, device=acc.device)
    nan.scatter_add_(0, index, src.isnan().to(torch.int32))
    flat.copy_(torch.where((nan > 0) | flat.isnan(), float("nan"),
                           _flip(key).view(acc.dtype)))
    return acc


def _card_add(flat: torch.Tensor, index: torch.Tensor,
              src: torch.Tensor) -> None:
    """``flat[index] += src`` on the card, with the same sums every run.
    float32 (and wider) and integers: ``index_put_(accumulate=True)``, which
    sorts by target and adds in the dtype, in an order of its own — float
    sums can differ from the CPU's (and the kernels') in the last bits.
    bfloat16 and float16: ``index_put_`` would add in float32 and round
    once, another function than one rounding per add, so they take
    ``ordered_add``, the CPU's sums bit for bit."""
    if flat.dtype in (torch.bfloat16, torch.float16):
        ordered_add(flat, index, src)
    else:
        flat.index_put_((index,), src, accumulate=True)


def ordered_add(flat: torch.Tensor, index: torch.Tensor,
                src: torch.Tensor) -> None:
    """``flat[index[i]] += src[i]`` for i in ascending order, one rounding
    in ``flat``'s dtype per add: what a 1-D ``index_add_`` computes on the
    CPU and the reference's ``.at[].add`` specifies, on any device.  The
    contributions are sorted by target (stably, so each target keeps them
    in ascending i) and added in rounds, round r adding every target's
    r-th contribution: as many rounds as the most contributions any one
    target gets, each round a few launches."""
    if index.numel() == 0:
        return
    tgt, order = torch.sort(index, stable=True)
    vals = src[order]
    pos = torch.arange(tgt.numel(), device=tgt.device)
    first = torch.ones_like(tgt, dtype=torch.bool)
    first[1:] = tgt[1:] != tgt[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    for part in torch.split(by_rank, torch.bincount(rank).tolist()):
        t = tgt[part]
        flat[t] = flat[t] + vals[part]


def accumulate_segments_ref(vals, idx, *, out_len: int, reduce: str = "add"):
    """Per rank q: ``acc = full((out_len, ...), identity)``, then combine
    ``vals[q, k]`` into ``acc[idx[q, k]]`` — add (``set`` is add after the
    caller's winner mask) or max.  vals ``(P, K, ...)``, idx ``(P, K)``
    int32 -> ``(P, out_len, ...)``."""
    acc = torch.full((vals.shape[0], out_len) + tuple(vals.shape[2:]),
                     reduce_identity(vals.dtype, reduce), dtype=vals.dtype,
                     device=vals.device)
    return _combine(acc, idx, vals, reduce)


def accumulate_into_ref(init, vals, idx, *, reduce: str = "add"):
    """The same combine, continuing from ``init (P, L, ...)`` (which is not
    modified)."""
    return _combine(init.clone(), idx, vals, reduce)


# --------------------------------------------------------------------------
# 5-point stencil
# --------------------------------------------------------------------------

def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` on float32 tensors, rounded once (IEEE fma), as the
    card's ``__fmaf_rn`` and XLA's fused multiply-add compute it.

    The product is exact in float64 and the float64 sum rounds once; the
    second rounding, to float32, can differ from a single rounding only
    where the float64 sum lies exactly halfway between two float32 values
    and is not the exact sum.  The exact error of the float64 add (TwoSum)
    says on which side the exact sum lies, and that case is rounded toward
    it."""
    prod = a.double() * b.double()
    c64 = c.double()
    s = prod + c64
    back = s - prod
    err = (prod - (s - back)) + (c64 - back)
    f = s.float()
    below = s - f.double()                       # exact
    away = torch.where(below > 0, float("inf"), float("-inf")).to(f.dtype)
    g = torch.nextafter(f, away)                 # the other candidate
    tie = (below != 0) & ((f.double() + g.double()) * 0.5 == s)
    return torch.where(tie & (err != 0) & ((err > 0) == (below > 0)), g, f)


def stencil2d_ref(x: torch.Tensor, coef: float) -> torch.Tensor:
    """One 5-point Jacobi step on every ``(M, N)`` slice of ``x (..., M,
    N)`` float32 (paper Listing 8): the interior gets ``mid + coef·lap``
    with ``lap = ((up + down) + left) + right - 4·mid`` and the last step
    one fused multiply-add (``fma_f32``), ``coef`` rounded to float32 first;
    boundary rows and columns are copied.  This is the rounding of the
    reference's jitted ``stencil2d_ref`` and of its Pallas kernel (its eager
    ``stencil2d_ref`` rounds the product and the sum on their own)."""
    mid = x[..., 1:-1, 1:-1]
    lap = (x[..., :-2, 1:-1] + x[..., 2:, 1:-1] + x[..., 1:-1, :-2]
           + x[..., 1:-1, 2:] - 4.0 * mid)
    coef32 = torch.tensor(coef, dtype=torch.float32, device=x.device)
    out = x.clone()
    out[..., 1:-1, 1:-1] = fma_f32(coef32, lap, mid)
    return out


# --------------------------------------------------------------------------
# Model kernels: single-token attention over a KV cache, mamba-1 recurrence
# --------------------------------------------------------------------------

def decode_attention_ref(q, k, v, lengths, *, scale=None):
    """Single-token GQA attention over the valid prefix of a KV cache: q
    ``(B, H, D)``, k/v ``(B, S, Hkv, D)`` (the model's cache layout, H a
    multiple of Hkv), lengths ``(B,)`` int.  Slot s of lane b is valid when
    ``s < lengths[b]``; the logits are float32, invalid ones -1e30 before
    the softmax over all S slots, as the reference's decode attention and
    its Pallas kernel mask them.  So a lane with length 0 (or less) gets
    uniform weights: the mean of V over all S slots.  Returns ``(B, H, D)``
    in ``q.dtype``."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, hkv, h // hkv, d).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(device=q.device, dtype=torch.int64)[:, None])
    logits = torch.where(valid[:, None, None, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_partial_ref(q, k, v, lengths, *, scale=None):
    """``decode_attention_ref`` over a range of slots, with its log-sum-exp:
    ``(out (B, H, D) in q.dtype, lse (B, H) float32)``, ``out`` the float32
    softmax-weighted V over the slots ``s < lengths[b]`` and ``lse`` the
    log-sum-exp of their scaled float32 logits.  A length of 0 or less is
    an empty range: ``out`` 0 and ``lse`` -inf.  Ranges of a cache merged
    by ``runtime.model_axis.merge_partials`` give ``decode_attention_ref``
    over their union."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, hkv, h // hkv, d).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(device=q.device, dtype=torch.int64)[:, None])
    logits = torch.where(valid[:, None, None, :], logits, -torch.inf)
    lse = torch.logsumexp(logits, dim=-1)
    w = torch.exp(logits - torch.where(lse.isfinite(), lse, 0.0)[..., None])
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return out.reshape(b, h, d).to(q.dtype), lse.reshape(b, h)


def selective_scan_ref(x, dt, bmat, cmat, a):
    """The mamba-1 recurrence, one step after another: x/dt ``(B, L, di)``,
    bmat/cmat ``(B, L, st)``, a ``(di, st)``; in float32, from h = 0,
    ``h = exp(dt[t]·a) ⊙ h + (dt[t]·x[t]) ⊗ B[t]`` and ``y[t] = h · C[t]``.
    Returns y ``(B, L, di)`` in ``x.dtype`` (no gate, no skip)."""
    bsz, l, di = x.shape
    xf, dtf, bf, cf, af = (t.float() for t in (x, dt, bmat, cmat, a))
    h = torch.zeros((bsz, di, bmat.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = torch.empty((bsz, l, di), dtype=torch.float32, device=x.device)
    for t in range(l):
        da = torch.exp(dtf[:, t, :, None] * af[None])
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys[:, t] = torch.einsum("bds,bs->bd", h, cf[:, t])
    return ys.to(x.dtype)


def selective_scan_bwd_ref(x, dt, bmat, cmat, a, dy):
    """The gradients of ``selective_scan_ref`` for the cotangent ``dy``
    ``(B, L, di)``: ``(dx, ddt, dB, dC, dA)`` in the inputs' dtypes, from
    the reverse-time recurrence one step after another in float32.  With
    ``dA_t = exp(dt_t·a)`` and ``g_t`` the gradient reaching ``h_t``::

        g_t   = dy_t ⊗ C_t + dA_{t+1} ⊙ g_{t+1}
        dC_t  = Σ_c dy_t[c]·h_t[c]        dB_t = Σ_c g_t[c]·dt_t[c]·x_t[c]
        dx_t  = dt_t·Σ_n g_t·B_t          ddt_t = Σ_n g_t ⊙ (x_t B_t
                                                  + a ⊙ dA_t ⊙ h_{t−1})
        dA    = Σ_{b,t} g_t ⊙ dA_t ⊙ h_{t−1}·dt_t

    The forward's states are kept, every one of them."""
    bsz, l, di = x.shape
    xf, dtf, bf, cf, af, dyf = (t.float() for t in (x, dt, bmat, cmat, a,
                                                    dy))
    hs = [torch.zeros((bsz, di, bmat.shape[-1]), dtype=torch.float32,
                      device=x.device)]
    for t in range(l):
        da = torch.exp(dtf[:, t, :, None] * af[None])
        hs.append(da * hs[-1]
                  + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da_sum = torch.zeros_like(af)
    q = torch.zeros_like(hs[0])             # dA_{t+1} ⊙ g_{t+1}
    for t in range(l - 1, -1, -1):
        da = torch.exp(dtf[:, t, :, None] * af[None])
        g = dyf[:, t, :, None] * cf[:, t, None, :] + q
        dh = da * hs[t]                      # dA_t ⊙ h_{t−1}
        dc[:, t] = torch.einsum("bd,bds->bs", dyf[:, t], hs[t + 1])
        db[:, t] = torch.einsum("bds,bd->bs", g, dtf[:, t] * xf[:, t])
        dx[:, t] = dtf[:, t] * torch.einsum("bds,bs->bd", g, bf[:, t])
        ddt[:, t] = (g * (xf[:, t, :, None] * bf[:, t, None, :]
                          + af[None] * dh)).sum(-1)
        da_sum += (g * dh * dtf[:, t, :, None]).sum(0)
        q = da * g
    return (dx.to(x.dtype), ddt.to(dt.dtype), db.to(bmat.dtype),
            dc.to(cmat.dtype), da_sum.to(a.dtype))


# --------------------------------------------------------------------------
# the selective scan with a bfloat16 payload (ssm_fwd(scan_dtype=bfloat16))
# --------------------------------------------------------------------------

def _tree_scan_bf16(a, b):
    """The states of ``jax.lax.associative_scan`` of the combine ``(a1, b1)
    ∘ (a2, b2) = (a1·a2, b1·a2 + b2)`` along axis 1, run as jax's odd/even
    recursion: combine the pairs (0, 1), (2, 3), …; scan those
    recursively; form each even position from its odd neighbour's prefix
    and its own element (an odd length leaves its last element to this
    pass); interleave.  Each ``*`` and ``+`` is one bf16 operation on bf16
    tensors, rounded once.  Only the b half is returned: the a halves of
    the prefixes never reach a state."""
    n = b.shape[1]
    if n < 2:
        return b
    a1 = a[:, 1::2]
    ob = _tree_scan_bf16(a[:, 0:-1:2] * a1, b[:, 0:-1:2] * a1 + b[:, 1::2])
    ae, be = a[:, 2::2], b[:, 2::2]
    even = torch.cat([b[:, :1], ob[:, :be.shape[1]] * ae + be], dim=1)
    if n % 2:
        pairs = torch.stack([even[:, :-1], ob], dim=2).flatten(1, 2)
        return torch.cat([pairs, even[:, -1:]], dim=1)
    return torch.stack([even, ob], dim=2).flatten(1, 2)


def scan_chunk_bf16(h0, da, dbx):
    """One chunk of the reference's bf16 scan (``repro.models.ssm.
    _selective_scan_chunk`` at ``scan_dtype=bfloat16``): da, dbx ``(B, c,
    di, st)`` and h0 ``(B, di, st)``, all bfloat16.  Step 0 takes ``da'_0
    = 1`` and ``dbx'_0 = dbx_0 + da_0·h0`` (both bf16 operations); then
    the tree of ``_tree_scan_bf16``.  Returns ``(hs, h_last)`` in bf16."""
    dbx = torch.cat([dbx[:, :1] + da[:, :1] * h0[:, None], dbx[:, 1:]],
                    dim=1)
    da = torch.cat([torch.ones_like(da[:, :1]), da[:, 1:]], dim=1)
    hs = _tree_scan_bf16(da, dbx)
    return hs, hs[:, -1]


def scan_chunk_len(l: int, chunk: int) -> int:
    """The chunk the reference's ``ssm_fwd`` takes at length ``l``:
    ``min(chunk, l)``, which must divide ``l``."""
    c = min(chunk, l)
    if c < 1 or l % c:
        raise ValueError(f"the bf16 scan's chunk {c} does not divide the "
                         f"length {l}")
    return c


def _payload_bf16(x, dt, bmat, a):
    """The chunk's scan payload as the reference forms it: ``da =
    bf16(exp(dt·a))`` and ``dbx = bf16((dt·x)·B)``, the products and the
    exponential in float32."""
    da = torch.exp(dt[..., None] * a).to(torch.bfloat16)
    dbx = ((dt * x)[..., None] * bmat[:, :, None, :]).to(torch.bfloat16)
    return da, dbx


def state_sum(p):
    """``p (..., st)`` summed over its last axis in float32 in the card
    kernels' order: padded with zeros to a power of two, then halves
    added, the highest bit of the state index first (state s with s + w/2,
    then those sums with s + w/4, …), which is the order of B9b's
    transposed butterfly."""
    st = p.shape[-1]
    w = 1 << max(0, (st - 1).bit_length())
    if w > st:
        p = torch.nn.functional.pad(p, (0, w - st))
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def selective_scan_bf16_states_ref(x, dt, bmat, cmat, a, *, chunk=256):
    """The reference's ``ssm_fwd`` recurrence at ``scan_dtype=bfloat16``
    (``repro/models/ssm.py:97-105``): per chunk of ``c = min(chunk, L)``
    steps the payload of ``_payload_bf16``, the chunk's entering state
    rounded to bf16, ``scan_chunk_bf16``, ``y_t = Σ_s float(h_t[s])·C_t[s]``
    in float32 (summed in ``state_sum``'s order, so that the card's kernel
    gives the same bits), and the next chunk entering at
    ``float(h_last)``.  Inputs
    as ``selective_scan_ref``'s, float32.  Returns ``(y (B, L, di),
    hck (B, L / c, di, st))``: the float32 state entering each chunk."""
    bsz, l, di = x.shape
    st = bmat.shape[-1]
    c = scan_chunk_len(l, chunk)
    xf, dtf, bf, cf, af = (t.float() for t in (x, dt, bmat, cmat, a))
    y = torch.empty((bsz, l, di), dtype=torch.float32, device=x.device)
    hck = torch.empty((bsz, l // c, di, st), dtype=torch.float32,
                      device=x.device)
    h = torch.zeros((bsz, di, st), dtype=torch.float32, device=x.device)
    for k in range(l // c):
        sl = slice(k * c, (k + 1) * c)
        hck[:, k] = h
        da, dbx = _payload_bf16(xf[:, sl], dtf[:, sl], bf[:, sl], af)
        hs, h_last = scan_chunk_bf16(h.to(torch.bfloat16), da, dbx)
        y[:, sl] = state_sum(hs.float() * cf[:, sl, None, :])
        h = h_last.float()
    return y, hck


def selective_scan_bf16_ref(x, dt, bmat, cmat, a, *, chunk=256):
    """``y (B, L, di)`` of ``selective_scan_bf16_states_ref``, float32."""
    return selective_scan_bf16_states_ref(x, dt, bmat, cmat, a,
                                          chunk=chunk)[0]


def selective_scan_bf16_bwd_ref(x, dt, bmat, cmat, a, dy, *, chunk=256):
    """The gradients ``(dx, ddt, dB, dC, dA)`` (float32) of
    ``selective_scan_bf16_ref`` for the cotangent ``dy``: ``torch.autograd``
    through the plain forward, a chunk at a time, last first, from the
    states entering the chunks.  That is the reference's VJP: the
    cotangent entering the states is ``bf16(dy_t ⊗ C_t)``, the chunk's last
    state also takes the carried cotangent (a bf16 add), the tree's
    transpose runs in bf16 operations, and the da and dbx cotangents go
    back to float32 through ``exp``, the products and ``a``."""
    bsz, l, di = x.shape
    c = scan_chunk_len(l, chunk)
    xf, dtf, bf, cf, af, dyf = (t.float().detach() for t in (x, dt, bmat,
                                                            cmat, a, dy))
    with torch.no_grad():
        _, hck = selective_scan_bf16_states_ref(xf, dtf, bf, cf, af,
                                                chunk=c)
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da_sum = torch.zeros_like(af)
    g_carry = torch.zeros_like(hck[:, 0])
    for k in range(l // c - 1, -1, -1):
        sl = slice(k * c, (k + 1) * c)
        with torch.enable_grad():
            leaves = [t[:, sl].clone().requires_grad_()
                      for t in (xf, dtf, bf, cf)]
            al = af.clone().requires_grad_()
            h_in = hck[:, k].clone().requires_grad_()
            xs, dts, bs, cs = leaves
            da, dbx = _payload_bf16(xs, dts, bs, al)
            hs, h_last = scan_chunk_bf16(h_in.to(torch.bfloat16), da, dbx)
            yk = state_sum(hs.float() * cs[:, :, None, :])
            gx, gdt, gb, gc, ga, gh = torch.autograd.grad(
                [yk, h_last.float()], [*leaves, al, h_in],
                [dyf[:, sl], g_carry])
        dx[:, sl], ddt[:, sl], db[:, sl], dc[:, sl] = gx, gdt, gb, gc
        da_sum += ga
        g_carry = gh
    return dx, ddt, db, dc, da_sum
