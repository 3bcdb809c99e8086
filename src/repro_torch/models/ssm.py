"""Mamba-1 selective SSM block (falcon-mamba-7b).

The forward runs the input projection, the depthwise causal convolution,
the x/dt projections and the gate as plain PyTorch, as the reference does in
jnp and in the activations' dtype (the conv's weights cast to it, as
``linear`` casts its own), and the recurrence through
``kernels.ops.selective_scan`` (the card's selective-scan kernel; its plain
version on the CPU).  The reference computes the recurrence as a chunked
associative scan.  With a float32 payload its ``chunk`` is a blocking knob
of that scan and changes nothing here; with ``scan_dtype=bfloat16`` the
payload is rounded inside each chunk and the chunk is part of the function
(B9b and its backward B9b′).
Training runs ``ssm_fwd`` as it stands: in grad mode ``ops.selective_scan``
gives the recurrence its backward (the card's backward kernel, which the
reference gets from ``jax.grad`` of its scan), and autograd carries the
gradients through the rest.  The decode path is the exact single-step
recurrence with a rolling conv window.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _normal, init_linear, linear

__all__ = ["init_ssm", "ssm_fwd", "ssm_decode_step", "init_ssm_cache"]


def init_ssm(generator, cfg, *, d_model=None, d_inner=None):
    d = d_model or cfg.d_model
    di = d_inner or cfg.d_inner
    st, dr, dc = cfg.ssm_state, cfg.ssm_dt_rank, cfg.ssm_conv
    dev = generator.device
    a = torch.arange(1, st + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    return {
        "in_proj": init_linear(generator, d, 2 * di),
        "conv_w": _normal(generator, (dc, di), dc ** -0.5),
        "conv_b": torch.zeros((di,), device=dev),
        "x_proj": init_linear(generator, di, dr + 2 * st),
        "dt_proj": init_linear(generator, dr, di, bias=True),
        "a_log": torch.log(a),
        "d_skip": torch.ones((di,), device=dev),
        "out_proj": init_linear(generator, di, d),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, L, di); w: (K, di)."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:l, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + l, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _tp_ssm(p, u, di, tp):
    """The layer's leaves and input on the model axis ``tp``:
    ``(p, u, d_inner, tp)``.  Where ``di % M == 0`` a rank runs its block
    of ``di/M`` channels: ``conv_w``, ``conv_b``, ``dt_proj``, ``a_log``,
    ``d_skip``, and the rows of ``x_proj`` and ``out_proj``, are that
    block already.  ``in_proj``'s stored block is the rule table's
    contiguous columns of ``(x | z)`` (all of ``x`` on rank 0 and all of
    ``z`` on rank 1 at M = 2), so it is gathered whole
    (``gather_used``) and the rank's channels of ``x`` and of ``z`` are
    cut from it.  Else (``di`` odd at M = 2: no registered config) the
    layer runs replicated, ``in_proj`` gathered whole where it is split."""
    if not tp.splits(di):
        return dict(p, in_proj={"w": tp.full(p["in_proj"]["w"], -1,
                                             2 * di)}), u, di, None
    w = tp.gather_used(p["in_proj"]["w"], -1, 2 * di)
    if tp.size > 1:
        mine = tp.block(di)
        w = torch.cat([w[:, mine], w[:, di + mine.start:di + mine.stop]],
                      dim=1)
    return dict(p, in_proj={"w": w}), tp.enter(u), di // tp.size, tp


def ssm_fwd(p, u, cfg, *, d_inner=None, chunk=256,
            scan_dtype=torch.float32, tp=None):
    """u: (B, L, d). Returns (B, L, d).

    ``scan_dtype=torch.bfloat16`` rounds the scan payload (exp(dt·a) and
    dt·x·B) and each chunk's entering state to bfloat16 and scans each
    chunk of ``min(chunk, L)`` steps (which must divide L) as the
    reference's bf16 associative scan; the decay exponent, the boundary
    states and ``y`` stay float32.

    ``tp`` (training): the model axis; ``p`` holds this rank's parts and
    the layer runs its channels (``_tp_ssm``): the scan on ``di/M`` of
    them, ``x_proj``'s partial ``dt|B|C`` and ``out_proj``'s partial
    output reduced over the axis."""
    di = d_inner or cfg.d_inner
    if tp is not None:
        p, u, di, tp = _tp_ssm(p, u, di, tp)
    st, dr = cfg.ssm_state, cfg.ssm_dt_rank
    xz = linear(p["in_proj"], u)
    x, z = xz.split(di, dim=-1)                           # (B, L, di)
    x = F.silu(_causal_conv(x, p["conv_w"].to(x.dtype),
                            p["conv_b"].to(x.dtype)))

    dbc = linear(p["x_proj"], x)
    if tp is not None:
        dbc = tp.enter(tp.reduce(dbc))
    dt, bmat, cmat = dbc.split([dr, st, st], dim=-1)
    dt = F.softplus(linear(p["dt_proj"], dt)).float()     # (B, L, di)
    a = -torch.exp(p["a_log"].float())                    # (di, st)
    xs = x.float().contiguous()
    y = ops.selective_scan(xs, dt.contiguous(), bmat.float().contiguous(),
                           cmat.float().contiguous(), a, payload=scan_dtype,
                           chunk=chunk)
    y = y + xs * p["d_skip"].float()
    y = y * F.silu(z.float())
    out = linear(p["out_proj"], y.to(u.dtype))
    return out if tp is None else tp.reduce(out)


def init_ssm_cache(batch, cfg, *, d_inner=None, dtype=torch.float32,
                   device=None):
    di = d_inner or cfg.d_inner
    return {
        "h": torch.zeros((batch, di, cfg.ssm_state), device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
    }


def ssm_decode_step(p, u, cache, cfg, *, d_inner=None, tp=None):
    """u: (B, 1, d). Exact single-step recurrence. Returns (y, new_cache).

    ``tp`` (serving): the model axis; ``p`` holds this rank's parts, the
    cache's ``h`` and ``conv`` its block of ``di/M`` channels (the
    reference's ``cache_specs``), and the step runs those channels as
    ``ssm_fwd`` does (``_tp_ssm``): ``x_proj``'s partial ``dt|B|C`` and
    ``out_proj``'s partial output reduced over the axis."""
    di = d_inner or cfg.d_inner
    if tp is not None:
        p, u, di, tp = _tp_ssm(p, u, di, tp)
    st, dr = cfg.ssm_state, cfg.ssm_dt_rank
    xz = linear(p["in_proj"], u)                          # (B, 1, 2di)
    x, z = xz.split(di, dim=-1)
    conv_in = torch.cat([cache["conv"], x], dim=1)        # (B, K, di)
    w = p["conv_w"].to(x.dtype)
    xc = (conv_in * w[None]).sum(dim=1, keepdim=True) \
        + p["conv_b"].to(x.dtype)[None, None]
    xc = F.silu(xc)

    dbc = linear(p["x_proj"], xc)
    if tp is not None:
        dbc = tp.reduce(dbc)
    dt, bmat, cmat = dbc.split([dr, st, st], dim=-1)
    dt = F.softplus(linear(p["dt_proj"], dt)).float()
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt[..., None] * a)[:, 0]               # (B, di, st)
    dbx = (dt * xc.float())[..., None][:, 0] * bmat.float()[:, 0, None, :]
    h = da * cache["h"] + dbx
    y = torch.einsum("bds,bs->bd", h, cmat.float()[:, 0])[:, None]
    y = y + xc.float() * p["d_skip"].float()
    y = y * F.silu(z.float())
    out = linear(p["out_proj"], y.to(u.dtype))
    if tp is not None:
        out = tp.reduce(out)
    return out, {"h": h, "conv": conv_in[:, 1:]}
