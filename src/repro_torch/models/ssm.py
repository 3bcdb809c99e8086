"""Mamba-1 selective SSM block (falcon-mamba-7b).

The forward runs the input projection, the depthwise causal convolution,
the x/dt projections and the gate as plain PyTorch, as the reference does in
jnp, and the recurrence through ``kernels.ops.selective_scan`` (the card's
selective-scan kernel; its plain version on the CPU).  The reference
computes the recurrence as a chunked associative scan whose ``chunk`` is a
blocking knob of that scan; the port has no such knob.  Training runs
``ssm_fwd`` as it stands: in grad mode ``ops.selective_scan`` gives the
recurrence its backward (the card's backward kernel, which the reference
gets from ``jax.grad`` of its scan), and autograd carries the gradients
through the rest.  The decode path is the exact single-step recurrence
with a rolling conv window.
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


def ssm_fwd(p, u, cfg, *, d_inner=None, scan_dtype=torch.float32):
    """u: (B, L, d). Returns (B, L, d).

    The recurrence runs in float32.  ``scan_dtype=torch.bfloat16`` is the
    reference's other function, which rounds the scan payload to bfloat16
    inside each chunk; it is not ported (ROADMAP A16)."""
    if scan_dtype != torch.float32:
        raise NotImplementedError(
            "ssm_fwd with a bfloat16 scan payload is not ported: ROADMAP "
            "A16")
    di = d_inner or cfg.d_inner
    st, dr = cfg.ssm_state, cfg.ssm_dt_rank
    xz = linear(p["in_proj"], u)
    x, z = xz.split(di, dim=-1)                           # (B, L, di)
    x = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))

    dbc = linear(p["x_proj"], x)
    dt, bmat, cmat = dbc.split([dr, st, st], dim=-1)
    dt = F.softplus(linear(p["dt_proj"], dt)).float()     # (B, L, di)
    a = -torch.exp(p["a_log"].float())                    # (di, st)
    xs = x.float().contiguous()
    y = ops.selective_scan(xs, dt.contiguous(), bmat.float().contiguous(),
                           cmat.float().contiguous(), a)
    y = y + xs * p["d_skip"].float()
    y = y * F.silu(z.float())
    return linear(p["out_proj"], y.to(u.dtype))


def init_ssm_cache(batch, cfg, *, d_inner=None, dtype=torch.float32,
                   device=None):
    di = d_inner or cfg.d_inner
    return {
        "h": torch.zeros((batch, di, cfg.ssm_state), device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
    }


def ssm_decode_step(p, u, cache, cfg, *, d_inner=None):
    """u: (B, 1, d). Exact single-step recurrence. Returns (y, new_cache)."""
    di = d_inner or cfg.d_inner
    st, dr = cfg.ssm_state, cfg.ssm_dt_rank
    xz = linear(p["in_proj"], u)                          # (B, 1, 2di)
    x, z = xz.split(di, dim=-1)
    conv_in = torch.cat([cache["conv"], x], dim=1)        # (B, K, di)
    xc = (conv_in * p["conv_w"][None]).sum(dim=1, keepdim=True) \
        + p["conv_b"][None, None]
    xc = F.silu(xc)

    dbc = linear(p["x_proj"], xc)
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
    return out, {"h": h, "conv": conv_in[:, 1:]}
