"""Shared neural building blocks (pure functions, params = nested dicts).

The counterparts of ``repro.models.layers`` that the serving path needs:
linear layers, norms, RoPE and the MLP, with the same parameter trees and
the same float32 arithmetic where the reference computes in float32.  The
port stores each weight in the activation dtype once, when it loads the
parameters (``models.transformer.Model``), where the reference casts its
float32 master weight at every call; the numbers are the same.

The training-forward attention (``attention``, ``attention_fwd``: the
dense, flash and banded sliding-window schedules) is not ported yet
(ROADMAP A11); the serving path attends through ``models.transformer``'s
prefill and decode attention.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "init_linear", "linear", "init_norm", "norm_apply", "rope",
    "attention", "init_attention", "attention_fwd", "mlp_fwd", "init_mlp",
]


# ---------------------------------------------------------------------------
# init helpers: ``generator`` is a torch.Generator on the device the
# parameters are made on; the master values are float32, as the reference's
# ---------------------------------------------------------------------------

def _normal(generator, shape, scale) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device) * scale


def init_linear(generator, d_in, d_out, *, bias=False, scale=None):
    if scale is None:
        scale = d_in ** -0.5
    p = {"w": _normal(generator, (d_in, d_out), scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=generator.device)
    return p


def linear(p, x):
    """``x @ w (+ b)``; the weights are already in ``x.dtype``."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_norm(generator, d, *, kind="rmsnorm"):
    p = {"scale": torch.ones((d,), device=generator.device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=generator.device)
    return p


def norm_apply(p, x, *, kind="rmsnorm", eps=1e-5):
    """RMS or layer norm in float32 (scale and bias stay float32), the
    result in ``x.dtype``."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, *, theta=1e4):
    """x: (..., S, H, D). positions: (..., S) int."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs       # (..., S, half)
    cos = torch.cos(ang)[..., None, :]               # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def attention(*args, **kwargs):
    raise NotImplementedError(
        "the training-forward attention (dense, flash and banded SWA "
        "schedules) is not ported yet: ROADMAP A11")


def attention_fwd(*args, **kwargs):
    raise NotImplementedError(
        "attention_fwd (the training forward and cross-attention) is not "
        "ported yet: ROADMAP A11")


def init_attention(generator, cfg, *, d_model=None):
    d = d_model or cfg.d_model
    hd, h, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": init_linear(generator, d, h * hd, bias=cfg.qkv_bias),
        "wk": init_linear(generator, d, hkv * hd, bias=cfg.qkv_bias),
        "wv": init_linear(generator, d, hkv * hd, bias=cfg.qkv_bias),
        "wo": init_linear(generator, h * hd, d),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(generator, d, f, *, act="swiglu"):
    p = {"w1": init_linear(generator, d, f),
         "w2": init_linear(generator, f, d)}
    if act == "swiglu":
        p["w3"] = init_linear(generator, d, f)
    return p


def mlp_fwd(p, x, *, act="swiglu"):
    h = linear(p["w1"], x)
    if act == "swiglu":
        h = F.silu(h) * linear(p["w3"], x)
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return linear(p["w2"], h)
