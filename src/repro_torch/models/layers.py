"""Shared neural building blocks (pure functions, params = nested dicts).

The counterparts of ``repro.models.layers``: linear layers, norms, RoPE,
the MLP and the training-forward attention (``attention``: the dense,
flash and banded sliding-window schedules, picked by the reference's
rule; ``attention_fwd``), with the same parameter trees and the same
float32 arithmetic where the reference computes in float32.  ``linear``
casts each weight to the activation dtype at each use, as the
reference's does: a serving model stores its weights in that dtype once
(``models.transformer.Model``), so the cast is a no-op there, and a
training model keeps float32 master weights that the cast reads.

The attention schedules are plain PyTorch in float32, as the reference's
are plain jnp (no Pallas kernel lies on the training path).  At cross
shapes (``Sq != Skv``) the pick is the reference's too: the banded
schedule needs self-attention and flash needs both lengths a multiple of
512, so whisper's 1500 frames and the vision model's 1601 image tokens
take the dense one.  The
reference's ``lax.scan`` over chunks becomes a Python loop over the same
chunks in the same order; like the reference's scan, the flash schedule
computes the fully masked chunks too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "init_linear", "linear", "init_norm", "norm_apply", "rope",
    "attention", "init_attention", "attention_fwd", "serve_attention",
    "mlp_fwd", "init_mlp",
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
    """``x @ w (+ b)``, the weights cast to ``x.dtype`` (a no-op where they
    are stored in it)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
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
# attention (training forward): q (B, Sq, Hkv, G, D), k/v (B, Skv, Hkv, D)
# ---------------------------------------------------------------------------

def _positions(n, device, start=0):
    return start + torch.arange(n, device=device)


def _dense_attention(q, k, v, *, causal, window, q_pos0=0, kv_pos0=0,
                     kv_len=None):
    """One float32 softmax over all of k/v; masked logits are -1e30."""
    d = q.shape[-1]
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                          k.float()) * (d ** -0.5)
    sq, sk = q.shape[1], k.shape[1]
    qi = _positions(sq, q.device, q_pos0)[:, None]
    ki = _positions(sk, q.device, kv_pos0)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window:
        mask = mask & (ki > qi - window)
    if kv_len is not None:               # decode: only positions < kv_len
        mask = mask & (ki < kv_len)
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.to(q.dtype)


def _flash_attention(q, k, v, *, causal, window, q_chunk=1024,
                     kv_chunk=1024):
    """Memory-bounded attention: q chunks (outer) and kv chunks (inner)
    with a running log-sum-exp, the reference's two ``lax.scan``s as two
    loops.  Fully masked kv chunks are computed and masked, as there."""
    b, sq, hkv, g, d = q.shape
    sk = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunks {q_chunk}/{kv_chunk} do not divide the "
                         f"lengths {sq}/{sk}")
    scale = d ** -0.5
    qs, ks, vs = q.float(), k.float(), v.float()
    outs = []
    for iq in range(sq // q_chunk):
        qc = qs[:, iq * q_chunk:(iq + 1) * q_chunk]
        qpos = _positions(q_chunk, q.device, iq * q_chunk)[:, None]
        m = torch.full((b, hkv, g, q_chunk), -torch.inf, device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), device=q.device)
        acc = torch.zeros((b, q_chunk, hkv, g, d), device=q.device)
        for ik in range(sk // kv_chunk):
            kc = ks[:, ik * kv_chunk:(ik + 1) * kv_chunk]
            vc = vs[:, ik * kv_chunk:(ik + 1) * kv_chunk]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
            kpos = _positions(kv_chunk, q.device, ik * kv_chunk)[None, :]
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (kpos <= qpos)
            if window:
                mask = mask & (kpos > qpos - window)
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bhgqk,bkhd->bqhgd", p, vc)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30).permute(
            0, 3, 1, 2)[..., None])
    return torch.cat(outs, dim=1).to(q.dtype)


def _swa_banded_attention(q, k, v, *, window, q_chunk=2048):
    """Sliding-window attention over the diagonal band only: every q chunk
    attends a (q_chunk + window)-wide kv band around the diagonal."""
    b, sq, hkv, g, d = q.shape
    q_chunk = min(q_chunk, sq)
    if sq % q_chunk:
        raise ValueError(f"q_chunk {q_chunk} does not divide {sq}")
    band = min(q_chunk + window, sq)
    scale = d ** -0.5
    outs = []
    for iq in range(sq // q_chunk):
        qc = q[:, iq * q_chunk:(iq + 1) * q_chunk].float()
        start = min(max(iq * q_chunk - window, 0), sq - band)
        kc = k[:, start:start + band].float()
        vc = v[:, start:start + band].float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
        qpos = _positions(q_chunk, q.device, iq * q_chunk)[:, None]
        kpos = _positions(band, q.device, start)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        logits = torch.where(mask, logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", w, vc).to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_schedule(sq: int, sk: int, *, causal=True, window=0,
                       kv_len=None, flash_threshold=4096) -> str:
    """The reference's pick: ``"banded"``, ``"flash"`` or ``"dense"``."""
    self_attn = sq == sk and kv_len is None
    if (causal and window and self_attn and sq > 2 * window
            and sq % min(2048, sq) == 0):
        return "banded"
    if (sq > 1 and sq * sk > flash_threshold * flash_threshold // 4
            and sq % 512 == 0 and sk % 512 == 0 and kv_len is None):
        return "flash"
    return "dense"


def attention(q, k, v, *, causal=True, window=0, q_pos0=0, kv_len=None,
              flash_threshold=4096):
    """GQA attention. q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    pick = attention_schedule(sq, k.shape[1], causal=causal, window=window,
                              kv_len=kv_len, flash_threshold=flash_threshold)
    if pick == "banded":
        out = _swa_banded_attention(qg, k, v, window=window,
                                    q_chunk=min(2048, sq))
    elif pick == "flash":
        out = _flash_attention(qg, k, v, causal=causal, window=window,
                               q_chunk=min(2048, sq),
                               kv_chunk=min(1024, k.shape[1]))
    else:
        out = _dense_attention(qg, k, v, causal=causal, window=window,
                               q_pos0=q_pos0, kv_len=kv_len)
    return out.reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, *, d_model=None):
    d = d_model or cfg.d_model
    hd, h, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": init_linear(generator, d, h * hd, bias=cfg.qkv_bias),
        "wk": init_linear(generator, d, hkv * hd, bias=cfg.qkv_bias),
        "wv": init_linear(generator, d, hkv * hd, bias=cfg.qkv_bias),
        "wo": init_linear(generator, h * hd, d),
    }


def _tp_attention(p, x, src, cfg, tp):
    """The attention block's leaves and inputs on the model axis ``tp``:
    ``(p, x, src, heads, kv_heads, kv_index, row_split)``.

    With ``H % M == 0`` a rank runs its block of ``H/M`` query heads
    (``wq`` and its bias split by columns, ``wo`` by rows, then
    ``reduce``) and the inputs ``enter``.  Its KV heads are its block of
    ``Hkv/M`` where ``Hkv % M == 0`` (the GQA groups stay aligned: query
    head ``j`` reads KV head ``j // (H/Hkv)``); else (``Hkv < M``, or an
    ``Hkv`` that M does not divide, e.g. reduced hymba's 2 at M = 4) ``wk``
    and ``wv`` are gathered whole (``gather_used``) and each query head
    reads its KV head by index.  With ``H % M != 0`` (hymba's 25 heads at
    M = 2 or 4) every leaf is gathered whole (``full``) and the block is
    computed replicated."""
    h, hkv, hd, m = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, tp.size
    if h % m:
        whole = {name: {k: tp.full(t, 0 if name == "wo" and k == "w"
                                   else -1, (hkv if name in ("wk", "wv")
                                             else h) * hd)
                        for k, t in leaf.items()}
                 for name, leaf in p.items()}
        return whole, x, src, h, hkv, None, False
    x_in = tp.enter(x)
    src_in = x_in if src is x else tp.enter(src)
    hl, kv_index = h // m, None
    if hkv % m == 0:
        hkv = hkv // m
    else:
        p = dict(p, **{name: {k: tp.gather_used(t, -1, hkv * hd)
                              for k, t in p[name].items()}
                       for name in ("wk", "wv")})
        kv_index = (tp.rank * hl + torch.arange(hl, device=x.device)) \
            // (h // hkv)
    return p, x_in, src_in, hl, hkv, kv_index, True


def serve_attention(p, cfg, tp):
    """The serving half of the split attention block on the model axis
    ``tp``: ``(p, heads, kv_heads, row_split)``, the leaves this rank
    projects with and the query and KV heads they give.

    With ``H % M == 0`` a rank projects its block of ``H/M`` query heads
    (``wq`` and its bias by columns) and ``wo``'s rows for them
    (``row_split``: its output is a partial sum, ``reduce``d), and its
    block of ``Hkv/M`` KV heads where ``Hkv % M == 0``; else (``Hkv < M``,
    or an ``Hkv`` that M does not divide, hymba's 5 or reduced hymba's 2
    at M = 4) ``wk`` and ``wv`` are gathered whole and it projects every
    KV head.  With ``H % M != 0`` (hymba's 25 heads at M = 2 or 4) every
    leaf is gathered whole (``full``) and the block runs replicated.
    Serving has no backward: the gathers are forward collectives."""
    h, hkv, hd, m = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, tp.size

    def whole(names):
        return {name: {k: tp.full(t, 0 if name == "wo" and k == "w"
                                  else -1, (hkv if name in ("wk", "wv")
                                            else h) * hd)
                       for k, t in p[name].items()} for name in names}

    if h % m:
        return whole(p), h, hkv, False
    if hkv % m:
        return dict(p, **whole(("wk", "wv"))), h // m, hkv, True
    return p, h // m, hkv // m, True


def attention_fwd(p, x, cfg, *, kv_x=None, positions=None, causal=True,
                  window=0, cache=None, cache_pos=None, use_rope=True,
                  tp=None):
    """Self- or cross-attention, the reference's ``attention_fwd``.

    ``kv_x`` (B, Skv, D): cross-attention, keys and values from ``kv_x``,
    no RoPE and no causal mask.  ``cache``: a dict {k, v} of (B, Smax,
    Hkv, D) buffers; the new k/v rows are written at ``cache_pos`` (an int
    or a 0-d tensor; the start clamped into the buffer, as
    ``dynamic_update_slice`` clamps it) in place, and the queries attend
    positions ``< cache_pos + Sq`` of the whole buffer with the window
    mask and no causal one, as the reference's cache path does.  Returns
    ``y``, or ``(y, cache)`` with a cache (the same dict, written).

    ``tp`` (training, no cache): the model axis; ``p`` holds this rank's
    model-axis parts, and the heads are split as ``_tp_attention`` says."""
    b, sq, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    kv_index, row_split = None, False
    if tp is not None:
        p, x, src, h, hkv, kv_index, row_split = _tp_attention(
            p, x, src, cfg, tp)
    q = linear(p["wq"], x).reshape(b, sq, h, hd)
    k = linear(p["wk"], src).reshape(b, src.shape[1], hkv, hd)
    v = linear(p["wv"], src).reshape(b, src.shape[1], hkv, hd)
    if kv_index is not None:
        k, v = k[:, :, kv_index], v[:, :, kv_index]
    if positions is None:
        positions = torch.arange(sq, device=x.device)[None, :]
    if use_rope and kv_x is None:
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        pos = torch.as_tensor(cache_pos, device=x.device)
        start = torch.clamp(pos, 0, ck.shape[1] - k.shape[1])
        rows = start + torch.arange(k.shape[1], device=x.device)
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        out = attention(q, ck, cv, causal=False, window=window, q_pos0=pos,
                        kv_len=pos + sq)
        return linear(p["wo"], out.reshape(b, sq, h * hd)), cache
    out = attention(q, k, v, causal=causal and kv_x is None, window=window)
    y = linear(p["wo"], out.reshape(b, sq, h * hd))
    return tp.reduce(y) if row_split else y


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(generator, d, f, *, act="swiglu"):
    p = {"w1": init_linear(generator, d, f),
         "w2": init_linear(generator, f, d)}
    if act == "swiglu":
        p["w3"] = init_linear(generator, d, f)
    return p


def mlp_fwd(p, x, *, act="swiglu", tp=None):
    """``tp``: the model axis, whose ranks hold ``w1``/``w3`` split by
    columns and ``w2`` by rows (the caller passes it where it splits
    ``F``): ``x`` enters, and the rows' partial sums are reduced."""
    if tp is not None:
        x = tp.enter(x)
    h = linear(p["w1"], x)
    if act == "swiglu":
        h = F.silu(h) * linear(p["w3"], x)
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    y = linear(p["w2"], h)
    return y if tp is None else tp.reduce(y)
