"""The serving model: the families of ``repro.models.transformer`` that the
port runs so far, dense attention stacks (llama3-8b), MoE attention stacks
(mixtral-8x22b) and attention-free mamba-1 stacks (falcon-mamba-7b).

Parameters are the reference's nested-dict tree with the layers stacked on
a leading axis (``params["layers"]["attn"]["wq"]["w"]`` is ``(L, d, H·hd)``)
and live on ``Model.device``.  Every weight that the reference casts to
the activation dtype at each use is stored in that dtype once, when the
model loads it (``init_params``, ``load_params``); norm scales and biases,
``a_log`` and ``d_skip``, which the reference reads in float32, stay
float32.  The layer stack runs as a Python loop over views of the stacked
tensors.

Serving caches are the reference's too: ``{"pos", "layers"}`` with ring
K/V buffers ``(L, B, cache_len, Hkv, hd)`` and per-slot positions
``slot_pos``.  ``decode_step`` and ``prefill`` write the new K/V rows, slot
positions and SSM states into the cache's tensors in place and return a
cache dict that shares them, with ``pos`` a new tensor: a cache passed in
is consumed, and the reference's functional update becomes one write per
row.  Calling a step twice on the same cache dict rewrites the same rows
with the same values.

Decode attention runs through ``kernels.ops.decode_attention`` (the card's
flash-decoding kernel).  Its ``lengths`` are ``min(pos + 1, cache_len)``:
with full attention the valid slots of a lane are exactly that prefix of
the ring, because an admitted prompt replaces the lane's whole
``slot_pos`` and never wraps the ring, and decode then fills slot after
slot.  Prefill attention stays plain PyTorch, as it is plain jnp in the
reference.

The MoE FFN runs ``models.moe.moe_fwd`` (groups of ``RunCtx.moe_groups``),
or, for a one-token decode step, ``RunCtx.moe_step`` when it is set: the
serving hook that ``serve.engine`` points at a ``DynamicMoELayer``.

Sliding-window attention (``swa_window > 0``) runs where the window cannot
bind: the cache is cut to the window (``cache_len <= swa_window``, as the
reference cuts it) and no position reaches ``swa_window``; there the
reference's window masks are true for every written slot.  A step that
would reach it raises (ROADMAP A11).

Not ported yet: the families ``hybrid``, ``encdec`` and ``vlm``,
sliding-window attention past the window, the training forward of
attention stacks, and the loss (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.comm.communicator import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

__all__ = ["RunCtx", "Model", "tree_map"]

_NOT_PORTED = {"hybrid": "A11", "encdec": "A11", "vlm": "A11"}
# subtrees and leaves the reference reads in float32 at every use
_FLOAT32_PARAMS = ("ln1", "ln2", "final_norm", "a_log", "d_skip")


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Runtime context.  The reference's sharding, remat and scan-barrier
    hooks have no counterpart: the port runs one model on one card.
    ``moe_groups`` splits the batch into groups whose tokens ``moe_fwd``
    dispatches separately.  ``moe_step``, when set, routes the MoE FFN of
    a one-token decode step through ``fn(moe_params, h) -> out`` (both (B,
    1, D)) instead of ``moe_fwd``: ``serve.engine`` wires the per-batch
    routed ``DynamicMoELayer`` in here.  Prefill keeps ``moe_fwd``."""

    act_dtype: torch.dtype = torch.bfloat16
    ssm_scan_dtype: torch.dtype = torch.float32
    moe_groups: int = 1
    moe_step: Callable[[Any, torch.Tensor], torch.Tensor] | None = None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _init_block(generator, cfg, *, kind: str):
    p: dict[str, Any] = {"ln1": L.init_norm(generator, cfg.d_model,
                                            kind=cfg.norm)}
    if kind == "ssm":
        p["ssm"] = S.init_ssm(generator, cfg)
        return p
    p["attn"] = L.init_attention(generator, cfg)
    p["ln2"] = L.init_norm(generator, cfg.d_model, kind=cfg.norm)
    if kind == "moe":
        p["moe"] = M.init_moe(generator, cfg)
        if cfg.dense_residual:
            p["res_mlp"] = L.init_mlp(generator, cfg.d_model,
                                      cfg.residual_d_ff, act=cfg.act)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, act=cfg.act)
    return p


def _ffn(p, x, cfg, ctx, *, decode=False):
    h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
    if "moe" not in p:
        return L.mlp_fwd(p["mlp"], h, act=cfg.act)
    b, s_len, d = h.shape
    if ctx.moe_step is not None and decode:
        # serving decode: the comm-scheduled per-step MoE exchange.  The
        # reference takes it for any one-token step, a prefill chunk of
        # one token too, where the hook's batch is not the engine's lanes
        out = ctx.moe_step(p["moe"], h)
    else:
        g = min(ctx.moe_groups, b)
        out = M.moe_fwd(p["moe"], h.reshape(g, (b // g) * s_len, d),
                        cfg).reshape(b, s_len, d)
    if cfg.dense_residual:
        out = out + L.mlp_fwd(p["res_mlp"], h, act=cfg.act)
    return out


def _qkv(p, x, cfg):
    b, s_len = x.shape[:2]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return (L.linear(p["wq"], x).reshape(b, s_len, h, hd),
            L.linear(p["wk"], x).reshape(b, s_len, hkv, hd),
            L.linear(p["wv"], x).reshape(b, s_len, hkv, hd))


def _attn_decode(p, x, cfg, cache, pos):
    """x: (B, 1, D); one token per lane into the ring K/V cache.

    ``pos`` 0-d: every lane at the same position, ``slot_pos``
    ``(cache_len,)`` shared.  ``pos`` (B,): lanes at their own positions
    with ``slot_pos`` ``(B, cache_len)`` (``init_cache(per_slot=True)``).
    The slot positions are kept as the reference keeps them (windowed
    attention will read them); the attention reads the valid prefix
    ``min(pos + 1, cache_len)`` of each lane."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    cache_len = ck.shape[1]
    q, k, v = _qkv(p, x, cfg)
    positions = pos[None, None] if pos.dim() == 0 else pos[:, None]
    q = L.rope(q, positions, theta=cfg.rope_theta)
    k = L.rope(k, positions, theta=cfg.rope_theta)

    slot = (pos % cache_len).long()     # ring slot (== pos before a wrap)
    if pos.dim() == 0:
        ck.index_copy_(1, slot.reshape(1), k.to(ck.dtype))
        cv.index_copy_(1, slot.reshape(1), v.to(cv.dtype))
        spos.index_copy_(0, slot.reshape(1), pos.reshape(1).to(torch.int32))
        lengths = torch.clamp(pos + 1, max=cache_len).to(torch.int32)
        lengths = lengths.expand(b).contiguous()
    else:
        lane = torch.arange(b, device=x.device)
        ck[lane, slot] = k[:, 0].to(ck.dtype)
        cv[lane, slot] = v[:, 0].to(cv.dtype)
        spos[lane, slot] = pos.to(torch.int32)
        lengths = torch.clamp(pos + 1, max=cache_len).to(torch.int32)
    out = ops.decode_attention(q.reshape(b, h, hd), ck, cv, lengths)
    return L.linear(p["wo"], out.reshape(b, 1, h * hd).to(x.dtype))


def _attn_prefill(p, x, cfg, cache, pos):
    """x: (B, S, D) prompt chunk; writes positions [pos, pos+S) into the
    ring cache and attends causally over everything valid, as S successive
    ``_attn_decode`` calls would (float32 einsum, -1e30 masking, a softmax
    over the whole cache), as long as the chunk fits the ring (S <=
    cache_len: no slot is written twice within one call).  ``pos`` 0-d
    for a shared-position cache, (B,) for a per-slot one."""
    b, s_len = x.shape[:2]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    cache_len = ck.shape[1]
    q, k, v = _qkv(p, x, cfg)
    offs = torch.arange(s_len, device=x.device)
    per_slot = pos.dim() == 1
    qpos = pos[:, None] + offs[None] if per_slot else pos + offs
    qp = qpos if per_slot else qpos[None]              # (B, S) | (1, S)
    q = L.rope(q, qp, theta=cfg.rope_theta)
    k = L.rope(k, qp, theta=cfg.rope_theta)

    slots = (qpos % cache_len).long()
    if per_slot:
        lane = torch.arange(b, device=x.device)[:, None]
        ck[lane, slots] = k.to(ck.dtype)
        cv[lane, slots] = v.to(cv.dtype)
        spos[lane, slots] = qpos.to(torch.int32)
        sp = spos                                      # (B, cache_len)
    else:
        ck.index_copy_(1, slots, k.to(ck.dtype))
        cv.index_copy_(1, slots, v.to(cv.dtype))
        spos.index_copy_(0, slots, qpos.to(torch.int32))
        sp = spos[None]                                # (1, cache_len)
    valid = (sp[:, None, :] >= 0) & (sp[:, None, :] <= qp[..., None])
    qg = q.reshape(b, s_len, hkv, h // hkv, hd)
    logits = torch.einsum("bshgd,blhd->bhgsl", qg.float(),
                          ck.float()) * (hd ** -0.5)
    logits = torch.where(valid[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgsl,blhd->bshgd", w, cv.float())
    out = out.reshape(b, s_len, h * hd).to(x.dtype)
    return L.linear(p["wo"], out)


def _block_decode(p, x, cfg, ctx, cache, pos, *, kind):
    """One layer of one decode step; writes the layer's cache in place."""
    h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
    if kind == "ssm":
        y, new = S.ssm_decode_step(p["ssm"], h, cache["ssm"], cfg)
        cache["ssm"]["h"].copy_(new["h"])
        cache["ssm"]["conv"].copy_(new["conv"])
        return x + y
    x = x + _attn_decode(p["attn"], h, cfg, cache, pos)
    return x + _ffn(p, x, cfg, ctx, decode=True)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model:
    """Family-dispatching model wrapper around the pure functions above,
    on one device (``device=None`` means ``"cuda"``; without a card only
    ``device="cpu"`` runs)."""

    def __init__(self, cfg, ctx: RunCtx | None = None, *, device=None):
        if cfg.family in _NOT_PORTED:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP "
                f"{_NOT_PORTED[cfg.family]}")
        self.cfg = cfg
        self.ctx = ctx or RunCtx()
        self.kind = cfg.family                    # dense | moe | ssm
        self.device = resolve_device(device)

    def _check_window(self, pos, s_len: int) -> None:
        """Refuse a step whose positions reach ``swa_window``: below it the
        reference's window masks are true for every written slot, and
        windowed attention past it is not ported.  Reads the positions on
        the host (one sync a step, for windowed configs only)."""
        window = self.cfg.swa_window
        if window and int(pos.max()) + s_len > window:
            raise NotImplementedError(
                f"position {int(pos.max()) + s_len - 1} reaches the "
                f"sliding window ({window}); sliding-window attention past "
                "the window is not ported yet: ROADMAP A11")

    # ---- parameters ----
    def _load(self, tree, *, float32=False):
        """Place a (numpy or tensor) parameter tree on the device, in the
        activation dtype but for the float32 leaves."""
        if isinstance(tree, dict):
            return {k: self._load(v, float32=float32 or k in _FLOAT32_PARAMS)
                    for k, v in tree.items()}
        dtype = torch.float32 if float32 else self.ctx.act_dtype
        return torch.as_tensor(tree).to(device=self.device, dtype=dtype)

    def init_params(self, generator: torch.Generator):
        """Random parameters from ``generator`` (a ``torch.Generator`` on
        ``self.device``), drawn as the reference draws its master values
        (normal × fan-in^-0.5, embeddings × 0.02; the numbers differ from
        ``jax.random``'s) and stored at once, a layer at a time, in the
        activation dtype."""
        if resolve_device(generator.device) != self.device:
            raise ValueError(f"the generator lies on {generator.device}, "
                             f"the model on {self.device}")
        cfg = self.cfg
        p: dict[str, Any] = {
            "embed": self._load({"w": L._normal(
                generator, (cfg.vocab_size, cfg.d_model), 0.02)}),
            "final_norm": self._load(L.init_norm(
                generator, cfg.d_model, kind=cfg.norm), float32=True),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = self._load({"w": L._normal(
                generator, (cfg.d_model, cfg.vocab_size),
                cfg.d_model ** -0.5)})
        layers = None
        for i in range(cfg.num_layers):
            lp = self._load(_init_block(generator, cfg, kind=self.kind))
            if layers is None:
                layers = tree_map(
                    lambda t: t.new_empty((cfg.num_layers,) + t.shape), lp)
            tree_map(lambda dst, src: dst[i].copy_(src), layers, lp)
        p["layers"] = layers
        return p

    def load_params(self, params):
        """The model's parameters from a master tree (numpy arrays or
        tensors, float32, the reference's structure with stacked layers;
        ``convert.model_params_from_reference`` makes one from the
        reference's ``Model.init_params``)."""
        return self._load(params)

    def head_weight(self, params):
        return (params["embed"]["w"].T if self.cfg.tie_embeddings
                else params["lm_head"]["w"])

    def _head(self, params, x):
        """Logits of the final norm of ``x``."""
        x = L.norm_apply(params["final_norm"], x, kind=self.cfg.norm)
        return x @ self.head_weight(params)

    # ---- forward (attention-free stacks) ----
    def hidden(self, params, tokens):
        """Post-final-norm hidden states (B, S, D) of an ssm stack."""
        cfg = self.cfg
        if self.kind != "ssm":
            raise NotImplementedError(
                "the training forward of attention stacks is not ported "
                "yet: ROADMAP A11")
        x = params["embed"]["w"][tokens]
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h = L.norm_apply(lp["ln1"], x, kind=cfg.norm)
            x = x + S.ssm_fwd(lp["ssm"], h, cfg,
                              scan_dtype=self.ctx.ssm_scan_dtype)
        return L.norm_apply(params["final_norm"], x, kind=cfg.norm)

    def forward(self, params, tokens, *, last_only=False):
        """tokens: (B, S) int.  Returns logits (B, S, V), or (B, 1, V) when
        ``last_only`` (prefill: the head runs on the final position only)."""
        x = self.hidden(params, tokens)
        if last_only:
            x = x[:, -1:, :]
        return x @ self.head_weight(params)

    # ---- serving ----
    def init_cache(self, batch, cache_len, *, dtype=torch.bfloat16,
                   per_slot=False):
        """``per_slot=True`` builds a continuous-batching cache: ``pos``
        (B,) and ``slot_pos`` (B, cache_len) per layer, so every lane (a
        serving *slot*) tracks its own sequence.  Needs an attention
        stack."""
        cfg, dev = self.cfg, self.device
        if cfg.swa_window:
            cache_len = min(cache_len, cfg.swa_window)
        if per_slot and self.kind not in ("dense", "moe"):
            raise NotImplementedError(
                "per-slot caches (continuous batching) need an "
                f"attention-only stack, got family {cfg.family!r}")
        n = cfg.num_layers
        c: dict[str, Any] = {}
        if self.kind in ("dense", "moe"):
            kv = (n, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
            c["k"] = torch.zeros(kv, dtype=dtype, device=dev)
            c["v"] = torch.zeros(kv, dtype=dtype, device=dev)
            spos = (n, batch, cache_len) if per_slot else (n, cache_len)
            c["slot_pos"] = torch.full(spos, -1, dtype=torch.int32,
                                       device=dev)
        else:
            one = S.init_ssm_cache(batch, cfg, dtype=dtype, device=dev)
            c["ssm"] = {k: t[None].repeat((n,) + (1,) * t.dim())
                        for k, t in one.items()}
        pos0 = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=dev)
        return {"pos": pos0, "layers": c}

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1).  Returns (logits (B, 1, V), new_cache); the
        cache's tensors are written in place (module docstring)."""
        cfg = self.cfg
        pos = cache["pos"]
        self._check_window(pos, 1)
        x = params["embed"]["w"][tokens]
        layers = cache["layers"]
        for i in range(cfg.num_layers):
            x = _block_decode(_layer(params["layers"], i), x, cfg, self.ctx,
                              _layer(layers, i), pos, kind=self.kind)
        return self._head(params, x), {"pos": pos + 1, "layers": layers}

    def prefill(self, params, cache, tokens):
        """Fused prompt prefill: one forward over ``tokens`` (B, S) that
        also writes the prompt's K/V into the decode cache at positions
        [pos, pos+S).  Returns ``(last_logits (B, 1, V), new_cache)``;
        chunked prefill is consecutive calls.  Attention stacks only (dense
        and moe; an ssm stack prefills through the decode_step scan); ``S
        <= cache_len``."""
        cfg = self.cfg
        if self.kind not in ("dense", "moe"):
            raise NotImplementedError(
                "fused prefill supports attention-only stacks; family "
                f"{cfg.family!r} prefills via the decode_step scan")
        cache_len = cache["layers"]["k"].shape[2]
        if tokens.shape[1] > cache_len:
            raise ValueError(
                f"prefill chunk ({tokens.shape[1]} tokens) exceeds the ring "
                f"cache ({cache_len} slots); chunk the prompt")
        pos = cache["pos"]
        self._check_window(pos, tokens.shape[1])
        x = params["embed"]["w"][tokens]
        layers = cache["layers"]
        for i in range(cfg.num_layers):
            lp, lc = _layer(params["layers"], i), _layer(layers, i)
            h = L.norm_apply(lp["ln1"], x, kind=cfg.norm)
            x = x + _attn_prefill(lp["attn"], h, cfg, lc, pos)
            x = x + _ffn(lp, x, cfg, self.ctx)
        return self._head(params, x[:, -1:, :]), {
            "pos": pos + tokens.shape[1], "layers": layers}
