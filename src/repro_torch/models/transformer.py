"""The model of the port: every family of ``repro.models.transformer``,
dense attention stacks (llama3-8b), MoE attention stacks (mixtral-8x22b),
attention-free mamba-1 stacks (falcon-mamba-7b), hybrid stacks whose
blocks run attention and a mamba-1 head side by side (hymba-1.5b), an
encoder-decoder whose decoder cross-attends to the encoded frames
(whisper-tiny) and a vision-language stack whose every ``period``-th
layer cross-attends to image embeddings (llama-3.2-vision-90b), for
training (``hidden``, ``forward``, ``loss``) and serving
(``init_cache``, ``prefill_cross``, ``prefill``, ``decode_step``).

Parameters are the reference's nested-dict tree with the layers stacked on
a leading axis (``params["layers"]["attn"]["wq"]["w"]`` is ``(L, d, H·hd)``;
the vision stack's ``params["groups"]["self"]`` is ``(G, period − 1, …)``
and ``["cross"]`` ``(G, …)``; the encoder's ``params["encoder"]["layers"]``)
and live on ``Model.device``.  Two conventions share it.  *Serving*
(``init_params``/``load_params`` by default): every weight that the
reference casts to the activation dtype at each use is stored in that
dtype once; norm scales and biases, ``a_log`` and ``d_skip``, which the
reference reads in float32, stay float32.  *Training* (``master=True``):
every leaf is a float32 master value, as the reference's
``init_params`` gives it, and the forward casts each weight to the
activation dtype at each use (``layers.linear``, ``_embed_fwd``, the
head), as the reference does.  The layer stack runs as a Python loop over
the layers (the reference's ``lax.scan``).

The training forward is the reference's: ``_block_fwd`` (``_mixer_fwd``,
``_ffn_fwd``) under the ``RunCtx.remat`` policy (``torch.utils.checkpoint``,
a layer or a group of layers at a time) and the fused chunked cross-entropy
(``fused_ce_loss``).  The ssm and hybrid stacks run their recurrence
through the card kernel B9 with its backward (``kernels.ops.
selective_scan`` in grad mode: the checkpointing forward and the backward
kernel on the card, the plain versions on the CPU), so every family
trains.

Serving caches are the reference's too: ``{"pos", "layers"}`` with ring
K/V buffers ``(L, B, cache_len, Hkv, hd)`` and per-slot positions
``slot_pos``, the cross-attention K/V ``cross_k``/``cross_v`` ``(L, B,
cross_len, Hkv, hd)`` and the SSM states.  ``decode_step`` and
``prefill`` write the new K/V rows, slot positions and SSM states into
the cache's tensors in place and return a cache dict that shares them,
with ``pos`` a new tensor: a cache passed in is consumed, and the
reference's functional update becomes one write per row.  Calling a step
twice on the same cache dict rewrites the same rows with the same values.

Decode attention, self and cross, runs through
``kernels.ops.decode_attention`` (the card's flash-decoding kernel B8).
Its self-attention ``lengths`` are ``min(pos + 1, cache_len)``: the valid
slots of a lane are exactly that prefix of the ring.  With full
attention an admitted prompt replaces the lane's whole ``slot_pos`` and
decode then fills slot after slot, so the ring holds the lane's last
``min(pos + 1, cache_len)`` positions.  With a sliding window the
reference cuts the ring to ``cache_len <= swa_window`` and masks
``spos > pos − window``; every position the ring holds is then inside the
window (the oldest is ``pos − cache_len + 1 > pos − window``), so the
mask keeps the same prefix, wrapped or not, for idle lanes that keep
advancing too.  Cross-attention attends every slot of ``cross_k``
(``lengths`` = the cross length), the reference's ``attention(...,
causal=False)`` of one query.  Prefill attention stays plain PyTorch, as
it is plain jnp in the reference, with the reference's window mask.

The MoE FFN runs ``models.moe.moe_fwd`` (groups of ``RunCtx.moe_groups``),
or, for a one-token decode step, ``RunCtx.moe_step`` when it is set: the
serving hook that ``serve.engine`` points at a ``DynamicMoELayer``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.comm.communicator import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

__all__ = ["RunCtx", "Model", "tree_map", "tree_leaves", "lm_loss",
           "fused_ce_loss"]

# subtrees and leaves the reference reads in float32 at every use
_FLOAT32_PARAMS = ("ln1", "ln2", "final_norm", "a_log", "d_skip")


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Runtime context.  ``moe_groups`` splits the batch into groups whose
    tokens ``moe_fwd`` dispatches separately.  ``moe_step``, when set,
    routes the MoE FFN of a one-token decode step through ``fn(moe_params,
    h) -> out`` (both (B, 1, D)) instead of ``moe_fwd``: ``serve.engine``
    wires the per-batch routed ``DynamicMoELayer`` in here.  Prefill and
    training keep ``moe_fwd``.

    The training knobs are the reference's.  ``remat`` (``none`` | ``full``
    | ``dots``) is the recomputation policy of each layer's backward:
    ``full`` keeps only the layer's input (``torch.utils.checkpoint``),
    ``dots`` also keeps its matmul outputs (a selective-checkpoint policy
    standing in for ``jax.checkpoint_policies.checkpoint_dots``); it
    applies only where a backward will run (grad mode on and a parameter
    that requires grad).  ``remat_groups > 1`` (dividing the layer count)
    checkpoints groups of layers instead, keeping only the groups'
    boundaries.  ``cast_params_once`` casts the layer stack to the
    activation dtype once before the layers run, where the reference does
    it to halve its weight all-gathers.  The reference's ``constrain``
    and ``scan_barrier`` (sharding constraints and an XLA scheduling
    barrier) have no counterpart on one card, and ``vocab_shards`` is
    always 1 here."""

    act_dtype: torch.dtype = torch.bfloat16
    ssm_scan_dtype: torch.dtype = torch.float32
    moe_groups: int = 1
    moe_step: Callable[[Any, torch.Tensor], torch.Tensor] | None = None
    remat: str = "full"
    remat_groups: int = 1
    cast_params_once: bool = False

    def __post_init__(self):
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be none, full or dots, got "
                             f"{self.remat!r}")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in ``jax.tree.leaves``' order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _layer(tree, *index):
    return tree_map(lambda t: t[index], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree as views (``unbind``: the
    backward writes each leaf's gradient once, where indexing layer by
    layer would add ``n`` full-size gradients)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda t, i=i: t[i], parts) for i in range(n)]


# the ops whose outputs ``remat="dots"`` keeps (jax's checkpoint_dots)
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under the recomputation ``policy`` (``RunCtx.remat``)."""
    if policy == "none":
        return fn
    kw = {"use_reentrant": False}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    return lambda *args: ckpt.checkpoint(fn, *args, **kw)




# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _init_block(generator, cfg, *, kind: str):
    """kind: dense | moe | ssm | hybrid | encdec_dec | enc | cross"""
    p: dict[str, Any] = {"ln1": L.init_norm(generator, cfg.d_model,
                                            kind=cfg.norm)}
    if kind == "ssm":
        p["ssm"] = S.init_ssm(generator, cfg)
        return p
    if kind not in ("dense", "moe", "hybrid", "encdec_dec", "enc", "cross"):
        raise ValueError(kind)
    p["attn"] = L.init_attention(generator, cfg)
    p["ln2"] = L.init_norm(generator, cfg.d_model, kind=cfg.norm)
    if kind == "hybrid":
        p["ssm"] = S.init_ssm(generator, cfg)
    if kind == "moe":
        p["moe"] = M.init_moe(generator, cfg)
        if cfg.dense_residual:
            p["res_mlp"] = L.init_mlp(generator, cfg.d_model,
                                      cfg.residual_d_ff, act=cfg.act)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, act=cfg.act)
    if kind == "encdec_dec":
        p["ln_cross"] = L.init_norm(generator, cfg.d_model, kind=cfg.norm)
        p["cross"] = L.init_attention(generator, cfg)
    return p


def _mixer_fwd(p, h, cfg, ctx, *, kind, kv_ctx=None):
    """The token-mixing half of a block (h already normed)."""
    if kind == "ssm":
        return S.ssm_fwd(p["ssm"], h, cfg, scan_dtype=ctx.ssm_scan_dtype)
    if kind == "hybrid":
        a = L.attention_fwd(p["attn"], h, cfg, causal=True,
                            window=cfg.swa_window)
        s = S.ssm_fwd(p["ssm"], h, cfg, scan_dtype=ctx.ssm_scan_dtype)
        return 0.5 * (a + s)
    if kind == "cross":
        return L.attention_fwd(p["attn"], h, cfg, kv_x=kv_ctx, causal=False,
                               use_rope=False)
    return L.attention_fwd(p["attn"], h, cfg, causal=kind != "enc",
                           window=cfg.swa_window, use_rope=kind != "enc")


def _ffn_fwd(p, x, cfg, ctx, *, decode=False):
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


def _block_fwd(p, x, cfg, ctx, *, kind, kv_ctx=None):
    h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
    x = x + _mixer_fwd(p, h, cfg, ctx, kind=kind, kv_ctx=kv_ctx)
    if kind == "encdec_dec":
        hc = L.norm_apply(p["ln_cross"], x, kind=cfg.norm)
        x = x + L.attention_fwd(p["cross"], hc, cfg, kv_x=kv_ctx,
                                causal=False, use_rope=False)
    if kind != "ssm":
        x = x + _ffn_fwd(p, x, cfg, ctx)
    return x


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
    The attention reads the valid prefix ``min(pos + 1, cache_len)`` of
    each lane, which is the reference's mask, sliding window included
    (module docstring)."""
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
    ring cache, then attends over every slot the reference's mask keeps
    (written, at or before the query, inside the sliding window), as S
    successive ``_attn_decode`` calls would (float32 einsum, -1e30
    masking, a softmax over the whole cache), as long as the chunk fits the
    ring (S <= cache_len).  A chunk that wraps the ring overwrites slots
    of its own earlier positions before any query reads them, as the
    reference's write-then-mask does.  ``pos`` 0-d for a shared-position
    cache, (B,) for a per-slot one."""
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
    if cfg.swa_window:
        valid = valid & (sp[:, None, :] > qp[..., None] - cfg.swa_window)
    qg = q.reshape(b, s_len, hkv, h // hkv, hd)
    logits = torch.einsum("bshgd,blhd->bhgsl", qg.float(),
                          ck.float()) * (hd ** -0.5)
    logits = torch.where(valid[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgsl,blhd->bshgd", w, cv.float())
    out = out.reshape(b, s_len, h * hd).to(x.dtype)
    return L.linear(p["wo"], out)


def _cross_decode(p, x, cfg, cache):
    """x: (B, 1, D); one query per lane against the cached encoder or
    image K/V, every slot attended: B8 with ``lengths`` = the cross
    length."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    ck, cv = cache["cross_k"], cache["cross_v"]
    q = L.linear(p["wq"], x).reshape(b, h, hd)
    lengths = torch.full((b,), ck.shape[1], dtype=torch.int32,
                         device=x.device)
    out = ops.decode_attention(q, ck, cv, lengths)
    return L.linear(p["wo"], out.reshape(b, 1, h * hd).to(x.dtype))


def _block_decode(p, x, cfg, ctx, cache, pos, *, kind):
    """One layer of one decode step; writes the layer's cache in place."""
    h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
    if kind in ("ssm", "hybrid"):
        s_out, new = S.ssm_decode_step(p["ssm"], h, cache["ssm"], cfg)
        cache["ssm"]["h"].copy_(new["h"])
        cache["ssm"]["conv"].copy_(new["conv"])
        if kind == "ssm":
            return x + s_out
        a = _attn_decode(p["attn"], h, cfg, cache, pos)
        x = x + 0.5 * (a + s_out)
    elif kind == "cross":
        x = x + _cross_decode(p["attn"], h, cfg, cache)
    else:
        x = x + _attn_decode(p["attn"], h, cfg, cache, pos)
        if kind == "encdec_dec":
            hc = L.norm_apply(p["ln_cross"], x, kind=cfg.norm)
            x = x + _cross_decode(p["cross"], hc, cfg, cache)
    return x + _ffn_fwd(p, x, cfg, ctx, decode=True)


# ---------------------------------------------------------------------------
# embedding / loss
# ---------------------------------------------------------------------------

class _CastEmbed(torch.autograd.Function):
    """The reference's gather from the table cast to the activation dtype
    (``w.astype(act_dtype)[tokens]``), with its backward: the cotangent
    rows of the tokens added into a zero table of the activation dtype in
    ascending position order, one rounding per add (``kref.ordered_add``,
    the sequential add bit for bit on every device, as the reference's
    scatter-add), then cast once to the table's dtype.  Casting after the
    gather (``F.embedding(...).to(act_dtype)``) would add the same rows in
    the table's dtype: another, more accurate, function."""

    @staticmethod
    def forward(ctx, w, tokens, dtype):
        ctx.save_for_backward(tokens)
        ctx.table = (tuple(w.shape), w.dtype)
        return F.embedding(tokens, w).to(dtype)

    @staticmethod
    def backward(ctx, grad):
        tokens, = ctx.saved_tensors
        shape, dtype = ctx.table
        table = grad.new_zeros(shape)
        kref.ordered_add(table, tokens.reshape(-1),
                         grad.reshape(-1, shape[1]))
        return table.to(dtype), None, None


def _embed_fwd(p, tokens, cfg, ctx):
    """The reference's ``replicate`` gather, rows cast to the activation
    dtype.  Its ``onehot_psum`` path serves a vocabulary sharded over a
    model axis (``vocab_shards > 1``); on one card the table is whole and
    the reference takes this path too.  Where a backward runs through a
    table of another dtype than the activations (float32 master weights,
    bf16 activations) the gather is ``_CastEmbed``; otherwise
    ``F.embedding``, not indexing: its backward adds a token's rows in the
    same order every run, on the CPU and on the card, where indexing's
    (``index_put_``) does not on the CPU, and a resumed run must repeat
    the uninterrupted one."""
    w = p["w"]
    if (w.dtype != ctx.act_dtype and w.requires_grad
            and torch.is_grad_enabled()):
        return _CastEmbed.apply(w, tokens, ctx.act_dtype)
    return F.embedding(tokens, w).to(ctx.act_dtype)


def lm_loss(logits, labels, mask=None):
    """Mean cross-entropy of (B, S, V) logits in float32 (the label's
    logit gathered: the reference's one-hot contraction adds zeros to
    it)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _ce_chunk(xc, head, lc):
    lf = (xc @ head.to(xc.dtype)).float()                 # (B, C, V)
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, lc.long()[..., None])[..., 0]
    return (lse - ll).sum()


def fused_ce_loss(x, head, labels, *, chunk=512):
    """Memory-fused cross-entropy: the head matmul and the log-softmax run
    a sequence chunk at a time, each under checkpoint where a backward
    will run, so the (B, S, V) logits never exist whole.  x: (B, S, D)
    post-norm hidden; the chunks' sums are added in order from 0."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the length {s}")
    body = _ce_chunk
    if torch.is_grad_enabled() and (x.requires_grad or head.requires_grad):
        body = _remat(_ce_chunk, "full")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + body(x[:, sl], head, labels[:, sl])
    return total / (b * s)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

_KINDS = {"dense": "dense", "moe": "moe", "ssm": "ssm", "hybrid": "hybrid",
          "encdec": "encdec_dec", "vlm": "dense"}


class Model:
    """Family-dispatching model wrapper around the pure functions above,
    on one device (``device=None`` means ``"cuda"``; without a card only
    ``device="cpu"`` runs)."""

    def __init__(self, cfg, ctx: RunCtx | None = None, *, device=None):
        self.cfg = cfg
        self.ctx = ctx or RunCtx()
        self.kind = _KINDS[cfg.family]
        self.device = resolve_device(device)

    @property
    def groups(self) -> int:
        """Cross-attention groups of a vision stack (0 otherwise): each is
        ``cross_attn_period − 1`` self-attention layers and one cross."""
        cfg = self.cfg
        if cfg.is_vlm and cfg.cross_attn_period:
            return cfg.num_layers // cfg.cross_attn_period
        return 0

    # ---- parameters ----
    def _load(self, tree, *, float32=False):
        """Place a (numpy or tensor) parameter tree on the device, in the
        activation dtype but for the float32 leaves (all of them when
        ``float32``)."""
        if isinstance(tree, dict):
            return {k: self._load(v, float32=float32 or k in _FLOAT32_PARAMS)
                    for k, v in tree.items()}
        dtype = torch.float32 if float32 else self.ctx.act_dtype
        return torch.as_tensor(tree).to(device=self.device, dtype=dtype)

    def _stack(self, generator, kind: str, lead: tuple, master: bool):
        """``prod(lead)`` blocks of ``kind`` drawn one after another and
        stored at once, a block at a time, in a tree stacked on ``lead``."""
        n = math.prod(lead)
        stack = None
        for i in range(n):
            bp = self._load(_init_block(generator, self.cfg, kind=kind),
                            float32=master)
            if stack is None:
                stack = tree_map(lambda t: t.new_empty((n,) + t.shape), bp)
            tree_map(lambda dst, src: dst[i].copy_(src), stack, bp)
        return tree_map(lambda t: t.view(lead + t.shape[1:]), stack)

    def init_params(self, generator: torch.Generator, *, master=False):
        """Random parameters from ``generator`` (a ``torch.Generator`` on
        ``self.device``), drawn as the reference draws its master values
        (normal × fan-in^-0.5, embeddings × 0.02; the numbers differ from
        ``jax.random``'s) and stored at once, a layer at a time, in the
        activation dtype, or kept float32 with ``master=True`` (training:
        module docstring)."""
        if resolve_device(generator.device) != self.device:
            raise ValueError(f"the generator lies on {generator.device}, "
                             f"the model on {self.device}")
        cfg = self.cfg
        load = functools.partial(self._load, float32=master)
        p: dict[str, Any] = {
            "embed": load({"w": L._normal(
                generator, (cfg.vocab_size, cfg.d_model), 0.02)}),
            "final_norm": self._load(L.init_norm(
                generator, cfg.d_model, kind=cfg.norm), float32=True),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = load({"w": L._normal(
                generator, (cfg.d_model, cfg.vocab_size),
                cfg.d_model ** -0.5)})
        if self.groups:
            g, per = self.groups, cfg.cross_attn_period
            p["groups"] = {
                "self": self._stack(generator, "dense", (g, per - 1), master),
                "cross": self._stack(generator, "cross", (g,), master)}
        else:
            p["layers"] = self._stack(generator, self.kind,
                                      (cfg.num_layers,), master)
        if cfg.is_encdec:
            p["encoder"] = {
                "layers": self._stack(generator, "enc",
                                      (cfg.encoder_layers,), master),
                "norm": self._load(L.init_norm(generator, cfg.d_model,
                                               kind=cfg.norm), float32=True)}
        return p

    def load_params(self, params, *, master=False):
        """The model's parameters from a master tree (numpy arrays or
        tensors, float32, the reference's structure with stacked layers;
        ``convert.model_params_from_reference`` makes one from the
        reference's ``Model.init_params``): stored for serving, or kept
        float32 with ``master=True`` (training)."""
        return self._load(params, float32=master)

    def head_weight(self, params):
        return (params["embed"]["w"].T if self.cfg.tie_embeddings
                else params["lm_head"]["w"])

    def _head(self, params, x):
        """Logits of the final norm of ``x``."""
        x = L.norm_apply(params["final_norm"], x, kind=self.cfg.norm)
        return x @ self.head_weight(params).to(x.dtype)

    # ---- training forward ----
    def _policy(self, params) -> str:
        """``RunCtx.remat`` where a backward will run, else ``none``."""
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves(params))
        return self.ctx.remat if needs_grad else "none"

    def _context(self, params, extra):
        """The cross-attention context: the encoded frames (encdec) or
        the image embeddings (vlm) of ``extra``; None for other stacks."""
        if self.cfg.is_encdec:
            return self._encode(params["encoder"], extra["frames"])
        if self.cfg.is_vlm:
            return extra["image_embeds"].to(self.ctx.act_dtype)
        return None

    def hidden(self, params, tokens, *, extra=None):
        """Post-final-norm hidden states (B, S, D).  ``extra``:
        ``{"frames": (B, T, D)}`` (encdec) or ``{"image_embeds": (B, T,
        D)}`` (vlm)."""
        cfg, ctx = self.cfg, self.ctx
        x = _embed_fwd(params["embed"], tokens, cfg, ctx)
        kv_ctx = self._context(params, extra)
        policy = self._policy(params)
        if self.groups:
            return L.norm_apply(params["final_norm"], self._vlm_stack(
                params["groups"], x, kv_ctx, policy), kind=cfg.norm)
        stack = params["layers"]
        if ctx.cast_params_once:
            stack = tree_map(lambda a: a.to(ctx.act_dtype)
                             if a.is_floating_point() else a, stack)
        layers = _unstack(stack, cfg.num_layers)

        def run(lps, x):
            for lp in lps:
                x = _block_fwd(lp, x, cfg, ctx, kind=self.kind,
                               kv_ctx=kv_ctx)
            return x

        groups = ctx.remat_groups
        if groups > 1 and cfg.num_layers % groups == 0:
            per = cfg.num_layers // groups
            for gi in range(groups):
                x = _remat(functools.partial(
                    run, layers[gi * per:(gi + 1) * per]), policy)(x)
        else:
            for lp in layers:
                x = _remat(functools.partial(run, [lp]), policy)(x)
        return L.norm_apply(params["final_norm"], x, kind=cfg.norm)

    def _vlm_stack(self, groups_p, x, kv_ctx, policy):
        """Each group's self-attention layers, then its cross layer, each
        under the remat policy (the reference's ``_vlm_stack``)."""
        cfg, ctx = self.cfg, self.ctx
        per = cfg.cross_attn_period - 1
        for gp in _unstack(groups_p, self.groups):
            for lp in _unstack(gp["self"], per):
                x = _remat(functools.partial(
                    _block_fwd, lp, cfg=cfg, ctx=ctx, kind="dense"),
                    policy)(x)
            x = _remat(functools.partial(
                _block_fwd, gp["cross"], cfg=cfg, ctx=ctx, kind="cross",
                kv_ctx=kv_ctx), policy)(x)
        return x

    def _encode(self, enc_p, frames):
        """The encoder over the frame embeddings (non-causal, no RoPE),
        then its norm."""
        cfg, ctx = self.cfg, self.ctx
        x = frames.to(ctx.act_dtype)
        policy = self._policy(enc_p)
        for lp in _unstack(enc_p["layers"], cfg.encoder_layers):
            x = _remat(functools.partial(
                _block_fwd, lp, cfg=cfg, ctx=ctx, kind="enc"), policy)(x)
        return L.norm_apply(enc_p["norm"], x, kind=cfg.norm)

    def forward(self, params, tokens, *, extra=None, last_only=False):
        """tokens: (B, S) int; ``extra`` as ``hidden``'s.  Returns logits
        (B, S, V), or (B, 1, V) when ``last_only`` (prefill: the head runs
        on the final position only)."""
        x = self.hidden(params, tokens, extra=extra)
        if last_only:
            x = x[:, -1:, :]
        return x @ self.head_weight(params).to(x.dtype)

    def loss(self, params, tokens, labels, *, extra=None, chunk=512):
        """Fused chunked cross-entropy (never materializes full logits)."""
        x = self.hidden(params, tokens, extra=extra)
        return fused_ce_loss(x, self.head_weight(params), labels,
                             chunk=chunk)

    # ---- serving ----
    def _layer_cache(self, lead, kind, batch, cache_len, cross_len, dtype,
                     per_slot):
        """The cache of ``kind``'s layers, stacked on ``lead``."""
        cfg, dev = self.cfg, self.device
        c: dict[str, Any] = {}
        kv = lead + (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        if kind in ("dense", "moe", "hybrid", "encdec_dec"):
            c["k"] = torch.zeros(kv, dtype=dtype, device=dev)
            c["v"] = torch.zeros(kv, dtype=dtype, device=dev)
            spos = lead + ((batch, cache_len) if per_slot else (cache_len,))
            c["slot_pos"] = torch.full(spos, -1, dtype=torch.int32,
                                       device=dev)
        if kind in ("encdec_dec", "cross"):
            xkv = lead + (batch, cross_len, cfg.num_kv_heads, cfg.head_dim)
            c["cross_k"] = torch.zeros(xkv, dtype=dtype, device=dev)
            c["cross_v"] = torch.zeros(xkv, dtype=dtype, device=dev)
        if kind in ("ssm", "hybrid"):
            one = S.init_ssm_cache(batch, cfg, dtype=dtype, device=dev)
            c["ssm"] = {k: t.expand(lead + t.shape).clone()
                        for k, t in one.items()}
        return c

    def init_cache(self, batch, cache_len, *, cross_len=0,
                   dtype=torch.bfloat16, per_slot=False):
        """``cross_len``: the slots of the cross-attention K/V (encdec,
        vlm), which ``prefill_cross`` fills.  ``per_slot=True`` builds a
        continuous-batching cache: ``pos`` (B,) and ``slot_pos`` (B,
        cache_len) per layer, so every lane (a serving *slot*) tracks its
        own sequence.  Needs an attention stack (dense, moe)."""
        cfg = self.cfg
        if cfg.swa_window:
            cache_len = min(cache_len, cfg.swa_window)
        if per_slot and self.kind not in ("dense", "moe"):
            raise NotImplementedError(
                "per-slot caches (continuous batching) need an "
                f"attention-only stack, got family {cfg.family!r}")
        make = functools.partial(self._layer_cache, batch=batch,
                                 cache_len=cache_len, cross_len=cross_len,
                                 dtype=dtype, per_slot=per_slot)
        if self.groups:
            g, per = self.groups, cfg.cross_attn_period
            layers = {"self": make((g, per - 1), "dense"),
                      "cross": make((g,), "cross")}
        else:
            layers = make((cfg.num_layers,), self.kind)
        pos0 = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=self.device)
        return {"pos": pos0, "layers": layers}

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1).  Returns (logits (B, 1, V), new_cache); the
        cache's tensors are written in place (module docstring)."""
        cfg, ctx = self.cfg, self.ctx
        pos = cache["pos"]
        x = _embed_fwd(params["embed"], tokens, cfg, ctx)
        layers = cache["layers"]
        if self.groups:
            gp, gc = params["groups"], layers
            for g in range(self.groups):
                for j in range(cfg.cross_attn_period - 1):
                    x = _block_decode(_layer(gp["self"], g, j), x, cfg, ctx,
                                      _layer(gc["self"], g, j), pos,
                                      kind="dense")
                x = _block_decode(_layer(gp["cross"], g), x, cfg, ctx,
                                  _layer(gc["cross"], g), pos, kind="cross")
        else:
            for i in range(cfg.num_layers):
                x = _block_decode(_layer(params["layers"], i), x, cfg, ctx,
                                  _layer(layers, i), pos, kind=self.kind)
        return self._head(params, x), {"pos": pos + 1, "layers": layers}

    def prefill(self, params, cache, tokens):
        """Fused prompt prefill: one forward over ``tokens`` (B, S) that
        also writes the prompt's K/V into the decode cache at positions
        [pos, pos+S).  Returns ``(last_logits (B, 1, V), new_cache)``;
        chunked prefill is consecutive calls.  Attention stacks only (dense
        and moe; the other families prefill through the decode_step scan,
        ``launch.serve.prefill_into_cache``); ``S <= cache_len``."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                "fused prefill supports attention-only stacks; family "
                f"{cfg.family!r} prefills via the decode_step scan")
        cache_len = cache["layers"]["k"].shape[2]
        if tokens.shape[1] > cache_len:
            raise ValueError(
                f"prefill chunk ({tokens.shape[1]} tokens) exceeds the ring "
                f"cache ({cache_len} slots); chunk the prompt")
        pos = cache["pos"]
        x = _embed_fwd(params["embed"], tokens, cfg, self.ctx)
        layers = cache["layers"]
        for i in range(cfg.num_layers):
            lp, lc = _layer(params["layers"], i), _layer(layers, i)
            h = L.norm_apply(lp["ln1"], x, kind=cfg.norm)
            x = x + _attn_prefill(lp["attn"], h, cfg, lc, pos)
            x = x + _ffn_fwd(lp, x, cfg, self.ctx)
        return self._head(params, x[:, -1:, :]), {
            "pos": pos + tokens.shape[1], "layers": layers}

    def prefill_cross(self, params, cache, context):
        """Fill the cross-attention K/V from ``context`` (B, T, D): the
        frame embeddings, encoded first (encdec), or the image embeddings
        (vlm).  The cache's ``cross_k``/``cross_v`` become new tensors of
        T slots in the cache's dtype (as the reference replaces them);
        returns the cache.  Other families' caches come back as they
        are."""
        cfg = self.cfg
        if cfg.is_encdec:
            kv_src = self._encode(params["encoder"], context)
            attn, n = params["layers"]["cross"], cfg.num_layers
            lc = cache["layers"]
        elif cfg.is_vlm:
            kv_src = context.to(self.ctx.act_dtype)
            attn, n = params["groups"]["cross"]["attn"], self.groups
            lc = cache["layers"]["cross"]
        else:
            return cache
        b = kv_src.shape[0]
        shape = (b, kv_src.shape[1], cfg.num_kv_heads, cfg.head_dim)
        for key, w in (("cross_k", "wk"), ("cross_v", "wv")):
            lc[key] = torch.stack([
                L.linear(_layer(attn[w], i), kv_src).reshape(shape)
                for i in range(n)]).to(lc[key].dtype)
        return cache
