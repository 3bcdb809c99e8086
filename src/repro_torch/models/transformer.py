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

Serving over a model axis (``RunCtx.model``, ``launch.serve --mesh DxM``)
keeps the reference's placement (``runtime.sharding.serve_rules`` for the
weights, ``cache_specs`` for the caches, ``RunCtx.gather`` holding both):
``init_cache`` gives this rank's block of every cache leaf, its lanes of
the batch (``Gather.lanes``) and, where the model axis divides the ring
(or the cross length), its ``S/M`` slots of it (the flash-decoding
layout), else the whole ring.  A step's caller passes this rank's lanes of
the tokens (and the context of ``prefill_cross``); ``pos`` stays whole.
Each rank projects its ``H/M`` query heads (``layers.serve_attention``);
the query and the new K/V rows are gathered over the heads, the rank that
owns a position's ring slot (``pos % cache_len``) writes its row, each rank
attends its own slots for every head (B8's partial entry,
``ops.decode_attention_partial``; a fused prefill's masked einsum with its
log-sum-exp), the ranks' partials are merged (``ModelAxis.merge``), and
``wo``'s rows give a partial sum that is reduced.  On a whole ring (and
at ``M = 1``, where the step is ``--mesh local``'s bit for bit) B8 runs
every head over it and each rank keeps its heads.  The MLP, the experts,
the mamba channels (``ssm_decode_step(tp=)``), the embedding and the
vocabulary-parallel head are the training split's; the logits are
gathered over the model group, so every rank of it samples the same
token.
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
    it to halve its weight all-gathers (under ``gather``, each layer's
    shards are cast before they are gathered).

    ``gather`` (``runtime.sharding.make_gather``, FSDP over the data axis)
    stands where the reference's ``constrain`` stands: the parameters are
    this rank's shards (``init_params`` keeps them), and
    ``gather(tree, keys, dtype)`` makes a subtree at ``keys`` of the
    parameter tree whole where it is computed, inside each remat region
    (a layer's weights, gathered again when its forward is recomputed in
    the backward), and the embedding, the head and the final norm once a
    call of ``hidden``/``forward``/``loss``.  The reference's
    ``scan_barrier`` (an XLA scheduling barrier) has no counterpart.

    ``model`` (``runtime.model_axis.ModelAxis``, ``launch.train --mesh
    DxM`` and ``launch.serve --mesh DxM``) is the model-axis hook: the
    parameters are this rank's parts over both axes, ``gather`` makes them
    whole over the data group only, and the layers compute tensor- and
    expert-parallel with the parts (``layers.attention_fwd``, ``mlp_fwd``,
    ``ssm.ssm_fwd``, ``moe.moe_fwd``, the vocab-parallel embedding and
    cross-entropy in training; the serving steps as the module docstring
    says, the caches placed by ``gather``'s rules).  ``vocab_shards`` is
    the reference's: above 1, with a vocabulary that it divides and
    ``embed_gather`` not ``replicate``, the embedding is the reference's
    ``onehot_psum`` over the vocabulary split on the model axis
    (``_VocabEmbed``), in training and in serving."""

    act_dtype: torch.dtype = torch.bfloat16
    ssm_scan_dtype: torch.dtype = torch.float32
    moe_groups: int = 1
    moe_step: Callable[[Any, torch.Tensor], torch.Tensor] | None = None
    remat: str = "full"
    remat_groups: int = 1
    cast_params_once: bool = False
    gather: Callable[..., Any] | None = None
    model: Any = None
    vocab_shards: int = 1

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
    tp = ctx.model
    if kind == "ssm":
        return S.ssm_fwd(p["ssm"], h, cfg, scan_dtype=ctx.ssm_scan_dtype,
                         tp=tp)
    if kind == "hybrid":
        a = L.attention_fwd(p["attn"], h, cfg, causal=True,
                            window=cfg.swa_window, tp=tp)
        s = S.ssm_fwd(p["ssm"], h, cfg, scan_dtype=ctx.ssm_scan_dtype,
                      tp=tp)
        return 0.5 * (a + s)
    if kind == "cross":
        return L.attention_fwd(p["attn"], h, cfg, kv_x=kv_ctx, causal=False,
                               use_rope=False, tp=tp)
    return L.attention_fwd(p["attn"], h, cfg, causal=kind != "enc",
                           window=cfg.swa_window, use_rope=kind != "enc",
                           tp=tp)


def _mlp_tp(ctx, f: int):
    """The model axis for an MLP of width ``f``: where it splits ``f``
    (``w1``/``w3`` by columns, ``w2`` by rows), else None (replicated)."""
    tp = ctx.model
    return tp if tp is not None and tp.splits(f) else None


def _ffn_fwd(p, x, cfg, ctx, *, decode=False):
    h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
    if "moe" not in p:
        return L.mlp_fwd(p["mlp"], h, act=cfg.act,
                         tp=_mlp_tp(ctx, cfg.d_ff))
    b, s_len, d = h.shape
    if ctx.moe_step is not None and decode:
        # serving decode: the comm-scheduled per-step MoE exchange.  The
        # reference takes it for any one-token step, a prefill chunk of
        # one token too, where the hook's batch is not the engine's lanes
        out = ctx.moe_step(p["moe"], h)
    else:
        g = min(ctx.moe_groups, b)
        out = M.moe_fwd(p["moe"], h.reshape(g, (b // g) * s_len, d),
                        cfg, tp=ctx.model).reshape(b, s_len, d)
    if cfg.dense_residual:
        out = out + L.mlp_fwd(p["res_mlp"], h, act=cfg.act,
                              tp=_mlp_tp(ctx, cfg.residual_d_ff))
    return out


def _block_fwd(p, x, cfg, ctx, *, kind, kv_ctx=None):
    h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
    x = x + _mixer_fwd(p, h, cfg, ctx, kind=kind, kv_ctx=kv_ctx)
    if kind == "encdec_dec":
        hc = L.norm_apply(p["ln_cross"], x, kind=cfg.norm)
        x = x + L.attention_fwd(p["cross"], hc, cfg, kv_x=kv_ctx,
                                causal=False, use_rope=False, tp=ctx.model)
    if kind != "ssm":
        x = x + _ffn_fwd(p, x, cfg, ctx)
    return x


def _qkv(p, x, cfg, h, hkv):
    """The query and the new K/V rows of ``h`` query and ``hkv`` KV
    heads."""
    b, s_len = x.shape[:2]
    hd = cfg.head_dim
    return (L.linear(p["wq"], x).reshape(b, s_len, h, hd),
            L.linear(p["wk"], x).reshape(b, s_len, hkv, hd),
            L.linear(p["wv"], x).reshape(b, s_len, hkv, hd))


@dataclasses.dataclass(frozen=True)
class _Place:
    """Where a serving step runs on a model axis: ``tp`` the axis,
    ``lanes`` this rank's lanes of a per-slot ``pos`` (None: all of
    them), ``seq`` and ``xseq`` the ``(first slot, whole length)`` of this
    rank's block of a sequence-split self-attention ring and
    cross-attention cache (None: it holds the whole)."""

    tp: Any
    lanes: slice | None = None
    seq: tuple | None = None
    xseq: tuple | None = None


def _split_heads(p, x, cfg, tp):
    """``(p, x, heads, kv_heads, row_split)`` of the attention block: the
    leaves and the head counts a rank projects (``layers.serve_attention``)
    without a model axis, with it, and ``x`` entered."""
    if tp is None:
        return p, x, cfg.num_heads, cfg.num_kv_heads, False
    p, h, hkv, row_split = L.serve_attention(p, cfg, tp)
    return p, tp.enter(x), h, hkv, row_split


def _all_heads(tp, cfg, *ts):
    """The query (and the new K/V rows) ``(B, S, heads, hd)`` of this
    rank's heads made whole over the heads, one gather for all those that
    are split: every rank attends every head over its own slots."""
    whole = (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)
    split = [i for i, t in enumerate(ts) if t.shape[2] < whole[i]]
    out = list(ts)
    for i, t in zip(split, tp.gather_all([ts[i] for i in split],
                                         [2] * len(split))):
        out[i] = t
    return out


def _own_heads(out, cfg, tp, h):
    """This rank's ``h`` heads of an ``(..., H, D)`` attention output."""
    return out if h == cfg.num_heads else out[..., tp.block(cfg.num_heads), :]


def _out_proj(p, out, x, h, hd, tp, row_split):
    """``wo`` of this rank's heads' outputs ``(B, S, h, hd)``, reduced over
    the model axis where its rows are split."""
    b, s_len = out.shape[:2]
    y = L.linear(p["wo"], out.reshape(b, s_len, h * hd).to(x.dtype))
    return tp.reduce(y) if row_split else y


def _ring_row(buf, lane, ls, mine, rows):
    """Write ``rows`` into ``buf`` at lanes ``lane`` (None: the shared
    position's row of every lane, ``buf``'s dim 1 for a K/V ring, dim 0
    for ``slot_pos``) and local slot ``ls`` where ``mine``, the old row
    elsewhere: one position a lane, so no two writes meet."""
    if lane is None:
        dim = 1 if buf.dim() > 1 else 0
        ls = ls.reshape(1)
        old = buf.index_select(dim, ls)
        buf.index_copy_(dim, ls, torch.where(mine, rows.to(buf.dtype), old))
    else:
        shape = (-1,) + (1,) * (rows.dim() - 1)
        buf[lane, ls] = torch.where(mine.reshape(shape), rows.to(buf.dtype),
                                    buf[lane, ls])


def _attn_decode(p, x, cfg, cache, pos, place=None):
    """x: (B, 1, D); one token per lane into the ring K/V cache.

    ``pos`` 0-d: every lane at the same position, ``slot_pos``
    ``(cache_len,)`` shared.  ``pos`` (B,): lanes at their own positions
    with ``slot_pos`` ``(B, cache_len)`` (``init_cache(per_slot=True)``).
    The attention reads the valid prefix ``min(pos + 1, cache_len)`` of
    each lane, which is the reference's mask, sliding window included
    (module docstring).

    ``place`` (a ``_Place``, serving over a model axis): ``x`` holds this
    rank's lanes, ``pos`` and ``slot_pos`` every lane.  On a
    sequence-split ring the owner of the new token's slot writes it, and
    each rank runs B8's partial entry on its slots, merged over the
    axis."""
    tp = None if place is None else place.tp
    b = x.shape[0]
    hd, h_all = cfg.head_dim, cfg.num_heads
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    p, x, h, hkv, row_split = _split_heads(p, x, cfg, tp)
    all_pos = pos
    if pos.dim() == 1 and place is not None and place.lanes is not None:
        pos = pos[place.lanes]
    q, k, v = _qkv(p, x, cfg, h, hkv)
    positions = pos[None, None] if pos.dim() == 0 else pos[:, None]
    q = L.rope(q, positions, theta=cfg.rope_theta)
    k = L.rope(k, positions, theta=cfg.rope_theta)
    if tp is not None:
        q, k, v = _all_heads(tp, cfg, q, k, v)
    lo, whole = (0, ck.shape[1]) if place is None or place.seq is None \
        else place.seq
    n = ck.shape[1]

    slot = (pos % whole).long()         # ring slot (== pos before a wrap)
    if place is not None and place.seq is not None:
        # a sequence-split ring: the owner of the slot writes the row
        ls = slot - lo
        mine = (ls >= 0) & (ls < n)
        ls = ls.clamp(0, n - 1)
        lane = None if pos.dim() == 0 else torch.arange(b, device=x.device)
        _ring_row(ck, lane, ls, mine, k[:, 0] if lane is not None else k)
        _ring_row(cv, lane, ls, mine, v[:, 0] if lane is not None else v)
        aslot = (all_pos % whole).long() - lo
        amine = (aslot >= 0) & (aslot < n)
        alane = None if all_pos.dim() == 0 else torch.arange(
            all_pos.shape[0], device=x.device)
        _ring_row(spos, alane, aslot.clamp(0, n - 1), amine,
                  all_pos.to(torch.int32))
        lengths = torch.clamp(torch.clamp(pos + 1, max=whole) - lo, 0, n)
        lengths = lengths.to(torch.int32).expand(b).contiguous()
        part, lse = ops.decode_attention_partial(
            q.reshape(b, h_all, hd), ck, cv, lengths)
        out, _ = tp.merge(part, lse)
    else:
        if pos.dim() == 0:
            ck.index_copy_(1, slot.reshape(1), k.to(ck.dtype))
            cv.index_copy_(1, slot.reshape(1), v.to(cv.dtype))
            spos.index_copy_(0, slot.reshape(1),
                             pos.reshape(1).to(torch.int32))
            lengths = torch.clamp(pos + 1, max=n).to(torch.int32)
            lengths = lengths.expand(b).contiguous()
        else:
            lane = torch.arange(b, device=x.device)
            ck[lane, slot] = k[:, 0].to(ck.dtype)
            cv[lane, slot] = v[:, 0].to(cv.dtype)
            alane = torch.arange(all_pos.shape[0], device=x.device)
            spos[alane, (all_pos % n).long()] = all_pos.to(torch.int32)
            lengths = torch.clamp(pos + 1, max=n).to(torch.int32)
        out = ops.decode_attention(q.reshape(b, q.shape[2], hd), ck, cv,
                                   lengths)
    if tp is None:
        return L.linear(p["wo"], out.reshape(b, 1, h * hd).to(x.dtype))
    out = _own_heads(out.reshape(b, 1, h_all, hd), cfg, tp, h)
    return _out_proj(p, out, x, h, hd, tp, row_split)


def _attn_prefill(p, x, cfg, cache, pos, place=None):
    """x: (B, S, D) prompt chunk; writes positions [pos, pos+S) into the
    ring cache, then attends over every slot the reference's mask keeps
    (written, at or before the query, inside the sliding window), as S
    successive ``_attn_decode`` calls would (float32 einsum, -1e30
    masking, a softmax over the whole cache), as long as the chunk fits the
    ring (S <= cache_len).  A chunk that wraps the ring overwrites slots
    of its own earlier positions before any query reads them, as the
    reference's write-then-mask does.  ``pos`` 0-d for a shared-position
    cache, (B,) for a per-slot one.

    ``place`` as ``_attn_decode``'s.  On a sequence-split ring each rank
    writes the chunk's rows that land in its slots (each local slot takes
    the chunk's row of its position, if any) and attends its slots with
    the log-sum-exp of its logits (-inf masking: a query none of whose
    slots lie here adds nothing), merged over the axis."""
    tp = None if place is None else place.tp
    b, s_len = x.shape[:2]
    hkv_all, hd, h_all = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    p, x, h, hkv, row_split = _split_heads(p, x, cfg, tp)
    per_slot = pos.dim() == 1
    all_pos = pos
    lanes = None if place is None else place.lanes
    if per_slot and lanes is not None:
        pos = pos[lanes]
    q, k, v = _qkv(p, x, cfg, h, hkv)
    offs = torch.arange(s_len, device=x.device)
    qpos = pos[:, None] + offs[None] if per_slot else pos + offs
    qp = qpos if per_slot else qpos[None]              # (B, S) | (1, S)
    q = L.rope(q, qp, theta=cfg.rope_theta)
    k = L.rope(k, qp, theta=cfg.rope_theta)
    if tp is not None:
        q, k, v = _all_heads(tp, cfg, q, k, v)
    n = ck.shape[1]
    qg = q.reshape(b, s_len, hkv_all, h_all // hkv_all, hd)

    if place is not None and place.seq is not None:
        lo, whole = place.seq
        g = lo + torch.arange(n, device=x.device)
        off = (g - (all_pos[:, None] if per_slot else all_pos)) % whole
        hit = off < s_len                       # (B_all, n) | (n,)
        spos.copy_(torch.where(hit, ((all_pos[:, None] if per_slot
                                      else all_pos) + off).to(torch.int32),
                               spos))
        if per_slot:
            off_l = off if lanes is None else off[lanes]
            hit_l = hit if lanes is None else hit[lanes]
            idx = off_l.clamp(max=s_len - 1)[..., None, None].expand(
                -1, -1, hkv_all, hd)
            keep = hit_l[..., None, None]
            ck.copy_(torch.where(keep, k.gather(1, idx).to(ck.dtype), ck))
            cv.copy_(torch.where(keep, v.gather(1, idx).to(cv.dtype), cv))
            sp = spos if lanes is None else spos[lanes]
        else:
            idx = off.clamp(max=s_len - 1)
            keep = hit[None, :, None, None]
            ck.copy_(torch.where(keep, k[:, idx].to(ck.dtype), ck))
            cv.copy_(torch.where(keep, v[:, idx].to(cv.dtype), cv))
            sp = spos[None]
        valid = (sp[:, None, :] >= 0) & (sp[:, None, :] <= qp[..., None])
        if cfg.swa_window:
            valid = valid & (sp[:, None, :] > qp[..., None] - cfg.swa_window)
        logits = torch.einsum("bshgd,blhd->bhgsl", qg.float(),
                              ck.float()) * (hd ** -0.5)
        logits = torch.where(valid[:, None, None, :, :], logits, -torch.inf)
        lse = torch.logsumexp(logits, dim=-1)               # (b, hkv, g, s)
        w = torch.exp(logits - torch.where(lse.isfinite(), lse,
                                           0.0)[..., None])
        part = torch.einsum("bhgsl,blhd->bshgd", w, cv.float())
        out, _ = tp.merge(part.reshape(b, s_len, h_all, hd),
                          lse.permute(0, 3, 1, 2).reshape(b, s_len, h_all))
    else:
        slots = (qpos % n).long()
        if per_slot:
            lane = torch.arange(b, device=x.device)[:, None]
            ck[lane, slots] = k.to(ck.dtype)
            cv[lane, slots] = v.to(cv.dtype)
            aq = all_pos[:, None] + offs[None]
            alane = torch.arange(all_pos.shape[0], device=x.device)[:, None]
            spos[alane, (aq % n).long()] = aq.to(torch.int32)
            sp = spos if lanes is None else spos[lanes]  # (B, cache_len)
        else:
            ck.index_copy_(1, slots, k.to(ck.dtype))
            cv.index_copy_(1, slots, v.to(cv.dtype))
            spos.index_copy_(0, slots, qpos.to(torch.int32))
            sp = spos[None]                              # (1, cache_len)
        valid = (sp[:, None, :] >= 0) & (sp[:, None, :] <= qp[..., None])
        if cfg.swa_window:
            valid = valid & (sp[:, None, :] > qp[..., None] - cfg.swa_window)
        logits = torch.einsum("bshgd,blhd->bhgsl", qg.float(),
                              ck.float()) * (hd ** -0.5)
        logits = torch.where(valid[:, None, None, :, :], logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgsl,blhd->bshgd", w, cv.float())
    if tp is None:
        out = out.reshape(b, s_len, h_all * hd).to(x.dtype)
        return L.linear(p["wo"], out)
    out = _own_heads(out.reshape(b, s_len, h_all, hd), cfg, tp, h)
    return _out_proj(p, out, x, h, hd, tp, row_split)


def _cross_decode(p, x, cfg, cache, place=None):
    """x: (B, 1, D); one query per lane against the cached encoder or
    image K/V, every slot attended: B8 with ``lengths`` = the cross
    length; over a model axis each rank's query heads, and on a
    sequence-split cross cache B8's partial entry on its slots, merged."""
    tp = None if place is None else place.tp
    b = x.shape[0]
    hd, h_all = cfg.head_dim, cfg.num_heads
    ck, cv = cache["cross_k"], cache["cross_v"]
    p, x, h, _, row_split = _split_heads({k: p[k] for k in ("wq", "wo")},
                                         x, cfg, tp)
    q = L.linear(p["wq"], x).reshape(b, 1, h, hd)
    if tp is not None:
        q, = _all_heads(tp, cfg, q)
    lengths = torch.full((b,), ck.shape[1], dtype=torch.int32,
                         device=x.device)
    if place is not None and place.xseq is not None:
        part, lse = ops.decode_attention_partial(q.reshape(b, h_all, hd),
                                                 ck, cv, lengths)
        out, _ = tp.merge(part, lse)
    else:
        out = ops.decode_attention(q.reshape(b, h_all, hd), ck, cv, lengths)
    if tp is None:
        return L.linear(p["wo"], out.reshape(b, 1, h * hd).to(x.dtype))
    out = _own_heads(out.reshape(b, 1, h_all, hd), cfg, tp, h)
    return _out_proj(p, out, x, h, hd, tp, row_split)


def _block_decode(p, x, cfg, ctx, cache, pos, *, kind, place=None):
    """One layer of one decode step; writes the layer's cache in place."""
    h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
    if kind in ("ssm", "hybrid"):
        s_out, new = S.ssm_decode_step(p["ssm"], h, cache["ssm"], cfg,
                                       tp=ctx.model)
        cache["ssm"]["h"].copy_(new["h"])
        cache["ssm"]["conv"].copy_(new["conv"])
        if kind == "ssm":
            return x + s_out
        a = _attn_decode(p["attn"], h, cfg, cache, pos, place)
        x = x + 0.5 * (a + s_out)
    elif kind == "cross":
        x = x + _cross_decode(p["attn"], h, cfg, cache, place)
    else:
        x = x + _attn_decode(p["attn"], h, cfg, cache, pos, place)
        if kind == "encdec_dec":
            hc = L.norm_apply(p["ln_cross"], x, kind=cfg.norm)
            x = x + _cross_decode(p["cross"], hc, cfg, cache, place)
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


class _VocabEmbed(torch.autograd.Function):
    """This rank's part of the reference's ``onehot_psum`` embedding: the
    rows of table part ``w`` (vocabulary rows ``[lo, lo + len(w))``) for
    the tokens that fall in it, cast to the activation dtype, zeros for
    the others (the ranks' parts add up to the lookup: ``ModelAxis.
    reduce``).  Its backward is the reference's one-hot contraction
    ``ohᵀ @ g`` a chunk of ``min(512, S)`` positions at a time (one chunk
    where that does not divide ``S``): each chunk's rows added in float32
    and rounded once to the activation dtype, then cast to the table's
    dtype (the reference casts the table inside its scan's body), and
    the chunks added in the table's dtype from the last to the first (the
    transpose of the reference's scan over the chunks)."""

    @staticmethod
    def forward(ctx, w, tokens, lo, dtype):
        n = w.shape[0]
        local = tokens - lo
        mine = (local >= 0) & (local < n)
        local = torch.where(mine, local, torch.zeros_like(local))
        ctx.save_for_backward(local, mine)
        ctx.table = (tuple(w.shape), w.dtype)
        rows = F.embedding(local, w).to(dtype)
        return torch.where(mine[..., None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, grad):
        local, mine = ctx.saved_tensors
        shape, dtype = ctx.table
        s = local.shape[1]
        chunk = min(512, s)
        if s % chunk:
            chunk = s
        table = None
        for i in reversed(range(s // chunk)):
            sl = slice(i * chunk, (i + 1) * chunk)
            sel = mine[:, sl].reshape(-1)
            part = torch.zeros(shape, dtype=torch.float32,
                               device=grad.device).index_add_(
                0, local[:, sl].reshape(-1)[sel],
                grad[:, sl].reshape(-1, shape[1])[sel].float())
            part = part.to(grad.dtype).to(dtype)
            table = part if table is None else table + part
        return table, None, None, None


def _embed_fwd(p, tokens, cfg, ctx):
    """The reference's ``replicate`` gather, rows cast to the activation
    dtype.  Its ``onehot_psum`` path serves a vocabulary sharded over a
    model axis (``vocab_shards > 1``, a vocabulary it divides and
    ``embed_gather`` not ``replicate``): this rank looks up its slice of
    the vocabulary, masked (``_VocabEmbed``), and the ranks' lookups are
    added over the model axis.  On one card the table is whole and the
    reference takes the ``replicate`` path; under a model axis that
    path gathers a split table whole first.  Where a backward runs
    through a table of another dtype than the activations (float32
    master weights, bf16 activations) the gather is ``_CastEmbed``;
    otherwise ``F.embedding``, not indexing: its backward adds a token's
    rows in the same order every run, on the CPU and on the card, where
    indexing's (``index_put_``) does not on the CPU, and a resumed run
    must repeat the uninterrupted one."""
    w = p["w"]
    tp, v, vs = ctx.model, cfg.vocab_size, ctx.vocab_shards
    if tp is not None:
        if vs > 1 and v % vs == 0 and cfg.embed_gather != "replicate":
            assert vs == tp.size, (vs, tp.size)
            return tp.reduce(_VocabEmbed.apply(w, tokens, tp.block(v).start,
                                               ctx.act_dtype))
        w = tp.full(w, 0, v)
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


def _ce_chunk_tp(xc, head, lc, tp):
    """``_ce_chunk`` with the head split by columns over the model axis
    ``tp`` (this rank's block of ``V/M`` vocabulary columns): the local
    log-sum-exp combined over the ranks (``ModelAxis.logsumexp``), and
    the label's logit taken from the rank that holds it (zeros elsewhere,
    reduced)."""
    lf = (tp.enter(xc) @ head.to(xc.dtype)).float()       # (B, C, V/M)
    lse = tp.logsumexp(torch.logsumexp(lf, dim=-1))
    local = lc.long() - tp.rank * lf.shape[-1]
    mine = (local >= 0) & (local < lf.shape[-1])
    ll = lf.gather(-1, torch.where(mine, local, torch.zeros_like(
        local))[..., None])[..., 0]
    ll = tp.reduce(torch.where(mine, ll, torch.zeros_like(ll)))
    return (lse - ll).sum()


def fused_ce_loss(x, head, labels, *, chunk=512, tp=None):
    """Memory-fused cross-entropy: the head matmul and the log-softmax run
    a sequence chunk at a time, each under checkpoint where a backward
    will run, so the (B, S, V) logits never exist whole.  x: (B, S, D)
    post-norm hidden; the chunks' sums are added in order from 0.  ``tp``:
    the model axis whose ranks hold the head's columns in rank order
    (``_ce_chunk_tp``): vocab-parallel."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the length {s}")
    body = _ce_chunk if tp is None else functools.partial(_ce_chunk_tp,
                                                          tp=tp)
    if torch.is_grad_enabled() and (x.requires_grad or head.requires_grad):
        body = _remat(body, "full")
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

    def _keep(self, keys, tree, lead=()):
        """What this rank keeps of a subtree at ``keys`` (a block of a
        stack on ``lead``): all of it, or under ``RunCtx.gather`` its
        shards."""
        gather = self.ctx.gather
        if gather is None:
            return tree
        if isinstance(tree, dict):
            return {k: self._keep(keys + (k,), v, lead)
                    for k, v in tree.items()}
        return gather.keep(keys, tree, lead + tuple(tree.shape))

    def _stack(self, generator, kind: str, lead: tuple, master: bool,
               keys: tuple):
        """``prod(lead)`` blocks of ``kind`` drawn one after another and
        stored at once, a block at a time, in a tree stacked on ``lead``
        at ``keys`` (this rank's part of each block, ``_keep``)."""
        n = math.prod(lead)
        stack = None
        for i in range(n):
            bp = self._keep(keys, self._load(
                _init_block(generator, self.cfg, kind=kind),
                float32=master), lead)
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
        module docstring).  Under ``RunCtx.gather`` every leaf is drawn
        whole, the same numbers, and only this rank's shard of it is kept
        (a stack holds its shards only)."""
        if resolve_device(generator.device) != self.device:
            raise ValueError(f"the generator lies on {generator.device}, "
                             f"the model on {self.device}")
        cfg = self.cfg
        def load(keys, tree, float32=master):
            return self._keep(keys, self._load(tree, float32=float32))

        p: dict[str, Any] = {
            "embed": load(("embed",), {"w": L._normal(
                generator, (cfg.vocab_size, cfg.d_model), 0.02)}),
            "final_norm": load(("final_norm",), L.init_norm(
                generator, cfg.d_model, kind=cfg.norm), float32=True),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = load(("lm_head",), {"w": L._normal(
                generator, (cfg.d_model, cfg.vocab_size),
                cfg.d_model ** -0.5)})
        if self.groups:
            g, per = self.groups, cfg.cross_attn_period
            p["groups"] = {
                "self": self._stack(generator, "dense", (g, per - 1), master,
                                    ("groups", "self")),
                "cross": self._stack(generator, "cross", (g,), master,
                                     ("groups", "cross"))}
        else:
            p["layers"] = self._stack(generator, self.kind,
                                      (cfg.num_layers,), master, ("layers",))
        if cfg.is_encdec:
            p["encoder"] = {
                "layers": self._stack(generator, "enc",
                                      (cfg.encoder_layers,), master,
                                      ("encoder", "layers")),
                "norm": load(("encoder", "norm"), L.init_norm(
                    generator, cfg.d_model, kind=cfg.norm), float32=True)}
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
        """Logits of the final norm of ``x``: vocab-parallel under a model
        axis that splits the head, gathered over it."""
        x = L.norm_apply(params["final_norm"], x, kind=self.cfg.norm)
        tp = self._vocab_tp()
        if tp is None:
            return x @ self.head_weight(params).to(x.dtype)
        return tp.gather(tp.enter(x) @ self.head_weight(params).to(x.dtype),
                         -1)

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

    def _whole(self, keys, dtype=None):
        """``tree -> tree``: a subtree of the parameters at ``keys`` whole
        (``RunCtx.gather``; the tree itself without it)."""
        gather = self.ctx.gather
        if gather is None:
            return lambda tree: tree
        return functools.partial(gather, keys=keys, dtype=dtype)

    def _top(self, params):
        """``params`` with the embedding, the head and the final norm
        whole: one gather a call, so that a tied table's two uses add
        their gradients before one reduce-scatter."""
        if self.ctx.gather is None:
            return params
        top = {k: params[k] for k in ("embed", "lm_head", "final_norm")
               if k in params}
        return {**params, **self._whole(())(top)}

    def hidden(self, params, tokens, *, extra=None):
        """Post-final-norm hidden states (B, S, D).  ``extra``:
        ``{"frames": (B, T, D)}`` (encdec) or ``{"image_embeds": (B, T,
        D)}`` (vlm)."""
        return self._hidden(self._top(params), tokens, extra)

    def _hidden(self, params, tokens, extra):
        cfg, ctx = self.cfg, self.ctx
        x = _embed_fwd(params["embed"], tokens, cfg, ctx)
        kv_ctx = self._context(params, extra)
        policy = self._policy(params)
        if self.groups:
            return L.norm_apply(params["final_norm"], self._vlm_stack(
                params["groups"], x, kv_ctx, policy), kind=cfg.norm)
        stack = params["layers"]
        cast = ctx.act_dtype if ctx.cast_params_once else None
        if cast is not None and ctx.gather is None:
            stack = tree_map(lambda a: a.to(cast)
                             if a.is_floating_point() else a, stack)
        layers = _unstack(stack, cfg.num_layers)
        whole = self._whole(("layers",), cast)

        def run(lps, x):
            for lp in lps:
                x = _block_fwd(whole(lp), x, cfg, ctx, kind=self.kind,
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
        self_w = self._whole(("groups", "self"))
        cross_w = self._whole(("groups", "cross"))

        def block(whole, lp, x, **kw):
            return _block_fwd(whole(lp), x, cfg, ctx, **kw)

        for gp in _unstack(groups_p, self.groups):
            for lp in _unstack(gp["self"], per):
                x = _remat(functools.partial(
                    block, self_w, lp, kind="dense"), policy)(x)
            x = _remat(functools.partial(
                block, cross_w, gp["cross"], kind="cross", kv_ctx=kv_ctx),
                policy)(x)
        return x

    def _encode(self, enc_p, frames):
        """The encoder over the frame embeddings (non-causal, no RoPE),
        then its norm."""
        cfg, ctx = self.cfg, self.ctx
        x = frames.to(ctx.act_dtype)
        policy = self._policy(enc_p)
        whole = self._whole(("encoder", "layers"))

        def block(lp, x):
            return _block_fwd(whole(lp), x, cfg, ctx, kind="enc")

        for lp in _unstack(enc_p["layers"], cfg.encoder_layers):
            x = _remat(functools.partial(block, lp), policy)(x)
        norm = self._whole(("encoder", "norm"))(enc_p["norm"])
        return L.norm_apply(norm, x, kind=cfg.norm)

    def forward(self, params, tokens, *, extra=None, last_only=False):
        """tokens: (B, S) int; ``extra`` as ``hidden``'s.  Returns logits
        (B, S, V), or (B, 1, V) when ``last_only`` (prefill: the head runs
        on the final position only)."""
        params = self._top(params)
        x = self._hidden(params, tokens, extra)
        if last_only:
            x = x[:, -1:, :]
        tp = self._vocab_tp()
        if tp is None:
            return x @ self.head_weight(params).to(x.dtype)
        return tp.gather(tp.enter(x) @ self.head_weight(params).to(x.dtype),
                         -1)

    def _vocab_tp(self):
        """The model axis where it splits the head's vocabulary columns
        (and the tied table's rows), else None."""
        tp = self.ctx.model
        return tp if tp is not None and tp.splits(self.cfg.vocab_size) \
            else None

    def loss(self, params, tokens, labels, *, extra=None, chunk=512):
        """Fused chunked cross-entropy (never materializes full logits);
        vocab-parallel under a model axis that splits the head."""
        params = self._top(params)
        x = self._hidden(params, tokens, extra)
        return fused_ce_loss(x, self.head_weight(params), labels,
                             chunk=chunk, tp=self._vocab_tp())

    # ---- serving ----
    def _cache_leaf(self, keys, shape, dtype, fill=0):
        """A cache leaf at ``keys`` of whole ``shape``, filled: this rank's
        block of it under ``RunCtx.gather`` (``cache_specs``)."""
        gather = self.ctx.gather
        if gather is not None:
            shape = gather.cache_shape(keys, tuple(shape))
        return torch.full(shape, fill, dtype=dtype, device=self.device)

    def _layer_cache(self, keys, lead, kind, batch, cache_len, cross_len,
                     dtype, per_slot):
        """The cache of ``kind``'s layers at ``keys``, stacked on
        ``lead``."""
        cfg = self.cfg
        leaf = lambda name, shape, dt, fill=0: self._cache_leaf(  # noqa: E731
            keys + (name,), shape, dt, fill)
        c: dict[str, Any] = {}
        kv = lead + (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        if kind in ("dense", "moe", "hybrid", "encdec_dec"):
            c["k"] = leaf("k", kv, dtype)
            c["v"] = leaf("v", kv, dtype)
            spos = lead + ((batch, cache_len) if per_slot else (cache_len,))
            c["slot_pos"] = leaf("slot_pos", spos, torch.int32, -1)
        if kind in ("encdec_dec", "cross"):
            xkv = lead + (batch, cross_len, cfg.num_kv_heads, cfg.head_dim)
            c["cross_k"] = leaf("cross_k", xkv, dtype)
            c["cross_v"] = leaf("cross_v", xkv, dtype)
        if kind in ("ssm", "hybrid"):
            one = S.init_ssm_cache(batch, cfg, dtype=dtype, device="meta")
            c["ssm"] = {k: self._cache_leaf(keys + ("ssm", k),
                                            lead + t.shape, t.dtype)
                        for k, t in one.items()}
        return c

    def init_cache(self, batch, cache_len, *, cross_len=0,
                   dtype=torch.bfloat16, per_slot=False):
        """``cross_len``: the slots of the cross-attention K/V (encdec,
        vlm), which ``prefill_cross`` fills.  ``per_slot=True`` builds a
        continuous-batching cache: ``pos`` (B,) and ``slot_pos`` (B,
        cache_len) per layer, so every lane (a serving *slot*) tracks its
        own sequence.  Needs an attention stack (dense, moe).  Under
        ``RunCtx.gather`` (serving over a model axis) each leaf is this
        rank's block of the whole cache of ``batch`` lanes (module
        docstring), and the cache's ``whole`` holds the whole sizes the
        blocks are of: ``self`` (the ring), ``cross`` and ``batch``."""
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
            layers = {"self": make(("layers", "self"), (g, per - 1),
                                   "dense"),
                      "cross": make(("layers", "cross"), (g,), "cross")}
        else:
            layers = make(("layers",), (cfg.num_layers,), self.kind)
        pos0 = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=self.device)
        cache = {"pos": pos0, "layers": layers}
        if self.ctx.gather is not None:
            cache["whole"] = {"self": cache_len, "cross": cross_len,
                              "batch": batch}
        return cache

    def ring_len(self, cache) -> int:
        """The whole length of ``cache``'s self-attention ring (cut to the
        window), of which this rank may hold a block."""
        if "whole" in cache:
            return cache["whole"]["self"]
        return cache["layers"]["k"].shape[-3]

    def ring_slots(self, cache) -> torch.Tensor:
        """The ring slots (int32) of this rank's block of ``cache``'s
        self-attention ring: all of them but where the model axis splits
        it."""
        n = cache["layers"]["k"].shape[-3]
        seq = None if self.ctx.model is None else self._seq(cache, "self", n)
        lo = 0 if seq is None else seq[0]
        return torch.arange(lo, lo + n, dtype=torch.int32,
                            device=self.device)

    def _seq(self, cache, kind: str, n: int):
        """``(first slot, whole length)`` of this rank's block of ``n``
        slots of ``cache``'s ``kind`` ("self" or "cross") cache, where the
        model axis splits it; None where this rank holds it whole (and at
        M = 1).  A cache that ``init_cache`` did not place for this model
        (no ``whole``), or whose block is not ``n`` slots, raises."""
        tp = self.ctx.model
        if "whole" not in cache:
            raise ValueError(f"a {kind} cache of {n} slots that this model "
                             "did not place: make it with init_cache")
        whole = cache["whole"][kind]
        split = tp.size > 1 and tp.splits(whole)
        if n != (whole // tp.size if split else whole):
            raise ValueError(
                f"this rank's {kind} cache holds {n} slots; the model "
                f"placed a cache of {whole} over {tp.size} model ranks")
        return (tp.rank * n, whole) if split else None

    def _place(self, cache):
        """The ``_Place`` of a serving step on ``cache``, None without a
        model axis."""
        tp = self.ctx.model
        if tp is None:
            return None
        layers = cache["layers"]
        if self.groups:
            self_c, cross_c = layers["self"], layers["cross"]
        else:
            self_c = cross_c = layers
        lanes = None
        pos = cache["pos"]
        if pos.dim() == 1 and self.ctx.gather is not None:
            lanes = self.ctx.gather.lanes(pos.shape[0])
        seq = (self._seq(cache, "self", self_c["k"].shape[-3])
               if "k" in self_c else None)
        xseq = (self._seq(cache, "cross", cross_c["cross_k"].shape[-3])
                if "cross_k" in cross_c else None)
        return _Place(tp, lanes, seq, xseq)

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1).  Returns (logits (B, 1, V), new_cache); the
        cache's tensors are written in place (module docstring).  Over a
        model axis: this rank's lanes of the tokens and of the logits, the
        logits gathered over the vocabulary."""
        cfg, ctx = self.cfg, self.ctx
        params = self._top(params)
        place = self._place(cache)
        pos = cache["pos"]
        x = _embed_fwd(params["embed"], tokens, cfg, ctx)
        layers = cache["layers"]
        if self.groups:
            gp, gc = params["groups"], layers
            self_w = self._whole(("groups", "self"))
            cross_w = self._whole(("groups", "cross"))
            for g in range(self.groups):
                for j in range(cfg.cross_attn_period - 1):
                    x = _block_decode(self_w(_layer(gp["self"], g, j)), x,
                                      cfg, ctx, _layer(gc["self"], g, j),
                                      pos, kind="dense", place=place)
                x = _block_decode(cross_w(_layer(gp["cross"], g)), x, cfg,
                                  ctx, _layer(gc["cross"], g), pos,
                                  kind="cross", place=place)
        else:
            whole = self._whole(("layers",))
            for i in range(cfg.num_layers):
                x = _block_decode(whole(_layer(params["layers"], i)), x, cfg,
                                  ctx, _layer(layers, i), pos,
                                  kind=self.kind, place=place)
        return self._head(params, x), dict(cache, pos=pos + 1)

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
        cache_len = self.ring_len(cache)       # the whole ring, not a block
        if tokens.shape[1] > cache_len:
            raise ValueError(
                f"prefill chunk ({tokens.shape[1]} tokens) exceeds the ring "
                f"cache ({cache_len} slots); chunk the prompt")
        params = self._top(params)
        place = self._place(cache)
        pos = cache["pos"]
        x = _embed_fwd(params["embed"], tokens, cfg, self.ctx)
        layers = cache["layers"]
        whole = self._whole(("layers",))
        for i in range(cfg.num_layers):
            lp, lc = whole(_layer(params["layers"], i)), _layer(layers, i)
            h = L.norm_apply(lp["ln1"], x, kind=cfg.norm)
            x = x + _attn_prefill(lp["attn"], h, cfg, lc, pos, place)
            x = x + _ffn_fwd(lp, x, cfg, self.ctx)
        return self._head(params, x[:, -1:, :]), dict(
            cache, pos=pos + tokens.shape[1])

    def prefill_cross(self, params, cache, context):
        """Fill the cross-attention K/V from ``context`` (B, T, D): the
        frame embeddings, encoded first (encdec), or the image embeddings
        (vlm).  The cache's ``cross_k``/``cross_v`` become new tensors of
        T slots in the cache's dtype (as the reference replaces them);
        returns the cache.  Other families' caches come back as they
        are.  Over a model axis: this rank's lanes of the context, the
        encoder tensor-parallel, and the K/V of this rank's ``T/M`` slots
        (all ``T`` where the axis does not divide them) for every KV head,
        ``wk``/``wv`` gathered whole."""
        cfg = self.cfg
        if cfg.is_encdec:
            kv_src = self._encode(params["encoder"], context)
            keys, n = ("layers", "cross"), cfg.num_layers
            attn = params["layers"]["cross"]
            lc = cache["layers"]
        elif cfg.is_vlm:
            kv_src = context.to(self.ctx.act_dtype)
            keys, n = ("groups", "cross", "attn"), self.groups
            attn = params["groups"]["cross"]["attn"]
            lc = cache["layers"]["cross"]
        else:
            return cache
        attn = self._whole(keys)({k: attn[k] for k in ("wk", "wv")})
        tp, t = self.ctx.model, kv_src.shape[1]
        if tp is not None:
            cache["whole"]["cross"] = t
            if tp.size > 1 and tp.splits(t):
                kv_src = kv_src[:, tp.block(t)]
            width = cfg.num_kv_heads * cfg.head_dim
            attn = {w: {k: tp.full(leaf, -1, width)
                        for k, leaf in attn[w].items()} for w in attn}
        b = kv_src.shape[0]
        shape = (b, kv_src.shape[1], cfg.num_kv_heads, cfg.head_dim)
        for key, w in (("cross_k", "wk"), ("cross_v", "wv")):
            lc[key] = torch.stack([
                L.linear(_layer(attn[w], i), kv_src).reshape(shape)
                for i in range(n)]).to(lc[key].dtype)
        return cache
