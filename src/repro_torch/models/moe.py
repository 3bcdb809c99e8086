"""Mixture-of-Experts block, and the MoE consumers of the exchange ladder.

Token→expert routing is the LM-scale instance of the paper's fine-grained
irregular communication: each token (array element) must reach the rank
owning its expert (owner thread).

* ``moe_fwd`` — the local MoE FFN of the transformer: tokens sort-packed
  into per-expert capacity-bounded buffers (message condensing with a
  static capacity bound standing in for the paper's one-time plan), the
  expert MLPs, and the weighted combine back onto the tokens.
* ``MoEDispatchGather`` / ``MoECombineScatter`` / ``MoELayer`` — the same
  dispatch and combine as exchanges over a communicator's ranks: expert
  capacity slots are accessor rows, tokens the shared vector, and any rung
  of the ladder (or ``"auto"``) moves exactly the routed tokens.
* ``DynamicMoELayer`` — the per-batch routed layer: one envelope plan for
  every routing of the same shape, and each batch's executor tables
  derived on the device from that batch's routing (``comm.dynamic``), with
  no host plan build and no host sync.

The reference compiles each exchange consumer into one ``shard_map``; the
port runs it on rank-stacked tensors over a ``LoopbackComm``: tokens are
``(P, num_tokens / P, ...)``, expert buffers ``(P, num_experts / P,
capacity, ...)``, expert weights ``(P, num_experts / P, ...)`` — rank q
holds tokens and experts in contiguous blocks, as the reference shards
them.  The expert matmuls are ``torch.matmul``; the reference computes
them with ``einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.comm import dynamic as dyn
from repro_torch.comm import telemetry
from repro_torch.comm.exchange import measure_hw
from repro_torch.comm.gather import IrregularGather
from repro_torch.comm.pattern import AccessPattern, Destination
from repro_torch.comm.plan import Topology
from repro_torch.comm.scatter import IrregularScatter
from repro_torch.comm.schedule import Schedule
from repro_torch.core import perfmodel
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L

__all__ = ["init_moe", "moe_fwd", "moe_capacity", "random_router", "top_k",
           "moe_dispatch_pattern", "moe_dispatch_ref", "MoEDispatchGather",
           "moe_combine_weights", "moe_combine_ref", "MoECombineScatter",
           "moe_expert_local", "MoELayer", "DynamicMoELayer"]


def random_router(key, num_tokens: int, num_experts: int, top_e: int = 2):
    """Seeded zipf-skewed routing, the shared stand-in for a trained router.

    Expert popularity follows the paper-style skew real routers exhibit
    (weights ∝ 1/rank).  Per token the ``top_e`` experts are drawn
    *without replacement* (Gumbel top-k over the skewed logits) and the
    routing weights are normalized to sum to 1.  A numpy copy of the
    reference's: the same ``key`` gives the same arrays.

    Returns ``(top_e_idx (T, k) int32, top_w (T, k) float32)``.
    """
    rng = np.random.default_rng(key)
    weights = 1.0 / np.arange(1, num_experts + 1)
    weights /= weights.sum()
    # Gumbel top-k: k distinct experts per token with P(expert) ∝ weights
    g = rng.gumbel(size=(num_tokens, num_experts)) + np.log(weights)
    idx = np.argsort(-g, axis=1)[:, :top_e].astype(np.int32)
    raw = rng.random((num_tokens, top_e)).astype(np.float32) + 0.1
    top_w = raw / raw.sum(axis=1, keepdims=True)
    return idx, top_w.astype(np.float32)


def init_moe(generator, cfg):
    """The router and the stacked expert weights (``w1``/``w3`` (E, D, F),
    ``w2`` (E, F, D)), float32 master values drawn from ``generator``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = d ** -0.5
    p = {
        "router": L.init_linear(generator, d, e),
        "w1": L._normal(generator, (e, d, f), scale),
        "w2": L._normal(generator, (e, f, d), f ** -0.5),
    }
    if cfg.act == "swiglu":
        p["w3"] = L._normal(generator, (e, d, f), scale)
    return p


def moe_capacity(tokens_per_group: int, cfg) -> int:
    c = math.ceil(
        tokens_per_group * cfg.experts_per_token / cfg.num_experts
        * cfg.capacity_factor
    )
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, in
    descending order, ties broken toward the lower index (a stable
    descending sort; ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _act(h, act):
    return F.silu(h) if act == "swiglu" else F.gelu(h, approximate="tanh")


def moe_expert_local(buf, w1, w2, w3=None, act="gelu"):
    """Expert MLPs on their capacity buffers: ``buf`` (..., E, C, D) with
    the matching expert weights ``w1`` (..., E, D, F) / ``w2`` (..., E, F,
    D) (and ``w3`` under swiglu), rank-stacked or not.  Shared by the
    layers and any composed baseline so that both run the same local
    math."""
    w1 = w1.to(buf.dtype)
    w2 = w2.to(buf.dtype)
    h = torch.matmul(buf, w1)
    if act == "swiglu":
        h = F.silu(h) * torch.matmul(buf, w3.to(buf.dtype))
    else:
        h = _act(h, act)
    return torch.matmul(h, w2)


def moe_fwd(p, x, cfg):
    """x: (G, T, D) tokens grouped by data-parallel rank.

    The router's logits in the activation dtype, a float32 softmax, the
    top-k experts (``top_k``, ties to the lower index) renormalized; the
    (token, choice) pairs sorted stably by expert and packed into (G, E, C,
    D) capacity buffers (over-capacity choices dropped into a dump row);
    the expert MLPs; each kept choice's output weighted and added onto its
    token (the plain fold of ``kernels.ref``, one rounding per add in the
    activation dtype)."""
    g, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = moe_capacity(t, cfg)
    dev = x.device

    logits = (x @ p["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                 # (G, T, E)
    top_p, top_e = top_k(probs, k)                        # (G, T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)

    # ---- condensed dispatch: sort tokens by expert, pack to capacity ----
    flat_e = top_e.reshape(g, t * k)
    flat_w = top_p.reshape(g, t * k)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)  # (G, T*k)
    se = flat_e.gather(-1, sort_idx)
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))               # (G, E)
    seg_start = counts.cumsum(-1) - counts                # exclusive
    pos = torch.arange(t * k, device=dev)[None] - seg_start.gather(-1, se)
    keep = pos < c
    dest = torch.where(keep, se * c + pos, e * c)         # dump slot
    tok = sort_idx // k

    gather_tok = x.gather(1, tok[..., None].expand(-1, -1, d))  # (G,T*k,D)
    buf = torch.zeros((g, e * c + 1, d), dtype=x.dtype, device=dev)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), gather_tok)
    buf = buf[:, :e * c].reshape(g, e, c, d)

    out_buf = moe_expert_local(buf, p["w1"], p["w2"], p.get("w3"), cfg.act)

    flat_out = torch.cat([out_buf.reshape(g, e * c, d),
                          out_buf.new_zeros((g, 1, d))], dim=1)
    y_sorted = flat_out.gather(1, dest[..., None].expand(-1, -1, d))
    w_sorted = flat_w.gather(-1, sort_idx)
    y_sorted = y_sorted * (w_sorted * keep)[..., None].to(y_sorted.dtype)
    # every token takes its k choices' outputs in sorted order
    return kref.accumulate_segments_ref(y_sorted, tok, out_len=t)


# ---------------------------------------------------------------------------
# MoE dispatch as the paper's irregular gather
# ---------------------------------------------------------------------------


def _pack_slots(top_e, num_tokens: int, num_experts: int, capacity: int):
    """Shared slot packing: sort (token, choice) pairs by expert, truncate
    at capacity.  Returns (slot_expert, slot_pos, src_flat, keep) over the
    flattened (num_tokens * k) routing choices, token-major within each
    expert — the same tokens ``moe_fwd`` keeps."""
    top_e = np.asarray(top_e)
    k = top_e.shape[1]
    e_flat = top_e.ravel()
    order = np.argsort(e_flat, kind="stable")     # (e, then token-major)
    se = e_flat[order]
    counts = np.bincount(e_flat, minlength=num_experts)
    seg_start = np.cumsum(counts) - counts
    pos = np.arange(num_tokens * k) - seg_start[se]
    keep = pos < capacity
    return se, pos, order, keep


def moe_dispatch_pattern(top_e, num_tokens: int, num_experts: int,
                         capacity: int, p: int, *, packed=None):
    """Token→expert assignment as an access-pattern index table.

    ``top_e``: (num_tokens, k) expert choices per token.  Accessor row
    ``e*capacity + c`` reads the c-th token routed to expert e (token-major
    order, truncated at capacity — the same tokens ``moe_fwd`` keeps).
    Returns ``(idx (E*C,) int32, valid (E*C,) bool)``; empty slots pad with
    a token *owned by the expert's rank* so padding costs no communication.
    ``packed`` accepts a precomputed ``_pack_slots`` result.
    """
    top_e = np.asarray(top_e)
    assert num_tokens % p == 0 and num_experts % p == 0
    t_loc, e_loc = num_tokens // p, num_experts // p
    k = top_e.shape[1]
    se, pos, order, keep = packed if packed is not None else _pack_slots(
        top_e, num_tokens, num_experts, capacity)
    st = np.repeat(np.arange(num_tokens, dtype=np.int64), k)[order]

    idx = np.zeros((num_experts, capacity), np.int64)
    valid = np.zeros((num_experts, capacity), bool)
    idx[se[keep], pos[keep]] = st[keep]
    valid[se[keep], pos[keep]] = True
    # pad empty slots with an owned token id (zero-cost access)
    own_token = np.repeat(np.arange(p) * t_loc, e_loc * capacity).reshape(
        num_experts, capacity)
    idx = np.where(valid, idx, own_token)
    return idx.reshape(-1).astype(np.int32), valid.reshape(-1)


def moe_combine_weights(top_e, top_w, num_tokens: int, num_experts: int,
                        capacity: int, *, packed=None):
    """Per-slot combine weight for the expert→token return path: slot
    ``e*capacity + c`` gets the weight of the token occupying it under
    ``moe_dispatch_pattern``'s packing; empty (over-capacity) slots get 0.
    Returns (E*C,) float32."""
    top_w = np.asarray(top_w)
    se, pos, order, keep = packed if packed is not None else _pack_slots(
        top_e, num_tokens, num_experts, capacity)
    sw = top_w.ravel()[order]
    w = np.zeros((num_experts, capacity), np.float32)
    w[se[keep], pos[keep]] = sw[keep]
    return w.reshape(-1)


def moe_dispatch_ref(x, idx, valid, num_experts: int, capacity: int):
    """NumPy ground truth: buf[e, c] = x[idx[e*C+c]] (0 where invalid)."""
    x = np.asarray(x)
    out = x[idx] * valid.reshape(-1, *([1] * (x.ndim - 1)))
    return out.reshape((num_experts, capacity) + x.shape[1:])


def moe_combine_ref(buf, idx, valid, w_slot, num_tokens: int):
    """NumPy ground truth for the combine: y[t] = Σ_slots→t w_slot * buf.

    ``buf``: (num_experts, capacity, ...) expert outputs; ``idx``/``valid``
    from ``moe_dispatch_pattern``; ``w_slot`` from ``moe_combine_weights``.
    """
    buf = np.asarray(buf)
    feat = buf.shape[2:]
    flat = buf.reshape((-1,) + feat)
    wshape = (-1,) + (1,) * len(feat)
    contrib = flat * (np.asarray(w_slot) * valid).reshape(wshape)
    y = np.zeros((num_tokens,) + feat, buf.dtype)
    np.add.at(y, np.asarray(idx), contrib.astype(buf.dtype))
    return y


def _ranked(a, p: int, device) -> torch.Tensor:
    """A host array (or tensor) split over ``p`` ranks along dim 0."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(a))
    return t.reshape((p, -1) + tuple(t.shape[1:])).to(device)


class MoEDispatchGather:
    """Expert-capacity-slot gather over rank-sharded tokens.

    Tokens (the shared vector, length ``num_tokens``, optional feature
    dims) and experts (``num_experts``, ``capacity`` slots each) are both
    split contiguously over the communicator's ranks.  Any ladder rung or
    ``"auto"`` applies.

    ``materialize="dest"`` (default) registers the expert-capacity slots as
    a ``Destination``: each exchange lands token vectors directly in
    ``(expert, capacity-slot)`` order, empty slots read exactly 0.0, and no
    length-``num_tokens`` private copy is assembled.  ``materialize="full"``
    keeps the assemble-then-index path (the same output); there the
    ``overlap`` rung fills owned-token slots from the local tokens while
    the condensed exchange is in flight.
    """

    def __init__(self, top_e, num_tokens: int, num_experts: int,
                 capacity: int, comm, *, strategy: str = "auto",
                 blocksize=None, shards_per_node=None,
                 materialize: str = "dest", hw=None,
                 use_plan_cache: bool = True):
        p = comm.p
        self.p = p
        self.num_tokens = num_tokens
        self.num_experts = num_experts
        self.capacity = capacity
        assert materialize in ("dest", "full"), materialize
        self.materialize = materialize
        idx, valid = moe_dispatch_pattern(
            top_e, num_tokens, num_experts, capacity, p)
        self.idx, self.valid = idx, valid
        pattern = AccessPattern.from_indices(idx, n=num_tokens)
        destination = None
        if materialize == "dest":
            # capacity slots ARE the consumer buffer: empty slots (whose
            # pattern entry is an owned zero-cost pad token) deliver 0.0
            slot_idx = np.where(valid, idx.astype(np.int64),
                                Destination.ZERO)
            destination = Destination.from_slots(
                slots=slot_idx.reshape(p, -1))
        self.gather = IrregularGather(
            pattern, comm, strategy=strategy, blocksize=blocksize,
            destination=destination,
            topology=Topology(p, shards_per_node or p), hw=hw,
            use_plan_cache=use_plan_cache)
        self.strategy = self.gather.strategy
        self.requested_strategy = strategy
        self.predicted_times = self.gather.predicted_times
        self.plan = self.gather.plan
        dev = comm.device
        if materialize == "dest":
            extra = ()
        elif self.strategy == "overlap":
            plan = self.plan
            extra = (plan.loc_cols[:, 0], plan.rem_cols[:, 0],
                     valid.astype(np.float32))
        else:
            extra = (idx, valid.astype(np.float32))
        self._extra_args = tuple(_ranked(a, p, dev) for a in extra)

    @property
    def counts(self):
        return self.plan.counts

    def shard_tokens(self, x) -> torch.Tensor:
        return self.gather.shard_vector(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (P, num_tokens / P, ...) -> (P, num_experts / P, capacity,
        ...) expert input buffers."""
        gather, p, c = self.gather, self.p, self.capacity
        feat = tuple(x.shape[2:])
        e_loc = self.num_experts // p
        ranks = torch.arange(p, device=x.device)[:, None]
        if self.materialize == "dest":
            # one targeted delivery: owned tokens from x, foreign tokens
            # from the landed recv buffer, empty slots exactly 0
            vals = gather.local(x, *gather.plan_args)["slots"]
            return vals.reshape((p, e_loc, c) + feat)
        if self.strategy == "overlap":
            loc, rem, valid = self._extra_args
            handle = gather.start_local(x, *gather.plan_args)
            # own-token slots resolve from x while the exchange flies;
            # padding points at the zero row appended here
            x_ext = torch.cat([x, x.new_zeros((p, 1) + feat)], dim=1)
            own = x_ext[ranks, loc]
            x_copy = handle.finish(extra_slots=1, copy_own=False)
            vals = own + x_copy[ranks, rem]   # each slot is own xor foreign
        else:
            idx, valid = self._extra_args
            vals = gather.local(x, *gather.plan_args)[ranks, idx]
        mask = valid.reshape(tuple(valid.shape) + (1,) * len(feat))
        buf = vals * mask.to(vals.dtype)
        return buf.reshape((p, e_loc, c) + feat)


class MoECombineScatter:
    """Weighted expert→token combine over the ranks — the inverse of
    ``MoEDispatchGather``.

    After the experts run, each (expert, capacity-slot) row holds the
    processed vector of the token that occupied it; the combine pushes
    ``w_slot * buf[e, c]`` back to that token and sums across a token's
    experts (``reduce="add"``), what ``moe_fwd``'s combine does locally.
    The same ``AccessPattern`` that plans the dispatch gather plans the
    combine scatter (``CommPlan.transpose()`` reuses the cached base plan).
    Over-capacity (invalid) slots carry weight 0, so they contribute
    exactly nothing.
    """

    def __init__(self, top_e, top_w, num_tokens: int, num_experts: int,
                 capacity: int, comm, *, strategy: str = "auto",
                 blocksize=None, shards_per_node=None, hw=None,
                 use_plan_cache: bool = True):
        p = comm.p
        self.p = p
        self.num_tokens = num_tokens
        self.num_experts = num_experts
        self.capacity = capacity
        packed = _pack_slots(top_e, num_tokens, num_experts, capacity)
        idx, valid = moe_dispatch_pattern(
            top_e, num_tokens, num_experts, capacity, p, packed=packed)
        w_slot = moe_combine_weights(
            top_e, top_w, num_tokens, num_experts, capacity, packed=packed)
        self.idx, self.valid, self.w_slot = idx, valid, w_slot
        # same pattern as the dispatch gather: slot (e, c) touches its
        # token — pulled on dispatch, pushed on combine
        pattern = AccessPattern.from_indices(idx, n=num_tokens)
        self.scatter = IrregularScatter(
            pattern, comm, strategy=strategy, blocksize=blocksize,
            reduce="add", topology=Topology(p, shards_per_node or p), hw=hw,
            use_plan_cache=use_plan_cache)
        self.strategy = self.scatter.strategy
        self.requested_strategy = strategy
        self.predicted_times = self.scatter.predicted_times
        self.plan = self.scatter.plan
        self.splan = self.scatter.splan
        # invalid slots: weight 0 -> contribution exactly 0
        self._w = _ranked((w_slot * valid).astype(np.float32), p,
                          comm.device)

    @property
    def counts(self):
        """Put-direction §5 volume counts of the combine exchange."""
        return self.splan.counts

    def shard_expert_buf(self, buf) -> torch.Tensor:
        """Place a host (num_experts, capacity, ...) buffer on the device
        as ``(P, num_experts / P, capacity, ...)``."""
        return _ranked(np.asarray(buf), self.p, self.scatter.device)

    def __call__(self, buf: torch.Tensor) -> torch.Tensor:
        """buf: (P, num_experts / P, capacity, ...) expert outputs ->
        (P, num_tokens / P, ...) combined tokens."""
        p, feat = self.p, tuple(buf.shape[3:])
        flat = buf.reshape((p, -1, 1) + feat)
        w = self._w.reshape((p, -1, 1) + (1,) * len(feat))
        return self.scatter(flat * w.to(buf.dtype))


class MoELayer:
    """Dispatch → expert MLP → combine as one ``Schedule``: one gather
    stage (the token→expert ``Destination`` delivery of
    ``MoEDispatchGather``), one compute stage (``moe_expert_local`` and the
    combine-weight multiply), one scatter stage (the ``reduce="add"`` push
    of ``MoECombineScatter``); both exchange stages share one base
    ``CommPlan``, and the expert compute runs inside the gather's window.
    The same numbers as the composed ``MoEDispatchGather →
    moe_expert_local → MoECombineScatter`` path on every rung.

    ``params``: ``{"w1": (E, D, F), "w2": (E, F, D)[, "w3": (E, D, F)]}``
    (the ``init_moe`` layout), split over the ranks along the expert dim.
    """

    def __init__(self, params, top_e, top_w, num_tokens: int,
                 num_experts: int, capacity: int, comm, *, act: str = "gelu",
                 strategy: str = "auto", blocksize=None,
                 shards_per_node=None, hw=None, use_plan_cache: bool = True):
        p = comm.p
        assert num_experts % p == 0 and num_tokens % p == 0
        self.p = p
        self.num_tokens = num_tokens
        self.num_experts = num_experts
        self.capacity = capacity
        e_loc = num_experts // p
        d = np.shape(params["w1"])[1]

        # one sort pipeline builds the dispatch pattern AND the combine
        # weights (the pair shares the packing, like the two front doors)
        packed = _pack_slots(top_e, num_tokens, num_experts, capacity)
        idx, valid = moe_dispatch_pattern(
            top_e, num_tokens, num_experts, capacity, p, packed=packed)
        w_slot = moe_combine_weights(
            top_e, top_w, num_tokens, num_experts, capacity, packed=packed)
        self.idx, self.valid, self.w_slot = idx, valid, w_slot
        pattern = AccessPattern.from_indices(idx, n=num_tokens)
        slot_idx = np.where(valid, idx.astype(np.int64), Destination.ZERO)
        destination = Destination.from_slots(slots=slot_idx.reshape(p, -1))
        # invalid (over-capacity) slots: weight 0 -> contribution exactly 0
        w_masked = (w_slot * valid).astype(np.float32)[:, None]

        sched = Schedule()
        x_ref = sched.input("tokens")
        wexperts = tuple(sched.constant(np.asarray(params[k]), k)
                         for k in (("w1", "w2", "w3") if act == "swiglu"
                                   else ("w1", "w2")))
        wc = sched.constant(w_masked, "combine_w")
        g = sched.gather(pattern, src=x_ref, destination=destination,
                         name="dispatch")

        def expert_fn(delivered, *weights):
            *wx, wc_l = weights
            w3_l = wx[2] if len(wx) == 3 else None
            # tokens land in (expert, capacity) order; empty slots are
            # exactly 0 and carry combine weight 0
            buf = delivered["slots"].reshape(p, e_loc, capacity, d)
            out = moe_expert_local(buf, wx[0], wx[1], w3_l, act)
            flat = out.reshape(p, e_loc * capacity, 1, d)
            return flat * wc_l.reshape(p, e_loc * capacity, 1, 1).to(
                flat.dtype)

        y = sched.compute(expert_fn, g, *wexperts, wc, name="expert")
        out = sched.scatter(pattern, y, reduce="add", name="combine")
        self.schedule = sched.compile(
            comm, strategy=strategy, blocksize=blocksize,
            topology=Topology(p, shards_per_node or p), hw=hw,
            use_plan_cache=use_plan_cache, output=out)
        self.gather = sched.exchange_of(g)
        self.scatter = sched.exchange_of(out)
        self.requested_strategy = strategy
        self.strategies = self.schedule.strategies
        self.predicted_times = self.schedule.predicted_times
        self.predicted_window = self.schedule.predicted_window

    def shard_tokens(self, x) -> torch.Tensor:
        return self.schedule.shard_input(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (P, num_tokens / P, d) -> (P, num_tokens / P, d) combined
        expert outputs: the whole dispatch→expert→combine step."""
        return self.schedule(x)


# ---------------------------------------------------------------------------
# Per-batch routing: the DynamicPattern consumer (comm.dynamic)
# ---------------------------------------------------------------------------


class DynamicMoELayer:
    """Per-batch routed dispatch → expert MLP → combine with no host plan
    build after construction.

    ``MoELayer`` bakes one routing into its plan: a new routing means a new
    host ``CommPlan`` build, the §5 ``T_plan`` tax every batch.
    ``DynamicMoELayer`` wraps one representative routing in a
    ``DynamicPattern``: the plan cache serves a capacity-bounded *envelope*
    plan (bucket-reused across compatible routings,
    ``plan_cache.get_envelope_plan``), and each batch's executor tables
    are derived on the device from that batch's ``(top_e, top_w)``
    (``comm.dynamic``) — one derivation feeds both directions.  A step
    makes no host sync of its own until the plain fold of the combine (in
    bfloat16 on the card ``kernels.ref.ordered_add`` reads its round count
    on the host).

    The per-call plan cost the auto ranking pays is
    ``perfmodel.plan_build_time(..., source="device-derive")``, threaded
    through ``select.rank_strategies(plan_cost=...)`` and exposed as
    ``.plan_time``.  The same numbers as a freshly host-planned
    ``MoEDispatchGather(materialize="full") → moe_expert_local →
    MoECombineScatter`` per routing.

    ``params``: the ``init_moe`` layout (``w1``/``w2``[/``w3``]), placed on
    the device at construction.  ``top_e`` is a *template* routing (T, k):
    only its shape and load envelope matter.  The step runs in pieces
    (``pack``, ``derive``, ``dispatch``, ``experts``, ``combine``) that a
    caller may time one by one.
    """

    def __init__(self, params, top_e, num_tokens: int, num_experts: int,
                 capacity: int, comm, *, act: str = "gelu",
                 strategy: str = "auto", blocksize=None, shards_per_node=None,
                 hw=None, use_plan_cache: bool = True,
                 s_max: int | None = None, decode: bool = False):
        p = comm.p
        assert num_experts % p == 0 and num_tokens % p == 0
        self.p = p
        self.comm = comm
        self.device = comm.device
        self.num_tokens = num_tokens
        self.num_experts = num_experts
        self.capacity = capacity
        self.act = act
        t_loc, e_loc = num_tokens // p, num_experts // p
        self.k = k = np.asarray(top_e).shape[1]
        m = num_experts * capacity

        # the template routing founds the envelope plan; every later batch
        # reuses it (memory/bucket tier) and derives its tables on device
        idx, _ = moe_dispatch_pattern(
            top_e, num_tokens, num_experts, capacity, p)
        template = AccessPattern.from_indices(idx, n=num_tokens)
        self.pattern = dyn.DynamicPattern.from_template(
            template, p, s_max=s_max)

        if hw is None:
            hw = measure_hw(comm)
        # the per-batch T_plan this layer actually pays: the derivation
        # sort on the device, not a host build
        self.plan_time = perfmodel.plan_build_time(
            m, 1, hw, source="device-derive")
        topo = Topology(p, shards_per_node or p)
        common = dict(strategy=strategy, blocksize=blocksize, topology=topo,
                      hw=hw, use_plan_cache=use_plan_cache,
                      plan_cost=self.plan_time, decode=decode)
        self.gather = IrregularGather(self.pattern, comm, **common)
        self.scatter = IrregularScatter(self.pattern, comm, reduce="add",
                                        **common)
        self.decode = decode
        self.strategies = {"dispatch": self.gather.strategy,
                           "combine": self.scatter.strategy}
        self.predicted_times = {"dispatch": self.gather.predicted_times,
                                "combine": self.scatter.predicted_times}
        self.requested_strategy = strategy

        names = ("w1", "w2", "w3") if act == "swiglu" else ("w1", "w2")
        self._weights = tuple(
            (params[k_] if isinstance(params[k_], torch.Tensor)
             else torch.as_tensor(np.asarray(params[k_]))).to(self.device)
            for k_ in names)
        # empty-slot pad: an owned token id per expert rank (zero-cost)
        self._own_token = torch.arange(
            p, dtype=torch.int64, device=self.device).mul_(
            t_loc).repeat_interleave(e_loc * capacity)

    def shard_tokens(self, x) -> torch.Tensor:
        return self.gather.shard_vector(x)

    # ---- the step, in pieces ----
    def pack(self, top_e, top_w):
        """This batch's slot table and combine weights on the device: the
        twin of ``_pack_slots`` + ``moe_dispatch_pattern`` +
        ``moe_combine_weights`` (same stable sort, same capacity drop, same
        owned-token padding).  Returns ``(cols (E*C,) int64, w_slot (E*C,)
        float32)``, ``w_slot`` 0 at invalid slots."""
        e, c, t, k = (self.num_experts, self.capacity, self.num_tokens,
                      self.k)
        dev = self.device
        flat_e = top_e.reshape(t * k).to(torch.int64)
        flat_w = top_w.reshape(t * k)
        sort_idx = torch.argsort(flat_e, stable=True)
        se = flat_e[sort_idx]
        counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        seg_start = counts.cumsum(0) - counts
        pos = torch.arange(t * k, device=dev) - seg_start[se]
        keep = pos < c
        dest = torch.where(keep, se * c + pos, e * c)     # dump slot
        tok = sort_idx // k
        sw = flat_w[sort_idx].to(torch.float32)
        valid = torch.zeros(e * c + 1, dtype=torch.bool, device=dev).scatter_(
            0, dest, True)[:e * c]
        slot_tok = torch.zeros(e * c + 1, dtype=torch.int64,
                               device=dev).scatter_(0, dest, tok)[:e * c]
        w_slot = torch.zeros(e * c + 1, dtype=torch.float32,
                             device=dev).scatter_(0, dest, sw)[:e * c]
        cols = torch.where(valid, slot_tok, self._own_token)
        return cols, w_slot

    def derive(self, cols):
        """Both directions' executor tables from one derivation: the gather
        tables seed the scatter's (``derive_plan_args``)."""
        cols2 = cols.reshape(-1, 1)
        g = dyn.derive_gather_tables(cols2, self.num_tokens, self.p,
                                     self.pattern.s_max)
        gargs = (g.send_local_idx, g.recv_global_idx)
        sargs = self.scatter.derive_plan_args(cols2, gather_tables=g)
        return gargs, sargs

    def dispatch(self, x, cols, gargs):
        """x (P, T / P, d) -> the capacity buffers (P, E / P, C, d)."""
        p, d = self.p, x.shape[-1]
        x_copy = self.gather.local(x, *gargs)
        ranks = torch.arange(p, device=x.device)[:, None]
        return x_copy[ranks, cols.reshape(p, -1)].reshape(
            p, self.num_experts // p, self.capacity, d)

    def experts(self, buf, w_slot, weights):
        """Expert MLPs and the combine weights: -> the contribution table
        ``(P, E / P · C, 1, d)``."""
        p, d = self.p, buf.shape[-1]
        w = [t.reshape((p, -1) + tuple(t.shape[1:])) for t in weights]
        out = moe_expert_local(buf, w[0], w[1], w[2] if len(w) == 3 else None,
                               self.act)
        flat = out.reshape(p, -1, 1, d)
        return flat * w_slot.reshape(p, -1, 1, 1).to(flat.dtype)

    def combine(self, contrib, sargs):
        """The contributions pushed back onto the tokens: (P, T / P, d)."""
        return self.scatter.local(contrib, *sargs)

    def _routed_step(self, x, top_e, top_w, weights):
        top_e = torch.as_tensor(top_e, device=self.device)
        top_w = torch.as_tensor(top_w, device=self.device)
        cols, w_slot = self.pack(top_e, top_w)
        gargs, sargs = self.derive(cols)
        buf = self.dispatch(x, cols, gargs)
        return self.combine(self.experts(buf, w_slot, weights), sargs)

    def apply(self, x: torch.Tensor, top_e, top_w, *weights) -> torch.Tensor:
        """One routed step on ``x`` (num_tokens, d) with the expert weights
        passed per call (``w1, w2[, w3]``, each (E, ...)) instead of the
        ones given at construction: the twin of ``__call__`` for a model
        whose layers share one instance (template shapes), each supplying
        its own weights.  Returns (num_tokens, d).  No telemetry is
        recorded here; the caller records one ``"device-derive"`` per
        executed step (``serve.engine`` does, per decode tick)."""
        if len(weights) != len(self._weights):
            raise ValueError(
                f"expected {len(self._weights)} expert weight arrays "
                f"(w1, w2{', w3' if len(self._weights) == 3 else ''}), "
                f"got {len(weights)}")
        xs = x.reshape((self.p, -1) + tuple(x.shape[1:]))
        return self._routed_step(xs, top_e, top_w, weights).reshape(x.shape)

    def __call__(self, x: torch.Tensor, top_e, top_w) -> torch.Tensor:
        """One routed step: x (P, T / P, d) + THIS batch's routing (T, k)
        -> (P, T / P, d) combined expert outputs.  No host plan work: the
        tables come from the device derivation (recorded per call as
        ``"device-derive"``)."""
        telemetry.record("device-derive")
        return self._routed_step(x, top_e, top_w, self._weights)
