"""Prefill/decode interleave engine (continuous batching).

``num_slots`` lanes of one batched per-slot KV cache.  Every tick the
engine

1. **admits**: pops arrived requests off the ``RequestQueue`` while free
   lanes exist; each prompt runs chunked fused prefill (``Model.prefill``)
   into a private 1-lane cache, which ``_insert`` copies into the free
   lane;
2. **decodes**: one ``Model.decode_step`` over ALL lanes (free lanes
   compute garbage that is never read);
3. **bookkeeps**: appends each active lane's greedy token on the host and
   releases lanes whose request hit ``max_new_tokens`` / ``eos_id``, so the
   next tick's admission can refill them.

The only host synchronisation of a tick is the read of its tokens at the
tick boundary (a windowed config adds the read of its positions,
``Model._check_window``).  The engine's clock is the tick counter, so
``Request.arrival_time`` in tick units makes admission order
deterministic.

With ``moe_layer`` set (a ``models.moe.DynamicMoELayer`` built for
``num_tokens == num_slots``), the transformer's MoE FFN of every decode
step is routed through the §5-priced exchange via ``RunCtx.moe_step``:
per-tick routing, executor tables derived on the device, no host plan
build after construction — asserted through ``comm.telemetry``
(``assert_steady_state``).  Prefill keeps the local ``moe_fwd``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.comm import telemetry
from repro_torch.models import moe as M
from repro_torch.models.transformer import Model, tree_map
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.slots import SlotManager

__all__ = ["ServeEngine", "ServeReport", "generate_batch_loop",
           "moe_decode_hook"]


def moe_decode_hook(cfg, layer):
    """``RunCtx.moe_step`` adapter: route one decode tick's (B, 1, D)
    hidden batch through a ``DynamicMoELayer``.

    The routing math is ``moe_fwd``'s (the router in the activation dtype,
    a float32 softmax, ``moe.top_k``, renormalized); the dispatch→expert→
    combine then runs through the layer with THIS layer's weights — one
    ``DynamicMoELayer`` instance (template shapes) serves every layer of
    the stack via ``DynamicMoELayer.apply``.
    """
    k = cfg.experts_per_token

    def moe_step(p_moe, h):
        b, _, d = h.shape
        logits = (h.reshape(1, b, d)
                  @ p_moe["router"]["w"].to(h.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = M.top_k(probs, k)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        wx = [p_moe["w1"], p_moe["w2"]]
        if cfg.act == "swiglu":
            wx.append(p_moe["w3"])
        y = layer.apply(h.reshape(b, d), top_e[0], top_p[0], *wx)
        return y.reshape(b, 1, d).to(h.dtype)

    return moe_step


def _with_moe_hook(model: Model, moe_layer) -> Model:
    if moe_layer is None:
        return model
    if model.cfg.family != "moe":
        raise ValueError(
            f"moe_layer needs a MoE model, got family {model.cfg.family!r}")
    ctx = dataclasses.replace(
        model.ctx, moe_step=moe_decode_hook(model.cfg, moe_layer))
    return Model(model.cfg, ctx, device=model.device)


def _insert(cache, prefix, slot: int, token, tokens):
    """Copy a B=1 per-slot prefix cache into lane ``slot`` of the batched
    cache, in place, and seed the lane's next input token.  Layer tensors
    carry the leading stacked-L dim: every leaf maps (L, 1, ...) -> lane of
    (L, B, ...)."""

    def put(dst, src):
        dst[:, slot] = src[:, 0]

    tree_map(put, cache["layers"], prefix["layers"])
    cache["pos"][slot] = prefix["pos"][0]
    tokens[slot, 0] = token
    return cache, tokens


def _prompt(request: Request, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(request.prompt, np.int32).reshape(1, -1),
                           device=device)


def _prefill(model: Model, params, prompt, *, cache_len, chunk, dtype,
             on_chunk=None):
    """Chunked fused prefill of one prompt (1, P) into a fresh 1-lane
    per-slot cache; returns (the prefix cache, the first token as a 0-d
    device tensor)."""
    prefix = model.init_cache(1, cache_len, per_slot=True, dtype=dtype)
    chunk = chunk or prompt.shape[1]
    logits = None
    for lo in range(0, prompt.shape[1], chunk):
        logits, prefix = model.prefill(params, prefix,
                                       prompt[:, lo:lo + chunk])
        if on_chunk is not None:
            on_chunk()
    return prefix, torch.argmax(logits[0, -1], dim=-1).to(torch.int32)


def _percentile(xs, q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    i = min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))
    return float(s[i])


@dataclasses.dataclass
class ServeReport:
    """What a ``ServeEngine.run`` produced, with its latency accounting."""

    outputs: dict[Any, list[int]]       # request id -> greedy tokens
    completed: list[Any]                # completion order
    slot_of: dict[Any, int]             # request id -> lane it ran in
    ticks: int
    tick_seconds: list[float]           # wall time of each decode tick
    token_seconds: list[float]          # per generated token (its tick's dt)
    ttft_seconds: dict[Any, float]      # request id -> admission to token 1
    telemetry: dict                     # comm.telemetry deltas for the run

    @property
    def total_tokens(self) -> int:
        return sum(len(v) for v in self.outputs.values())

    @property
    def tokens_per_s(self) -> float:
        """Decode throughput: tokens emitted by decode ticks over decode
        wall time (prefill tokens/time excluded on both sides)."""
        t = sum(self.tick_seconds)
        return len(self.token_seconds) / t if t > 0 else 0.0

    def p50_us(self) -> float:
        return _percentile(self.token_seconds, 50.0) * 1e6

    def p99_us(self) -> float:
        return _percentile(self.token_seconds, 99.0) * 1e6


class ServeEngine:
    """Continuous-batching serving loop over a per-slot decode cache."""

    def __init__(self, model: Model, params, *, num_slots: int,
                 cache_len: int, prefill_chunk: int | None = None,
                 moe_layer=None, cache_dtype=None):
        if moe_layer is not None and moe_layer.num_tokens != num_slots:
            raise ValueError(
                f"moe_layer routes {moe_layer.num_tokens} tokens per step "
                f"but the engine decodes {num_slots} lanes; build the "
                f"DynamicMoELayer with num_tokens={num_slots}")
        self.model = _with_moe_hook(model, moe_layer)
        self.moe_layer = moe_layer
        self.params = params
        self.prefill_chunk = prefill_chunk
        self.cache_dtype = cache_dtype or self.model.ctx.act_dtype
        # one device derivation per MoE layer runs every decode tick
        self._derives_per_tick = (
            model.cfg.num_layers if moe_layer is not None else 0)
        self.cache = self.model.init_cache(
            num_slots, cache_len, per_slot=True, dtype=self.cache_dtype)
        self.cache_len = int(self.cache["layers"]["k"].shape[2])
        self.slots = SlotManager(num_slots)
        self.queue = RequestQueue()
        self._tokens = torch.zeros((num_slots, 1), dtype=torch.int32,
                                   device=model.device)

        self.now = 0.0            # tick clock (admission compares against it)
        self.ticks = 0
        self._outputs: dict[Any, list[int]] = {}
        self._completed: list[Any] = []
        self._slot_of: dict[Any, int] = {}
        self._tick_seconds: list[float] = []
        self._token_seconds: list[float] = []
        self._ttft: dict[Any, float] = {}
        self._snap0 = telemetry.stats.snapshot()

    # ---- request intake ----
    def submit(self, request: Request) -> None:
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        plen = len(np.asarray(request.prompt).reshape(-1))
        if plen < 1 or plen > self.cache_len:
            raise ValueError(
                f"prompt length {plen} must be in [1, {self.cache_len}] "
                "(the decode cache ring)")
        self.queue.submit(request)

    # ---- one tick ----
    def step(self) -> int:
        """Admit → decode → bookkeep.  Returns the number of lanes still
        active after the tick."""
        while self.slots.num_free and len(self.queue):
            req = self.queue.pop_ready(self.now)
            if req is None:
                break
            self._admit(req)

        active = self.slots.active()
        if active:
            t0 = time.perf_counter()
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, self._tokens)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            self._tokens = nxt[:, None]
            nxt_host = nxt.cpu().numpy()        # blocks: tick boundary
            dt = time.perf_counter() - t0
            telemetry.record_tick("decode_steps")
            for _ in range(self._derives_per_tick):
                telemetry.record("device-derive")
            self._tick_seconds.append(dt)
            for s in active:
                self._token_seconds.append(dt)
                self._emit(s, int(nxt_host[s.index]))

        self.now += 1.0
        self.ticks += 1
        return len(self.slots.active())

    def _admit(self, req: Request) -> None:
        """Prefill ``req`` into a free lane.  Its time to first token runs
        until that token is on the host (the reference stops its clock
        before that read, which on an asynchronous device times only the
        enqueue)."""
        t0 = time.perf_counter()
        prefix, first = _prefill(
            self.model, self.params, _prompt(req, self.model.device),
            cache_len=self.cache_len, chunk=self.prefill_chunk,
            dtype=self.cache_dtype,
            on_chunk=lambda: telemetry.record_tick("prefill_chunks"))
        slot = self.slots.allocate(req.id, max_new_tokens=req.max_new_tokens,
                                   eos_id=req.eos_id)
        self.cache, self._tokens = _insert(self.cache, prefix, slot, first,
                                           self._tokens)
        tok = int(first)
        self._outputs[req.id] = []
        self._slot_of[req.id] = slot
        self._ttft[req.id] = time.perf_counter() - t0
        # the prefill's last-position logits yield generated token #1
        self._emit(self.slots[slot], tok)

    def _emit(self, s, tok: int) -> None:
        rid = s.request_id
        self._outputs[rid].append(tok)
        s.generated += 1
        if s.generated >= s.max_new_tokens or (
                s.eos_id is not None and tok == s.eos_id):
            self._completed.append(rid)
            self.slots.release(s.index)

    # ---- drive to completion ----
    def run(self, *, max_ticks: int = 100_000) -> ServeReport:
        """Tick until the queue drains and every lane completes."""
        while len(self.queue) or self.slots.active():
            if not self.slots.active():
                nxt = self.queue.next_arrival()
                if nxt is not None and nxt > self.now:
                    self.now = float(nxt)       # idle: jump to next arrival
            self.step()
            if self.ticks >= max_ticks:
                raise RuntimeError(f"serve loop exceeded {max_ticks} ticks")
        return self.report()

    def report(self) -> ServeReport:
        return ServeReport(
            outputs={k: list(v) for k, v in self._outputs.items()},
            completed=list(self._completed),
            slot_of=dict(self._slot_of),
            ticks=self.ticks,
            tick_seconds=list(self._tick_seconds),
            token_seconds=list(self._token_seconds),
            ttft_seconds=dict(self._ttft),
            telemetry=telemetry.stats.since(self._snap0),
        )

    # ---- steady-state invariant ----
    def snapshot(self) -> dict:
        """Telemetry snapshot for a later ``assert_steady_state``."""
        return telemetry.stats.snapshot()

    def assert_steady_state(self, snap: dict) -> dict:
        """Assert that no host plan build happened across the decode ticks
        since ``snap`` (the §5 T_plan tax must not recur once warm).
        Returns the telemetry delta."""
        delta = telemetry.stats.since(snap)
        if not telemetry.stats.decode_host_free(snap):
            raise AssertionError(
                f"host plan builds during steady-state decode: {delta}")
        return delta


def generate_batch_loop(model: Model, params, requests, *, cache_len: int,
                        prefill_chunk: int | None = None, moe_layer=None,
                        cache_dtype=None) -> dict[Any, list[int]]:
    """The naive batch-loop baseline the engine must match token for token.

    Every request gets a dedicated lane up front (batch = len(requests):
    no queue, no admission, no slot reuse), prompts prefill per request
    into their lanes through the same fused path, then one decode step per
    tick until the longest request finishes.  Tokens stop accumulating per
    request at its ``max_new_tokens`` / ``eos_id``, so outputs compare
    directly against ``ServeReport.outputs``.
    """
    model = _with_moe_hook(model, moe_layer)
    dtype = cache_dtype or model.ctx.act_dtype
    b = len(requests)
    cache = model.init_cache(b, cache_len, per_slot=True, dtype=dtype)
    clen = int(cache["layers"]["k"].shape[2])
    tokens = torch.zeros((b, 1), dtype=torch.int32, device=model.device)
    outs: dict[Any, list[int]] = {}

    for i, r in enumerate(requests):
        prefix, first = _prefill(model, params, _prompt(r, model.device),
                                 cache_len=clen, chunk=prefill_chunk,
                                 dtype=dtype)
        cache, tokens = _insert(cache, prefix, i, first, tokens)
        outs[r.id] = [int(first)]

    def done(r):
        o = outs[r.id]
        return len(o) >= r.max_new_tokens or (
            r.eos_id is not None and o and o[-1] == r.eos_id)

    while not all(done(r) for r in requests):
        logits, cache = model.decode_step(params, cache, tokens)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        tokens = nxt[:, None]
        nh = nxt.cpu().numpy()
        for i, r in enumerate(requests):
            if not done(r):
                outs[r.id].append(int(nh[i]))
    return outs
