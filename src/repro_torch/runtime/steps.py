"""Train and serve step builders, and the model-FLOPs count.

The reference's builders return functions to ``jit``; PyTorch runs
eagerly, so these return plain functions behind the same signatures.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import Model, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault import retrying

__all__ = ["build_grad_fn", "build_train_step", "build_decode_step",
           "build_prefill", "model_flops"]


def build_grad_fn(model: Model, *, accum_steps: int = 1):
    """``grads(params, batch, extra=None) -> (grads, loss)``: the gradient
    half of the train step, which writes nothing of ``params``.

    ``batch`` = (tokens, labels) with shape (B, S), ``extra`` the
    cross-attention inputs of an encdec or vlm stack (``Model.hidden``'s,
    each (B, T, D)); gradient accumulation splits B, and every tensor of
    ``extra`` with it, into ``accum_steps`` microbatches in order and sums
    their
    gradients in float32 (from the first; a float32 leaf's sum is the one
    its ``.grad`` collects), then divides by ``accum_steps``.  ``grads``
    is a tree like ``params``; ``loss`` is the float32 mean loss, a 0-d
    tensor on the device."""
    def grads_of(params, batch, extra=None):
        tokens, labels = batch
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not split into {accum_steps} "
                             "microbatches")
        mb = b // accum_steps
        # leaves that collect the gradient, sharing the parameters' storage
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(tracked)
        acc = {}            # float32 sums of the leaves of other dtypes
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            kw = {} if extra is None else {
                "extra": {k: t[sl] for k, t in extra.items()}}
            loss_i = model.loss(tracked, tokens[sl], labels[sl], **kw)
            loss_i.backward()
            loss = loss + loss_i.detach().float()
            for t in leaves:
                if accum_steps > 1 and t.grad is not None \
                        and t.grad.dtype != torch.float32:
                    acc[id(t)] = t.grad.float() if id(t) not in acc \
                        else acc[id(t)] + t.grad
                    t.grad = None

        def grad(t):
            g = acc.get(id(t), t.grad)
            g = torch.zeros_like(t) if g is None else g
            return g.div_(accum_steps) if accum_steps > 1 else g

        grads = tree_map(grad, tracked)
        if accum_steps > 1:
            loss = loss / accum_steps
        return grads, loss

    return grads_of


def build_train_step(model: Model, opt: AdamW, *, accum_steps: int = 1,
                     retries: int = 0):
    """``step(params, opt_state, batch, extra=None) -> (params, opt_state,
    metrics)``.

    The gradients are ``build_grad_fn``'s; ``params`` and ``opt_state``
    are then updated in place (``AdamW.apply``) and returned; ``metrics``
    holds the float32 ``loss`` and ``grad_norm`` as 0-d tensors on the
    device (reading them syncs).  A failure of the gradient half, which
    writes nothing of the state, is retried up to ``retries`` times
    (``retrying``); the update runs once, outside the retry, since a
    failure inside it may have written some leaves already."""
    grads_of = retrying(build_grad_fn(model, accum_steps=accum_steps),
                        retries=retries)

    def step(params, opt_state, batch, extra=None):
        grads, loss = grads_of(params, batch, extra)
        params, opt_state, gnorm = opt.apply(params, grads, opt_state)
        return params, opt_state, {"loss": loss,
                                   "grad_norm": gnorm.float()}

    return step


def build_decode_step(model: Model):
    """``step(params, cache, tokens) -> (logits, new_cache)``."""
    def step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return step


def build_prefill(model: Model, *, fill_cache: bool = False):
    """Inference prefill: forward over the prompt; the head runs on the
    last position only (next-token logits), as real serving does.

    Default (``fill_cache=False``): ``step(params, tokens, extra=None) ->
    logits (B, 1, V)``, the forward that measures prompt processing and
    keeps no cache (``extra``: ``Model.forward``'s).

    ``fill_cache=True``: the serving prefill, ``step(params, cache, tokens)
    -> (last_logits, new_cache)``: ``Model.prefill``, which also writes the
    prompt's K/V into the decode cache (chunked prefill = consecutive
    calls)."""
    if fill_cache:
        def fill_step(params, cache, tokens):
            return model.prefill(params, cache, tokens)

        return fill_step

    def step(params, tokens, extra=None):
        return model.forward(params, tokens, extra=extra, last_only=True)

    return step


def model_flops(cfg, *, mode: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS per step: 6·N_active·tokens (train) / 2·N_active·tokens
    (inference); N excludes the embedding gather, and the head matmul is
    added for the positions whose logits are actually computed."""
    n = cfg.flops_param_count()
    tokens = batch * (seq if mode in ("train", "prefill") else 1)
    mult = 6.0 if mode == "train" else 2.0
    head = 2.0 * cfg.d_model * cfg.vocab_size
    head_tokens = tokens if mode == "train" else batch  # last-only otherwise
    return mult * n * tokens + (3.0 if mode == "train" else 1.0) \
        * head * head_tokens
