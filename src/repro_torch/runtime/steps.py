"""Train and serve step builders, and the model-FLOPs count.

The reference's builders return functions to ``jit``; PyTorch runs
eagerly, so these return plain functions behind the same signatures.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import Model, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault import retrying

__all__ = ["build_grad_fn", "mean_over_ranks", "build_train_step",
           "build_decode_step", "build_prefill", "model_flops"]


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


def mean_over_ranks(grads, loss, comm, dims=None):
    """``(grads, loss)`` summed over the ranks of ``comm`` (one a process,
    a ``DistComm``) in rank order and divided by their count: the
    data-parallel mean, as ``build_grad_fn``'s accumulation sums its
    microbatches in order and divides.  Every leaf of one dtype travels in
    one flat buffer (one ``all_reduce``).

    ``dims`` (a tree like ``grads``, ``runtime.sharding``'s data dims):
    the leaves it splits are FSDP shards whose gradients the gather's
    backward has already summed over the ranks in order; they are only
    divided."""
    split = set()
    if dims is not None:
        split = {id(g) for g, d in zip(tree_leaves(grads), tree_leaves(dims))
                 if d is not None}
    leaves = [g for g in tree_leaves(grads) if id(g) not in split] + [loss]
    done = {id(g): g.div_(comm.p) for g in tree_leaves(grads)
            if id(g) in split}
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        group = [t for t in leaves if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])[None]
        total = comm.all_reduce(flat).wait()[0].div_(comm.p)
        for t, part in zip(group, total.split([t.numel() for t in group])):
            done[id(t)] = part.view_as(t)
    return tree_map(lambda t: done[id(t)], grads), done[id(loss)]


def build_train_step(model: Model, opt: AdamW, *, accum_steps: int = 1,
                     retries: int = 0, comm=None, dims=None):
    """``step(params, opt_state, batch, extra=None) -> (params, opt_state,
    metrics)``.

    The gradients are ``build_grad_fn``'s; ``params`` and ``opt_state``
    are then updated in place (``AdamW.apply``) and returned; ``metrics``
    holds the float32 ``loss`` and ``grad_norm`` as 0-d tensors on the
    device (reading them syncs).  A failure of the gradient half, which
    writes nothing of the state, is retried up to ``retries`` times
    (``retrying``); the update runs once, outside the retry, since a
    failure inside it may have written some leaves already.

    ``comm`` (a ``DistComm``, one rank a process): data parallelism.
    ``batch`` is this rank's rows; the gradients and the loss are
    averaged over the ranks (``mean_over_ranks``, outside the retry: a
    collective must run once on every rank) before the update, so every
    rank holds the same parameters after the step.

    ``dims`` (FSDP: ``RunCtx.gather`` is the model's hook, ``params`` and
    ``opt_state`` this rank's shards, ``dims`` the parameters' data dims):
    the split leaves' gradients arrive reduced by the gather's backward
    and are divided by ``comm.p``, the others go through
    ``mean_over_ranks``; the global norm sees each split gradient whole,
    assembled one leaf at a time (``AdamW.apply``'s ``whole``), so it is
    the replicated step's bit for bit; ``AdamW.apply`` then updates the
    shards.  The gradient half then holds collectives, and a retry on one
    rank alone would leave the others waiting in a gather: a sharded step
    takes no ``retries``.  ``step.retries`` is the count it retries.

    Under a model axis too (``launch.train --mesh DxM``: the gather's
    ``mdims``), ``comm`` is the data group, so the gradients and the loss
    are averaged over the data axis only (every model rank computes the
    same loss, and a leaf that the model axis does not split has the same
    gradient on every model rank); the global norm assembles each leaf
    over both axes, so that it counts every leaf once.  On a pod axis
    ``comm`` is the batch group (pod × data), whose order the gather's
    backward sums the split leaves in too.

    AdamW updates each leaf at its block over ``opt_fsdp_axes`` (the
    gather's ``odims``, where ``opt_state``'s ``m``/``v``/``master`` hold
    theirs; its FSDP part without them): each parameter and gradient whose
    block there differs from its part is cut to that block
    (``Gather.to_wide``), the norm assembles the blocks over the same
    axes, and each parameter's part is put back from its updated block
    (``Gather.from_wide``).  The update is elementwise and the norm over
    whole leaves, so the step is the one without ``opt_fsdp_axes`` bit
    for bit."""
    sharded = dims is not None and any(
        d is not None for d in tree_leaves(dims))
    if sharded and retries:
        raise ValueError("a sharded step retries nothing: its gradient "
                         "half holds collectives")
    grads_of = retrying(build_grad_fn(model, accum_steps=accum_steps),
                        retries=retries)
    whole = None

    def wide(tree):                     # replicated: the leaves themselves
        return tree

    def put_back(params, blocks):
        pass

    if sharded:
        gather = model.ctx.gather
        ds = tree_leaves(dims)
        mds = [None] * len(ds) if gather.mdims is None \
            else tree_leaves(gather.mdims)
        ods = ds if gather.odims is None else tree_leaves(gather.odims)

        def whole(tree):
            return (gather.whole(g, od, md, wide=True)
                    for g, od, md in zip(tree_leaves(tree), ods, mds))

        def wide(tree):
            cut = {id(t): gather.to_wide(t, d, od) for t, d, od in zip(
                tree_leaves(tree), ds, ods)}
            return tree_map(lambda t: cut[id(t)], tree)

        def put_back(params, blocks):
            for p, w, d, od in zip(tree_leaves(params), tree_leaves(blocks),
                                   ds, ods):
                if w is not p:
                    p.copy_(gather.from_wide(w, d, od))

    def step(params, opt_state, batch, extra=None):
        grads, loss = grads_of(params, batch, extra)
        if comm is not None:
            grads, loss = mean_over_ranks(grads, loss, comm, dims)
        blocks, opt_state, gnorm = opt.apply(wide(params), wide(grads),
                                             opt_state, whole)
        put_back(params, blocks)
        return params, opt_state, {"loss": loss,
                                   "grad_norm": gnorm.float()}

    step.retries = retries
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
