"""AdamW, schedules and global-norm clipping on tensor trees (nested
dicts of tensors): the counterpart of ``repro.optim.adamw``.

The reference is functional and its train step donates params and state
to XLA, which updates them in place.  Here ``apply`` updates the given
trees in place and returns them: a model whose float32 parameters,
gradients and two moments take 16 B a parameter has no room for a second
copy.  The moments are float32.  Schedules are callables ``step -> lr``
on the step counter, a 0-d int32 tensor on the parameters' device, as the
reference evaluates them inside ``jit``: the learning rate never leaves
the device.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable

import torch

from repro_torch.models.transformer import tree_leaves, tree_map

__all__ = ["AdamW", "cosine_schedule", "linear_warmup", "global_norm",
           "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (``jax.tree.leaves``' order) of each
    leaf's float32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm):
    """Scale ``tree`` in place so that its global norm is at most
    ``max_norm``; returns ``(tree, norm before clipping)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in tree_leaves(tree):
        g.copy_(g * scale)
    return tree, norm


def linear_warmup(base_lr: float, warmup_steps: int):
    def lr(step):
        return base_lr * torch.clamp((step + 1) / max(1, warmup_steps),
                                     max=1.0)
    return lr


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    def lr(step):
        warm = torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * warm * cos
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with optional true mixed precision.

    ``mixed_precision=True``: the params passed through the train step are
    the bf16 compute copy; the float32 master weights live inside the
    optimizer state and are the ones updated, and the compute copy is
    re-derived from them each step."""

    lr: Callable[[torch.Tensor], Any] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    mixed_precision: bool = False

    def init(self, params) -> dict[str, Any]:
        """``{"m", "v", "step"}`` (and ``"master"``): float32 zeros like
        ``params`` and a 0-d int32 step, on the parameters' device."""
        zeros = lambda t: tree_map(  # noqa: E731
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), t)
        device = tree_leaves(params)[0].device
        state = {"m": zeros(params), "v": zeros(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        if self.mixed_precision:
            state["master"] = tree_map(
                lambda x: x.to(torch.float32, copy=True), params)
        return state

    def cast_params(self, params, dtype=torch.bfloat16):
        """float32 master tree -> compute tree (at init or restore)."""
        return tree_map(lambda x: x.to(dtype) if x.is_floating_point()
                        else x, params)

    def apply(self, params, grads, state):
        """One step: ``(params, state, gnorm)``, the first two updated in
        place (``grads`` is clipped in place too).  ``gnorm`` is the norm
        before clipping."""
        step = state["step"] + 1
        if self.clip_norm:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        else:
            gnorm = global_norm(grads)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf

        leaves = zip(tree_leaves(params), tree_leaves(grads),
                     tree_leaves(state["m"]), tree_leaves(state["v"]),
                     tree_leaves(state["master"]) if self.mixed_precision
                     else itertools.repeat(None))
        for p, g, m, v, master in leaves:
            gf = g.float()
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * gf * gf)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            ref = master if master is not None else p.float()
            if self.weight_decay:
                u = u + self.weight_decay * ref
            new_master = ref - lr * u
            if master is not None:
                master.copy_(new_master)
            p.copy_(new_master)
        state["step"] = step
        return params, state, gnorm
