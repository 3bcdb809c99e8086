"""Serve step builders: the decode step and the prefill.

The reference's builders return functions to ``jit``; PyTorch runs
eagerly, so these return the model's own methods behind the same
signatures.  The train step is not ported yet (ROADMAP A11).
"""
from __future__ import annotations

from repro_torch.models.transformer import Model

__all__ = ["build_decode_step", "build_prefill"]


def build_decode_step(model: Model):
    """``step(params, cache, tokens) -> (logits, new_cache)``."""
    def step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return step


def build_prefill(model: Model, *, fill_cache: bool = False):
    """Inference prefill: forward over the prompt; the head runs on the
    last position only (next-token logits), as real serving does.

    Default (``fill_cache=False``): ``step(params, tokens) -> logits (B, 1,
    V)``, the forward that measures prompt processing and keeps no cache
    (attention-free stacks; the training forward of attention stacks waits
    for ROADMAP A11).

    ``fill_cache=True``: the serving prefill, ``step(params, cache, tokens)
    -> (last_logits, new_cache)``: ``Model.prefill``, which also writes the
    prompt's K/V into the decode cache (chunked prefill = consecutive
    calls)."""
    if fill_cache:
        def fill_step(params, cache, tokens):
            return model.prefill(params, cache, tokens)

        return fill_step

    def step(params, tokens):
        return model.forward(params, tokens, last_only=True)

    return step
