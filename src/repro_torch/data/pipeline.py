"""Deterministic, resumable synthetic LM data (numpy only): a copy of
``repro.data.pipeline``, whose batches it gives bit for bit.

Batch contents are a pure function of (seed, step), so any worker can
regenerate any batch and a restart never replays or skips data; the
pipeline's checkpointable state is one integer (the step).  Batches are
numpy arrays; placing them on a device is the caller's concern.  The
token stream mixes Zipf-distributed ids with copied spans, so that a
model's loss falls without shipping a corpus.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "DataState"]


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_json(self):
        return {"step": self.step}

    @classmethod
    def from_json(cls, d):
        return cls(step=int(d["step"]))


class SyntheticLM:
    """Yields (tokens, labels) of shape (batch, seq_len) int32."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 *, seed: int = 0, zipf_a: float = 1.3):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.zipf_a = zipf_a

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """Pure function of (seed, step): the resumability contract."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        v = self.vocab_size
        raw = rng.zipf(self.zipf_a, size=(self.batch, self.seq_len + 1))
        toks = (raw - 1) % v
        # structured spans: copy a prefix window forward (predictable
        # substructure, so that models reduce their loss)
        span = max(2, self.seq_len // 8)
        start = rng.integers(0, max(1, self.seq_len - 2 * span),
                             size=self.batch)
        for b in range(self.batch):
            s = start[b]
            end = min(s + 2 * span, toks.shape[1])
            toks[b, s + span:end] = toks[b, s:s + (end - s - span)]
        toks = toks.astype(np.int32)
        return toks[:, :-1], toks[:, 1:]

    def iterate(self, state: DataState):
        while True:
            yield self.batch_at(state.step)
            state.step += 1
