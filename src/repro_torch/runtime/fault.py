"""Fault-tolerance utilities for the training entry point: a copy of
``repro.runtime.fault`` (numpy only), with a ``StepTimer`` that waits for
the card.

The failure model: a lost process resumes from the last committed
checkpoint; a transient step failure is retried (``retrying``); a
persistently slow step is flagged from step-time z-scores
(``StragglerWatch``) as the cue to checkpoint and move.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

log = logging.getLogger("repro_torch.fault")

__all__ = ["StragglerWatch", "retrying", "StepTimer"]


@dataclasses.dataclass
class StragglerWatch:
    """Host-side per-step wall-time watchdog.

    A step slower than mean + z_thresh * std (over a sliding window) is
    flagged; ``persistent`` trips after ``patience`` consecutive flags.
    """

    window: int = 50
    z_thresh: float = 4.0
    patience: int = 3

    def __post_init__(self):
        self._times: list[float] = []
        self._consecutive = 0

    def observe(self, dt: float) -> bool:
        flagged = False
        hist = self._times[-self.window:]
        if len(hist) >= 10:
            mu, sd = float(np.mean(hist)), float(np.std(hist)) + 1e-9
            if dt > mu + self.z_thresh * sd:
                flagged = True
        self._times.append(dt)
        self._consecutive = self._consecutive + 1 if flagged else 0
        if flagged:
            log.warning("straggler: step took %.3fs (window mean %.3fs)",
                        dt, np.mean(hist))
        return flagged

    @property
    def persistent(self) -> bool:
        return self._consecutive >= self.patience


def retrying(fn: Callable, *, retries: int = 2, on_retry=None):
    """Wrap a step callable with bounded retry (transient failures)."""

    def wrapped(*a, **kw):
        for attempt in range(retries + 1):
            try:
                return fn(*a, **kw)
            except Exception as e:  # noqa: BLE001 - the step boundary
                if attempt == retries:
                    raise
                log.warning("step failed (%s); retry %d/%d",
                            e, attempt + 1, retries)
                if on_retry is not None:
                    on_retry(attempt, e)

    return wrapped


class StepTimer:
    """Wall seconds of a ``with`` block (``dt``).  With a CUDA ``device``
    it synchronizes the device on entry and exit, so that ``dt`` covers
    the block's device work, not only its enqueue."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self._t0 = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self._t0
        return False
