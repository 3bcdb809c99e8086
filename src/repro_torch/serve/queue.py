"""Request queue with arrival-time admission (FIFO).

Pure host-side bookkeeping — no torch.  Requests become *ready* once the
engine's clock passes their ``arrival_time``; among ready requests,
admission is strictly first-come-first-served (arrival time, then
submission order), so a late-arriving short prompt can never starve an
earlier long one.  The clock unit is the caller's: ``ServeEngine`` counts
decode ticks (deterministic for tests), a real gateway would pass wall
seconds — the queue only ever compares ``arrival_time <= now``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any

__all__ = ["Request", "RequestQueue"]


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D int token sequence (list / tuple / ndarray);
    ``max_new_tokens`` counts every generated token, including the one the
    prefill's last-position logits yield; ``eos_id`` stops generation
    early when the greedy token hits it.
    """

    id: Any
    prompt: Any
    max_new_tokens: int
    arrival_time: float = 0.0
    eos_id: int | None = None


class RequestQueue:
    """FIFO admission gated on arrival time.

    >>> q = RequestQueue()
    >>> q.submit(Request(id="late", prompt=[1], max_new_tokens=4,
    ...                  arrival_time=2.0))
    >>> q.submit(Request(id="early", prompt=[2], max_new_tokens=4))
    >>> [r.id for r in q.ready(now=0.0)]     # peek: only arrived requests
    ['early']
    >>> q.pop_ready(now=0.0).id
    'early'
    >>> q.pop_ready(now=0.0) is None         # "late" hasn't arrived yet
    True
    >>> q.next_arrival()                     # when to wake an idle engine
    2.0
    >>> q.pop_ready(now=5.0).id
    'late'
    >>> len(q)
    0
    """

    def __init__(self):
        self._heap: list[tuple[float, int, Request]] = []
        self._seq = 0

    def submit(self, request: Request) -> None:
        heapq.heappush(self._heap,
                       (float(request.arrival_time), self._seq, request))
        self._seq += 1

    def pop_ready(self, now: float) -> Request | None:
        """The earliest-arrived ready request, or None if none has
        arrived by ``now``."""
        if self._heap and self._heap[0][0] <= now:
            return heapq.heappop(self._heap)[2]
        return None

    def ready(self, now: float) -> list[Request]:
        """Arrived-but-unadmitted requests in admission order (peek)."""
        return [r for (t, _, r) in sorted(self._heap) if t <= now]

    def next_arrival(self) -> float | None:
        """Earliest pending arrival time (None when empty) — lets an idle
        engine jump its clock instead of spinning empty ticks."""
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
