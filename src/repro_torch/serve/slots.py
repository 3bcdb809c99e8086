"""Slot-based KV-cache bookkeeping.

A *slot* is one lane of the engine's batched decode cache (``per_slot``
caches in ``models.transformer``).  The device side never moves — a
request is admitted by overwriting a free lane's K/V prefix in place and
released by plain host bookkeeping (the lane's ``slot_pos`` rows are reset
lazily at the next insert).  This mirrors MaxText's offline-inference slot
scheme: allocate the lowest free lane, decode all lanes every tick, free a
lane the moment its request completes so the queue can refill it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Slot", "SlotManager"]


@dataclasses.dataclass
class Slot:
    """Host-side state of one cache lane."""

    index: int
    request_id: Any = None
    generated: int = 0          # tokens emitted so far (prefill token incl.)
    max_new_tokens: int = 0
    eos_id: int | None = None

    @property
    def free(self) -> bool:
        return self.request_id is None


class SlotManager:
    """Fixed pool of cache lanes with allocate / free / reset.

    >>> sm = SlotManager(2)
    >>> sm.allocate("r1", max_new_tokens=4)
    0
    >>> sm.allocate("r2", max_new_tokens=4)
    1
    >>> sm.allocate("r3", max_new_tokens=1) is None   # pool exhausted
    True
    >>> sm.release(0)
    >>> sm.allocate("r3", max_new_tokens=1)           # lowest free lane wins
    0
    >>> [s.request_id for s in sm.active()]
    ['r3', 'r2']
    >>> sm.num_free
    0
    """

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        self.slots = [Slot(i) for i in range(num_slots)]

    def allocate(self, request_id: Any, *, max_new_tokens: int = 0,
                 eos_id: int | None = None) -> int | None:
        """Claim the lowest free lane for ``request_id``; None if full."""
        for s in self.slots:
            if s.free:
                s.request_id = request_id
                s.generated = 0
                s.max_new_tokens = int(max_new_tokens)
                s.eos_id = eos_id
                return s.index
        return None

    def release(self, index: int) -> None:
        """Free a lane (request finished or evicted)."""
        self.reset(index)
        self.slots[index].request_id = None

    def reset(self, index: int) -> None:
        """Clear per-request counters; keeps the lane's assignment."""
        s = self.slots[index]
        s.generated = 0

    def active(self) -> list[Slot]:
        return [s for s in self.slots if not s.free]

    def free_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.free]

    @property
    def num_free(self) -> int:
        return len(self.free_slots())

    def __getitem__(self, index: int) -> Slot:
        return self.slots[index]

    def __len__(self) -> int:
        return len(self.slots)
