"""Plan-source telemetry — where did each exchange's executor tables come from?

The paper's "one-time preparation step" (§4.3.1) stops being one-time the
moment the access pattern changes per batch: at traffic rates the question
"did this exchange pay a host plan build?" is the difference between a hot
path and a stall.  This module counts, per process, how every plan was
obtained:

* ``memory-hit``    — exact plan served from the in-process LRU;
* ``disk-hit``      — exact plan loaded from the persistent cache;
* ``bucket-reuse``  — a compatible cached *envelope* plan reused after the
  pattern's quantized stats matched (``plan_cache.get_envelope_plan``);
* ``device-derive`` — executor tables computed in-jit from the batch's
  routing (``comm.dynamic``), no host round-trip at all;
* ``host-build``    — the full O(nnz) host preparation step ran.

Build latency is accumulated per source so the §5 ``T_plan`` model
(``perfmodel.plan_build_time``) can be validated against what actually
happened.  The counters are surfaced as the ``telemetry`` block of
``BENCH_table3.json`` and asserted by the dynamic-MoE acceptance test
("N distinct routings, zero host builds after warmup").

Thread-safe like ``plan_cache.CacheStats`` (bump under a lock); tests use
``isolated()`` instead of mutating the module-global ``stats``.

Beyond the plan sources, a second counter group ticks the *serving loop*
(``TICK_KINDS``): the continuous-batching engine (``repro_torch.serve``) bumps
``decode_steps`` once per decode tick and ``prefill_chunks`` once
per prefill chunk, so "zero host plan-builds during steady-state decode"
is an assertable interval fact: snapshot, run N ticks, check
``since(snap)`` shows ``decode_steps >= N`` and ``host-build == 0``
(``decode_host_free`` packages exactly that).

>>> from repro_torch.comm import telemetry
>>> with telemetry.isolated() as t:
...     telemetry.record("host-build", seconds=0.25)   # warmup
...     snap = t.snapshot()
...     telemetry.record("device-derive")
...     telemetry.record("device-derive")
...     telemetry.record_tick("decode_steps")
>>> t.snapshot()["sources"]["device-derive"], t.snapshot()["sources"]["host-build"]
(2, 1)
>>> t.snapshot()["build_seconds"]["host-build"]
0.25
>>> t.host_free(warmup=1)   # after the 1-record warmup, no host builds
True
>>> delta = t.since(snap)
>>> delta["host-build"], delta["decode_steps"]
(0, 1)
>>> t.decode_host_free(snap)   # >=1 decode tick, 0 host builds since snap
True
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["PLAN_SOURCES", "TICK_KINDS", "PlanTelemetry", "stats", "record",
           "record_tick", "isolated"]

# Ordered from cheapest to most expensive way of obtaining a plan.
PLAN_SOURCES = ("memory-hit", "disk-hit", "bucket-reuse", "device-derive",
                "host-build")

# Sources that never touch the host O(nnz) preparation step after warmup.
HOT_PATH_SOURCES = ("memory-hit", "disk-hit", "bucket-reuse",
                    "device-derive")

# Serving-loop tick counters (repro_torch.serve): one bump per decode
# tick / per prefill chunk — the denominator for "zero host builds while
# the loop was actually decoding".
TICK_KINDS = ("decode_steps", "prefill_chunks")


class PlanTelemetry:
    """Per-exchange plan-source counters + accumulated build latency."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self.sources = {s: 0 for s in PLAN_SOURCES}
            self.build_seconds = {s: 0.0 for s in PLAN_SOURCES}
            self.ticks = {k: 0 for k in TICK_KINDS}
            self.events: list[str] = []   # sources in record order

    def record(self, source: str, seconds: float = 0.0) -> None:
        if source not in PLAN_SOURCES:
            raise ValueError(
                f"unknown plan source {source!r}; expected one of "
                f"{PLAN_SOURCES}")
        with self._lock:
            self.sources[source] += 1
            self.build_seconds[source] += float(seconds)
            self.events.append(source)

    def record_tick(self, kind: str, n: int = 1) -> None:
        """Bump a serving-loop counter (a ``TICK_KINDS`` name) by ``n``."""
        if kind not in TICK_KINDS:
            raise ValueError(
                f"unknown tick kind {kind!r}; expected one of {TICK_KINDS}")
        with self._lock:
            self.ticks[kind] += int(n)

    @property
    def total(self) -> int:
        return sum(self.sources.values())

    def snapshot(self) -> dict:
        """A deep, detached copy — safe to compare across later records."""
        with self._lock:
            return {
                "sources": dict(self.sources),
                "build_seconds": dict(self.build_seconds),
                "ticks": dict(self.ticks),
                "total": sum(self.sources.values()),
            }

    def since(self, snap: dict) -> dict:
        """Per-source (and per-tick-kind) deltas between ``snap`` (a
        ``snapshot()``) and now.  Pre-tick snapshots are accepted — missing
        keys count from 0."""
        cur = self.snapshot()
        out = {s: cur["sources"][s] - snap["sources"].get(s, 0)
               for s in PLAN_SOURCES}
        prev_ticks = snap.get("ticks", {})
        out.update({k: cur["ticks"][k] - prev_ticks.get(k, 0)
                    for k in TICK_KINDS})
        return out

    def decode_host_free(self, snap: dict) -> bool:
        """The serving acceptance criterion: since ``snap``, at least one
        decode tick ran and NO plan came from the host O(nnz) build."""
        delta = self.since(snap)
        return delta["decode_steps"] > 0 and delta["host-build"] == 0

    def host_free(self, warmup: int = 0) -> bool:
        """True when every record after the first ``warmup`` events came
        from a hot-path source (never ``host-build``) — the dynamic-MoE
        acceptance criterion."""
        with self._lock:
            tail = self.events[warmup:]
        return all(s in HOT_PATH_SOURCES for s in tail)


# Module-global telemetry; swap it out with ``isolated()`` in tests.
stats = PlanTelemetry()


def record(source: str, seconds: float = 0.0) -> None:
    """Record one plan acquisition on the active telemetry object."""
    stats.record(source, seconds)


def record_tick(kind: str, n: int = 1) -> None:
    """Bump a serving-loop tick counter on the active telemetry object."""
    stats.record_tick(kind, n)


@contextlib.contextmanager
def isolated():
    """Capture-safe scope: a fresh ``PlanTelemetry`` becomes the module
    global for the duration, the previous one is restored after — tests
    never mutate (or race on) the process-wide counters."""
    global stats
    prev = stats
    stats = PlanTelemetry()
    try:
        yield stats
    finally:
        stats = prev
