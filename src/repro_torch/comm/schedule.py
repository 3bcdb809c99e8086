"""ExchangeSchedule — chains of exchanges run as one planned window.

The paper optimizes one exchange at a time; real consumers issue *chains*
of them: SpMV ``y = A x`` followed by ``z = Aᵀ y``, a halo exchange before
every stencil step.  A ``Schedule`` declares the whole chain up front so
that ``compile`` resolves every stage against one shared context:

* one hardware-calibration memo hit (``exchange.measure_hw``) prices every
  ``strategy="auto"`` stage;
* each unique (pattern, blocksize) gets one destination-independent base
  ``CommPlan``, keyed by content (``plan_key``), shared by every stage over
  it — and, through ``plans=``, by other schedules; a plan not in
  ``plans`` comes from the persistent plan cache (``comm.plan_cache``);
* a scatter stage over a pattern that a sibling gather uses derives its
  ``ScatterPlan`` from that gather's base plan, never a second O(nnz)
  build;
* the §5 composition model (``perfmodel.predict_schedule``) prices the
  window from the stages' resolved rungs (``predicted_window``; a
  ``ScanSchedule`` also prices its loop, ``predicted_loop``) whenever
  hardware parameters are in scope: an ``"auto"`` stage, or ``hw=``.

The reference compiles the chain into one ``shard_map``; the port runs the
stages eagerly, in declaration order, on rank-stacked ``(P, ...)`` tensors
(``comm.communicator.LoopbackComm``; over a ``DistComm``, this process's
``p_local`` rows of every constant, input and stage value, the host plans
built alike in every process).  The handle protocol is the same: an
exchange stage *issues* its collective (``start_local``) when reached, and
its landed messages are delivered (``finish``) only when a later stage
first consumes them — every stage in between is enqueued while the
collective's copy runs on the communicator's side stream.  Stage order in
the builder is therefore the schedule: put the compute that should hide an
exchange *after* that exchange stage and *before* the stage that reads its
result.

Time loops: ``Schedule.scan`` runs the same stage pipeline as the body of
a Python loop (``ScanSchedule``), with plans resolved once for the whole
loop.  A ``gather(double_buffer=True)`` stage reads the delivery of the
exchange its ``feed()`` stage issued one iteration earlier, so the compute
of one iteration hides inside the window opened during the previous one.

``spec`` is a placement function here, not a ``PartitionSpec``.  A
``DynamicPattern`` stage degrades to its template (``_unwrap_dynamic``):
schedules resolve against host plans, and a per-batch consumer threads
``derive_plan_args`` through its own step (``models.moe.DynamicMoELayer``).

>>> import numpy as np, torch
>>> from repro_torch.comm.communicator import LoopbackComm
>>> from repro_torch.comm.pattern import AccessPattern
>>> comm = LoopbackComm(4, device="cpu")
>>> n = 64
>>> rng = np.random.default_rng(0)
>>> idx = rng.integers(0, n, size=(n, 3)).astype(np.int32)
>>> pattern = AccessPattern.from_indices(idx, n=n)
>>> sched = Schedule()
>>> x = sched.input("x")
>>> rows = sched.constant(idx)      # (n, 3) index table, row-sharded
>>> g = sched.gather(pattern, src=x)
>>> def take(xc, r):                # rank-stacked: xc (P, n + 1), r (P, 16, 3)
...     ranks = torch.arange(xc.shape[0])[:, None, None]
...     return xc[ranks, r].sum(-1)
>>> y = sched.compute(take, g, rows)
>>> step = sched.compile(comm, strategy="condensed", blocksize=8)
>>> xv = rng.standard_normal(n).astype(np.float32)
>>> out = step(step.shard_input(xv)).reshape(-1).numpy()
>>> bool(np.allclose(out, xv[idx].sum(-1), rtol=1e-5))
True
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.comm import plan_cache
from repro_torch.comm import select
from repro_torch.comm import strategies as strat
from repro_torch.comm.dynamic import DynamicPattern
from repro_torch.comm.exchange import measure_hw
from repro_torch.comm.gather import IrregularGather
from repro_torch.comm.pattern import AccessPattern
from repro_torch.comm.plan import Topology
from repro_torch.comm.scatter import IrregularScatter

__all__ = ["Schedule", "ExchangeSchedule", "ScanSchedule", "StageRef",
           "plan_key"]


def plan_key(pattern: AccessPattern, p: int, blocksize: int | None,
             topology: Topology) -> tuple:
    """The content key of a base plan: the pattern's digest, the rank
    count, the blocksize (None means one block per shard, as
    ``build_comm_plan`` defaults) and the topology."""
    bs = pattern.n // p if blocksize is None else int(blocksize)
    return (pattern.digest, p, bs, topology)


def _unwrap_dynamic(pattern) -> AccessPattern:
    """Schedules resolve stages against host plans, so a ``DynamicPattern``
    degrades to its template here (per-batch device-derived tables need
    the consumer to thread ``derive_plan_args`` through its own step — see
    ``models.moe.DynamicMoELayer``)."""
    if isinstance(pattern, DynamicPattern):
        return pattern.template
    return pattern


def _place(value, spec, comm) -> torch.Tensor:
    """A host value as a rank-stacked tensor on ``comm``'s device: ``spec``
    None splits dim 0 over the ``comm.p`` ranks, a callable maps the host
    array to its ``(P, ...)`` layout; then this process's rows of it
    (``comm.local_rows``: all P on a ``LoopbackComm``)."""
    p = comm.p
    arr = np.asarray(value)
    if spec is None:
        if arr.shape[0] % p:
            raise ValueError(f"dim 0 ({arr.shape[0]}) does not split over "
                             f"{p} ranks")
        arr = arr.reshape((p, -1) + arr.shape[1:])
    else:
        arr = np.asarray(spec(arr))
        if arr.shape[0] != p:
            raise ValueError(f"spec placed {arr.shape[0]} rows, not {p}")
    return torch.as_tensor(np.ascontiguousarray(
        arr[comm.local_rows])).to(comm.device)


@dataclasses.dataclass(frozen=True)
class StageRef:
    """Symbolic handle to one stage's output inside a ``Schedule``."""

    sid: int
    kind: str
    name: str
    owner: int = 0      # id() of the owning Schedule — refs don't cross


class _Stage:
    """Builder-side record of one stage (mutable until compile)."""

    def __init__(self, sid: int, kind: str, name: str, owner: int, **kw):
        self.sid = sid
        self.kind = kind
        self.name = name
        self.owner = owner
        self.__dict__.update(kw)

    @property
    def ref(self) -> StageRef:
        return StageRef(self.sid, self.kind, self.name, self.owner)


class Schedule:
    """Declarative builder for an ``ExchangeSchedule`` / ``ScanSchedule``.

    Build stages in execution order (the order IS the pipeline schedule),
    then ``compile(comm, strategy=...)``::

        sched = Schedule()
        h = sched.gather(pattern, destination=dest)
        y = sched.compute(expert_fn, h, weights)
        sched.scatter(pattern, y, reduce="add")
        step = sched.compile(comm, strategy="condensed")

    Every compute function takes and returns rank-stacked ``(P, ...)``
    tensors.  ``resolve`` may be called before ``compile`` to read the
    resolved exchanges (``exchange_of``) or to share the base plans.
    """

    def __init__(self):
        self._stages: list[_Stage] = []
        self._ctx: dict | None = None       # set by resolve()
        self._exchanges: dict[int, Any] = {}
        self._compiled = False

    # ---- builder surface ----
    def _add(self, kind: str, name: str | None, **kw) -> StageRef:
        if self._compiled:
            raise RuntimeError("schedule already compiled")
        sid = len(self._stages)
        name = name or f"{kind}{sid}"
        if any(s.name == name for s in self._stages):
            raise ValueError(
                f"duplicate stage name {name!r} — names key the "
                ".strategies reporting, so each stage needs its own")
        st = _Stage(sid, kind, name, id(self), **kw)
        self._stages.append(st)
        return st.ref

    def _check_ref(self, ref, *, array_valued: bool = False) -> StageRef:
        if not isinstance(ref, StageRef):
            raise TypeError(
                f"stage arguments must be StageRefs, got {type(ref).__name__}")
        if ref.owner != id(self):
            raise ValueError(
                f"stage ref {ref.name!r} belongs to a different Schedule "
                "— refs cannot cross builders")
        st = self._stages[ref.sid]
        if array_valued and st.kind == "gather" and st.destination is not None:
            raise ValueError(
                f"stage {st.name!r} delivers named Destination slots (a "
                "dict); wrap it in a compute stage that selects/combines "
                "the slots before feeding an exchange")
        return ref

    def input(self, name: str | None = None, *, spec=None) -> StageRef:
        """Declare an external operand of the compiled step (call-time
        positional argument, in declaration order), a rank-stacked tensor.
        ``spec`` says how ``shard_input`` places a host value: None splits
        dim 0 over the ranks, a callable maps the host array to its ``(P,
        ...)`` layout."""
        return self._add("input", name, spec=spec)

    def constant(self, value, name: str | None = None, *, spec=None,
                 replicated: bool = False) -> StageRef:
        """Bind a fixed array operand (matrix values, index tables).  It is
        placed on the device once, at compile time: dim 0 split over the
        ranks (default), by a ``spec`` placement function, or — with
        ``replicated=True`` — the whole value for every rank."""
        if replicated and spec is not None:
            raise ValueError("pass spec OR replicated, not both")
        return self._add("constant", name, value=value, spec=spec,
                         replicated=replicated)

    def gather(self, pattern: AccessPattern, *, src: StageRef | None = None,
               destination=None, dest_slots: int | None = None,
               strategy: str | None = None,
               blocksize=None, use_kernel: bool | None = None,
               finish_kwargs: dict | None = None,
               double_buffer: bool = False, prime: StageRef | None = None,
               name: str | None = None) -> StageRef:
        """Pull stage: deliver ``pattern``'s elements of the ``src`` value
        (default: the first declared input, declared here if absent).

        The stage value is the ``{name: (P, *slots)}`` dict with a
        ``destination``, else every rank's full ``x_copy``.  ``strategy`` /
        ``blocksize`` / ``use_kernel`` override the schedule defaults per
        stage; ``finish_kwargs`` are forwarded to ``OverlapHandle.finish``
        (``extra_slots=`` / ``copy_own=``); ``dest_slots`` is the slot count
        an ``"auto"`` stage prices for a callable ``destination``.

        ``double_buffer=True`` (only under ``Schedule.scan``): the stage's
        value is the delivery of the exchange issued by this schedule's
        matching ``feed()`` stage one iteration EARLIER, so the compute of
        iteration k+1 hides inside the window opened during iteration k.
        Such a stage has no in-body ``src``; ``prime=`` names the
        exchange-free stage whose value seeds iteration 0's exchange
        before the loop starts."""
        if double_buffer:
            if src is not None:
                raise ValueError(
                    "a double_buffer gather has no in-body src: its value "
                    "is the delivery of the exchange issued by feed() one "
                    "iteration earlier — pass prime= (the stage seeding "
                    "iteration 0) and add a feed() stage instead")
            if prime is None:
                raise ValueError(
                    "double_buffer=True needs prime= — the stage whose "
                    "value seeds iteration 0's exchange in the scan "
                    "prologue (it must not depend on any exchange stage)")
            src = prime
        elif prime is not None:
            raise ValueError("prime= only applies to double_buffer=True")
        elif src is None:
            src = next((s.ref for s in self._stages if s.kind == "input"),
                       None)
            if src is None:
                src = self.input()
        self._check_ref(src, array_valued=True)
        pattern = _unwrap_dynamic(pattern)
        return self._add("gather", name, pattern=pattern, src=src,
                         destination=destination, dest_slots=dest_slots,
                         strategy=strategy,
                         blocksize=blocksize, use_kernel=use_kernel,
                         double_buffer=double_buffer,
                         finish_kwargs=dict(finish_kwargs or {}))

    def compute(self, fn: Callable, *args: StageRef,
                name: str | None = None) -> StageRef:
        """Local compute stage: ``fn(*values)`` on the referenced stages'
        rank-stacked values.  A compute stage placed after an exchange
        stage but before anything consumes that exchange runs inside its
        window."""
        for a in args:
            self._check_ref(a)
        return self._add("compute", name, fn=fn, args=tuple(args))

    def feed(self, gather: StageRef, src: StageRef, *,
             name: str | None = None) -> StageRef:
        """Issue the NEXT iteration's exchange of a ``double_buffer``
        gather stage (only under ``Schedule.scan``).

        ``src``'s value — typically this iteration's refreshed operand — is
        packed and sent where the feed stage sits in the pipeline; the
        delivery becomes the gather stage's value next iteration.  Every
        stage between the feed and the gather's first consumer next
        iteration runs inside the collective's window.  The last
        iteration's feed issues one exchange whose delivery is finished
        and dropped."""
        self._check_ref(gather)
        g = self._stages[gather.sid]
        if g.kind != "gather" or not g.double_buffer:
            raise ValueError(
                "feed() targets a gather(double_buffer=True, ...) stage; "
                f"{g.name!r} is not one")
        self._check_ref(src, array_valued=True)
        if any(s.kind == "feed" and s.gather.sid == gather.sid
               for s in self._stages):
            raise ValueError(
                f"stage {g.name!r} already has a feed() stage — a "
                "double-buffer depth of one carries exactly one in-flight "
                "exchange")
        return self._add("feed", name, gather=gather, src=src)

    def scatter(self, pattern: AccessPattern, src: StageRef, *,
                reduce: str = "add", strategy: str | None = None,
                blocksize=None, use_kernel: bool | None = None,
                name: str | None = None) -> StageRef:
        """Push stage: ``src``'s value is the ``(P, rows, r, ...)``
        contribution table; the stage value is the combined owned slice
        ``(P, shard, ...)``.  A pattern already gathered by a sibling stage
        reuses its base plan (the scatter tables are a transpose-derived
        delta)."""
        self._check_ref(src, array_valued=True)
        if reduce not in strat.SCATTER_REDUCES:
            raise ValueError(f"reduce must be one of {strat.SCATTER_REDUCES}")
        pattern = _unwrap_dynamic(pattern)
        return self._add("scatter", name, pattern=pattern, src=src,
                         reduce=reduce, strategy=strategy,
                         blocksize=blocksize, use_kernel=use_kernel)

    # ---- resolution (shared exchange-core context) ----
    def _exchange_stages(self) -> list[_Stage]:
        return [s for s in self._stages if s.kind in ("gather", "scatter")]

    def resolve(self, comm, *, strategy: str = "auto", blocksize=None,
                use_kernel: bool = False, topology: Topology | None = None,
                shards_per_node: int | None = None, hw=None,
                use_plan_cache: bool = True, scan_steps: int | None = None,
                plans: dict | None = None) -> "Schedule":
        """Resolve every exchange stage over ``comm``'s ranks against one
        shared context: one ``measure_hw`` memo hit for every ``"auto"``
        stage, one base plan per unique (pattern, blocksize), ScatterPlans
        derived from the sibling gather's base plan.

        ``use_kernel`` is the schedule-wide default for the CUDA pack /
        unpack / fold kernels (each stage's own ``use_kernel=`` wins when
        set); ``"auto"`` stages are priced with the kernelized compute terms
        so the ranking matches what the window runs.  ``scan_steps`` (set
        by ``Schedule.scan(n_steps_hint=...)``) makes every ``"auto"`` stage
        rank rungs on the n-step steady-state loop cost
        (``perfmodel.scan_loop_cost``) instead of the single-call cost.
        ``plans`` is a dict, keyed by ``plan_key`` (and ``("put", key)``
        for ScatterPlans), that resolve reads before acquiring a plan
        (through the plan cache unless ``use_plan_cache=False``) and fills
        with what it acquires: pass one dict to several schedules to share
        their plans.  Call it explicitly when a later stage's shape depends
        on a resolved rung (``strategy_of(ref)``)."""
        if self._ctx is not None:
            raise RuntimeError("schedule already resolved")
        exchanges = self._exchange_stages()
        if not exchanges:
            raise ValueError("a schedule needs at least one exchange stage")
        p = comm.p
        if topology is None:
            topology = Topology(p, shards_per_node or p)
        needs_hw = any((s.strategy or strategy) == "auto"
                       or (s.blocksize if s.blocksize is not None
                           else blocksize) == "auto"
                       for s in exchanges)
        if needs_hw and hw is None:
            hw = measure_hw(comm)   # ONE memo hit for all stages
        plans = {} if plans is None else plans
        for st in exchanges:
            bs = st.blocksize if st.blocksize is not None else blocksize
            if bs == "auto":
                bs = select.choose_blocksize(
                    st.pattern.indices, st.pattern.n, p, topology=topology,
                    hw=hw)
            key = plan_key(st.pattern, p, bs, topology)
            if key not in plans:
                plans[key] = plan_cache.get_comm_plan(
                    st.pattern.indices, st.pattern.n, p, blocksize=bs,
                    topology=topology, cache=use_plan_cache)
            kwargs = dict(
                strategy=st.strategy if st.strategy is not None else strategy,
                topology=topology, hw=hw, use_plan_cache=use_plan_cache,
                base_plan=plans[key], scan_steps=scan_steps,
                use_kernel=(st.use_kernel if st.use_kernel is not None
                            else use_kernel))
            if st.kind == "gather":
                ex = IrregularGather(st.pattern, comm,
                                     destination=st.destination,
                                     dest_slots=st.dest_slots, **kwargs)
            else:
                put_key = ("put", key)
                if put_key not in plans:
                    plans[put_key] = plan_cache.get_scatter_plan(
                        st.pattern.indices, st.pattern.n, p,
                        blocksize=plans[key].blocksize, topology=topology,
                        base=plans[key], cache=use_plan_cache)
                ex = IrregularScatter(st.pattern, comm, reduce=st.reduce,
                                      scatter_plan=plans[put_key], **kwargs)
            self._exchanges[st.sid] = ex
        self._ctx = dict(comm=comm, topology=topology, plans=plans, hw=hw,
                         default_strategy=strategy)
        return self

    def exchange_of(self, ref: StageRef):
        """The resolved ``IrregularGather``/``IrregularScatter`` behind one
        exchange stage (available after ``resolve``)."""
        if self._ctx is None:
            raise RuntimeError("call resolve()/compile() first")
        return self._exchanges[ref.sid]

    def strategy_of(self, ref: StageRef) -> str:
        """The resolved rung of one exchange stage."""
        return self.exchange_of(ref).strategy

    def _stage_specs(self):
        """Per-exchange-stage §5 pricing specs: the ``(name, direction,
        workload, strategy)`` rows ``perfmodel.predict_schedule`` /
        ``predict_scan_schedule`` consume (available after ``resolve``)."""
        specs = []
        for st in self._exchange_stages():
            ex = self._exchanges[st.sid]
            if st.kind == "gather":
                materialize = "dest" if ex.destination is not None else None
                dest_slots = (ex.destination.num_slots
                              if ex.destination is not None else None)
                w = select.workload_from_plan(
                    ex.plan, st.pattern.r, materialize=materialize,
                    dest_slots=dest_slots, use_kernel=ex.use_kernel)
                specs.append((st.name, "get", w, ex.strategy))
            else:
                w = select.workload_from_plan(ex.splan, st.pattern.r,
                                              use_kernel=ex.use_kernel)
                specs.append((st.name, "put", w, ex.strategy))
        return specs

    def _predict_window(self):
        """§5 fused-window composition for the resolved rungs (None when
        no hardware parameters are in scope)."""
        hw = self._ctx["hw"]
        if hw is None:
            return None
        from repro_torch.core import perfmodel as pm
        return pm.predict_schedule(self._stage_specs(), hw)

    @property
    def plans(self) -> dict:
        """The base plans (and ScatterPlans) the stages resolved against,
        keyed as ``resolve``'s ``plans=``."""
        if self._ctx is None:
            raise RuntimeError("call resolve()/compile() first")
        return self._ctx["plans"]

    def _finish_build(self, comm, resolve_kw):
        if self._compiled:
            raise RuntimeError("schedule already compiled")
        if self._ctx is None:
            if comm is None:
                raise ValueError("compile() needs a communicator (or "
                                 "resolve())")
            self.resolve(comm, **resolve_kw)
        else:
            if comm is not None and comm is not self._ctx["comm"]:
                raise ValueError(
                    "schedule was resolved on a different communicator")
            if resolve_kw:
                raise ValueError(
                    "schedule already resolved — these compile() keywords "
                    f"would be silently ignored: {sorted(resolve_kw)}; "
                    "pass them to resolve() instead")

    # ---- finalization ----
    def compile(self, comm=None, *, output=None,
                **resolve_kw) -> "ExchangeSchedule":
        """Finalize into an ``ExchangeSchedule`` whose stages pipeline
        through the handle protocol.

        ``output`` picks the stage whose value the step returns (default:
        the last stage; must be array-valued) — a tuple of refs makes the
        step return the matching tuple.  ``comm`` and the remaining
        keywords are forwarded to ``resolve`` unless it already ran."""
        bad = [s.name for s in self._stages
               if (s.kind == "feed"
                   or (s.kind == "gather" and s.double_buffer))]
        if bad:
            raise ValueError(
                f"stages {bad} double-buffer across iterations; a one-shot "
                "compile() has no previous iteration to carry the delivery "
                "from — build them through Schedule.scan() instead")
        self._finish_build(comm, resolve_kw)
        if output is None:
            output = self._stages[-1].ref
        single = not isinstance(output, (tuple, list))
        outputs = (output,) if single else tuple(output)
        for o in outputs:
            self._check_ref(o, array_valued=True)
        self._compiled = True
        return ExchangeSchedule(self, outputs, single=single)

    def scan(self, comm=None, *, carry, output,
             n_steps_hint: int | None = None,
             **resolve_kw) -> "ScanSchedule":
        """Finalize into a ``ScanSchedule``: the stage pipeline becomes the
        body of a time loop, with plans resolved once for the whole loop.

        ``carry`` — every declared input stage, as a tuple of refs in call
        order (a bare ref for a single carry); ``output`` — a matching
        tuple: the stage whose value becomes the corresponding carry next
        iteration (and the loop's final result).  ``n_steps_hint`` prices
        ``strategy="auto"`` stages on the hinted steady-state loop cost
        (setup amortized) instead of the single-call cost.  The compiled
        object is called as ``scan(*carries, n_steps=k)``."""
        single = not isinstance(carry, (tuple, list))
        carry = (carry,) if single else tuple(carry)
        output = (output,) if not isinstance(output, (tuple, list)) \
            else tuple(output)
        if self._ctx is None:
            resolve_kw.setdefault("scan_steps", n_steps_hint)
        self._finish_build(comm, resolve_kw)
        self._compiled = True
        return ScanSchedule(self, carry, output, single=single,
                            n_steps_hint=n_steps_hint)


def _bind_operands(stages, exchanges, comm) -> dict[int, tuple]:
    """Each stage's bound operands, by stage id: a constant's placed tensor
    (this process's rows; a replicated one expanded to them) or an
    exchange's device plan arrays."""
    bound: dict[int, tuple] = {}
    for st in stages:
        if st.kind == "constant":
            if st.replicated:
                t = torch.as_tensor(np.ascontiguousarray(
                    np.asarray(st.value))).to(comm.device)
                t = t.expand((comm.p_local,) + tuple(t.shape))
            else:
                t = _place(st.value, st.spec, comm)
            bound[st.sid] = (t,)
            st.value = None   # free the host copy
        elif st.kind in ("gather", "scatter"):
            bound[st.sid] = tuple(exchanges[st.sid].plan_args)
    return bound


def _run_stages(stages, exchanges, bound, input_pos, inputs, *,
                db_vals=None, prologue=False):
    """Run the stage pipeline once (one step, one scan body, or — with
    ``prologue=True`` — the exchange-free prefix that seeds a scan's
    double-buffer carries).

    Returns ``(force, feeds)``: ``force(sid)`` delivers a stage's value,
    finishing any exchange it consumes lazily so that everything scheduled
    between issue and first consumption is enqueued inside the collective's
    window; ``feeds`` maps each double-buffer gather to the pending
    delivery its ``feed()`` stage issued this body — the next iteration's
    carries, still in flight."""
    env: dict[int, Any] = {}
    pending: dict[int, Callable[[], Any]] = {}
    feeds: dict[int, Callable[[], Any]] = {}

    def force(sid):
        if sid in pending:
            env[sid] = pending.pop(sid)()
        return env[sid]

    def finish_of(handle, finish_kwargs):
        if finish_kwargs:
            return lambda h=handle, kw=finish_kwargs: h.finish(**kw)
        return handle.finish

    for st in stages:
        if st.kind == "input":
            env[st.sid] = inputs[input_pos[st.sid]]
        elif st.kind == "constant":
            (env[st.sid],) = bound[st.sid]
        elif prologue:
            continue   # compute stages on demand below; no exchange runs
        elif st.kind == "compute":
            env[st.sid] = st.fn(*[force(a.sid) for a in st.args])
        elif st.kind == "feed":
            # issue the NEXT iteration's exchange of a double-buffer gather
            g = stages[st.gather.sid]
            handle = exchanges[g.sid].start_local(force(st.src.sid),
                                                  *bound[g.sid])
            feeds[g.sid] = finish_of(handle, g.finish_kwargs)
            env[st.sid] = ()
        elif st.kind == "gather" and st.double_buffer:
            # delivered by the previous iteration's feed(), finished when
            # first consumed
            pending[st.sid] = db_vals[st.sid]
        else:
            # exchange stage: ISSUE the collective now; deliver (finish)
            # lazily when a later stage consumes it
            handle = exchanges[st.sid].start_local(force(st.src.sid),
                                                   *bound[st.sid])
            pending[st.sid] = finish_of(
                handle, st.finish_kwargs if st.kind == "gather" else None)

    if prologue:
        def force_prologue(sid):
            if sid not in env:
                st = stages[sid]
                assert st.kind == "compute", st.kind   # checked at build
                env[sid] = st.fn(*[force_prologue(a.sid) for a in st.args])
            return env[sid]
        return force_prologue, None
    return force, feeds


class _Compiled:
    """What ``ExchangeSchedule`` and ``ScanSchedule`` share: the resolved
    context, the bound operands and the placement of host inputs."""

    def __init__(self, sched: Schedule, input_sids: list[int]):
        ctx = sched._ctx
        self.comm = ctx["comm"]
        self.topology = ctx["topology"]
        self.plans = ctx["plans"]
        self.hw = ctx["hw"]
        self._stages = sched._stages
        self._exchanges = sched._exchanges
        stages = self._stages
        self.strategies = {st.name: self._exchanges[st.sid].strategy
                           for st in stages
                           if st.kind in ("gather", "scatter")}
        self.predicted_times = {
            st.name: self._exchanges[st.sid].predicted_times
            for st in stages if st.kind in ("gather", "scatter")}
        self.predicted_window = sched._predict_window()
        self._pricing_specs = sched._stage_specs()
        self._bound = _bind_operands(stages, self._exchanges, self.comm)
        self._input_sids = input_sids
        self._input_pos = {sid: i for i, sid in enumerate(input_sids)}

    def shard_input(self, value, which: int = 0) -> torch.Tensor:
        """Place a host value on the device with input ``which``'s spec."""
        st = self._stages[self._input_sids[which]]
        return _place(value, st.spec, self.comm)

    # the SpMV-flavored alias every front door exposes
    def shard_vector(self, value) -> torch.Tensor:
        return self.shard_input(value, 0)


class ExchangeSchedule(_Compiled):
    """A compiled multi-exchange step: ``step(*inputs)`` runs every stage
    once, inputs in declaration order, each a rank-stacked tensor (placed
    like ``shard_input`` does).

    * ``.strategies`` — resolved rung per exchange stage;
    * ``.plans`` — the base plans the stages share (``Schedule.resolve``);
    * ``.predicted_times`` — per-stage §5 rung rankings (``None`` for a
      stage on a fixed rung);
    * ``.predicted_window`` — the fused-window composition prediction
      (``perfmodel.predict_schedule``), ``None`` when no hardware
      parameters were in scope (every stage on a fixed rung, no ``hw=``).
    """

    def __init__(self, sched: Schedule, outputs: tuple, single: bool = True):
        super().__init__(sched, [st.sid for st in sched._stages
                                 if st.kind == "input"])
        self._outputs = outputs
        self._single = single

    def __call__(self, *inputs):
        if len(inputs) != len(self._input_sids):
            raise TypeError(f"the step takes {len(self._input_sids)} "
                            f"inputs, got {len(inputs)}")
        force, _ = _run_stages(self._stages, self._exchanges, self._bound,
                               self._input_pos, inputs)
        vals = tuple(force(o.sid) for o in self._outputs)
        return vals[0] if self._single else vals


def _exchange_free(stages, sid) -> bool:
    """True when stage ``sid``'s ancestry contains no exchange/feed stage
    (so the scan prologue can evaluate it from the initial carries)."""
    st = stages[sid]
    if st.kind in ("gather", "scatter", "feed"):
        return False
    if st.kind == "compute":
        return all(_exchange_free(stages, a.sid) for a in st.args)
    return True


class ScanSchedule(_Compiled):
    """A compiled time loop: ``scan(*carries, n_steps=k)`` runs the stage
    pipeline ``k`` times, plans resolved once.

    Carry contract: every ``input`` stage is a loop carry; iteration
    outputs (the ``output=`` refs passed to ``Schedule.scan``) become the
    next iteration's inputs, and the call returns the final carries (a
    bare tensor when a single carry was declared).

    Double-buffer contract: a ``gather(double_buffer=True, prime=...)``
    stage reads the delivery of the exchange issued by its ``feed()`` stage
    one iteration earlier; that delivery stays in flight across the
    iteration boundary and is finished when the next iteration first
    consumes it.  The prologue issues iteration 0's exchange from
    ``prime`` (evaluated on the initial carries); the last iteration's
    feed issues one exchange that is finished and dropped.

    * ``.strategies`` / ``.predicted_times`` / ``.predicted_window`` — as
      on ``ExchangeSchedule``;
    * ``.predicted_loop(n_steps)`` — the eq.-23 steady-state extension
      (``perfmodel.predict_scan_schedule``): setup paid once, per-iteration
      window terms thereafter; ``None`` without hardware parameters.
    """

    def __init__(self, sched: Schedule, carry: tuple, outputs: tuple, *,
                 single: bool, n_steps_hint: int | None = None):
        self.n_steps_hint = n_steps_hint
        stages = sched._stages
        for c in carry:
            sched._check_ref(c)
            if c.kind != "input":
                raise ValueError(
                    f"carry refs must be input stages; {c.name!r} is a "
                    f"{c.kind} stage")
        input_sids = [st.sid for st in stages if st.kind == "input"]
        if sorted(c.sid for c in carry) != sorted(input_sids):
            raise ValueError(
                "carry= must name every input stage exactly once (each "
                "input is re-fed from its paired output every iteration)")
        if len(outputs) != len(carry):
            raise ValueError(
                f"output= must pair one stage per carry ({len(carry)} "
                f"carries, {len(outputs)} outputs)")
        for o in outputs:
            sched._check_ref(o, array_valued=True)
        self._db_stages = [st for st in stages
                           if st.kind == "gather" and st.double_buffer]
        fed = {st.gather.sid for st in stages if st.kind == "feed"}
        for st in self._db_stages:
            if st.sid not in fed:
                raise ValueError(
                    f"double_buffer stage {st.name!r} has no feed() stage "
                    "— nothing would issue its next-iteration exchange")
            if not _exchange_free(stages, st.src.sid):
                raise ValueError(
                    f"prime stage of {st.name!r} depends on an exchange "
                    "stage; the scan prologue runs before any exchange, "
                    "so prime ancestry must be input/constant/compute only")
        # inputs arrive in CARRY order (the call order)
        super().__init__(sched, [c.sid for c in carry])
        self._outputs = outputs
        self._single = single

    def predicted_loop(self, n_steps: int, *,
                       overlap_credit: float = 0.0) -> dict | None:
        """§5 steady-state loop pricing (``perfmodel.
        predict_scan_schedule``): setup paid once, ``n_steps`` per-iteration
        window terms, ``overlap_credit`` seconds of cross-step compute
        hidden per iteration by double-buffered stages.  ``None`` when no
        hardware parameters were in scope at resolve time."""
        if self.hw is None:
            return None
        from repro_torch.core import perfmodel as pm
        return pm.predict_scan_schedule(self._pricing_specs, self.hw,
                                        n_steps,
                                        overlap_credit=overlap_credit)

    def __call__(self, *carries, n_steps: int):
        if len(carries) != len(self._input_sids):
            raise TypeError(f"the loop takes {len(self._input_sids)} "
                            f"carries, got {len(carries)}")
        stages, exchanges, bound = self._stages, self._exchanges, self._bound
        user = tuple(carries)
        db: dict[int, Callable[[], Any]] = {}
        if self._db_stages:
            # prologue: issue each double-buffer gather's first exchange
            # from its prime value on the initial carries
            force0, _ = _run_stages(stages, exchanges, bound,
                                    self._input_pos, user, prologue=True)
            for st in self._db_stages:
                handle = exchanges[st.sid].start_local(force0(st.src.sid),
                                                       *bound[st.sid])
                kw = st.finish_kwargs
                db[st.sid] = ((lambda h=handle, kw=kw: h.finish(**kw))
                              if kw else handle.finish)
        for _ in range(n_steps):
            force, db = _run_stages(stages, exchanges, bound,
                                    self._input_pos, user, db_vals=db)
            user = tuple(force(o.sid) for o in self._outputs)
        for finish in db.values():
            finish()     # the last feed's delivery: finished and dropped
        return user[0] if self._single else user
