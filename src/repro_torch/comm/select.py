"""Model-driven strategy and BLOCKSIZE selection (closing the §5 loop).

The paper's performance models are quantitative enough to *predict* which
communication strategy wins for a given access pattern and topology.  This
module is the selection half of the autotuner (the hardware-calibration half,
``measure_hardware``, lives in ``repro_torch.core.tune`` — it is about the
machine, not about any one plan):

* ``rank_strategies`` feeds the exact ``CommPlan`` volume counts through the
  §5 formulas (``perfmodel.STRATEGY_PREDICTORS``) and sorts.
* ``choose_strategy`` returns the predicted-fastest runnable strategy.
* ``choose_blocksize`` sweeps BLOCKSIZE candidates through eq. 11 (the UPCv2
  model) using the cheap per-candidate block counts — the paper's Fig. 4
  BLOCKSIZE dial, turned by the model instead of by hand.

Every ranking is pure arithmetic over already-counted volumes: autotuning
costs a handful of closed-form evaluations plus the one-time calibration.

A copy of ``repro.comm.select`` for the port: the same rankings from the
same counts and ``HardwareParams``; where the reference calibrates a mesh
axis, the port calibrates one rank of a ``LoopbackComm``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.comm.plan import CommPlan, Topology, blockwise_block_counts

__all__ = ["rank_strategies", "choose_strategy", "choose_blocksize",
           "blocksize_sweep", "blocksize_candidates", "workload_from_plan"]


def _perfmodel():
    # function-level import: perfmodel lives in repro_torch.core (it is the
    # paper's §5 equations, not comm machinery) — importing lazily keeps the
    # comm → core layering acyclic
    from repro_torch.core import perfmodel
    return perfmodel


def _measure(comm, p: int):
    """The calibration for one rank of ``comm`` (``LoopbackComm(p)`` on
    the card when None)."""
    from repro_torch.core import tune
    if comm is None:
        from repro_torch.comm.communicator import LoopbackComm
        comm = LoopbackComm(p)
    return tune.measure_hardware(comm)


def workload_from_plan(plan, r_nz: int, *,
                       materialize: str | None = None,
                       dest_slots: int | None = None,
                       use_kernel: bool = False):
    """Build the §5 workload record for one plan.

    ``plan`` may be a gather ``CommPlan`` or a put-direction
    ``ScatterPlan`` (``CommPlan.transpose()``): both expose the same
    partitioning facts, and a scatter plan's ``counts`` already carry the
    send/recv-swapped volumes the put models price.

    ``materialize`` selects the gather unpack pricing: ``None`` keeps the
    paper's in-place unpack (eq. 15 as written), ``"full"`` adds the O(n)
    x_copy-assembly tax the functional unpack pays, ``"dest"`` prices
    the consumer-targeted O(slots + recv) unpack instead.  ``dest_slots``
    defaults to the plan's ``dest_len`` (the flattened ``Destination``
    size).

    ``use_kernel=True`` prices the fused CUDA pack/unpack variants of
    the compute terms (eqs. 14/15 and 14ᵀ/15ᵀ) instead of the jnp
    formulas — one HBM pass per element on each side of the wire.
    """
    pm = _perfmodel()
    if dest_slots is None and materialize == "dest":
        dest_slots = plan.dest_len
    return pm.SpmvWorkload(
        n=plan.n, r_nz=r_nz, p=plan.p, blocksize=plan.blocksize,
        topology=plan.topology, counts=plan.counts, m=plan.m,
        materialize=materialize, dest_slots=dest_slots,
        use_kernel=use_kernel)


def rank_strategies(
    plan,
    r_nz: int,
    hw,
    *,
    candidates=None,
    materialize: str | None = None,
    dest_slots: int | None = None,
    use_kernel: bool = False,
    direction: str = "get",
    scan_steps: int | None = None,
    overlap_credit: float = 0.0,
    plan_cost: float = 0.0,
    decode: bool = False,
) -> list[tuple[str, float]]:
    """[(strategy, predicted_seconds)] sorted fastest-first (§5 formulas).

    ``direction`` selects the model family: ``"get"`` prices the gather
    rungs (``perfmodel.STRATEGY_PREDICTORS``); ``"put"`` prices the push
    rungs (``perfmodel.PUT_STRATEGY_PREDICTORS`` — the same formulas with
    send/recv volumes swapped plus the accumulate-unpack term) and expects
    ``plan`` to be a ``ScatterPlan`` so the counts are already transposed.

    ``materialize`` / ``dest_slots`` thread the gather unpack-mode pricing
    through (see ``workload_from_plan``) so a consumer with a
    ``Destination`` descriptor ranks rungs by the targeted-unpack cost it
    will actually pay; ``use_kernel`` likewise prices the fused CUDA
    pack/unpack variants of the compute terms.

    ``scan_steps`` re-prices every rung as a steady-state LOOP of that
    many iterations inside one persistent scan window
    (``perfmodel.scan_loop_cost``: window setup paid once, per-iteration
    term thereafter, ``overlap_credit`` seconds of cross-step compute
    hidden per iteration) — the ranking a ``ScanSchedule`` resolves
    ``strategy="auto"`` stages on.  Loop scaling is monotone per rung but
    NOT order-preserving across rungs: a rung that wins one call on cheap
    setup can lose the loop once setup amortizes away.

    ``plan_cost`` is the §5 ``T_plan`` term (``perfmodel.plan_build_time``
    priced for however this exchange obtains its executor tables): a flat
    per-use addend applied AFTER any ``scan_steps`` loop scaling, because
    a plan is (re)built once per use of the plan — once per loop, not once
    per iteration.  It closes the "is replanning worth it this step?"
    question: rank once with the rebuild's ``T_plan`` and once with the
    reuse tier's, and compare (``perfmodel.replan_break_even_steps``).

    ``decode=True`` prices each rung for a token-by-token decode step
    (``perfmodel.predict_decode_exchange``: max of the β throughput model
    and the tiny-m α/latency floor, eqs. 12δ–15δ).  The floor can only
    raise a rung's prediction, so throughput-regime rankings are
    untouched — but at decode batch sizes the per-message τ terms decide
    the ladder, which is exactly what keeps ``strategy="auto"`` honest
    for serving workloads.
    """
    pm = _perfmodel()
    if direction not in ("get", "put"):
        raise ValueError(f"direction must be 'get' or 'put', got {direction!r}")
    w = workload_from_plan(plan, r_nz, materialize=materialize,
                           dest_slots=dest_slots, use_kernel=use_kernel)
    predictors = (pm.PUT_STRATEGY_PREDICTORS if direction == "put"
                  else pm.STRATEGY_PREDICTORS)
    names = tuple(candidates) if candidates else tuple(predictors)
    ranked = [(name, float(predictors[name](w, hw))) for name in names]
    if decode:
        ranked = [(name, pm.predict_decode_exchange(
            w, hw, strategy=name, direction=direction))
            for name, _ in ranked]
    if scan_steps is not None:
        setup = pm.window_setup_time(w.topology, hw)
        ranked = [(name, pm.scan_loop_cost(t, setup, scan_steps,
                                           overlap_credit=overlap_credit))
                  for name, t in ranked]
    if plan_cost:
        ranked = [(name, t + float(plan_cost)) for name, t in ranked]
    ranked.sort(key=lambda kv: kv[1])
    return ranked


def choose_strategy(
    plan,
    r_nz: int,
    *,
    hw=None,
    comm=None,
    candidates=None,
    materialize: str | None = None,
    dest_slots: int | None = None,
    direction: str = "get",
) -> str:
    """Predicted-fastest strategy for this plan on this hardware
    (``hw``, else measured for one rank of ``comm``, else of
    ``LoopbackComm(plan.p)`` on the card)."""
    if hw is None:
        hw = _measure(comm, plan.p)
    return rank_strategies(plan, r_nz, hw, candidates=candidates,
                           materialize=materialize, dest_slots=dest_slots,
                           direction=direction)[0][0]


def blocksize_candidates(shard_size: int, *, min_bs: int = 8) -> list[int]:
    """Power-of-two divisors of ``shard_size`` (plus shard_size itself)."""
    out = []
    bs = min_bs
    while bs < shard_size:
        if shard_size % bs == 0:
            out.append(bs)
        bs *= 2
    out.append(shard_size)
    return out


def blocksize_sweep(
    cols: np.ndarray,
    n: int,
    p: int,
    *,
    r_nz: int | None = None,
    topology: Topology | None = None,
    hw=None,
    candidates=None,
) -> list[tuple[int, float]]:
    """The full eq.-11 BLOCKSIZE sweep: ``[(blocksize, seconds), ...]``.

    For each candidate BLOCKSIZE the UPCv2 model needs only the per-shard
    needed-block counts (B_local / B_remote) — counted directly from the
    index set without building a full plan per candidate.  Small blocks
    shrink the whole-block volume tax; large blocks amortize per-message
    latency; eq. 11 prices both sides.  Candidates that do not divide the
    shard size are skipped; the list keeps candidate order so callers can
    inspect the sweep's shape (the Fig. 4 curve — how sharply the optimum
    is peaked tells you how much a skew-concentrated pattern punishes a
    mis-sized block).  ``choose_blocksize`` is this sweep's argmin.
    """
    pm = _perfmodel()
    cols = np.asarray(cols)
    if cols.ndim == 1:
        cols = cols[:, None]
    shard_size = n // p
    if topology is None:
        topology = Topology(p, p)
    if r_nz is None:
        r_nz = cols.shape[1]
    if hw is None:
        hw = _measure(None, p)
    if candidates is None:
        candidates = blocksize_candidates(shard_size)

    sweep: list[tuple[int, float]] = []
    for bs in candidates:
        if shard_size % bs:
            continue
        b_local, b_remote = blockwise_block_counts(cols, n, p, bs, topology)
        zeros = np.zeros(p, np.int64)
        counts = pm.GatherCounts(
            c_local_indv=zeros, c_remote_indv=zeros,
            b_local=b_local, b_remote=b_remote, blocksize=bs,
            s_local_out=zeros, s_remote_out=zeros,
            s_local_in=zeros, s_remote_in=zeros, c_remote_out=zeros,
            padded_condensed_per_shard=0, padded_blockwise_per_shard=0)
        w = pm.SpmvWorkload(n=n, r_nz=r_nz, p=p, blocksize=bs,
                            topology=topology, counts=counts,
                            m=cols.shape[0])
        sweep.append((int(bs), float(pm.predict_v2(w, hw))))
    assert sweep, "no candidate divides the shard size"
    return sweep


def choose_blocksize(
    cols: np.ndarray,
    n: int,
    p: int,
    *,
    r_nz: int | None = None,
    topology: Topology | None = None,
    hw=None,
    candidates=None,
) -> int:
    """Eq.-11-minimizing virtual block size for this access pattern (the
    argmin of ``blocksize_sweep`` — the paper's Fig. 4 BLOCKSIZE dial,
    turned by the model instead of by hand)."""
    sweep = blocksize_sweep(cols, n, p, r_nz=r_nz, topology=topology,
                            hw=hw, candidates=candidates)
    return min(sweep, key=lambda kv: kv[1])[0]
