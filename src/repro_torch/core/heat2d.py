"""2D heat equation on a uniform mesh — the paper's §8 validation workload.

The global M×N field is partitioned over an (mprocs × nprocs) grid of ranks,
exactly like the paper's UPC code: rank ``r = ip*nprocs + kp`` owns the
(m_loc × n_loc) tile at grid position (ip, kp); every step exchanges four
halo sides and then applies the 5-point Jacobi update.  The field is one
rank-stacked tensor ``(P, m_loc, n_loc)`` (``shard_field`` /
``gather_field`` convert from and to the global array).

The halo exchange is a consumer of ``repro_torch.comm``: the stencil
neighborhood is an ``AccessPattern`` (``AccessPattern.from_stencil5``) over
the tile-major flattening of the field, and the per-step exchange + stencil
is a ``Schedule`` — a gather stage planned over all ``P`` ranks, an
interior compute stage scheduled inside its window (when the split runs),
and the halo-consuming update stage.  The condensed plan works out to
exactly the four halo strips (the paper's ``halo_exchange_intrinsic``), but
any rung of the ladder applies.

Ranks at the grid boundary read guaranteed-zero slots, which is harmless:
the update is masked to the global interior, reproducing the paper's
"boundary rows/cols are copied" semantics.

``materialize="dest"`` (default) lands each exchange straight in the four
halo strips (a ``Destination``: O(perimeter) unpack work);
``materialize="full"`` assembles the paper's full-length
``mythread_x_copy`` and indexes the strips out of it — bit-identical,
O(area) buffer traffic per step.

``overlap=True`` (or ``strategy="overlap"``) splits each step: the
tile-interior update (no halo dependency) runs while the exchange is in
flight; only the one-cell edge ring consumes the landed halos.  ``run``
loops through a ``ScanSchedule``; on the split it scans the double-buffered
body, whose next exchange is issued before this step's interior stencil.

``use_kernel=True`` runs every stencil through the CUDA kernel
(``kernels.ops.stencil2d``) and the exchange through the pack / unpack
kernels; the reference's flag swaps the stencil only (its exchange stays
plain, which is bit-identical).  ``strategy="auto"`` ranks the rungs on the
full per-step window (``heat2d_predicted_times``): the Heat2D window models
for condensed / overlap, the generic §5 exchange models for replicate /
blockwise shifted onto the window scale.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm import plan_cache, select
from repro_torch.comm.exchange import measure_hw
from repro_torch.comm.pattern import AccessPattern, Destination
from repro_torch.comm.plan import CommPlan, Topology
from repro_torch.comm.schedule import Schedule, plan_key
from repro_torch.core import perfmodel as pm
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["Heat2D", "heat2d_predicted_times"]


def _halo_indices(big_m, big_n, mprocs, nprocs, zero_slot):
    """Per-rank global ids of the four incoming halo strips (tile-major
    layout, see AccessPattern.from_stencil5); out-of-domain -> zero_slot."""
    m_loc, n_loc = big_m // mprocs, big_n // nprocs
    tile = m_loc * n_loc
    p = mprocs * nprocs
    up = np.full((p, n_loc), zero_slot, np.int32)
    down = np.full((p, n_loc), zero_slot, np.int32)
    left = np.full((p, m_loc), zero_slot, np.int32)
    right = np.full((p, m_loc), zero_slot, np.int32)
    cols = np.arange(n_loc)
    rows = np.arange(m_loc)
    for ip in range(mprocs):
        for kp in range(nprocs):
            r = ip * nprocs + kp
            if ip > 0:      # neighbor above sends its last row
                up[r] = (r - nprocs) * tile + (m_loc - 1) * n_loc + cols
            if ip < mprocs - 1:  # neighbor below sends its first row
                down[r] = (r + nprocs) * tile + cols
            if kp > 0:      # left neighbor sends its last column
                left[r] = (r - 1) * tile + rows * n_loc + (n_loc - 1)
            if kp < nprocs - 1:  # right neighbor sends its first column
                right[r] = (r + 1) * tile + rows * n_loc
    return up, down, left, right


def heat2d_predicted_times(base_plan: CommPlan, big_m: int, big_n: int,
                           mprocs: int, nprocs: int, hw, *,
                           destination: Destination | None = None,
                           materialize: str = "dest",
                           n_steps_hint: int | None = None) -> dict:
    """Seconds per Heat2D step of every rung, as ``Heat2D(strategy=
    "auto")`` ranks them (the reference's ranking, term for term).

    Overlap vs condensed are priced on the FULL per-step window — eqs.
    19–22 plus the edge-ring recompute of the interior/edge split
    (``perfmodel.predict_heat2d_window``).  The generic §5 exchange models
    price replicate / blockwise, shifted onto the window scale by the delta
    that maps the generic condensed price to its window price, so all four
    entries carry the same (exchange + whole-tile compute) units.  With
    ``n_steps_hint`` every rung is priced on the n-step loop instead
    (``predict_heat2d_scan``, ``scan_loop_cost``)."""
    topo = base_plan.topology
    pred = dict(select.rank_strategies(
        base_plan, 4, hw,
        materialize="dest" if destination is not None else None,
        dest_slots=(destination.num_slots
                    if destination is not None else None)))
    w2d = pm.Heat2DWorkload(big_m=big_m, big_n=big_n, mprocs=mprocs,
                            nprocs=nprocs, topology=topo)
    full = "full" if materialize == "full" else None
    win = pm.predict_heat2d_window(w2d, hw, materialize=full)
    offset = win["condensed"] - pred["condensed"]
    for rung in ("replicate", "blockwise"):
        pred[rung] = max(pred[rung] + offset, 0.0)
    pred["condensed"] = win["condensed"]
    pred["overlap"] = win["overlap"]
    if n_steps_hint is not None:
        # the n-step steady-state loop: window setup amortizes away and
        # the overlap rung earns its double-buffer credit
        setup = pm.window_setup_time(topo, hw)
        for rung in ("replicate", "blockwise"):
            pred[rung] = pm.scan_loop_cost(pred[rung], setup, n_steps_hint)
        scn = pm.predict_heat2d_scan(w2d, hw, n_steps_hint,
                                     materialize=full)
        pred["condensed"] = scn["condensed"]
        pred["overlap"] = scn["overlap"]
    return pred


def _per_rank(a):
    """Placement of a table that already has one row per rank."""
    return a


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[q, k] = x[q, idx[q, k]]`` for every rank q."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _set_ring(dst: torch.Tensor, top, bottom, left, right) -> torch.Tensor:
    """Write the one-cell edge ring of every tile of ``dst (P, m, n)`` in
    place: rows first, then columns (the corners get the column values,
    which are the same bits)."""
    dst[:, 0, :] = top
    dst[:, -1, :] = bottom
    dst[:, :, 0] = left
    dst[:, :, -1] = right
    return dst


class Heat2D:
    """Distributed 2D heat solver on an (mprocs × nprocs) grid of the ranks
    of ``comm`` (a ``LoopbackComm`` with ``mprocs * nprocs`` ranks, or a
    ``DistComm`` whose process holds ``p_local`` consecutive ranks of them
    and steps only their tiles; a process's ranks may cut a grid row).

    ``strategy`` picks the gather rung for the halo exchange (default
    ``condensed``; ``"auto"`` lets the §5 window models choose, from
    ``hw=`` or from parameters measured on the communicator's device, on
    the n-step loop under ``n_steps_hint``); ``overlap=True`` additionally
    splits each step into the
    tile-interior update (which needs no halo and can hide the exchange)
    plus a thin edge-ring update that consumes the landed halos.
    ``materialize`` picks the unpack (``"dest"`` or ``"full"``, see the
    module docstring).  ``pattern`` (the field's
    ``AccessPattern.from_stencil5``, O(area) to build) and ``base_plan`` (a
    base plan built from it) share what engines over the same field can
    share, in place of the plan cache, as ``DistributedSpMV(base_plan=)``
    does; the step schedule and the scan schedule always share one.
    ``use_plan_cache=False`` builds the plans without the plan cache.
    """

    def __init__(self, comm, big_m: int, big_n: int, *, mprocs: int,
                 nprocs: int, coef: float = 0.1, use_kernel: bool = False,
                 overlap: bool = False, strategy: str | None = None,
                 blocksize: int | str | None = None,
                 shards_per_node: int | None = None,
                 materialize: str = "dest",
                 pattern: AccessPattern | None = None,
                 base_plan: CommPlan | None = None, hw=None,
                 n_steps_hint: int | None = None,
                 use_plan_cache: bool = True):
        if strategy is None:
            strategy = "overlap" if overlap else "condensed"
        if materialize not in ("dest", "full"):
            raise ValueError(f"unknown materialize mode {materialize!r}")
        p = mprocs * nprocs
        if comm.p != p:
            raise ValueError(f"a {mprocs} x {nprocs} grid needs {p} ranks, "
                             f"the communicator has {comm.p}")
        if big_m % mprocs or big_n % nprocs:
            raise ValueError("the grid must divide the field")
        self.comm = comm
        self.device = comm.device
        self.mprocs, self.nprocs = mprocs, nprocs
        self.big_m, self.big_n = big_m, big_n
        m_loc, n_loc = big_m // mprocs, big_n // nprocs
        self.m_loc, self.n_loc = m_loc, n_loc
        self.coef = coef
        self.materialize = materialize
        n = big_m * big_n
        topo = Topology(p, shards_per_node or p)
        if pattern is None:
            pattern = AccessPattern.from_stencil5(big_m, big_n, mprocs,
                                                  nprocs)
        elif (pattern.n, pattern.m, pattern.r) != (n, n, 4):
            raise ValueError("pattern is not this field's stencil pattern")
        self.pattern = pattern
        plans: dict = {}
        if base_plan is not None:
            if (base_plan.n, base_plan.p, base_plan.m) != (n, p, pattern.m) \
                    or base_plan.topology != topo:
                raise ValueError("base_plan was built for another pattern, "
                                 "partitioning or topology")
            if blocksize not in (None, "auto", base_plan.blocksize):
                raise ValueError(f"blocksize={blocksize} but base_plan has "
                                 f"{base_plan.blocksize}")
            blocksize = base_plan.blocksize
            plans[plan_key(pattern, p, blocksize, topo)] = base_plan
        destination = None
        halo_idx = None
        if materialize == "dest":
            # the four halo strips ARE the consumer slots: finish() lands
            # the exchange straight into them, no length-n x_copy
            up, down, left, right = _halo_indices(
                big_m, big_n, mprocs, nprocs, zero_slot=Destination.ZERO)
            destination = Destination.from_slots(
                up=up, down=down, left=left, right=right)
        else:
            # index tables into the assembled x_copy; padding reads the
            # guaranteed-zero slot n + 1
            halo_idx = _halo_indices(big_m, big_n, mprocs, nprocs,
                                     zero_slot=n + 1)
        self.predicted_times = None
        if strategy == "auto":
            if hw is None:
                hw = measure_hw(comm)
            if base_plan is None:
                if blocksize == "auto":
                    blocksize = select.choose_blocksize(
                        pattern.indices, n, p, topology=topo, hw=hw)
                base_plan = plan_cache.get_comm_plan(
                    pattern.indices, n, p, blocksize=blocksize,
                    topology=topo, cache=use_plan_cache)
                blocksize = base_plan.blocksize
                plans[plan_key(pattern, p, blocksize, topo)] = base_plan
            self.predicted_times = heat2d_predicted_times(
                base_plan, big_m, big_n, mprocs, nprocs, hw,
                destination=destination, materialize=materialize,
                n_steps_hint=n_steps_hint)
            strategy = min(self.predicted_times,
                           key=self.predicted_times.get)
        self.strategy = strategy
        # split on the RESOLVED rung: "auto" may pick overlap, whose
        # predicted win exists only if the interior/edge split runs
        self.overlap = split = overlap or strategy == "overlap"

        # global boundary cells keep their value (the paper copies the
        # boundary): the rank's grid coordinates place its tile; the rows
        # are this process's ranks (every rank on a LoopbackComm)
        pl = comm.p_local
        ranks = torch.arange(comm.rank_offset, comm.rank_offset + pl,
                             device=self.device)
        grow = ((ranks // nprocs) * m_loc)[:, None] + torch.arange(
            m_loc, device=self.device)
        gcol = ((ranks % nprocs) * n_loc)[:, None] + torch.arange(
            n_loc, device=self.device)
        interior = (((grow > 0) & (grow < big_m - 1))[:, :, None]
                    & ((gcol > 0) & (gcol < big_n - 1))[:, None, :])

        def stencil(x):
            if use_kernel:
                return kops.stencil2d(x, coef=coef)
            return kref.stencil2d_ref(x, coef)

        def add_common_stages(sched, *, double_buffer):
            phi_ref = sched.input("phi", spec=self._tiles)
            flat = sched.compute(lambda phi: phi.reshape(pl, -1), phi_ref,
                                 name="flatten")
            halo_refs = ()
            if materialize != "dest":
                halo_refs = tuple(
                    sched.constant(a, nm, spec=_per_rank)
                    for nm, a in zip(("up_i", "down_i", "left_i", "right_i"),
                                     halo_idx))
            fk = (None if materialize == "dest"
                  else dict(extra_slots=1, copy_own=False))
            if double_buffer:
                g = sched.gather(pattern, double_buffer=True, prime=flat,
                                 destination=destination, name="halo",
                                 finish_kwargs=fk)
            else:
                g = sched.gather(pattern, src=flat, destination=destination,
                                 name="halo", finish_kwargs=fk)
            return phi_ref, g, halo_refs

        def unpack_halos(landed, rest):
            if materialize == "dest":
                return (landed["up"], landed["down"],
                        landed["left"], landed["right"]), rest
            up_i, dn_i, lf_i, rt_i = rest[:4]
            return (_take(landed, up_i), _take(landed, dn_i),
                    _take(landed, lf_i), _take(landed, rt_i)), rest[4:]

        def pad_with_halos(phi, halos):
            up_v, dn_v, lf_v, rt_v = halos
            padded = phi.new_zeros((pl, m_loc + 2, n_loc + 2))
            padded[:, 1:-1, 1:-1] = phi
            padded[:, 0, 1:-1] = up_v
            padded[:, -1, 1:-1] = dn_v
            padded[:, 1:-1, 0] = lf_v
            padded[:, 1:-1, -1] = rt_v
            return padded

        def ring_strips(padded):
            # only the one-cell edge ring consumes the landed halos, via
            # four thin strided strips of the padded assembly
            top = stencil(padded[:, 0:3, :])[:, 1, 1:-1]
            bottom = stencil(padded[:, -3:, :])[:, 1, 1:-1]
            left = stencil(padded[:, :, 0:3])[:, 1:-1, 1]
            right = stencil(padded[:, :, -3:])[:, 1:-1, 1]
            return top, bottom, left, right

        def build_step():
            sched = Schedule()
            phi_ref, g, halo_refs = add_common_stages(sched,
                                                      double_buffer=False)
            inner_refs = ()
            if split:
                # the interior update has no halo dependency: it runs
                # inside the exchange window
                inner_refs = (sched.compute(stencil, phi_ref,
                                            name="interior"),)

            def finalize(phi, landed, *rest):
                halos, rest = unpack_halos(landed, rest)
                padded = pad_with_halos(phi, halos)
                # --- compute (paper Listing 8) ---
                if split:
                    # the interior stage's value is read by this stage
                    # only, so its ring is overwritten in place
                    (inner,) = rest
                    upd = _set_ring(inner, *ring_strips(padded))
                else:
                    upd = stencil(padded)[:, 1:-1, 1:-1]
                return torch.where(interior, upd, phi)

            out = sched.compute(finalize, phi_ref, g, *halo_refs,
                                *inner_refs, name="update")
            return sched, phi_ref, out

        def build_scan_overlap():
            # double-buffered body: the delivered halos were issued by the
            # PREVIOUS iteration's feed.  The edge ring is refreshed first,
            # its flattened field feeds the NEXT exchange, and the
            # tile-interior stencil runs inside that freshly opened window
            sched = Schedule()
            phi_ref, g, halo_refs = add_common_stages(sched,
                                                      double_buffer=True)

            def ring_half(phi, landed, *rest):
                halos, _ = unpack_halos(landed, rest)
                padded = pad_with_halos(phi, halos)
                half = _set_ring(phi.clone(), *ring_strips(padded))
                # half's ring holds step-(k+1) values (masked to the copied
                # global boundary), its interior step k; the exchange only
                # delivers tile-perimeter cells, so feeding half equals
                # feeding the finished step-(k+1) field
                return torch.where(interior, half, phi)

            half = sched.compute(ring_half, phi_ref, g, *halo_refs,
                                 name="ring_half")
            flat_half = sched.compute(lambda h: h.reshape(pl, -1), half,
                                      name="flatten_half")
            sched.feed(g, flat_half)
            inner = sched.compute(stencil, phi_ref, name="interior")

            def combine(half, inner):
                # tile-interior cells are never on the global boundary, so
                # only the ring (already masked in half) needs care; inner
                # is read by this stage only and is updated in place
                return _set_ring(inner, half[:, 0, :], half[:, -1, :],
                                 half[:, :, 0], half[:, :, -1])

            out = sched.compute(combine, half, inner, name="update")
            return sched, phi_ref, out

        resolve_kw = dict(strategy=strategy, topology=topo,
                          use_kernel=use_kernel, plans=plans, hw=hw,
                          use_plan_cache=use_plan_cache)
        sched, _, out = build_step()
        self.schedule = sched.compile(comm, output=out, blocksize=blocksize,
                                      **resolve_kw)
        self.gather = sched.exchange_of(
            next(s.ref for s in sched._stages if s.kind == "gather"))
        self.plans = plans
        # the n-step loop: the overlap rung scans the double-buffered body,
        # the other rungs the per-step body; both resolve against the step
        # schedule's base plan
        builder = build_scan_overlap if split else build_step
        sscan, phi_in, sout = builder()
        self.scan_schedule = sscan.scan(
            comm, carry=phi_in, output=sout, n_steps_hint=n_steps_hint,
            blocksize=self.gather.plan.blocksize, **resolve_kw)

    def _tiles(self, field: np.ndarray) -> np.ndarray:
        """Global ``(M, N)`` -> rank-stacked tiles ``(P, m_loc, n_loc)``."""
        a = np.asarray(field).reshape(self.mprocs, self.m_loc, self.nprocs,
                                      self.n_loc)
        return a.transpose(0, 2, 1, 3).reshape(-1, self.m_loc, self.n_loc)

    @property
    def counts(self):
        return self.gather.counts

    def shard_field(self, field) -> torch.Tensor:
        """Host ``(M, N)`` field -> ``(P, m_loc, n_loc)`` on the device:
        this process's tiles of it."""
        return self.schedule.shard_input(field)

    def gather_field(self, phi: torch.Tensor) -> np.ndarray:
        """``(P, m_loc, n_loc)`` tiles -> the global ``(M, N)`` host array.
        A process that holds only some of the tiles gathers the others
        with one ``comm.all_gather``."""
        comm = self.comm
        if comm.p_local < comm.p:
            phi = comm.all_gather(
                phi.reshape(comm.p_local, -1).contiguous()).wait()[0]
        a = phi.detach().cpu().numpy().reshape(
            self.mprocs, self.nprocs, self.m_loc, self.n_loc)
        return a.transpose(0, 2, 1, 3).reshape(self.big_m, self.big_n)

    def init_field(self, seed: int = 0) -> torch.Tensor:
        rng = np.random.default_rng(seed)
        phi = rng.standard_normal((self.big_m, self.big_n)).astype(
            np.float32)
        return self.shard_field(phi)

    def run(self, phi: torch.Tensor, steps: int) -> torch.Tensor:
        """Advance ``steps`` iterations through the ``ScanSchedule``: plans
        resolved once, the double-buffered body on the split.  One step
        alone is ``self.schedule(phi)`` (the ``ExchangeSchedule``)."""
        return self.scan_schedule(phi, n_steps=steps)

    @staticmethod
    def reference(phi, steps: int, coef: float = 0.1) -> torch.Tensor:
        """``steps`` plain stencil steps on the whole ``(M, N)`` field (a
        host array, or a tensor on its own device)."""
        x = torch.as_tensor(np.asarray(phi) if not isinstance(
            phi, torch.Tensor) else phi)
        for _ in range(steps):
            x = kref.stencil2d_ref(x, coef)
        return x
