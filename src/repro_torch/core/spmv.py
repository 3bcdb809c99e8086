"""Distributed SpMV engine — the paper's workload on the port's comm layer.

``DistributedSpMV`` derives an ``AccessPattern`` from the EllPack column
table, hands it to ``IrregularGather`` (which owns the ``CommPlan``, the
rung, and the device-resident plan arrays), and runs the gather and the
local EllPack compute of all ``P`` ranks as rank-stacked tensor code.  With
``use_kernel=True`` the pack/unpack and the local SpMV run through the
port's CUDA kernels (``repro_torch.kernels``); otherwise through plain
PyTorch.

``strategy`` may be any rung of the ladder (``replicate`` / ``blockwise`` /
``condensed`` / ``overlap``) or ``"auto"``, which prices the rungs with the
§5 models from hardware parameters measured on the communicator's device
(``hw=`` passes them instead) and picks the predicted-fastest.
``blocksize`` may likewise be ``"auto"`` (eq.-11-minimizing BLOCKSIZE).
The resolved choices are ``engine.strategy`` / ``engine.blocksize``; the
request is kept in ``engine.requested_strategy`` and the ranking in
``engine.predicted_times``.

``transpose=True`` computes ``y = (D + A)ᵀ x`` in the push direction:
each rank forms its contributions ``vals * x[:, None]`` and scatters them to
the column owners through ``IrregularScatter`` (``reduce="add"``); the
diagonal product runs while the exchange is in flight.  With
``use_kernel=True`` every combine of the scatter runs through the port's
segment-fold kernels.

``materialize`` picks the unpack: ``"dest"`` (default on the plain paths)
registers the EllPack slot table as a ``Destination`` so each exchange
lands directly in gather-slot order — O(slots + recv) per step, no
full-length ``x_copy``; ``"full"`` keeps the paper's UPCv3 layout
(assemble ``mythread_x_copy``, then index it).  With ``use_kernel=True``
the default is ``"full"`` (the SpMV kernel consumes the assembled copy,
itself built by the unpack kernel); an explicit ``materialize="dest"``
routes the landed exchange through ``unpack_dest_spmv``, the targeted
unpack with the slot product as its epilogue (the slots never leave the
kernel), through the engine's dest table (``kernels.DestOrder``).

The ``overlap`` strategy uses the ``OverlapHandle`` protocol: issue the
condensed all_to_all (on a side stream on the card), run the own-shard
partial SpMV (which depends only on ``x``) meanwhile, then finish with the
foreign partial on the unpacked remote values.

``normal_equations_step`` chains both directions, ``z = MᵀM x``, as one
``Schedule`` whose gather and scatter stages share one base plan.

Usage:
    comm = LoopbackComm(8)                 # 8 ranks on the default card
    m = make_mesh_like_matrix(1 << 16, 16)
    engine = DistributedSpMV(m, comm, strategy="condensed", use_kernel=True)
    x = engine.shard_vector(x_host)        # (P, n / P)
    y = engine(x)                          # y = (D + A) x, sharded like x
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm import strategies as strat
from repro_torch.comm.gather import IrregularGather
from repro_torch.comm.pattern import AccessPattern, Destination
from repro_torch.comm.plan import CommPlan, ScatterPlan, Topology
from repro_torch.comm.scatter import IrregularScatter
from repro_torch.comm.schedule import Schedule
from repro_torch.core.matrix import EllpackMatrix
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["DistributedSpMV", "normal_equations_stages",
           "normal_equations_step"]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[q, ...] = x[q, idx[q, ...]]`` for every rank q."""
    ranks = torch.arange(x.shape[0], device=x.device)
    return x[ranks.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def _dest_product(landed: strat.Landed, vals, diag, table, *,
                  use_kernel: bool) -> torch.Tensor:
    """The slot product on a dest gather's landed exchange, ``diag·x + Σ_j
    vals·slot`` (``diag`` None: the sum alone): fused with the delivery
    where the card has the plan's dest ``table`` (``kops.DestOrder``), else
    the delivery (B3's kernel with ``use_kernel``) and then the plain
    product."""
    if table is not None:
        return kops.unpack_dest_spmv(*landed, vals, diag, table=table)
    unpack = kops.unpack_dest if use_kernel else kref.unpack_dest_ref
    acc = (vals * unpack(*landed).reshape(vals.shape)).sum(-1)
    return acc if diag is None else diag * landed.x_local + acc


class DistributedSpMV:
    """y = (D + A) x (or ``(D + A)ᵀ x`` with ``transpose=True``) with x, y,
    D, A, J sharded over the ranks of ``comm`` (a ``LoopbackComm``).
    ``base_plan`` shares one already-built destination-independent
    ``CommPlan`` between engines over the same matrix, and ``scatter_plan``
    one ``ScatterPlan`` between transposed engines."""

    def __init__(
        self,
        matrix: EllpackMatrix,
        comm,
        *,
        strategy: str = "condensed",
        blocksize: int | str | None = None,
        shards_per_node: int | None = None,
        use_kernel: bool = False,
        materialize: str | None = None,
        transpose: bool = False,
        base_plan: CommPlan | None = None,
        scatter_plan: ScatterPlan | None = None,
        hw=None,
        use_plan_cache: bool = True,
    ):
        self.matrix = matrix
        self.comm = comm
        p = comm.p
        self.p = p
        dev = comm.device
        n = matrix.n
        assert n % p == 0, "pad the matrix so n divides the rank count"
        topology = Topology(p, shards_per_node or p)
        self.transpose = transpose
        if transpose:
            assert materialize is None, (
                "materialize= is a gather-unpack knob; the transposed "
                "product always accumulates straight into the owned slice")
            self._init_transpose(matrix, comm, strategy=strategy,
                                 blocksize=blocksize, topology=topology,
                                 use_kernel=use_kernel, base_plan=base_plan,
                                 scatter_plan=scatter_plan, hw=hw,
                                 use_plan_cache=use_plan_cache)
            return
        assert scatter_plan is None, "scatter_plan serves transpose=True"
        if materialize is None:
            # the SpMV kernel consumes the assembled copy, so the kernel
            # default is "full"; an explicit materialize="dest" with
            # use_kernel=True routes the exchange through the targeted
            # unpack fused with the slot product instead
            materialize = "full" if use_kernel else "dest"
        assert materialize in ("dest", "full"), materialize
        self.materialize = materialize
        rows = matrix.cols.shape[0] // p

        destination = None
        if materialize == "dest":
            # land every gathered value in EllPack slot order: row i's slot
            # j reads x[J[i, j]].  The overlap rung resolves owned slots
            # from x inside the own partial, so there the destination
            # targets the plan's foreign (rem) slots only; resolved per
            # rung, after "auto" picks
            def destination(resolved, plan):
                if resolved == "overlap":
                    rem = np.where(plan.rem_cols >= n, Destination.ZERO,
                                   plan.rem_cols)
                    return Destination.from_slots(
                        foreign=rem.reshape(p, rows, -1))
                return Destination.from_slots(
                    ellpack=matrix.cols.reshape(p, rows, -1))
        self.gather = gather = IrregularGather(
            AccessPattern.from_ellpack(matrix), comm, strategy=strategy,
            blocksize=blocksize, topology=topology, destination=destination,
            dest_slots=rows * matrix.cols.shape[1], hw=hw,
            use_plan_cache=use_plan_cache, base_plan=base_plan,
            use_kernel=use_kernel)
        self.plan: CommPlan = gather.plan
        self.requested_strategy = strategy
        self.predicted_times = gather.predicted_times
        # the rung branches below build the resolved rung's step
        strategy = gather.strategy
        self.strategy = strategy
        self.blocksize = self.plan.blocksize
        plan = self.plan
        shard = plan.shard_size
        gargs = gather.plan_args

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a)).reshape(
                (p, rows) + a.shape[1:]).to(dev)

        diag = put(matrix.diag)

        def dest_product(landed, vals_t, diag_t, order):
            return _dest_product(landed, vals_t, diag_t,
                                 order(*landed[2:]) if use_kernel else None,
                                 use_kernel=use_kernel)

        if strategy == "overlap" and use_kernel and materialize == "full":
            own_fn, rem_fn, kargs = kops.make_spmv_overlap_sharded(
                plan, matrix.vals)
            kargs = strat.to_device(kargs, dev)

            def step(x):
                handle = gather.start_local(x, *gargs)
                # own-shard partial on x (+ its one zero pad slot) while the
                # exchange is in flight on the side stream
                x_ext = torch.cat([x, x.new_zeros((p, 1))], dim=1)
                y_own = own_fn(diag, x_ext, *kargs[:3])
                x_copy = handle.finish(extra_slots=1, copy_own=False)
                return y_own + rem_fn(x_copy, *kargs[3:])
        elif strategy == "overlap":
            # split vals the same way the plan split cols; padded slots read
            # a guaranteed-zero value, so their vals are never observed
            loc_cols, loc_vals, rem_vals = (
                put(plan.loc_cols),
                put(np.take_along_axis(matrix.vals, plan.loc_src, axis=1)),
                put(np.take_along_axis(matrix.vals, plan.rem_src, axis=1)))
            rem_cols = put(plan.rem_cols) if materialize == "full" else None
            rem_order = kops.DestOrder(row=rem_vals.shape[2])

            def step(x):
                # 1. issue the condensed exchange (paper Listing 5 pack)
                handle = gather.start_local(x, *gargs)
                # 2. own-shard partial: no dependency on the landed messages
                x_ext = torch.cat([x, x.new_zeros((p, 1))], dim=1)
                y_own = diag * x + (loc_vals * _take(x_ext, loc_cols)).sum(-1)
                # 3. foreign partial on the landed remote values: the
                # targeted delivery inside the product, or off x_copy, where
                # slot n is the recv dump and slot n+1 the compute padding
                # (zero)
                if materialize == "dest":
                    return y_own + dest_product(
                        handle.finish(materialize="landed"), rem_vals, None,
                        rem_order)
                x_copy = handle.finish(extra_slots=1, copy_own=False)
                return y_own + (rem_vals * _take(x_copy, rem_cols)).sum(-1)
        elif materialize == "dest":
            vals = put(matrix.vals)
            order = kops.DestOrder(row=vals.shape[2])

            def step(x):
                # the landed values, delivered in EllPack slot order (owned
                # slots gathered from x) inside the slot product
                return dest_product(
                    gather.local(x, *gargs, materialize="landed"), vals, diag,
                    order)
        elif use_kernel:
            kernel_local, kplan = kops.make_spmv_on_copy_sharded(
                matrix.cols, p)
            kplan = strat.to_device(kplan, dev)
            vals = put(matrix.vals)

            def step(x):
                x_copy = gather.local(x, *gargs)
                return kernel_local(diag, vals, x_copy, *kplan)
        else:
            vals, cols = put(matrix.vals), put(matrix.cols)

            def step(x):
                x_copy = gather.local(x, *gargs)
                own = strat.own_rows(x_copy, shard)
                return diag * own + (vals * _take(x_copy, cols)).sum(-1)

        self._step = step

    def _init_transpose(self, matrix, comm, *, strategy, blocksize,
                        topology, use_kernel, base_plan, scatter_plan, hw,
                        use_plan_cache):
        """y = (D + A)ᵀ x via scatter-accumulate of partial products.

        Each rank forms its contributions ``vals * x[:, None]`` (its rows'
        partial products) and pushes them to the column owners; the diagonal
        term is purely local (Dᵀ = D).  The ``ScatterHandle`` protocol
        issues the exchange first, so the diagonal product and the
        own-column accumulate run while the collective is in flight — the
        ``overlap`` rung's window, on every rung.
        """
        p = self.p
        scatter = IrregularScatter(
            AccessPattern.from_ellpack(matrix), comm, strategy=strategy,
            blocksize=blocksize, topology=topology, reduce="add",
            use_kernel=use_kernel, base_plan=base_plan,
            scatter_plan=scatter_plan, hw=hw, use_plan_cache=use_plan_cache)
        self.scatter = scatter
        self.gather = None
        self.plan: CommPlan = scatter.plan
        self.splan = scatter.splan
        self.requested_strategy = strategy
        self.predicted_times = scatter.predicted_times
        self.strategy = scatter.strategy
        self.blocksize = self.plan.blocksize
        self.materialize = None
        rows = matrix.cols.shape[0] // p
        diag = torch.as_tensor(matrix.diag).reshape(p, rows).to(comm.device)
        vals = torch.as_tensor(np.ascontiguousarray(matrix.vals)).reshape(
            p, rows, -1).to(comm.device)
        sargs = scatter.plan_args

        def step(x):
            contrib = vals * x[:, :, None]
            handle = scatter.start_local(contrib, *sargs)
            y_diag = diag * x
            return y_diag + handle.finish()

        self._step = step

    # ---- public API ----
    def shard_vector(self, x) -> torch.Tensor:
        """Host vector (length n) -> ``(P, n / P)`` on the engine's device."""
        if self.transpose:
            return self.scatter.shard_vector(x)
        return self.gather.shard_vector(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = (D + A) x (or ``(D + A)ᵀ x``), both ``(P, n / P)``."""
        return self._step(x)

    def gather_x_copy(self, x: torch.Tensor) -> torch.Tensor:
        """``(P, >= n)``: row q is rank q's private x_copy (testing)."""
        assert not self.transpose, "the transposed product never gathers"
        return self.gather(x)

    @property
    def counts(self):
        """Exact per-shard §5 volume counts — put-direction counts when
        ``transpose=True`` (the direction the step actually runs)."""
        if self.transpose:
            return self.splan.counts
        return self.plan.counts


def normal_equations_stages(sched, matrix: EllpackMatrix, p: int, x_ref):
    """Declare the z = MᵀM x stage graph on an existing ``Schedule``.

    ``x_ref`` is the (already declared) input/stage whose value is the
    ``(P, n / P)`` operand; the return value is the ``z`` stage ref.  Shared
    by ``normal_equations_step`` (one step) and the iterative solvers
    (``repro_torch.core.solvers``), which embed the same graph inside a
    ``ScanSchedule`` body next to their own recurrence stages.

    The graph chains the two SpMV directions in one window: gather-product
    ``y = M x`` (EllPack-slot ``Destination``, slot product in PyTorch),
    push-product ``z = Mᵀ y`` whose scatter stage derives its executor
    tables from the gather stage's base plan, and the diagonal product
    ``D·y`` scheduled after the scatter so it runs inside the push
    collective's window.
    """
    n = matrix.n
    assert n % p == 0, "pad the matrix so n divides the rank count"
    rows_per_shard = matrix.cols.shape[0] // p
    pattern = AccessPattern.from_ellpack(matrix)
    # the forward product lands gathered x in EllPack slot order
    destination = Destination.from_slots(
        ellpack=matrix.cols.reshape(p, rows_per_shard, -1))

    diag = sched.constant(matrix.diag, "diag")
    vals = sched.constant(matrix.vals, "vals")
    g = sched.gather(pattern, src=x_ref, destination=destination,
                     name="gather_x")

    def forward(x_l, d_l, v_l, delivered):
        return d_l * x_l + (v_l * delivered["ellpack"]).sum(-1)

    y = sched.compute(forward, x_ref, diag, vals, g, name="y=Mx")
    contrib = sched.compute(lambda y_l, v_l: v_l * y_l[:, :, None], y, vals,
                            name="partials")
    s = sched.scatter(pattern, contrib, reduce="add", name="scatter_t")
    # scheduled after the scatter stage: D·y runs inside the push window
    y_diag = sched.compute(lambda y_l, d_l: d_l * y_l, y, diag,
                           name="diag_t")
    return sched.compute(lambda a, b: a + b, s, y_diag, name="z=Mty")


def normal_equations_step(matrix: EllpackMatrix, comm, *,
                          strategy: str = "auto",
                          blocksize: int | str | None = None,
                          shards_per_node: int | None = None,
                          use_kernel: bool = False,
                          plans: dict | None = None, hw=None,
                          use_plan_cache: bool = True):
    """z = MᵀM x with M = (D + A), as ONE ``ExchangeSchedule``.

    The normal-equations step (the CGNR / least-squares inner product)
    chains the forward gather-product ``y = M x`` and the transposed
    scatter-product ``z = Mᵀ y``: the scatter stage derives its executor
    tables from the gather stage's base plan (one O(nnz) preparation step
    in all), one hardware-calibration memo hit prices both ``"auto"``
    stages, and ``D·y`` runs inside the push window.  ``use_kernel``
    routes both exchanges through the CUDA pack / unpack / fold kernels;
    ``plans`` shares base plans (``Schedule.resolve``).

    Returns the compiled ``ExchangeSchedule``: ``step(x) -> z``, both ``(P,
    n / P)`` (``step.shard_vector`` places a host vector;
    ``step.predicted_window`` holds the §5 fused-window pricing).
    """
    p = comm.p
    sched = Schedule()
    x_ref = sched.input("x")
    z = normal_equations_stages(sched, matrix, p, x_ref)
    return sched.compile(
        comm, strategy=strategy, blocksize=blocksize,
        topology=Topology(p, shards_per_node or p), use_kernel=use_kernel,
        plans=plans, hw=hw, use_plan_cache=use_plan_cache, output=z)
