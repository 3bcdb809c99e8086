"""Distributed SpMV engine — the paper's workload on the port's comm layer.

``DistributedSpMV`` derives an ``AccessPattern`` from the EllPack column
table, hands it to ``IrregularGather`` (which owns the ``CommPlan``, the
rung, and the device-resident plan arrays), and runs the gather and the
local EllPack compute of all ``P`` ranks as rank-stacked tensor code.  With
``use_kernel=True`` the pack/unpack and the local SpMV run through the
port's CUDA kernels (``repro_torch.kernels``); otherwise through plain
PyTorch.

``strategy`` is any rung of the ladder (``replicate`` / ``blockwise`` /
``condensed`` / ``overlap``); ``"auto"`` comes with a later slice.

``materialize`` picks the unpack: ``"dest"`` (default on the plain paths)
registers the EllPack slot table as a ``Destination`` so each exchange
lands directly in gather-slot order — O(slots + recv) per step, no
full-length ``x_copy``; ``"full"`` keeps the paper's UPCv3 layout
(assemble ``mythread_x_copy``, then index it).  With ``use_kernel=True``
the default is ``"full"`` (the SpMV kernel consumes the assembled copy,
itself built by the unpack kernel); an explicit ``materialize="dest"``
routes the exchange through the targeted unpack kernel with the slot
compute in PyTorch.

The ``overlap`` strategy uses the ``OverlapHandle`` protocol: issue the
condensed all_to_all (on a side stream on the card), run the own-shard
partial SpMV (which depends only on ``x``) meanwhile, then finish with the
foreign partial on the unpacked remote values.

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
from repro_torch.comm.plan import CommPlan, Topology
from repro_torch.core.matrix import EllpackMatrix
from repro_torch.kernels import ops as kops

__all__ = ["DistributedSpMV"]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[q, ...] = x[q, idx[q, ...]]`` for every rank q."""
    ranks = torch.arange(x.shape[0], device=x.device)
    return x[ranks.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def _own_rows(x_copy: torch.Tensor, shard: int) -> torch.Tensor:
    """Rank q's own rows ``x_copy[q, q*shard : (q+1)*shard]``."""
    p = x_copy.shape[0]
    blocks = x_copy[:, :p * shard].reshape(p, p, shard)
    ranks = torch.arange(p, device=x_copy.device)
    return blocks[ranks, ranks]


class DistributedSpMV:
    """y = (D + A) x with x, y, D, A, J sharded over the ranks of ``comm``
    (a ``LoopbackComm``).  ``base_plan`` shares one already-built
    destination-independent ``CommPlan`` between engines over the same
    matrix."""

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
    ):
        if transpose:
            raise NotImplementedError(
                "transpose=True (y = (D + A)^T x by scatter-accumulate) "
                "comes with the push-direction slice of the port "
                "(ROADMAP A6)")
        self.matrix = matrix
        self.comm = comm
        p = comm.p
        self.p = p
        dev = comm.device
        n = matrix.n
        assert n % p == 0, "pad the matrix so n divides the rank count"
        topology = Topology(p, shards_per_node or p)
        if materialize is None:
            # the SpMV kernel consumes the assembled copy, so the kernel
            # default is "full"; an explicit materialize="dest" with
            # use_kernel=True routes the exchange through the targeted
            # unpack kernel instead (slot compute stays plain)
            materialize = "full" if use_kernel else "dest"
        assert materialize in ("dest", "full"), materialize
        self.materialize = materialize
        rows = matrix.cols.shape[0] // p

        destination = None
        if materialize == "dest":
            # land every gathered value in EllPack slot order: row i's slot
            # j reads x[J[i, j]].  The overlap rung resolves owned slots
            # from x inside the own partial, so there the destination
            # targets the plan's foreign (rem) slots only
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
            base_plan=base_plan, use_kernel=use_kernel)
        self.plan: CommPlan = gather.plan
        self.strategy = strategy
        self.blocksize = self.plan.blocksize
        plan = self.plan
        shard = plan.shard_size
        gargs = gather.plan_args

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a)).reshape(
                (p, rows) + a.shape[1:]).to(dev)

        diag = put(matrix.diag)

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

            def step(x):
                # 1. issue the condensed exchange (paper Listing 5 pack)
                handle = gather.start_local(x, *gargs)
                # 2. own-shard partial: no dependency on the landed messages
                x_ext = torch.cat([x, x.new_zeros((p, 1))], dim=1)
                y_own = diag * x + (loc_vals * _take(x_ext, loc_cols)).sum(-1)
                # 3. foreign partial on the landed remote values: straight
                # off the targeted delivery, or off x_copy, where slot n is
                # the recv dump and slot n+1 the compute padding (zero)
                if materialize == "dest":
                    foreign = handle.finish()["foreign"]
                else:
                    x_copy = handle.finish(extra_slots=1, copy_own=False)
                    foreign = _take(x_copy, rem_cols)
                return y_own + (rem_vals * foreign).sum(-1)
        elif materialize == "dest":
            vals = put(matrix.vals)

            def step(x):
                # landed values arrive already in EllPack slot order; owned
                # slots were gathered from x by the same delivery
                gathered = gather.local(x, *gargs)["ellpack"]
                return diag * x + (vals * gathered).sum(-1)
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
                own = _own_rows(x_copy, shard)
                return diag * own + (vals * _take(x_copy, cols)).sum(-1)

        self._step = step

    # ---- public API ----
    def shard_vector(self, x) -> torch.Tensor:
        """Host vector (length n) -> ``(P, n / P)`` on the engine's device."""
        return self.gather.shard_vector(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = (D + A) x, both ``(P, n / P)``."""
        return self._step(x)

    def gather_x_copy(self, x: torch.Tensor) -> torch.Tensor:
        """``(P, >= n)``: row q is rank q's private x_copy (testing)."""
        return self.gather(x)

    @property
    def counts(self):
        """Exact per-shard §5 volume counts."""
        return self.plan.counts
