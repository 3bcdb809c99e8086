"""Iterative solvers on persistent exchange windows (``ScanSchedule``).

A Krylov solver is the sharpest version of a time loop over irregular
communication: every iteration needs one fine-grained irregular product
plus a handful of scalar reductions.  ``ConjugateGradient`` is CGNR on the
normal equations: it reuses the ``z = MᵀM p`` stage graph of
``normal_equations_step`` (``spmv.normal_equations_stages``) and adds the
CG recurrence as compute stages around it.  The two global dot products
are one ``(P, 2)`` tensor of per-rank partial sums reduced by the
communicator's ``all_reduce`` — a collective, as the reference's ``psum``
is — and the vector updates are local AXPYs.  Since MᵀM is symmetric
positive definite whenever M is nonsingular, CGNR converges for any of the
paper's mesh-like test matrices, solving ``M x = b`` in the least-squares
sense via ``(MᵀM) x = Mᵀ b``.

Usage (solve (MᵀM) x = b):

    cg = ConjugateGradient(matrix, comm, strategy="condensed")
    x = cg.solve(b, n_steps=50)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.plan import Topology
from repro_torch.comm.schedule import Schedule
from repro_torch.core.matrix import EllpackMatrix
from repro_torch.core.spmv import normal_equations_stages

__all__ = ["ConjugateGradient", "cg_solve"]


def _safe_div(a, b):
    """a / b with 0/0 -> 0 (a converged CG has rs == pz == 0: the iterate
    must then stay fixed instead of going NaN)."""
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)),
                       torch.zeros_like(a))


class ConjugateGradient:
    """CGNR: iterate x -> x + α p on ``(MᵀM) x = b``, each iteration one
    pass of the stage pipeline inside a ``ScanSchedule``.

    The loop carries ``(x, r, p)``; the ``z = MᵀM p`` product is the
    ``normal_equations_stages`` graph and the recurrence stages are
    all-reduced dots plus local AXPYs:

        α  = (r·r) / (p·z)        x' = x + α p      r' = r − α z
        β  = (r'·r') / (r·r)      p' = r' + β p

    ``strategy`` accepts any rung or ``"auto"``; with ``n_steps_hint`` the
    auto ranking prices the n-step loop (window setup amortized) instead of
    one call.  ``use_kernel`` routes both exchanges through the CUDA
    kernels; ``plans`` shares base plans (``Schedule.resolve``).
    """

    def __init__(self, matrix: EllpackMatrix, comm, *,
                 strategy: str = "auto",
                 blocksize: int | str | None = None,
                 shards_per_node: int | None = None,
                 use_kernel: bool = False, plans: dict | None = None,
                 hw=None, use_plan_cache: bool = True,
                 n_steps_hint: int | None = None):
        p = comm.p
        self.matrix = matrix
        self.comm = comm

        sched = Schedule()
        x = sched.input("x")
        r = sched.input("r")
        pv = sched.input("p")
        z = normal_equations_stages(sched, matrix, p, pv)

        def gdots(*pairs):
            """Every rank's global dot of each pair: ``(P, len(pairs))``."""
            part = torch.stack([(a * b).sum(-1) for a, b in pairs], dim=-1)
            return comm.all_reduce(part, "sum").wait()

        # both dots in one stage: the (r·r, p·z) pair rides a single tiny
        # all-reduce right after the product's window closes
        dots = sched.compute(lambda r_l, p_l, z_l: gdots((r_l, r_l),
                                                         (p_l, z_l)),
                             r, pv, z, name="dots")
        x2 = sched.compute(
            lambda x_l, p_l, d: x_l + _safe_div(d[:, :1], d[:, 1:]) * p_l,
            x, pv, dots, name="x'")
        r2 = sched.compute(
            lambda r_l, z_l, d: r_l - _safe_div(d[:, :1], d[:, 1:]) * z_l,
            r, z, dots, name="r'")
        p2 = sched.compute(
            lambda r2_l, p_l, d: r2_l
            + _safe_div(gdots((r2_l, r2_l)), d[:, :1]) * p_l,
            r2, pv, dots, name="p'")

        self.schedule = sched.scan(
            comm, carry=(x, r, pv), output=(x2, r2, p2), strategy=strategy,
            blocksize=blocksize, topology=Topology(p, shards_per_node or p),
            use_kernel=use_kernel, plans=plans, hw=hw,
            use_plan_cache=use_plan_cache, n_steps_hint=n_steps_hint)

    @property
    def strategies(self):
        """Resolved strategy per exchange stage (gather_x / scatter_t)."""
        return self.schedule.strategies

    def carries(self, b):
        """The placed (x0, r0, p0) start state for right-hand side ``b``:
        x0 = 0, r0 = p0 = b (the CG start at zero initial guess)."""
        b = np.asarray(b)
        x0 = self.schedule.shard_input(np.zeros_like(b), 0)
        r0 = self.schedule.shard_input(b, 1)
        p0 = self.schedule.shard_input(b, 2)
        return x0, r0, p0

    def solve(self, b, n_steps: int) -> torch.Tensor:
        """Run ``n_steps`` CG iterations on ``(MᵀM) x = b`` from x0 = 0 and
        return the iterate ``x_n`` ``(P, n / P)``."""
        x_n, _, _ = self.schedule(*self.carries(b), n_steps=n_steps)
        return x_n


def cg_solve(matrix: EllpackMatrix, b, comm, *, n_steps: int = 50,
             **kwargs) -> np.ndarray:
    """One-call convenience: build ``ConjugateGradient`` and solve
    ``(MᵀM) x = b``, returning a host array of length n."""
    cg = ConjugateGradient(matrix, comm, n_steps_hint=n_steps, **kwargs)
    return cg.solve(b, n_steps).reshape(-1).cpu().numpy()
