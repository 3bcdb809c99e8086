"""The model axis of a ``D x M`` mesh: tensor and expert parallelism over
the ``M`` ranks of a model group, in training and in serving.

The reference places the compute of a sharded step with GSPMD: its rule
table (``runtime.sharding``) splits a weight over the model axis and XLA
inserts the collectives.  Eager PyTorch has no partitioner, so the layers
compute with their model-axis part and call the collectives themselves,
Megatron's way, through a ``ModelAxis`` (``RunCtx.model``):

* ``enter(x)``: identity forward, all-reduce backward.  Where a
  replicated activation enters a product whose weight is split by columns
  (``wq``/``wk``/``wv``, ``w1``/``w3``, ``in_proj``, the head), each rank's
  gradient of ``x`` is a partial sum over its columns.
* ``reduce(x)``: all-reduce forward, identity backward.  After a product
  whose weight is split by rows (``wo``, ``w2``, ``x_proj``,
  ``out_proj``): each rank holds a partial sum of the replicated result.
* ``gather(x, dim)``: all-gather forward, own-slice backward.  The expert
  outputs of an expert-parallel MoE layer, the logits of a split head,
  and a leaf gathered whole where its split does not fall on whole heads
  (``full``): the computation after it is replicated, so each rank's
  gradient of the whole is the whole gradient and it keeps its slice.
* ``gather_used(t, dim, n)``: a leaf whose whole each rank uses a part
  of (``in_proj``'s channels, the KV heads that a rank's query heads
  read): all-gather forward, reduce-scatter backward (``sharding.
  _GatherFn``); a leaf that is not split takes ``enter`` instead, so that
  its gradient is summed over the ranks all the same.
* ``logsumexp(lse)``: the log-sum-exp of a vocabulary split over the
  ranks from each rank's own (the max and the sum of exponentials over
  the ranks), with the backward ``g · exp(lse_r − lse)``.
* ``merge(out, lse)`` (serving, no backward): attention over a cache
  whose slots are split over the ranks (the reference's flash-decoding
  layout, sequence over the model axis).  Each rank attends its own
  slots and holds its output ``out_r``, normalised over them, and the
  log-sum-exp ``lse_r`` of its logits (-inf where it holds no valid
  slot, its ``out_r`` then 0); the pairs are all-gathered in rank order
  and every rank combines them in that order (``merge_partials``), so
  every rank gets the same bits.

Every all-reduce sums the ranks in ascending order
(``DistComm.all_reduce``), so the replicated computation stays bit for bit
the same on every rank of the group.  At ``M = 1`` every collective runs
over a group of one and leaves the values as they are, and the step is
the unsplit one bit for bit where each ``enter`` takes all the products
of its input: a hybrid block's normed input feeds the attention's and
the mamba head's entries, so its four products' gradients are added in
another order there (within float32 rounding).
"""
from __future__ import annotations

import functools

import torch

__all__ = ["ModelAxis", "merge_partials"]


def _all_reduce(comm, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    return comm.all_reduce(x.contiguous()[None], op).wait()[0]


def _gather(comm, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` from every rank of ``comm``, concatenated along ``dim`` in
    rank order."""
    from repro_torch.runtime.sharding import gathered
    return gathered(comm, [x], [dim])[0]


def merge_partials(outs, lses):
    """Attention partials over disjoint slot ranges combined, in list
    order: ``outs`` each ``(..., D)`` normalised over its range, ``lses``
    each ``(...)`` its log-sum-exp (-inf for an empty range, whose out is
    0).  Returns the float32 ``(out, lse)`` over the union: the max of the
    ``lse`` (a non-finite one taken as 0), each range weighted by
    ``exp(lse_r − max)``, the weighted outputs and the weights summed in
    order and divided."""
    top = functools.reduce(torch.maximum, lses)
    top = torch.where(top.isfinite(), top, torch.zeros_like(top))
    ws = [torch.exp(lse.float() - top) for lse in lses]
    total = functools.reduce(torch.add, ws)
    acc = functools.reduce(torch.add, [w[..., None] * o.float()
                                       for w, o in zip(ws, outs)])
    return (acc / torch.clamp(total, min=1e-30)[..., None],
            torch.log(total) + top)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.comm, g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return _all_reduce(comm, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.dim, ctx.rank, ctx.n = dim, comm.rank_offset, x.shape[dim]
        return _gather(comm, x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), \
            None, None


class _LogSumExp(torch.autograd.Function):
    """``log Σ_r exp(lse_r)``: the max over the ranks (a non-finite one
    taken as 0, as ``torch.logsumexp`` does), plus the log of the sum of
    ``exp(lse_r − max)`` over the ranks.  At one rank the value is
    ``lse_r + log(1)`` and the gradient ``g · exp(0)``: ``lse_r``'s own."""

    @staticmethod
    def forward(ctx, lse, comm):
        top = _all_reduce(comm, lse, "max")
        top = torch.where(top.isfinite(), top, torch.zeros_like(top))
        out = torch.log(_all_reduce(comm, torch.exp(lse - top))) + top
        ctx.save_for_backward(lse, out)
        return out

    @staticmethod
    def backward(ctx, g):
        lse, out = ctx.saved_tensors
        return g * torch.exp(lse - out), None


class ModelAxis:
    """The model group of this rank: ``comm`` (a communicator of one rank a
    process: ``DistComm(1, group=...)``), this rank's place ``rank`` in it
    and its ``size`` M.  The primitives are the module docstring's."""

    def __init__(self, comm):
        if comm.p_local != 1:
            raise ValueError("the model axis holds one rank a process")
        self.comm = comm
        self.rank, self.size = comm.rank_offset, comm.p

    def splits(self, n: int) -> bool:
        """Whether a dimension of ``n`` is split over the axis: the rule
        table's ``fit_spec`` keeps the axis where it divides ``n``."""
        return n % self.size == 0

    def block(self, n: int) -> slice:
        """This rank's block of a dimension of ``n`` split over the axis."""
        c = n // self.size
        return slice(self.rank * c, (self.rank + 1) * c)

    def enter(self, x):
        return _Enter.apply(x, self.comm)

    def reduce(self, x):
        return _Reduce.apply(x, self.comm)

    def gather(self, x, dim: int):
        return _GatherOwn.apply(x, self.comm, dim)

    def full(self, t, dim: int, n: int):
        """Leaf ``t`` whole along ``dim`` (whole length ``n``) for a
        computation replicated over the axis: gathered where it is split
        (own-slice backward), else ``t``."""
        return t if t.shape[dim] == n else self.gather(t, dim)

    def gather_used(self, t, dim: int, n: int):
        """Leaf ``t`` whole along ``dim`` for a computation that each rank
        runs on a part of it: gathered where it is split (reduce-scatter
        backward), else ``enter``ed (all-reduce backward)."""
        from repro_torch.runtime.sharding import _GatherFn
        if t.shape[dim] == n and self.size > 1:
            return self.enter(t)
        return _GatherFn.apply(self.comm, [dim], None, None, t)[0]

    def logsumexp(self, lse):
        return _LogSumExp.apply(lse, self.comm)

    def gather_all(self, tensors, dims):
        """Each tensor all-gathered along its dim in rank order, one
        collective a dtype, forward only (serving): the query and the new
        K/V rows of a rank's heads made whole over the heads."""
        from repro_torch.runtime.sharding import gathered
        return gathered(self.comm, list(tensors), list(dims))

    def merge(self, out, lse):
        """The merged attention ``(out, lse)`` (float32) of every rank's
        partial over its slots: both all-gathered in rank order, in one
        collective, and combined by ``merge_partials``."""
        from repro_torch.runtime.sharding import gathered
        got, lses = gathered(self.comm, [out.float()[None], lse[None]],
                              [0, 0])
        return merge_partials(list(got), list(lses))
