"""Communicators: the collectives the strategy ladder runs between shards.

The JAX reference runs each shard's code inside ``shard_map`` and moves data
with ``all_to_all`` / ``all_gather`` over a mesh axis.  The port writes every
per-rank tensor with a leading rank axis ``(P, ...)`` and hands the
collectives to a communicator.  ``LoopbackComm`` holds all ``P`` ranks in one
process on one device, like the paper's UPC threads sharing one node:

* ``all_to_all`` on ``(P_src, P_dst, s, ...)`` is a transpose of the first
  two axes (rank ``q`` receives row ``s`` from rank ``s``);
* ``all_gather`` on ``(P, shard, ...)`` gives every rank its own copy of the
  whole ``(n, ...)`` vector;
* ``all_reduce`` on ``(P, ...)`` gives every rank its own copy of the sum
  (or the max) over ranks — the replicate put rung's ``psum``/``pmax``.

All three take ``async_op=True``: the copy is then enqueued on a side CUDA stream
and the returned ``Work`` makes the caller's stream wait for it in
``wait()`` — the ``start`` / ``finish`` window of the overlap rung.  On the
CPU every collective completes before it returns.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import maximum

__all__ = ["LoopbackComm", "Work", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for (or defaulted to) and no card is present;
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class Work:
    """A collective's result, possibly still being copied on a side stream.

    ``wait()`` makes the caller's current stream wait for the copy and
    returns the result tensor."""

    def __init__(self, out: torch.Tensor, event=None):
        self._out = out
        self._event = event

    def wait(self) -> torch.Tensor:
        if self._event is not None:
            torch.cuda.current_stream(self._out.device).wait_event(
                self._event)
            self._event = None
        return self._out


class LoopbackComm:
    """``p`` virtual ranks in one process on one device.

    >>> comm = LoopbackComm(2, device="cpu")
    >>> buf = torch.arange(8.).reshape(2, 2, 2)   # (P_src, P_dst, s)
    >>> comm.all_to_all(buf).wait()[1].tolist()   # what rank 1 receives
    [[2.0, 3.0], [6.0, 7.0]]
    >>> comm.all_gather(torch.tensor([[1.], [2.]])).wait().tolist()
    [[1.0, 2.0], [1.0, 2.0]]
    >>> comm.all_reduce(torch.tensor([[1., 5.], [2., 3.]]), "max").wait()[0]
    tensor([2., 5.])
    """

    def __init__(self, p: int, device=None):
        assert p >= 1, p
        self.p = int(p)
        self.device = resolve_device(device)
        self._side = None

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def _run(self, fn, src: torch.Tensor, async_op: bool) -> Work:
        assert src.device == self.device, (src.device, self.device)
        assert src.shape[0] == self.p, (src.shape, self.p)
        if not async_op or self.device.type != "cuda":
            return Work(fn(src))
        main = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(src)
            event = torch.cuda.Event()
            event.record(side)
        # src was allocated on the main stream and is read on the side one;
        # out was allocated on the side stream and is read on the main one
        src.record_stream(side)
        out.record_stream(main)
        return Work(out, event)

    def all_to_all(self, buf: torch.Tensor, *, async_op: bool = False) -> Work:
        """``(P_src, P_dst, s, ...)`` -> ``(P_dst, P_src, s, ...)``."""
        assert buf.dim() >= 2 and buf.shape[1] == self.p, buf.shape
        return self._run(lambda t: t.transpose(0, 1).contiguous(), buf,
                         async_op)

    def all_gather(self, x: torch.Tensor, *, async_op: bool = False) -> Work:
        """``(P, shard, ...)`` -> ``(P, P * shard, ...)``: every rank gets its
        own copy of the whole vector."""
        p = self.p

        def gather(t):
            flat = t.reshape((1, -1) + tuple(t.shape[2:]))
            return flat.expand((p,) + tuple(flat.shape[1:])).contiguous()

        return self._run(gather, x, async_op)

    def all_reduce(self, x: torch.Tensor, op: str = "sum", *,
                   async_op: bool = False) -> Work:
        """``(P, ...)`` -> ``(P, ...)``: every rank gets the reduction over
        ranks, ``op`` ``"sum"`` (ranks added in ascending order) or ``"max"``
        (XLA's semantics: a NaN propagates, +0.0 beats -0.0)."""
        if op not in ("sum", "max"):
            raise ValueError(f"op must be 'sum' or 'max', not {op!r}")

        def reduce(t):
            acc = t[0]
            for q in range(1, t.shape[0]):
                acc = acc + t[q] if op == "sum" else maximum(acc, t[q])
            return acc.expand(t.shape).contiguous()

        return self._run(reduce, x, async_op)
