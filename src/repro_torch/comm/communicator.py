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
  (or the max) over ranks — the replicate put rung's ``psum``/``pmax``;
* ``reduce_scatter`` on ``(P, P * c, ...)`` gives rank ``r`` the sum (or
  the max) over ranks of their ``r``-th slices of ``c`` — the FSDP
  gradient's reduction (``runtime.sharding.make_gather``).

All four take ``async_op=True``: the copy is then enqueued on a side CUDA stream
and the returned ``Work`` makes the caller's stream wait for it in
``wait()`` — the ``start`` / ``finish`` window of the overlap rung.  On the
CPU every collective completes before it returns.

``DistComm`` runs the same three collectives between the processes of a
``torch.distributed`` group (gloo on the CPU, NCCL on the card).  Each
process holds ``p_local`` consecutive ranks ``[rank_offset, rank_offset +
p_local)`` of ``p = world * p_local``, so its tensors keep the leading
rank axis, of length ``p_local``.  A ``LoopbackComm`` is the one-process
case: ``p_local = p``, ``rank_offset = 0``.  A consumer builds the same
host plan in every process and takes its own rows of every per-rank table
(``local_rows``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import maximum

__all__ = ["LoopbackComm", "DistComm", "Work", "resolve_device"]


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


def _fold(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t``'s rows reduced in ascending order: ``"sum"`` or ``"max"``
    (XLA's: a NaN propagates, +0.0 beats -0.0)."""
    acc = t[0]
    for q in range(1, t.shape[0]):
        acc = acc + t[q] if op == "sum" else maximum(acc, t[q])
    if op == "sum" and t.dtype == torch.bfloat16 and t.device.type == "cpu":
        # the CPU's vector bf16 add writes a NaN as 0xFFFF, its scalar tail
        # as 0x7FC0: one NaN whatever the element's place in the row, so
        # that a DistComm's slices fold to LoopbackComm's bits
        acc = torch.where(acc.isnan(), acc.new_full((), float("nan")), acc)
    return acc


def _check_op(op: str) -> None:
    if op not in ("sum", "max"):
        raise ValueError(f"op must be 'sum' or 'max', not {op!r}")


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

    kind = "loopback"
    world = 1
    rank_offset = 0

    def __init__(self, p: int, device=None):
        assert p >= 1, p
        self.p = int(p)
        self.p_local = self.p
        self.device = resolve_device(device)
        self._side = None

    @property
    def local_rows(self) -> slice:
        """The rows of a ``(P, ...)`` table that this process holds."""
        return slice(0, self.p)

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
        _check_op(op)

        def reduce(t):
            return _fold(t, op).expand(t.shape).contiguous()

        return self._run(reduce, x, async_op)

    def reduce_scatter(self, x: torch.Tensor, op: str = "sum", *,
                       async_op: bool = False) -> Work:
        """``(P, P * c, ...)`` -> ``(P, c, ...)``: rank ``r`` gets the
        reduction over ranks of their ``r``-th slices, ``all_reduce``'s
        ``op`` in ascending rank order."""
        _check_op(op)
        p = self.p
        assert x.dim() >= 2 and x.shape[1] % p == 0, (x.shape, p)

        def scatter(t):
            c = t.shape[1] // p
            return _fold(t.reshape((p, p, c) + tuple(t.shape[2:])),
                         op).contiguous()

        return self._run(scatter, x, async_op)


class _DistWork(Work):
    """A ``torch.distributed`` collective in flight: ``wait()`` waits on
    the backend's work (on the card: makes the current stream wait for
    the NCCL stream) and then runs ``then`` on the received buffer."""

    def __init__(self, work, buf: torch.Tensor, then):
        super().__init__(buf)
        self._work, self._then = work, then

    def wait(self) -> torch.Tensor:
        if self._then is not None:
            if self._work is not None:
                self._work.wait()
            self._out, self._then = self._then(self._out), None
        return self._out


_BACKEND = {"cpu": "gloo", "cuda": "nccl"}


class DistComm:
    """``p_local`` ranks in each process of an initialised
    ``torch.distributed`` group: ``p = world * p_local`` ranks in all,
    this process holding ``[rank_offset, rank_offset + p_local)``.

    The collectives are ``LoopbackComm``'s, on this process's rows:

    * ``all_to_all`` ``(p_local, P_dst, s, ...)`` -> ``(p_local, P_src, s,
      ...)`` through one ``all_to_all_single`` over the world, the payload
      permuted to ``(world_dst, p_local_src, p_local_dst, s, ...)`` before
      and back after (every message padded to the plan's ``s_max`` /
      ``b_max``, as on one process);
    * ``all_gather`` ``(p_local, shard, ...)`` -> ``(p_local, P * shard,
      ...)``;
    * ``reduce_scatter`` ``(p_local, P * c, ...)`` -> ``(p_local, c,
      ...)`` bit for bit ``LoopbackComm``'s: neither gloo nor NCCL
      promises the ascending rank order of a float sum or XLA's ``max``,
      so the fold is done here.  Each process receives its ranks' slices
      from every rank (one ``all_to_all_single``) and folds them in rank
      order, so no process holds more than ``p_local`` payloads;
    * ``all_reduce`` ``(p_local, ...)`` -> ``(p_local, ...)``: the payload
      padded to ``P`` slices, ``reduce_scatter`` and ``all_gather``.

    The group's backend must serve the device: gloo for ``"cpu"``, NCCL
    for ``"cuda"`` (the default, as everywhere in the port).  Nothing
    falls back: without a group, or with another backend, it raises.
    """

    kind = "dist"

    def __init__(self, p_local: int = 1, device=None, *, group=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "DistComm needs an initialised torch.distributed process "
                "group (torch.distributed.init_process_group)")
        want = _BACKEND.get(torch.device(
            "cuda" if device is None else device).type)
        backend = str(dist.get_backend(group)).lower()
        if backend != want:
            raise ValueError(
                f"a DistComm on {device or 'cuda'} needs a {want} group; "
                f"this group's backend is {backend}")
        assert p_local >= 1, p_local
        self.device = resolve_device(device)
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.p_local = int(p_local)
        self.p = self.world * self.p_local
        self.rank_offset = self.rank * self.p_local

    @property
    def local_rows(self) -> slice:
        """The rows of a ``(P, ...)`` table that this process holds."""
        return slice(self.rank_offset, self.rank_offset + self.p_local)

    def _check(self, t: torch.Tensor) -> None:
        assert t.device == self.device, (t.device, self.device)
        assert t.shape[0] == self.p_local, (t.shape, self.p_local)

    def _gather(self, x: torch.Tensor, async_op: bool):
        """``(p_local, ...)`` -> backend work and the ``(P, ...)`` buffer
        it fills, rank-major."""
        x = x.contiguous()
        out = x.new_empty((self.p,) + tuple(x.shape[1:]))
        if hasattr(dist, "all_gather_single"):
            work = dist.all_gather_single(out, x, group=self.group,
                                          async_op=async_op)
        else:       # torch before all_gather_single
            work = dist.all_gather_into_tensor(out, x, group=self.group,
                                               async_op=async_op)
        return work, out

    @staticmethod
    def _done(work, buf, then, async_op: bool) -> Work:
        w = _DistWork(work if async_op else None, buf, then)
        return w if async_op else Work(w.wait())

    def all_to_all(self, buf: torch.Tensor, *, async_op: bool = False) -> Work:
        """``(p_local, P_dst, s, ...)`` -> ``(p_local, P_src, s, ...)``."""
        self._check(buf)
        assert buf.dim() >= 2 and buf.shape[1] == self.p, buf.shape
        w, pl = self.world, self.p_local
        tail = tuple(buf.shape[2:])
        send = buf.reshape((pl, w, pl) + tail).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=self.group,
                                      async_op=async_op)

        def unpermute(r):
            # (world_src, p_local_src, p_local_dst, ...) -> (p_local_dst,
            # P_src, ...)
            return r.permute((2, 0, 1) + tuple(range(3, r.dim()))).reshape(
                (pl, self.p) + tail).contiguous()

        return self._done(work, recv, unpermute, async_op)

    def all_gather(self, x: torch.Tensor, *, async_op: bool = False) -> Work:
        """``(p_local, shard, ...)`` -> ``(p_local, P * shard, ...)``."""
        self._check(x)
        work, out = self._gather(x, async_op)

        def spread(t):
            flat = t.reshape((1, -1) + tuple(t.shape[2:]))
            return flat.expand((self.p_local,)
                               + tuple(flat.shape[1:])).contiguous()

        return self._done(work, out, spread, async_op)

    def reduce_scatter(self, x: torch.Tensor, op: str = "sum", *,
                       async_op: bool = False) -> Work:
        """``(p_local, P * c, ...)`` -> ``(p_local, c, ...)``: local rank
        ``r`` gets the reduction over all ``p`` ranks of their ``r``-th
        slices, ``LoopbackComm``'s bit for bit."""
        _check_op(op)
        self._check(x)
        w, pl, p = self.world, self.p_local, self.p
        assert x.dim() >= 2 and x.shape[1] % p == 0, (x.shape, p)
        c = x.shape[1] // p
        tail = tuple(x.shape[2:])
        # (p_local_src, world_dst, p_local_dst, c, ...) -> (world_dst,
        # p_local_src, p_local_dst, c, ...): process d receives the slices
        # of its ranks from every rank
        send = x.reshape((pl, w, pl, c) + tail).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=self.group,
                                      async_op=async_op)

        def fold(r):
            # (world_src, p_local_src, ...): the P ranks in ascending order
            return _fold(r.reshape((p, pl, c) + tail), op).contiguous()

        return self._done(work, recv, fold, async_op)

    def sendrecv(self, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """One rank a process: ``x`` sent to rank ``dst`` and the tensor of
        ``x``'s shape that rank ``src`` sends returned (a permutation of the
        group's ranks, which every rank joins): one ``all_to_all_single``
        with one non-empty slice each way."""
        assert self.p_local == 1, self.p_local
        flat = x.contiguous().reshape(-1)
        n = flat.numel()
        sends, recvs = [0] * self.world, [0] * self.world
        sends[dst], recvs[src] = n, n
        out = flat.new_empty(n)
        dist.all_to_all_single(out, flat, output_split_sizes=recvs,
                               input_split_sizes=sends, group=self.group)
        return out.view(x.shape)

    def all_reduce(self, x: torch.Tensor, op: str = "sum", *,
                   async_op: bool = False) -> Work:
        """``(p_local, ...)`` -> ``(p_local, ...)``: every local rank gets
        the reduction over all ``p`` ranks, ``LoopbackComm``'s bit for
        bit: ``reduce_scatter`` of the payload padded to ``p`` slices,
        then ``all_gather``."""
        _check_op(op)
        self._check(x)
        shape = tuple(x.shape)
        flat = x.reshape(self.p_local, -1)
        n = flat.shape[1]
        c = max(1, -(-n // self.p))
        if self.p * c != n:
            flat = torch.nn.functional.pad(flat, (0, self.p * c - n))
        part = self.reduce_scatter(flat, op, async_op=async_op)

        def gather(_):
            out = self.all_gather(part.wait()).wait()
            return out[:, :n].reshape(shape)

        return self._done(None, flat, gather, async_op)
