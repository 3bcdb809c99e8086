"""SharedVector — a UPC shared array over a communicator.

The paper's base object is a shared array distributed over threads with
affinity: thread q owns a contiguous slice, and any thread may read any
element (at a cost the §5 models price).  ``SharedVector`` is that object
over a communicator's ``p`` ranks: it fixes the partitioning (contiguous
slices + a node ``Topology``) that ``AccessPattern`` indices refer to and
that ``IrregularGather`` plans against.  Its placed form is one tensor with a
leading rank axis, ``(P, shard_size, ...)``: row q is rank q's slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.plan import Topology

__all__ = ["SharedVector"]


@dataclasses.dataclass(frozen=True)
class SharedVector:
    """A length-``n`` vector (optional trailing feature dims) sharded in
    contiguous slices over the ranks of ``comm``.

    >>> from repro_torch.comm.communicator import LoopbackComm
    >>> sv = SharedVector(LoopbackComm(4, device="cpu"), n=64)
    >>> sv.shard_size == 16 and int(sv.owner_of(63)) == 3
    True
    >>> tuple(sv.put(np.arange(64, dtype=np.float32)).shape)
    (4, 16)
    """

    comm: object
    n: int
    topology: Topology | None = None

    def __post_init__(self):
        p = self.p
        assert self.n % p == 0, (
            f"n={self.n} must divide over {p} shards (pad upstream)")
        if self.topology is None:
            object.__setattr__(self, "topology", Topology(p, p))
        assert self.topology.num_shards == p

    @property
    def p(self) -> int:
        return self.comm.p

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def shard_size(self) -> int:
        return self.n // self.p

    def owner_of(self, idx):
        """Owning shard of global element(s) ``idx``."""
        return np.asarray(idx) // self.shard_size

    def node_of(self, idx):
        """Owning node (Topology) of global element(s) ``idx``."""
        return self.topology.node_of(self.owner_of(idx))

    def local_slice(self, shard: int) -> slice:
        return slice(shard * self.shard_size, (shard + 1) * self.shard_size)

    def put(self, values) -> torch.Tensor:
        """Place host values (length n, plus feature dims) on the device as
        ``(P, shard_size, ...)``."""
        values = torch.as_tensor(np.asarray(values))
        assert values.shape[0] == self.n, (tuple(values.shape), self.n)
        return values.reshape((self.p, self.shard_size)
                              + tuple(values.shape[1:])).to(
            self.device).contiguous()
