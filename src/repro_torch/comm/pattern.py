"""AccessPattern — the optimization unit of the paper, workload-agnostic.

The paper's ladder optimizes *an index set*, not a workload: which global
elements of a shared vector does each accessor touch?  SpMV's EllPack ``J``
is one such set; a stencil's halo neighborhood and a router's token→expert
assignment are others.  ``AccessPattern`` captures exactly that set (plus the
two partitioning facts the planner needs: vector length ``n`` and accessor
count ``m``) so every consumer feeds the same planner, the same strategies,
and the same §5 models.

A numpy-only copy of ``repro.comm.pattern`` (no plan-cache key), kept in
the port so that it imports no JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np

__all__ = ["AccessPattern", "Destination"]


@dataclasses.dataclass(frozen=True)
class AccessPattern:
    """A static set of global indices read by each of ``m`` accessor rows.

    ``indices``: (m, r) int32, values in [0, n).  Accessor rows and vector
    elements are partitioned contiguously over the same shards: shard q of p
    owns vector slice [q*n/p, (q+1)*n/p) and accessor rows
    [q*m/p, (q+1)*m/p).  Rows needing fewer than r indices pad with an
    *owned* index (e.g. the row's own element) — owned accesses cost nothing.

    """

    indices: np.ndarray
    n: int

    def __post_init__(self):
        idx = np.asarray(self.indices)
        assert idx.ndim == 2, f"indices must be (m, r), got {idx.shape}"
        assert idx.dtype == np.int32, "indices must be int32"

    @property
    def m(self) -> int:
        return self.indices.shape[0]

    @property
    def r(self) -> int:
        return self.indices.shape[1]

    @functools.cached_property
    def digest(self) -> str:
        """Content hash of the index set and ``n``: schedules key the base
        plans they share by it (``comm.schedule.plan_key``)."""
        h = hashlib.sha1(np.ascontiguousarray(self.indices).tobytes())
        h.update(repr((self.indices.shape, self.n)).encode())
        return h.hexdigest()

    @classmethod
    def from_indices(cls, idx, n: int | None = None) -> "AccessPattern":
        """Any global index set: (m,) or (m, r) integers into a length-n
        vector.  ``n`` defaults to max(idx)+1 (pad upstream so n % p == 0)."""
        idx = np.asarray(idx)
        if idx.ndim == 1:
            idx = idx[:, None]
        if n is None:
            n = int(idx.max()) + 1
        assert idx.min() >= 0 and idx.max() < n, (
            f"indices must lie in [0, {n})")
        return cls(indices=np.ascontiguousarray(idx, dtype=np.int32), n=n)

    @classmethod
    def from_ellpack(cls, matrix) -> "AccessPattern":
        """The SpMV instance: row i accesses x[J[i, :]] (m == n)."""
        return cls.from_indices(matrix.cols, n=matrix.n)

    @classmethod
    def from_stencil5(cls, big_m: int, big_n: int, mprocs: int,
                      nprocs: int) -> "AccessPattern":
        """5-point stencil neighbors over an (mprocs × nprocs) tile grid.

        The field is flattened *tile-major*: rank r = ip*nprocs + kp owns the
        contiguous slice [r*tile, (r+1)*tile) holding its (m_loc × n_loc)
        tile row-major — exactly the SharedVector contiguous-ownership
        layout.  Each cell's pattern row holds its four neighbors' global
        ids; out-of-domain neighbors pad with the cell's own id (an owned,
        zero-cost access; the solver masks the global boundary anyway).
        """
        assert big_m % mprocs == 0 and big_n % nprocs == 0
        m_loc, n_loc = big_m // mprocs, big_n // nprocs
        tile = m_loc * n_loc

        def gid(gi, gk):
            """Global row/col -> tile-major global id (arrays ok)."""
            ip, i = gi // m_loc, gi % m_loc
            kp, k = gk // n_loc, gk % n_loc
            return (ip * nprocs + kp) * tile + i * n_loc + k

        gi, gk = np.meshgrid(np.arange(big_m), np.arange(big_n),
                             indexing="ij")
        own = gid(gi, gk)
        nbrs = []
        for di, dk in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ni, nk = gi + di, gk + dk
            ok = (ni >= 0) & (ni < big_m) & (nk >= 0) & (nk < big_n)
            nbrs.append(np.where(
                ok, gid(np.clip(ni, 0, big_m - 1), np.clip(nk, 0, big_n - 1)),
                own))
        # order pattern rows by owning rank then tile-row-major so accessor
        # row g is the accessor of vector element g (m == n, SpMV-like)
        order = np.argsort(own.ravel(), kind="stable")
        idx = np.stack([nb.ravel()[order] for nb in nbrs], axis=1)
        return cls.from_indices(idx.astype(np.int32), n=big_m * big_n)


@dataclasses.dataclass(frozen=True)
class Destination:
    """Named consumer slots that gathered values land in directly.

    The paper's UPCv3 unpack scatters each landed message into a full-length
    private copy (``mythread_x_copy``) — O(n) buffer work per exchange even
    when the consumer only reads O(halo) foreign values.  A ``Destination``
    instead *names* where each device wants values delivered: halo strips,
    EllPack slots, expert-capacity rows — any set of named arrays of global
    indices, one table per device.  The planner precomputes, per strategy, a
    recv-buffer→slot gather so ``OverlapHandle.finish()`` writes the landed
    messages straight into the named buffers, never materializing ``x_copy``
    (which stays available behind ``finish(materialize="full")``).

    ``indices`` is ``(p, L)`` int32: device q's flattened slot table, holding
    the *global* vector index each slot reads.  The sentinel ``Destination.
    ZERO`` (-1) marks slots that must read exactly 0.0 (out-of-domain halo
    cells, padding).  Every non-sentinel foreign index must appear in the
    ``AccessPattern`` the plan was built from — the planner raises otherwise,
    because that value would never arrive.

    >>> import numpy as np
    >>> d = Destination.from_slots(
    ...     up=np.array([[4, 5], [0, 1]]),     # 2 devices x 2 slots
    ...     left=np.array([[6], [-1]]))        # -1: guaranteed-zero slot
    >>> d.names, d.num_slots
    (('up', 'left'), 3)
    >>> d.split(np.array([[10., 11., 12.], [20., 21., 22.]]))['up']
    array([[10., 11.],
           [20., 21.]])
    """

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]  # per-device slot-array shapes
    indices: np.ndarray                  # (p, L) int32 global ids; -1 -> 0.0

    ZERO = -1

    def __post_init__(self):
        idx = np.asarray(self.indices)
        assert idx.ndim == 2, f"indices must be (p, L), got {idx.shape}"
        assert idx.dtype == np.int32, "indices must be int32"
        assert len(self.names) == len(self.shapes)
        total = sum(int(np.prod(s)) for s in self.shapes)
        assert total == idx.shape[1], (total, idx.shape[1])
        assert idx.min() >= self.ZERO, "indices must be >= -1 (ZERO sentinel)"

    @classmethod
    def from_slots(cls, **slots) -> "Destination":
        """Build from named per-device global-index tables.

        Each value is an ``(p, *slot_shape)`` integer array; entries equal to
        ``Destination.ZERO`` (-1) read as exactly 0.0.  Slot order follows
        keyword order, which is also the order ``split_local`` returns.
        """
        assert slots, "at least one named slot table required"
        names = tuple(slots)
        arrays = [np.asarray(slots[k]) for k in names]
        p = arrays[0].shape[0]
        assert all(a.shape[0] == p for a in arrays), (
            "every slot table needs the same leading device dim")
        shapes = tuple(a.shape[1:] for a in arrays)
        flat = np.concatenate([a.reshape(p, -1) for a in arrays], axis=1)
        return cls(names=names, shapes=shapes,
                   indices=np.ascontiguousarray(flat, dtype=np.int32))

    @property
    def p(self) -> int:
        return self.indices.shape[0]

    @property
    def num_slots(self) -> int:
        """Flattened slots per device (the O(L) the targeted unpack pays)."""
        return self.indices.shape[1]

    def key_bytes(self) -> bytes:
        """Content bytes for the plan-cache key (the reference's, byte for
        byte)."""
        head = "|".join(
            f"{n}:{','.join(map(str, s))}"
            for n, s in zip(self.names, self.shapes)).encode()
        return head + b"#" + np.ascontiguousarray(self.indices).tobytes()

    def split(self, flat):
        """Split a rank-stacked flat ``(P, L, ...)`` buffer back into named
        ``(P, *slot_shape, ...)`` slot arrays (numpy arrays and torch
        tensors alike)."""
        out, off = {}, 0
        p, rest = flat.shape[0], tuple(flat.shape[2:])
        for name, shape in zip(self.names, self.shapes):
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            out[name] = flat[:, off:off + size].reshape(
                (p,) + tuple(shape) + rest)
            off += size
        return out
