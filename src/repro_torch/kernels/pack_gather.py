"""The exchange fast path: pack and unpack around the all_to_all.

Wrappers of the CUDA kernels in ``csrc/pack_gather.cu`` and
``csrc/accumulate.cu`` (which replace the Pallas kernels of
``repro/kernels/pack_gather.py``):

* ``pack_gather`` — ``out[q, k] = x[q, idx[q, k]]``: each rank's condensed
  messages (or whole virtual blocks) from its owned shard into one
  contiguous send buffer;
* ``unpack_scatter_set`` — the full-materialization unpack: a fresh
  ``x_copy`` per rank, the landed rows scattered in, the owned rows copied
  in at the rank's offset (eq. 15 + eq. 14 in one call); given the plan's
  ``TileTable`` (kept by a ``ScatterTiles`` beside the plan) the card
  writes each output tile once;
* ``unpack_dest`` — the ``Destination``-targeted unpack: each of the L slots
  reads the landed buffer, the owned shard, or exactly 0.0; given the
  plan's ``DestTable`` (kept by a ``DestOrder`` beside the plan) the card
  reads one code a slot, in the order of the positions it gathers;
* ``unpack_dest_spmv`` — ``unpack_dest`` followed by the dest rungs' EllPack
  slot product, the slots never written out;
* ``accumulate_segments`` / ``accumulate_into`` — the push direction's
  combines (sender-side pack, own-target accumulate, blockwise block
  combine, landed-foreign fold) under ``add`` or ``max``, in ascending lane
  order through a ``SegmentTable`` built once per static index array.

Every tensor carries the leading rank axis ``(P, ...)`` and one launch
serves all ranks.  A CUDA tensor always goes through the kernel (or the call
raises); a CPU tensor takes the plain version in ``kernels/ref.py``.  Each
wrapper allocates its output with ``torch.empty`` and counts its launches in
``_build.LAUNCHES``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref

__all__ = ["pack_gather", "unpack_scatter_set", "unpack_dest",
           "unpack_dest_spmv", "TileTable", "tile_table", "ScatterTiles",
           "DestTable", "dest_table", "DestOrder", "SegmentTable",
           "segment_table", "accumulate_segments", "accumulate_into"]


def require(cond: bool, what=None) -> None:
    """Raise ValueError unless ``cond``: the kernels index raw pointers, so
    a shape they do not take must never reach them."""
    if not cond:
        raise ValueError(f"the kernel does not take these inputs: {what}")


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; raises on anything else (mixed devices, other backends)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("the CUDA kernels take contiguous tensors")
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _int32(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[2:]) * t.element_size()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are the same array: one object, or views of
    the same memory with one shape, stride and dtype.  The plan tables keep
    the arrays they were built from alive, so their memory is never reused
    while a table names it."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def pack_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[q, k] = x[q, idx[q, k]]``: x ``(P, shard, ...)`` any dtype,
    idx ``(P, m)`` int32 -> ``(P, m, ...)``.  Bit-exact."""
    require(x.dim() >= 2 and idx.dim() == 2, (x.shape, idx.shape))
    require(idx.shape[0] == x.shape[0], (x.shape, idx.shape))
    _int32(idx)
    if not on_card(x, idx):
        return kref.pack_gather_ref(x, idx)
    p, shard = x.shape[:2]
    m = idx.shape[1]
    out = torch.empty((p, m) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    _build.launch("pack_gather", "rt_pack_gather", x.device,
                  x.data_ptr(), idx.data_ptr(), out.data_ptr(), p, shard, m,
                  _row_bytes(x))
    return out


# a tile of the one-pass unpack holds about TILE_BYTES of one rank's output
# in shared memory; rows of TILE_BYTES or more get a tile each and are
# copied without it
TILE_BYTES = 16384


@dataclasses.dataclass(frozen=True)
class TileTable:
    """One landed index array ``idx (P, R)`` sorted by target, for the
    one-pass unpack: rank q's landed rows in target order are ``perm[q]``
    (their positions in recv), with targets ``tgt[q]``; the rows landing in
    output tile t (rows ``[t * tile_rows, (t + 1) * tile_rows)``) are
    entries ``[tile_ptr[q, t], tile_ptr[q, t + 1])``.  Of the landed rows
    that share a target only the last in recv order is kept (the rest sort
    after every tile, with target ``out_len``): the padding of every message
    lands on one dump row, which would otherwise give one tile all of it.
    ``idx`` is the array it was built from, ``out_len`` and ``row_bytes``
    the output it serves."""

    idx: torch.Tensor          # (P, R) int32
    tgt: torch.Tensor          # (P, R) int32, ascending in each rank
    perm: torch.Tensor         # (P, R) int32
    tile_ptr: torch.Tensor     # (P, tiles + 1) int32
    out_len: int
    row_bytes: int
    tile_rows: int


def tile_table(idx: torch.Tensor, *, out_len: int,
               row_bytes: int) -> TileTable:
    """Build the ``TileTable`` of ``idx (P, R)`` (values in ``[0,
    out_len)``) for rows of ``row_bytes`` on idx's device, once per plan:
    stable ``torch.sort``s by target (before and after dropping all but the
    last of each target's rows) and a ``searchsorted`` of the tile bounds,
    ``TILE_BYTES // row_bytes`` rows a tile (at least one)."""
    require(idx.dim() == 2 and out_len > 0 and row_bytes > 0,
            (idx.shape, out_len, row_bytes))
    p = idx.shape[0]
    if idx.numel():
        require(int(idx.min()) >= 0 and int(idx.max()) < out_len,
                "idx outside [0, out_len)")
    tile_rows = max(1, TILE_BYTES // row_bytes)
    tiles = -(-out_len // tile_rows)
    tgt, perm = torch.sort(idx.to(torch.int64), dim=1, stable=True)
    last = torch.ones_like(tgt, dtype=torch.bool)
    last[:, :-1] = tgt[:, :-1] != tgt[:, 1:]
    tgt, kept = torch.sort(torch.where(last, tgt, out_len), dim=1,
                           stable=True)
    bounds = (torch.arange(tiles + 1, device=idx.device) * tile_rows
              ).clamp_(max=out_len).expand(p, -1).contiguous()
    tile_ptr = torch.searchsorted(tgt, bounds)
    return TileTable(idx=idx, tgt=tgt.to(torch.int32),
                     perm=perm.gather(1, kept).to(torch.int32),
                     tile_ptr=tile_ptr.to(torch.int32), out_len=out_len,
                     row_bytes=row_bytes, tile_rows=tile_rows)


class ScatterTiles:
    """A plan's ``tile_table``s on each card: built at the plan's first
    call there for an output of ``out_len`` rows of ``row_bytes``, from the
    landed index array that call gives, and kept beside the plan.  Calling
    it with another array builds that array's table instead.  A build
    syncs with the host (``tile_table``), so the plan's first call on a
    card must run outside a CUDA-graph capture; later calls only look the
    table up."""

    def __init__(self):
        self._by_key: dict = {}

    def __call__(self, idx: torch.Tensor, *, out_len: int,
                 row_bytes: int) -> TileTable | None:
        """The table of ``idx``, or None for a tensor on the CPU."""
        if not on_card(idx):
            return None
        key = (idx.device, out_len, row_bytes)
        hit = self._by_key.get(key)
        if hit is None or not _same(hit[0], idx):
            hit = (idx, tile_table(idx, out_len=out_len,
                                   row_bytes=row_bytes))
            self._by_key[key] = hit
        return hit[1]


def unpack_scatter_set(recv: torch.Tensor, idx: torch.Tensor,
                       x_own: torch.Tensor, offsets: torch.Tensor, *,
                       out_len: int, copy_own: bool = True,
                       table: TileTable | None = None) -> torch.Tensor:
    """Per rank q: ``x_copy = zeros(out_len, ...)``, ``x_copy[idx[q]] =
    recv[q]``, then (``copy_own``) ``x_copy[offsets[q] : offsets[q] + rows]
    = x_own[q]`` — the own rows land after (win over) the scatter.

    recv ``(P, R, ...)``, idx ``(P, R)`` int32, x_own ``(P, rows, ...)``,
    offsets ``(P,)`` int32 -> ``(P, out_len, ...)``.  Bit-exact outside
    duplicate targets (the dump rows), whose contents are unspecified.
    ``table``: ``tile_table(idx, ...)`` for this out_len and row width
    (``ScatterTiles``), which the card's one-pass kernel reads; None runs
    the three-phase kernel, and the CPU ignores it."""
    require(recv.dim() == x_own.dim()
            and recv.shape[2:] == x_own.shape[2:], (recv.shape, x_own.shape))
    require(idx.shape == recv.shape[:2], (idx.shape, recv.shape))
    require(offsets.shape == (x_own.shape[0],), offsets.shape)
    require(recv.dtype == x_own.dtype, (recv.dtype, x_own.dtype))
    _int32(idx, offsets)
    if not on_card(recv, idx, x_own, offsets):
        return kref.unpack_scatter_set_ref(recv, idx, x_own, offsets,
                                           out_len=out_len,
                                           copy_own=copy_own)
    p, rows = x_own.shape[:2]
    out = torch.empty((p, out_len) + tuple(x_own.shape[2:]),
                      dtype=x_own.dtype, device=x_own.device)
    head = (recv.data_ptr(), x_own.data_ptr(), offsets.data_ptr())
    if table is not None:
        require(_same(table.idx, idx) and table.out_len == out_len
                and table.row_bytes == _row_bytes(x_own),
                "the table was built for another index array or output")
        on_card(idx, table.tgt, table.perm, table.tile_ptr)
        _build.launch("unpack_scatter_set", "rt_unpack_scatter_tiles",
                      x_own.device, *head, table.tgt.data_ptr(),
                      table.perm.data_ptr(), table.tile_ptr.data_ptr(),
                      out.data_ptr(), p, recv.shape[1], rows, out_len,
                      _row_bytes(x_own), table.tile_rows, int(copy_own))
        return out
    _build.launch("unpack_scatter_set", "rt_unpack_scatter_set",
                  x_own.device, recv.data_ptr(), idx.data_ptr(),
                  x_own.data_ptr(), offsets.data_ptr(), out.data_ptr(), p,
                  recv.shape[1], rows, out_len, _row_bytes(x_own),
                  int(copy_own))
    return out


_DEST_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# slots a group of the planners' dest tables holds, the most a group may
# hold (csrc kDestSlots: its values in shared memory, its slots in uint16),
# and the code of a zero slot (csrc kZeroCode)
GROUP_SLOTS = 49152
MAX_GROUP_SLOTS = 57344
ZERO_CODE = -(1 << 31)


@dataclasses.dataclass(frozen=True)
class DestTable:
    """One plan's four dest arrays in the card's compact, sorted form.

    Each slot is one int32 code: a foreign slot its recv position, an owned
    slot ``~own`` (its x position, complemented), a zero slot ``ZERO_CODE``.
    The unselected index of every slot is 0, except that where ``shift`` is
    given an owned slot's recv index is ``own + shift[q]`` (the replicate
    rung, whose recv is the whole vector).  Within each group of ``group``
    consecutive slots of a rank the entries are sorted by code (ties in slot
    order), so each group's gathers walk positions in order; ``slot`` holds
    the uint16 slot of each entry in its group.  ``arrays`` are the arrays
    it was built from; the codes read recv below ``recv_len`` and x below
    ``x_len``."""

    arrays: tuple              # (src_idx, own_idx, own_mask, rem_mask)
    code: torch.Tensor         # (P, L) int32
    slot: torch.Tensor         # (P, L) int16 (uint16 bits)
    shift: torch.Tensor | None  # (P,) int32
    group: int
    recv_len: int
    x_len: int


def dest_codes(src_idx, own_idx, own_mask, rem_mask):
    """``(code (P, L) int32, shift (P,) int32 or None)`` where the arrays
    have their planner's structure (``comm.plan.attach_destination``): masks
    0/1 and never both 1, the unselected index 0 — except an owned slot's
    recv index, which may be ``own + shift[q]`` for one shift a rank — and
    positions that fit a code.  None where they do not: the kernels then
    read the arrays themselves."""
    own_i, rem_i = own_mask.to(torch.int32), rem_mask.to(torch.int32)
    if bool(((own_i | rem_i) & ~1).any()):
        return None                           # a mask other than 0/1
    own, rem = own_i.bool(), rem_i.bool()
    src, oidx = src_idx.to(torch.int64), own_idx.to(torch.int64)
    if bool((own & rem).any()) or bool(torch.where(own, 0, oidx).any()) \
            or bool(torch.where(own | rem, 0, src).any()):
        return None
    if bool((torch.where(rem, src, 0) < 0).any()) \
            or bool((torch.where(own, oidx, 0) < 0).any()):
        return None
    shift = None
    if bool(torch.where(own, src, 0).any()):
        # the replicate rung: each owned slot reads recv at own + shift[q]
        d = src - oidx
        hi = torch.where(own, d, torch.iinfo(torch.int64).min).amax(1)
        lo = torch.where(own, d, torch.iinfo(torch.int64).max).amin(1)
        has = own.any(1)
        if bool((has & (hi != lo)).any()) or bool((has & (lo < 0)).any()) \
                or bool((hi >= 1 << 31).any()):
            return None
        shift = torch.where(has, hi, 0).to(torch.int32)
    code = torch.where(rem, src, torch.where(own, ~oidx, ZERO_CODE))
    return code.to(torch.int32), shift


def dest_table(src_idx, own_idx, own_mask, rem_mask, *,
               group: int = GROUP_SLOTS) -> DestTable | None:
    """Build the ``DestTable`` of a plan's dest arrays ``(P, L)`` on their
    device, once per plan, in groups of ``group`` slots (at most
    ``MAX_GROUP_SLOTS``): ``dest_codes`` and a stable ``torch.sort`` of each
    group by code.  None where ``dest_codes`` refuses the arrays."""
    require(0 < group <= MAX_GROUP_SLOTS, group)
    got = dest_codes(src_idx, own_idx, own_mask, rem_mask)
    if got is None:
        return None
    code, shift = got
    p, L = code.shape
    rem = rem_mask != 0
    own = own_mask != 0
    reads = torch.where(rem, src_idx.to(torch.int64), 0)
    if shift is not None:
        reads = torch.maximum(reads, torch.where(
            own, own_idx.to(torch.int64) + shift[:, None], 0))
    x_reads = torch.where(own, own_idx.to(torch.int64), 0)
    entry = torch.arange(L, device=code.device)
    start = entry // group * group
    order = torch.sort(entry // group * (1 << 32)
                       + (code.to(torch.int64) + (1 << 31)),
                       dim=1, stable=True).indices
    slot = order - start
    slot = torch.where(slot >= 1 << 15, slot - (1 << 16), slot)
    return DestTable(
        arrays=(src_idx, own_idx, own_mask, rem_mask),
        code=code.gather(1, order).contiguous(),
        slot=slot.to(torch.int16).contiguous(), shift=shift, group=group,
        recv_len=int(reads.max()) + 1 if L else 1,
        x_len=int(x_reads.max()) + 1 if L else 1)


class DestOrder:
    """A plan's ``dest_table`` on each card, in groups of whole rows of
    ``row`` slots (``GROUP_SLOTS // row`` rows, so that ``unpack_dest_spmv``
    can sum a group's rows): built at the plan's first call there, from the
    dest arrays that call gives, and kept beside the plan.  Calling it with
    other arrays builds their table instead.  A build syncs with the host
    (``dest_codes`` checks the arrays' structure), so the plan's first call
    on a card must run outside a CUDA-graph capture; later calls only look
    the table up."""

    def __init__(self, row: int = 1):
        self.group = GROUP_SLOTS // row * row
        self._by_device: dict = {}

    def __call__(self, src_idx, own_idx, own_mask,
                 rem_mask) -> DestTable | None:
        """The table of the four arrays, or None where the card takes none
        (tensors on the CPU, rows wider than ``GROUP_SLOTS``, arrays without
        their planner's structure)."""
        arrays = (src_idx, own_idx, own_mask, rem_mask)
        if not on_card(*arrays) or not self.group:
            return None
        hit = self._by_device.get(src_idx.device)
        if hit is None or not all(map(_same, hit[0], arrays)):
            hit = (arrays, dest_table(*arrays, group=self.group))
            self._by_device[src_idx.device] = hit
        return hit[1]


def _dest_checks(recv_flat, x_local, src_idx, own_idx, own_mask, rem_mask):
    require(recv_flat.shape[2:] == x_local.shape[2:],
            (recv_flat.shape, x_local.shape))
    require(recv_flat.dtype == x_local.dtype,
            (recv_flat.dtype, x_local.dtype))
    shape = src_idx.shape
    require(len(shape) == 2 and shape[0] == x_local.shape[0], shape)
    require(own_idx.shape == own_mask.shape == rem_mask.shape == shape,
            (own_idx.shape, own_mask.shape, rem_mask.shape))
    _int32(src_idx, own_idx)
    for m in (own_mask, rem_mask):
        if m.dtype != torch.int8:
            raise TypeError(f"masks must be int8, got {m.dtype}")


def _table_args(table: DestTable, recv_flat, x_local, arrays) -> tuple:
    """The table's part of a launch, after checking that it was built from
    these arrays and that recv and x hold every position it reads."""
    require(all(map(_same, table.arrays, arrays)),
            "the table was built for other dest arrays")
    require(recv_flat.dim() == 2 and recv_flat.shape[1] >= table.recv_len
            and x_local.shape[1] >= table.x_len,
            "recv or x is shorter than the positions the table reads")
    parts = (table.code, table.slot) + (
        () if table.shift is None else (table.shift,))
    on_card(recv_flat, *parts)
    return (table.code.data_ptr(), table.slot.data_ptr(),
            None if table.shift is None else table.shift.data_ptr())


def unpack_dest(recv_flat: torch.Tensor, x_local: torch.Tensor,
                src_idx: torch.Tensor, own_idx: torch.Tensor,
                own_mask: torch.Tensor, rem_mask: torch.Tensor, *,
                table: DestTable | None = None) -> torch.Tensor:
    """Slot l of rank q gets ``recv_flat[q, src[q, l]]·rem[q, l] +
    x_local[q, own[q, l]]·own[q, l]``.

    recv_flat ``(P, R, ...)``, x_local ``(P, shard, ...)``, src/own ``(P, L)``
    int32, masks ``(P, L)`` int8 -> ``(P, L, ...)``; float32 or bfloat16 on
    the card.  Bit-exact, -0.0 and inf included; a NaN stays a NaN (its
    payload bits are the platform's).  ``table``: the plan's ``dest_table``
    of these four arrays (``DestOrder``), which the card reads in their
    place where x has no trailing dimensions; None runs the kernel that
    reads the arrays, and the CPU ignores it."""
    arrays = (src_idx, own_idx, own_mask, rem_mask)
    _dest_checks(recv_flat, x_local, *arrays)
    if not on_card(recv_flat, x_local, *arrays):
        return kref.unpack_dest_ref(recv_flat, x_local, *arrays)
    if x_local.dtype not in _DEST_DTYPES:
        raise TypeError(f"unpack_dest runs float32 or bfloat16 on the card, "
                        f"not {x_local.dtype}")
    p, slots = src_idx.shape
    out = torch.empty((p, slots) + tuple(x_local.shape[2:]),
                      dtype=x_local.dtype, device=x_local.device)
    dtype = _DEST_DTYPES[x_local.dtype]
    if table is not None and x_local.dim() == 2:
        _build.launch("unpack_dest", "rt_unpack_dest_sorted", x_local.device,
                      recv_flat.data_ptr(), x_local.data_ptr(),
                      *_table_args(table, recv_flat, x_local, arrays),
                      out.data_ptr(), p, recv_flat.shape[1],
                      x_local.shape[1], slots, table.group, dtype)
        return out
    _build.launch("unpack_dest", "rt_unpack_dest", x_local.device,
                  recv_flat.data_ptr(), x_local.data_ptr(),
                  src_idx.data_ptr(), own_idx.data_ptr(),
                  own_mask.data_ptr(), rem_mask.data_ptr(), out.data_ptr(),
                  p, recv_flat.shape[1], x_local.shape[1], slots,
                  math.prod(x_local.shape[2:]), dtype)
    return out


def unpack_dest_spmv(recv_flat: torch.Tensor, x_local: torch.Tensor,
                     src_idx: torch.Tensor, own_idx: torch.Tensor,
                     own_mask: torch.Tensor, rem_mask: torch.Tensor,
                     vals: torch.Tensor, diag: torch.Tensor | None = None,
                     *, table: DestTable | None = None) -> torch.Tensor:
    """``y[q, i] = diag[q, i]·x_local[q, i] + Σ_j vals[q, i, j]·slot[q, i·r
    + j]``, slot as ``unpack_dest`` computes it from the first six
    arguments, never written out; float32 sums.

    recv_flat ``(P, R)``, x_local ``(P, shard)``, the dest arrays ``(P,
    rows·r)``, vals ``(P, rows, r)``, diag ``(P, shard)`` (rows = shard) or
    None (no diagonal term) -> y ``(P, rows)``; on the card one dtype,
    float32 or bfloat16.  ``table``: the plan's ``dest_table`` in groups of
    whole rows (``DestOrder(row=r)``), which the card reads in place of the
    arrays and cannot run without (a caller whose arrays get no table
    composes ``unpack_dest`` with the product); the CPU ignores it.  The
    card's launch counts as one of ``unpack_dest``."""
    arrays = (src_idx, own_idx, own_mask, rem_mask)
    _dest_checks(recv_flat, x_local, *arrays)
    require(x_local.dim() == 2 and vals.dim() == 3, (x_local.shape,
                                                     vals.shape))
    p, rows, r = vals.shape
    require(src_idx.shape == (p, rows * r), (src_idx.shape, vals.shape))
    if diag is not None:
        require(diag.shape == (p, rows) == x_local.shape,
                (diag.shape, x_local.shape))
    dense = (recv_flat, x_local, *arrays, vals) + (
        () if diag is None else (diag,))
    if not on_card(*dense):
        return kref.unpack_dest_spmv_ref(recv_flat, x_local, *arrays, vals,
                                         diag)
    for t in dense[:2] + dense[6:]:
        if t.dtype != x_local.dtype or t.dtype not in _DEST_DTYPES:
            raise TypeError("unpack_dest_spmv runs float32 or bfloat16 on "
                            "the card, one dtype for recv, x, vals and diag")
    require(table is not None and table.group % r == 0,
            "the card runs unpack_dest_spmv through a dest table in groups "
            "of whole rows")
    y = torch.empty((p, rows), dtype=vals.dtype, device=vals.device)
    _build.launch("unpack_dest", "rt_unpack_dest_spmv_sorted", vals.device,
                  recv_flat.data_ptr(), x_local.data_ptr(),
                  *_table_args(table, recv_flat, x_local, arrays),
                  vals.data_ptr(), None if diag is None else diag.data_ptr(),
                  y.data_ptr(), p, recv_flat.shape[1], x_local.shape[1],
                  rows, r, table.group // r, _DEST_DTYPES[vals.dtype])
    return y


# --------------------------------------------------------------------------
# Segment accumulate (push direction)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentTable:
    """One static index array ``idx (P, K)`` sorted by target row, stably.

    Rank q's lanes that target row t are ``perm[q, seg_ptr[q, t] :
    seg_ptr[q, t + 1]]``, in ascending lane order, for every live row
    ``t < live_len``.  Lanes that target a row at or above ``live_len`` (the
    dump rows callers slice off) and padding lanes (which carry the reduce
    identity by construction) are left out; ``pad_rows[q, t]`` is 1 where a
    padding lane targeted row t.  ``perm`` keeps all K lanes per rank: the
    left-out ones sort last and are never read.  ``long_rows`` lists the
    rows (``q * live_len + t``) with more than ``LONG_LANES`` lanes, which
    the kernel folds one block each (scalar rows only).  ``runs`` cuts the
    other live rows into runs for the scalar kernel, one block each: row
    ``runs[b, 0] <= g < runs[b, 1]`` (``g = q * live_len + t``, at most
    ``RUN_ROWS`` rows of one rank) folds lanes ``perm[q, runs[b, 2] :
    runs[b, 3]]`` (fewer than ``RUN_LANES``).  ``idx`` is the array the
    table was built from: the kernels fold only that array."""

    idx: torch.Tensor                  # (P, K) int32
    perm: torch.Tensor                 # (P, K) int32
    seg_ptr: torch.Tensor              # (P, live_len + 1) int32
    pad_rows: torch.Tensor | None      # (P, live_len) int8
    long_rows: torch.Tensor            # (n_long,) int32
    runs: torch.Tensor                 # (n_runs, 4) int32
    out_len: int
    live_len: int

    def longest(self) -> int:
        """The most lanes any live row folds: its chain of dependent
        combines is the fold's serial work."""
        return int((self.seg_ptr[:, 1:] - self.seg_ptr[:, :-1]).max())


# rows with more lanes get a block of their own on scalar rows
LONG_LANES = 64
# a run of the scalar short-row kernel: at most RUN_ROWS rows (eight for
# each of a block's 256 threads, csrc/accumulate.cu kRunRows) and fewer than
# RUN_LANES lanes (parked in its shared memory, kRunLanes)
RUN_ROWS = 2048
RUN_LANES = 2048


def _runs(seg_ptr: torch.Tensor) -> torch.Tensor:
    """The runs of ``SegmentTable`` from its ``seg_ptr`` ``(P, live + 1)``:
    cut the live rows of every rank before each multiple of ``RUN_ROWS``,
    around each long row, and where ``seg_ptr // (RUN_LANES - LONG_LANES)``
    steps; drop the long rows.  A run's rows then start within ``RUN_LANES
    - LONG_LANES`` lanes of each other and its last row has at most
    ``LONG_LANES`` lanes, so it holds fewer than ``RUN_LANES``."""
    sp = seg_ptr.to(torch.int64)
    long = (sp[:, 1:] - sp[:, :-1]) > LONG_LANES
    p, live = long.shape
    if p * live == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=sp.device)
    step = sp[:, :-1] // (RUN_LANES - LONG_LANES)
    cut = long.clone()
    cut[:, ::RUN_ROWS] = True
    cut[:, 1:] |= long[:, :-1] | (step[:, 1:] != step[:, :-1])
    first = torch.nonzero(cut.reshape(-1)).reshape(-1)
    end = torch.cat([first[1:], first.new_full((1,), p * live)])
    keep = ~long.reshape(-1)[first]
    first, end = first[keep], end[keep]
    rank = first // live
    flat = sp.reshape(-1)
    lo = flat[first + rank]                   # sp[rank, first - rank * live]
    hi = flat[end + rank]
    return torch.stack([first, end, lo, hi], dim=1).to(torch.int32)


def segment_table(idx: torch.Tensor, *, out_len: int,
                  live_len: int | None = None,
                  pad: torch.Tensor | None = None) -> SegmentTable:
    """Build the ``SegmentTable`` of ``idx (P, K)`` (values in ``[0,
    out_len)``) on idx's device, once per static index array: a stable
    ``torch.sort`` by target and a per-rank ``bincount``/``cumsum``.

    ``live_len`` (default ``out_len``): rows at or above it are never
    folded.  ``pad (P, K)`` bool: lanes that carry the reduce identity,
    left out of the fold and recorded in ``pad_rows``."""
    require(idx.dim() == 2, idx.shape)
    p, k = idx.shape
    live = out_len if live_len is None else int(live_len)
    require(0 <= live <= out_len and k < 2 ** 31, (live, out_len, k))
    rows = idx.to(torch.int64)
    if rows.numel():
        require(int(rows.min()) >= 0 and int(rows.max()) < out_len,
                "idx outside [0, out_len)")
    drop = rows >= live
    if pad is not None:
        require(pad.shape == idx.shape, (pad.shape, idx.shape))
        pad = pad.to(device=idx.device, dtype=torch.bool) & ~drop
        drop = drop | pad
    key = torch.where(drop, live, rows)
    perm = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    base = torch.arange(p, device=idx.device)[:, None]
    counts = torch.bincount((key + base * (live + 1)).reshape(-1),
                            minlength=p * (live + 1)).reshape(p, live + 1)
    seg_ptr = torch.zeros((p, live + 1), dtype=torch.int32,
                          device=idx.device)
    seg_ptr[:, 1:] = counts[:, :live].cumsum(1)
    long_rows = torch.nonzero(counts[:, :live].reshape(-1) > LONG_LANES
                              ).reshape(-1).to(torch.int32)
    pad_rows = None
    if pad is not None:
        hit = torch.where(pad, rows + base * live, p * live).reshape(-1)
        pad_rows = (torch.bincount(hit, minlength=p * live + 1)[:p * live]
                    > 0).to(torch.int8).reshape(p, live)
    return SegmentTable(idx=idx, perm=perm.contiguous(), seg_ptr=seg_ptr,
                        pad_rows=pad_rows, long_rows=long_rows,
                        runs=_runs(seg_ptr), out_len=out_len, live_len=live)


_FOLD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
# "set" is add after the caller's winner mask
_FOLD_REDUCES = {"add": 0, "set": 0, "max": 1}


def _fold_checks(vals: torch.Tensor, idx: torch.Tensor, reduce: str) -> None:
    require(vals.dim() >= 2 and idx.dim() == 2
            and tuple(idx.shape) == tuple(vals.shape[:2]),
            (vals.shape, idx.shape))
    require(reduce in _FOLD_REDUCES, reduce)
    _int32(idx)


def _fold(kernel: str, entry: str, init, vals, idx, reduce: str, table,
          out_len: int) -> torch.Tensor:
    """Launch one fold of ``vals`` into a fresh ``(P, out_len, ...)``
    through ``table``, which must have been built from this ``idx``."""
    p = vals.shape[0]
    if vals.dtype not in _FOLD_DTYPES:
        raise TypeError(f"{kernel} runs float32, bfloat16 or int32 on the "
                        f"card, not {vals.dtype}")
    if table is None:
        raise ValueError(f"{kernel} on the card folds through a SegmentTable "
                         "built once from idx (segment_table)")
    require(table.idx.data_ptr() == idx.data_ptr()
            and table.idx.shape == idx.shape and table.out_len == out_len,
            "the table was built for another index array or out_len")
    parts = [table.perm, table.seg_ptr, table.long_rows, table.runs]
    if table.pad_rows is not None:
        parts.append(table.pad_rows)
    on_card(vals, *parts)
    dev = vals.device
    feat = math.prod(vals.shape[2:])
    out = torch.empty((p, out_len) + tuple(vals.shape[2:]), dtype=vals.dtype,
                      device=dev)
    init_ptr = None if init is None else init.data_ptr()
    pad_ptr = None if table.pad_rows is None else table.pad_rows.data_ptr()
    common = (vals.data_ptr(), table.perm.data_ptr(), table.seg_ptr.data_ptr(),
              pad_ptr)
    dtype, red = _FOLD_DTYPES[vals.dtype], _FOLD_REDUCES[reduce]
    head = () if init is None else (init_ptr,)
    short = (kernel, entry, dev, *head, *common, table.runs.data_ptr(),
             out.data_ptr(), p, idx.shape[1], table.live_len, out_len, feat,
             table.runs.shape[0], dtype, red)
    # scalar rows past LONG_LANES fold in blocks of their own, each on an
    # SM of its own: launched first, on a stream of higher priority, with
    # the short rows beside them on the caller's stream behind a gate that
    # opens once every long-row block has started (so they find empty SMs);
    # wider rows fold every row one thread per feature element.  The gate's
    # target is a host-side running total, which a CUDA graph would freeze
    # at capture: under capture the long rows count nothing and no gate is
    # launched: a captured fold gives the same bits, but its short rows may
    # take the SMs before its long rows start (the serialized step of
    # PERF.md §6 that the gate removes)
    n_long = table.long_rows.numel() if feat == 1 else 0
    if not n_long:
        _build.launch(*short)
        return out
    main = torch.cuda.current_stream(dev)
    chains = _Chains.on(dev)
    gated = not torch.cuda.is_current_stream_capturing()
    chains.stream.wait_stream(main)
    with torch.cuda.stream(chains.stream):
        _build.launch(None, "rt_fold_long_rows", dev, init_ptr, *common,
                      table.long_rows.data_ptr(), out.data_ptr(), p,
                      idx.shape[1], table.live_len, out_len, n_long, dtype,
                      red, chains.started.data_ptr() if gated else None)
    if gated:
        chains.launched += n_long
        _build.launch(None, "rt_fold_gate", dev, chains.started.data_ptr(),
                      chains.launched)
    _build.launch(*short)
    # everything the chain stream read was allocated on the main stream,
    # which waits for it before running (or freeing) anything after
    main.wait_stream(chains.stream)
    return out


class _Chains:
    """A device's long-row stream (priority -1, above the default streams),
    the device counter its blocks add themselves to as they start, and the
    number of blocks launched on it so far."""

    _by_device: dict = {}

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device=device, priority=-1)
        self.started = torch.zeros(1, dtype=torch.int64, device=device)
        self.launched = 0

    @classmethod
    def on(cls, device) -> "_Chains":
        if device not in cls._by_device:
            cls._by_device[device] = cls(device)
        return cls._by_device[device]


def accumulate_segments(vals: torch.Tensor, idx: torch.Tensor, *,
                        out_len: int, reduce: str = "add",
                        table: SegmentTable | None = None) -> torch.Tensor:
    """Per rank q: ``acc = full((out_len, ...), identity)``, then combine
    ``vals[q, k]`` into ``acc[idx[q, k]]`` in ascending k — add (``set`` is
    add after the caller's winner mask) or max.

    vals ``(P, K, ...)``, idx ``(P, K)`` int32 -> ``(P, out_len, ...)``;
    float32, bfloat16 or int32 on the card.  ``table`` is
    ``segment_table(idx, out_len=out_len, ...)``, built once from this very
    idx tensor; the card requires it (the CPU ignores it).  Bit-exact on the
    live rows; rows at
    or above ``table.live_len`` are unspecified, and padding lanes the table
    left out must carry the reduce identity."""
    _fold_checks(vals, idx, reduce)
    if not on_card(vals, idx):
        return kref.accumulate_segments_ref(vals, idx, out_len=out_len,
                                            reduce=reduce)
    return _fold("accumulate_segments", "rt_accumulate_segments", None, vals,
                 idx, reduce, table, out_len)


def accumulate_into(init: torch.Tensor, vals: torch.Tensor,
                    idx: torch.Tensor, *, reduce: str = "add",
                    table: SegmentTable | None = None) -> torch.Tensor:
    """The same combine, continuing from ``init (P, L, ...)`` (not
    modified) -> ``(P, L, ...)``; ``table`` as for ``accumulate_segments``
    with ``out_len = L``."""
    _fold_checks(vals, idx, reduce)
    require(init.dim() == vals.dim() and init.shape[0] == vals.shape[0]
            and init.shape[2:] == vals.shape[2:], (init.shape, vals.shape))
    require(init.dtype == vals.dtype, (init.dtype, vals.dtype))
    if not on_card(init, vals, idx):
        return kref.accumulate_into_ref(init, vals, idx, reduce=reduce)
    return _fold("accumulate_into", "rt_accumulate_into", init, vals, idx,
                 reduce, table, init.shape[1])
