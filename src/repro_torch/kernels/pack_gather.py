"""The exchange fast path: pack and unpack around the all_to_all.

Wrappers of the CUDA kernels in ``csrc/pack_gather.cu`` and
``csrc/accumulate.cu`` (which replace the Pallas kernels of
``repro/kernels/pack_gather.py``):

* ``pack_gather`` — ``out[q, k] = x[q, idx[q, k]]``: each rank's condensed
  messages (or whole virtual blocks) from its owned shard into one
  contiguous send buffer;
* ``unpack_scatter_set`` — the full-materialization unpack: a fresh
  ``x_copy`` per rank, the landed rows scattered in, the owned rows copied
  in at the rank's offset (eq. 15 + eq. 14 in one call);
* ``unpack_dest`` — the ``Destination``-targeted unpack: each of the L slots
  reads the landed buffer, the owned shard, or exactly 0.0;
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
           "SegmentTable", "segment_table", "accumulate_segments",
           "accumulate_into"]


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


def unpack_scatter_set(recv: torch.Tensor, idx: torch.Tensor,
                       x_own: torch.Tensor, offsets: torch.Tensor, *,
                       out_len: int, copy_own: bool = True) -> torch.Tensor:
    """Per rank q: ``x_copy = zeros(out_len, ...)``, ``x_copy[idx[q]] =
    recv[q]``, then (``copy_own``) ``x_copy[offsets[q] : offsets[q] + rows]
    = x_own[q]`` — the own rows land after (win over) the scatter.

    recv ``(P, R, ...)``, idx ``(P, R)`` int32, x_own ``(P, rows, ...)``,
    offsets ``(P,)`` int32 -> ``(P, out_len, ...)``.  Bit-exact outside
    duplicate targets (the dump rows), whose contents are unspecified."""
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
    _build.launch("unpack_scatter_set", "rt_unpack_scatter_set",
                  x_own.device, recv.data_ptr(), idx.data_ptr(),
                  x_own.data_ptr(), offsets.data_ptr(), out.data_ptr(), p,
                  recv.shape[1], rows, out_len, _row_bytes(x_own),
                  int(copy_own))
    return out


_DEST_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def unpack_dest(recv_flat: torch.Tensor, x_local: torch.Tensor,
                src_idx: torch.Tensor, own_idx: torch.Tensor,
                own_mask: torch.Tensor, rem_mask: torch.Tensor
                ) -> torch.Tensor:
    """Slot l of rank q gets ``recv_flat[q, src[q, l]]·rem[q, l] +
    x_local[q, own[q, l]]·own[q, l]``.

    recv_flat ``(P, R, ...)``, x_local ``(P, shard, ...)``, src/own ``(P, L)``
    int32, masks ``(P, L)`` int8 -> ``(P, L, ...)``; float32 or bfloat16 on
    the card.  Bit-exact, -0.0 and inf included; a NaN stays a NaN (its
    payload bits are the platform's)."""
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
    if not on_card(recv_flat, x_local, src_idx, own_idx, own_mask,
                   rem_mask):
        return kref.unpack_dest_ref(recv_flat, x_local, src_idx, own_idx,
                                    own_mask, rem_mask)
    if x_local.dtype not in _DEST_DTYPES:
        raise TypeError(f"unpack_dest runs float32 or bfloat16 on the card, "
                        f"not {x_local.dtype}")
    p, slots = shape
    out = torch.empty((p, slots) + tuple(x_local.shape[2:]),
                      dtype=x_local.dtype, device=x_local.device)
    _build.launch("unpack_dest", "rt_unpack_dest", x_local.device,
                  recv_flat.data_ptr(), x_local.data_ptr(),
                  src_idx.data_ptr(), own_idx.data_ptr(),
                  own_mask.data_ptr(), rem_mask.data_ptr(), out.data_ptr(),
                  p, recv_flat.shape[1], x_local.shape[1], slots,
                  math.prod(x_local.shape[2:]), _DEST_DTYPES[x_local.dtype])
    return out


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
