"""Torch models of the card's B3 and B2 kernels through their plan tables,
and the dest rungs' fused slot product, checked on the CPU against the JAX
reference's Pallas kernels in interpret mode.

The CUDA kernels run only on the card; what they compute in which order is
modelled here step for step, so the decomposition is checked where the
reference runs.

* B3 ``unpack_dest`` through ``dest_table`` (``csrc/pack_gather.cu``
  ``unpack_dest_sorted_kernel``): each slot's code rebuilt into both
  operands and both masks, ``a·ma + b·mb`` with separate roundings, the
  value parked at its slot of its group.  Bit for bit (a NaN by position),
  float32 and bfloat16, on a real ``CommPlan``'s dest arrays of every rung.
* B2 ``unpack_scatter_set`` through ``tile_table``
  (``scatter_tiles_kernel``): each tile filled with zeros or the own rows,
  its landed rows placed unless they target an own row, written once.  Bit
  for bit outside the dump row and any twice-landed row.
* ``unpack_dest_spmv``: its plain version against the JAX ``unpack_dest``
  followed by the jnp product (3e-5, float32 sums in another order), and a
  model of the card's lane order through the table.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.comm import strategies as tstrat
from repro_torch.comm.communicator import LoopbackComm
from repro_torch.comm.gather import IrregularGather
from repro_torch.comm.pattern import AccessPattern, Destination
from repro_torch.comm.plan import attach_destination, build_comm_plan
from repro_torch.core import matrix as tmatrix
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack_gather as tpg
from repro_torch.kernels import ref as tref

# the reference's kernel module (``repro.kernels`` exports functions of the
# same names, so import the module by its path)
jpg = importlib.import_module("repro.kernels.pack_gather")

TOL = dict(rtol=3e-5, atol=3e-5)
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
P, N, R_NZ, BS = 8, 2048, 8, 64
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()
    assert not tops.entry_counts()


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _same_as_jax(got: torch.Tensor, want) -> None:
    """Bit for bit; a NaN by position (its payload bits are the
    platform's: bf16 NaNs come out 0xffff from torch, 0xffc0 from XLA)."""
    nan = np.isnan(np.asarray(want, np.float32))
    np.testing.assert_array_equal(got.float().isnan().numpy(), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _jbits(want)[~nan])


def _matrix(seed=5):
    return tmatrix.make_mesh_like_matrix(N, R_NZ, locality_window=N // 16,
                                         long_range_frac=0.05, seed=seed)


def _dest_plan(strategy, seed=5):
    """A real plan's dest arrays for ``strategy`` (the SpMV's EllPack slots,
    or on the overlap rung its foreign slots), the recv length they index
    and the slot row width."""
    m = _matrix(seed)
    base = build_comm_plan(m.cols, N, P, blocksize=BS)
    rows = N // P
    if strategy == "overlap":
        rem = np.where(base.rem_cols >= N, Destination.ZERO, base.rem_cols)
        dest = Destination.from_slots(foreign=rem.reshape(P, rows, -1))
    else:
        dest = Destination.from_slots(ellpack=m.cols.reshape(P, rows, -1))
    plan = attach_destination(base, dest)
    arrays = tstrat.plan_device_args(plan, strategy, with_dest=True)[-4:]
    n_recv = {"replicate": N, "blockwise": P * plan.b_max * BS}.get(
        strategy, P * plan.s_max)
    return m, tuple(torch.as_tensor(np.ascontiguousarray(a))
                    for a in arrays), n_recv, plan.dest_len // rows


def _sources(n_recv, dtype, seed=6):
    """recv ``(P, n_recv)`` and x ``(P, N / P)`` as float32 numpy arrays,
    with -0.0, inf and NaN planted in both."""
    rng = np.random.default_rng(seed)
    recv = rng.standard_normal((P, n_recv)).astype(np.float32)
    x = rng.standard_normal((P, N // P)).astype(np.float32)
    recv[:, :4] = [-0.0, np.inf, np.nan, -1.5]
    x[:, :4] = [-0.0, -np.inf, np.nan, 2.5]
    return recv, x


def _pair(a32, dtype):
    return torch.as_tensor(a32).to(TDT[dtype]), jnp.asarray(a32).astype(
        JDT[dtype])


# --------------------------------------------------------------------------
# B3 through the dest table
# --------------------------------------------------------------------------

def dest_model(recv, x, table):
    """What ``unpack_dest_sorted_kernel`` computes: each entry's operands
    rebuilt from its code, the slot value rounded to the slot type and
    parked at its slot."""
    p, L = table.code.shape
    code = table.code.to(torch.int64)
    rem = code >= 0
    own = ~rem & (code != tpg.ZERO_CODE)
    other = (torch.zeros_like(code) if table.shift is None
             else ~code + table.shift.to(torch.int64)[:, None])
    ia = torch.where(rem, code, torch.where(own, other, 0))
    ib = torch.where(own, ~code, 0)
    a, b = recv.float().gather(1, ia), x.float().gather(1, ib)
    value = (a * rem.float() + b * own.float()).to(recv.dtype)
    start = torch.arange(L) // table.group * table.group
    parked = torch.empty((p, L), dtype=recv.dtype)
    parked.scatter_(1, start + table.slot.to(torch.int64) % (1 << 16), value)
    return parked


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("group", [tpg.GROUP_SLOTS, 48])
def test_unpack_dest_table_matches_reference(strategy, dtype, group):
    """The card's decomposition of B3 through the table, on every rung's
    real dest arrays, in one group a rank or in groups of 48 slots, against
    the Pallas ``unpack_dest``; the planner's arrays always give a table,
    with a shift on the replicate rung only."""
    _, arrays, n_recv, _ = _dest_plan(strategy)
    table = tpg.dest_table(*arrays, group=group)
    assert table is not None
    assert (table.shift is not None) == (strategy == "replicate")
    recv32, x32 = _sources(n_recv, dtype)
    tr, jr = _pair(recv32, dtype)
    tx, jx = _pair(x32, dtype)
    assert table.recv_len <= n_recv and table.x_len <= N // P
    got = dest_model(tr, tx, table)
    plain = tpg.unpack_dest(tr, tx, *arrays, table=table)   # CPU: plain
    np.testing.assert_array_equal(_bits(plain), _bits(
        tref.unpack_dest_ref(tr, tx, *arrays)))
    for q in range(P):
        want = jpg.unpack_dest(jr[q], jx[q], *(jnp.asarray(a[q].numpy())
                                               for a in arrays),
                               interpret=True)
        _same_as_jax(got[q], want)
        _same_as_jax(plain[q], want)


def test_dest_table_invariants():
    """Within each group the entries are sorted by code (foreign, owned
    and zero slots in separate ranges) and ``slot`` is a permutation of the
    group's slots; the codes read what the arrays name."""
    _, arrays, _, _ = _dest_plan("condensed")
    src, own, own_m, rem_m = arrays
    group = 100
    table = tpg.dest_table(*arrays, group=group)
    p, L = src.shape
    slot = table.slot.to(torch.int64) % (1 << 16)
    start = torch.arange(L) // group * group
    for g0 in range(0, L, group):
        g1 = min(L, g0 + group)
        code = table.code[:, g0:g1]
        assert bool((code[:, 1:] >= code[:, :-1]).all())
        assert torch.equal(slot[:, g0:g1].sort(1).values,
                           torch.arange(g1 - g0).expand(p, -1))
    at = start + slot
    want = torch.where(rem_m.bool(), src, torch.where(
        own_m.bool(), ~own, tpg.ZERO_CODE))
    assert torch.equal(want.gather(1, at), table.code)


def _break(arrays, how):
    src, own, own_m, rem_m = (a.clone() for a in arrays)
    o = int(torch.nonzero(own_m[0])[0])          # an owned slot of rank 0
    f = int(torch.nonzero(rem_m[0])[0])          # a foreign slot of rank 0
    if how == "mask_two":
        own_m[0, o] = 2
    elif how == "both_masks":
        rem_m[0, o] = 1
    elif how == "own_idx_on_foreign":
        own[0, f] = 1
    elif how == "src_on_zero_slot":
        own_m[0, o] = 0
        src[0, o] = 3
    elif how == "owned_src_not_a_shift":
        src[0, o] = 1
    elif how == "negative_position":
        src[0, f] = -1
    return src, own, own_m, rem_m


@pytest.mark.parametrize("how", ["mask_two", "both_masks",
                                 "own_idx_on_foreign", "src_on_zero_slot",
                                 "owned_src_not_a_shift",
                                 "negative_position"])
def test_dest_table_refuses_arrays_without_the_structure(how):
    """``dest_codes`` refuses arrays whose unselected reads a code cannot
    rebuild: such arrays get no table, and the wrappers read the arrays."""
    _, arrays, _, _ = _dest_plan("condensed")
    assert tpg.dest_codes(*arrays) is not None
    broken = _break(arrays, how)
    assert tpg.dest_codes(*broken) is None
    assert tpg.dest_table(*broken) is None


def test_dest_order_and_scatter_tiles_take_no_cpu_tensors():
    """The plan tables serve the card only: on the CPU the caches give
    None and build nothing."""
    _, arrays, _, _ = _dest_plan("blockwise")
    assert tops.DestOrder(row=R_NZ)(*arrays) is None
    assert tops.ScatterTiles()(arrays[0], out_len=10, row_bytes=4) is None
    assert tops.DestOrder(row=tpg.GROUP_SLOTS + 1).group == 0


# --------------------------------------------------------------------------
# B2 through the tile table
# --------------------------------------------------------------------------

def tiles_model(recv, x_own, offsets, table, *, copy_own):
    """What ``scatter_tiles_kernel`` computes: per rank and tile, zeros or
    the own rows, then the tile's landed rows in table order unless they
    target an own row, the tile written once."""
    p, rows = x_own.shape[:2]
    feat = tuple(x_own.shape[2:])
    t_rows, out_len = table.tile_rows, table.out_len
    out = torch.empty((p, out_len) + feat, dtype=x_own.dtype)
    for q in range(p):
        off = int(offsets[q])
        for t0 in range(0, out_len, t_rows):
            t1 = min(out_len, t0 + t_rows)
            tile = torch.zeros((t1 - t0,) + feat, dtype=x_own.dtype)
            if copy_own:
                lo, hi = max(t0, off), min(t1, off + rows)
                if lo < hi:
                    tile[lo - t0:hi - t0] = x_own[q, lo - off:hi - off]
            t = t0 // t_rows
            for e in range(int(table.tile_ptr[q, t]),
                           int(table.tile_ptr[q, t + 1])):
                d = int(table.tgt[q, e])
                assert t0 <= d < t1
                if copy_own and off <= d < off + rows:
                    continue
                tile[d - t0] = recv[q, int(table.perm[q, e])]
            out[q, t0:t1] = tile
    return out


def _landed_rows(feat, dtype, seed, p=4, rows=40, n_recv=70):
    """Landed rows: sorted foreign targets, own-range targets (which
    lose), one foreign target landed twice, padding on the dump row n."""
    rng = np.random.default_rng(seed)
    n = p * rows
    idx = np.full((p, n_recv), n, np.int32)
    for q in range(p):
        foreign = np.setdiff1d(np.arange(n), np.arange(q * rows,
                                                       (q + 1) * rows))
        idx[q, :50] = np.sort(rng.choice(foreign, 50, replace=False))
        idx[q, 50:58] = q * rows + rng.choice(rows, 8, replace=False)
        idx[q, 58] = idx[q, 3]
    recv = rng.standard_normal((p, n_recv) + feat).astype(np.float32)
    own = rng.standard_normal((p, rows) + feat).astype(np.float32)
    recv.reshape(-1)[:2] = [-0.0, np.nan]
    return n, idx, recv, own


@pytest.mark.parametrize("copy_own", [True, False])
@pytest.mark.parametrize("extra_slots", [0, 2])
@pytest.mark.parametrize("feat,row_bytes_tile", [((), 64), ((3,), 120),
                                                 ((16,), 128), ((16,), 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unpack_scatter_tiles_match_reference(copy_own, extra_slots, feat,
                                              row_bytes_tile, dtype,
                                              monkeypatch):
    """The card's one pass through the tile table (tiles cut small here, so
    that landed rows, own rows and tile edges meet) against the Pallas
    ``unpack_scatter_set``, outside the dump row and the twice-landed row:
    duplicates, own-range targets, copy_own off, zero slots after the dump
    row, scalar, 3-wide and 16-wide (block) rows, and rows wider than a
    tile (one row a tile, the wide-row kernel's case)."""
    monkeypatch.setattr(tpg, "TILE_BYTES", row_bytes_tile)
    n, idx, recv32, own32 = _landed_rows(feat, dtype, seed=len(feat))
    p, rows = own32.shape[:2]
    out_len = n + 1 + extra_slots
    tr, jr = _pair(recv32, dtype)
    to, jo = _pair(own32, dtype)
    offsets = np.arange(0, n, rows, dtype=np.int32)
    row_bytes = int(np.prod(feat, dtype=np.int64)) * tr.element_size()
    table = tpg.tile_table(torch.as_tensor(idx), out_len=out_len,
                           row_bytes=row_bytes)
    assert table.tile_rows == max(1, row_bytes_tile // row_bytes)
    got = tiles_model(tr, to, torch.as_tensor(offsets), table,
                      copy_own=copy_own)
    keep = np.ones(out_len, bool)
    for q in range(p):
        keep[:] = True
        keep[[n, idx[q, 3]]] = False
        want = jpg.unpack_scatter_set(jr[q], jnp.asarray(idx[q]), jo[q],
                                      int(offsets[q]), out_len=out_len,
                                      copy_own=copy_own, interpret=True)
        _same_as_jax(got[q][keep], np.asarray(want)[keep])
    assert not got[:, n + 1:].any()


@pytest.mark.parametrize("strategy", ["condensed", "blockwise"])
def test_tile_table_of_a_real_plan(strategy):
    """The tables of a plan's landed index arrays: each rank's targets
    ascend, tile t's entries are exactly those targeting it, and the model
    matches the Pallas unpack on the plan's own shapes (blocks of BS rows on
    the blockwise rung)."""
    m = _matrix()
    plan = build_comm_plan(m.cols, N, P, blocksize=BS)
    shard = N // P
    if strategy == "condensed":
        idx = torch.as_tensor(plan.recv_global_idx.reshape(P, -1))
        rows_own, out_len, feat = shard, N + 1, ()
    else:
        idx = torch.as_tensor(plan.recv_global_blk.reshape(P, -1))
        rows_own, out_len, feat = shard // BS, N // BS + 1, (BS,)
    rng = np.random.default_rng(8)
    recv = torch.as_tensor(rng.standard_normal(
        tuple(idx.shape) + feat).astype(np.float32))
    own = torch.as_tensor(rng.standard_normal(
        (P, rows_own) + feat).astype(np.float32))
    offsets = torch.arange(0, P * rows_own, rows_own, dtype=torch.int32)
    row_bytes = 4 * int(np.prod(feat, dtype=np.int64))
    table = tpg.tile_table(idx, out_len=out_len, row_bytes=row_bytes)
    tgt, kept = table.tgt.long(), table.tile_ptr[:, -1:].long()
    live = torch.arange(tgt.shape[1]) < kept
    assert bool((tgt[:, 1:] >= tgt[:, :-1]).all())
    assert bool(((tgt[:, 1:] > tgt[:, :-1]) | ~live[:, 1:]).all())
    assert torch.equal(torch.where(live, idx.gather(1, table.perm.long()),
                                   out_len), tgt)
    for q in range(P):                    # every target kept, the last row
        last = {int(t): k for k, t in enumerate(idx[q])}
        assert {int(t): int(k) for t, k in zip(
            tgt[q][live[q]], table.perm[q][live[q]])} == last
    tile = tgt // table.tile_rows
    for t in range(table.tile_ptr.shape[1] - 1):
        count = ((tile == t) & live).sum(1)
        assert torch.equal(table.tile_ptr[:, t + 1] - table.tile_ptr[:, t],
                           count.to(torch.int32))
    got = tiles_model(recv, own, offsets, table, copy_own=True)
    dump = out_len - 1
    for q in range(P):
        want = jpg.unpack_scatter_set(
            jnp.asarray(recv[q].numpy()), jnp.asarray(idx[q].numpy()),
            jnp.asarray(own[q].numpy()), int(offsets[q]), out_len=out_len,
            copy_own=True, interpret=True)
        np.testing.assert_array_equal(_bits(got[q])[:dump],
                                      _jbits(want)[:dump])


def test_tile_table_wide_rows_and_bad_targets():
    """Rows of a tile or more get a tile each (Heat2D's blockwise rung
    lands whole 8 MB blocks), with at most one kept landed row; a target
    outside the output is refused."""
    idx = torch.tensor([[3, 1, 3, 0], [2, 2, 2, 2]], dtype=torch.int32)
    table = tpg.tile_table(idx, out_len=4, row_bytes=tpg.TILE_BYTES)
    assert table.tile_rows == 1
    assert torch.equal(table.tile_ptr, torch.tensor(
        [[0, 1, 2, 2, 3], [0, 0, 0, 1, 1]], dtype=torch.int32))
    assert table.perm[0, :3].tolist() == [3, 1, 2]     # last of target 3
    assert table.perm[1, 0] == 3
    with pytest.raises(ValueError):
        tpg.tile_table(idx + 4, out_len=4, row_bytes=4)


# --------------------------------------------------------------------------
# unpack_dest_spmv: B3 with the slot product as its epilogue
# --------------------------------------------------------------------------

def _spmv_inputs(strategy, seed=5):
    m, arrays, n_recv, r = _dest_plan(strategy, seed)
    rng = np.random.default_rng(seed + 1)
    recv = rng.standard_normal((P, n_recv)).astype(np.float32)
    x = rng.standard_normal((P, N // P)).astype(np.float32)
    vals = (m.vals.reshape(P, N // P, -1) if strategy != "overlap" else
            rng.standard_normal((P, N // P, r)).astype(np.float32))
    return arrays, recv, x, np.ascontiguousarray(vals), m.diag.reshape(
        P, -1)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("with_diag", [True, False])
def test_unpack_dest_spmv_plain_matches_reference(strategy, with_diag):
    """The plain ``unpack_dest_spmv`` (the wrapper on CPU tensors) against
    the Pallas ``unpack_dest`` followed by the jnp slot product, at 3e-5;
    on the CPU it is bit for bit the composition the dest rungs ran."""
    arrays, recv, x, vals, diag = _spmv_inputs(strategy)
    t = [torch.as_tensor(a) for a in (recv, x, vals, diag)]
    got = tops.unpack_dest_spmv(t[0], t[1], *arrays, t[2],
                                t[3] if with_diag else None)
    slots = tref.unpack_dest_ref(t[0], t[1], *arrays).reshape(t[2].shape)
    composed = (t[2] * slots).sum(-1)
    if with_diag:
        composed = t[3] * t[1] + composed
    np.testing.assert_array_equal(_bits(got), _bits(composed))
    for q in range(P):
        s = jpg.unpack_dest(jnp.asarray(recv[q]), jnp.asarray(x[q]),
                            *(jnp.asarray(a[q].numpy()) for a in arrays),
                            interpret=True).reshape(vals.shape[1:])
        want = (jnp.asarray(vals[q]) * s).sum(-1)
        if with_diag:
            want = jnp.asarray(diag[q]) * jnp.asarray(x[q]) + want
        np.testing.assert_allclose(got[q].numpy(), np.asarray(want), **TOL)


def fused_model(recv, x, table, vals, diag):
    """What ``dest_spmv_sorted_kernel`` computes: the group's slots staged
    as ``dest_model`` does, then a group of ``lanes`` threads a row (four
    entries a lane where r is a multiple of 4), fused multiply-adds in j
    order, the butterfly, ``fma(diag, x, sum)``."""
    p, rows, r = vals.shape
    g = dest_model(recv, x, table).float().reshape(p, rows, r)
    vec = 4 if r % 4 == 0 else 1
    per_row = r // vec
    lanes = 1
    while lanes < per_row and lanes < 32:
        lanes <<= 1
    v = vals.float()
    part = torch.zeros((lanes, p, rows))
    for j in range(per_row):
        for u in range(vec):
            e = j * vec + u
            part[j % lanes] = tref.fma_f32(v[:, :, e], g[:, :, e],
                                           part[j % lanes])
    s = lanes // 2
    while s:
        part = part + part[torch.arange(lanes) ^ s]
        s //= 2
    acc = part[0]
    if diag is not None:
        acc = tref.fma_f32(diag.float(), x.float(), acc)
    return acc.to(vals.dtype)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("with_diag", [True, False])
def test_unpack_dest_spmv_lane_order_matches_reference(strategy, with_diag):
    """The card's fused decomposition through a table of whole rows
    (``DestOrder(row=r)``'s grouping, cut to 24 rows here) against the
    Pallas ``unpack_dest`` and the jnp product, at 3e-5."""
    arrays, recv, x, vals, diag = _spmv_inputs(strategy)
    r = vals.shape[2]
    table = tpg.dest_table(*arrays, group=24 * r)
    t = [torch.as_tensor(a) for a in (recv, x, vals, diag)]
    got = fused_model(t[0], t[1], table, t[2], t[3] if with_diag else None)
    for q in range(P):
        s = jpg.unpack_dest(jnp.asarray(recv[q]), jnp.asarray(x[q]),
                            *(jnp.asarray(a[q].numpy()) for a in arrays),
                            interpret=True).reshape(vals.shape[1:])
        want = (jnp.asarray(vals[q]) * s).sum(-1)
        if with_diag:
            want = jnp.asarray(diag[q]) * jnp.asarray(x[q]) + want
        np.testing.assert_allclose(got[q].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_landed_finish_delivers_the_dest_slots(strategy):
    """``materialize="landed"`` hands back what the dest delivery reads:
    delivered, it gives ``local(x)``'s named slots bit for bit."""
    m = _matrix()
    rows = N // P
    gather = IrregularGather(
        AccessPattern.from_ellpack(m), LoopbackComm(P, device="cpu"),
        strategy=strategy, blocksize=BS,
        destination=Destination.from_slots(ellpack=m.cols.reshape(
            P, rows, -1)))
    x = gather.shard_vector(np.random.default_rng(9).standard_normal(
        N).astype(np.float32))
    landed = gather.local(x, *gather.plan_args, materialize="landed")
    assert isinstance(landed, tstrat.Landed)
    assert all(a is b for a, b in zip(landed[2:], gather.plan_args[-4:]))
    slots = gather.destination.split(tstrat.dest_gather_local(*landed))
    want = gather.local(x, *gather.plan_args)
    np.testing.assert_array_equal(_bits(slots["ellpack"]),
                                  _bits(want["ellpack"]))
    with pytest.raises(ValueError):
        IrregularGather(AccessPattern.from_ellpack(m),
                        LoopbackComm(P, device="cpu"), strategy=strategy,
                        blocksize=BS).local(x, materialize="landed")
