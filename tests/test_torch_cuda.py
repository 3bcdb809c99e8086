"""The port's CUDA kernels against their plain PyTorch versions, and its
paths on the card against the same paths on the CPU.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; on the card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.comm.communicator import LoopbackComm
from repro_torch.comm.pattern import AccessPattern
from repro_torch.comm.scatter import IrregularScatter
from repro_torch.configs.registry import get_config
from repro_torch.core.matrix import (make_mesh_like_matrix, spmv_ref_np,
                                     spmv_t_ref_np)
from repro_torch.core.heat2d import Heat2D
from repro_torch.core.matrix import EllpackMatrix
from repro_torch.core.solvers import ConjugateGradient
from repro_torch.core.spmv import (DistributedSpMV, _dest_product,
                                   normal_equations_step)
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import ellpack_spmv as kes
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.runtime.steps import build_prefill
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda

TOL = dict(rtol=3e-5, atol=3e-5)   # float32 sums in another order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(
        dev, dtype)


@pytest.mark.parametrize("feat", [(), (3,), (4,), (1024,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.int8])
def test_pack_gather_bit_exact(dev, feat, dtype):
    rng = np.random.default_rng(0)
    p, shard, m = 4, 37, 53
    x = _rand(rng, (p, shard) + feat, torch.float32, dev).mul(100).to(dtype)
    idx = torch.as_tensor(rng.integers(0, shard, (p, m)), dtype=torch.int32,
                          device=dev)
    before = kops.launch_counts()["pack_gather"]
    got = kops.pack_gather(x, idx)
    torch.cuda.synchronize()
    assert kops.launch_counts()["pack_gather"] == before + 1
    assert torch.equal(got, kref.pack_gather_ref(x, idx))


@pytest.mark.parametrize("copy_own", [True, False])
@pytest.mark.parametrize("feat", [(), (3,), (64,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_scatter_set_bit_exact(dev, copy_own, feat, dtype):
    rng = np.random.default_rng(1)
    p, rows, n_recv = 4, 16, 30
    n = p * rows
    out_len = n + 2                       # dump row n, zero slot n + 1
    idx = np.full((p, n_recv), n, np.int32)
    for q in range(p):
        foreign = np.setdiff1d(np.arange(n), np.arange(q * rows,
                                                       (q + 1) * rows))
        k = 20
        idx[q, :k] = rng.choice(foreign, k, replace=False)
        idx[q, k:k + 3] = q * rows + np.arange(3)   # own-range targets lose
    idx = torch.as_tensor(idx, device=dev)
    recv = _rand(rng, (p, n_recv) + feat, dtype, dev)
    x_own = _rand(rng, (p, rows) + feat, dtype, dev)
    offsets = torch.arange(0, n, rows, dtype=torch.int32, device=dev)
    got = kops.unpack_scatter_set(recv, idx, x_own, offsets, out_len=out_len,
                                  copy_own=copy_own)
    want = kref.unpack_scatter_set_ref(recv, idx, x_own, offsets,
                                       out_len=out_len, copy_own=copy_own)
    keep = [i for i in range(out_len) if i != n]    # dump row unspecified
    assert torch.equal(got[:, keep], want[:, keep])
    assert not got[:, n + 1].any()


@pytest.mark.parametrize("feat", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_dest_bit_exact(dev, feat, dtype):
    rng = np.random.default_rng(2)
    p, n_recv, shard, slots = 4, 40, 24, 101
    recv = _rand(rng, (p, n_recv) + feat, dtype, dev)
    x = _rand(rng, (p, shard) + feat, dtype, dev)
    # -0.0, inf and NaN must pass through the two products and the add
    recv.view(-1)[:3] = torch.tensor([-0.0, float("inf"), float("nan")],
                                     dtype=dtype, device=dev)
    x.view(-1)[:3] = torch.tensor([-0.0, float("-inf"), 1.0], dtype=dtype,
                                  device=dev)
    kind = rng.integers(0, 3, (p, slots))               # own / foreign / zero
    src = torch.as_tensor(rng.integers(0, n_recv, (p, slots)),
                          dtype=torch.int32, device=dev)
    own = torch.as_tensor(rng.integers(0, shard, (p, slots)),
                          dtype=torch.int32, device=dev)
    src[:, :3] = torch.arange(3, device=dev)
    own[:, :3] = torch.arange(3, device=dev)
    own_m = torch.as_tensor(kind == 0, dtype=torch.int8, device=dev)
    rem_m = torch.as_tensor(kind == 1, dtype=torch.int8, device=dev)
    got = kops.unpack_dest(recv, x, src, own, own_m, rem_m)
    want = kref.unpack_dest_ref(recv, x, src, own, own_m, rem_m)
    assert torch.equal(got.isnan(), want.isnan())
    same = ~want.isnan()
    assert torch.equal(got[same].view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32),
                       want[same].view(torch.int16 if dtype == torch.bfloat16
                                       else torch.int32))


BF16_OUT_TOL = dict(rtol=2.0 ** -8, atol=2e-4)   # one bf16 rounding


@pytest.mark.parametrize("r_nz", [1, 3, 8, 16, 33])
@pytest.mark.parametrize("with_diag", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [512, 544, 2592])
def test_ellpack_spmv_matches_plain(dev, r_nz, with_diag, dtype, rows):
    """B4 against its plain version, in float32 (3e-5) and in bfloat16
    (diag, vals and x; against the plain version on float32 copies of the
    same values, one bf16 rounding apart), on a strided x: the row-order
    kernel, and where r_nz is ``sortable`` the column-sorted one through
    the plan's ``order_table`` in ``SORT_ROWS`` (1024-row) groups, at one
    partial group (512, 544 rows) and at two full groups and a partial one
    (2592); two calls give the same bits."""
    rng = np.random.default_rng(3)
    p, rpb, window = 3, 32, 256
    nblk = rows // rpb
    x = _rand(rng, (p, 4 * window + 7), dtype, dev)
    win_blk = torch.as_tensor(rng.integers(0, 3, (p, nblk)),
                              dtype=torch.int32, device=dev)
    cols_rel = torch.as_tensor(rng.integers(0, 2 * window, (p, rows, r_nz)),
                               dtype=torch.int32, device=dev)
    own_rel = torch.as_tensor(rng.integers(0, 2 * window, (p, rows)),
                              dtype=torch.int32, device=dev)
    vals = _rand(rng, (p, rows, r_nz), dtype, dev)
    diag = _rand(rng, (p, rows), dtype, dev) if with_diag else None
    args = (diag, vals, cols_rel, own_rel if with_diag else None, win_blk,
            x[:, :-7])                         # a strided view of x
    wide = tuple(t.float() if t is not None and t.is_floating_point() else t
                 for t in args)
    want = kref.ellpack_spmv_ref(*wide, window=window, rows_per_block=rpb)
    orders = [None]
    if kes.sortable(r_nz):
        orders.append(kes.order_table(cols_rel, win_blk, window=window,
                                      rows_per_block=rpb,
                                      group_rows=kes.SORT_ROWS))
    for order in orders:
        kops.reset_launch_counts()
        got = kops.ellpack_spmv_windowed(*args, window=window,
                                         rows_per_block=rpb, order=order)
        again = kops.ellpack_spmv_windowed(*args, window=window,
                                           rows_per_block=rpb, order=order)
        assert kops.launch_counts()["ellpack_spmv_windowed"] == 2
        assert got.dtype == dtype and _same_bits(got, again)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **TOL)
        else:
            torch.testing.assert_close(got.float(), want, **BF16_OUT_TOL)


def test_plan_order_built_once_per_plan(dev):
    """The on-copy planner's ``PlanOrder`` builds its table at the plan's
    first call on the card and gives the same one after; other plan arrays
    get a table of their own."""
    n, p = 4096, 4
    m = make_mesh_like_matrix(n, 16, locality_window=n // 64,
                              long_range_frac=0.02, seed=2)
    order = kes.PlanOrder(window=512, rows_per_block=256)
    _, kplan = kops.make_spmv_on_copy_sharded(m.cols, p)
    win_blk, cols_rel, _ = (torch.as_tensor(a).to(dev) for a in kplan)
    first = order(cols_rel, win_blk)
    assert first is order(cols_rel, win_blk)
    other = order(cols_rel.clone(), win_blk)
    assert other is not first and torch.equal(other[0], first[0])


@pytest.mark.parametrize("strategy", ["replicate", "blockwise", "condensed",
                                      "overlap"])
@pytest.mark.parametrize("materialize", ["full", "dest"])
def test_spmv_engine_on_card(dev, strategy, materialize):
    n = 8 * 1024
    m = make_mesh_like_matrix(n, 16, locality_window=n // 64,
                              long_range_frac=0.02, seed=1)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    eng = DistributedSpMV(m, LoopbackComm(8, device=dev), strategy=strategy,
                          blocksize=64, shards_per_node=4, use_kernel=True,
                          materialize=materialize)
    kops.reset_launch_counts()
    y = eng(eng.shard_vector(x))
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    np.testing.assert_allclose(y.reshape(-1).cpu().numpy(), spmv_ref_np(m, x),
                               rtol=2e-4, atol=2e-4)
    assert _same_bits(eng(eng.shard_vector(x)), y)     # repeatable
    if strategy != "replicate":
        assert counts["pack_gather"] == 1
    if materialize == "dest":
        assert counts["unpack_dest"] == 1
    else:
        assert counts["ellpack_spmv_windowed"] == (
            2 if strategy == "overlap" else 1)
        assert counts["unpack_scatter_set"] == (
            0 if strategy == "replicate" else 1)


# --------------------------------------------------------------------------
# B3 / B2 through their plan tables, and B3 fused with the slot product
# --------------------------------------------------------------------------

STRATEGIES = ["replicate", "blockwise", "condensed", "overlap"]


def _landed(dev, strategy, n=8192, seed=3, plant=True):
    """A dest engine's landed exchange (``strategies.Landed``), its vals
    and diag, with -0.0, inf and NaN planted in recv and x."""
    m = make_mesh_like_matrix(n, 16, locality_window=n // 64,
                              long_range_frac=0.02, seed=seed)
    eng = DistributedSpMV(m, LoopbackComm(8, device=dev), strategy=strategy,
                          blocksize=64, shards_per_node=4, use_kernel=True,
                          materialize="dest")
    x_host = np.random.default_rng(seed).standard_normal(n).astype(
        np.float32)
    x = eng.shard_vector(x_host)
    landed = eng.gather.local(x, *eng.gather.plan_args, materialize="landed")
    if plant:
        recv, x = landed.recv_flat.clone(), landed.x_local.clone()
        recv.view(-1)[:4] = torch.tensor([-0.0, float("inf"), float("nan"),
                                          -1.5], device=dev)
        x.view(-1)[:4] = torch.tensor([-0.0, float("-inf"), float("nan"),
                                       2.5], device=dev)
        landed = landed._replace(recv_flat=recv, x_local=x)
    p = 8
    rows = n // p
    if strategy == "overlap":       # the foreign slots' own width
        r = landed.src_idx.shape[1] // rows
        vals = _rand(np.random.default_rng(seed), (p, rows, r),
                     torch.float32, dev)
    else:
        vals = torch.as_tensor(m.vals).to(dev).reshape(p, rows, -1)
    diag = torch.as_tensor(m.diag).to(dev).reshape(p, rows)
    return m, x_host, landed, vals, diag


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_dest_table_bit_exact(dev, strategy, dtype):
    """B3 through the plan's dest table and through the plan's arrays, bit
    for bit against the plain version, on every rung's real dest arrays
    with -0.0, inf and NaN in both sources; the table variant launches."""
    _, _, landed, _, _ = _landed(dev, strategy)
    landed = landed._replace(recv_flat=landed.recv_flat.to(dtype),
                             x_local=landed.x_local.to(dtype))
    table = kops.DestOrder()(*landed[2:])
    assert table is not None
    assert (table.shift is not None) == (strategy == "replicate")
    want = kref.unpack_dest_ref(*landed)
    kops.reset_launch_counts()
    with_table = kops.unpack_dest(*landed, table=table)
    without = kops.unpack_dest(*landed)
    torch.cuda.synchronize()
    assert kops.entry_counts() == {"rt_unpack_dest_sorted": 1,
                                   "rt_unpack_dest": 1}
    assert _same_bits(with_table, want)
    assert _same_bits(without, want)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("with_diag", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_dest_spmv_matches_plain(dev, strategy, with_diag, dtype):
    """B3 fused with the slot product, through the table, against the
    plain composition (float32 at 3e-5; bfloat16 against the composition on
    float32 copies of the same slots, one bf16 rounding); the same bits on
    a second call; refused on the card without a table."""
    _, _, landed, vals, diag = _landed(dev, strategy, plant=False)
    landed = landed._replace(recv_flat=landed.recv_flat.to(dtype),
                             x_local=landed.x_local.to(dtype))
    vals, diag = vals.to(dtype), diag.to(dtype) if with_diag else None
    r = vals.shape[2]
    table = kops.DestOrder(row=r)(*landed[2:])
    assert table is not None and table.group % r == 0
    slots = kref.unpack_dest_ref(*landed).float()
    want = (vals.float() * slots.reshape(vals.shape)).sum(-1)
    if with_diag:
        want = diag.float() * landed.x_local.float() + want
    kops.reset_launch_counts()
    got = [kops.unpack_dest_spmv(*landed, vals, diag, table=table)
           for _ in range(2)]
    with pytest.raises(ValueError, match="dest table"):
        kops.unpack_dest_spmv(*landed, vals, diag)
    torch.cuda.synchronize()
    assert kops.launch_counts()["unpack_dest"] == 2
    assert kops.entry_counts() == {"rt_unpack_dest_spmv_sorted": 2}
    assert _same_bits(got[0], got[1])
    tol = TOL if dtype == torch.float32 else BF16_OUT_TOL
    assert got[0].dtype == dtype
    torch.testing.assert_close(got[0].float(), want, **tol)
    if dtype == torch.float32:
        plain = kref.unpack_dest_spmv_ref(*landed, vals, diag)
        torch.testing.assert_close(got[0], plain, **TOL)


def test_dest_table_refused_runs_the_array_kernel(dev):
    """Dest arrays without their planner's structure (a slot both owned
    and foreign) get no table; the wrapper then reads the arrays, and the
    dest step composes that kernel with the plain slot product."""
    _, _, landed, vals, diag = _landed(dev, "condensed", plant=False)
    both = landed.own_mask.clone()
    both[:, 0] = 1
    rem = landed.rem_mask.clone()
    rem[:, 0] = 1
    broken = landed._replace(own_mask=both, rem_mask=rem)
    assert kops.DestOrder()(*broken[2:]) is None
    kops.reset_launch_counts()
    got = kops.unpack_dest(*broken, table=None)
    torch.cuda.synchronize()
    assert _same_bits(got, kref.unpack_dest_ref(*broken))
    assert kops.entry_counts() == {"rt_unpack_dest": 1}
    for d in (diag, None):
        kops.reset_launch_counts()
        y = _dest_product(broken, vals, d, kops.DestOrder(
            row=vals.shape[2])(*broken[2:]), use_kernel=True)
        torch.cuda.synchronize()
        assert kops.entry_counts() == {"rt_unpack_dest": 1}
        torch.testing.assert_close(
            y, kref.unpack_dest_spmv_ref(*broken, vals, d), **TOL)


def test_dest_order_built_once_per_plan(dev):
    _, _, landed, _, _ = _landed(dev, "blockwise", plant=False)
    order = kops.DestOrder(row=16)
    first = order(*landed[2:])
    assert first is order(*landed[2:])
    other = order(landed.src_idx.clone(), *landed[3:])
    assert other is not first and torch.equal(other.code, first.code)


def _tile_case(dev, rng, feat, dtype, p=4, rows=700, dups=True):
    """Landed rows for B2: foreign targets across tile edges, own-range
    targets (which lose), duplicates on the dump row n, and (``dups``) a
    foreign target landed twice (its contents unspecified)."""
    n = p * rows
    n_recv = 900
    idx = np.full((p, n_recv), n, np.int32)
    for q in range(p):
        foreign = np.setdiff1d(np.arange(n), np.arange(q * rows,
                                                       (q + 1) * rows))
        k = 600
        idx[q, :k] = np.sort(rng.choice(foreign, k, replace=False))
        idx[q, k:k + 40] = q * rows + rng.choice(rows, 40, replace=False)
        if dups:
            idx[q, k + 40] = idx[q, 0]
    recv = _rand(rng, (p, n_recv) + feat, dtype, dev)
    x_own = _rand(rng, (p, rows) + feat, dtype, dev)
    offsets = torch.arange(0, n, rows, dtype=torch.int32, device=dev)
    return n, torch.as_tensor(idx, device=dev), recv, x_own, offsets


@pytest.mark.parametrize("copy_own", [True, False])
@pytest.mark.parametrize("extra_slots", [0, 2])
@pytest.mark.parametrize("feat", [(), (3,), (1024,), (8192,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_scatter_set_tiles_bit_exact(dev, copy_own, extra_slots, feat,
                                            dtype):
    """B2 in one pass through the plan's tile table, against the plain
    version outside the dump row and the twice-landed row: duplicates,
    own-range targets, copy_own off, zero slots after the dump row, scalar,
    3-wide and 1024-wide (blockwise) rows, and rows of a tile or more (the
    wide-row kernel); the three-phase kernel too."""
    rng = np.random.default_rng(4)
    n, idx, recv, x_own, offsets = _tile_case(dev, rng, feat, dtype)
    out_len = n + 1 + extra_slots
    row_bytes = int(np.prod(feat, dtype=np.int64)) * recv.element_size()
    table = kops.ScatterTiles()(idx, out_len=out_len, row_bytes=row_bytes)
    assert table is not None
    kw = dict(out_len=out_len, copy_own=copy_own)
    want = kref.unpack_scatter_set_ref(recv, idx, x_own, offsets, **kw)
    kops.reset_launch_counts()
    got = kops.unpack_scatter_set(recv, idx, x_own, offsets, table=table,
                                  **kw)
    plain_kernel = kops.unpack_scatter_set(recv, idx, x_own, offsets, **kw)
    torch.cuda.synchronize()
    assert kops.entry_counts() == {"rt_unpack_scatter_tiles": 1,
                                   "rt_unpack_scatter_set": 1}
    twice = idx[:, 0].long()
    keep = torch.ones((idx.shape[0], out_len), dtype=torch.bool, device=dev)
    keep[:, n] = False
    keep[torch.arange(idx.shape[0], device=dev), twice] = False
    for out in (got, plain_kernel):
        assert torch.equal(out[keep], want[keep])
        assert not out[:, n + 1:].any()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("materialize", ["full", "dest"])
def test_spmv_engine_runs_the_table_kernels(dev, strategy, materialize):
    """On every rung the engines' unpacks launch the table variants, and
    nothing else of B2/B3."""
    n = 8 * 1024
    m = make_mesh_like_matrix(n, 16, locality_window=n // 64,
                              long_range_frac=0.02, seed=1)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    eng = DistributedSpMV(m, LoopbackComm(8, device=dev), strategy=strategy,
                          blocksize=64, shards_per_node=4, use_kernel=True,
                          materialize=materialize)
    xs = eng.shard_vector(x)
    eng(xs)
    kops.reset_launch_counts()
    y = eng(xs)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.reshape(-1).cpu().numpy(), spmv_ref_np(m, x),
                               rtol=2e-4, atol=2e-4)
    entries = kops.entry_counts()
    unpacks = {k: v for k, v in entries.items() if "unpack" in k}
    if materialize == "dest":
        assert unpacks == {"rt_unpack_dest_spmv_sorted": 1}
    elif strategy != "replicate":
        assert unpacks == {"rt_unpack_scatter_tiles": 1}
    else:
        assert unpacks == {}


def test_table_kernels_in_a_cuda_graph(dev):
    """With their tables built, B3, its fusion and B2 launch with no host
    sync and allocate only their outputs: a CUDA graph captures them and
    its replay gives the eager bits."""
    _, _, landed, vals, diag = _landed(dev, "condensed", plant=False)
    dtab = kops.DestOrder()(*landed[2:])
    ftab = kops.DestOrder(row=vals.shape[2])(*landed[2:])
    rng = np.random.default_rng(5)
    n, idx, recv, x_own, offsets = _tile_case(dev, rng, (), torch.float32,
                                              dups=False)
    ttab = kops.ScatterTiles()(idx, out_len=n + 1, row_bytes=4)

    def run():
        return (kops.unpack_dest(*landed, table=dtab),
                kops.unpack_dest_spmv(*landed, vals, diag, table=ftab),
                kops.unpack_scatter_set(recv, idx, x_own, offsets,
                                        out_len=n + 1, table=ttab))
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eager = run()                     # warm-up off the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert _same_bits(got, want)


def test_exchange_tables_at_the_smoke_shape(dev):
    """B3 (table and arrays), B3 fused with the slot product and B2 (table
    and three phases) at the condensed rung of chip_smoke.py's n = 2^22
    matrix, against their plain versions."""
    n, p = 1 << 22, 8
    m = make_mesh_like_matrix(n, 16, locality_window=n // 64,
                              long_range_frac=0.02, seed=1)
    x_host = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    comm = LoopbackComm(p, device=dev)
    dest = DistributedSpMV(m, comm, strategy="condensed", shards_per_node=4,
                           blocksize=1024, use_kernel=True,
                           materialize="dest")
    x = dest.shard_vector(x_host)
    landed = dest.gather.local(x, *dest.gather.plan_args,
                               materialize="landed")
    want = kref.unpack_dest_ref(*landed)
    assert _same_bits(kops.unpack_dest(*landed, table=kops.DestOrder()(
        *landed[2:])), want)
    assert _same_bits(kops.unpack_dest(*landed), want)
    vals = torch.as_tensor(m.vals).to(dev).reshape(p, n // p, -1)
    diag = torch.as_tensor(m.diag).to(dev).reshape(p, n // p)
    y = kops.unpack_dest_spmv(*landed, vals, diag,
                              table=kops.DestOrder(row=16)(*landed[2:]))
    torch.testing.assert_close(
        y, kref.unpack_dest_spmv_ref(*landed, vals, diag), **TOL)
    np.testing.assert_allclose(y.reshape(-1).cpu().numpy(),
                               spmv_ref_np(m, x_host), rtol=2e-4, atol=2e-4)
    del landed, want, dest
    full = DistributedSpMV(m, comm, strategy="condensed", shards_per_node=4,
                           blocksize=1024, use_kernel=True,
                           materialize="full")
    send_idx, recv_idx = full.gather.plan_args
    buf = kops.pack_gather(x, send_idx.reshape(p, -1))
    recv = comm.all_to_all(buf.reshape(send_idx.shape)).wait().reshape(p, -1)
    idx = recv_idx.reshape(p, -1)
    offsets = torch.arange(0, n, n // p, dtype=torch.int32, device=dev)
    kw = dict(out_len=n + 1)
    want = kref.unpack_scatter_set_ref(recv, idx, x, offsets, **kw)
    table = kops.ScatterTiles()(idx, out_len=n + 1, row_bytes=4)
    for t in (table, None):
        got = kops.unpack_scatter_set(recv, idx, x, offsets, table=t, **kw)
        assert torch.equal(got[:, :n], want[:, :n])


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, NaN compared by position (its payload is the
    platform's)."""
    got, want = got.cpu(), want.cpu()
    if not got.dtype.is_floating_point:
        return torch.equal(got, want)
    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        return False
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got[~nan].view(bits), want[~nan].view(bits))


def _fold_inputs(dtype, feat, reduce, p=4, k=3000, live=200, seed=0):
    """Contributions with heavy duplicates, -0.0/NaN/inf, a dump row (index
    ``live``) and identity-carrying padding lanes piled onto row 0."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, live + 1, (p, k)).astype(np.int32)
    pad = rng.random((p, k)) < 0.2
    idx[pad] = 0
    if dtype == torch.int32:
        vals = torch.as_tensor(rng.integers(-999, 999, (p, k) + feat),
                               dtype=torch.int32)
        init = torch.as_tensor(rng.integers(-999, 999, (p, live + 1) + feat),
                               dtype=torch.int32)
    else:
        v = rng.standard_normal((p, k) + feat).astype(np.float32)
        v.reshape(p, k, -1)[:, :6, 0] = [-0.0, -0.0, np.nan, np.inf,
                                         -np.inf, 0.0]
        idx[:, :6] = [0, 0, 3, 4, 4, 5]
        pad[:, :6] = False
        vals = torch.as_tensor(v).to(dtype)
        init = torch.as_tensor(rng.standard_normal((p, live + 1) + feat)
                               .astype(np.float32)).to(dtype)
        init[:, 0] = -0.0
    vals[torch.as_tensor(pad)] = kref.reduce_identity(vals.dtype, reduce)
    return torch.as_tensor(idx), torch.as_tensor(pad), vals, init


@pytest.mark.parametrize("feat", [(), (3,), (1024,)])
@pytest.mark.parametrize("reduce", ["add", "set", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_accumulate_kernels_bit_exact(dev, feat, reduce, dtype):
    """B5 and B6 through a table with a dump row and padding lanes, and
    through a plain table that folds every row, against the plain versions
    on the CPU (a sequential fold), bit for bit on every live row."""
    k = 300 if feat == (1024,) else 3000
    idx, pad, vals, init = _fold_inputs(dtype, feat, reduce, k=k)
    live = init.shape[1] - 1
    idd, vd = idx.to(dev), vals.to(dev)
    table = kops.segment_table(idd, out_len=live + 1, live_len=live,
                               pad=pad.to(dev))
    plain_table = kops.segment_table(idd, out_len=live + 1)
    before = kops.launch_counts()
    seg = kops.accumulate_segments(vd, idd, out_len=live + 1, reduce=reduce,
                                   table=table)
    into = kops.accumulate_into(init.to(dev), vd, idd, reduce=reduce,
                                table=table)
    whole = kops.accumulate_segments(vd, idd, out_len=live + 1, reduce=reduce,
                                     table=plain_table)
    torch.cuda.synchronize()
    after = kops.launch_counts()
    assert after["accumulate_segments"] == before["accumulate_segments"] + 2
    assert after["accumulate_into"] == before["accumulate_into"] + 1
    want_seg = kref.accumulate_segments_ref(vals, idx, out_len=live + 1,
                                            reduce=reduce)
    want_into = kref.accumulate_into_ref(init, vals, idx, reduce=reduce)
    assert _same_bits(seg[:, :live], want_seg[:, :live])
    assert _same_bits(into[:, :live], want_into[:, :live])
    assert _same_bits(whole, want_seg)


def test_fold_refuses_missing_or_foreign_table(dev):
    """On the card a fold needs the table built from its own index array:
    none, another array of the same shape, or another out_len raise."""
    idx, _, vals, _ = _fold_inputs(torch.float32, (), "add", k=300)
    live = int(idx.max()) + 1
    idd, vd = idx.to(dev), vals.to(dev)
    other = idd.flip(1).contiguous()
    with pytest.raises(ValueError):
        kops.accumulate_segments(vd, idd, out_len=live)
    with pytest.raises(ValueError):
        kops.accumulate_segments(vd, idd, out_len=live,
                                 table=kops.segment_table(other,
                                                          out_len=live))
    with pytest.raises(ValueError):
        kops.accumulate_segments(vd, idd, out_len=live + 1,
                                 table=kops.segment_table(idd, out_len=live))


def test_segment_table_long_dump_segment(dev):
    """A 1 M-lane dump segment is left out of the fold: the kernel takes
    well under 20 ms (it would fold 1 M dependent adds on one thread
    otherwise), and the live rows stay exact."""
    p, dump, live = 2, 1 << 20, 4096
    rng = np.random.default_rng(3)
    idx = torch.full((p, dump + live * 4), live, dtype=torch.int32)
    idx[:, dump:] = torch.as_tensor(rng.integers(0, live, (p, live * 4)),
                                    dtype=torch.int32)
    vals = torch.as_tensor(rng.standard_normal(tuple(idx.shape))
                           .astype(np.float32))
    vd, idd = vals.to(dev), idx.to(dev)
    table = kops.segment_table(idd, out_len=live + 1, live_len=live)
    assert table.longest() < 64
    kops.accumulate_segments(vd, idd, out_len=live + 1, table=table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = kops.accumulate_segments(vd, idd, out_len=live + 1, table=table)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 0.020
    want = kref.accumulate_segments_ref(vals, idx, out_len=live + 1)
    assert _same_bits(got[:, :live], want[:, :live])


@pytest.mark.parametrize("reduce", ["add", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_long_rows_bit_exact(dev, reduce, dtype):
    """Rows past LONG_LANES (a 2^18-lane hot row, as the main path's edge
    columns have, and a few just past the threshold) fold in their own
    blocks, in lane order: bit for bit against the CPU's sequential fold."""
    from repro_torch.kernels.pack_gather import LONG_LANES
    p, live = 2, 5000
    rng = np.random.default_rng(6)
    idx = rng.integers(0, live, (p, 1 << 19)).astype(np.int32)
    idx[:, ::2] = 7                            # the hot row
    idx[:, 1:600:8] = 11                       # just past the threshold
    if dtype == torch.int32:
        vals = torch.as_tensor(rng.integers(-99, 99, idx.shape),
                               dtype=torch.int32)
    else:
        vals = torch.as_tensor(rng.standard_normal(idx.shape)
                               .astype(np.float32)).to(dtype)
    tidx = torch.as_tensor(idx)
    idd = tidx.to(dev)
    table = kops.segment_table(idd, out_len=live)
    assert table.longest() >= 1 << 18
    assert set(table.long_rows.tolist()) >= {7, 11, live + 7, live + 11}
    lanes = np.bincount(idx[0], minlength=live)
    assert 11 in [t for t in range(live) if lanes[t] > LONG_LANES]
    got = kops.accumulate_segments(vals.to(dev), idd, out_len=live,
                                   reduce=reduce, table=table)
    want = kref.accumulate_segments_ref(vals, tidx, out_len=live,
                                        reduce=reduce)
    assert _same_bits(got, want)


def _stage_idx(layout: str, rng, p: int):
    """``(idx, live)`` for the staged-run cases: 60000 lanes a rank over
    6000 rows, a long row of 2000 lanes among short ones, a row of exactly
    LONG_LANES (short) and lanes to the dump row ``live``.

    * random: 3000 targets, about 20 lanes each, runs cut on the lane step
      with stretches of empty rows; three tenths of rank 1's lanes dumped;
    * full_runs: row 0 takes 63 lanes and rows 1-900 LONG_LANES each, so
      runs hold ``RUN_LANES - 1`` lanes, the most a run may;
    * empty_stretch: as random, but the short rows' lanes lie below row
      1000 or from 5000 up, so rows 2048-4095 are one run of ``RUN_ROWS``
      empty rows."""
    from repro_torch.kernels.pack_gather import LONG_LANES
    live, k = 6000, 60000
    if layout == "full_runs":
        rows = np.concatenate([
            np.zeros(63, int), np.repeat(np.arange(1, 901), LONG_LANES),
            np.full(2000, 1500), np.full(LONG_LANES, 1501)])
        rows = np.concatenate([rows, np.full(k - rows.size, live)])
        return np.stack([rows[rng.permutation(k)] for _ in range(p)]
                        ).astype(np.int32), live
    idx = rng.integers(0, 3000 if layout == "random" else 2000, (p, k))
    if layout == "empty_stretch":
        idx[idx >= 1000] += 4000
    idx = idx.astype(np.int32)
    idx[(idx == 1500) | (idx == 1501)] = live
    idx[:, :2000] = 1500                      # a long row among short ones
    idx[:, 2000:2000 + LONG_LANES] = 1501     # at the threshold: short
    idx[1, rng.random(k) < 0.3] = live        # the dump row
    return idx, live


@pytest.mark.parametrize("layout", ["random", "full_runs", "empty_stretch"])
@pytest.mark.parametrize("reduce", ["add", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_runs_straddle_stages_bit_exact(dev, layout, reduce, dtype):
    """Runs cut on the lane step, runs of ``RUN_LANES - 1`` lanes (every
    thread parks several values) and a run of ``RUN_ROWS`` empty rows, each
    beside a long row (2000 lanes), B5 and B6, bit for bit against the
    CPU's sequential fold."""
    from repro_torch.kernels import pack_gather as kpg
    p = 3
    rng = np.random.default_rng(5)
    idx, live = _stage_idx(layout, rng, p)
    if dtype == torch.int32:
        vals = torch.as_tensor(rng.integers(-99, 99, idx.shape),
                               dtype=torch.int32)
        init = torch.as_tensor(rng.integers(-99, 99, (p, live + 1)),
                               dtype=torch.int32)
    else:
        vals = torch.as_tensor(rng.standard_normal(idx.shape)
                               .astype(np.float32)).to(dtype)
        init = torch.as_tensor(rng.standard_normal((p, live + 1))
                               .astype(np.float32)).to(dtype)
    tidx = torch.as_tensor(idx)
    idd = tidx.to(dev)
    table = kops.segment_table(idd, out_len=live + 1, live_len=live)
    runs = table.runs.cpu().numpy().astype(np.int64)
    lanes, rows = runs[:, 3] - runs[:, 2], runs[:, 1] - runs[:, 0]
    assert lanes.max() < kpg.RUN_LANES and table.long_rows.numel() == p
    if layout == "full_runs":
        assert lanes.max() == kpg.RUN_LANES - 1
    if layout == "empty_stretch":
        assert np.any((rows == kpg.RUN_ROWS) & (lanes == 0))
    seg = kops.accumulate_segments(vals.to(dev), idd, out_len=live + 1,
                                   reduce=reduce, table=table)
    into = kops.accumulate_into(init.to(dev), vals.to(dev), idd,
                                reduce=reduce, table=table)
    want_seg = kref.accumulate_segments_ref(vals, tidx, out_len=live + 1,
                                            reduce=reduce)
    want_into = kref.accumulate_into_ref(init, vals, tidx, reduce=reduce)
    assert _same_bits(seg[:, :live], want_seg[:, :live])
    assert _same_bits(into[:, :live], want_into[:, :live])


def test_fold_with_long_rows_in_a_cuda_graph(dev):
    """A fold with long rows captured in a CUDA graph (no start gate there)
    gives the same bits on every replay, and the gated fold outside the
    graph still does after the replays."""
    p = 3
    rng = np.random.default_rng(6)
    idx, live = _stage_idx("random", rng, p)
    vals = torch.as_tensor(rng.standard_normal(idx.shape).astype(
        np.float32)).to(dev)
    idd = torch.as_tensor(idx).to(dev)
    table = kops.segment_table(idd, out_len=live + 1, live_len=live)
    want = kref.accumulate_segments_ref(vals.cpu(), idd.cpu(),
                                        out_len=live + 1)[:, :live]

    def fold():
        return kops.accumulate_segments(vals, idd, out_len=live + 1,
                                        table=table)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fold()                                   # warm-up before capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fold()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out[:, :live], want)
    assert _same_bits(fold()[:, :live], want)


@pytest.mark.parametrize("strategy", ["replicate", "blockwise", "condensed",
                                      "overlap"])
@pytest.mark.parametrize("reduce", ["add", "set", "max"])
def test_scatter_engine_on_card(dev, strategy, reduce):
    """The kernel arm on the card equals the plain arm on the CPU bit for
    bit on random float32 (both fold every target in lane order)."""
    n, m, r, d = 8 * 512, 8 * 256, 5, 3
    rng = np.random.default_rng(4)
    idx = rng.integers(0, n, (m, r)).astype(np.int32)
    vals = rng.standard_normal((m, r, d)).astype(np.float32)
    pattern = AccessPattern.from_indices(idx, n=n)
    kw = dict(strategy=strategy, blocksize=64, shards_per_node=4,
              reduce=reduce)
    card = IrregularScatter(pattern, LoopbackComm(8, device=dev),
                            use_kernel=True, **kw)
    cpu = IrregularScatter(pattern, LoopbackComm(8, device="cpu"),
                           scatter_plan=card.splan, **kw)
    kops.reset_launch_counts()
    y = card(card.shard_values(vals))
    y2 = card.start_local(card.shard_values(vals), *card.plan_args).finish()
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    # two scatters: per scatter replicate folds once, blockwise three
    # times (pack, own, blocks), condensed/overlap twice plus one fold-into
    assert counts["accumulate_segments"] == 2 * {
        "replicate": 1, "blockwise": 3}.get(strategy, 2)
    assert counts["accumulate_into"] == (
        2 if strategy in ("condensed", "overlap") else 0)
    want = cpu(cpu.shard_values(vals))
    assert _same_bits(y, want) and _same_bits(y2, want)


@pytest.mark.parametrize("strategy", ["replicate", "blockwise", "condensed",
                                      "overlap"])
def test_transposed_spmv_on_card(dev, strategy):
    n = 8 * 1024
    m = make_mesh_like_matrix(n, 16, locality_window=n // 64,
                              long_range_frac=0.02, seed=1)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    eng = DistributedSpMV(m, LoopbackComm(8, device=dev), strategy=strategy,
                          blocksize=64, shards_per_node=4, use_kernel=True,
                          transpose=True)
    kops.reset_launch_counts()
    y = eng(eng.shard_vector(x))
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    np.testing.assert_allclose(y.reshape(-1).cpu().numpy(),
                               spmv_t_ref_np(m, x), rtol=2e-4, atol=2e-4)
    # the band clipping piles some 500 lanes onto columns 0 and n - 1: long
    # rows beside short ones, folded in lane order like the CPU's plain arm
    cpu = DistributedSpMV(m, LoopbackComm(8, device="cpu"), strategy=strategy,
                          blocksize=64, shards_per_node=4, transpose=True)
    assert _same_bits(y, cpu(cpu.shard_vector(x)))
    assert counts["accumulate_segments"] == {
        "replicate": 1, "blockwise": 3}.get(strategy, 2)
    assert counts["accumulate_into"] == (
        1 if strategy in ("condensed", "overlap") else 0)


# --------------------------------------------------------------------------
# B7 stencil2d, Heat2D, the normal equations and CG
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (5, 2), (3, 40), (40, 3),
                                   (16, 16), (129, 65), (257, 1031),
                                   (8, 37, 45), (8, 2050, 130)])
@pytest.mark.parametrize("coef", [0.1, 0.13])
def test_stencil2d_bit_exact(dev, shape, coef):
    x = _rand(np.random.default_rng(7), shape, torch.float32, dev)
    before = kops.launch_counts()["stencil2d"]
    got = kops.stencil2d(x, coef=coef)
    torch.cuda.synchronize()
    assert kops.launch_counts()["stencil2d"] == before + 1
    assert got.shape == x.shape
    assert _same_bits(got, kref.stencil2d_ref(x, coef))
    # the plain version on the CPU rounds the same way
    assert _same_bits(got.cpu(), kref.stencil2d_ref(x.cpu(), coef))
    if min(shape[-2:]) < 3:
        assert torch.equal(got, x)


def test_stencil2d_strided_ring_strips(dev):
    padded = _rand(np.random.default_rng(8), (8, 66, 130), torch.float32,
                   dev)
    for strip in (padded[:, 0:3, :], padded[:, -3:, :], padded[:, :, 0:3],
                  padded[:, :, -3:], padded[3], padded[:, 1:-1, 1:-1]):
        got = kops.stencil2d(strip, coef=0.1)
        assert got.is_contiguous() and got.shape == strip.shape
        assert _same_bits(got, kref.stencil2d_ref(strip.contiguous(), 0.1))
    with pytest.raises(TypeError, match="float32"):
        kops.stencil2d(padded.double(), coef=0.1)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("materialize", ["dest", "full"])
@pytest.mark.parametrize("strategy", ["replicate", "blockwise", "condensed",
                                      "overlap"])
def test_heat2d_on_card(dev, strategy, materialize, overlap):
    comm = LoopbackComm(8, device=dev)
    engines = {uk: Heat2D(comm, 96, 160, mprocs=2, nprocs=4, coef=0.1,
                          strategy=strategy, materialize=materialize,
                          overlap=overlap, use_kernel=uk)
               for uk in (False, True)}
    phi = engines[True].init_field(5)
    kops.reset_launch_counts()
    got = engines[True].run(phi, 6)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    assert counts["stencil2d"] > 0
    if strategy != "replicate":
        assert counts["pack_gather"] > 0
    if materialize == "dest":
        assert counts["unpack_dest"] > 0
    elif strategy != "replicate":
        assert counts["unpack_scatter_set"] > 0
    plain = engines[False].run(phi, 6)
    assert _same_bits(got, plain)
    whole = Heat2D.reference(torch.as_tensor(
        engines[True].gather_field(phi)).to(dev), 6, 0.1)
    np.testing.assert_array_equal(engines[True].gather_field(got),
                                  whole.cpu().numpy())


@pytest.mark.parametrize("strategy", ["replicate", "blockwise", "condensed",
                                      "overlap"])
def test_normal_equations_and_cg_on_card(dev, strategy):
    n = 8 * 1024
    m0 = make_mesh_like_matrix(n, 8, locality_window=n // 64,
                               long_range_frac=0.02, seed=2)
    rng = np.random.default_rng(2)
    m = EllpackMatrix(n=n, r_nz=m0.r_nz,
                      diag=rng.integers(-3, 4, n).astype(np.float32),
                      vals=rng.integers(-3, 4, (n, 8)).astype(np.float32),
                      cols=m0.cols)
    x = rng.integers(-3, 4, n).astype(np.float32)
    comm = LoopbackComm(8, device=dev)
    step = normal_equations_step(m, comm, strategy=strategy, blocksize=64,
                                 use_kernel=True)
    kops.reset_launch_counts()
    z = step(step.shard_vector(x))
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    assert counts["unpack_dest"] == 1 and counts["accumulate_segments"] > 0
    np.testing.assert_array_equal(z.reshape(-1).cpu().numpy(),
                                  spmv_t_ref_np(m, spmv_ref_np(m, x)))
    m = make_mesh_like_matrix(n, 8, locality_window=n // 64,
                              long_range_frac=0.02, seed=3)
    b = rng.standard_normal(n).astype(np.float32)
    xs = {uk: ConjugateGradient(m, comm, strategy=strategy, blocksize=64,
                                use_kernel=uk).solve(b, 10).reshape(-1)
          for uk in (False, True)}
    torch.testing.assert_close(xs[True], xs[False], rtol=1e-4, atol=1e-4)


# -- strategy="auto" on the card: calibration, auto engines, plan cache ----

def test_calibration_on_card(dev):
    from repro_torch.comm.exchange import measure_hw
    from repro_torch.core import tune

    comm = LoopbackComm(8, device=dev)
    tune.clear_hardware_cache()
    hw = tune.measure_hardware(comm)
    assert tune.measure_hardware(comm) is hw is measure_hw(comm)
    raw = tune.calibration(comm)
    assert raw["timing"] == "cuda events" and raw["p"] == 8
    # one rank of eight on one card: at most its eighth of the card's HBM
    # rate (an un-stacked probe reads the whole card's)
    assert 1e10 < hw.w_private < 3.35e12 / 8
    assert 1e10 < hw.w_remote < 3.35e12 / 8
    assert 16 <= hw.cacheline <= 4096
    assert 1e-6 < hw.tau < 1e-2 and raw["tau_wall_s"] == hw.tau
    assert raw["all_to_all_tiny_s"] < raw["all_to_all_big_s"]
    assert raw["card_copy_bytes_per_s"] < 3.35e12


@pytest.mark.parametrize("kw", [dict(materialize="full"),
                                dict(materialize="dest"),
                                dict(transpose=True)],
                         ids=["full", "dest", "transposed"])
def test_auto_engine_on_card_equals_its_rung(dev, kw):
    n = 8 * 4096
    m = make_mesh_like_matrix(n, 8, locality_window=n // 64,
                              long_range_frac=0.02, seed=4)
    comm = LoopbackComm(8, device=dev)
    auto = DistributedSpMV(m, comm, strategy="auto", blocksize=256,
                           use_kernel=True, **kw)
    times = auto.predicted_times
    assert auto.requested_strategy == "auto"
    assert auto.strategy == min(times, key=times.get)
    assert all(np.isfinite(t) and t > 0 for t in times.values())
    fixed = DistributedSpMV(m, comm, strategy=auto.strategy, blocksize=256,
                            use_kernel=True, **kw)
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    kops.reset_launch_counts()
    y = auto(auto.shard_vector(x))
    torch.cuda.synchronize()
    assert sum(kops.launch_counts().values()) > 0
    # the same kernels on the same plan: no atomics, the same bits
    assert torch.equal(y, fixed(fixed.shard_vector(x)))
    ref = spmv_t_ref_np(m, x) if kw.get("transpose") else spmv_ref_np(m, x)
    np.testing.assert_allclose(y.reshape(-1).cpu().numpy(), ref, rtol=2e-4,
                               atol=2e-4)


def test_auto_defaults_and_heat2d_on_card(dev):
    n = 8 * 1024
    m = make_mesh_like_matrix(n, 8, locality_window=n // 64,
                              long_range_frac=0.02, seed=5)
    comm = LoopbackComm(8, device=dev)
    step = normal_equations_step(m, comm, blocksize=64, use_kernel=True)
    assert step.predicted_window["total"] > 0
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    z = step(step.shard_vector(x)).reshape(-1).cpu().numpy()
    ref = spmv_t_ref_np(m, spmv_ref_np(m, x))
    np.testing.assert_allclose(z, ref, rtol=2e-4,
                               atol=2e-4 * np.abs(ref).max())
    cg = ConjugateGradient(m, comm, blocksize=64, use_kernel=True,
                           n_steps_hint=10)
    loop = cg.schedule.predicted_loop(10)
    assert loop["total"] > 0 and loop["n_steps"] == 10
    assert bool(torch.isfinite(cg.solve(x, 10)).all())
    h = Heat2D(comm, 256, 512, mprocs=2, nprocs=4, strategy="auto",
               use_kernel=True)
    fixed = Heat2D(comm, 256, 512, mprocs=2, nprocs=4, strategy=h.strategy,
                   use_kernel=True)
    phi = h.init_field(5)
    assert torch.equal(h.run(phi, 4), fixed.run(phi, 4))


def test_plan_cache_disk_round_trip_on_card(dev, tmp_path, monkeypatch):
    from repro_torch.comm import plan_cache

    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path))
    plan_cache.clear_memory_cache()
    n = 8 * 4096
    m = make_mesh_like_matrix(n, 8, locality_window=n // 64,
                              long_range_frac=0.02, seed=6)
    comm = LoopbackComm(8, device=dev)
    x = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    ys = []
    with plan_cache.isolated() as stats:
        for _ in range(2):
            eng = DistributedSpMV(m, comm, strategy="condensed",
                                  blocksize=256, use_kernel=True,
                                  materialize="dest")
            ys.append(eng(eng.shard_vector(x)))
            plan_cache.clear_memory_cache()     # the second one: disk
        assert stats.misses == 1 and stats.disk_hits >= 1
    assert torch.equal(ys[0], ys[1])


# -- B8 decode attention and B9 selective scan against their plain versions

MODEL_TOL = dict(rtol=2e-4, atol=2e-4)   # float32 sums in another order
BF16_OUT_TOL = dict(rtol=2.0 ** -8, atol=2e-4)   # plus one bf16 rounding


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("s", [1, 77, 300, 2080])
@pytest.mark.parametrize("g", [1, 4])
def test_decode_attention_matches_plain(dev, g, s, q_dtype, kv_dtype):
    rng = np.random.default_rng(10 * s + g)
    b, hkv, d = 6, 3, 128
    lengths = rng.integers(1, s + 1, b)
    lengths[:3] = (s, 1, s + 7)          # full, one slot, past the cache
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    q = _rand(rng, (b, hkv * g, d), q_dtype, dev)
    k = _rand(rng, (b, s, hkv, d), kv_dtype, dev)
    v = _rand(rng, (b, s, hkv, d), kv_dtype, dev)
    before = kops.launch_counts()["decode_attention"]
    got = kops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert kops.launch_counts()["decode_attention"] == before + 1
    assert got.dtype == q_dtype and got.shape == q.shape
    want = kref.decode_attention_ref(q.float(), k, v, lengths)
    tol = MODEL_TOL if q_dtype == torch.float32 else BF16_OUT_TOL
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.parametrize("h,hkv,d", [(12, 1, 64), (6, 2, 16), (4, 4, 128),
                                     (20, 2, 80)])
def test_decode_attention_head_shapes(dev, h, hkv, d):
    """G past one block's eight heads, D under a warp, at the limit, and
    not a multiple of 32."""
    rng = np.random.default_rng(h + d)
    b, s = 3, 333
    lengths = torch.as_tensor([333, 5, 200], dtype=torch.int32, device=dev)
    q = _rand(rng, (b, h, d), torch.float32, dev)
    k = _rand(rng, (b, s, hkv, d), torch.float32, dev)
    v = _rand(rng, (b, s, hkv, d), torch.float32, dev)
    torch.testing.assert_close(kops.decode_attention(q, k, v, lengths),
                               kref.decode_attention_ref(q, k, v, lengths),
                               **MODEL_TOL)


def test_decode_attention_length_zero_is_mean_of_v(dev):
    rng = np.random.default_rng(4)
    q = _rand(rng, (2, 4, 32), torch.float32, dev)
    k = _rand(rng, (2, 700, 2, 32), torch.float32, dev)
    v = _rand(rng, (2, 700, 2, 32), torch.float32, dev)
    lengths = torch.tensor([0, -3], dtype=torch.int32, device=dev)
    got = kops.decode_attention(q, k, v, lengths)
    want = v.mean(dim=1).repeat_interleave(2, dim=1)
    torch.testing.assert_close(got, want, **MODEL_TOL)
    torch.testing.assert_close(
        got, kref.decode_attention_ref(q, k, v, lengths), **MODEL_TOL)


def test_decode_attention_refusals(dev):
    q = torch.zeros((2, 4, 16), device=dev)
    kv = torch.zeros((2, 8, 2, 16), device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        kops.decode_attention(q, kv, kv, lengths.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kops.decode_attention(q.half(), kv.half(), kv.half(), lengths)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kops.decode_attention(q.bfloat16(), kv, kv, lengths)
    with pytest.raises(ValueError):
        kops.decode_attention(torch.zeros((2, 3, 16), device=dev), kv, kv,
                              lengths)
    big = torch.zeros((2, 8, 2, 136), device=dev)
    with pytest.raises(ValueError):
        kops.decode_attention(torch.zeros((2, 4, 136), device=dev), big, big,
                              lengths)
    with pytest.raises(ValueError):
        kops.decode_attention(q, kv, kv, lengths.cpu())


@pytest.fixture(params=[None, 1], ids=["planned", "one_tile_splits"])
def split_plan(request, monkeypatch):
    """The planner's splits, and splits of one tile each (the most splits
    a lane can have, so the most partials the last block merges)."""
    if request.param is not None:
        monkeypatch.setattr(kda, "MAX_TILES", request.param)
    return request.param


def _check_decode(dev, b, h, hkv, d, s, lengths, dtype, seed):
    rng = np.random.default_rng(seed)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    q = _rand(rng, (b, h, d), dtype, dev)
    k = _rand(rng, (b, s, hkv, d), dtype, dev)
    v = _rand(rng, (b, s, hkv, d), dtype, dev)
    got = kops.decode_attention(q, k, v, lengths)
    again = kops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    # the last split merges whatever order the splits end in: no race
    assert torch.equal(got, again)
    want = kref.decode_attention_ref(q.float(), k, v, lengths)
    tol = MODEL_TOL if dtype == torch.float32 else BF16_OUT_TOL
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 3, 5, 7, 48])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_decode_attention_any_g_and_d(dev, split_plan, g, d, dtype):
    """G of minitron, qwen2.5/hymba, arctic and granite's MQA; D of the
    reduced configs, 64, a width that is no power of two, and 128; lengths
    0, 1, S and S + 7."""
    hkv = 1 if g == 48 else 2
    s = 200
    _check_decode(dev, 4, g * hkv, hkv, d, s, [0, 1, s, s + 7], dtype,
                  seed=g * d)


@pytest.mark.parametrize("s", [31, 32, 33, 63, 64, 65, 255, 256, 257, 2080])
def test_decode_attention_tile_edges(dev, split_plan, s):
    """S at a tile of 32 slots, two tiles and a split of eight tiles, +- 1,
    with lengths 0, 1, S, S + 7 and short ones that end inside a tile."""
    lengths = [0, 1, s, s + 7, max(1, s // 2 + 1), max(1, s - 1)]
    _check_decode(dev, len(lengths), 8, 2, 128, s, lengths, torch.bfloat16,
                  seed=s)


def test_decode_attention_64_lanes(dev, split_plan):
    """64 lanes of llama3-8b's heads: 512 (lane, KV head) pairs, splits of
    several tiles (``plan_chunk``)."""
    b, s = 64, 2080
    lengths = np.random.default_rng(3).integers(1, s + 8, b)
    lengths[:2] = (0, s)
    if split_plan is None:
        assert kda.plan_chunk(b, s, 8) > kda.TILE
    _check_decode(dev, b, 32, 8, 128, s, lengths, torch.bfloat16, seed=5)


def test_decode_attention_32k_cache(dev, split_plan):
    """decode_32k's cache length, batch cut to 8: lengths in
    [16385, 32768] as in chip_smoke.py, plus a full and an overlong lane."""
    b, s = 8, 32768
    lengths = np.random.default_rng(1).integers(16385, s + 1, b)
    lengths[:2] = (s, s + 7)
    _check_decode(dev, b, 32, 8, 128, s, lengths, torch.bfloat16, seed=6)


# (lanes, query heads, KV heads, D, cache slots, lengths) of the A11
# families' decode attention: hymba's self-attention on its wrapped ring of
# 1024 (group 5; two lanes past the ring, one short of it), whisper's self
# (group 1) and cross over 1500 frames, the vision model's self (group 8)
# and cross over 1601 image tokens, every slot attended
FAMILY_B8 = {
    "hymba_ring1024_g5": (4, 25, 5, 64, 1024, [1024, 1031, 1024, 700]),
    "whisper_self_g1": (8, 6, 6, 64, 96, [96, 1, 50, 96, 7, 33, 96, 64]),
    "whisper_cross1500_g1": (8, 6, 6, 64, 1500, [1500] * 8),
    "vision_self_g8": (4, 64, 8, 128, 160, [160, 1, 129, 160]),
    "vision_cross1601_g8": (4, 64, 8, 128, 1601, [1601] * 4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(FAMILY_B8))
def test_decode_attention_at_the_family_shapes(dev, split_plan, shape,
                                               dtype):
    """B8 at groups 1, 5 and 8, on caches of 1500 and 1601 slots (not a
    multiple of the 32-slot tile) and a wrapped ring of 1024."""
    b, h, hkv, d, s, lengths = FAMILY_B8[shape]
    _check_decode(dev, b, h, hkv, d, s, lengths, dtype, seed=s + h)


@pytest.mark.parametrize("name", ["hymba-1.5b", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
def test_family_decode_on_card_matches_cpu(dev, name):
    """Reduced hymba, whisper and vision models, float32: the cross K/V
    from ``prefill_cross``, 20 tokens through ``prefill_into_cache`` (the
    hybrid's ring of 16 wraps) and 6 greedy steps give the CPU's tokens,
    the logits within 2e-4; B8 once per attention a layer and step; the
    hybrid's forward through B9 within 2e-4 of the CPU's."""
    from repro_torch.launch.serve import prefill_into_cache

    cfg = get_config(name, reduced=True)
    t = cfg.encoder_seq or cfg.num_image_tokens
    rng = np.random.default_rng(2)
    ctx = torch.as_tensor(rng.standard_normal((2, t, cfg.d_model)),
                          dtype=torch.float32) if t else None
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 20)),
                           dtype=torch.int32)
    out = {}
    for d, (model, params) in _model_pair(dev, cfg).items():
        kops.reset_launch_counts()
        cache = model.init_cache(2, 32, cross_len=t, dtype=torch.float32)
        if ctx is not None:
            cache = model.prefill_cross(params, cache, ctx.to(d))
        cache, logits = prefill_into_cache(model, params, cache, toks.to(d))
        seq, steps = [], [logits.cpu()]
        for _ in range(6):
            nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
            seq.append(nxt.cpu())
            logits, cache = model.decode_step(params, cache, nxt[:, None])
            steps.append(logits.cpu())
        fwd = build_prefill(model)(params, toks.to(d)).cpu() \
            if cfg.is_hybrid else None
        out[d] = (torch.stack(seq), steps, fwd, kops.launch_counts())
    per_step = cfg.num_layers * (2 if cfg.is_encdec else 1)
    counts = out[dev][3]
    assert counts["decode_attention"] == per_step * (20 + 6)
    assert counts["selective_scan"] == (cfg.num_layers if cfg.is_hybrid
                                        else 0)
    assert torch.equal(out[dev][0], out["cpu"][0])
    for a, b in zip(out[dev][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, **MODEL_TOL)
    if cfg.is_hybrid:
        torch.testing.assert_close(out[dev][2], out["cpu"][2], **MODEL_TOL)


def _scan_inputs(rng, b, l, di, st, dev):
    x = _rand(rng, (b, l, di), torch.float32, dev) * 0.3
    dt = torch.nn.functional.softplus(_rand(rng, (b, l, di), torch.float32,
                                            dev))
    bm = _rand(rng, (b, l, st), torch.float32, dev) * 0.5
    cm = _rand(rng, (b, l, st), torch.float32, dev) * 0.5
    a = -torch.exp(_rand(rng, (di, st), torch.float32, dev) * 0.3)
    return x, dt, bm, cm, a


@pytest.mark.parametrize("b,l,di,st", [
    (1, 1, 1, 1), (2, 3, 37, 4), (1, 64, 16, 16), (2, 65, 130, 16),
    (1, 200, 40, 32), (3, 129, 24, 8), (1, 300, 17, 5)])
def test_selective_scan_matches_plain(dev, b, l, di, st):
    """di not a multiple of the block's 16 channels, short and ragged L
    around the 64 staged steps, st from 1 to 32."""
    rng = np.random.default_rng(l + di)
    args = _scan_inputs(rng, b, l, di, st, dev)
    before = kops.launch_counts()["selective_scan"]
    got = kops.selective_scan(*args)
    torch.cuda.synchronize()
    assert kops.launch_counts()["selective_scan"] == before + 1
    torch.testing.assert_close(got, kref.selective_scan_ref(*args),
                               **MODEL_TOL)


@pytest.mark.parametrize("l", [15, 16, 17, 63, 64, 65, 127, 128, 129, 257])
def test_selective_scan_chunk_edges(dev, l):
    """L at the staged chunk of 128 steps (st 16) +- 1, two chunks, and
    short L, B = 2, di ragged against the block's 32 channels."""
    rng = np.random.default_rng(l)
    args = _scan_inputs(rng, 2, l, 133, 16, dev)
    torch.testing.assert_close(kops.selective_scan(*args),
                               kref.selective_scan_ref(*args), **MODEL_TOL)


@pytest.mark.parametrize("st", [1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 24, 31,
                                32])
def test_selective_scan_every_state_width(dev, st):
    rng = np.random.default_rng(st)
    args = _scan_inputs(rng, 3, 70, 45, st, dev)
    torch.testing.assert_close(kops.selective_scan(*args),
                               kref.selective_scan_ref(*args), **MODEL_TOL)


@pytest.mark.parametrize("l", [257, 4096])
def test_selective_scan_at_hymba_width(dev, l):
    """hymba-1.5b's d_inner 3200 (its state 16), at a short L and at the
    smoke's prefill length."""
    rng = np.random.default_rng(l)
    args = _scan_inputs(rng, 1, l, 3200, 16, dev)
    torch.testing.assert_close(kops.selective_scan(*args),
                               kref.selective_scan_ref(*args), **MODEL_TOL)


def test_selective_scan_carry_underflows(dev):
    """A strongly decaying ``a``: exp(dt * a) underflows to 0 within a step
    or two, so h forgets its carry at once."""
    rng = np.random.default_rng(9)
    x, dt, bm, cm, a = _scan_inputs(rng, 2, 300, 64, 16, dev)
    a = a * 200.0
    got = kops.selective_scan(x, dt, bm, cm, a)
    torch.testing.assert_close(got, kref.selective_scan_ref(x, dt, bm, cm,
                                                            a), **MODEL_TOL)
    assert bool(torch.isfinite(got).all())


def test_selective_scan_unaligned_rows(dev):
    """x/dt/B/C that are not 16-byte aligned (an odd offset into a larger
    buffer) go through the 4-byte copies."""
    rng = np.random.default_rng(11)
    x, dt, bm, cm, a = (t.contiguous() for t in _scan_inputs(
        rng, 1, 100, 33, 16, dev))
    def shift(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    xs, dts, bms, cms = (shift(t) for t in (x, dt, bm, cm))
    assert xs.data_ptr() % 16 != 0
    torch.testing.assert_close(kops.selective_scan(xs, dts, bms, cms, a),
                               kref.selective_scan_ref(x, dt, bm, cm, a),
                               **MODEL_TOL)


def _rel_err(got, want):
    """Each gradient's largest error over its largest element."""
    return [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("b,l,di,st,scale", [
    (1, 1, 1, 1, 1.0), (1, 7, 3, 5, 1.0), (1, 33, 136, 4, 1.0),
    (2, 129, 24, 8, 1.0), (1, 300, 40, 16, 1.0), (1, 257, 45, 32, 1.0),
    (2, 200, 16, 16, 200.0), (2, 4096, 3200, 16, 1.0),
    (2, 4096, 8192, 16, 1.0)],
    ids=["one", "tiny", "st4", "st8", "segments", "st32", "underflow",
         "hymba", "falcon"])
def test_selective_scan_bwd_matches_plain(dev, b, l, di, st, scale):
    """The backward kernel against the plain backward, each gradient within
    2e-4 of its largest element: ragged L against the 128-step
    checkpoints and 8-step sub-chunks, channels that leave a block
    part-empty, st 1 to 32, a carry that underflows, and the shapes of
    falcon-mamba-7b's and hymba-1.5b's train microbatch (B 2, L 4096, di
    8192 and 3200, st 16).  The checkpointing forward's y is the serving
    kernel's bit for bit, and a second backward gives the same bits."""
    from repro_torch.kernels import selective_scan as b9

    rng = np.random.default_rng(l + di)
    x, dt, bm, cm, a = _scan_inputs(rng, b, l, di, st, dev)
    a = a * scale
    dy = _rand(rng, (b, l, di), torch.float32, dev)
    y, hck = b9.selective_scan_ckpt(x, dt, bm, cm, a)
    assert torch.equal(y, b9.selective_scan(x, dt, bm, cm, a))
    before = kops.launch_counts()["selective_scan_bwd"]
    got = b9.selective_scan_bwd(x, dt, bm, cm, a, hck, dy)
    again = b9.selective_scan_bwd(x, dt, bm, cm, a, hck, dy)
    torch.cuda.synchronize()
    assert kops.launch_counts()["selective_scan_bwd"] == before + 2
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = kref.selective_scan_bwd_ref(x, dt, bm, cm, a, dy)
    assert max(_rel_err(got, want)) <= 2e-4, _rel_err(got, want)


def test_selective_scan_grad_through_ops_on_card(dev):
    """``ops.selective_scan`` in grad mode on the card: the checkpointing
    forward and the backward kernel, one launch each, every input's
    gradient within 2e-4 of the CPU's plain autograd; a non-contiguous
    cotangent is taken."""
    rng = np.random.default_rng(5)
    args = _scan_inputs(rng, 2, 150, 70, 16, dev)
    ct = _rand(rng, (2, 70, 150), torch.float32, dev).transpose(1, 2)
    ins = [t.clone().requires_grad_(True) for t in args]
    before = kops.launch_counts()
    y = kops.selective_scan(*ins)
    got = torch.autograd.grad(y, ins, ct)
    torch.cuda.synchronize()
    after = kops.launch_counts()
    assert after["selective_scan"] == before["selective_scan"] + 1
    assert after["selective_scan_bwd"] == before["selective_scan_bwd"] + 1
    cpu = [t.detach().cpu().requires_grad_(True) for t in args]
    want = torch.autograd.grad(kref.selective_scan_ref(*cpu), cpu, ct.cpu())
    assert max(_rel_err([g.cpu() for g in got], want)) <= 2e-4


def test_selective_scan_refusals(dev):
    rng = np.random.default_rng(0)
    x, dt, bm, cm, a = _scan_inputs(rng, 1, 8, 16, 4, dev)
    with pytest.raises(TypeError, match="float32"):
        kops.selective_scan(x.double(), dt.double(), bm.double(),
                            cm.double(), a.double())
    with pytest.raises(ValueError):                  # L = 0
        kops.selective_scan(x[:, :0], dt[:, :0], bm[:, :0], cm[:, :0], a)
    with pytest.raises(ValueError):                  # a of the wrong shape
        kops.selective_scan(x, dt, bm, cm, a[:8])
    x, dt, bm, cm, a = _scan_inputs(rng, 1, 8, 16, 33, dev)
    with pytest.raises(ValueError):                  # st past 32
        kops.selective_scan(x, dt, bm, cm, a)


# -- the serving paths on the card against the same model on the CPU --

def _model_pair(dev, cfg):
    master = Model(cfg, RunCtx(act_dtype=torch.float32),
                   device="cpu").init_params(torch.Generator().manual_seed(0))
    models = {d: Model(cfg, RunCtx(act_dtype=torch.float32), device=d)
              for d in ("cpu", dev)}
    return {d: (m, m.load_params(master)) for d, m in models.items()}


def test_serve_engine_on_card_matches_cpu(dev):
    """Reduced llama3-8b with G = 2, float32, slot reuse and a ring wrap:
    the same greedy tokens as on the CPU, B8 once per layer and tick."""
    cfg = dataclasses.replace(get_config("llama3-8b", reduced=True),
                              num_kv_heads=2)
    rng = np.random.default_rng(0)
    reqs = [dict(id=i, prompt=rng.integers(0, cfg.vocab_size,
                                           int(rng.integers(3, 7))).tolist(),
                 max_new_tokens=6, arrival_time=float(i // 2))
            for i in range(5)]
    reports = {}
    for d, (model, params) in _model_pair(dev, cfg).items():
        engine = ServeEngine(model, params, num_slots=2, cache_len=8,
                             prefill_chunk=4, cache_dtype=torch.float32)
        for r in reqs:
            engine.submit(Request(**r))
        kops.reset_launch_counts()
        reports[d] = engine.run()
        counts = kops.launch_counts()
    assert counts["decode_attention"] == cfg.num_layers * len(
        reports[dev].tick_seconds)
    assert reports[dev].outputs == reports["cpu"].outputs


def test_ssm_prefill_on_card_matches_cpu(dev):
    cfg = get_config("falcon-mamba-7b", reduced=True)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 100)), dtype=torch.int32)
    logits = {}
    for d, (model, params) in _model_pair(dev, cfg).items():
        kops.reset_launch_counts()
        logits[d] = build_prefill(model)(params, toks.to(d)).cpu()
    assert kops.launch_counts()["selective_scan"] == cfg.num_layers
    torch.testing.assert_close(logits[dev], logits["cpu"], **MODEL_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
def test_plain_fold_on_card_is_repeatable(dev, dtype):
    """The plain fold on the card gives the same sums every run (CG without
    kernels is the yardstick of CG with them), within float32 rounding of
    the CPU's ascending-order sums (exactly for integers, and bit for bit
    for bfloat16, which keeps one rounding per add on the card)."""
    rng = np.random.default_rng(7)
    p, k, live = 2, 200_000, 64
    idx = torch.as_tensor(rng.integers(0, live, (p, k)), dtype=torch.int32)
    vals = torch.as_tensor(rng.standard_normal((p, k)) * 1e3).to(dtype)
    want = kref.accumulate_segments_ref(vals, idx, out_len=live)
    runs = [kref.accumulate_segments_ref(vals.to(dev), idx.to(dev),
                                         out_len=live).cpu()
            for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    if dtype == torch.bfloat16:
        assert torch.equal(runs[0], want)
        return
    # sums of ~3,000 terms of size 1e3 in another order: ~30 float32 ulps
    torch.testing.assert_close(runs[0], want, rtol=1e-4, atol=1.0)


# -- dynamic patterns, the MoE consumers and the GNN on the card --

def _routing_cols(seed, p, n_tok=64, e=8, cap=16, k=2):
    from repro_torch.models.moe import moe_dispatch_pattern, random_router
    te, tw = random_router(seed, n_tok, e, k)
    idx, _ = moe_dispatch_pattern(te, n_tok, e, cap, p)
    return te, tw, torch.as_tensor(idx.reshape(-1, 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [2, 8])
def test_dynamic_derivation_on_card_is_sync_free(dev, p, seed):
    """Both directions' tables derived on the card make no host sync
    (``set_sync_debug_mode("error")`` raises on one) and equal the CPU
    derivation bit for bit, at the envelope and below it (overflow)."""
    from repro_torch.comm import dynamic as dyn

    _, _, cols = _routing_cols(seed, p)
    n = 64
    env = dyn.envelope_s_max(cols.shape[0], 1, n, p)
    for s_max in (env, 1):
        cols_d = cols.to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            g = dyn.derive_gather_tables(cols_d, n, p, s_max)
            s = dyn.derive_scatter_tables(cols_d, n, p, s_max, gather=g)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        gc = dyn.derive_gather_tables(cols, n, p, s_max)
        sc = dyn.derive_scatter_tables(cols, n, p, s_max, gather=gc)
        for got, want in zip(tuple(g) + tuple(s), tuple(gc) + tuple(sc)):
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want)


def _moe_case(seed=0, n_tok=64, d=8, f=16, e=8):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(shape) * 0.3).astype(np.float32)
              for k, shape in (("w1", (e, d, f)), ("w2", (e, f, d)),
                               ("w3", (e, d, f)))}
    return params, rng.standard_normal((n_tok, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dynamic_moe_layer_on_card(dev, dtype):
    """A DynamicMoELayer step over LoopbackComm(8) on the card: its pack
    and derivation sync-free, the same numbers as its composed host-planned
    path on the card (bit for bit) and as the same layer on the CPU."""
    from repro_torch.core import perfmodel as pm
    from repro_torch.models import moe as M

    n_tok, e, cap = 64, 8, 16
    params, x = _moe_case()
    te0, _, _ = _routing_cols(0, 8)
    layers = {d: M.DynamicMoELayer(params, te0, n_tok, e, cap,
                                   LoopbackComm(8, device=d), act="swiglu",
                                   strategy="condensed", hw=pm.ABEL)
              for d in ("cpu", dev)}
    layer = layers[dev]
    for seed in (1, 2):
        te, tw, _ = _routing_cols(seed, 8)
        te_d = torch.as_tensor(te, device=dev)
        tw_d = torch.as_tensor(tw, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cols, w_slot = layer.pack(te_d, tw_d)
            layer.derive(cols)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        xs = layer.shard_tokens(x).to(dtype)
        y = layer(xs, te_d, tw_d)
        comm = layer.comm
        g = M.MoEDispatchGather(te, n_tok, e, cap, comm, strategy="condensed",
                                materialize="full", use_plan_cache=False)
        buf = g(xs)
        w = [t.reshape((8, -1) + tuple(t.shape[1:])) for t in layer._weights]
        out = M.moe_expert_local(buf, *w, act="swiglu")
        c = M.MoECombineScatter(te, tw, n_tok, e, cap, comm,
                                strategy="condensed", use_plan_cache=False)
        assert torch.equal(y, c(out))
        if dtype == torch.float32:
            want = layers["cpu"](layers["cpu"].shard_tokens(x), te, tw)
            torch.testing.assert_close(y.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [77, 2080])
def test_decode_attention_group_6(dev, s, dtype):
    """B8 at mixtral-8x22b's heads: 48 query heads over 8 KV heads of 128,
    a group of 6 (a partial tile of query heads), against its plain
    version at 2e-4 (float32 query) or one bf16 rounding (bf16 query)."""
    rng = np.random.default_rng(s)
    b, h, hkv, d = 8, 48, 8, 128
    lengths = rng.integers(1, s + 1, b)
    lengths[:2] = (s, 1)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    q = _rand(rng, (b, h, d), dtype, dev)
    k = _rand(rng, (b, s, hkv, d), torch.bfloat16, dev)
    v = _rand(rng, (b, s, hkv, d), torch.bfloat16, dev)
    got = kops.decode_attention(q, k, v, lengths)
    want = kref.decode_attention_ref(q.float(), k, v, lengths)
    tol = MODEL_TOL if dtype == torch.float32 else BF16_OUT_TOL
    torch.testing.assert_close(got.float(), want, **tol)


def test_moe_serve_engine_on_card_matches_cpu(dev):
    """Reduced mixtral-8x22b (8 experts, full attention, no drops),
    float32, through the engine with the DynamicMoELayer hook over
    LoopbackComm(8): the same greedy tokens on the card as on the CPU,
    no host plan build after construction, B8 once per layer and tick."""
    from repro_torch.launch.serve import build_moe_layer

    cfg = get_config("mixtral-8x22b", reduced=True)
    cfg = dataclasses.replace(cfg, num_experts=8, swa_window=0,
                              capacity_factor=8.0 / cfg.experts_per_token)
    rng = np.random.default_rng(3)
    reqs = [dict(id=i, prompt=rng.integers(0, cfg.vocab_size, 8).tolist(),
                 max_new_tokens=4, arrival_time=float(i // 4))
            for i in range(8)]
    reports = {}
    for d, (model, params) in _model_pair(dev, cfg).items():
        layer = build_moe_layer(model, params, 8, LoopbackComm(8, device=d))
        engine = ServeEngine(model, params, num_slots=8, cache_len=16,
                             prefill_chunk=4, moe_layer=layer,
                             cache_dtype=torch.float32)
        snap = engine.snapshot()
        for r in reqs:
            engine.submit(Request(**r))
        kops.reset_launch_counts()
        reports[d] = engine.run()
        delta = engine.assert_steady_state(snap)
        assert delta["device-derive"] == cfg.num_layers * delta[
            "decode_steps"]
        counts = kops.launch_counts()
    assert counts["decode_attention"] == cfg.num_layers * len(
        reports[dev].tick_seconds)
    assert reports[dev].outputs == reports["cpu"].outputs


@pytest.mark.parametrize("strategy", ["condensed", "auto"])
def test_gnn_on_card_matches_oracle(dev, strategy):
    from repro_torch.core import perfmodel as pm
    from repro_torch.models.gnn import (GNNNeighborAggregate, gnn_ref_np,
                                        random_neighbors)

    n, r, d = 4096, 16, 64
    nbrs = random_neighbors(n, r, alpha=1.1, seed=1)
    h = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    layer = GNNNeighborAggregate(nbrs, n, LoopbackComm(8, device=dev),
                                 strategy=strategy, hw=pm.ABEL)
    got = layer(layer.shard_features(h)).reshape(n, d).cpu().numpy()
    np.testing.assert_allclose(got, gnn_ref_np(h, nbrs), rtol=2e-4,
                               atol=2e-4)


# -- training (plain PyTorch, and B9 with its backward in the ssm and hybrid
# stacks) --

@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "hymba-1.5b"])
def test_train_step_on_card_matches_cpu(dev, no_tf32, name, accum):
    """One float32 train step of a reduced model on the card and on the
    CPU: loss, gradient norm and updated parameters within 1e-4."""
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.steps import build_train_step

    cfg = get_config(name, reduced=True)
    master = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0), master=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int64))
    out = {}
    for d in (dev, "cpu"):
        model = Model(cfg, RunCtx(act_dtype=torch.float32), device=d)
        opt = AdamW(lr=cosine_schedule(3e-4, 20, 100), weight_decay=0.01)
        params = tree_map(lambda t: t.to(model.device, copy=True), master)
        batch = (toks[:, :-1].to(model.device), toks[:, 1:].to(model.device))
        params, _, met = build_train_step(model, opt, accum_steps=accum)(
            params, opt.init(params), batch)
        out[str(d)] = (met, [t.cpu() for t in tree_leaves(params)])
    (mc, pc), (mh, ph) = out[str(dev)], out["cpu"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mc[k]), float(mh[k]), rtol=1e-4,
                                   atol=1e-4)
    for a, b in zip(pc, ph):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "hymba-1.5b"])
def test_remat_on_card_is_bit_identical(dev, name):
    """bf16 activations on float32 master weights: remat full, dots and
    groups of 2 give the gradients of no remat, bit for bit."""
    from repro_torch.models.transformer import tree_leaves, tree_map

    cfg = get_config(name, reduced=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int64)).to(dev)
    master = None
    grads = {}
    for ctx in (dict(remat="none"), dict(remat="full"), dict(remat="dots"),
                dict(remat="full", remat_groups=2)):
        model = Model(cfg, RunCtx(act_dtype=torch.bfloat16, **ctx),
                      device=dev)
        if master is None:
            master = model.init_params(
                torch.Generator(device=dev).manual_seed(0), master=True)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), master)
        loss = model.loss(leaves, toks[:, :-1], toks[:, 1:], chunk=32)
        loss.backward()
        grads[str(ctx)] = [loss.detach()] + [t.grad for t in
                                             tree_leaves(leaves)]
    want = grads[str(dict(remat="none"))]
    for got in grads.values():
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_resume_on_card_is_exact(dev, tmp_path):
    """launch.train on the card (bf16 activations): an 8-step run and the
    same run resumed from its step-5 checkpoint give the same losses."""
    import shutil

    from repro_torch.launch import train as ltrain

    argv = ["--arch", "llama3-8b", "--reduced", "--batch", "4", "--seq",
            "64", "--steps", "8", "--save-every", "5", "--ckpt-dir",
            str(tmp_path)]
    whole = ltrain.main(argv)
    shutil.rmtree(tmp_path / "step_8")
    resumed = ltrain.main(argv)
    assert [h["step"] for h in resumed] == [5, 6, 7]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in whole[5:]]


def test_bf16_embedding_backward_on_card_is_the_cpus(dev):
    """``_embed_fwd``'s backward at bf16 activations over a float32 table
    (each token's rows added in bf16 in ascending position order,
    ``kref.ordered_add``) gives the CPU's gradient bit for bit, every
    run."""
    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(get_config("llama3-8b", reduced=True),
                              vocab_size=50, d_model=16)
    rng = np.random.default_rng(12)
    w = torch.as_tensor(rng.standard_normal((50, 16)), dtype=torch.float32)
    tokens = torch.as_tensor(rng.integers(0, 50, (4, 1024)))
    ct = torch.as_tensor(rng.standard_normal((4, 1024, 16)),
                         dtype=torch.float32).bfloat16()
    grads = []
    for d in ("cpu", dev, dev):
        wd = w.detach().to(d).requires_grad_(True)
        TT._embed_fwd({"w": wd}, tokens.to(d), cfg,
                      RunCtx(act_dtype=torch.bfloat16)).backward(ct.to(d))
        grads.append(wd.grad.cpu())
    assert torch.equal(grads[1], grads[0]) and torch.equal(grads[2],
                                                           grads[0])


def test_card_kernels_refuse_grad_on_card(dev):
    """B8 refuses an input that requires grad on the card as on the CPU;
    B9 gives it its gradient through the backward kernel."""
    q = torch.zeros((2, 4, 16), device=dev, requires_grad=True)
    kv = torch.zeros((2, 8, 2, 16), device=dev)
    lengths = torch.full((2,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="serving kernel"):
        kops.decode_attention(q, kv, kv, lengths)
    x = torch.ones((1, 8, 4), device=dev, requires_grad=True)
    bm = torch.ones((1, 8, 3), device=dev)
    a = -torch.ones((4, 3), device=dev)
    before = kops.launch_counts()["selective_scan_bwd"]
    got, = torch.autograd.grad(
        kops.selective_scan(x, x.detach(), bm, bm, a).sum(), x)
    torch.cuda.synchronize()
    assert kops.launch_counts()["selective_scan_bwd"] == before + 1
    xc = x.detach().cpu().requires_grad_(True)
    want, = torch.autograd.grad(kref.selective_scan_ref(
        xc, xc.detach(), bm.cpu(), bm.cpu(), a.cpu()).sum(), xc)
    torch.testing.assert_close(got.cpu(), want, **MODEL_TOL)
