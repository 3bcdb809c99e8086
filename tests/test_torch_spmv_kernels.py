"""Torch models of the card's B4 and B5/B6 kernels, checked on the CPU
against the JAX reference's Pallas kernels in interpret mode.

The CUDA kernels run only on the card; what they compute in which order is
modelled here step for step, so the decomposition is checked where the
reference runs.

* B4 ``ellpack_spmv_windowed`` (``csrc/ellpack_spmv.cu``): x staged
  through the order table (each group of rows' entries sorted by the x
  position they read, each gathered value parked at its entry's slot), then
  a group of ``lanes`` threads a row, lane ``l`` summing the row's vector
  chunks
  ``l, l + lanes, ...`` (4 entries each where r_nz is a multiple of 4, else
  one) with fused multiply-adds in entry order, the lanes' sums combined by
  the xor butterfly, then ``fma(diag, own, sum)``; float32 sums from float32
  or bfloat16 inputs.  Tolerances: float32 3e-5 (the reference's own kernel
  test), bfloat16 one bf16 rounding of the float32 sum (2^-8 relative) plus
  1e-4.
* B5 ``accumulate_segments`` / B6 ``accumulate_into``
  (``csrc/accumulate.cu``): the segment table's runs (each staged, then
  folded row by row in lane order), its long rows (folded whole), padding
  and dump rows.  Bit for bit, add and max, float32, bfloat16 and int32.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import matrix as tmatrix
from repro_torch.kernels import ellpack_spmv as tes
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack_gather as tpg
from repro_torch.kernels import ref as tref

# the reference's kernel modules (``repro.kernels`` exports functions of
# the same names, so import the modules by their paths)
jes = importlib.import_module("repro.kernels.ellpack_spmv")
jpg = importlib.import_module("repro.kernels.pack_gather")

TOL = dict(rtol=3e-5, atol=3e-5)
BF16_TOL = dict(rtol=2.0 ** -8, atol=1e-4)
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i32": jnp.int32}


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


# --------------------------------------------------------------------------
# B4: the lane order of the card's SpMV
# --------------------------------------------------------------------------

def spmv_model(diag, vals, cols_rel, own_rel, win_blk, x, *, window,
               rows_per_block, group_rows=None):
    """What ``csrc/ellpack_spmv.cu`` computes, in its order (see the module
    docstring); arguments as ``ellpack_spmv_windowed``'s.  ``group_rows``:
    stage x through ``order_table`` for groups of that many rows (None:
    gather in row order).  Returns the float32 sums and y in the matrix's
    dtype."""
    p, rows, r = vals.shape
    vec = 4 if r % 4 == 0 else 1
    per_row = r // vec
    lanes = 1
    while lanes < per_row and lanes < 32:
        lanes <<= 1
    base = (win_blk.to(torch.int64) * window).repeat_interleave(
        rows_per_block, dim=1)
    if group_rows is None:
        g = x.float().gather(1, (base[:, :, None] + cols_rel).reshape(p, -1)
                             ).reshape(p, rows, r)
    else:
        pos, slot = tes.order_table(cols_rel, win_blk, window=window,
                                    rows_per_block=rows_per_block,
                                    group_rows=group_rows)
        entry = torch.arange(rows * r)
        start = entry // (group_rows * r) * (group_rows * r)
        parked = torch.full((p, rows * r), float("nan"))
        parked.scatter_(1, start + slot.to(torch.int64) % (1 << 16),
                        x.float().gather(1, pos.to(torch.int64)))
        g = parked.reshape(p, rows, r)
    v = vals.float()
    part = torch.zeros((lanes, p, rows))
    for j in range(per_row):                 # lane j % lanes, in j order
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
        own = x.float().gather(1, base + own_rel)
        acc = tref.fma_f32(diag.float(), own, acc)
    return acc, acc.to(vals.dtype)


def _window_inputs(n, r_nz, rows_per_block, seed):
    m = tmatrix.make_mesh_like_matrix(n, r_nz, locality_window=n // 16,
                                      long_range_frac=0.03, seed=seed)
    window, win_blk, cols_rel, own_rel = tops.plan_spmv_windows(
        m.cols, rows_per_block=rows_per_block)
    x_len = (int(win_blk.max()) + 2) * window
    x = np.random.default_rng(seed).standard_normal(x_len).astype(
        np.float32)
    return m, window, win_blk, cols_rel, own_rel, x


@pytest.mark.parametrize("r_nz", [16, 8, 3, 33])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_diag", [True, False])
@pytest.mark.parametrize("group_rows", [None, 64, 2048])
def test_spmv_lane_order_matches_reference(r_nz, dtype, with_diag,
                                           group_rows):
    """The card's decomposition against the Pallas kernel at 1056 rows (not
    a multiple of the kernels' 64-, 128- or 1024-row blocks), with and
    without the diagonal term (the reference's kernel always has one: a
    zero diagonal stands for none), x gathered in row order or staged
    through the order table in groups of 64 rows or of one (partial)
    group."""
    if group_rows is not None and r_nz % 4:
        group_rows = None          # the sorted kernel takes r_nz % 4 == 0
    n, rpb = 1056, 32
    m, window, win_blk, cols_rel, own_rel, x = _window_inputs(
        n, r_nz, rpb, seed=r_nz)
    diag = m.diag if with_diag else np.zeros(n, np.float32)
    tdt, jdt = TDT[dtype], JDT[dtype]
    want = np.asarray(jes.ellpack_spmv_windowed(
        jnp.asarray(diag).astype(jdt), jnp.asarray(m.vals).astype(jdt),
        jnp.asarray(cols_rel), jnp.asarray(own_rel), jnp.asarray(win_blk),
        jnp.asarray(x).astype(jdt), window=window, rows_per_block=rpb,
        interpret=True)).astype(np.float32)
    args = (torch.as_tensor(diag).to(tdt)[None] if with_diag else None,
            torch.as_tensor(m.vals).to(tdt)[None],
            torch.as_tensor(cols_rel)[None], torch.as_tensor(own_rel)[None],
            torch.as_tensor(win_blk)[None], torch.as_tensor(x).to(tdt)[None])
    kw = dict(window=window, rows_per_block=rpb)
    acc, y = spmv_model(*args, **kw, group_rows=group_rows)
    plain = tops.ellpack_spmv_windowed(*args, **kw)
    assert y.dtype == plain.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(y[0].numpy(), want, **TOL)
        np.testing.assert_allclose(plain[0].numpy(), want, **TOL)
    else:
        # float32 sums of the same bf16 products, one bf16 rounding apart
        np.testing.assert_allclose(want, acc[0].numpy(), **BF16_TOL)
        np.testing.assert_allclose(plain[0].float().numpy(),
                                   acc[0].numpy(), **BF16_TOL)


def test_spmv_lane_order_is_not_the_plain_order():
    """The model's order is the card's, not the plain version's: on a row
    of 16 entries the two sums differ in their last bits somewhere, so the
    model checks an order of its own."""
    m, window, win_blk, cols_rel, own_rel, x = _window_inputs(
        4096, 16, 256, seed=3)
    args = (torch.as_tensor(m.diag)[None], torch.as_tensor(m.vals)[None],
            torch.as_tensor(cols_rel)[None], torch.as_tensor(own_rel)[None],
            torch.as_tensor(win_blk)[None], torch.as_tensor(x)[None])
    kw = dict(window=window, rows_per_block=256)
    _, y = spmv_model(*args, **kw)
    plain = tref.ellpack_spmv_ref(*args, **kw)
    assert not torch.equal(y, plain)
    torch.testing.assert_close(y, plain, **TOL)


@pytest.mark.parametrize("group_rows", [1, 64, 100, 1024])
def test_order_table_permutes_each_group(group_rows):
    """The order table of the column-sorted SpMV: per rank and group of
    rows, ``slot`` is a permutation of the group's entries (the last group
    partial), ``pos`` is each entry's x position, ascending inside the
    group, and equal positions keep their entries' order."""
    p, rows, r, rpb, window = 3, 544, 8, 32, 384
    rng = np.random.default_rng(group_rows)
    cols_rel = torch.as_tensor(rng.integers(0, 2 * window, (p, rows, r)),
                               dtype=torch.int32)
    cols_rel[:, :, 1] = cols_rel[:, :, 0]          # ties inside rows
    win_blk = torch.as_tensor(rng.integers(0, 5, (p, rows // rpb)),
                              dtype=torch.int32)
    pos, slot = tes.order_table(cols_rel, win_blk, window=window,
                                rows_per_block=rpb, group_rows=group_rows)
    assert pos.dtype == torch.int32 and slot.dtype == torch.int16
    want = ((win_blk.long() * window).repeat_interleave(rpb, dim=1)[:, :, None]
            + cols_rel).reshape(p, -1).numpy()
    slots = slot.numpy().astype(np.int64) % (1 << 16)
    step = group_rows * r
    for q in range(p):
        for g0 in range(0, rows * r, step):
            g1 = min(g0 + step, rows * r)
            s = slots[q, g0:g1]
            assert np.array_equal(np.sort(s), np.arange(g1 - g0))
            got = pos[q, g0:g1].numpy()
            assert np.array_equal(got, want[q, g0 + s])
            assert np.all(np.diff(got) >= 0)
            tie = np.diff(got) == 0
            assert np.all(np.diff(s)[tie] > 0)


def test_plan_order_exists_on_the_card_only():
    """A planner's ``PlanOrder`` builds no table for CPU tensors (the plain
    version reads none), nor for rows the column-sorted kernel does not
    take; ``sortable`` names those: multiples of 4 up to 32."""
    order = tes.PlanOrder(window=256, rows_per_block=32)
    for r in (16, 3):
        assert order(torch.zeros((2, 64, r), dtype=torch.int32),
                     torch.zeros((2, 2), dtype=torch.int32)) is None
    assert [r for r in range(1, 41) if tes.sortable(r)] == list(
        range(4, 33, 4))


# --------------------------------------------------------------------------
# B5/B6: the runs, long rows, padding and dump rows of the card's fold
# --------------------------------------------------------------------------

def _combine(acc, v, reduce: str, dtype: str):
    """One combine of the card's fold, on numpy scalars of the element
    type (bfloat16 values carried as float32)."""
    if dtype == "i32":
        if reduce == "add":
            return np.int32((int(acc) + int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31)
        return max(acc, v)
    if reduce == "add":
        s = np.float32(acc + v)
        if dtype == "bf16":        # rounded back to bfloat16 every add
            s = np.float32(torch.tensor(s).to(torch.bfloat16).float())
        return s
    if np.isnan(acc) or np.isnan(v):
        return np.float32(np.nan)
    if acc == v:
        return v if np.signbit(acc) else acc   # +0.0 beats -0.0
    return max(acc, v)


def fold_model(table, vals, start, reduce: str, dtype: str):
    """What ``rt_accumulate_segments``/``rt_accumulate_into`` and
    ``rt_fold_long_rows`` compute from ``table`` on scalar rows: every run
    parks its lane range of values, then each of its rows folds its own
    lanes from there in order; each long row folds its lanes whole; a row
    with a padding lane gets one +0.0 under add.  ``start`` (P, live) holds
    the start values; returns the live rows (float32 for bfloat16)."""
    perm, sp = table.perm.numpy(), table.seg_ptr.numpy()
    live = table.live_len
    out = start.copy()
    done = np.zeros(out.shape, bool)

    def finish(q, t, acc):
        if (reduce == "add" and table.pad_rows is not None
                and table.pad_rows[q, t]):
            acc = _combine(acc, out.dtype.type(0), reduce, dtype)
        assert not done[q, t], "a row folded twice"
        out[q, t], done[q, t] = acc, True

    for g0, g1, lo, hi in table.runs.tolist():
        q = g0 // live
        parked = vals[q, perm[q, lo:hi]]
        for t in range(g0 - q * live, g1 - q * live):
            acc = out[q, t]
            for v in parked[sp[q, t] - lo:sp[q, t + 1] - lo]:
                acc = _combine(acc, v, reduce, dtype)
            finish(q, t, acc)
    for g in table.long_rows.tolist():
        q, t = divmod(g, live)
        acc = out[q, t]
        for j in range(sp[q, t], sp[q, t + 1]):
            acc = _combine(acc, vals[q, perm[q, j]], reduce, dtype)
        finish(q, t, acc)
    assert done.all(), "a live row folded by no run and no long row"
    return out


LAYOUTS = ["mixed", "full_runs", "empty_stretch"]


def _fold_idx(layout: str, rng, p: int, k: int, live: int):
    """``(idx, pad, live)``: the targets of one of ``LAYOUTS`` over ``live``
    rows and the dump row ``live``, and the padding lanes (the reduce
    identity, on row 0), each rank's lanes in an order of its own.

    * mixed (``k`` lanes over ``live`` rows): random rows; row 7 of every
      rank takes 200 lanes (past ``LONG_LANES``), rank 1's row 30 exactly
      LONG_LANES, about a fifth of the lanes go to the dump row and a tenth
      are padding.
    * full_runs (80 rows): row 0 folds 63 lanes and rows 1-69 LONG_LANES
      each, so the first run holds ``RUN_LANES - 1`` lanes (the most a run
      may) and the next starts on a lane-step cut; row 70 is long (200),
      rows 71-79 take five each.
    * empty_stretch (4200 rows): ten lanes on each of rows 0-49 and
      4150-4199 and a long row 4100: rows 2048-4095 are one run of
      ``RUN_ROWS`` empty rows.

    The last two send 300 lanes to the dump row and add 50 padding lanes."""
    if layout == "mixed":
        idx = rng.integers(0, live + 1, (p, k)).astype(np.int32)
        idx[rng.random((p, k)) < 0.2] = live
        hot = rng.choice(k, 200, replace=False)
        idx[:, hot] = 7
        pad = rng.random((p, k)) < 0.1
        idx[pad] = 0
        idx[1, idx[1] == 30] = 29
        free = np.flatnonzero((idx[1] < live) & (idx[1] != 7) & ~pad[1])
        idx[1, rng.choice(free, tpg.LONG_LANES, replace=False)] = 30
        return idx, pad, live
    if layout == "full_runs":
        live = 80
        rows = np.concatenate([np.zeros(63, int),
                               np.repeat(np.arange(1, 70), tpg.LONG_LANES),
                               np.full(200, 70),
                               np.repeat(np.arange(71, 80), 5)])
    else:
        live = 4200
        rows = np.concatenate([np.repeat(np.arange(50), 10),
                               np.repeat(np.arange(4150, 4200), 10),
                               np.full(200, 4100)])
    rows = np.concatenate([rows, np.full(300, live), np.zeros(50, int)])
    flag = np.arange(rows.size) >= rows.size - 50
    order = np.stack([rng.permutation(rows.size) for _ in range(p)])
    return rows[order].astype(np.int32), flag[order], live


def _check_layout(layout: str, table) -> None:
    """The run boundary each layout is built to reach."""
    runs = table.runs.numpy().astype(np.int64)
    assert table.long_rows.numel() >= table.perm.shape[0]
    assert runs.shape[0] > 1
    assert (runs[:, 3] - runs[:, 2]).max() < tpg.RUN_LANES
    if layout == "full_runs":
        assert (runs[:, 3] - runs[:, 2]).max() == tpg.RUN_LANES - 1
    if layout == "empty_stretch":
        assert np.any((runs[:, 1] - runs[:, 0] == tpg.RUN_ROWS)
                      & (runs[:, 2] == runs[:, 3]))


def _fold_inputs(dtype, reduce, seed, layout="mixed", p=3, k=1400,
                 live=60):
    """``_fold_idx``'s lanes with values: -0.0, NaN and inf among the
    floats, int32's extremes among the integers, and start values for the
    fold-into; padding lanes carry the reduce identity."""
    rng = np.random.default_rng(seed)
    idx, pad, live = _fold_idx(layout, rng, p, k, live)
    p, k = idx.shape
    if dtype == "i32":
        vals = rng.integers(-1000, 1000, (p, k)).astype(np.int32)
        vals[:, :2] = np.iinfo(np.int32).max
        init = rng.integers(-1000, 1000, (p, live + 1)).astype(np.int32)
        ident = 0 if reduce == "add" else np.iinfo(np.int32).min
    else:
        vals = rng.standard_normal((p, k)).astype(np.float32)
        vals[:, :6] = [-0.0, 0.0, np.nan, np.inf, -np.inf, -0.0]
        init = rng.standard_normal((p, live + 1)).astype(np.float32)
        init[:, 0] = -0.0
        if dtype == "bf16":
            vals, init = (torch.as_tensor(a).to(torch.bfloat16).float()
                          .numpy() for a in (vals, init))
        ident = 0.0 if reduce == "add" else -np.inf
    vals[pad] = ident
    return idx, vals, init, pad, ident


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("reduce", ["add", "max"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i32"])
def test_run_fold_bit_exact(layout, reduce, dtype):
    """The card's fold through runs and long rows against the reference's
    ``accumulate_segments`` and ``accumulate_into`` (interpret mode), bit
    for bit on every live row, on random rows, on runs of the most lanes a
    run may hold and on a run of ``RUN_ROWS`` empty rows."""
    idx, vals, init, pad, ident = _fold_inputs(dtype, reduce, seed=7,
                                               layout=layout)
    p, live = idx.shape[0], init.shape[1] - 1
    table = tpg.segment_table(torch.as_tensor(idx), out_len=live + 1,
                              live_len=live, pad=torch.as_tensor(pad))
    _check_layout(layout, table)
    got_seg = fold_model(table, vals, np.full((p, live), ident, vals.dtype),
                         reduce, dtype)
    got_into = fold_model(table, vals, init[:, :live], reduce, dtype)
    jdt = JDT[dtype]
    for q in range(p):
        jv, ji = jnp.asarray(vals[q]).astype(jdt), jnp.asarray(idx[q])
        want_seg = jpg.accumulate_segments(jv, ji, out_len=live + 1,
                                           reduce=reduce, interpret=True)
        want_into = jpg.accumulate_into(jnp.asarray(init[q]).astype(jdt),
                                        jv, ji, reduce=reduce,
                                        interpret=True)
        for got, want in ((got_seg[q], want_seg), (got_into[q], want_into)):
            want = np.asarray(want)[:live].astype(got.dtype)
            nan = np.isnan(want) if dtype != "i32" else np.zeros(live, bool)
            np.testing.assert_array_equal(np.isnan(got) if dtype != "i32"
                                          else nan, nan)
            np.testing.assert_array_equal(got[~nan].view(np.int32),
                                          want[~nan].view(np.int32))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_runs_partition_the_sorted_table(layout, seed):
    """The run table's invariants: perm is a permutation of each rank's
    lanes; the runs and the long rows cover every live row once, in order,
    each run inside one rank with at most ``RUN_ROWS`` rows and fewer than
    ``RUN_LANES`` lanes; the runs' lane ranges are their rows' ``seg_ptr``
    span, and with the long rows' spans they partition the folded lanes
    ``[0, seg_ptr[q, live])`` of every rank; inside a run the lanes' targets
    ascend, each target's lanes in ascending lane order."""
    idx, _, init, pad, _ = _fold_inputs("f32", "add", seed, layout=layout,
                                        p=4, k=5000, live=700)
    p, k = idx.shape
    live = init.shape[1] - 1
    table = tpg.segment_table(torch.as_tensor(idx), out_len=live + 1,
                              live_len=live, pad=torch.as_tensor(pad))
    _check_layout(layout, table)
    perm, sp = table.perm.numpy(), table.seg_ptr.numpy().astype(np.int64)
    runs = table.runs.numpy().astype(np.int64)
    for q in range(p):
        assert np.array_equal(np.sort(perm[q]), np.arange(k))
    rows = np.zeros(p * live, int)
    lanes = [np.zeros(sp[q, live], int) for q in range(p)]
    for g0, g1, lo, hi in runs:
        q = g0 // live
        t0, t1 = g0 - q * live, g1 - q * live
        assert 0 <= t0 < t1 <= live and t1 - t0 <= tpg.RUN_ROWS
        assert (lo, hi) == (sp[q, t0], sp[q, t1])
        rows[g0:g1] += 1
        lanes[q][lo:hi] += 1
        tgt = idx[q, perm[q, lo:hi]]
        assert np.all(np.diff(tgt) >= 0) and tgt.min(initial=t0) >= t0
        assert tgt.max(initial=t0) < t1
        for t in range(t0, t1):
            assert np.all(np.diff(perm[q, sp[q, t]:sp[q, t + 1]]) > 0)
    assert np.all(np.diff(runs[:, 0]) > 0) and np.all(runs[:-1, 1]
                                                     <= runs[1:, 0])
    for g in table.long_rows.numpy():
        q, t = divmod(int(g), live)
        assert sp[q, t + 1] - sp[q, t] > tpg.LONG_LANES
        rows[g] += 1
        lanes[q][sp[q, t]:sp[q, t + 1]] += 1
    assert np.all(rows == 1)
    for q in range(p):
        assert np.all(lanes[q] == 1)
        assert sp[q, live] == int(((idx[q] < live) & ~pad[q]).sum())


def test_runs_of_an_empty_table():
    """No live row, or no rank: no run; a rank whose lanes all go to the
    dump row: runs of empty rows only."""
    idx = torch.zeros((2, 5), dtype=torch.int32)
    assert tpg.segment_table(idx, out_len=1, live_len=0).runs.shape == (0, 4)
    assert tpg.segment_table(torch.zeros((0, 5), dtype=torch.int32),
                             out_len=3).runs.shape == (0, 4)
    table = tpg.segment_table(torch.full((2, 5), 3000, dtype=torch.int32),
                              out_len=3001, live_len=3000)
    runs = table.runs.numpy()
    assert np.all(runs[:, 2] == runs[:, 3]) and runs[0, 0] == 0
    assert runs[:, 1].max() == 6000 and len(runs) == 4  # 2048 + 952 a rank
