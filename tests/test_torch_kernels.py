"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX reference's kernels in interpret mode and its ``kernels/ref.py``.

B1 ``pack_gather``, B3 ``unpack_dest``: bit-exact.  B2
``unpack_scatter_set``: bit-exact outside the dump row(s).  B4
``ellpack_spmv_windowed``: rtol/atol 3e-5 (float32 sums in another order,
the tolerance of the reference's own kernel test).  The port runs every
rank in one call; the reference runs one rank at a time, as inside its
``shard_map``.  On the CPU no kernel launches, so the launch counters stay 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import plan as jplan
from repro.core import matrix as jmatrix
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.comm import plan as tplan
from repro_torch.core import matrix as tmatrix
from repro_torch.kernels import ops as tops

TOL = dict(rtol=3e-5, atol=3e-5)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _pair(a32: np.ndarray, dtype: str):
    """The same float32 values as a torch and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.as_tensor(a32).to(tdt), jnp.asarray(a32).astype(jdt)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("feat", [(), (3,)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 77, 256])
def test_pack_gather_bit_exact(feat, dtype, m):
    rng = np.random.default_rng(m)
    p, shard = 4, 53
    x32 = rng.standard_normal((p, shard) + feat).astype(np.float32)
    idx = rng.integers(0, shard, (p, m)).astype(np.int32)
    tx, jx = _pair(x32, dtype)
    got = tops.pack_gather(tx, torch.as_tensor(idx))
    assert got.shape == (p, m) + feat
    for q in range(p):
        want = jops.pack_gather(jx[q], jnp.asarray(idx[q]))
        np.testing.assert_array_equal(_bits(got[q]), _jbits(want))
        np.testing.assert_array_equal(
            _bits(got[q]), _jbits(jref.pack_gather_ref(jx[q], idx[q])))


@pytest.mark.parametrize("feat", [(), (3,)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("slots", [1, 101])
def test_unpack_dest_bit_exact(feat, dtype, slots):
    rng = np.random.default_rng(slots)
    p, n_recv, shard = 4, 40, 24
    recv32 = rng.standard_normal((p, n_recv) + feat).astype(np.float32)
    x32 = rng.standard_normal((p, shard) + feat).astype(np.float32)
    # -0.0, inf and NaN pass through the two products and the add
    recv32.reshape(-1)[:3] = [-0.0, np.inf, np.nan]
    x32.reshape(-1)[:3] = [-0.0, -np.inf, 1.0]
    kind = rng.integers(0, 3, (p, slots))              # own / foreign / zero
    src = rng.integers(0, n_recv, (p, slots)).astype(np.int32)
    own = rng.integers(0, shard, (p, slots)).astype(np.int32)
    src[:, :3] = np.arange(min(3, slots))[None] if slots >= 3 else 0
    own_m = (kind == 0).astype(np.int8)
    rem_m = (kind == 1).astype(np.int8)
    tr, jr = _pair(recv32, dtype)
    tx, jx = _pair(x32, dtype)
    got = tops.unpack_dest(tr, tx, *map(torch.as_tensor,
                                        (src, own, own_m, rem_m)))
    for q in range(p):
        args = (jr[q], jx[q], jnp.asarray(src[q]), jnp.asarray(own[q]),
                jnp.asarray(own_m[q]), jnp.asarray(rem_m[q]))
        for want in (jops.unpack_dest(*args), jref.unpack_dest_ref(*args)):
            # a NaN's payload bits are the platform's own (bf16 NaNs come
            # out 0xffff from torch, 0xffc0 from XLA): NaN by position,
            # every other value bit for bit
            nan = np.isnan(np.asarray(want, np.float32))
            np.testing.assert_array_equal(got[q].float().isnan().numpy(),
                                          nan)
            np.testing.assert_array_equal(_bits(got[q])[~nan],
                                          _jbits(want)[~nan])


@pytest.mark.parametrize("extra_slots", [0, 1])
@pytest.mark.parametrize("copy_own", [True, False])
@pytest.mark.parametrize("feat", [(), (3,)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unpack_scatter_set_bit_exact(extra_slots, copy_own, feat, dtype):
    rng = np.random.default_rng(7)
    p, rows, n_recv = 4, 16, 31
    n = p * rows
    out_len = n + 1 + extra_slots
    idx = np.full((p, n_recv), n, np.int32)            # padding -> dump row
    for q in range(p):
        foreign = np.setdiff1d(np.arange(n), np.arange(q * rows,
                                                       (q + 1) * rows))
        idx[q, :20] = rng.choice(foreign, 20, replace=False)
    recv32 = rng.standard_normal((p, n_recv) + feat).astype(np.float32)
    own32 = rng.standard_normal((p, rows) + feat).astype(np.float32)
    tr, jr = _pair(recv32, dtype)
    to, jo = _pair(own32, dtype)
    offsets = np.arange(0, n, rows, dtype=np.int32)
    got = tops.unpack_scatter_set(tr, torch.as_tensor(idx), to,
                                  torch.as_tensor(offsets), out_len=out_len,
                                  copy_own=copy_own)
    assert got.shape == (p, out_len) + feat
    keep = np.r_[0:n, n + 1:out_len]                   # all but the dump row
    for q in range(p):
        args = (jr[q], jnp.asarray(idx[q]), jo[q], int(offsets[q]))
        kw = dict(out_len=out_len, copy_own=copy_own)
        for want in (jops.unpack_scatter_set(*args, **kw),
                     jref.unpack_scatter_set_ref(*args, **kw)):
            np.testing.assert_array_equal(_bits(got[q])[keep],
                                          _jbits(want)[keep])
    assert not got[:, n + 1:].any()


def _matrix(n=2048, r_nz=8, seed=4):
    kw = dict(locality_window=n // 16, long_range_frac=0.03, seed=seed)
    return (jmatrix.make_mesh_like_matrix(n, r_nz, **kw),
            tmatrix.make_mesh_like_matrix(n, r_nz, **kw))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def test_ellpack_spmv_single_matrix():
    jm, tm = _matrix(1024, 5)
    x = np.random.default_rng(0).standard_normal(jm.n).astype(np.float32)
    got = tops.ellpack_spmv(_t(tm.diag), _t(tm.vals), tm.cols, _t(x),
                            rows_per_block=128)
    want = jops.ellpack_spmv(jnp.asarray(jm.diag), jnp.asarray(jm.vals),
                             jm.cols, jnp.asarray(x), rows_per_block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), tmatrix.spmv_ref_np(tm, x), **TOL)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_ellpack_spmv_on_copy(p):
    jm, tm = _matrix()
    n, shard = jm.n, jm.n // p
    rng = np.random.default_rng(p)
    x_copy = rng.standard_normal((p, n + 1)).astype(np.float32)
    t_fn, t_args = tops.make_spmv_on_copy_sharded(tm.cols, p)
    j_fn, j_args = jops.make_spmv_on_copy_sharded(jm.cols, p)
    diag = tm.diag.reshape(p, shard)
    vals = tm.vals.reshape(p, shard, -1)
    got = t_fn(_t(diag), _t(vals), _t(x_copy), *map(_t, t_args))
    for q in range(p):
        want = j_fn(jnp.asarray(diag[q]), jnp.asarray(vals[q]),
                    jnp.asarray(x_copy[q]), *(a[q:q + 1] for a in j_args))
        np.testing.assert_allclose(got[q].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_ellpack_spmv_overlap_partials(p):
    jm, tm = _matrix()
    n, shard = jm.n, jm.n // p
    jp = jplan.build_comm_plan(jm.cols, n, p)
    tp = tplan.build_comm_plan(tm.cols, n, p)
    t_own, t_rem, t_args = tops.make_spmv_overlap_sharded(tp, tm.vals)
    j_own, j_rem, j_args = jops.make_spmv_overlap_sharded(jp, jm.vals)
    rng = np.random.default_rng(p)
    x_ext = rng.standard_normal((p, shard + 1)).astype(np.float32)
    x_ext[:, shard] = 0.0                     # the own partial's zero slot
    x_copy = rng.standard_normal((p, n + 2)).astype(np.float32)
    x_copy[:, n + 1] = 0.0                    # the foreign zero slot
    diag = tm.diag.reshape(p, shard)
    targs = tuple(map(_t, t_args))
    got_own = t_own(_t(diag), _t(x_ext), *targs[:3])
    got_rem = t_rem(_t(x_copy), *targs[3:])
    for q in range(p):
        jq = tuple(a[q:q + 1] for a in j_args)
        want_own = j_own(jnp.asarray(diag[q]), jnp.asarray(x_ext[q]),
                         *jq[:3])
        want_rem = j_rem(jnp.asarray(x_copy[q]), *jq[3:])
        np.testing.assert_allclose(got_own[q].numpy(), np.asarray(want_own),
                                   **TOL)
        np.testing.assert_allclose(got_rem[q].numpy(), np.asarray(want_rem),
                                   **TOL)


# --------------------------------------------------------------------------
# B5 accumulate_segments / B6 accumulate_into (push direction)
# --------------------------------------------------------------------------

ACC_DTYPES = {"f32": (torch.float32, jnp.float32, np.int32),
              "bf16": (torch.bfloat16, jnp.bfloat16, np.int16),
              "i32": (torch.int32, jnp.int32, np.int32)}


def _jax_pack_gather():
    """The reference's Pallas kernels module (``repro.kernels`` exports a
    function of the same name, so import the module by its path)."""
    import importlib
    return importlib.import_module("repro.kernels.pack_gather")


def _acc_inputs(dtype, feat, p=3, k=400, rows=37, seed=0):
    """Random contributions with -0.0, +0.0, NaN and ±inf (floats) or the
    integer extremes, heavy duplicates, and an ``init`` with -0.0/NaN."""
    rng = np.random.default_rng(seed)
    tdt, jdt, _ = ACC_DTYPES[dtype]
    idx = rng.integers(0, rows, (p, k)).astype(np.int32)
    idx[:, :12] = [0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 4]
    if dtype == "i32":
        vals = rng.integers(-1000, 1000, (p, k) + feat).astype(np.int32)
        vals.reshape(p, k, -1)[:, :3] = np.iinfo(np.int32).min
        init = rng.integers(-1000, 1000, (p, rows) + feat).astype(np.int32)
        return idx, vals, init, tdt, jdt
    vals = rng.standard_normal((p, k) + feat).astype(np.float32)
    vals.reshape(p, k, -1)[:, :12, 0] = [-0.0, -0.0, -0.0, -0.0, 0.0,
                                         np.nan, 1.0, np.inf, -np.inf,
                                         0.0, -0.0, -0.0]
    init = rng.standard_normal((p, rows) + feat).astype(np.float32)
    init.reshape(p, rows, -1)[:, :4, 0] = [-0.0, 0.0, np.nan, -0.0]
    return idx, vals, init, tdt, jdt


def _assert_same_bits(got: torch.Tensor, want, dtype: str):
    """Bit for bit; a NaN's payload bits are the platform's own, so NaN is
    compared by position."""
    bits = ACC_DTYPES[dtype][2]
    want = np.asarray(want)
    if dtype == "i32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(got.float().isnan().numpy(), nan)
    np.testing.assert_array_equal(
        got.view(torch.int16 if dtype == "bf16" else torch.int32)
        .numpy()[~nan], want.view(bits)[~nan])


@pytest.mark.parametrize("feat", [(), (3,), (1024,)])
@pytest.mark.parametrize("reduce", ["add", "set", "max"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i32"])
def test_accumulate_bit_exact(feat, reduce, dtype):
    """Both plain versions against the reference's Pallas kernels (interpret
    mode) and its jnp oracles, one rank at a time."""
    jpg = _jax_pack_gather()
    k = 40 if feat == (1024,) else 400
    idx, vals, init, tdt, jdt = _acc_inputs(dtype, feat, k=k)
    rows = init.shape[1]
    tv, ti = torch.as_tensor(vals).to(tdt), torch.as_tensor(init).to(tdt)
    tidx = torch.as_tensor(idx)
    seg = tops.accumulate_segments(tv, tidx, out_len=rows + 2, reduce=reduce)
    into = tops.accumulate_into(ti, tv, tidx, reduce=reduce)
    assert seg.shape == (3, rows + 2) + feat and into.shape == ti.shape
    for q in range(3):
        jv, ji = jnp.asarray(vals[q]).astype(jdt), jnp.asarray(init[q]).astype(
            jdt)
        jidx = jnp.asarray(idx[q])
        for want in (jpg.accumulate_segments(jv, jidx, out_len=rows + 2,
                                             reduce=reduce, interpret=True),
                     jref.accumulate_segments_ref(jv, jidx, out_len=rows + 2,
                                                  reduce=reduce)):
            _assert_same_bits(seg[q], want, dtype)
        for want in (jpg.accumulate_into(ji, jv, jidx, reduce=reduce,
                                         interpret=True),
                     jref.accumulate_into_ref(ji, jv, jidx, reduce=reduce)):
            _assert_same_bits(into[q], want, dtype)


def test_accumulate_adds_in_lane_order():
    """On the CPU the plain add folds each row's lanes in ascending k, one
    float32 rounding each: equal to a sequential loop, bit for bit, where a
    pairwise or reordered sum would differ."""
    rng = np.random.default_rng(11)
    p, k, rows = 2, 20000, 50
    idx = rng.integers(0, rows, (p, k)).astype(np.int32)
    vals = (rng.standard_normal((p, k))
            * 10.0 ** rng.integers(-3, 4, (p, k))).astype(np.float32)
    got = tops.accumulate_segments(torch.as_tensor(vals),
                                   torch.as_tensor(idx), out_len=rows)
    want = np.zeros((p, rows), np.float32)
    for q in range(p):
        for i, v in zip(idx[q], vals[q]):
            want[q, i] = np.float32(want[q, i] + v)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    pairwise = np.zeros((p, rows), np.float32)
    for q in range(p):
        for t in range(rows):
            pairwise[q, t] = vals[q][idx[q] == t].sum()
    assert not np.array_equal(pairwise, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32])
def test_ordered_add_is_the_sequential_index_add(dtype):
    """``ordered_add`` (the card's plain bfloat16/float16 fold) equals the
    CPU's sequential 1-D ``index_add_`` bit for bit: ascending order, one
    rounding per add, targets with 0 to ~500 contributions."""
    from repro_torch.kernels import ref as kref
    rng = np.random.default_rng(12)
    n, k = 64, 6000
    index = torch.as_tensor(np.concatenate([
        rng.integers(0, n // 2, k - 500), np.full(500, n - 1)]))
    index = index[torch.as_tensor(rng.permutation(k))]
    src = torch.as_tensor(rng.standard_normal(k) * 1e2).to(dtype)
    init = torch.as_tensor(rng.standard_normal(n) * 1e2).to(dtype)
    got, want = init.clone(), init.clone()
    kref.ordered_add(got, index, src)
    want.index_add_(0, index, src)
    assert torch.equal(got, want)
    if dtype == torch.bfloat16:
        once = (init.float().index_add_(0, index, src.float())).to(dtype)
        assert not torch.equal(got, once)   # one rounding at the end differs
    kref.ordered_add(got, index[:0], src[:0])
    assert torch.equal(got, want)


def _np_max(a, b):
    """XLA's max: a NaN propagates, +0.0 beats -0.0."""
    out = np.where(a > b, a, b)
    out = np.where((a == b) & np.signbit(a), b, out)
    return np.where(np.isnan(a) | np.isnan(b), np.nan, out).astype(a.dtype)


def _fold_through_table(table, vals, init, reduce):
    """What the CUDA kernel computes from a ``SegmentTable``, in numpy:
    each live row folds its lanes in table order, then (add) one +0.0 where
    a padding lane was left out."""
    perm, ptr = table.perm.numpy(), table.seg_ptr.numpy()
    p = vals.shape[0]
    out = init[:, :table.live_len].copy()
    for q in range(p):
        for t in range(table.live_len):
            acc = out[q, t]
            for j in range(ptr[q, t], ptr[q, t + 1]):
                v = vals[q, perm[q, j]]
                acc = np.float32(acc + v) if reduce == "add" else _np_max(
                    acc, v)
            if (reduce == "add" and table.pad_rows is not None
                    and table.pad_rows[q, t]):
                acc = np.float32(acc + np.float32(0.0))
            out[q, t] = acc
    return out


@pytest.mark.parametrize("reduce", ["add", "max"])
def test_segment_table_fold_bit_exact(reduce):
    """The kernels' design, checked on the CPU: folding through a table
    that leaves out the dump rows and the padding lanes gives the plain
    version's bits on every live row — including row 0, where -0.0
    contributions meet the identity padding (+0.0 under add)."""
    rng = np.random.default_rng(5)
    p, k, live = 3, 300, 20
    out_len = live + 1                       # one dump row
    idx = rng.integers(0, out_len, (p, k)).astype(np.int32)
    pad = rng.random((p, k)) < 0.3
    idx[pad] = 0                             # padding lanes pile onto row 0
    ident = 0.0 if reduce == "add" else -np.inf
    vals = rng.standard_normal((p, k)).astype(np.float32)
    vals[pad] = ident
    vals[(idx == 0) & ~pad] = -0.0           # row 0's real lanes: -0.0
    init = rng.standard_normal((p, out_len)).astype(np.float32)
    init[:, 0] = -0.0
    table = tops.segment_table(torch.as_tensor(idx), out_len=out_len,
                               live_len=live, pad=torch.as_tensor(pad))
    # the table: a stable sort by target, dump and padding lanes last
    key = np.where((idx >= live) | pad, live, idx)
    for q in range(p):
        order = np.argsort(key[q], kind="stable")
        np.testing.assert_array_equal(table.perm[q].numpy(), order)
        np.testing.assert_array_equal(
            table.seg_ptr[q].numpy(),
            np.r_[0, np.cumsum(np.bincount(key[q], minlength=live)[:live])])
    np.testing.assert_array_equal(table.pad_rows.numpy()[:, 0], 1)
    assert not table.pad_rows.numpy()[:, 1:].any()
    assert table.longest() == max(
        int(np.bincount(key[q], minlength=live)[:live].max()) for q in range(p))
    jpg = _jax_pack_gather()
    want_seg = tops.accumulate_segments(torch.as_tensor(vals),
                                        torch.as_tensor(idx),
                                        out_len=out_len, reduce=reduce)
    want_into = tops.accumulate_into(torch.as_tensor(init),
                                     torch.as_tensor(vals),
                                     torch.as_tensor(idx), reduce=reduce)
    start = np.full((p, out_len), ident, np.float32)
    got_seg = _fold_through_table(table, vals, start, reduce)
    got_into = _fold_through_table(table, vals, init, reduce)
    for got, want in ((got_seg, want_seg), (got_into, want_into)):
        np.testing.assert_array_equal(
            got.view(np.int32), want[:, :live].numpy().view(np.int32))
    for q in range(p):
        jwant = jpg.accumulate_into(jnp.asarray(init[q]), jnp.asarray(vals[q]),
                                    jnp.asarray(idx[q]), reduce=reduce,
                                    interpret=True)
        np.testing.assert_array_equal(got_into[q].view(np.int32),
                                      np.asarray(jwant)[:live].view(np.int32))
    if reduce == "add":
        # row 0 summed -0.0s from a -0.0 start: the padding's +0.0 decides
        assert not np.signbit(got_into[:, 0]).any()
        no_pad = _fold_through_table(
            tops.segment_table(torch.as_tensor(np.where(pad, live, idx)),
                               out_len=out_len, live_len=live),
            vals, init, reduce)
        assert np.signbit(no_pad[:, 0]).all()
