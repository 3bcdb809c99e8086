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
