"""The port's push-direction planners against the JAX reference.

``CommPlan.transpose`` / ``derive_scatter_plan``, ``pattern_cols`` and
``transpose_counts`` must build every array of the reference bit for bit:
on EllPack matrices and on random patterns with ``m != n``, over several
rank counts, blocksizes (blockwise tables) and topologies.  Also
``convert.from_reference`` of a ``ScatterPlan``, the transpose involution,
and ``spmv_t_ref_np``.
"""
import dataclasses

import numpy as np
import pytest

from repro.comm import plan as jplan
from repro.core import matrix as jmatrix
from repro_torch import convert
from repro_torch.comm import plan as tplan
from repro_torch.core import matrix as tmatrix


def assert_same_fields(a, b):
    """Every dataclass field of ``b`` equal in ``a`` (arrays exactly)."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            assert_same_fields(va, vb)
        elif isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, (f.name, va, vb)


def _ellpack(n, r_nz, seed):
    m = jmatrix.make_mesh_like_matrix(n, r_nz, locality_window=n // 16,
                                      long_range_frac=0.03, seed=seed)
    return m.cols, n


def _random(n, m, r, seed):
    """Uniform random targets, ``m`` accessor rows into a length-n vector."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, (m, r)).astype(np.int32), n


PATTERNS = {  # name: (cols, n)
    "ellpack": lambda: _ellpack(2048, 8, 3),
    "random_square": lambda: _random(512, 512, 5, 0),
    "random_m_lt_n": lambda: _random(512, 128, 3, 1),
    "random_m_gt_n": lambda: _random(256, 1024, 2, 2),
}


def _plans(cols, n, p, blocksize, spn):
    jtop, ttop = jplan.Topology(p, spn), tplan.Topology(p, spn)
    jp = jplan.build_comm_plan(cols, n, p, blocksize=blocksize,
                               topology=jtop)
    tp = tplan.build_comm_plan(cols, n, p, blocksize=blocksize,
                               topology=ttop)
    return jp, tp


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("p,blocksize,spn", [
    (2, None, 2), (4, 16, 2), (8, 8, 4), (8, 32, 8), (4, 1, 1)])
def test_scatter_plan_equal(name, p, blocksize, spn):
    cols, n = PATTERNS[name]()
    jp, tp = _plans(cols, n, p, blocksize, spn)
    js, ts = jp.transpose(), tp.transpose()
    assert isinstance(ts, tplan.ScatterPlan) and ts.base is tp
    assert_same_fields(ts, js)
    # the derived-from-the-plan column table is the pattern itself
    np.testing.assert_array_equal(tplan.pattern_cols(tp), cols)
    np.testing.assert_array_equal(tplan.pattern_cols(tp),
                                  jplan.pattern_cols(jp))
    assert_same_fields(tplan.transpose_counts(tp), jplan.transpose_counts(jp))
    # the involution returns the very base plan
    assert ts.transpose() is tp
    # the facts a scatter engine reads off the plan
    for attr in ("n", "p", "m", "r", "shard_size", "blocksize", "s_max",
                 "b_max", "blocks_per_shard", "rows_per_shard", "dest_len"):
        assert getattr(ts, attr) == getattr(js, attr), attr


@pytest.mark.parametrize("name", PATTERNS)
def test_scatter_plan_carried_across(name):
    cols, n = PATTERNS[name]()
    jp, tp = _plans(cols, n, 4, 16, 2)
    matrix, ts = convert.from_reference(None, jp.transpose())
    assert matrix is None
    assert isinstance(ts, tplan.ScatterPlan)
    assert isinstance(ts.base, tplan.CommPlan)
    assert_same_fields(ts, tp.transpose())
    # a CommPlan still comes across as one
    _, base = convert.from_reference(None, jp)
    assert_same_fields(base, tp)


def test_scatter_plan_invariants():
    """Each contribution lands in exactly one of the own-accumulate and the
    two message packs; the winner mask picks one slot per touched target."""
    cols, n = _random(512, 512, 5, 0)
    p = 8
    _, tp = _plans(cols, n, p, 16, 4)
    s = tp.transpose()
    shard = s.shard_size
    own = s.own_tgt_idx != shard
    assert ((s.cond_msg_idx == p * s.s_max) == own).all()
    assert ((s.blk_msg_idx == p * s.b_max * s.blocksize) == own).all()
    touched = np.zeros(n, np.int8)
    touched[cols.ravel()] = 1
    np.testing.assert_array_equal(s.touched.reshape(-1), touched)
    assert int(s.win_mask.sum()) == int(touched.sum())
    winners = cols.ravel()[s.win_mask.ravel() == 1]
    np.testing.assert_array_equal(np.sort(winners), np.flatnonzero(touched))


@pytest.mark.parametrize("seed", [0, 1])
def test_spmv_t_ref_np_equal(seed):
    kw = dict(locality_window=64, long_range_frac=0.05, seed=seed)
    jm = jmatrix.make_mesh_like_matrix(1024, 6, **kw)
    tm = tmatrix.make_mesh_like_matrix(1024, 6, **kw)
    x = np.random.default_rng(seed).standard_normal(1024).astype(np.float32)
    got = tmatrix.spmv_t_ref_np(tm, x)
    np.testing.assert_array_equal(got, jmatrix.spmv_t_ref_np(jm, x))
    dense = np.diag(tm.diag.astype(np.float64))
    np.add.at(dense, (np.repeat(np.arange(1024), 6), tm.cols.ravel()),
              tm.vals.ravel())
    np.testing.assert_allclose(got, dense.T @ x, rtol=1e-4, atol=1e-4)
