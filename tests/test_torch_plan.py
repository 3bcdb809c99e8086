"""The port's host planners against the JAX reference: every array equal.

Covers the matrix generator, ``AccessPattern.from_ellpack``,
``build_comm_plan`` / ``attach_destination`` / ``blockwise_block_counts``
over several blocksizes, topologies and destinations, the SpMV window
planners, ``convert.from_reference``, the port's device default, and its
import hygiene (no JAX, no ``repro``).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.comm import pattern as jpattern
from repro.comm import plan as jplan
from repro.core import matrix as jmatrix
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.comm import pattern as tpattern
from repro_torch.comm import plan as tplan
from repro_torch.comm.communicator import LoopbackComm
from repro_torch.core import matrix as tmatrix
from repro_torch.kernels import ops as tops


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


MATRICES = [  # n, r_nz, locality_window, long_range_frac, seed
    (1024, 4, 64, 0.0, 0),
    (2048, 8, 200, 0.02, 1),
    (4096, 8, None, 0.05, 2),
]


def _matrices(n, r_nz, w, lr, seed):
    kw = dict(locality_window=w, long_range_frac=lr, seed=seed)
    return (jmatrix.make_mesh_like_matrix(n, r_nz, **kw),
            tmatrix.make_mesh_like_matrix(n, r_nz, **kw))


@pytest.mark.parametrize("spec", MATRICES)
def test_matrix_and_pattern_equal(spec):
    jm, tm = _matrices(*spec)
    assert_same_fields(tm, jm)
    x = np.random.default_rng(0).standard_normal(jm.n).astype(np.float32)
    np.testing.assert_array_equal(tmatrix.spmv_ref_np(tm, x),
                                  jmatrix.spmv_ref_np(jm, x))
    assert_same_fields(tpattern.AccessPattern.from_ellpack(tm),
                       jpattern.AccessPattern.from_ellpack(jm))


def _ellpack_destination(mod, cols, p):
    return mod.Destination.from_slots(
        ellpack=cols.reshape(p, cols.shape[0] // p, -1))


def _halo_destination(mod, cols, p, seed=0):
    """Mixed slots: owned, foreign (from the pattern) and ZERO."""
    rng = np.random.default_rng(seed)
    rows = cols.shape[0] // p
    idx = np.stack([rng.choice(cols[q * rows:(q + 1) * rows].ravel(), 37)
                    for q in range(p)]).astype(np.int32)
    idx[:, ::5] = -1
    return mod.Destination.from_slots(a=idx[:, :20], b=idx[:, 20:])


@pytest.mark.parametrize("spec", MATRICES)
@pytest.mark.parametrize("p,blocksize,spn", [
    (2, None, None), (4, 64, 2), (8, 32, 4), (8, 128, 8), (4, 1, 1)])
@pytest.mark.parametrize("dest", [None, "ellpack", "halo"])
def test_build_comm_plan_equal(spec, p, blocksize, spn, dest):
    jm, tm = _matrices(*spec)
    kw = dict(blocksize=blocksize)
    jkw, tkw = dict(kw), dict(kw)
    if spn is not None:
        jkw["topology"] = jplan.Topology(p, spn)
        tkw["topology"] = tplan.Topology(p, spn)
    if dest is not None:
        make = {"ellpack": _ellpack_destination,
                "halo": _halo_destination}[dest]
        jkw["destination"] = make(jpattern, jm.cols, p)
        tkw["destination"] = make(tpattern, tm.cols, p)
    jp = jplan.build_comm_plan(jm.cols, jm.n, p, **jkw)
    tp = tplan.build_comm_plan(tm.cols, tm.n, p, **tkw)
    assert_same_fields(tp, jp)
    # the reference's plan carried across equals the port's own build
    _, conv = convert.from_reference(jm, jp)
    assert_same_fields(conv, tp)


@pytest.mark.parametrize("p", [2, 8])
def test_attach_destination_equal_and_rejects_unplanned(p):
    jm, tm = _matrices(*MATRICES[1])
    jp = jplan.build_comm_plan(jm.cols, jm.n, p, blocksize=64)
    tp = tplan.build_comm_plan(tm.cols, tm.n, p, blocksize=64)
    jd = _halo_destination(jpattern, jm.cols, p, seed=3)
    td = _halo_destination(tpattern, tm.cols, p, seed=3)
    assert_same_fields(tplan.attach_destination(tp, td),
                       jplan.attach_destination(jp, jd))
    # a foreign slot the pattern never gathers is refused
    rows = tm.n // p
    needed = set(tm.cols[:rows].ravel().tolist())
    missing = next(g for g in range(rows, tm.n) if g not in needed)
    bad = td.indices.copy()
    bad[0, 0] = missing
    with pytest.raises(ValueError, match="never"):
        tplan.attach_destination(tp, tpattern.Destination(
            names=td.names, shapes=td.shapes, indices=bad))


@pytest.mark.parametrize("blocksize", [1, 16, 64, 256])
@pytest.mark.parametrize("spn", [1, 2, 8])
def test_blockwise_block_counts_equal(blocksize, spn):
    jm, tm = _matrices(*MATRICES[2])
    p = 8
    got = tplan.blockwise_block_counts(tm.cols, tm.n, p, blocksize,
                                       tplan.Topology(p, spn))
    want = jplan.blockwise_block_counts(jm.cols, jm.n, p, blocksize,
                                        jplan.Topology(p, spn))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("spec", MATRICES)
@pytest.mark.parametrize("rows_per_block", [64, 256])
def test_plan_spmv_windows_equal(spec, rows_per_block):
    jm, tm = _matrices(*spec)
    got = tops.plan_spmv_windows(tm.cols, rows_per_block=rows_per_block)
    want = jops.plan_spmv_windows(jm.cols, rows_per_block=rows_per_block)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("spec", MATRICES)
@pytest.mark.parametrize("p", [2, 4, 8])
def test_spmv_kernel_planners_equal(spec, p):
    jm, tm = _matrices(*spec)
    _, tk = tops.make_spmv_on_copy_sharded(tm.cols, p)
    _, jk = jops.make_spmv_on_copy_sharded(jm.cols, p)
    for g, w in zip(tk, jk, strict=True):
        np.testing.assert_array_equal(g, w)
    jp = jplan.build_comm_plan(jm.cols, jm.n, p)
    tp = tplan.build_comm_plan(tm.cols, tm.n, p)
    *_, tk = tops.make_spmv_overlap_sharded(tp, tm.vals)
    *_, jk = jops.make_spmv_overlap_sharded(jp, jm.vals)
    for g, w in zip(tk, jk, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert LoopbackComm(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LoopbackComm(2)
    assert LoopbackComm(2, device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 18, names\n"
        "for mod in ('comm.schedule', 'core.heat2d', 'core.solvers',\n"
        "            'kernels.stencil2d'):\n"
        "    assert 'repro_torch.' + mod in names, mod\n"
        "assert not bad, bad\n"
        "print('CLEAN', len(names))\n")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("CLEAN")
