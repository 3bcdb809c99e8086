"""B7, the 5-point stencil, and the stencil pattern: the port against the
JAX reference on the CPU.

The plain ``stencil2d_ref`` and the kernel wrapper on CPU tensors must equal
bit for bit the reference's *jitted* ``stencil2d_ref`` and its Pallas
kernel in interpret mode (``kops.stencil2d``): both compute ``mid +
coef·lap`` as one fused multiply-add, which the port reproduces exactly
(``kernels.ref.fma_f32``).  The reference's eager ``stencil2d_ref`` rounds
the product and the sum on their own; the port follows the jitted rounding,
the one ``Heat2D.run`` uses.  ``AccessPattern.from_stencil5`` and its base
plan must equal the reference's array for array.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.comm import pattern as jpattern
from repro.comm import plan as jplan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.comm import pattern as tpattern
from repro_torch.comm import plan as tplan
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(64, 128), (40, 56), (16, 16), (129, 65), (3, 40), (40, 3)]
COEFS = [0.1, 0.13]


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


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


def _field(shape, seed=2, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("coef", COEFS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_stencil_equals_jitted_reference(shape, coef):
    x = _field(shape)
    want = jax.jit(lambda a: jref.stencil2d_ref(a, coef))(x)
    got = tref.stencil2d_ref(torch.from_numpy(x), coef)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_stencil_wrapper_equals_pallas_interpret(shape):
    x = _field(shape, seed=3)
    want = jops.stencil2d(jnp.asarray(x), coef=0.1, interpret=True)
    got = tops.stencil2d(torch.from_numpy(x), coef=0.1)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_eager_reference_rounds_differently():
    """The reason the port follows the jitted rounding: the reference's
    eager stencil disagrees with its own jitted one (by ~1e-7)."""
    x = _field((64, 128))
    eager = np.asarray(jref.stencil2d_ref(jnp.asarray(x), 0.1))
    jitted = np.asarray(jax.jit(lambda a: jref.stencil2d_ref(a, 0.1))(x))
    assert not np.array_equal(eager, jitted)
    np.testing.assert_allclose(eager, jitted, rtol=0, atol=1e-6)
    got = tref.stencil2d_ref(torch.from_numpy(x), 0.1).numpy()
    np.testing.assert_array_equal(got, jitted)


def test_fma_rounds_once_at_a_double_rounding_tie():
    """``a*b + c`` whose float64 sum lands exactly halfway between two
    float32 values: a second rounding would go to the even neighbour, one
    fused rounding goes to the exact sum's side."""
    a = torch.tensor([2.0 ** -12 * (1 + 2.0 ** -23)])
    b = torch.tensor([2.0 ** -12 * (1 - 2.0 ** -23)])
    c = torch.tensor([1 + 2.0 ** -23])
    assert (a.double() * b.double() + c.double()).float().item() \
        == 1 + 2.0 ** -22                       # rounded twice: wrong
    assert tref.fma_f32(a, b, c).item() == 1 + 2.0 ** -23
    xla = jax.jit(lambda u, v, w: u * v + w)(a.numpy(), b.numpy(), c.numpy())
    assert float(np.asarray(xla)[0]) == 1 + 2.0 ** -23


def test_fma_matches_xla_on_random_operands():
    rng = np.random.default_rng(5)
    a = rng.standard_normal(4096).astype(np.float32)
    b = (rng.standard_normal(4096) * 1e3).astype(np.float32)
    c = rng.standard_normal(4096).astype(np.float32)
    want = jax.jit(lambda u, v, w: u * v + w)(a, b, c)
    got = tref.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("shape", [(3, 40), (40, 3), (2, 9), (1, 1),
                                   (5, 2)])
def test_thin_slices_are_all_boundary_where_they_must_be(shape):
    x = torch.from_numpy(_field(shape, seed=4))
    got = tops.stencil2d(x, coef=0.25)
    if min(shape) < 3:
        assert torch.equal(got, x)
    want = jax.jit(lambda a: jref.stencil2d_ref(a, 0.25))(x.numpy())
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_batched_and_strided_inputs():
    """One call over a rank batch, and the ring-strip views Heat2D passes,
    equal slice-by-slice steps on contiguous copies."""
    padded = torch.from_numpy(_field((8, 18, 34), seed=6))
    whole = tops.stencil2d(padded, coef=0.1)
    for q in range(8):
        np.testing.assert_array_equal(
            whole[q].numpy(), tref.stencil2d_ref(padded[q], 0.1).numpy())
    for strip in (padded[:, 0:3, :], padded[:, -3:, :], padded[:, :, 0:3],
                  padded[:, :, -3:]):
        assert not strip.is_contiguous()
        got = tops.stencil2d(strip, coef=0.1)
        assert got.shape == strip.shape and got.is_contiguous()
        assert torch.equal(got, tref.stencil2d_ref(strip.contiguous(), 0.1))


@pytest.mark.parametrize("grid", [(32, 64, 2, 4), (16, 16, 2, 2),
                                  (24, 40, 1, 4)])
def test_stencil_pattern_and_plan_equal_reference(grid):
    big_m, big_n, mprocs, nprocs = grid
    jp = jpattern.AccessPattern.from_stencil5(big_m, big_n, mprocs, nprocs)
    tp = tpattern.AccessPattern.from_stencil5(big_m, big_n, mprocs, nprocs)
    assert tp.n == jp.n and tp.indices.dtype == np.int32
    np.testing.assert_array_equal(tp.indices, jp.indices)
    p = mprocs * nprocs
    for blocksize in (None, (big_m * big_n // p) // 4):
        topo_j = jplan.Topology(p, max(1, p // 2))
        topo_t = tplan.Topology(p, max(1, p // 2))
        jb = jplan.build_comm_plan(jp.indices, jp.n, p, blocksize=blocksize,
                                   topology=topo_j)
        tb = tplan.build_comm_plan(tp.indices, tp.n, p, blocksize=blocksize,
                                   topology=topo_t)
        assert_same_fields(tb, jb)
