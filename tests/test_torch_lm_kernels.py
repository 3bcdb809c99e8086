"""B8 (decode attention) and B9 (selective scan): the port's plain versions
and ``ops`` wrappers on CPU tensors against the JAX Pallas kernels in
interpret mode and the JAX oracles.

Same numpy inputs on both sides, on the parametrisations of
``tests/test_kernels.py``.  Tolerance rtol/atol 2e-4, the reference's own
for these kernels: both sum in float32 in another order than XLA.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-4, atol=2e-4)
FNS = {"plain": tref.decode_attention_ref, "wrapper": tops.decode_attention}
SCANS = {"plain": tref.selective_scan_ref, "wrapper": tops.selective_scan}


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _attn_inputs(b, h, hkv, d, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    return q, k, v, lengths


def _port(fn, *arrays):
    out = fn(*(torch.from_numpy(a) for a in arrays))
    return out.numpy()


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("b,h,hkv,d,s,chunk", [
    (2, 8, 4, 32, 1024, 256), (1, 4, 4, 64, 512, 512), (3, 6, 2, 16, 768, 128),
])
def test_decode_attention_matches_jax(fn, b, h, hkv, d, s, chunk):
    q, k, v, lengths = _attn_inputs(b, h, hkv, d, s, seed=s + h)
    got = _port(FNS[fn], q, k, v, lengths)
    kernel = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        kv_chunk=chunk))
    np.testing.assert_allclose(got, kernel, **TOL)
    # the reference test's oracle: each lane's valid prefix, dense attention
    oracle = np.stack([np.asarray(jref.decode_attention_ref(
        jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1, :lengths[i]]),
        jnp.asarray(v[i:i + 1, :lengths[i]])))[0] for i in range(b)])
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("fn", sorted(FNS))
def test_decode_attention_length_zero_matches_jax(fn):
    """Length 0 (the model never passes it): every slot masked alike, so
    the JAX kernel and the port give the mean of V over all S slots."""
    q, k, v, _ = _attn_inputs(2, 4, 2, 16, 256, seed=7)
    lengths = np.array([0, 100], np.int32)
    got = _port(FNS[fn], q, k, v, lengths)
    kernel = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        kv_chunk=128))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got[0], np.repeat(v[0].mean(0), 2, axis=0),
                               **TOL)


def _scan_inputs(b, l, di, st, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, di)) * 0.3).astype(np.float32)
    z = rng.standard_normal((b, l, di))
    dt = np.log1p(np.exp(z)).astype(np.float32)          # softplus
    bm = (rng.standard_normal((b, l, st)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, st)) * 0.5).astype(np.float32)
    a = (-np.exp(rng.standard_normal((di, st)) * 0.3)).astype(np.float32)
    return x, dt, bm, cm, a


@pytest.mark.parametrize("fn", sorted(SCANS))
@pytest.mark.parametrize("b,l,di,st,tile,chunk", [
    (2, 128, 16, 4, 8, 64), (1, 256, 32, 8, 32, 256), (2, 64, 8, 16, 8, 32),
])
def test_selective_scan_matches_jax(fn, b, l, di, st, tile, chunk):
    args = _scan_inputs(b, l, di, st, seed=l + di)
    got = _port(SCANS[fn], *args)
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jops.selective_scan(*jargs, tile_di=tile,
                                            chunk_l=chunk))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.selective_scan_ref(*jargs)), **TOL)


def test_wrappers_refuse_shapes_they_do_not_take():
    q, k, v, lengths = (torch.from_numpy(a) for a in
                        _attn_inputs(2, 6, 4, 16, 32, seed=1))
    with pytest.raises(ValueError):          # H not a multiple of Hkv
        tops.decode_attention(q, k, v, lengths)
    x, dt, bm, cm, a = (torch.from_numpy(t) for t in
                        _scan_inputs(1, 8, 16, 4, seed=2))
    with pytest.raises(ValueError):          # L = 0
        tops.selective_scan(x[:, :0], dt[:, :0], bm[:, :0], cm[:, :0], a)
    with pytest.raises(ValueError):          # a is not (di, st)
        tops.selective_scan(x, dt, bm, cm, a.T)
