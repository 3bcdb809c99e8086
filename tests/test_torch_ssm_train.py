"""Training the ssm and hybrid families on the CPU: the selective scan's
backward against the JAX reference.

``kref.selective_scan_bwd_ref`` (the plain backward, one step after
another) against ``jax.vjp`` of the reference oracle
``repro.kernels.ref.selective_scan_ref`` and against ``torch.autograd``
through the port's plain scan, at 1e-5: the same float32 operations summed
in other orders.  A torch model of the card's backward kernel
(``csrc/selective_scan.cu``: checkpoints every 128 steps, the segments
last first, sub-checkpoints every 8 steps, the reverse walk, dB and dC
summed per channel block into partials reduced in block order, dA per
lane) against the plain backward at 2e-4 of each gradient's largest
element, the card's tolerance (the model decays by ``exp2`` of a
pre-scaled rate, as the kernel does).  ``ssm_fwd``'s gradients against
``jax.grad`` of the reference ``ssm_fwd`` (its chunked associative scan) at
chunk 256 and 4, at 1e-4, as ``tests/test_torch_train.py`` holds
gradients; and a falcon-mamba checkpoint across the two packages.
Inputs are numpy arrays made from a seed, handed to both sides.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import registry as jregistry
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro.models.transformer import Model as JModel
from repro_torch.checkpoint import manager as tckpt
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import selective_scan as b9
from repro_torch.kernels.selective_scan import (CKPT_STEPS, bwd_blocks,
                                                lanes_per_channel)
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

REF_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CARD_TOL = 2e-4            # of each gradient's largest element
KEY = jax.random.PRNGKey(0)
SHAPES = [(2, 129, 16, 16), (1, 127, 8, 16), (2, 65, 8, 5), (1, 40, 8, 32),
          (1, 33, 8, 1)]


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _scan_inputs(b, l, di, st, seed):
    """The scan's inputs and a cotangent, as the kernel tests draw them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, di)) * 0.3).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, di)))).astype(np.float32)
    bm = (rng.standard_normal((b, l, st)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, st)) * 0.5).astype(np.float32)
    a = (-np.exp(rng.standard_normal((di, st)) * 0.3)).astype(np.float32)
    dy = rng.standard_normal((b, l, di)).astype(np.float32)
    return x, dt, bm, cm, a, dy


def _rel_close(got, want, tol):
    """Each gradient within ``tol`` of its largest element."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), (err, w.shape)


@pytest.mark.parametrize("b,l,di,st", SHAPES)
def test_plain_backward_matches_jax_vjp_and_autograd(b, l, di, st):
    """L off the chunk, B 1 and 2, st 1 to 32."""
    *args, dy = _scan_inputs(b, l, di, st, seed=l * st)
    got = kref.selective_scan_bwd_ref(*(torch.from_numpy(t)
                                        for t in (*args, dy)))
    _, vjp = jax.vjp(jref.selective_scan_ref, *map(jnp.asarray, args))
    for g, w in zip(got, vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **REF_TOL)
    ins = [torch.from_numpy(t).requires_grad_(True) for t in args]
    want = torch.autograd.grad(kref.selective_scan_ref(*ins), ins,
                               torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **REF_TOL)


def test_ops_scan_in_grad_mode_is_the_plain_backward_on_the_cpu():
    """``ops.selective_scan`` with an input that requires grad: the plain
    forward, and the plain backward's gradient for all five inputs, bit
    for bit; without grad mode the serving path gives the same ``y``."""
    *args, dy = (torch.from_numpy(t) for t in _scan_inputs(2, 37, 6, 5, 4))
    ins = [t.clone().requires_grad_(True) for t in args]
    y = tops.selective_scan(*ins)
    assert y.grad_fn is not None
    grads = torch.autograd.grad(y, ins, dy)
    want = kref.selective_scan_bwd_ref(*args, dy)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    with torch.no_grad():
        assert torch.equal(tops.selective_scan(*ins), y.detach())


def test_backward_wrapper_refuses_shapes_it_does_not_take():
    """A cotangent of another shape than ``x`` raises before any launch."""
    *args, dy = (torch.from_numpy(t) for t in _scan_inputs(1, 9, 4, 3, 2))
    with pytest.raises(ValueError):
        b9.selective_scan_bwd(*args, None, dy[:, :-1])
    with pytest.raises(ValueError):                 # a is not (di, st)
        b9.selective_scan_bwd(*args[:4], args[4].T, None, dy)


# -- a model of the card's backward kernel --

def _lane_sum(parts):
    """The transposed butterfly's sum over a channel's lanes (tpc, ...):
    lanes j and j + m meet first, m halving each round."""
    while parts.shape[0] > 1:
        m = parts.shape[0] // 2
        parts = parts[:m] + parts[m:]
    return parts[0]


def _scan_bwd_model(x, dt, bm, cm, a, dy, sub=8):
    """csrc/selective_scan.cu's backward in float32 torch.  The
    checkpointing forward writes h entering every CKPT_STEPS-th step; the
    backward takes the segments last first: from the segment's checkpoint
    forward, h entering every ``sub``-th step (pass 1); then the
    sub-chunks last first, each rebuilt from its sub-checkpoint with its
    decays, and walked in reverse with ``q = exp(dt[t+1] a) g[t+1]``
    carried across sub-chunks and segments.  States are padded to the
    lanes' width (a = B = C = 0), channels to whole blocks and steps to
    whole segments (zeros: dt = 0 keeps h); a sub-chunk wholly past L is
    skipped.  dx and ddt: each lane's 4 states summed in order, times dt
    (dx), then the lanes' butterfly; dB and dC: each block's channels
    summed into a partial (B, nblk, L, st), the partials summed in block
    order; dA summed per lane over its steps, then over the lanes."""
    bsz, l, di = x.shape
    st = bm.shape[2]
    tpc = lanes_per_channel(st)
    w, kc, nblk = 4 * tpc, 128 // tpc, bwd_blocks(di, st)
    dip, nseg = nblk * kc, -(-l // CKPT_STEPS)
    lp = nseg * CKPT_STEPS
    pad_bc = lambda t: torch.nn.functional.pad(  # noqa: E731
        t, (0, w - st, 0, lp - l))
    pad_x = lambda t: torch.nn.functional.pad(  # noqa: E731
        t, (0, dip - di, 0, lp - l))
    bm, cm = pad_bc(bm), pad_bc(cm)
    x, dt, dy = pad_x(x), pad_x(dt), pad_x(dy)
    av = torch.nn.functional.pad(a, (0, w - st, 0, dip - di))
    a2 = av * math.log2(math.e)

    def decay(t):
        return torch.exp2(dt[:, t, :, None] * a2)

    def step(h, t, da):
        return da * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]

    h, hck = torch.zeros((bsz, dip, w)), []
    for t in range(lp):
        if t % CKPT_STEPS == 0:
            hck.append(h)
        h = step(h, t, decay(t))
    dx, ddt = torch.zeros((bsz, lp, dip)), torch.zeros((bsz, lp, dip))
    part = torch.zeros((2, bsz, nblk, lp, w))
    q, dacc = torch.zeros((bsz, dip, w)), torch.zeros((bsz, dip, w))

    def lanes(v):                             # (B, dip, w) -> (B, dip)
        return _lane_sum(v.reshape(bsz, dip, tpc, 4).sum(-1).permute(
            2, 0, 1))

    for seg in range(nseg - 1, -1, -1):
        s0, h, subs = seg * CKPT_STEPS, hck[seg], []
        for u in range(CKPT_STEPS // sub):
            subs.append(h)
            for k in range(sub):
                h = step(h, s0 + u * sub + k, decay(s0 + u * sub + k))
        for u in range(CKPT_STEPS // sub - 1, -1, -1):
            tu = s0 + u * sub
            if tu >= l:
                continue
            hs, das = [subs[u]], []
            for k in range(sub):
                das.append(decay(tu + k))
                hs.append(step(hs[-1], tu + k, das[-1]))
            for k in range(sub - 1, -1, -1):
                t = tu + k
                g = dy[:, t, :, None] * cm[:, t, None, :] + q
                dh = das[k] * hs[k]
                dx[:, t] = lanes(g * bm[:, t, None, :]
                                 * dt[:, t, :, None])
                ddt[:, t] = lanes(g * (av * dh + x[:, t, :, None]
                                       * bm[:, t, None, :]))
                dacc += g * dt[:, t, :, None] * dh
                gb = g * (dt[:, t] * x[:, t])[..., None]
                hc = dy[:, t, :, None] * hs[k + 1]
                for i, v in enumerate((gb, hc)):
                    blocks = v.reshape(bsz, nblk, kc, w)
                    acc = blocks[:, :, 0]
                    for cc in range(1, kc):
                        acc = acc + blocks[:, :, cc]
                    part[i, :, :, t] = acc
                q = das[k] * g
    sums = part[:, :, 0]
    for blk in range(1, nblk):
        sums = sums + part[:, :, blk]
    da = dacc[0]
    for b in range(1, bsz):
        da = da + dacc[b]
    return (dx[:, :l, :di], ddt[:, :l, :di], sums[0, :, :l, :st],
            sums[1, :, :l, :st], da[:di, :st])


@pytest.mark.parametrize("b,l,di,st", SHAPES + [
    (2, 300, 40, 16), (1, 256, 136, 4), (1, 129, 24, 8), (2, 7, 3, 16)])
def test_backward_model_matches_the_plain_backward(b, l, di, st):
    """L inside one segment, across segment edges (129, 256, 300),
    channels that leave a block part-empty (40 at 32 a block, 136 at 128),
    st from 1 to 32, B 1 and 2."""
    args = [torch.from_numpy(t) for t in _scan_inputs(b, l, di, st, l + di)]
    got = _scan_bwd_model(*args)
    want = kref.selective_scan_bwd_ref(*args)
    _rel_close([g.numpy() for g in got], [w.numpy() for w in want],
               CARD_TOL)


def test_backward_model_carry_underflows():
    """A strongly decaying ``a``: the carry and the state underflow to 0
    within a step or two (no inversion of the recurrence could rebuild
    them); the checkpoints restart the walk from stored states."""
    x, dt, bm, cm, a, dy = _scan_inputs(2, 200, 16, 16, seed=3)
    args = [torch.from_numpy(t) for t in (x, dt, bm, cm, a * 200.0, dy)]
    got = _scan_bwd_model(*args)
    want = kref.selective_scan_bwd_ref(*args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _rel_close([g.numpy() for g in got], [w.numpy() for w in want],
               CARD_TOL)


# -- the mamba block --

@pytest.mark.parametrize("chunk", [256, 4])
def test_ssm_fwd_gradients_match_jax(chunk):
    """Every parameter's and the input's gradient of ``ssm_fwd`` against
    ``jax.grad`` of the reference's chunked associative scan."""
    cfg = jregistry.get_config("falcon-mamba-7b", reduced=True)
    jp = jax.tree.map(np.asarray, JS.init_ssm(KEY, cfg))
    rng = np.random.default_rng(chunk)
    u = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(JS.ssm_fwd(p, x, cfg, chunk=chunk) * ct)

    jgp, jgu = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(u))
    tp = TT.tree_map(lambda t: torch.from_numpy(np.array(t))
                     .requires_grad_(True), jp)
    tu = torch.from_numpy(u).requires_grad_(True)
    (TS.ssm_fwd(tp, tu, cfg) * torch.from_numpy(ct)).sum().backward()
    for g, w in zip(TT.tree_leaves(TT.tree_map(lambda t: t.grad, tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jgp))):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jgu), **GRAD_TOL)


def test_falcon_mamba_checkpoint_crosses_packages(tmp_path):
    """A reduced falcon-mamba-7b's parameters saved by the JAX manager
    restore in the port, and the port's save restores in JAX, bit for
    bit."""
    cfg = jregistry.get_config("falcon-mamba-7b", reduced=True)
    jp = JModel(cfg).init_params(KEY)
    jckpt.save(str(tmp_path / "jax"), 2, {"params": jp})
    target = TT.tree_map(torch.zeros_like, model_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)))
    got, _ = tckpt.restore(str(tmp_path / "jax"), 2, {"params": target})
    for g, w in zip(TT.tree_leaves(got["params"]),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(g.numpy(), w)
    tckpt.save(str(tmp_path / "port"), 3, got, blocking=True)
    back, _ = jckpt.restore(str(tmp_path / "port"), 3, {"params": jp})
    for g, w in zip(jax.tree.leaves(jax.tree.map(np.asarray, back)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(g, w)
