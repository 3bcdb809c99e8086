"""The mamba glue in the activations' dtype, as the reference runs it.

The reference casts the depthwise conv's weights to the activations' dtype
(``repro.models.ssm.ssm_fwd``'s ``p["conv_w"].astype(x.dtype)`` and the
decode step's), so with float32 master weights under bf16 activations — the
training path on the card (``launch.train``) — the conv, ``x_proj``,
``dt_proj`` and the scan's x, B and C are bf16 values.  Each test runs
reduced falcon-mamba-7b (or hymba-1.5b) with bf16 activations over float32
parameters against the JAX package on the same numpy inputs and records
what the port's glue hands on: every ``linear`` of the block takes a bf16
input, the conv's output is bf16 (and the reference's conv of the same
input bit for bit), and x, B and C reach the scan as bf16 values widened to
float32.  Those records are what a float32 glue fails; the value checks
below do not catch it alone (a float32 glue lands about as far from the
reference's bf16 gradients as the reference's own float32 run does).

The values' tolerances, and why:

- ``ssm_fwd`` (both scan payloads): its output is bf16 (one rounding is
  2^-8 of an element) and the projections' bf16 products round after other
  float32 sums in torch and XLA; held within ``OUT_TOL`` = 2e-2 of max |y|
  (four roundings of the largest element; 6.9e-3 seen);
- ``ssm_decode_step``: the bf16 output as above, the float32 state within
  ``STATE_TOL`` = 1e-2 of its largest element (its inputs are the bf16
  glue's, one rounding apart where torch's and XLA's silu or softplus
  round differently);
- a train step (``build_grad_fn`` against ``jax.value_and_grad``): the loss
  within 1e-3 relative, and each leaf's gradient within twice that leaf's
  own distance (relative L2) between the reference's gradients at bf16 and
  at float32 activations on the same batch — the noise that bf16
  activations put into that gradient, which both packages carry with
  roundings at other places (the port at 0.86–1.27 times it here, leaf by
  leaf).  A leaf's noise counts as at least ``NOISE_FLOOR`` = 2^-8, one
  bf16 rounding step, so that a leaf the reference computes almost exactly
  at bf16 does not demand more than bf16 can hold (every leaf's noise here
  is 1.1e-2 or more, so the floor does not loosen any of them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import ssm as JS
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.runtime import steps as tsteps

KEY = jax.random.PRNGKey(0)
OUT_TOL = 2e-2             # of max |y|: bf16 outputs
STATE_TOL = 1e-2           # of max |h|: the decode step's float32 state
LOSS_RTOL = 1e-3
NOISE_FACTOR = 2.0         # times the leaf's own bf16-vs-f32 distance
NOISE_FLOOR = 2.0 ** -8    # the least noise a leaf is held to: one rounding
PAYLOADS = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


class Glue:
    """Records the dtypes the port's mamba glue runs in: each ``linear``'s
    input, the conv's input and output, and the scan's inputs."""

    def __init__(self, monkeypatch):
        self.linear_in, self.convs, self.scans = [], [], []
        linear, conv, scan = TS.linear, TS._causal_conv, tops.selective_scan

        def rec_linear(p, x):
            self.linear_in.append(x.dtype)
            return linear(p, x)

        def rec_conv(x, w, b):
            out = conv(x, w, b)
            self.convs.append((x.detach(), w.dtype, b.dtype, out.detach()))
            return out

        def rec_scan(x, dt, bmat, cmat, a, **kw):
            self.scans.append((x.detach(), bmat.detach(), cmat.detach()))
            return scan(x, dt, bmat, cmat, a, **kw)

        monkeypatch.setattr(TS, "linear", rec_linear)
        monkeypatch.setattr(TS, "_causal_conv", rec_conv)
        monkeypatch.setattr(tops, "selective_scan", rec_scan)

    def check(self, dtype=torch.bfloat16):
        """Every linear of the block took ``dtype``; the conv ran in it; x,
        B and C are ``dtype`` values in float32."""
        assert self.linear_in and set(self.linear_in) == {dtype}, \
            self.linear_in
        for x, wd, bd, out in self.convs:
            assert x.dtype == wd == bd == out.dtype == dtype, (
                x.dtype, wd, bd, out.dtype)
        for ts in self.scans:
            for t in ts:
                assert t.dtype == torch.float32
                assert torch.equal(t, t.to(dtype).float())


def _cfg():
    """Reduced falcon-mamba-7b at d_inner 64 and 16 states."""
    return dataclasses.replace(
        jregistry.get_config("falcon-mamba-7b", reduced=True), d_model=32,
        ssm_state=16)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _params(cfg):
    jp = jax.tree.map(np.asarray, JS.init_ssm(KEY, cfg))
    tp = TT.tree_map(lambda t: torch.from_numpy(np.array(t)), jp)
    assert all(t.dtype == torch.float32 for t in TT.tree_leaves(tp))
    return jp, tp


@pytest.mark.parametrize("payload", PAYLOADS, ids=["f32", "bf16"])
def test_ssm_fwd_glue_runs_in_the_activation_dtype(monkeypatch, payload):
    """B 2, L 512 (two chunks of the bf16 payload), bf16 input, float32
    parameters: the glue in bf16, the conv the reference's bit for bit on
    the same input, the output within OUT_TOL of the reference's."""
    tpay, jpay = payload
    cfg = _cfg()
    jp, tp = _params(cfg)
    u = np.random.default_rng(1).standard_normal(
        (2, 512, cfg.d_model)).astype(np.float32)
    ub = jnp.asarray(u, jnp.bfloat16)
    want = jax.jit(lambda p, x: JS.ssm_fwd(p, x, cfg, scan_dtype=jpay))(
        jp, ub)
    glue = Glue(monkeypatch)
    with torch.no_grad():
        got = TS.ssm_fwd(tp, torch.from_numpy(u).bfloat16(), cfg,
                         scan_dtype=tpay)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    glue.check()
    (x, _, _, out), = glue.convs
    jconv = JS._causal_conv(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                            jnp.asarray(jp["conv_w"]).astype(jnp.bfloat16),
                            jnp.asarray(jp["conv_b"]).astype(jnp.bfloat16))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jconv, np.float32))
    err = _rel_max(got.float().numpy(), want)
    assert err <= OUT_TOL, err


def test_ssm_decode_step_glue_runs_in_the_activation_dtype(monkeypatch):
    """Eight decode steps from an empty bf16 cache: every linear takes
    bf16, the rolling conv window stays bf16, each step's output and state
    near the reference's."""
    cfg = _cfg()
    jp, tp = _params(cfg)
    u = np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    jc = JS.init_ssm_cache(2, cfg, dtype=jnp.bfloat16)
    tc = TS.init_ssm_cache(2, cfg, dtype=torch.bfloat16)
    glue = Glue(monkeypatch)
    for i in range(u.shape[1]):
        jy, jc = JS.ssm_decode_step(
            jp, jnp.asarray(u[:, i:i + 1], jnp.bfloat16), jc, cfg)
        with torch.no_grad():
            ty, tc = TS.ssm_decode_step(
                tp, torch.from_numpy(u[:, i:i + 1]).bfloat16(), tc, cfg)
        assert ty.dtype == tc["conv"].dtype == torch.bfloat16
        assert tc["h"].dtype == torch.float32
        assert _rel_max(ty.float().numpy(), jy) <= OUT_TOL, i
        assert _rel_max(tc["h"].numpy(), jc["h"]) <= STATE_TOL, i
    glue.check()


def _grad_distance(got, want):
    return [float(np.linalg.norm(g - w) / np.linalg.norm(w))
            for g, w in zip(got, want) if np.any(w)]


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "hymba-1.5b"])
@pytest.mark.parametrize("payload", PAYLOADS, ids=["f32", "bf16"])
def test_train_step_glue_runs_in_the_activation_dtype(monkeypatch, name,
                                                      payload):
    """One gradient step (``build_grad_fn``) of the reduced model at bf16
    activations over float32 master weights, 2 × 64 tokens, against
    ``jax.value_and_grad`` of the JAX model at the same settings: the glue
    in bf16 in every layer, the loss within LOSS_RTOL, each leaf within
    NOISE_FACTOR times the reference's own bf16-vs-float32 distance for
    that leaf (at least NOISE_FLOOR)."""
    tpay, jpay = payload
    cfg = jregistry.get_config(name, reduced=True)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]

    def reference(act):
        jm = JModel(cfg, JRunCtx(remat="none", act_dtype=act,
                                 ssm_scan_dtype=jpay))
        jp = jm.init_params(KEY)
        loss, g = jax.value_and_grad(lambda p: jm.loss(
            p, jnp.asarray(tokens), jnp.asarray(labels)))(jp)
        return jp, float(loss), [np.asarray(t, np.float32)
                                 for t in jax.tree.leaves(g)]

    jp, jloss, want = reference(jnp.bfloat16)
    _, _, want32 = reference(jnp.float32)
    tm = TT.Model(cfg, TT.RunCtx(act_dtype=torch.bfloat16, remat="none",
                                 ssm_scan_dtype=tpay), device="cpu")
    tp = tm.load_params(model_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)), master=True)
    glue = Glue(monkeypatch)
    grads, loss = tsteps.build_grad_fn(tm)(
        tp, (torch.from_numpy(tokens), torch.from_numpy(labels)))
    assert len(glue.convs) == cfg.num_layers
    glue.check()
    got = [t.float().numpy() for t in TT.tree_leaves(grads)]
    assert len(got) == len(want)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    dist = _grad_distance(got, want)
    noise = _grad_distance(want32, want)
    assert len(dist) == len(noise)
    ratios = [d / max(n, NOISE_FLOOR) for d, n in zip(dist, noise)]
    print(f"{name}: largest leaf distance over its own noise "
          f"{max(ratios):.3f}")
    assert max(ratios) <= NOISE_FACTOR, list(zip(dist, noise))
