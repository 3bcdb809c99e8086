"""The serving model of the port against the JAX reference on the CPU:
configs field for field, the layers, the mamba-1 block, ``Model.prefill``
and ``decode_step`` on reduced llama3-8b, and ``build_prefill`` on reduced
falcon-mamba-7b.

Both sides get the same weights (the reference's ``init_params`` carried
across by ``convert.model_params_from_reference``) and the same numpy
inputs, in float32.  Tolerance rtol/atol 2e-4, as the reference's kernel
tests: the port sums in other orders (its recurrence one step after
another where the reference runs an associative scan, its decode softmax
over the valid prefix where the reference masks the whole ring).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro.runtime import steps as jsteps
from repro_torch.configs import registry as tregistry
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import Model, RunCtx, tree_map
from repro_torch.runtime import steps as tsteps

TOL = dict(rtol=2e-4, atol=2e-4)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def llama_cfg():
    """Reduced llama3-8b with two KV heads: G = 2 query heads per KV head
    (``reduce_common`` alone keeps 4 and 4, G = 1)."""
    return dataclasses.replace(
        jregistry.get_config("llama3-8b", reduced=True), num_kv_heads=2)


def mamba_cfg():
    return jregistry.get_config("falcon-mamba-7b", reduced=True)


def models(cfg):
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32))
    tm = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    jp = jm.init_params(KEY)
    tp = tm.load_params(model_params_from_reference(cfg, _np(jp)))
    return jm, jp, tm, tp


# -- configs --

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", jregistry.ARCH_NAMES)
def test_config_field_for_field(name, reduced):
    assert tregistry.ARCH_NAMES == jregistry.ARCH_NAMES
    want = dataclasses.asdict(jregistry.get_config(name, reduced=reduced))
    got = dataclasses.asdict(tregistry.get_config(name, reduced=reduced))
    assert got == want
    cfg = tregistry.get_config(name, reduced=reduced)
    ref = jregistry.get_config(name, reduced=reduced)
    assert cfg.param_count() == ref.param_count()
    assert cfg.d_inner == ref.d_inner


# -- layers --

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        TL.linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                  torch.from_numpy(x)).numpy(),
        np.asarray(JL.linear({"w": w, "b": b}, jnp.asarray(x))), **TOL)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    for kind, p in (("rmsnorm", {"scale": scale}),
                    ("layernorm", {"scale": scale, "bias": bias})):
        np.testing.assert_allclose(
            TL.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), kind=kind).numpy(),
            np.asarray(JL.norm_apply(p, jnp.asarray(x), kind=kind)), **TOL)
    xr = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(xr), torch.from_numpy(pos),
                theta=5e5).numpy(),
        np.asarray(JL.rope(jnp.asarray(xr), jnp.asarray(pos), theta=5e5)),
        **TOL)
    for act in ("swiglu", "gelu"):
        jp = _np(JL.init_mlp(KEY, 32, 48, act=act))
        np.testing.assert_allclose(
            TL.mlp_fwd(_t(jp), torch.from_numpy(x), act=act).numpy(),
            np.asarray(JL.mlp_fwd(jp, jnp.asarray(x), act=act)), **TOL)


def test_layers_init_shapes_match_jax():
    cfg = llama_cfg()
    gen = torch.Generator().manual_seed(0)
    got = TL.init_attention(gen, cfg)
    want = JL.init_attention(KEY, cfg)
    assert jax.tree.map(lambda a: a.shape, _np(want)) == \
        jax.tree.map(lambda t: tuple(t.shape), got)


def test_training_attention_is_refused():
    """The training attention is ported (tests/test_torch_train.py); what
    stays refused is a gradient through the card's decode-attention
    kernel B8, a serving kernel with no backward (the reference never
    differentiates one-token decode)."""
    q = torch.zeros((2, 4, 16), requires_grad=True)
    kv = torch.zeros((2, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="serving kernel"):
        tops.decode_attention(q, kv, kv, torch.full((2,), 8,
                                                    dtype=torch.int32))


# -- mamba-1 block --

def test_ssm_fwd_matches_jax():
    cfg = mamba_cfg()
    jp = _np(JS.init_ssm(KEY, cfg))
    u = np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    want = np.asarray(JS.ssm_fwd(jp, jnp.asarray(u), cfg, chunk=16))
    got = TS.ssm_fwd(_t(jp), torch.from_numpy(u), cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_ssm_decode_step_matches_jax():
    cfg = mamba_cfg()
    jp = _np(JS.init_ssm(KEY, cfg))
    tp = _t(jp)
    u = np.random.default_rng(2).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    jc = JS.init_ssm_cache(2, cfg)
    tc = TS.init_ssm_cache(2, cfg)
    for i in range(u.shape[1]):
        jy, jc = JS.ssm_decode_step(jp, jnp.asarray(u[:, i:i + 1]), jc, cfg)
        ty, tc = TS.ssm_decode_step(tp, torch.from_numpy(u[:, i:i + 1]), tc,
                                    cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tc["h"].numpy(), np.asarray(jc["h"]), **TOL)
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]),
                               **TOL)


def test_ssm_bf16_scan_is_refused():
    cfg = mamba_cfg()
    tp = _t(_np(JS.init_ssm(KEY, cfg)))
    with pytest.raises(NotImplementedError, match="A16"):
        TS.ssm_fwd(tp, torch.zeros((1, 4, cfg.d_model)), cfg,
                   scan_dtype=torch.bfloat16)


# -- the model --

@pytest.mark.parametrize("per_slot", [False, True])
def test_prefill_and_decode_logits_match_jax(per_slot):
    cfg = llama_cfg()
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(3)
    b, s, clen = 2, 6, 16
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jc = jm.init_cache(b, clen, dtype=jnp.float32, per_slot=per_slot)
    tc = tm.init_cache(b, clen, dtype=torch.float32, per_slot=per_slot)
    jl, jc = jm.prefill(jp, jc, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][leaf].numpy(),
                                   np.asarray(jc["layers"][leaf]), **TOL)
    np.testing.assert_array_equal(tc["layers"]["slot_pos"].numpy(),
                                  np.asarray(jc["layers"]["slot_pos"]))
    nxt = rng.integers(0, cfg.vocab_size, (b, 4)).astype(np.int32)
    for i in range(nxt.shape[1]):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt[:, i:i + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["layers"]["slot_pos"].numpy(),
                                  np.asarray(jc["layers"]["slot_pos"]))


def test_ssm_decode_step_model_matches_jax():
    cfg = mamba_cfg()
    jm, jp, tm, tp = models(cfg)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    jc = jm.init_cache(2, 8, dtype=jnp.float32)
    tc = tm.init_cache(2, 8, dtype=torch.float32)
    for i in range(toks.shape[1]):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_build_prefill_ssm_matches_jax():
    cfg = mamba_cfg()
    jm, jp, tm, tp = models(cfg)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want = np.asarray(jsteps.build_prefill(jm)(jp, jnp.asarray(toks)))
    got = tsteps.build_prefill(tm)(tp, torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    full = tm.forward(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(full[:, -1:], got, rtol=1e-6, atol=1e-6)


def test_build_prefill_fill_cache_is_model_prefill():
    cfg = llama_cfg()
    _, _, tm, tp = models(cfg)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 5)).astype(np.int32))
    a, _ = tsteps.build_prefill(tm, fill_cache=True)(
        tp, tm.init_cache(1, 8, dtype=torch.float32), toks)
    b, _ = tm.prefill(tp, tm.init_cache(1, 8, dtype=torch.float32), toks)
    assert torch.equal(a, b)
    c, _ = tsteps.build_decode_step(tm)(
        tp, tm.init_cache(1, 8, dtype=torch.float32), toks[:, :1])
    assert c.shape == (1, 1, cfg.vocab_size)


def test_params_store_act_dtype_once():
    cfg = llama_cfg()
    jp = _np(JModel(cfg).init_params(KEY))
    tm = Model(cfg, RunCtx(act_dtype=torch.bfloat16), device="cpu")
    tp = tm.load_params(model_params_from_reference(cfg, jp))
    assert tp["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert tp["embed"]["w"].dtype == torch.bfloat16
    assert tp["layers"]["ln1"]["scale"].dtype == torch.float32
    assert tp["final_norm"]["scale"].dtype == torch.float32
    gen = tm.init_params(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), gen)
    assert gen["layers"]["mlp"]["w1"]["w"].dtype == torch.bfloat16
    mcfg = mamba_cfg()
    mp = Model(mcfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert mp["layers"]["ssm"]["a_log"].dtype == torch.float32
    assert mp["layers"]["ssm"]["d_skip"].dtype == torch.float32
    with pytest.raises(ValueError, match="stacked"):
        bad = dict(jp, layers=jax.tree.map(lambda a: a[0], jp["layers"]))
        model_params_from_reference(cfg, bad)


@pytest.mark.parametrize("name,item", [
    ("hymba-1.5b", "A11"), ("whisper-tiny", "A11"),
    ("llama-3.2-vision-90b", "A11")])
def test_other_families_are_refused(name, item):
    """The families that ``item`` took to the port (once refused here)
    build, with the reference's parameter tree and a cache of its shapes
    (``tests/test_torch_families.py`` holds their outputs against JAX);
    what stays refused is what the reference refuses too: a per-slot
    cache and the fused prefill, which need an attention-only stack."""
    cfg = tregistry.get_config(name, reduced=True)
    jcfg = jregistry.get_config(name, reduced=True)
    tm = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    jm = JModel(jcfg, JRunCtx(remat="none", act_dtype=jnp.float32))
    got = tm.init_params(torch.Generator().manual_seed(0))
    want = jax.eval_shape(jm.init_params, KEY)
    assert jax.tree.map(lambda a: a.shape, want) == tree_map(
        lambda t: tuple(t.shape), got), item
    cross = cfg.encoder_seq or cfg.num_image_tokens
    assert tree_map(lambda t: tuple(t.shape), tm.init_cache(
        2, 8, cross_len=cross, dtype=torch.float32)) == jax.tree.map(
        lambda a: a.shape, jax.eval_shape(functools.partial(
            jm.init_cache, 2, 8, cross_len=cross, dtype=jnp.float32)))
    with pytest.raises(NotImplementedError, match="fused prefill"):
        tm.prefill(got, tm.init_cache(2, 8, cross_len=cross),
                   torch.zeros((2, 4), dtype=torch.int32))
    if not cfg.is_vlm:    # the reference lets the vision stack through
        with pytest.raises(NotImplementedError, match="per-slot"):
            tm.init_cache(2, 8, per_slot=True)


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_family_matches_jax(groups):
    """The moe family (A10, once refused here): reduced mixtral-8x22b with
    the JAX weights carried across and full attention, its fused prefill
    (``moe_fwd`` over ``moe_groups`` groups) and a decode step within 2e-4
    of the JAX model's, its parameter tree the JAX tree's."""
    cfg = dataclasses.replace(
        jregistry.get_config("mixtral-8x22b", reduced=True), swa_window=0)
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32,
                             moe_groups=groups))
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = Model(cfg, RunCtx(act_dtype=torch.float32, moe_groups=groups),
               device="cpu")
    tp = tm.load_params(model_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)))
    gen = tm.init_params(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), gen)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6))
    jc = jm.init_cache(2, 8, dtype=jnp.float32)
    tc = tm.init_cache(2, 8, dtype=torch.float32)
    jl, jc = jm.prefill(jp, jc, jnp.asarray(tokens, jnp.int32))
    tl, tc = tm.prefill(tp, tc, torch.as_tensor(tokens, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = tokens[:, :1]
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(nxt, jnp.int32))
    tl, _ = tm.decode_step(tp, tc, torch.as_tensor(nxt, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_windowed_decode_and_attention_training_are_refused():
    """A window (A11) runs past its end — the cache cut to the window, the
    step at position 8 and those after it the JAX model's
    (``tests/test_torch_window.py`` holds every case); the training
    forward of attention stacks is ported (tests/test_torch_train.py), and
    what stays refused is a decode step with weights that require grad,
    whose attention kernel (B8) is a serving kernel with no backward; a
    MoE decode hook
    (A10) is a no-op on a stack without a MoE FFN."""
    cfg = dataclasses.replace(llama_cfg(), swa_window=8)
    jm, jp, tm, params = models(cfg)
    cache = tm.init_cache(1, 32, dtype=torch.float32)
    jc = jm.init_cache(1, 32, dtype=jnp.float32)
    assert cache["layers"]["k"].shape[2] == 8
    tok = torch.zeros((1, 1), dtype=torch.int32)
    for _ in range(12):                                 # positions 0 .. 11
        got, cache = tm.decode_step(params, cache, tok)
        want, jc = jm.decode_step(jp, jc, jnp.asarray(tok.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tm = Model(llama_cfg(), RunCtx(act_dtype=torch.float32), device="cpu")
    grad_params = tree_map(lambda t: t.detach().requires_grad_(True),
                           tm.init_params(torch.Generator().manual_seed(0)))
    with pytest.raises(NotImplementedError, match="serving kernel"):
        tm.decode_step(grad_params, tm.init_cache(1, 4), tok)
    hooked = Model(llama_cfg(), RunCtx(act_dtype=torch.float32,
                                       moe_step=lambda p, h: h),
                   device="cpu")
    plain = Model(llama_cfg(), RunCtx(act_dtype=torch.float32), device="cpu")
    params = plain.init_params(torch.Generator().manual_seed(1))
    got, _ = hooked.decode_step(params, hooked.init_cache(1, 4), tok)
    want, _ = plain.decode_step(params, plain.init_cache(1, 4), tok)
    assert torch.equal(got, want)
