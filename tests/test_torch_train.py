"""The training forward of the port against the JAX reference on the CPU:
the attention schedules (dense, flash at chunked shapes, banded
sliding-window) and the dispatcher's pick, ``Model.hidden``/``forward``/
``loss`` with the gradient of every leaf for reduced llama3-8b,
granite-20b, qwen2.5-32b (``qkv_bias``) and mixtral-8x22b (moe), the
remat policies bit for bit against no remat (falcon-mamba-7b and
hymba-1.5b too), every family's train step, B9's gradients in grad mode
and B8's refusal of an input that requires grad, and the plain fold's
gradient.

Both sides get the same numpy inputs made from a seed and the same master
weights (the reference's ``init_params`` carried across by
``convert.model_params_from_reference``), in float32.  Tolerances:
attention outputs 1e-5 and gradients 1e-4; model losses and logits 1e-5,
gradients 1e-4 (rtol and atol alike).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as jregistry
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro_torch.configs import registry as tregistry
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import steps as tsteps

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(0)
ARCHS = ["llama3-8b", "granite-20b", "qwen2.5-32b", "mixtral-8x22b"]


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_leaves(tree):
    return TT.tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _close(got_tree, want_tree, tol):
    """Every leaf of the port's tree against the JAX tree's."""
    got = TT.tree_leaves(got_tree)
    want = jax.tree.leaves(_np(want_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **tol)


# -- attention --

def _qkv(rng, b=2, sq=64, sk=64, h=4, hkv=2, d=16):
    q = rng.standard_normal((b, sq, hkv, h // hkv, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    return q, k, v


def _vjp_both(jfn, tfn, arrays, seed):
    """Outputs and input gradients (against one random cotangent) of the
    JAX function and the port's on the same arrays."""
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ct = np.random.default_rng(seed).standard_normal(
        jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True)
          for a in arrays]
    tout = tfn(*ts)
    tout.backward(torch.from_numpy(ct))
    return (tout.detach().numpy(), np.asarray(jout),
            [t.grad.numpy() for t in ts], [np.asarray(g) for g in jgrads])


def _check_vjp(jfn, tfn, arrays, seed=0):
    got, want, tg, jg = _vjp_both(jfn, tfn, arrays, seed)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 16), (False, 24)])
def test_dense_attention_matches_jax(causal, window):
    arrays = _qkv(np.random.default_rng(1))
    kw = dict(causal=causal, window=window)
    _check_vjp(lambda q, k, v: JL._dense_attention(q, k, v, **kw),
               lambda q, k, v: TL._dense_attention(q, k, v, **kw), arrays)


def test_dense_attention_decode_offsets_match_jax():
    """The cache path's form: queries at ``q_pos0``, keys valid below
    ``kv_len``."""
    arrays = _qkv(np.random.default_rng(2), sq=4, sk=32)
    kw = dict(causal=False, window=8, q_pos0=11, kv_len=15)
    _check_vjp(lambda q, k, v: JL._dense_attention(q, k, v, **kw),
               lambda q, k, v: TL._dense_attention(q, k, v, **kw), arrays)


@pytest.mark.parametrize("causal,window,qc,kc", [
    (True, 0, 16, 8), (True, 0, 32, 16), (False, 0, 16, 32),
    (True, 12, 16, 8), (True, 40, 8, 16)])
def test_flash_attention_matches_jax(causal, window, qc, kc):
    arrays = _qkv(np.random.default_rng(3))
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    _check_vjp(lambda q, k, v: JL._flash_attention(q, k, v, **kw),
               lambda q, k, v: TL._flash_attention(q, k, v, **kw), arrays)


@pytest.mark.parametrize("window,qc", [(16, 16), (16, 32), (8, 64),
                                       (24, 16)])
def test_banded_attention_matches_jax(window, qc):
    """Banded at ``sq > 2 * window`` (the dispatcher's condition), the
    band clipped at both ends of the sequence."""
    arrays = _qkv(np.random.default_rng(4))
    assert arrays[0].shape[1] > 2 * window
    kw = dict(window=window, q_chunk=qc)
    _check_vjp(lambda q, k, v: JL._swa_banded_attention(q, k, v, **kw),
               lambda q, k, v: TL._swa_banded_attention(q, k, v, **kw),
               arrays)


@pytest.mark.parametrize("sq,window,threshold,pick", [
    (64, 16, 4096, "banded"), (64, 0, 4096, "dense"),
    (64, 32, 4096, "dense"),            # sq == 2 * window: not banded
    (512, 0, 64, "flash"), (512, 100, 64, "banded"),
    (48, 0, 8, "dense")])               # 48 % 512: not flash
def test_dispatcher_pick_and_output_match_jax(monkeypatch, sq, window,
                                              threshold, pick):
    """``attention`` picks the schedule the reference's dispatcher calls
    (spied on the JAX side) and gives its output and gradients."""
    picked = []
    for name, tag in (("_dense_attention", "dense"),
                      ("_flash_attention", "flash"),
                      ("_swa_banded_attention", "banded")):
        fn = getattr(JL, name)
        monkeypatch.setattr(JL, name, lambda *a, _f=fn, _t=tag, **k: (
            picked.append(_t), _f(*a, **k))[1])
    rng = np.random.default_rng(5)
    b, h, hkv, d = (1, 2, 1, 8) if sq >= 512 else (2, 4, 2, 16)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    kw = dict(causal=True, window=window, flash_threshold=threshold)
    _check_vjp(lambda q, k, v: JL.attention(q, k, v, **kw),
               lambda q, k, v: TL.attention(q, k, v, **kw), (q, k, v))
    assert picked == [pick]
    assert TL.attention_schedule(sq, sq, causal=True, window=window,
                                 flash_threshold=threshold) == pick


@pytest.mark.parametrize("use_rope", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_fwd_matches_jax(use_rope, causal):
    """Self-attention with and without RoPE (cache-less), with the
    parameter gradients."""
    cfg = jregistry.get_config("qwen2.5-32b", reduced=True)
    jp = _np(JL.init_attention(KEY, cfg))
    x = np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    names = sorted((k, kk) for k in jp for kk in jp[k])
    flat = [jp[k][kk] for k, kk in names]

    def tree(leaves):
        out = {}
        for (k, kk), a in zip(names, leaves):
            out.setdefault(k, {})[kk] = a
        return out

    kw = dict(window=5, use_rope=use_rope, causal=causal)
    _check_vjp(lambda x, *w: JL.attention_fwd(tree(w), x, cfg, **kw),
               lambda x, *w: TL.attention_fwd(tree(w), x, cfg, **kw),
               [x] + flat)


# -- the model --

def _models(name, **ctx):
    cfg = jregistry.get_config(name, reduced=True)
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32))
    tm = Model(cfg, RunCtx(act_dtype=torch.float32, **ctx), device="cpu")
    jp = jm.init_params(KEY)
    tp = tm.load_params(model_params_from_reference(cfg, _np(jp)),
                        master=True)
    return cfg, jm, jp, tm, tp


def _batch(cfg, b=2, s=64, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("name", ARCHS)
def test_model_hidden_forward_loss_and_grads_match_jax(name):
    cfg, jm, jp, tm, tp = _models(name, remat="none")
    tokens, labels = _batch(cfg)
    tt, tl = torch.from_numpy(tokens), torch.from_numpy(labels)
    np.testing.assert_allclose(
        tm.hidden(tp, tt).numpy(),
        np.asarray(jm.hidden(jp, jnp.asarray(tokens))), **OUT_TOL)
    np.testing.assert_allclose(
        tm.forward(tp, tt).numpy(),
        np.asarray(jm.forward(jp, jnp.asarray(tokens))), **OUT_TOL)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tokens), jnp.asarray(labels), chunk=16))(jp)
    leaves = _grad_leaves(tp)
    loss = tm.loss(leaves, tt, tl, chunk=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **OUT_TOL)
    _close(TT.tree_map(lambda t: t.grad, leaves), jgrads, GRAD_TOL)
    # the whole-logits loss is the fused one
    np.testing.assert_allclose(
        TT.lm_loss(tm.forward(tp, tt), tl).item(), float(jloss), **OUT_TOL)


def _loss_and_grads(name, **ctx):
    cfg, _, _, tm, tp = _models(name, **ctx)
    tokens, labels = _batch(cfg, seed=8)
    leaves = _grad_leaves(tp)
    loss = tm.loss(leaves, torch.from_numpy(tokens),
                   torch.from_numpy(labels), chunk=32)
    loss.backward()
    return loss.detach(), [t.grad for t in TT.tree_leaves(leaves)]


@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "hymba-1.5b"])
@pytest.mark.parametrize("ctx", [
    dict(remat="full"), dict(remat="dots"),
    dict(remat="full", remat_groups=2), dict(remat="dots", remat_groups=2),
    dict(remat="none", cast_params_once=True)],
    ids=["full", "dots", "full-groups2", "dots-groups2", "cast-once"])
def test_remat_is_bit_identical_to_none(name, ctx):
    want_loss, want = _loss_and_grads(name, remat="none")
    got_loss, got = _loss_and_grads(name, **ctx)
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_remat_checkpoints_only_when_a_backward_runs(monkeypatch):
    calls = []
    real = TT.ckpt.checkpoint
    monkeypatch.setattr(TT.ckpt, "checkpoint",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    cfg, _, _, tm, tp = _models("llama3-8b", remat="full")
    tokens, labels = (torch.from_numpy(a) for a in _batch(cfg, s=32))
    tm.loss(tp, tokens, labels, chunk=16)            # nothing requires grad
    assert not calls
    tm.loss(_grad_leaves(tp), tokens, labels, chunk=16)
    assert len(calls) == cfg.num_layers + 2          # layers + loss chunks
    with pytest.raises(ValueError, match="remat"):
        RunCtx(remat="some")


def test_master_params_cast_at_use_and_serving_stays_stored():
    """Master weights stay float32 and a bf16 forward casts them at each
    use, giving the serving model's logits (weights stored in bf16)."""
    cfg = tregistry.get_config("llama3-8b", reduced=True)
    ctx = RunCtx(act_dtype=torch.bfloat16)
    tm = Model(cfg, ctx, device="cpu")
    master = tm.init_params(torch.Generator().manual_seed(0), master=True)
    assert all(t.dtype == torch.float32 for t in TT.tree_leaves(master))
    stored = tm.load_params(master)
    assert stored["layers"]["mlp"]["w1"]["w"].dtype == torch.bfloat16
    tokens = torch.from_numpy(_batch(cfg, s=16)[0])
    assert torch.equal(tm.forward(master, tokens), tm.forward(stored, tokens))


# -- refusals on the way to training --

def test_card_kernels_refuse_inputs_that_require_grad():
    """B9 in grad mode goes through its backward: with any of its five
    inputs requiring grad, the gradients are the plain autograd's through
    the plain recurrence.  B8 is a serving kernel with no backward: an
    input that requires grad raises (it would lose its gradient without a
    word); without grad mode both run."""
    rng = np.random.default_rng(9)
    x, dt = (torch.from_numpy(rng.random((1, 8, 4), np.float32))
             for _ in range(2))
    bm, cm = (torch.from_numpy(rng.random((1, 8, 3), np.float32))
              for _ in range(2))
    a = -torch.ones((4, 3))
    dy = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
    q = torch.zeros((2, 4, 16))
    kv = torch.zeros((2, 8, 2, 16))
    lengths = torch.full((2,), 8, dtype=torch.int32)
    for i in range(5):
        args = [x, dt, bm, cm, a]
        args[i] = args[i].clone().requires_grad_(True)
        got = torch.autograd.grad(tops.selective_scan(*args), args[i], dy)
        want = torch.autograd.grad(tref.selective_scan_ref(*args), args[i],
                                   dy)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        with torch.no_grad():
            tops.selective_scan(*args)
    for i in range(3):
        args = [q, kv, kv]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="serving kernel"):
            tops.decode_attention(*args, lengths)
        with torch.no_grad():
            tops.decode_attention(*args, lengths)


@pytest.mark.parametrize("name,item", [
    ("falcon-mamba-7b", "A18"), ("hymba-1.5b", "A11"),
    ("whisper-tiny", "A11"), ("llama-3.2-vision-90b", "A11")])
def test_untrainable_families_raise_in_loss_and_train_step(name, item):
    """``item`` is the ROADMAP item that took the family to the port; no
    family is refused any more.  The ssm and hybrid stacks run their
    recurrence through B9 and its backward (A18); A11's encoder-decoder
    and vision stacks train through plain attention, as the reference
    does.  The train step builds and runs, the loss and a forward with
    gradients too (``tests/test_torch_families.py`` and
    ``tests/test_torch_ssm_train.py`` hold the gradients against
    ``jax.grad``)."""
    cfg = tregistry.get_config(name, reduced=True)
    assert item == ("A18" if cfg.family == "ssm" else "A11")
    opt = AdamW()
    tm = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0), master=True)
    toks = torch.zeros((2, 8), dtype=torch.int64)
    extra = None
    t = cfg.encoder_seq or cfg.num_image_tokens
    if t:
        extra = {"frames" if cfg.is_encdec else "image_embeds":
                 torch.zeros((2, t, cfg.d_model))}
    else:
        loss = tm.loss(_grad_leaves(tp), toks, toks)
        assert loss.requires_grad and bool(torch.isfinite(loss))
        assert tm.hidden(_grad_leaves(tp), toks).requires_grad
    step = tsteps.build_train_step(tm, opt, accum_steps=2)
    _, _, metrics = step(tp, opt.init(tp), (toks, toks), extra)
    assert bool(torch.isfinite(metrics["loss"])) and \
        float(metrics["grad_norm"]) > 0


def test_bf16_embedding_backward_is_the_reference_bit_for_bit():
    """A bf16 forward over float32 master weights: the reference gathers
    from the table cast to bf16, so under ``jax.vjp`` each token's
    cotangent rows add in bf16 (a scatter-add, one rounding per add in
    ascending position order) and the sum is cast once to float32.  The
    port's ``_embed_fwd`` gives the same gradient bit for bit on the same
    bf16 cotangent, 4096 tokens over a vocabulary of 50 (every row
    repeated ~80 times); casting after the gather would add in float32,
    1.8e-2 (relative max) away."""
    cfg = dataclasses.replace(jregistry.get_config("llama3-8b",
                                                   reduced=True),
                              vocab_size=50, d_model=16)
    rng = np.random.default_rng(12)
    w = rng.standard_normal((50, 16)).astype(np.float32)
    tokens = rng.integers(0, 50, (4, 1024)).astype(np.int32)
    ct = torch.from_numpy(rng.standard_normal((4, 1024, 16)).astype(
        np.float32)).bfloat16()
    _, vjp = jax.vjp(lambda w: JT._embed_fwd(
        {"w": w}, jnp.asarray(tokens), cfg, JRunCtx(act_dtype=jnp.bfloat16)),
        jnp.asarray(w))
    want, = vjp(jnp.asarray(ct.float().numpy()).astype(jnp.bfloat16))
    wt = torch.from_numpy(w).requires_grad_(True)
    out = TT._embed_fwd({"w": wt}, torch.from_numpy(tokens), cfg,
                        RunCtx(act_dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    out.backward(ct)
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(want))
    # float32 activations keep F.embedding and its float32 backward
    w32 = torch.from_numpy(w).requires_grad_(True)
    ct32 = ct.float()
    TT._embed_fwd({"w": w32}, torch.from_numpy(tokens), cfg,
                  RunCtx(act_dtype=torch.float32)).backward(ct32)
    ref = torch.zeros_like(w32).index_add_(
        0, torch.from_numpy(tokens).long().reshape(-1), ct32.reshape(-1, 16))
    np.testing.assert_allclose(w32.grad.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def _bf16_step_errors(tm, tp, jgrads, tokens, labels):
    """Each leaf's largest gradient difference from the reference's, over
    the leaf's largest reference element, for one gradient step of the
    port (``build_grad_fn``)."""
    grads, _ = tsteps.build_grad_fn(tm)(
        tp, (torch.from_numpy(tokens), torch.from_numpy(labels)))
    return [float(np.abs(g.float().numpy() - w).max() / np.abs(w).max())
            for g, w in zip(TT.tree_leaves(grads),
                            jax.tree.leaves(_np(jgrads)))]


def test_bf16_train_step_with_repeated_tokens_matches_jax(monkeypatch):
    """One gradient step of reduced llama3-8b at bf16 activations over
    float32 master weights, 8 × 128 tokens drawn from 3 (each row of the
    embedding gets ~340 cotangents): every leaf's gradient within 2e-2 of
    the leaf's largest element of ``jax.grad``'s.  The port's bf16
    matmuls round in other places than XLA's (0.4–0.8 % here, every leaf);
    the embedding's bf16 sum adds its own rounding per add, which the
    port repeats (0.8 %).  Casting after the gather (the float32 add)
    misses by ~11 %, and the test sees it: with ``_embed_fwd``'s old
    gather the embedding's leaf fails the same bound."""
    cfg = jregistry.get_config("llama3-8b", reduced=True)
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.bfloat16))
    jp = jm.init_params(KEY)
    tm = Model(cfg, RunCtx(act_dtype=torch.bfloat16, remat="none"),
               device="cpu")
    tp = tm.load_params(model_params_from_reference(cfg, _np(jp)),
                        master=True)
    toks = np.random.default_rng(13).integers(0, 3, (8, 129)).astype(
        np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    jgrads = jax.grad(lambda p: jm.loss(p, jnp.asarray(tokens),
                                        jnp.asarray(labels)))(jp)
    embed = 0                       # embed/w: the first leaf, keys sorted
    errs = _bf16_step_errors(tm, tp, jgrads, tokens, labels)
    assert max(errs) < 2e-2, errs
    monkeypatch.setattr(TT._CastEmbed, "apply",
                        lambda w, t, dtype: F.embedding(t, w).to(dtype))
    old = _bf16_step_errors(tm, tp, jgrads, tokens, labels)
    assert old[embed] > 2e-2, old


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_fold_is_differentiable(dtype):
    """``moe_fwd``'s combine (``accumulate_segments_ref``, and the card's
    bf16 ``ordered_add``) passes each contribution the cotangent of its
    target: the gradient of a gather, the same on every path."""
    rng = np.random.default_rng(10)
    vals = torch.from_numpy(rng.standard_normal((2, 40, 6)).astype(
        np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 9, (2, 40)).astype(np.int32))
    ct = torch.from_numpy(rng.standard_normal((2, 9, 6)).astype(
        np.float32)).to(dtype)
    want = torch.stack([ct[p][idx[p].long()] for p in range(2)])
    v = vals.clone().requires_grad_(True)
    out = tref.accumulate_segments_ref(v, idx, out_len=9)
    out.backward(ct)
    assert torch.equal(v.grad, want)
    v = vals.clone().requires_grad_(True)
    flat = torch.zeros(2 * 9 * 6, dtype=dtype)
    rows = idx.long() + torch.arange(2)[:, None] * 9
    index = (rows.reshape(-1, 1) * 6 + torch.arange(6)).reshape(-1)
    tref.ordered_add(flat, index, v.reshape(-1))
    flat.backward(ct.reshape(-1))
    assert torch.equal(v.grad, want)
    np.testing.assert_array_equal(flat.detach().float().numpy(),
                                  out.detach().float().reshape(-1).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_fwd_backward_runs(dtype):
    """``moe_fwd``'s backward, through the plain fold, reaches the router
    and every expert weight in float32 and bfloat16."""
    from repro_torch.models import moe as TM
    cfg = tregistry.get_config("mixtral-8x22b", reduced=True)
    p = TT.tree_map(lambda t: t.to(dtype).requires_grad_(True),
                    TM.init_moe(torch.Generator().manual_seed(0), cfg))
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(dtype)
    TM.moe_fwd(p, x.requires_grad_(True), cfg).float().square().sum(
    ).backward()
    for g in [x.grad] + [t.grad for t in TT.tree_leaves(p)]:
        assert g is not None and g.dtype == dtype
        assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
