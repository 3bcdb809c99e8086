"""The hybrid, encoder-decoder and vision families of the port against the
JAX reference on the CPU: reduced hymba-1.5b (attention and a mamba-1 head
side by side, window 16), whisper-tiny (an encoder over 32 frames, a
decoder that cross-attends to it) and llama-3.2-vision-90b (two groups of
a self-attention layer and a cross-attention layer over 16 image
embeddings).

Both sides get the same master weights (the reference's ``init_params``
carried across by ``convert.model_params_from_reference``) and the same
numpy inputs made from a seed, in float32.  On the CPU the card kernels
take their plain versions: the hybrid's mamba half runs B9's plain
recurrence (``kref.selective_scan_ref``), decode attention, self and
cross, B8's (``kref.decode_attention_ref``).  Tolerances: the forward,
``attention_fwd`` and the decode logits 2e-4 (rtol and atol alike), as
``tests/test_torch_models.py``: the port sums in other orders (the
recurrence one step after another, the decode softmax over the valid
prefix); the loss and every leaf's gradient 1e-4, as
``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import registry as jregistry
from repro.launch.serve import prefill_into_cache as jprefill_into_cache
from repro.models import layers as JL
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import registry as tregistry
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ltrain
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import Model, RunCtx

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(0)
FAMILIES = ["hymba-1.5b", "whisper-tiny", "llama-3.2-vision-90b"]


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(name):
    cfg = jregistry.get_config(name, reduced=True)
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32))
    tm = Model(cfg, RunCtx(act_dtype=torch.float32, remat="none"),
               device="cpu")
    jp = jm.init_params(KEY)
    tp = tm.load_params(model_params_from_reference(cfg, _np(jp)),
                        master=True)
    return cfg, jm, jp, tm, tp


def _context(cfg, b, seed=11):
    """The cross-attention input of ``cfg`` as numpy: frames or image
    embeddings (B, T, D), or None."""
    t = cfg.encoder_seq or cfg.num_image_tokens
    if not t:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _extra(cfg, ctx, to):
    if ctx is None:
        return None
    return {"frames" if cfg.is_encdec else "image_embeds": to(ctx)}


def _tokens(cfg, b, s, seed=7):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_hidden_match_jax(name):
    """40 tokens: past the hybrid's window of 16 (the reference's banded
    schedule), the encoder's 32 frames and the 16 image tokens."""
    cfg, jm, jp, tm, tp = _models(name)
    toks = _tokens(cfg, 2, 40)
    ctx = _context(cfg, 2)
    jex, tex = _extra(cfg, ctx, jnp.asarray), _extra(cfg, ctx,
                                                     torch.from_numpy)
    tt = torch.from_numpy(toks)
    np.testing.assert_allclose(
        tm.hidden(tp, tt, extra=tex).numpy(),
        np.asarray(jm.hidden(jp, jnp.asarray(toks), extra=jex)), **TOL)
    np.testing.assert_allclose(
        tm.forward(tp, tt, extra=tex, last_only=True).numpy(),
        np.asarray(jm.forward(jp, jnp.asarray(toks), extra=jex,
                              last_only=True)), **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_has_the_reference_tree(name):
    cfg = jregistry.get_config(name, reduced=True)
    want = jax.eval_shape(JModel(cfg).init_params, KEY)
    got = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu") \
        .init_params(torch.Generator().manual_seed(0), master=True)
    assert jax.tree.map(lambda a: a.shape, want) == TT.tree_map(
        lambda t: tuple(t.shape), got)
    assert all(t.dtype == torch.float32 for t in TT.tree_leaves(got))


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_cross_and_decode_match_jax(name):
    """The cross K/V from ``prefill_cross``, then a prompt of 12 and 10
    generated tokens through ``prefill_into_cache`` and ``decode_step``:
    the hybrid's ring of 16 wraps and decode runs past its window."""
    cfg, jm, jp, tm, tp = _models(name)
    b, s, gen, clen = 2, 12, 10, 32
    ctx = _context(cfg, b)
    cross_len = 0 if ctx is None else ctx.shape[1]
    jc = jm.init_cache(b, clen, cross_len=cross_len, dtype=jnp.float32)
    tc = tm.init_cache(b, clen, cross_len=cross_len, dtype=torch.float32)
    assert TT.tree_map(lambda t: tuple(t.shape), tc) == jax.tree.map(
        lambda a: a.shape, jc)
    if ctx is not None:
        jc = jm.prefill_cross(jp, jc, jnp.asarray(ctx))
        tc = tm.prefill_cross(tp, tc, torch.from_numpy(ctx))
        for key in ("cross_k", "cross_v"):
            lc, jlc = tc["layers"], jc["layers"]
            if cfg.is_vlm:
                lc, jlc = lc["cross"], jlc["cross"]
            np.testing.assert_allclose(lc[key].numpy(), np.asarray(jlc[key]),
                                       **TOL)
    toks = _tokens(cfg, b, s)
    jc, jl = jprefill_into_cache(jm, jp, jc, jnp.asarray(toks))
    tc, tl = tserve.prefill_into_cache(tm, tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt_j = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    nxt_t = torch.argmax(tl[:, -1], -1).to(torch.int32)
    for _ in range(gen):
        np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j))
        jl, jc = jm.decode_step(jp, jc, nxt_j[:, None])
        tl, tc = tm.decode_step(tp, tc, nxt_t[:, None])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt_j = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
        nxt_t = torch.argmax(tl[:, -1], -1).to(torch.int32)
    assert int(tc["pos"]) == int(jc["pos"]) == s + gen


@pytest.mark.parametrize("name", ["whisper-tiny", "llama-3.2-vision-90b",
                                  "falcon-mamba-7b", "hymba-1.5b"])
def test_loss_and_every_gradient_match_jax(name):
    """The encoder-decoder and the vision stack train through plain
    attention, as the reference does, the frames' or image embeddings'
    gradient too; the mamba and hybrid stacks through B9's backward (on
    the CPU the plain backward) against ``jax.grad`` of the reference's
    chunked associative scan."""
    cfg, jm, jp, tm, tp = _models(name)
    toks = _tokens(cfg, 2, 33)
    ctx = _context(cfg, 2)
    key = "frames" if cfg.is_encdec else "image_embeds"

    def jloss(p, c):
        extra = None if c is None else {key: c}
        return jm.loss(p, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]),
                       extra=extra, chunk=16)

    want, (jg, jgc) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, None if ctx is None else jnp.asarray(ctx))
    leaves = TT.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    c = None if ctx is None else torch.from_numpy(ctx).requires_grad_(True)
    got = tm.loss(leaves, torch.from_numpy(toks[:, :-1]),
                  torch.from_numpy(toks[:, 1:]),
                  extra=None if c is None else {key: c}, chunk=16)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **GRAD_TOL)
    g_leaves = TT.tree_leaves(TT.tree_map(lambda t: t.grad, leaves))
    j_leaves = jax.tree.leaves(_np(jg))
    assert len(g_leaves) == len(j_leaves)
    for g, w in zip(g_leaves, j_leaves):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)
    if c is not None:
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc),
                                   **GRAD_TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_fwd_matches_jax(cached):
    """``attention_fwd`` with ``kv_x`` (no RoPE, no causal mask), and its
    cache path: new rows written at ``cache_pos`` (clamped into the
    buffer), positions below ``cache_pos + Sq`` attended under the
    window."""
    cfg = jregistry.get_config("llama3-8b", reduced=True)
    rng = np.random.default_rng(3)
    jp = _np(JL.init_attention(KEY, cfg))
    tp = TT.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    if not cached:
        kv = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
        np.testing.assert_allclose(
            TL.attention_fwd(tp, torch.from_numpy(x), cfg,
                             kv_x=torch.from_numpy(kv)).numpy(),
            np.asarray(JL.attention_fwd(jp, jnp.asarray(x), cfg,
                                        kv_x=jnp.asarray(kv))), **TOL)
        return
    shape = (2, 12, cfg.num_kv_heads, cfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    for pos in (3, 10):                      # 10 + 5 > 12: the start clamps
        jy, jc = JL.attention_fwd(jp, jnp.asarray(x), cfg, window=4,
                                  cache={"k": jnp.asarray(k0),
                                         "v": jnp.asarray(v0)},
                                  cache_pos=jnp.int32(pos))
        tcache = {"k": torch.from_numpy(k0.copy()),
                  "v": torch.from_numpy(v0.copy())}
        ty, tc = TL.attention_fwd(tp, torch.from_numpy(x), cfg, window=4,
                                  cache=tcache, cache_pos=pos)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)


def test_convert_checks_the_group_and_encoder_stacks():
    for name, path in (("llama-3.2-vision-90b", ("groups", "self")),
                       ("whisper-tiny", ("encoder", "layers"))):
        cfg = jregistry.get_config(name, reduced=True)
        jp = _np(JModel(cfg).init_params(KEY))
        node = jp
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = jax.tree.map(lambda a: a[0], node[path[-1]])
        with pytest.raises(ValueError, match="stacked"):
            model_params_from_reference(cfg, jp)
        del node[path[-1]]
        with pytest.raises(ValueError, match="missing"):
            model_params_from_reference(cfg, jp)


@pytest.mark.parametrize("name", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_checkpoints_of_the_group_and_encoder_trees_cross_packages(
        tmp_path, name):
    cfg = jregistry.get_config(name, reduced=True)
    jp = JModel(cfg).init_params(KEY)
    jckpt.save(str(tmp_path / "jax"), 3, {"params": jp})
    target = TT.tree_map(torch.zeros_like,
                         model_params_from_reference(cfg, _np(jp)))
    got, _ = tckpt.restore(str(tmp_path / "jax"), 3, {"params": target})
    for g, w in zip(TT.tree_leaves(got["params"]), jax.tree.leaves(_np(jp))):
        np.testing.assert_array_equal(g.numpy(), w)
    tckpt.save(str(tmp_path / "port"), 4, got, blocking=True)
    back, _ = jckpt.restore(str(tmp_path / "port"), 4, {"params": jp})
    for g, w in zip(jax.tree.leaves(_np(back)), jax.tree.leaves(_np(jp))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", FAMILIES)
def test_batch_demo_draws_the_context_then_the_prompt(name):
    """``launch.serve``'s batched demo: the cross context of the cache
    filled from the seed's first draw, the prompt from the next, as the
    reference's ``_batch_demo_main`` draws them; then every lane gets its
    tokens inside the vocabulary."""
    cfg = tregistry.get_config(name, reduced=True)
    args = tserve.parse_args(["--arch", name, "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "6", "--gen",
                              "3", "--seed", "5"])
    ctx = RunCtx(act_dtype=torch.float32)
    model, params, cache, prompt = tserve.setup_batch_demo(cfg, ctx, args)
    rng = np.random.default_rng(5)
    t = cfg.encoder_seq or cfg.num_image_tokens
    if t:
        context = rng.standard_normal((2, t, cfg.d_model))
        want = model.prefill_cross(params, model.init_cache(
            2, 9, cross_len=t, dtype=torch.float32),
            torch.as_tensor(context).float())["layers"]
        got = cache["layers"]
        if cfg.is_vlm:
            want, got = want["cross"], got["cross"]
        assert torch.equal(got["cross_k"], want["cross_k"])
    np.testing.assert_array_equal(prompt.numpy(),
                                  rng.integers(0, cfg.vocab_size, (2, 6)))
    seq = tserve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert tuple(seq.shape) == (2, 3)
    assert bool(((seq >= 0) & (seq < cfg.vocab_size)).all())


@pytest.mark.parametrize("name", FAMILIES)
def test_launch_train_on_the_cpu(name):
    """``launch.train`` feeds the encoder-decoder and the vision stack the
    reference's zero frames or image embeddings, a step at a time, and
    the loss falls; the hybrid trains with no extra inputs, its mamba
    head through B9's backward."""
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "16", "--accum", "2", "--lr", "1e-2",
            "--warmup", "1", "--log-every", "5"]
    cfg = tregistry.get_config(name, reduced=True)
    tr = ltrain.setup(cfg, ltrain.parse_args(argv))
    if name == "hymba-1.5b":
        assert tr.extra is None
    else:
        (key, ctx), = tr.extra.items()
        assert key == ("frames" if cfg.is_encdec else "image_embeds")
        assert tuple(ctx.shape) == (
            4, cfg.encoder_seq or cfg.num_image_tokens, cfg.d_model) \
            and not bool(ctx.any())
    hist = ltrain.main(argv)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
