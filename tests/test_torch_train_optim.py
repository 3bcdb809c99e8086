"""The port's optimizer, train step, data pipeline and fault utilities
against the JAX reference on the CPU.

AdamW over 5 steps (with and without ``clip_norm``, ``mixed_precision``
both ways, weight decay) and the schedules: parameters, moments and
``gnorm`` within 1e-6.  One ``build_train_step`` step of reduced llama3-8b,
mixtral-8x22b, falcon-mamba-7b and hymba-1.5b at ``accum_steps`` 1 and 4:
loss, ``grad_norm``, the updated parameters and moments within 1e-5 (with
AdamW's ``eps`` above the gradients' scale: the test's docstring says
why).  ``SyntheticLM.batch_at`` bit for bit; ``model_flops`` equal; ``StragglerWatch`` and ``retrying`` behaving as the
reference's.  Float32 throughout (the mixed-precision compute copy is
bfloat16 on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import pipeline as jpipe
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro.optim import adamw as jadamw
from repro.runtime import fault as jfault
from repro.runtime import steps as jsteps
from repro_torch.configs import registry as tregistry
from repro_torch.convert import model_params_from_reference
from repro_torch.data import pipeline as tpipe
from repro_torch.models.transformer import Model, RunCtx, tree_leaves
from repro_torch.models.transformer import tree_map
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import fault as tfault
from repro_torch.runtime import steps as tsteps

OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _close(got_tree, want_tree, tol):
    got = [t.float().numpy() for t in tree_leaves(got_tree)]
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(
        _np(want_tree))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


# -- AdamW and schedules --

@pytest.mark.parametrize("step", [0, 1, 4, 5, 9, 30])
def test_schedules_match_jax(step):
    s_j, s_t = jnp.int32(step), torch.tensor(step, dtype=torch.int32)
    for jfn, tfn in (
            (jadamw.linear_warmup(3e-4, 5), tadamw.linear_warmup(3e-4, 5)),
            (jadamw.cosine_schedule(3e-4, 5, 20),
             tadamw.cosine_schedule(3e-4, 5, 20)),
            (jadamw.cosine_schedule(1e-2, 0, 1, min_ratio=0.3),
             tadamw.cosine_schedule(1e-2, 0, 1, min_ratio=0.3))):
        np.testing.assert_allclose(float(tfn(s_t)), float(jfn(s_j)),
                                   rtol=1e-6, atol=0)


def _tree(rng):
    return {"a": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                  "b": rng.standard_normal(5).astype(np.float32)},
            "z": rng.standard_normal((3, 2, 4)).astype(np.float32)}


@pytest.mark.parametrize("clip_norm", [1.0, 0.0, 50.0])
@pytest.mark.parametrize("mixed_precision", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_five_steps_match_jax(clip_norm, mixed_precision,
                                    weight_decay):
    rng = np.random.default_rng(0)
    master = _tree(rng)
    kw = dict(b1=0.9, b2=0.95, clip_norm=clip_norm,
              mixed_precision=mixed_precision, weight_decay=weight_decay)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-2, 2, 5), **kw)
    topt = tadamw.AdamW(lr=tadamw.cosine_schedule(1e-2, 2, 5), **kw)
    jp = jax.tree.map(jnp.asarray, master)
    tp = _t(master)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    if mixed_precision:
        jp, tp = jopt.cast_params(jp), topt.cast_params(tp)
    for _ in range(5):
        grads = jax.tree.map(lambda a: a * 3, _tree(rng))
        jg = jax.tree.map(lambda g, p: jnp.asarray(g).astype(p.dtype),
                          grads, jp)
        tg = tree_map(lambda g, p: torch.from_numpy(g).to(p.dtype),
                      grads, tp)
        jp, jstate, jn = jopt.apply(jp, jg, jstate)
        tp, tstate, tn = topt.apply(tp, tg, tstate)
        np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
        for k in ("m", "v") + (("master",) if mixed_precision else ()):
            _close(tstate[k], jstate[k], OPT_TOL)
        assert int(tstate["step"]) == int(jstate["step"])
        if mixed_precision:
            assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
            # the compute copy is the master rounded to bf16, as the JAX one
            _close(tp, jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                    jstate["master"]), OPT_TOL)
        _close(tp, jp, OPT_TOL)
    assert tstate["step"].dtype == torch.int32


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    np.testing.assert_allclose(float(tadamw.global_norm(_t(tree))),
                               float(jadamw.global_norm(tree)), **OPT_TOL)
    for max_norm in (0.5, 1e3):
        jc, jn = jadamw.clip_by_global_norm(tree, max_norm)
        tc, tn = tadamw.clip_by_global_norm(_t(tree), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
        _close(tc, jc, OPT_TOL)


# -- the train step --

def _step_models(name):
    cfg = jregistry.get_config(name, reduced=True)
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32))
    tm = Model(cfg, RunCtx(act_dtype=torch.float32, remat="full"),
               device="cpu")
    return cfg, jm, tm


@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "hymba-1.5b"])
@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_jax(name, accum):
    """One step of each package on the same weights and batch.

    AdamW's ``eps`` is 1e-3 here, above the gradients' scale, so that the
    update is linear in the gradient.  At the default 1e-8 the first step
    divides each gradient element by its own magnitude: where a gradient
    sums terms that cancel to ~1e-8 (expert and attention weights here),
    the two packages' float32 sums differ by ~1e-8 and the parameters by
    up to ``lr``, whatever the port does.  The gradients themselves are
    held against ``jax.grad`` in tests/test_torch_train.py, and AdamW at
    its defaults against the reference's on the same gradients above."""
    cfg, jm, tm = _step_models(name)
    kw = dict(weight_decay=0.01, clip_norm=1.0, eps=1e-3)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 10), **kw)
    topt = tadamw.AdamW(lr=tadamw.cosine_schedule(1e-3, 2, 10), **kw)
    jp = jm.init_params(KEY)
    tp = tm.load_params(model_params_from_reference(cfg, _np(jp)),
                        master=True)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (8, 33)).astype(np.int32)
    batch = (toks[:, :-1], toks[:, 1:])
    jp2, jstate2, jmet = jsteps.build_train_step(
        jm, jopt, accum_steps=accum)(
            jp, jstate, tuple(map(jnp.asarray, batch)))
    tp2, tstate2, tmet = tsteps.build_train_step(
        tm, topt, accum_steps=accum)(
            tp, tstate, tuple(torch.from_numpy(a) for a in batch))
    assert tp2 is tp and tstate2 is tstate          # updated in place
    for k in ("loss", "grad_norm"):
        assert tmet[k].dtype == torch.float32
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   **STEP_TOL)
    _close(tp2, jp2, STEP_TOL)
    for k in ("m", "v"):
        _close(tstate2[k], jstate2[k], STEP_TOL)


def test_train_step_accumulates_bf16_grads_in_float32():
    """Under mixed precision the compute copy's gradients are bf16; the
    microbatch sum runs in float32 (the reference's float32 zeros tree)
    and equals one float32 sum of the same bf16 gradients."""
    cfg = tregistry.get_config("llama3-8b", reduced=True)
    tm = Model(cfg, RunCtx(act_dtype=torch.bfloat16, remat="none"),
               device="cpu")
    opt = tadamw.AdamW(lr=0.0, mixed_precision=True, clip_norm=0.0)
    master = tm.init_params(torch.Generator().manual_seed(0), master=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int64))
    tokens, labels = toks[:, :-1], toks[:, 1:]

    def grads_of(sl):
        p = tree_map(lambda t: t.detach().requires_grad_(True),
                     opt.cast_params(master))
        tm.loss(p, tokens[sl], labels[sl]).backward()
        return [t.grad for t in tree_leaves(p)]

    parts = [grads_of(slice(i, i + 1)) for i in range(4)]
    want = [(sum((g[j].float() for g in parts[1:]), parts[0][j].float())
             / 4) for j in range(len(parts[0]))]
    state = opt.init(opt.cast_params(master))
    _, _, met = tsteps.build_train_step(tm, opt, accum_steps=4)(
        opt.cast_params(master), state, (tokens, labels))
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in want))
    assert float(met["grad_norm"]) == float(norm)


@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "qwen2.5-32b"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_model_flops_equal_jax(name, mode):
    for reduced in (False, True):
        assert tsteps.model_flops(
            tregistry.get_config(name, reduced=reduced), mode=mode,
            batch=8, seq=4096) == jsteps.model_flops(
                jregistry.get_config(name, reduced=reduced), mode=mode,
                batch=8, seq=4096)


def test_train_step_rejects_a_batch_that_does_not_split():
    _, _, tm = _step_models("llama3-8b")
    opt = tadamw.AdamW()
    tp = tm.init_params(torch.Generator().manual_seed(0), master=True)
    toks = torch.zeros((6, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.build_train_step(tm, opt, accum_steps=4)(
            tp, opt.init(tp), (toks, toks))


# -- data pipeline and fault utilities --

@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (256, 64, 8, 0), (128256, 4096, 2, 1), (32768, 256, 8, 7),
    (50, 3, 5, 3)])
def test_synthetic_batches_bit_identical(vocab, seq, batch, seed):
    jd = jpipe.SyntheticLM(vocab, seq, batch, seed=seed)
    td = tpipe.SyntheticLM(vocab, seq, batch, seed=seed)
    for step in (0, 1, 15, 1000):
        for a, b in zip(td.batch_at(step), jd.batch_at(step)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    state = tpipe.DataState(step=3)
    assert tpipe.DataState.from_json(state.to_json()) == state
    it = td.iterate(state)
    next(it), next(it)
    assert state.step == 4
    assert state.to_json() == jpipe.DataState(step=4).to_json()


def test_straggler_watch_and_retrying_match_jax():
    times = [1.0] * 12 + [9.0, 9.5, 9.0, 1.0] + [1.0 + 0.01 * i
                                                  for i in range(5)]
    jw, tw = jfault.StragglerWatch(), tfault.StragglerWatch()
    for dt in times:
        assert tw.observe(dt) == jw.observe(dt)
        assert tw.persistent == jw.persistent

    for mod in (jfault, tfault):
        calls = []

        def flaky(x):
            calls.append(x)
            if len(calls) < 2:
                raise RuntimeError("transient")
            return x * 2

        seen = []
        assert mod.retrying(flaky, retries=1, on_retry=lambda a, e:
                            seen.append(a))(3) == 6
        assert calls == [3, 3] and seen == [0]
        calls.clear()
        with pytest.raises(RuntimeError, match="transient"):
            mod.retrying(flaky, retries=0)(1)
    with tfault.StepTimer("cpu") as t:
        pass
    assert t.dt >= 0.0


def test_dataclass_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tadamw.AdamW)] == \
        [f.name for f in dataclasses.fields(jadamw.AdamW)]
    assert tadamw.AdamW() == tadamw.AdamW(**{
        f.name: getattr(jadamw.AdamW(), f.name)
        for f in dataclasses.fields(jadamw.AdamW)})
