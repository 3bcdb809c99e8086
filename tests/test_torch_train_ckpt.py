"""Checkpoints and optimizer state across the two packages, on the CPU.

A checkpoint written by the JAX ``CheckpointManager`` restores in the port,
and one written by the port restores in JAX, arrays and extra state bit
for bit, in the reference's on-disk format (``step_N.tmp`` renamed to
``step_N``, ``arrays.npz`` under the reference's keys, ``manifest.json``).
The reference's AdamW state, carried across by
``convert.opt_state_from_reference``, continues: one port step from it
equals one JAX step: parameters and moments within 1e-6, the gradient's
global norm within 1e-5 (a float32 sum of ~10^5 squares, in another order
than XLA's).
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import registry as jregistry
from repro.models.transformer import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs.registry import get_config
from repro_torch.convert import (model_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.models.transformer import Model, RunCtx, tree_leaves
from repro_torch.models.transformer import tree_map
from repro_torch.optim import adamw as tadamw

OPT_TOL = dict(rtol=1e-6, atol=1e-6)
NORM_TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(name="mixtral-8x22b", mixed_precision=False, steps=2):
    """A reduced model's params and the reference AdamW state after
    ``steps`` steps of random gradients."""
    cfg = jregistry.get_config(name, reduced=True)
    jp = JModel(cfg, JRunCtx(remat="none",
                             act_dtype=jnp.float32)).init_params(KEY)
    opt = jadamw.AdamW(lr=1e-2, weight_decay=0.01,
                       mixed_precision=mixed_precision)
    state = opt.init(jp)
    if mixed_precision:
        jp = opt.cast_params(jp)
    for i in range(steps):
        grads = jax.tree.map(
            lambda p, i=i: jax.random.normal(jax.random.PRNGKey(i + 1),
                                             p.shape, p.dtype), jp)
        jp, state, _ = opt.apply(jp, grads, state)
    return cfg, opt, jp, state


def _equal(got_tree, want_tree):
    got = tree_leaves(got_tree)
    want = jax.tree.leaves(_np(want_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def _port_tree(cfg, jp, state):
    return {"params": model_params_from_reference(cfg, _np(jp)),
            "opt": opt_state_from_reference(cfg, _np(state))}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    cfg, _, jp, state = _jax_state()
    jm = jckpt.CheckpointManager(str(tmp_path), save_every=5)
    assert jm.maybe_save(5, {"params": jp, "opt": state},
                         extra={"data": {"step": 5}})
    jm.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_5"]
    target = tree_map(torch.zeros_like, _port_tree(cfg, jp, state))
    step, tree, extra = tckpt.CheckpointManager(
        str(tmp_path)).restore_latest(target)
    assert step == 5 and extra == {"data": {"step": 5}}
    _equal(tree["params"], jp)
    _equal({k: v for k, v in tree["opt"].items() if k != "step"},
           {k: v for k, v in state.items() if k != "step"})
    assert tree["opt"]["step"].dtype == torch.int32
    assert int(tree["opt"]["step"]) == int(state["step"]) == 2


@pytest.mark.parametrize("blocking", [True, False])
def test_port_checkpoint_restores_in_jax(tmp_path, blocking):
    cfg, _, jp, state = _jax_state()
    tree = _port_tree(cfg, jp, state)
    t = tckpt.save(str(tmp_path), 7, tree, extra={"data": {"step": 7}},
                   blocking=blocking)
    if t is not None:
        t.join()
    assert sorted(os.listdir(tmp_path)) == ["step_7"]
    assert sorted(os.listdir(tmp_path / "step_7")) == ["arrays.npz",
                                                       "manifest.json"]
    # the reference's keys and manifest for the same tree
    jckpt.save(str(tmp_path / "ref"), 7, {"params": jp, "opt": state},
               extra={"data": {"step": 7}})
    for name in ("manifest.json",):
        with open(tmp_path / "step_7" / name) as a, \
                open(tmp_path / "ref" / "step_7" / name) as b:
            assert json.load(a) == json.load(b)
    assert tckpt.latest_step(str(tmp_path)) == jckpt.latest_step(
        str(tmp_path)) == 7
    got, extra = jckpt.restore(str(tmp_path), 7, {"params": jp,
                                                  "opt": state})
    assert extra == {"data": {"step": 7}}
    _equal(tree["params"], got["params"])
    _equal(tree["opt"], got["opt"])


def test_restore_places_on_the_target_device_and_dtype(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16),
                  torch.tensor(3, dtype=torch.int32)]}
    tckpt.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "step_1" / "arrays.npz") as data:
        assert sorted(data.files) == ["['a']", "['b']||[0]", "['b']||[1]"]
        assert data["['b']||[0]"].dtype == np.float32   # numpy: no bf16
    target = {"a": torch.zeros((2, 3), dtype=torch.float64),
              "b": [torch.zeros(2, dtype=torch.bfloat16),
                    torch.zeros((), dtype=torch.int32)]}
    got, extra = tckpt.restore(str(tmp_path), 1, target)
    assert extra == {}
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], tree["a"].double())
    assert got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["b"][0], tree["b"][0])
    assert int(got["b"][1]) == 3
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path), 1, {"a": torch.zeros(6), "b": target[
            "b"]})


def test_manager_keeps_the_last_and_commits_async(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_last=2, save_every=2)
    tree = {"w": torch.zeros(3)}
    saved = [s for s in range(7) if mgr.maybe_save(s, tree)]
    assert saved == [2, 4, 6]
    assert mgr.maybe_save(7, tree, force=True)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_6", "step_7"]
    assert mgr.restore_latest(tree)[0] == 7
    assert tckpt.CheckpointManager(str(tmp_path / "none")).restore_latest(
        tree) == (None, None, None)


def test_async_save_holds_the_state_of_its_step(tmp_path, monkeypatch):
    """An async commit held open across the next train step (a ``np.savez``
    that waits) writes the step-N state, not a mix of steps N and N+1:
    ``AdamW.apply`` updates params and moments in place, and on the CPU a
    tensor's ``.cpu()`` is itself, so the snapshot must copy."""
    from repro_torch.launch import train as T

    args = T.parse_args(["--device", "cpu", "--arch", "llama3-8b",
                         "--reduced", "--batch", "2", "--seq", "16",
                         "--lr", "1e-2", "--warmup", "1",
                         "--ckpt-dir", str(tmp_path)])
    tr = T.setup(get_config("llama3-8b", reduced=True), args)
    tr.step()
    want = tree_map(lambda t: t.clone(), {"params": tr.params,
                                          "opt": tr.opt_state})
    release, entered = threading.Event(), threading.Event()
    savez = np.savez

    def held_savez(*a, **kw):
        entered.set()
        assert release.wait(60)
        return savez(*a, **kw)

    monkeypatch.setattr(np, "savez", held_savez)
    tr.save(1, force=True)
    assert entered.wait(60)
    tr.step()
    assert not torch.equal(tr.params["embed"]["w"],
                           want["params"]["embed"]["w"])
    release.set()
    tr.mgr.wait()
    got, _ = tckpt.restore(str(tmp_path), 1, tree_map(torch.zeros_like,
                                                      want))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_converted_opt_state_continues_the_jax_run(mixed_precision):
    """JAX ``AdamW.init``/``apply`` state -> the port's trees -> one port
    step equals one JAX step."""
    cfg, jopt, jp, state = _jax_state("llama3-8b", mixed_precision)
    topt = tadamw.AdamW(lr=1e-2, weight_decay=0.01,
                        mixed_precision=mixed_precision)
    tstate = opt_state_from_reference(cfg, _np(state))
    assert set(tstate) == set(state)
    tm = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    tp = tm.load_params(model_params_from_reference(
        cfg, _np(jax.tree.map(lambda a: a.astype(jnp.float32), jp))),
        master=True)
    if mixed_precision:
        tp = topt.cast_params(tp)
    grads = jax.tree.map(lambda p: jax.random.normal(
        jax.random.PRNGKey(9), p.shape, p.dtype), jp)
    jp2, state2, jn = jopt.apply(jp, grads, state)
    tp2, tstate2, tn = topt.apply(
        tp, tree_map(lambda g, p: torch.from_numpy(
            np.array(g, np.float32)).to(p.dtype), _np(grads), tp), tstate)
    np.testing.assert_allclose(float(tn), float(jn), **NORM_TOL)
    assert int(tstate2["step"]) == int(state2["step"]) == 3
    for got, want in ((tp2, jp2), (tstate2["m"], state2["m"]),
                      (tstate2["v"], state2["v"])) + (
            ((tstate2["master"], state2["master"]),) if mixed_precision
            else ()):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32), **OPT_TOL)
    with pytest.raises(ValueError, match="stacked"):
        opt_state_from_reference(cfg, {
            "m": dict(_np(state["m"]), layers=jax.tree.map(
                lambda a: np.asarray(a)[0], _np(state["m"]["layers"]))),
            "v": _np(state["v"]), "step": 1})
