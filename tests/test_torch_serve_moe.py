"""The port's MoE serving path against the JAX reference on the CPU.

On the reduced mixtral-8x22b of the reference's own test (8 experts,
full attention, a capacity that drops nothing, float32), with the
reference's weights carried across:

* the port's ``ServeEngine`` with the ``DynamicMoELayer`` decode hook
  (``launch.serve.build_moe_layer`` over ``LoopbackComm(8)``) emits the
  JAX engine's tokens exactly — the JAX side needs eight devices, so it
  runs once in a subprocess of this file (``python
  tests/test_torch_serve_moe.py OUT``) — and its own
  ``generate_batch_loop``'s with the same hook;
* after a warm-up batch ``assert_steady_state`` holds: no host plan
  build, one device derivation per layer per decode tick;
* the hook's decode step is within 2e-4 of the same step through
  ``moe_fwd``, the fused prefill of a moe stack within 2e-4 of the
  sequential ``prefill_into_cache`` (the reference's bit-for-bit version
  of that test fails on this tree: two summation orders);
* sliding-window attention runs while no position reaches the window and
  raises (ROADMAP A11) at the step that would.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

NUM_SLOTS, CACHE_LEN, CHUNK = 8, 16, 4
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfg(registry):
    cfg = registry.get_config("mixtral-8x22b", reduced=True)
    # experts divide the ranks, full attention, no-drop capacity
    return dataclasses.replace(cfg, num_experts=8, swa_window=0,
                               capacity_factor=8.0 / cfg.experts_per_token)


def _batch(cfg, rng, tag, gen):
    return [dict(id=f"{tag}{i}", prompt=rng.integers(
        0, cfg.vocab_size, (8,)).tolist(), max_new_tokens=gen,
        arrival_time=float(i // 4)) for i in range(8)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def run_reference(out_dir: str) -> None:
    """The JAX engine with the MoE hook on eight devices, as the
    reference's own acceptance test drives it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.launch.mesh import make_local_mesh
    from repro.launch.serve import build_moe_layer
    from repro.models.transformer import Model, RunCtx
    from repro.serve import Request, ServeEngine

    assert len(jax.devices()) == 8, jax.devices()
    cfg = _cfg(registry)
    model = Model(cfg, RunCtx(remat="none", act_dtype=jnp.float32))
    params = model.init_params(jax.random.PRNGKey(0))
    layer = build_moe_layer(model, params, NUM_SLOTS,
                            make_local_mesh((8,), ("data",)))
    engine = ServeEngine(model, params, num_slots=NUM_SLOTS,
                         cache_len=CACHE_LEN, prefill_chunk=CHUNK,
                         moe_layer=layer, cache_dtype=jnp.float32)
    rng = np.random.default_rng(2)
    out = {"strategies": layer.strategies}
    for tag, gen in (("warm", 2), ("req", 4)):
        reqs = _batch(cfg, rng, tag, gen)
        for r in reqs:
            engine.submit(Request(**r))
        out[tag] = {"requests": reqs, "outputs": engine.run().outputs}
    np.savez(pathlib.Path(out_dir) / "params.npz",
             **_flat(jax.tree.map(np.asarray, params)))
    (pathlib.Path(out_dir) / "out.json").write_text(json.dumps(out))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_serve_moe")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               REPRO_PLAN_CACHE="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "params.npz") as data:
        params = _unflat({k: data[k] for k in data.files})
    return json.loads((out / "out.json").read_text()), params


@pytest.fixture(autouse=True)
def own_plan_cache(tmp_path, monkeypatch):
    from repro_torch.comm import plan_cache
    from repro_torch.kernels import ops as tops
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    plan_cache.clear_memory_cache()
    tops.reset_launch_counts()
    yield
    plan_cache.clear_memory_cache()
    assert not any(tops.launch_counts().values()), tops.launch_counts()


@pytest.fixture(scope="module")
def port(reference):
    import torch

    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.configs import registry
    from repro_torch.convert import model_params_from_reference
    from repro_torch.launch.serve import build_moe_layer
    from repro_torch.models.transformer import Model, RunCtx

    _, jparams = reference
    cfg = _cfg(registry)
    model = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    params = model.load_params(model_params_from_reference(cfg, jparams))
    layer = build_moe_layer(model, params, NUM_SLOTS,
                            LoopbackComm(8, device="cpu"))
    return cfg, model, params, layer


def test_engine_with_the_moe_hook_emits_the_jax_tokens(reference, port):
    import torch

    from repro_torch.serve import Request, ServeEngine, generate_batch_loop

    ref, _ = reference
    cfg, model, params, layer = port
    assert layer.decode and layer.gather.decode and layer.scatter.decode
    assert set(layer.strategies.values()) <= {"condensed", "overlap"}
    engine = ServeEngine(model, params, num_slots=NUM_SLOTS,
                         cache_len=CACHE_LEN, prefill_chunk=CHUNK,
                         moe_layer=layer, cache_dtype=torch.float32)
    assert engine.model.ctx.moe_step is not None
    for r in ref["warm"]["requests"]:
        engine.submit(Request(**r))
    assert engine.run().outputs == ref["warm"]["outputs"]
    snap = engine.snapshot()
    reqs = [Request(**r) for r in ref["req"]["requests"]]
    for r in reqs:
        engine.submit(r)
    rep = engine.run()
    delta = engine.assert_steady_state(snap)
    assert delta["host-build"] == 0 and delta["decode_steps"] > 0
    assert delta["device-derive"] == cfg.num_layers * delta["decode_steps"]
    assert rep.outputs == ref["req"]["outputs"]
    base = generate_batch_loop(model, params, reqs, cache_len=CACHE_LEN,
                               prefill_chunk=CHUNK, moe_layer=layer,
                               cache_dtype=torch.float32)
    assert {r.id: rep.outputs[r.id] for r in reqs} == base


def test_engine_refuses_a_mismatched_layer_or_family(port):
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.transformer import Model, RunCtx
    from repro_torch.serve import ServeEngine

    cfg, model, params, layer = port
    with pytest.raises(ValueError, match="num_tokens"):
        ServeEngine(model, params, num_slots=4, cache_len=CACHE_LEN,
                    moe_layer=layer)
    dense = Model(registry.get_config("llama3-8b", reduced=True),
                  RunCtx(act_dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="MoE model"):
        ServeEngine(dense, {}, num_slots=NUM_SLOTS, cache_len=CACHE_LEN,
                    moe_layer=layer)


def test_assert_steady_state_sees_a_host_build(port):
    import torch

    from repro_torch.comm import telemetry
    from repro_torch.serve import ServeEngine

    cfg, model, params, layer = port
    engine = ServeEngine(model, params, num_slots=NUM_SLOTS,
                         cache_len=CACHE_LEN, moe_layer=layer,
                         cache_dtype=torch.float32)
    snap = engine.snapshot()
    telemetry.record_tick("decode_steps")
    assert engine.assert_steady_state(snap)["host-build"] == 0
    telemetry.record("host-build", 0.0)
    with pytest.raises(AssertionError, match="host plan builds"):
        engine.assert_steady_state(snap)


def test_hook_decode_step_matches_moe_fwd(port):
    """One decode step over a prefilled per-slot cache: through the hook
    and through ``moe_fwd`` (the model without it), within 2e-4."""
    import torch

    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import _with_moe_hook

    cfg, model, params, layer = port
    hooked = _with_moe_hook(model, layer)
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (NUM_SLOTS, 6)), dtype=torch.int32)
    logits = {}
    for name, m in (("hook", hooked), ("moe_fwd", model)):
        assert isinstance(m, Model)
        cache = m.init_cache(NUM_SLOTS, CACHE_LEN, per_slot=True,
                             dtype=torch.float32)
        _, cache = m.prefill(params, cache, tokens)
        logits[name], _ = m.decode_step(params, cache, tokens[:, :1])
    np.testing.assert_allclose(logits["hook"].numpy(),
                               logits["moe_fwd"].numpy(), **TOL)


def test_fused_prefill_of_a_moe_stack_matches_the_sequential_oracle(port):
    import torch

    from repro_torch.launch.serve import prefill_into_cache

    cfg, model, params, _ = port
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 9)), dtype=torch.int32)
    fused_cache = model.init_cache(2, CACHE_LEN, dtype=torch.float32)
    seq_cache = model.init_cache(2, CACHE_LEN, dtype=torch.float32)
    fused, fused_cache = model.prefill(params, fused_cache, tokens)
    seq_cache, seq = prefill_into_cache(model, params, seq_cache, tokens)
    np.testing.assert_allclose(fused.numpy(), seq.numpy(), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(fused_cache["layers"][key].numpy(),
                                   seq_cache["layers"][key].numpy(), **TOL)


def test_sliding_window_runs_until_a_position_reaches_it():
    """mixtral's reduced window (16): the cache is cut to the window, the
    steps run while every position stays below it — the same logits as
    the model without a window — and the step that would write position
    16 raises naming ROADMAP A11."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.transformer import Model, RunCtx

    cfg = registry.get_config("mixtral-8x22b", reduced=True)
    assert cfg.swa_window == 16
    model = Model(cfg, RunCtx(act_dtype=torch.float32), device="cpu")
    full = Model(dataclasses.replace(cfg, swa_window=0),
                 RunCtx(act_dtype=torch.float32), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 64, per_slot=True, dtype=torch.float32)
    assert cache["layers"]["k"].shape[2] == cfg.swa_window
    ref = full.init_cache(2, 16, per_slot=True, dtype=torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)), dtype=torch.int32)
    got, cache = model.prefill(params, cache, tokens)
    want, ref = full.prefill(params, ref, tokens)
    assert torch.equal(got, want)
    tok = tokens[:, :1]
    for _ in range(4):                          # positions 12 .. 15
        got, cache = model.decode_step(params, cache, tok)
        want, ref = full.decode_step(params, ref, tok)
        assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="A11"):
        model.decode_step(params, cache, tok)   # position 16
    fresh = model.init_cache(1, 64, per_slot=True, dtype=torch.float32)
    _, fresh = model.prefill(params, fresh, tokens[:1, :10])
    with pytest.raises(NotImplementedError, match="A11"):
        model.prefill(params, fresh, tokens[:1, :7])   # positions 10 .. 16


def test_launch_serve_moe_comm_on_the_cpu():
    """``--moe-comm`` over ``--mesh 8`` (and ``local``: one rank on the
    CPU) serves every request; ``--experts`` overrides the expert count;
    a 2-D mesh and a dense architecture are refused."""
    from repro_torch.launch import serve as tserve

    base = ["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu",
            "--requests", "8", "--slots", "8", "--prompt-len", "10",
            "--gen", "3", "--prefill-chunk", "4", "--moe-comm"]
    rep = tserve.main(base + ["--experts", "8", "--mesh", "8"])
    assert len(rep.completed) == 8 and rep.total_tokens == 24
    assert rep.telemetry["device-derive"] == 2 * rep.telemetry[
        "decode_steps"]
    rep = tserve.main(base + ["--mesh", "local"])
    assert len(rep.completed) == 8
    with pytest.raises(ValueError, match="one axis"):
        tserve.main(base + ["--experts", "8", "--mesh", "2x4"])
    with pytest.raises(ValueError, match="MoE architecture"):
        tserve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                     "--moe-comm"])


if __name__ == "__main__":
    run_reference(sys.argv[1])
