"""The port's MoE and GNN consumers (``repro_torch.models.moe``,
``repro_torch.models.gnn``) and its copy of ``data/skewed.py`` against the
JAX reference and the reference's numpy oracles.

* ``moe_fwd`` within 1e-5 of the JAX ``moe_fwd`` in float32, on weights
  carried across by ``convert.model_params_from_reference``, with and
  without capacity drops; tied router logits pick the experts
  ``lax.top_k`` picks;
* ``MoEDispatchGather`` on every rung × materialization bit for bit
  against ``moe_dispatch_ref``;
* ``MoECombineScatter`` and ``MoELayer`` against ``moe_combine_ref``: bit
  for bit on integer-valued data, within 1e-6 otherwise, and ``MoELayer``
  bit for bit with its composed path.  The JAX classes fail on this tree
  (``ShardingTypeError`` in ``MoECombineScatter``), so the numpy oracles
  stand in for them;
* ``DynamicMoELayer`` within 1e-5 of the JAX ``DynamicMoELayer`` (eight
  devices: the JAX side runs once in a subprocess of this file, ``python
  tests/test_torch_moe.py OUT``) and bit for bit with the port's
  host-planned composed path, over several routings through one layer;
* ``GNNNeighborAggregate`` within 1e-5 of ``gnn_ref_np`` and of the JAX
  layer on every rung;
* ``random_neighbors`` and ``data.skewed``'s arrays equal the reference's.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

P = 8
N_TOK, D, F, K, E, CAP = 64, 8, 16, 2, 8, 16
ROUTING_SEEDS = (1, 2, 3)
GNN_N, GNN_R, GNN_D = 256, 6, 8
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")
TOL = dict(rtol=1e-5, atol=1e-5)


def _moe_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32),
            "w2": (rng.standard_normal((E, F, D)) * 0.3).astype(np.float32),
            "w3": (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32)}


def _tokens(seed=9):
    return np.random.default_rng(seed).standard_normal(
        (N_TOK, D)).astype(np.float32)


def _graph():
    from repro_torch.models.gnn import random_neighbors
    nbrs = random_neighbors(GNN_N, GNN_R, alpha=1.1, seed=4)
    h = np.random.default_rng(6).standard_normal(
        (GNN_N, GNN_D)).astype(np.float32)
    return nbrs, h


def run_reference(out_path: str) -> None:
    """The JAX DynamicMoELayer and GNN layer on eight devices."""
    import jax

    from repro.core import perfmodel as jpm
    from repro.models.gnn import GNNNeighborAggregate
    from repro.models.moe import DynamicMoELayer, random_router

    assert len(jax.devices()) == P, jax.devices()
    mesh = jax.make_mesh((P,), ("data",))
    out = {}
    params = _moe_params()
    te, _ = random_router(0, N_TOK, E, K)
    layer = DynamicMoELayer(params, te, N_TOK, E, CAP, mesh,
                            act="swiglu", strategy="auto", hw=jpm.ABEL)
    out["dyn_strategies"] = np.array(
        [layer.strategies["dispatch"], layer.strategies["combine"]])
    x = _tokens()
    for seed in ROUTING_SEEDS:
        te2, tw2 = random_router(seed, N_TOK, E, K)
        out[f"dyn_{seed}"] = np.asarray(layer(layer.shard_tokens(x), te2,
                                              tw2))
    nbrs, h = _graph()
    for strategy in STRATEGIES + ("auto",):
        g = GNNNeighborAggregate(nbrs, GNN_N, mesh, strategy=strategy,
                                 hw=jpm.ABEL, use_plan_cache=False)
        out[f"gnn_{strategy}"] = np.asarray(g(g.shard_features(h)))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_moe") / "ref.npz"
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               REPRO_PLAN_CACHE="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(autouse=True)
def own_plan_cache(tmp_path, monkeypatch):
    from repro_torch.comm import plan_cache
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    plan_cache.clear_memory_cache()
    yield
    plan_cache.clear_memory_cache()


@pytest.fixture(scope="module")
def comm():
    from repro_torch.comm.communicator import LoopbackComm
    return LoopbackComm(P, device="cpu")


# ---- moe_fwd ---------------------------------------------------------------

def _moe_cfg(pkg, e=4, k=2, cf=8.0, act="swiglu"):
    return pkg.ArchConfig(
        name="t", family="moe", num_layers=2, d_model=16, num_heads=2,
        num_kv_heads=2, d_ff=32, vocab_size=64, num_experts=e,
        experts_per_token=k, capacity_factor=cf, act=act)


def _jax_moe_model(e, k, cf, act, seed=0):
    """The JAX model's parameters and the port's copy of them."""
    import jax

    from repro.configs import base as jbase
    from repro.models.transformer import Model as JModel
    from repro_torch.configs import base as tbase
    from repro_torch.convert import model_params_from_reference

    jcfg = _moe_cfg(jbase, e, k, cf, act)
    tcfg = _moe_cfg(tbase, e, k, cf, act)
    jp = jax.tree.map(np.asarray,
                      JModel(jcfg).init_params(jax.random.PRNGKey(seed)))
    tp = model_params_from_reference(tcfg, jp)
    return jcfg, tcfg, jp["layers"]["moe"], tp["layers"]["moe"]


@pytest.mark.parametrize("g,t,e,k,cf,act", [
    (1, 32, 4, 2, 4.0, "swiglu"), (2, 16, 4, 1, 4.0, "swiglu"),
    (1, 64, 8, 2, 8.0, "gelu"), (1, 64, 8, 2, 1.25, "swiglu"),
    (2, 48, 8, 2, 0.5, "gelu"), (1, 40, 4, 3, 1.0, "swiglu")])
def test_moe_fwd_matches_jax(g, t, e, k, cf, act):
    """Within 1e-5 in float32, with no drops (cf = E) and with the
    capacity dropping choices (cf < 1.25), on every layer's weights."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import moe as JM
    from repro_torch.models import moe as TM

    jcfg, tcfg, jmoe, tmoe = _jax_moe_model(e, k, cf, act)
    x = np.random.default_rng(t).standard_normal(
        (g, t, tcfg.d_model)).astype(np.float32)
    for layer in range(tcfg.num_layers):
        jl = jax.tree.map(lambda a: jnp.asarray(a[layer]), jmoe)
        tl = {k_: (v[layer] if not isinstance(v, dict)
                   else {kk: vv[layer] for kk, vv in v.items()})
              for k_, v in tmoe.items()}
        want = np.asarray(JM.moe_fwd(jl, jnp.asarray(x), jcfg))
        got = TM.moe_fwd(tl, torch.as_tensor(x), tcfg).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_tied_router_logits_pick_the_lower_index():
    """Router columns that repeat give exactly tied logits: ``top_k``
    keeps ``lax.top_k``'s order (ties to the lower index), and moe_fwd
    then matches the JAX one, where ``torch.topk`` leaves the order open."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import moe as JM
    from repro_torch.models import moe as TM

    rng = np.random.default_rng(3)
    probs = rng.integers(0, 3, (4, 50, 8)).astype(np.float32)
    jv, je = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, te = TM.top_k(torch.as_tensor(probs), 3)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    jcfg, tcfg, jmoe, tmoe = _jax_moe_model(8, 2, 8.0, "swiglu")
    w = np.asarray(jmoe["router"]["w"][0]).copy()
    w[:, 4:] = w[:, :4]                 # experts 4-7 tie with 0-3
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), jmoe)
    jl["router"]["w"] = jnp.asarray(w)
    tl = {k_: (v[0] if not isinstance(v, dict) else {"w": torch.as_tensor(w)})
          for k_, v in tmoe.items()}
    x = rng.standard_normal((1, 32, tcfg.d_model)).astype(np.float32)
    logits = x @ w
    assert (logits[..., :4] == logits[..., 4:]).all()
    want = np.asarray(JM.moe_fwd(jl, jnp.asarray(x), jcfg))
    got = TM.moe_fwd(tl, torch.as_tensor(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---- the exchange consumers ------------------------------------------------

def _routing(seed=1, k=K, int_weights=False):
    from repro_torch.models.moe import random_router
    te, tw = random_router(seed, N_TOK, E, k)
    if int_weights:
        tw = np.random.default_rng(seed).integers(
            1, 4, tw.shape).astype(np.float32)
    return te, tw


@pytest.mark.parametrize("materialize", ["dest", "full"])
@pytest.mark.parametrize("strategy", STRATEGIES + ("auto",))
def test_dispatch_gather_bit_identical(comm, strategy, materialize):
    from repro_torch.core import perfmodel as pm
    from repro_torch.models import moe as TM

    te, _ = _routing(k=3)
    idx, valid = TM.moe_dispatch_pattern(te, N_TOK, E, 8, P)
    x = _tokens()
    want = TM.moe_dispatch_ref(x, idx, valid, E, 8)
    g = TM.MoEDispatchGather(te, N_TOK, E, 8, comm, strategy=strategy,
                             materialize=materialize, hw=pm.ABEL)
    got = g(g.shard_tokens(x))
    assert tuple(got.shape) == (P, E // P, 8, D)
    np.testing.assert_array_equal(got.reshape(E, 8, D).numpy(), want)
    assert g.counts is g.plan.counts


@pytest.mark.parametrize("data", ["integer", "float"])
@pytest.mark.parametrize("strategy", STRATEGIES + ("auto",))
def test_combine_scatter_matches_the_oracle(comm, strategy, data):
    from repro_torch.core import perfmodel as pm
    from repro_torch.models import moe as TM

    integer = data == "integer"
    te, tw = _routing(k=3, int_weights=integer)
    rng = np.random.default_rng(2)
    buf = (rng.integers(-4, 5, (E, CAP, D)) if integer
           else rng.standard_normal((E, CAP, D))).astype(np.float32)
    c = TM.MoECombineScatter(te, tw, N_TOK, E, CAP, comm, strategy=strategy,
                             hw=pm.ABEL)
    want = TM.moe_combine_ref(buf, c.idx, c.valid, c.w_slot, N_TOK)
    got = c(c.shard_expert_buf(buf)).reshape(N_TOK, D).numpy()
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert c.counts is c.splan.counts


def _composed(comm, te, tw, params, x, strategy, act="swiglu"):
    """MoEDispatchGather(full) → moe_expert_local → MoECombineScatter."""
    import torch

    from repro_torch.models import moe as TM

    g = TM.MoEDispatchGather(te, N_TOK, E, CAP, comm, strategy=strategy,
                             materialize="full", use_plan_cache=False)
    buf = g(g.shard_tokens(x))
    w = [torch.as_tensor(params[k]).reshape((P, -1) + params[k].shape[1:])
         for k in ("w1", "w2", "w3")]
    out = TM.moe_expert_local(buf, w[0], w[1], w[2] if act == "swiglu"
                              else None, act)
    c = TM.MoECombineScatter(te, tw, N_TOK, E, CAP, comm, strategy=strategy,
                             use_plan_cache=False)
    return c(out), buf, out, c


@pytest.mark.parametrize("strategy", STRATEGIES + ("auto",))
def test_moe_layer_matches_composed_path_and_oracle(comm, strategy):
    import torch

    from repro_torch.core import perfmodel as pm
    from repro_torch.models import moe as TM

    params, x = _moe_params(), _tokens()
    te, tw = _routing()
    layer = TM.MoELayer(params, te, tw, N_TOK, E, CAP, comm, act="swiglu",
                        strategy=strategy, hw=pm.ABEL)
    y = layer(layer.shard_tokens(x))
    rung = layer.strategies["dispatch"]
    want, buf, out, c = _composed(comm, te, tw, params, x, rung)
    assert torch.equal(y, want)
    ref = TM.moe_combine_ref(out.reshape(E, CAP, D).numpy(), c.idx, c.valid,
                             c.w_slot, N_TOK)
    np.testing.assert_allclose(y.reshape(N_TOK, D).numpy(), ref, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seed", ROUTING_SEEDS)
def test_dynamic_moe_layer_matches_jax_and_host_planned_path(
        comm, reference, seed):
    """One layer serves every routing: within 1e-5 of the JAX
    DynamicMoELayer, and bit for bit with the port's host-planned composed
    path at the layer's rung; each call records one device derivation and
    no host build."""
    import torch

    from repro_torch.comm import telemetry
    from repro_torch.core import perfmodel as pm
    from repro_torch.models import moe as TM

    params, x = _moe_params(), _tokens()
    te0, _ = TM.random_router(0, N_TOK, E, K)
    layer = TM.DynamicMoELayer(params, te0, N_TOK, E, CAP, comm,
                               act="swiglu", strategy="auto", hw=pm.ABEL)
    assert list(layer.strategies.values()) == list(
        reference["dyn_strategies"])
    te, tw = TM.random_router(seed, N_TOK, E, K)
    with telemetry.isolated() as tel:
        y = layer(layer.shard_tokens(x), te, tw)
        assert tel.sources["device-derive"] == 1
        assert tel.sources["host-build"] == 0
    np.testing.assert_allclose(y.reshape(N_TOK, D).numpy(),
                               reference[f"dyn_{seed}"], **TOL)
    want, *_ = _composed(comm, te, tw, params, x,
                         layer.strategies["dispatch"])
    assert torch.equal(y, want)
    # apply: the weights per call, tokens and output (T, d)
    w = [torch.as_tensor(params[k]) for k in ("w1", "w2", "w3")]
    ya = layer.apply(torch.as_tensor(x), torch.as_tensor(te),
                     torch.as_tensor(tw), *w)
    assert torch.equal(ya, y.reshape(N_TOK, D))
    with pytest.raises(ValueError, match="expert weight"):
        layer.apply(torch.as_tensor(x), te, tw, w[0])


def test_dynamic_moe_layer_pieces_and_telemetry(comm):
    """The step's pieces compose to the step; the derived slot table equals
    the host packing; the layer's plan_time prices a device derivation."""
    import torch

    from repro_torch.core import perfmodel as pm
    from repro_torch.models import moe as TM

    params, x = _moe_params(), _tokens()
    te, tw = _routing(seed=5)
    layer = TM.DynamicMoELayer(params, te, N_TOK, E, CAP, comm,
                               act="swiglu", strategy="condensed",
                               hw=pm.ABEL, decode=True)
    assert layer.decode and layer.gather.decode and layer.scatter.decode
    assert layer.plan_time == pm.plan_build_time(E * CAP, 1, pm.ABEL,
                                                 source="device-derive")
    cols, w_slot = layer.pack(torch.as_tensor(te), torch.as_tensor(tw))
    idx, valid = TM.moe_dispatch_pattern(te, N_TOK, E, CAP, P)
    np.testing.assert_array_equal(cols.numpy(), idx)
    np.testing.assert_array_equal(
        w_slot.numpy(), TM.moe_combine_weights(te, tw, N_TOK, E, CAP) * valid)
    gargs, sargs = layer.derive(cols)
    xs = layer.shard_tokens(x)
    y = layer.combine(layer.experts(layer.dispatch(xs, cols, gargs), w_slot,
                                    layer._weights), sargs)
    assert torch.equal(y, layer(xs, te, tw))


# ---- GNN ------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES + ("auto",))
def test_gnn_matches_oracle_and_jax(comm, reference, strategy):
    from repro_torch.core import perfmodel as pm
    from repro_torch.models.gnn import GNNNeighborAggregate, gnn_ref_np

    nbrs, h = _graph()
    layer = GNNNeighborAggregate(nbrs, GNN_N, comm, strategy=strategy,
                                 hw=pm.ABEL)
    got = layer(layer.shard_features(h))
    assert tuple(got.shape) == (P, GNN_N // P, GNN_D)
    got = got.reshape(GNN_N, GNN_D).numpy()
    np.testing.assert_allclose(got, gnn_ref_np(h, nbrs), **TOL)
    np.testing.assert_allclose(got, reference[f"gnn_{strategy}"], **TOL)
    if strategy != "auto":
        assert set(layer.strategies.values()) == {strategy}
    assert layer.predicted_window is not None or strategy != "auto"


def test_gnn_bfloat16_accumulates_in_float32(comm):
    import torch

    from repro_torch.models.gnn import GNNNeighborAggregate, gnn_ref_np

    nbrs, h = _graph()
    hb = torch.as_tensor(h).to(torch.bfloat16)
    layer = GNNNeighborAggregate(nbrs, GNN_N, comm, strategy="condensed")
    got = layer(hb.reshape(P, -1, GNN_D))
    assert got.dtype == torch.bfloat16
    want = gnn_ref_np(hb.float().numpy(), nbrs)
    np.testing.assert_allclose(got.float().reshape(GNN_N, GNN_D).numpy(),
                               want, rtol=2e-2, atol=2e-2)
    with pytest.raises(AssertionError, match="nbrs"):
        GNNNeighborAggregate(np.zeros((8, 2), np.int32), 16, comm)


@pytest.mark.parametrize("alpha", [0.0, 0.8, 1.1])
def test_random_neighbors_and_skewed_equal_the_reference(alpha):
    from repro.data import skewed as jsk
    from repro.models.gnn import random_neighbors as j_neighbors
    from repro_torch.data import skewed as tsk
    from repro_torch.models.gnn import random_neighbors

    np.testing.assert_array_equal(random_neighbors(300, 5, alpha=alpha,
                                                   seed=2),
                                  j_neighbors(300, 5, alpha=alpha, seed=2))
    np.testing.assert_array_equal(tsk.zipf_column_weights(500, alpha, seed=3),
                                  jsk.zipf_column_weights(500, alpha, seed=3))
    tm = tsk.make_powerlaw_matrix(512, 8, alpha=alpha, seed=4)
    jm = jsk.make_powerlaw_matrix(512, 8, alpha=alpha, seed=4)
    for f in ("diag", "vals", "cols"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    assert tsk.skew_summary(tm.cols, 512, 8) == jsk.skew_summary(
        jm.cols, 512, 8)


if __name__ == "__main__":
    run_reference(sys.argv[1])
