"""``launch.train --mesh 2``: data parallelism over two gloo processes.

Reduced llama3-8b (dense) and falcon-mamba-7b (ssm), float32, batch 4 of
32 tokens.  Two processes spawn from this file (``python
tests/test_torch_train_dp.py RANK 2 INIT OUT``) and, in one gloo group,
for each arch:

* train two steps through ``launch.train.setup`` at ``--mesh 2`` with
  checkpoints every step (rank 0 writes them), and write their parameters
  and AdamW state, each leaf assembled whole from the ranks' FSDP parts;
* take one ``build_train_step`` step over a ``DistComm`` from the
  reference's weights (``convert.model_params_from_reference``), each on
  its half of the batch.

In this process the same steps run at ``--mesh local --accum 2``:

* every parameter after each DP step equals the local step's bit for bit
  on both ranks (``build_grad_fn`` sums its microbatches in order and
  divides; ``mean_over_ranks`` sums the ranks in order and divides);
* the DP checkpoint resumes at ``--mesh local``: the restored state is
  the DP state, and its next step is the local run's third, bit for bit
  (the counterpart of ``tests/helpers/check_elastic_ckpt.py``);
* the DP step from the reference's weights matches the JAX single-device
  step on the whole batch within ``test_train_step_matches_jax``'s 1e-5
  (AdamW's ``eps`` 1e-3: that test's docstring says why);
* the production meshes and a model axis with fewer experts than its
  ranks are refused with their ROADMAP
  item, ``--mesh 2`` without a process group raises, and ``--mesh 1`` in
  a one-process group takes the whole batch over a ``DistComm``.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from test_torch_dist_comm import init_gloo, run_ranks

ARCHS = ("llama3-8b", "falcon-mamba-7b")
WORLD, BATCH, SEQ = 2, 4, 32
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _argv(arch, *more):
    return ["--arch", arch, "--reduced", "--batch", str(BATCH), "--seq",
            str(SEQ), "--device", "cpu", "--steps", "3", *more]


def _paths(tree, keys=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], keys + (k,))]
    return [(keys, tree)]


def _leaves(tr):
    """The trainer's state in ``tree_leaves``' order, each leaf whole
    (under ``--mesh``, assembled from the ranks' parts: a collective)."""
    whole = (lambda k, t: t) if tr.placed is None else tr.placed.whole
    return [whole(k, t).numpy().copy() for k, t in _paths(
        {"params": tr.params, "opt": tr.opt_state})]


def _jax_case(arch):
    """The reference's model, weights, AdamW and batch of the JAX step."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models.transformer import Model as JModel
    from repro.models.transformer import RunCtx as JRunCtx
    from repro.optim import adamw as jadamw

    cfg = jregistry.get_config(arch, reduced=True)
    jm = JModel(cfg, JRunCtx(remat="none", act_dtype=jnp.float32))
    jp = jm.init_params(jax.random.PRNGKey(0))
    kw = dict(weight_decay=0.01, clip_norm=1.0, eps=1e-3)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 10), **kw)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, 33)).astype(np.int32)
    return cfg, jm, jp, jopt, kw, (toks[:, :-1], toks[:, 1:])


def _worker(rank, world, init, out):
    import torch.distributed as dist

    init_gloo(rank, world, init)
    for arch in ARCHS:
        np.savez(f"{out}-{arch}-{rank}.npz", **_rank_steps(rank, world, out,
                                                           arch))
    dist.destroy_process_group()


def _rank_steps(rank, world, out, arch):
    """This rank's two ``--mesh`` steps and its step from the reference's
    weights."""
    import jax

    from repro_torch.comm.communicator import DistComm
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import model_params_from_reference
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model, RunCtx, tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_train_step

    res = {}
    ckpt = pathlib.Path(out).parent / f"ckpt-{arch}"
    args = train.parse_args(_argv(arch, "--mesh", str(world), "--ckpt-dir",
                                  str(ckpt), "--save-every", "1"))
    tr = train.setup(get_config(arch, reduced=True), args)
    assert tr.rows == slice(rank * BATCH // world,
                            (rank + 1) * BATCH // world)
    for step in range(2):
        res[f"loss{step}"] = tr.step()["loss"].numpy()
        tr.save(step + 1)
        for i, a in enumerate(_leaves(tr)):
            res[f"s{step}-{i}"] = a
    if tr.mgr is not None:
        tr.mgr.wait()

    # one step from the reference's weights, each rank on its rows
    cfg, _, jp, _, kw, (tokens, labels) = _jax_case(arch)
    tm = Model(cfg, RunCtx(act_dtype=torch.float32, remat="full"),
               device="cpu")
    tp = tm.load_params(model_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)), master=True)
    topt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 10), **kw)
    comm = DistComm(1, device="cpu")
    rows = slice(rank * 4, rank * 4 + 4)
    tp, state, met = build_train_step(tm, topt, comm=comm)(
        tp, topt.init(tp), (torch.from_numpy(tokens[rows]).long(),
                            torch.from_numpy(labels[rows]).long()))
    for k in ("loss", "grad_norm"):
        res["jax-" + k] = met[k].numpy()
    for i, t in enumerate(tree_leaves({"params": tp, "m": state["m"],
                                       "v": state["v"]})):
        res[f"jax-{i}"] = t.numpy()
    return res


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The two ranks, spawned once for this module: ``run(arch) -> (tmp,
    [rank 0's arrays, rank 1's])``."""
    tmp = tmp_path_factory.mktemp("dp")
    run_ranks(__file__, WORLD, tmp, tmp / "rank", timeout=400)

    def run(arch):
        return tmp, [dict(np.load(tmp / f"rank-{arch}-{r}.npz"))
                     for r in range(WORLD)]
    return run


@pytest.fixture(scope="module")
def local_runs():
    """``--mesh local --accum 2``: the state after each of three steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train

    out = {}
    for arch in ARCHS:
        args = train.parse_args(_argv(arch, "--accum", str(WORLD)))
        tr = train.setup(get_config(arch, reduced=True), args)
        out[arch] = [(float(tr.step()["loss"]), _leaves(tr))
                     for _ in range(3)]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_2_is_local_accum_2_bit_for_bit(arch, dp_run, local_runs):
    _, ranks = dp_run(arch)
    for step in range(2):
        loss, leaves = local_runs[arch][step]
        for res in ranks:                  # replicated on every rank
            assert float(res[f"loss{step}"]) == loss
            for i, want in enumerate(leaves):
                np.testing.assert_array_equal(res[f"s{step}-{i}"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_2_checkpoint_resumes_at_mesh_local(arch, dp_run, local_runs):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train

    tmp, ranks = dp_run(arch)
    args = train.parse_args(_argv(arch, "--accum", str(WORLD), "--ckpt-dir",
                                  str(tmp / f"ckpt-{arch}")))
    tr = train.setup(get_config(arch, reduced=True), args)
    assert tr.start_step == 2 and tr.comm is None
    for i, got in enumerate(_leaves(tr)):
        np.testing.assert_array_equal(got, ranks[0][f"s1-{i}"])
    loss = float(tr.step()["loss"])
    want_loss, want = local_runs[arch][2]
    assert loss == want_loss
    for got, w in zip(_leaves(tr), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_2_step_matches_the_jax_step(arch, dp_run):
    import jax
    import jax.numpy as jnp

    from repro.runtime import steps as jsteps

    _, ranks = dp_run(arch)
    cfg, jm, jp, jopt, _, batch = _jax_case(arch)
    jp2, js2, jmet = jsteps.build_train_step(jm, jopt)(
        jp, jopt.init(jp), tuple(map(jnp.asarray, batch)))
    want = jax.tree.leaves({"params": jp2, "m": js2["m"], "v": js2["v"]})
    for res in ranks:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(res["jax-" + k]),
                                       float(jmet[k]), **STEP_TOL)
        for i, w in enumerate(want):
            np.testing.assert_allclose(res[f"jax-{i}"], np.asarray(w),
                                       **STEP_TOL)


@pytest.mark.parametrize("spec,shape", [("2x2", (2, 2)), ("1x2", (1, 2)),
                                        ("pod", (16, 16)),
                                        ("multipod", (2, 16, 16))])
def test_model_axis_specs_are_accepted(spec, shape):
    """Every mesh of the reference's grammar is ported: the production
    meshes, and at ``2x2`` and ``1x2`` an MoE config with fewer experts
    than the model axis (one expert on two model ranks: the reference's
    tp_local split).  Without a process group the mesh asks for one."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    cfg = dataclasses.replace(get_config("mixtral-8x22b", reduced=True),
                              num_experts=1, experts_per_token=1)
    mesh = train.ported_mesh(spec)
    assert mesh.axis_sizes == shape
    assert not train.mesh_rules(cfg, mesh).ep_mode
    with pytest.raises(RuntimeError, match="init_process_group"):
        train.data_parallel(spec, BATCH, "cpu")


def test_data_parallel_in_a_one_process_group(tmp_path):
    """``--mesh 1`` in a one-process gloo group: a ``DistComm`` of one rank
    that takes every row, with no grid (no model axis); a mesh of another
    size than the group raises."""
    import torch.distributed as dist

    from repro_torch.comm.communicator import DistComm
    from repro_torch.launch import train
    init_gloo(0, 1, str(tmp_path / "init"))
    try:
        mesh, grid, comm, rows = train.data_parallel("1", BATCH, "cpu")
        assert isinstance(comm, DistComm) and grid is None
        assert mesh.axis_sizes == (1,)
        assert (comm.p, comm.rank, rows) == (1, 0, slice(0, BATCH))
        with pytest.raises(ValueError, match="process group has 1"):
            train.data_parallel("2", BATCH, "cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_2_needs_a_process_group(monkeypatch):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="init_process_group"):
        train.data_parallel("2", BATCH, "cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torch.distributed group"):
        train.main(_argv("llama3-8b", "--mesh", "2"))
    # local without a group: this process alone
    _, grid, comm, rows = train.data_parallel("local", BATCH, "cpu")
    assert (grid, comm, rows) == (None, None, slice(None))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
