"""Training entry point with checkpoint/restart and a straggler watch: the
counterpart of ``repro.launch.train``.

    python -m repro_torch.launch.train --preset lm100m --steps 200
    python -m repro_torch.launch.train --arch llama3-8b --reduced \
        --steps 20 --batch 8 --seq 128 --device cpu

The model trains on the card unless ``--device cpu`` is given: in bfloat16
activations on the card, in float32 on the CPU (the reference picks by its
backend the same way), from float32 master weights drawn from ``--seed``,
on ``SyntheticLM`` batches, with AdamW (weight decay 0.01) on a cosine
schedule.  ``--ckpt-dir`` saves every ``--save-every`` steps and resumes
from the latest checkpoint there.

``--mesh`` takes the reference's grammar (``launch.mesh.make_mesh``).
``local`` without a process group trains in this process alone.  ``D`` or
``Dx1`` trains over the ``D`` processes of a ``torch.distributed`` group
(gloo on the CPU, NCCL on the card; ``main`` initialises it from a
launcher's environment, one process a rank), data-parallel with FSDP
storage sharding:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch llama3-8b --reduced --mesh 2 --device cpu

Every rank draws the same global batch from ``--seed`` and takes its
consecutive rows, as the reference's batch sharding over the data axis
does.  The parameters and the AdamW state are placed as the reference's
``--mesh Dx1`` places them (``fsdp_axes="data"``, ``ep_mode`` for an MoE
config; ``runtime.sharding``): each rank holds ``1/D`` of every leaf
whose rule names the data axis (an MoE layer's expert weights on their
model dimension) and the rest whole (norms, biases, ``conv_w``,
``x_proj``, ``dt_proj``, ``a_log``, ``d_skip``, and what ``fit_spec``
left whole).  The model all-gathers a layer's weights inside its remat
region, where it computes them, and the backward reduce-scatters their
gradients in rank order (``sharding.make_gather``); the whole leaves'
gradients are averaged over the ranks in rank order
(``runtime.steps.mean_over_ranks``).  So ``--mesh W`` (accumulation 1 a
rank) gives ``--mesh local --accum W``'s step bit for bit.  A sharded step
retries nothing (a retry on one rank would leave the others in a
gather).  Checkpoints keep the reference's format: every rank assembles
each leaf, rank 0 writes, and every rank restores its part whatever the
mesh that wrote them.  At ``--mesh 1`` each part is the whole leaf, and
the gathers still run.

``DxM`` (``M > 1``, or ``Dx1`` and ``1x1``) adds the model axis: tensor
and expert parallelism over ``D·M`` processes, global rank ``r = d·M + m``
(``launch.mesh.grid``: a data group for each ``m``, a model group for
each ``d``).  The batch splits over the data axis only, so the ``M`` ranks
of a model group see the same rows.  A leaf's part is its block over both
axes under the reference's rules on the ``D x M`` mesh (``fsdp_rules``),
the data group gathers a layer's parts whole over the data axis, and the
layer computes with its model-axis part (``runtime.model_axis``):
``H/M`` query heads, ``F/M`` MLP columns, ``di/M`` mamba channels (B9 and
its backward on them), ``E/M`` experts (``ep_mode``), a vocab-parallel
embedding (``vocab_shards = M``) and cross-entropy.  The gradients and
the loss are averaged over the data group; the global norm counts each
leaf once.  The step then holds ``--mesh local --accum D`` within float32
rounding (the row-split products add their partial sums over the ranks).
At ``M = 1`` the model group's collectives still run, over one rank, and
the step is ``--mesh local``'s bit for bit (the hybrid family's within
float32 rounding: ``runtime.model_axis``).

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama3-8b --reduced --mesh 2x2 --device cpu

An MoE config with fewer experts than the model axis trains the
reference's ``tp_local`` split (``ep_mode=False``): every rank runs every
expert on its ``F/M`` columns (``models.moe.moe_fwd``).

``pod`` (16x16, data × model over 256 processes) is ``DxM``.
``multipod`` (2x16x16, pod × data × model over 512; a test passes a
``launch.mesh.Mesh`` of that layout and smaller sizes as ``args.mesh``)
adds the pod axis, global rank ``r = (p·D + d)·M + m``: the batch splits
over ``("pod", "data")`` (the batch group, ``P·D`` ranks at ``m``),
FSDP stays on ``"data"`` (a rank keeps its ``(d, m)`` block on every
pod), and the gradients of the split leaves are summed over the batch
group by the HSDP reduction (a reduce-scatter over the batch group into
``P·D`` pieces, an all-gather over the pod group back to the ``1/D``
part), the whole leaves' and the loss averaged over it, each in the
batch group's order ``p·D + d``: so ``P x D x 1`` gives ``--mesh local
--accum P·D``'s step bit for bit.  ``hierarchical_rules`` is the
reference's dry-run train rules (``opt_fsdp_axes=("pod", "data")``,
hierarchical ZeRO), which ``setup(rules=)`` takes: the AdamW state is
kept at its block over both data axes and the update runs there
(``runtime.steps``), bit for bit the step without it.  ``launch.train``
itself, as the reference's, sets no ``opt_fsdp_axes``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time

import os

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.comm.communicator import DistComm, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataState, SyntheticLM
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime import sharding
from repro_torch.runtime.model_axis import ModelAxis
from repro_torch.runtime.fault import StepTimer, StragglerWatch
from repro_torch.runtime.steps import build_train_step

__all__ = ["preset_lm100m", "parse_args", "ported_mesh", "data_parallel",
           "fsdp_rules", "mesh_rules", "hierarchical_rules", "Trainer",
           "setup", "main"]

log = logging.getLogger("repro_torch.train")


def preset_lm100m() -> ArchConfig:
    """~100M-param dense LM for the end-to-end example."""
    return ArchConfig(
        name="lm100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=32768,
        head_dim=64,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", default=None, choices=[None, "lm100m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--mesh", default="local")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs without a card; default the card")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Trainer:
    """What ``main``'s loop runs: the model and its optimizer, the state
    (params, opt_state, data state, resumed step), the step, the data, the
    checkpoint manager, and the cross-attention inputs of every step
    (``extra``: the reference's zero frames or image embeddings for an
    encdec or vlm stack, else None).  Under data parallelism ``comm`` is
    the ``DistComm`` over which the batch splits: the data group (the
    batch group on a pod axis; the model group's is the model's
    ``ctx.model.comm`` under ``DxM``), ``rows`` this rank's rows of each
    global batch and ``placed`` the placement of ``{"params", "opt"}``
    (``sharding.Placed``: ``params`` and ``opt_state`` hold this rank's
    parts); else ``comm`` and ``placed`` are None and ``rows`` takes them
    all."""

    model: Model
    opt: AdamW
    params: dict
    opt_state: dict
    step_fn: object
    data: SyntheticLM
    dstate: DataState
    start_step: int
    mgr: CheckpointManager | None
    extra: dict | None = None
    comm: object = None
    rows: slice = slice(None)
    placed: sharding.Placed | None = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def batch(self):
        """This rank's rows of the next batch on the device, as (tokens,
        labels) int64."""
        tokens, labels = self.data.batch_at(self.dstate.step)
        return tuple(torch.from_numpy(a[self.rows]).to(self.device,
                                                       torch.int64)
                     for a in (tokens, labels))

    def step(self):
        """One train step on the next batch; returns its metrics (0-d
        tensors on the device)."""
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, self.batch(), self.extra)
        self.dstate.step += 1
        return metrics

    def save(self, step: int, *, force=False):
        """Save at ``step`` when due; every rank calls it (assembling a
        leaf is a collective) and rank 0 writes."""
        if self.mgr is not None:
            self.mgr.maybe_save(
                step, {"params": self.params, "opt": self.opt_state},
                extra={"data": self.dstate.to_json()}, force=force,
                placed=self.placed)


def ported_mesh(spec) -> mesh_mod.Mesh:
    """``--mesh spec``'s mesh (a ``launch.mesh.Mesh`` is taken as it is):
    every spec of the reference's grammar is ported, the production
    meshes too.  Where a process group is initialised, its world must be
    the mesh's size (``local`` excepted): ``pod`` needs 256 processes,
    ``multipod`` 512."""
    mesh = mesh_mod.make_mesh(spec)
    if dist.is_initialized() and spec != "local" \
            and dist.get_world_size() != mesh.size:
        raise ValueError(f"--mesh {spec} has {mesh.size} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return mesh


def data_parallel(spec, batch: int, device):
    """``--mesh spec``'s parallelism: ``(mesh, grid, comm, rows)``, its
    ``launch.mesh.Grid`` where it has a model axis (None for ``D``), this
    rank's ``DistComm`` over the ranks the batch splits over (its data
    group; its batch group, pod × data, on a pod axis; one rank a
    process) and its rows of a global batch of ``batch``; ``(mesh, None,
    None, all rows)`` for ``local`` without a process group."""
    mesh = ported_mesh(spec)
    if spec == "local" and not dist.is_initialized():
        return mesh, None, None, slice(None)
    g = None
    if "model" in mesh.shape and spec != "local":
        if not dist.is_initialized():
            DistComm(1, device)                     # raises: no group
        g = mesh_mod.grid(mesh, device)
        comm = g.batch
    else:
        comm = DistComm(1, device)
        if comm.world != mesh.size:
            raise ValueError(f"--mesh {spec} has {mesh.size} ranks; the "
                             f"process group has {comm.world}")
    dp = comm.p
    if batch % dp:
        raise ValueError(f"--batch {batch} does not split over {dp} "
                         "data-parallel ranks")
    per = batch // dp
    return mesh, g, comm, slice(comm.rank * per, (comm.rank + 1) * per)


def mesh_rules(cfg, mesh) -> sharding.ShardingRules:
    """The reference's ``launch.train`` rules for ``cfg`` on ``mesh``:
    ``fsdp_axes="data"`` (the batch over ``("pod", "data")`` on a pod
    axis, the weights replicated over pods), ``ep_mode`` for an MoE config
    with at least ``M`` experts (else its ``tp_local`` split), no
    ``opt_fsdp_axes``."""
    return sharding.ShardingRules(
        mesh=mesh, fsdp_axes="data",
        ep_mode=cfg.is_moe and cfg.num_experts >= mesh.shape["model"])


def fsdp_rules(cfg, parts: int, model: int = 1) -> sharding.ShardingRules:
    """``mesh_rules`` on the ``D x M`` mesh, ``D = parts`` and ``M =
    model``; ``--mesh D`` is the ``D x 1`` mesh, whose model axis the rule
    table names."""
    return mesh_rules(cfg, mesh_mod.Mesh((parts, model), ("data", "model")))


def hierarchical_rules(cfg, mesh) -> sharding.ShardingRules:
    """The train branch of the reference's dry-run ``make_rules``
    (``launch/dryrun.py``): on a pod axis hierarchical ZeRO, the weights
    FSDP over ``"data"`` and the optimizer state over ``("pod",
    "data")`` (``opt_fsdp_axes``); else ``mesh_rules``.  ``setup(rules=)``
    takes them (``launch.train``, as the reference's, does not)."""
    rules = mesh_rules(cfg, mesh)
    if "pod" in mesh.shape:
        rules = dataclasses.replace(rules, opt_fsdp_axes=("pod", "data"))
    return rules


def setup(cfg, args, *, retries: int = 1,
          ssm_scan_dtype: torch.dtype = torch.float32,
          rules: sharding.ShardingRules | None = None) -> Trainer:
    """The model, optimizer and state of ``args`` for ``cfg``, resumed from
    ``--ckpt-dir``'s latest checkpoint when there is one.  A step's failed
    gradient half is retried up to ``retries`` times (the reference
    retries a failed step once; ``build_train_step``), but for a sharded
    step, whose gradient half holds collectives: it retries nothing.
    ``ssm_scan_dtype`` is ``RunCtx``'s: the mamba layers' scan payload (as
    the reference, no flag sets it).  A ``--mesh`` other than ``local``
    needs an initialised process group (``data_parallel``) and shards the
    parameters and the AdamW state over it (``mesh_rules`` on its mesh, or
    ``rules`` on the same mesh: ``hierarchical_rules``' for
    ``opt_fsdp_axes``)."""
    device = resolve_device(args.device)
    mesh, g, comm, rows = data_parallel(args.mesh, args.batch, device)
    gather = tp = None
    if comm is not None:
        if g is None:                       # --mesh D: the D x 1 mesh
            mesh = mesh_mod.Mesh((comm.p, 1), ("data", "model"))
        if rules is None:
            rules = mesh_rules(cfg, mesh)
        elif rules.mesh.shape != mesh.shape:
            raise ValueError(f"rules for the mesh {rules.mesh.shape}; "
                             f"--mesh {args.mesh} is {mesh.shape}")
        if g is None:
            gather = sharding.make_gather(rules, comm)
        else:
            tp = ModelAxis(g.model)
            gather = g.gather_for(rules, tp)
        retries = 0
    ctx = RunCtx(
        moe_groups=1,          # the reference's min(data-parallel size, B)
        remat="full",
        act_dtype=torch.float32 if device.type == "cpu" else torch.bfloat16,
        ssm_scan_dtype=ssm_scan_dtype,
        gather=gather,
        model=tp,
        vocab_shards=1 if tp is None else tp.size,
    )
    model = Model(cfg, ctx, device=device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps),
                weight_decay=0.01)

    # drawn whole, block by block; a rank keeps its parts (gather.keep)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed), master=True)
    opt_state = opt.init(params)
    placed = dims = None
    if gather is not None:
        dims = gather.dims

        odims = gather.odims
        if odims is not None:           # the AdamW state over opt axes
            opt_state = {k: sharding.tree_zip(gather.to_wide, v, dims, odims)
                         if k in sharding.OPT_STATE_KEYS else v
                         for k, v in opt_state.items()}

        def state(d, o=None):
            return None if d is None else {"params": d, "opt": {
                k: (d if o is None else o)
                if k in sharding.OPT_STATE_KEYS else None
                for k in opt_state}}

        wide = None
        if odims is not None:
            wide = state(sharding.tree_zip(lambda d: False, dims),
                         sharding.tree_zip(lambda d: True, dims))
        placed = sharding.Placed(gather, state(dims, odims),
                                 state(gather.mdims), wide)
    step_fn = build_train_step(model, opt, accum_steps=args.accum,
                               retries=retries, comm=comm, dims=dims)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    dstate = DataState()

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, save_every=args.save_every)
        got = mgr.restore_latest({"params": params, "opt": opt_state},
                                 placed=placed)
        if got[0] is not None:
            start_step, tree, extra_state = got
            params, opt_state = tree["params"], tree["opt"]
            dstate = DataState.from_json(extra_state.get("data", {"step": 0}))
            log.info("resumed from step %d", start_step)
    extra = None
    local_batch = len(range(args.batch)[rows])
    if cfg.is_encdec:
        extra = {"frames": torch.zeros(
            (local_batch, cfg.encoder_seq, cfg.d_model), dtype=ctx.act_dtype,
            device=device)}
    if cfg.is_vlm:
        extra = {"image_embeds": torch.zeros(
            (local_batch, cfg.num_image_tokens, cfg.d_model),
            dtype=ctx.act_dtype, device=device)}
    return Trainer(model, opt, params, opt_state, step_fn, data, dstate,
                   start_step, mgr, extra, comm, rows, placed)


def main(argv=None, *, retries: int = 1):
    """Train as ``argv`` says; returns the per-step metrics.  ``retries``
    is ``setup``'s."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.preset == "lm100m":
        cfg = preset_lm100m()
    elif args.arch:
        cfg = get_config(args.arch, reduced=args.reduced)
    else:
        raise SystemExit("pass --arch or --preset")
    if args.mesh != "local" and not dist.is_initialized():
        ported_mesh(args.mesh)                  # a bad spec before a group
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"--mesh {args.mesh} trains over a torch.distributed group: "
                "start one process a rank under a launcher (torchrun) or "
                "initialise the group before calling setup")
        mesh_mod.init_group(args.device or "cuda")
        try:
            return _train(cfg, args, retries)
        finally:
            dist.destroy_process_group()
    return _train(cfg, args, retries)


def _train(cfg, args, retries: int):
    tr = setup(cfg, args, retries=retries)

    watch = StragglerWatch()
    metrics_hist = []
    t_start = time.time()
    for step in range(tr.start_step, args.steps):
        with StepTimer(tr.device) as t:
            metrics = tr.step()
            loss = float(metrics["loss"])
        watch.observe(t.dt)
        if watch.persistent:
            log.warning("persistent straggler detected; checkpoint + "
                        "re-slice advised")
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %d loss %.4f gnorm %.3f %.2fs/step",
                     step, loss, float(metrics["grad_norm"]), t.dt)
        metrics_hist.append({"step": step, "loss": loss, "sec": t.dt})
        tr.save(step + 1)

    if tr.mgr is not None:
        tr.save(args.steps, force=True)
        tr.mgr.wait()
    wall = time.time() - t_start
    log.info("done: %d steps in %.1fs (%.2fs/step)",
             args.steps - tr.start_step, wall,
             wall / max(1, args.steps - tr.start_step))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_hist, f)
    return metrics_hist


if __name__ == "__main__":
    main()
