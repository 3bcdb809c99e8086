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
from the latest checkpoint there.  The port runs on one device: a
``--mesh`` other than ``local`` (the reference's data and model axes,
FSDP and expert sharding) is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.comm.communicator import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataState, SyntheticLM
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.fault import StepTimer, StragglerWatch
from repro_torch.runtime.steps import build_train_step

__all__ = ["preset_lm100m", "parse_args", "Trainer", "setup", "main"]

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
    encdec or vlm stack, else None)."""

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

    @property
    def device(self) -> torch.device:
        return self.model.device

    def batch(self):
        """The next batch on the device, as (tokens, labels) int64."""
        tokens, labels = self.data.batch_at(self.dstate.step)
        return (torch.from_numpy(tokens).to(self.device, torch.int64),
                torch.from_numpy(labels).to(self.device, torch.int64))

    def step(self):
        """One train step on the next batch; returns its metrics (0-d
        tensors on the device)."""
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, self.batch(), self.extra)
        self.dstate.step += 1
        return metrics

    def save(self, step: int, *, force=False):
        if self.mgr is not None:
            self.mgr.maybe_save(
                step, {"params": self.params, "opt": self.opt_state},
                extra={"data": self.dstate.to_json()}, force=force)


def setup(cfg, args, *, retries: int = 1,
          ssm_scan_dtype: torch.dtype = torch.float32) -> Trainer:
    """The model, optimizer and state of ``args`` for ``cfg``, resumed from
    ``--ckpt-dir``'s latest checkpoint when there is one.  A step's failed
    gradient half is retried up to ``retries`` times (the reference
    retries a failed step once; ``build_train_step``).
    ``ssm_scan_dtype`` is ``RunCtx``'s: the mamba layers' scan payload (as
    the reference, no flag sets it)."""
    if args.mesh != "local":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; sharded "
            "training needs the torch.distributed communicator (ROADMAP "
            "A2) and runtime/sharding.py, launch/mesh.py (A13)")
    device = resolve_device(args.device)
    ctx = RunCtx(
        moe_groups=1,          # the reference's min(data-parallel size, B)
        remat="full",
        act_dtype=torch.float32 if device.type == "cpu" else torch.bfloat16,
        ssm_scan_dtype=ssm_scan_dtype,
    )
    model = Model(cfg, ctx, device=device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps),
                weight_decay=0.01)
    step_fn = build_train_step(model, opt, accum_steps=args.accum,
                               retries=retries)

    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed), master=True)
    opt_state = opt.init(params)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    dstate = DataState()

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, save_every=args.save_every)
        got = mgr.restore_latest({"params": params, "opt": opt_state})
        if got[0] is not None:
            start_step, tree, extra_state = got
            params, opt_state = tree["params"], tree["opt"]
            dstate = DataState.from_json(extra_state.get("data", {"step": 0}))
            log.info("resumed from step %d", start_step)
    extra = None
    if cfg.is_encdec:
        extra = {"frames": torch.zeros(
            (args.batch, cfg.encoder_seq, cfg.d_model), dtype=ctx.act_dtype,
            device=device)}
    if cfg.is_vlm:
        extra = {"image_embeds": torch.zeros(
            (args.batch, cfg.num_image_tokens, cfg.d_model),
            dtype=ctx.act_dtype, device=device)}
    return Trainer(model, opt, params, opt_state, step_fn, data, dstate,
                   start_step, mgr, extra)


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
