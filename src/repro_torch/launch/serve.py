"""Serving entry point: a continuous-batching engine over a request queue.

    python -m repro_torch.launch.serve --arch llama3-8b
    python -m repro_torch.launch.serve --arch llama3-8b --reduced --device cpu
    python -m repro_torch.launch.serve --arch whisper-tiny --batch 8
    python -m repro_torch.launch.serve --arch mixtral-8x22b --moe-comm \
        --mesh 8 --requests 16 --slots 8 --prompt-len 2048

``repro_torch.serve`` supplies the loop (queue → slots → engine); this
module builds the model with random weights from ``--seed``, fabricates a
staggered arrival trace of random token ids (no tokenizer), and prints the
throughput and latency report.  The families without a per-slot cache
(ssm, hybrid, encdec, vlm) run the batched demo loop instead, their
cross-attention context (whisper's frames, the vision model's image
embeddings: both front ends are stubs) random from the seed and their
prompt prefilled through the sequential decode scan
``prefill_into_cache``.  The model runs on the card
unless ``--device cpu`` is given (then in float32, as the reference runs
on its CPU backend).

``--moe-comm`` routes each decode step's MoE FFN through a
``DynamicMoELayer`` over ``--mesh``'s ranks (``build_moe_layer``): a
``LoopbackComm`` of that many ranks on the one device (``local``: as many
ranks as cards present, at least one), or, started one process a rank
under a launcher, a ``DistComm`` holding ``P / world`` of them in each
process (gloo on the CPU, NCCL on the card; ``launch.mesh.init_group``)::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch mixtral-8x22b --reduced --device cpu --experts 8 --slots 8 \
        --moe-comm --mesh 8

Every process then runs the whole engine on every slot and holds its
ranks' experts.

``--mesh DxM`` (``Dx1`` and ``1xM`` too) serves over a data axis of D
ranks and a model axis of M, one process a rank (global rank ``d·M +
m``, ``launch.mesh.grid``), with the reference's serve placement
(``runtime.sharding.serve_rules``: the weights over the model axis, and
over the data axis too where a model-axis part would exceed
``sharding.serve_limit``: half the card's memory on the card, the
reference's 12e9 bytes on the CPU) and its
decode caches (``cache_specs``: lanes over the data axis, the ring and the
cross slots over the model axis).  A data rank serves its block of the
lanes (or of the batched demo's batch) tensor- and expert-parallel with
its model group, and with ``--moe-comm`` the decode hook's
``DynamicMoELayer`` runs over its data group, as the reference's hook over
its mesh's ``data`` axis::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch llama3-8b --reduced --device cpu --mesh 2x2

An MoE config with fewer experts than the model axis serves the
reference's ``tp_local`` split (``ep_mode=False``: every rank runs every
expert on its ``F/M`` columns, ``models.moe.moe_fwd``; the decode hook
gathers the experts whole over the model group).  ``pod`` (16x16) is
``DxM``; ``multipod`` (2x16x16, pod × data × model, global rank ``(p·D +
d)·M + m``; a test passes a smaller ``launch.mesh.Mesh`` of that layout
as ``args.mesh``) places the weights by the serve rule, ZeRO-inference
over ``("pod", "data")`` where a model-axis part would not fit, and the
caches by ``cache_specs``: the lanes over pod × data (the batch group),
each served by its rank's model group.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.communicator import (DistComm, LoopbackComm,
                                           resolve_device)
from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.train import preset_lm100m
from repro_torch.models import moe as M
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.runtime import sharding
from repro_torch.runtime.model_axis import ModelAxis
from repro_torch.serve import Request, ServeEngine

__all__ = ["prefill_into_cache", "preset_lm100m", "parse_args",
           "serve_mesh", "serving_ctx", "make_comm", "build_moe_layer",
           "build_engine", "submit_trace", "make_engine", "setup_batch_demo",
           "run_batch_demo", "main"]

log = logging.getLogger("repro_torch.serve")


def prefill_into_cache(model, params, cache, tokens):
    """Sequential prefill through decode_step, one position at a time: the
    oracle for the fused path (``Model.prefill``) and the prefill of
    stacks without one (ssm).  tokens (B, S); returns (cache, the last
    step's logits (B, 1, V))."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
    return cache, logits


def serve_mesh(spec):
    """``--mesh spec``'s mesh where it has a model axis (``DxM``, ``pod``,
    ``multipod``, or a ``launch.mesh.Mesh`` with a ``model`` axis), None
    for ``"local"`` or a count."""
    if isinstance(spec, mesh_mod.Mesh):
        mesh = spec
    elif spec in ("local",) or spec.isdigit():
        return None
    else:
        mesh = mesh_mod.make_mesh(spec)
    if "model" not in mesh.shape:
        raise ValueError(f"--mesh {spec!r}: give D x M, pod or multipod")
    return mesh


def serving_ctx(cfg, ctx: RunCtx, mesh, grid, *, limit=None,
                device=None) -> RunCtx:
    """``ctx`` serving over ``mesh`` at ``grid``'s place (a
    ``launch.mesh.Grid``: its data, model and, on a pod axis, pod and
    batch groups): the reference's serve rules (``sharding.serve_rules``
    at ``limit``), the placement hook over the groups they name with the
    model axis (``Grid.gather_for``: ``RunCtx.gather``, ``RunCtx.model``)
    and ``vocab_shards = M``, as the reference's ``input_specs``."""
    rules = sharding.serve_rules(cfg, mesh, limit=limit, device=device)
    tp = ModelAxis(grid.model)
    return dataclasses.replace(
        ctx, gather=grid.gather_for(rules, tp), model=tp,
        vocab_shards=tp.size)


def make_comm(spec: str, device):
    """The ranks of ``--mesh``: ``"local"`` is one rank per card present
    (one on the CPU), ``"<P>"`` is ``LoopbackComm(P)`` on the one device,
    or, when a default process group of world > 1 is initialised,
    ``DistComm(P / world)`` in each process (a ``P`` the world does not
    divide is refused).  ``"DxM"`` (``pod``, ``multipod``) is this
    process's data group of the mesh over the default group (on a pod
    axis its batch group, pod × data; ``launch.mesh.grid``, which creates
    every group: ``build_engine`` makes the grid once and serves the MoE
    hook over that group)."""
    device = torch.device(device)
    if spec == "local":
        p = torch.cuda.device_count() if device.type == "cuda" else 1
        return LoopbackComm(max(1, p), device=device)
    mesh = serve_mesh(spec)
    if mesh is not None:
        return mesh_mod.grid(mesh, device).batch
    if not spec.isdigit():
        raise ValueError(f"--mesh {spec!r}: give 'local', a count ('8') "
                         "or 'DxM'")
    p = int(spec)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        return LoopbackComm(p, device=device)
    if p % world:
        raise ValueError(f"--mesh {spec} has {p} ranks; the process group's "
                         f"{world} processes do not split them")
    return DistComm(p // world, device)


def build_moe_layer(model, params, num_slots, comm, *, strategy="auto"):
    """A ``DynamicMoELayer`` sized for the engine's decode batch: one
    instance (template shapes, layer-0 weight slices) serves every layer
    via ``DynamicMoELayer.apply``."""
    cfg = model.cfg
    p = comm.p
    if cfg.num_experts % p or num_slots % p:
        raise ValueError(
            f"MoE comm path needs num_experts ({cfg.num_experts}) and "
            f"--slots ({num_slots}) divisible by the mesh axis ({p})")
    cap = M.moe_capacity(num_slots, cfg)
    tmpl_e, _ = M.random_router(0, num_slots, cfg.num_experts,
                                cfg.experts_per_token)
    moe_p = params["layers"]["moe"]
    weights = {k: moe_p[k][0] for k in ("w1", "w2", "w3") if k in moe_p}
    if model.ctx.gather is not None:         # whole over both axes
        weights = model.ctx.gather(weights, ("layers", "moe"))
        tp = model.ctx.model
        weights = {k: M.whole_experts(tp, cfg, k, w)
                   for k, w in weights.items()}
    return M.DynamicMoELayer(weights, tmpl_e, num_slots, cfg.num_experts,
                             cap, comm, act=cfg.act, strategy=strategy,
                             decode=True)


def _placed(cfg, ctx, args, device, grid):
    """``(ctx, grid)``: under a ``--mesh`` with a model axis the serving
    context of this process's place (``serving_ctx``) and its grid
    (``grid``, made over the default process group when not given: a
    caller that plays the ranks otherwise, as threads, passes its own),
    else ``(ctx, None)``."""
    mesh = serve_mesh(args.mesh)
    if mesh is None:
        return ctx, None
    grid = grid or mesh_mod.grid(mesh, device)
    return serving_ctx(cfg, ctx, mesh, grid, device=device), grid


def build_engine(cfg, ctx, args, *, grid=None) -> ServeEngine:
    """The model, its random parameters (``torch.Generator`` seeded with
    ``args.seed`` on the device) and an engine with ``args.slots`` lanes of
    ``cache_len = prompt_len + gen``, its queue empty.  With
    ``args.moe_comm`` the engine's decode steps route the MoE FFN through
    ``build_moe_layer`` over ``args.mesh``'s ranks (over a ``DxM`` mesh,
    its data group).  Under a ``DxM`` mesh this process keeps its parts
    of the parameters, drawn whole from the seed, and its block of the
    cache (``_placed``; ``grid`` as there)."""
    device = resolve_device(args.device)
    ctx, grid = _placed(cfg, ctx, args, device, grid)
    model = Model(cfg, ctx, device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    moe_layer = None
    if args.moe_comm:
        if cfg.family != "moe":
            raise ValueError("--moe-comm needs a MoE architecture")
        comm = grid.batch if grid is not None else make_comm(args.mesh,
                                                             device)
        moe_layer = build_moe_layer(model, params, args.slots, comm)
        log.info("MoE decode comm: strategies=%s plan_time=%.2fus",
                 moe_layer.strategies, moe_layer.plan_time * 1e6)
    return ServeEngine(model, params, num_slots=args.slots,
                       cache_len=args.prompt_len + args.gen,
                       prefill_chunk=args.prefill_chunk,
                       moe_layer=moe_layer, cache_dtype=ctx.act_dtype)


def submit_trace(engine: ServeEngine, cfg, args) -> None:
    """The arrival trace: ``args.requests`` prompts of uniform length in
    ``(prompt_len / 2, prompt_len]`` drawn from ``args.seed``, ``args.gen``
    tokens each, two arriving a tick from the engine's clock on."""
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2 + 1,
                                args.prompt_len + 1))
        engine.submit(Request(
            id=f"req{i}",
            prompt=rng.integers(0, cfg.vocab_size, (plen,)).tolist(),
            max_new_tokens=args.gen,
            # staggered arrivals in tick units: 2 new requests per tick
            arrival_time=engine.now + float(i // 2)))


def make_engine(cfg, ctx, args, *, grid=None) -> ServeEngine:
    """``build_engine`` with ``submit_trace``'s requests queued."""
    engine = build_engine(cfg, ctx, args, grid=grid)
    submit_trace(engine, cfg, args)
    return engine


def _serve_main(cfg, ctx, args):
    engine = make_engine(cfg, ctx, args)
    t0 = time.time()
    report = engine.run()
    wall = time.time() - t0
    log.info("%d requests, %d ticks, %.2fs wall", args.requests,
             report.ticks, wall)
    log.info("decode: %.1f tok/s, p50 %.0fus, p99 %.0fus per token",
             report.tokens_per_s, report.p50_us(), report.p99_us())
    log.info("telemetry: %s", report.telemetry)
    print("completed:", len(report.completed), "of", args.requests,
          "| total tokens:", report.total_tokens)
    return report


def setup_batch_demo(cfg, ctx, args, *, grid=None):
    """The batched demo's model, its random parameters (a
    ``torch.Generator`` seeded with ``args.seed`` on the device), a cache
    of ``args.batch`` lanes and ``cache_len = prompt_len + gen`` (cut to
    the window of a windowed config), its cross-attention K/V filled
    (``prefill_cross``) from a random context of ``encoder_seq`` frames or
    ``num_image_tokens`` image embeddings, and the prompt ``(batch,
    prompt_len)``.  The context and then the prompt are drawn from
    ``np.random.default_rng(args.seed)``, as the reference draws them.
    Returns ``(model, params, cache, prompt)``.  Under a ``DxM`` ``--mesh``
    (``grid`` as ``build_engine``'s) the model and the cache are this
    process's parts, and the context and the prompt its lanes' rows."""
    device = resolve_device(args.device)
    ctx, _ = _placed(cfg, ctx, args, device, grid)
    model = Model(cfg, ctx, device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    cross_len = cfg.encoder_seq or cfg.num_image_tokens or 0
    cache = model.init_cache(args.batch, args.prompt_len + args.gen,
                             cross_len=cross_len, dtype=ctx.act_dtype)
    rng = np.random.default_rng(args.seed)
    lanes = slice(None) if ctx.gather is None else ctx.gather.lanes(
        args.batch)
    if cross_len:
        context = torch.as_tensor(rng.standard_normal(
            (args.batch, cross_len, cfg.d_model))[lanes], device=device).to(
                ctx.act_dtype)
        cache = model.prefill_cross(params, cache, context)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))[lanes],
        dtype=torch.int32, device=device)
    return model, params, cache, prompt


def run_batch_demo(model, params, cache, prompt, gen: int):
    """The prompt prefilled through ``prefill_into_cache``, then ``gen``
    greedy decode steps over the whole batch.  Returns ``(tokens (B, gen)
    on the host, cache, prefill seconds, decode seconds)``; each time ends
    with a read of the tokens on the host, which waits for the device.
    Over a data axis that splits the batch each rank decodes its lanes
    and the tokens are all-gathered over its data group."""
    t0 = time.time()
    cache, last_logits = prefill_into_cache(model, params, cache, prompt)
    last = torch.argmax(last_logits[:, -1], dim=-1).to(torch.int32)  # (B,)
    last.cpu()                                  # waits for the device
    t_prefill = time.time() - t0

    out_tokens = [last]
    t0 = time.time()
    for _ in range(gen):
        logits, cache = model.decode_step(params, cache,
                                          out_tokens[-1][:, None])
        out_tokens.append(torch.argmax(logits[:, -1], dim=-1).to(
            torch.int32))
    seq = torch.stack(out_tokens[1:], dim=1)
    gather = model.ctx.gather
    if gather is not None:                  # every lane's tokens
        b = cache["whole"]["batch"]
        lanes = gather.lanes(b)
        if lanes.stop - lanes.start < b:
            seq = sharding.gathered(gather.batch, [seq], [0])[0]
    seq = seq.cpu()
    return seq, cache, t_prefill, time.time() - t0


def _batch_demo_main(cfg, ctx, args):
    """Batched demo for families without a per-slot cache (ssm, hybrid,
    encdec, vlm)."""
    model, params, cache, prompt = setup_batch_demo(cfg, ctx, args)
    seq, _, t_prefill, t_decode = run_batch_demo(model, params, cache,
                                                 prompt, args.gen)
    toks = args.gen * args.batch
    log.info("prefill %.3fs (%d tokens); decode %.3fs "
             "(%.1f tok/s aggregate)", t_prefill,
             args.batch * args.prompt_len, t_decode, toks / t_decode)
    print("generated shape:", tuple(seq.shape))
    return seq


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", default=None, choices=[None, "lm100m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)     # batched demo
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--moe-comm", action="store_true",
                    help="route decode MoE through DynamicMoELayer")
    ap.add_argument("--experts", type=int, default=None,
                    help="override num_experts (e.g. to match the mesh)")
    ap.add_argument("--mesh", default="local",
                    help="the MoE exchange's ranks ('local' or a count), "
                         "or a DxM serving mesh (one process a rank)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs without a card; default the card")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = (preset_lm100m() if args.preset == "lm100m"
           else get_config(args.arch, reduced=args.reduced))
    if args.experts:
        cfg = dataclasses.replace(cfg, num_experts=args.experts)
    ctx = RunCtx(act_dtype=torch.float32
                 if resolve_device(args.device).type == "cpu"
                 else torch.bfloat16)
    run = _serve_main if cfg.family in ("dense", "moe") else _batch_demo_main
    grouped = serve_mesh(args.mesh) is not None or (
        args.moe_comm and args.mesh != "local"
        and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if grouped and not dist.is_initialized():
        # one process a rank under a launcher (torchrun): a DxM mesh's
        # groups, or the MoE exchange's ranks over the group
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"--mesh {args.mesh} serves over a torch.distributed group: "
                "start one process a rank under a launcher (torchrun) or "
                "initialise the group first")
        mesh_mod.init_group(args.device or "cuda")
        try:
            return run(cfg, ctx, args)
        finally:
            dist.destroy_process_group()
    return run(cfg, ctx, args)


if __name__ == "__main__":
    main()
