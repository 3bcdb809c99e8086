"""Serving entry point: a continuous-batching engine over a request queue.

    python -m repro_torch.launch.serve --arch llama3-8b
    python -m repro_torch.launch.serve --arch llama3-8b --reduced --device cpu
    python -m repro_torch.launch.serve --arch mixtral-8x22b --moe-comm \
        --mesh 8 --requests 16 --slots 8 --prompt-len 2048

``repro_torch.serve`` supplies the loop (queue → slots → engine); this
module builds the model with random weights from ``--seed``, fabricates a
staggered arrival trace of random token ids (no tokenizer), and prints the
throughput and latency report.  The ssm family (no per-slot cache) runs
the batched demo loop instead, its prompt prefilled through the
sequential decode scan ``prefill_into_cache``.  The model runs on the card
unless ``--device cpu`` is given (then in float32, as the reference runs
on its CPU backend).

``--moe-comm`` routes each decode step's MoE FFN through a
``DynamicMoELayer`` over ``--mesh``'s ranks (``build_moe_layer``): a
``LoopbackComm`` of that many ranks on the one device (``local``: as many
ranks as cards present, at least one).  The reference's 2-D meshes have a
model axis the port has no counterpart for, and are refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch.comm.communicator import LoopbackComm, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import moe as M
from repro_torch.models.transformer import Model, RunCtx
from repro_torch.serve import Request, ServeEngine

__all__ = ["prefill_into_cache", "preset_lm100m", "parse_args",
           "make_comm", "build_moe_layer", "build_engine", "submit_trace",
           "make_engine", "main"]

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


def preset_lm100m() -> ArchConfig:
    """~100M-param dense LM (the reference's end-to-end example preset)."""
    return ArchConfig(
        name="lm100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=32768,
        head_dim=64,
    )


def make_comm(spec: str, device) -> LoopbackComm:
    """The ranks of ``--mesh``: ``"local"`` is one rank per card present
    (one on the CPU), ``"<P>"`` is ``LoopbackComm(P)`` on the one device.
    A spec with a model axis (``"AxB"``, ``pod``, ``multipod``) is
    refused: the port's communicator has one axis."""
    device = torch.device(device)
    if spec == "local":
        p = torch.cuda.device_count() if device.type == "cuda" else 1
        return LoopbackComm(max(1, p), device=device)
    if not spec.isdigit():
        raise ValueError(
            f"--mesh {spec!r}: the port's communicator has one axis of "
            "ranks; give their count ('8') or 'local'")
    return LoopbackComm(int(spec), device=device)


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
    return M.DynamicMoELayer(weights, tmpl_e, num_slots, cfg.num_experts,
                             cap, comm, act=cfg.act, strategy=strategy,
                             decode=True)


def build_engine(cfg, ctx, args) -> ServeEngine:
    """The model, its random parameters (``torch.Generator`` seeded with
    ``args.seed`` on the device) and an engine with ``args.slots`` lanes of
    ``cache_len = prompt_len + gen``, its queue empty.  With
    ``args.moe_comm`` the engine's decode steps route the MoE FFN through
    ``build_moe_layer`` over ``args.mesh``'s ranks."""
    device = resolve_device(args.device)
    model = Model(cfg, ctx, device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    moe_layer = None
    if args.moe_comm:
        if cfg.family != "moe":
            raise ValueError("--moe-comm needs a MoE architecture")
        moe_layer = build_moe_layer(model, params, args.slots,
                                    make_comm(args.mesh, device))
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


def make_engine(cfg, ctx, args) -> ServeEngine:
    """``build_engine`` with ``submit_trace``'s requests queued."""
    engine = build_engine(cfg, ctx, args)
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


def _batch_demo_main(cfg, ctx, args):
    """Batched demo for families without a per-slot cache (ssm)."""
    device = resolve_device(args.device)
    model = Model(cfg, ctx, device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    cache = model.init_cache(args.batch, args.prompt_len + args.gen,
                             dtype=ctx.act_dtype)
    rng = np.random.default_rng(args.seed)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)), dtype=torch.int32,
        device=device)

    t0 = time.time()
    cache, last_logits = prefill_into_cache(model, params, cache, prompt)
    last = torch.argmax(last_logits[:, -1], dim=-1).to(torch.int32)  # (B,)
    last.cpu()                                  # waits for the device
    t_prefill = time.time() - t0

    out_tokens = [last]
    t0 = time.time()
    for _ in range(args.gen):
        logits, cache = model.decode_step(params, cache,
                                          out_tokens[-1][:, None])
        out_tokens.append(torch.argmax(logits[:, -1], dim=-1).to(
            torch.int32))
    seq = torch.stack(out_tokens[1:], dim=1).cpu()
    t_decode = time.time() - t0

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
    ap.add_argument("--batch", type=int, default=4)     # ssm demo path
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--moe-comm", action="store_true",
                    help="route decode MoE through DynamicMoELayer")
    ap.add_argument("--experts", type=int, default=None,
                    help="override num_experts (e.g. to match the mesh)")
    ap.add_argument("--mesh", default="local",
                    help="the MoE exchange's ranks: 'local' or a count")
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
    if cfg.family in ("dense", "moe"):
        return _serve_main(cfg, ctx, args)
    return _batch_demo_main(cfg, ctx, args)


if __name__ == "__main__":
    main()
