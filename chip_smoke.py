#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at sizes their users would call real.  The
distributed modified-EllPack SpMV y = (D + A) x of the paper's Tables 3/4
(pull direction), its transpose y = (D + A)^T x (push direction) and the
normal-equations step z = M^T M x with CG on top run at n = 2^22 rows,
r_nz = 16, the 32x-scaled matrix of examples/spmv_strategies.py (locality
window n/64, 2% long-range columns, seed 1), over eight virtual ranks on
one card (LoopbackComm(8), shards_per_node = 4, blocksize = 1024).  The
paper's §8 heat equation (Heat2D) runs a 4096 x 4096 float32 field over a
2 x 4 rank grid (the grid of the paper's Table 5, whose 20000^2 mesh is cut
to 4096^2 by the O(area) host planning), coef 0.1.  Phases, one JSON line
each:

1. card: name and power limit, as nvidia-smi gives them (also printed
   raw on a line of their own);
2. build: the CUDA kernels, compiled from kernels/csrc/*.cu for sm_90a,
   and beside them the probes of tools/spmv_probes.cu;
3. setup: the matrix, the base plan and the push plan (ScatterPlan) from
   the plan cache (comm/plan_cache.py), the eight forward and four
   transposed engines (all sharing those plans);
4. kernels: each kernel against its plain PyTorch version at the inputs
   its path gives it, with its time, the plain version's on the card, one
   PyTorch library call's where one computes the same function, and the
   least time the card could take (its bound).  The forward kernels run
   at the condensed rung's inputs and are checked on the card:
   unpack_scatter_set and unpack_dest through their plan tables (each
   line also times the kernel that runs without one, no_table_ms; B3's
   bound counts the table it reads, bound_plan_arrays_ms the plan's
   arrays), and on a line of its own unpack_dest_spmv (unpack_dest with
   the dest rungs' slot product as its epilogue) against its plain
   composition (3e-5) and spmv_ref_np (2e-4), beside CSR sparse.mm;
   ellpack_spmv_windowed also in bfloat16 (a second line, against the
   plain version on float32 copies of the bf16 inputs, one bf16 rounding
   apart), and each twice, bit for bit; the push kernels
   (accumulate_segments at its four call sites, accumulate_into) are
   checked bit for bit against their plain versions run on the CPU copy of
   the same inputs (a sequential fold), outside the dump rows, and each
   site's line carries chain_ms (one thread's dependent add chain as long
   as the site's longest row, a probe) and floor_ms = max(bound_ms,
   chain_ms); stencil2d runs on Heat2D's whole padded tile, bit for bit;
5. main path: every rung x {full, dest} forward with use_kernel=True, y
   checked against the numpy reference (rtol/atol 2e-4) and timed;
6. transposed: every rung of DistributedSpMV(transpose=True,
   use_kernel=True), y checked against spmv_t_ref_np (rtol/atol 2e-4) and
   timed;
7. heat2d: every rung x {dest, full} of Heat2D(use_kernel=True), the
   overlap rung split, one stencil pattern and one base plan shared by
   all eight; run(phi, 10) checked bit for bit against ten plain steps on
   the whole field on the card, then timed over run(phi, 20);
8. normal_equations: normal_equations_step(use_kernel=True) on every
   rung, z checked against spmv_t_ref_np(m, spmv_ref_np(m, x)) (rtol 2e-4,
   atol 2e-4 max|z|) and timed; ConjugateGradient on the condensed rung
   for ten iterations against the same ten with use_kernel=False (rel
   1e-4), its residual norm below the start's;
9. serve: llama3-8b at its published widths and depth (32 layers, d 4096,
   32/8 heads of 128, d_ff 14336, vocab 128256), bf16, random weights from
   the seed, through launch.serve's engine: 16 requests of uniform length
   in [1025, 2048] (launch.serve's draw for --prompt-len 2048), 32 tokens
   each, 8 slots, two arrivals a tick, prefill chunks of 512, cache_len
   2080; decode tokens/s, per-token p50/p99, mean TTFT, decode_attention
   launches (32 per decode tick), one decode step's logits with
   decode_attention against the plain attention's (relative L2 under
   2e-2), and the busy share over three decode steps;
10. hybrid_serve: hymba-1.5b at its published widths and depth (32
   layers, d 1600, 25/5 heads of 64, d_ff 5504, d_inner 3200, window
   1024), bf16, random weights from the seed, through launch.serve's
   batched demo (setup_batch_demo, run_batch_demo): batch 4, a prompt of
   1040 through the sequential decode scan on a ring cut to the window
   (it wraps; decode runs past the window), 32 tokens; decode_attention
   launches (32 a step), one decode step with B8 against the plain
   attention (bf16 and a float32 twin: relative L2 under 5e-2 and 1e-3),
   B8 on that step's own inputs at group 5 on the wrapped ring against
   its plain version (a kernel line beside SDPA), decode tokens/s, step
   ms, busy share, prefill s, weights GB and peak memory; then
   build_prefill at B = 1, L = 4096 (the banded attention schedule):
   selective_scan launches (32), layer 0's call against the plain
   recurrence on its own inputs at 2e-4 (kernel line
   selective_scan_di3200), ms per prefill;
11. encdec_serve: whisper-tiny at its published widths (4 + 4 layers, d
   384, 6 heads of 64, 1500 frames, vocab 51865) the same way: batch 8,
   prompt 64, 32 tokens, the random frames encoded and prefill_cross run
   once, B8 twice a layer and step (self, and cross over the 1500
   frames), held at group 1 on both;
12. vlm_serve: llama-3.2-vision-90b at its published widths (d 8192,
   64/8 heads of 128, d_ff 28672, vocab 128256, 1601 image tokens), 20 of
   its 100 layers (4 of its 20 cross-attention groups), the same way:
   batch 4, prompt 128, 32 tokens, B8 held at group 8 on the
   self-attention ring and on the 1601 image slots, the float32 twin of
   one group;
13. ssm_prefill: falcon-mamba-7b at its published widths and depth (64
   layers, d 4096, d_inner 8192, state 16, vocab 65024), bf16:
   build_prefill at B = 1 and L = 32768 (prefill_32k's length, batch cut
   to 1 for one card), ms per prefill, tokens/s, selective_scan launches
   (64 per prefill), and the logits with the kernel against the plain
   recurrence's at L = 1024 (relative L2 under 2e-2);
14. moe_serve: mixtral-8x22b at its published widths (d 6144, 48/8 heads
   of 128, d_ff 16384, 8 experts top-2, vocab 32768), 8 of its 56 layers,
   bf16, through launch.serve with --moe-comm --mesh 8: each decode step's
   MoE FFN through one DynamicMoELayer over LoopbackComm(8), its tables
   derived on the card from the step's routing, prefill through moe_fwd;
   after a warm-up batch the serve phase's traffic (16 requests, 8 slots,
   prompts in [1025, 2048], 32 tokens, chunks of 512, cache_len 2080, so
   the 4096 window never binds); no host plan build and one device
   derivation per layer and decode tick (telemetry), B8 launched once per
   layer and tick; one tick's derivation under
   torch.cuda.set_sync_debug_mode("error"), its tables equal to the host
   planner's at the envelope s_max; the hook's ms per layer split into
   derivation, dispatch, experts and combine; a float32 twin of 2 layers
   whose decode logits through the hook are within 1e-3 (relative L2) of
   moe_fwd's; B8 at group 6 against its plain version at 2e-4 (a kernel
   line of its own, beside SDPA and its bound); and model_rows pricing the
   dispatch and combine with the decode floors (eqs. 12δ-15δ);
15. gnn: GNNNeighborAggregate over LoopbackComm(8) on a Zipf(1.1) graph of
   2^19 nodes, 16 neighbors, 64 float32 features, on the condensed rung
   and under auto, each against gnn_ref_np (rtol/atol 2e-4), timed, with
   its busy share and a model_row;
16. train: llama3-8b at its published widths (d 4096, 32/8 heads of 128,
   d_ff 14336, vocab 128256), 8 of its 32 layers (2.80B parameters: their
   float32 master weights, gradients and two moments take ~45 GB),
   trained through launch.train (setup and its Trainer's step) at
   train_4k's length 4096 with the global batch cut to 8 (accumulation 4,
   microbatch 2), remat full, bf16 activations, random master weights
   from the seed: 1 warm-up and 3 timed steps (CUDA events), ms a step,
   tokens/s, MFU against the bf16 spec peak and against a bf16 matmul
   measured in the run, peak memory, every loss and gradient norm, and one
   more step under torch.profiler split by region (the training
   attention's einsums and elementwise passes, the fused CE, AdamW, the
   rest's matmuls and elementwise; marker kernels bracket the regions)
   with its busy share (the embedding's gather and backward a region of
   their own), and the embedding's backward at one microbatch timed
   through the reference's bf16 add and through the float32 add it
   replaced; every loss and gradient norm finite and the first loss
   within 2 of ln(128256).  Then train_twin: a float32 twin of
   reduced llama3-8b and of reduced mixtral-8x22b takes one train step on
   the card and on the CPU (TF32 off), every leaf's gradient within 1e-4
   of the leaf's largest element, loss, gradient norm and parameters
   within 1e-4; and train_lm100m: launch.train.main on lm100m, 30 steps at
   seq 256, batch 8, a checkpoint every 15 steps, the loss falling by more
   than 0.3, then the run resumed from its step-15 checkpoint giving steps
   15-29's losses bit for bit.  The dense and MoE training paths launch no
   kernel (the reference trains through plain jnp);
17. train_ssm: falcon-mamba-7b at its published widths (d 4096, d_inner
   8192, state 16, dt rank 256, vocab 65024), 16 of its 64 layers (~2.2B
   parameters, ~36 GB at 16 B a parameter; 64 would need ~117 GB), trained
   through launch.train as phase 16 (seq 4096, batch 8, accum 4, remat
   full, bf16 over float32 master weights): 1 warm-up and 3 timed steps,
   one profiled step split by region (selective_scan for B9's forward,
   selective_scan_bwd for its backward kernel); B9's forward launched
   layers x microbatches x 2 a step (remat full runs it again in the
   backward), its backward layers x microbatches, the plain scan and the
   plain backward never called; the backward kernel on the inputs of the
   warm-up's first backward call (the kernel line selective_scan_bwd:
   every gradient within 2e-4 of the plain backward's largest element,
   two more launches bit for bit with the step's, its bound from the
   function's own bytes and one exponential a (step, channel, state) over
   the SMs' special-function lanes) and, beside it, the checkpointing
   forward on the inputs of the warm-up's first forward call (y within
   2e-4 of the plain recurrence, bit for bit with the serving entry's,
   its ms beside the serving entry's); then train_hybrid: hymba-1.5b at
   its published widths and depth the same way with 2 timed steps (B9's
   backward at d_inner 3200 beside the banded attention; kernel line
   selective_scan_bwd_di3200).  The train_twin phase holds reduced
   falcon-mamba-7b and hymba-1.5b too.  MFU counts 6 N tokens
   (runtime/steps.model_flops): the scan's own work is outside it.
The model lines (phase "model"; the §5 models of core/perfmodel.py on
this card): right after setup, calibration (core/tune.py's four
parameters for one rank of LoopbackComm(8), the stacked probes' raw
times, tau's wall and event times, the card's copy and gather rates);
after phase 5 and in phase 7, auto (DistributedSpMV(strategy="auto") with
use_kernel for full and dest, Heat2D(strategy="auto") dest, each with its
base plan a memory hit of the plan cache: its predicted_times, its pick,
the measured-fastest rung of the phase and the regret, the pick's
measured ms over the best's); after phase 8, one model_row for each
measured configuration of phases 5 to 8 (the step time those phases
measured beside the §5 prediction priced as the engine runs, model_error,
error_budget, busy share) and plan_cache (the cache's counters and the
seconds a memory hit saves over the build within the process, the base
plan's bytes and whether its entry reached the disk tier). They fail the
run when a prediction is not a positive number, a calibration value lies
outside CALIBRATION_RANGE, an auto pick is not the argmin of its own
ranking, or an auto engine's output differs from the fixed-rung engine it
resolved to (bit for bit; the forward dest rungs may hold to
unpack_dest_spmv's 3e-5 instead). A model miss, even past its budget, is printed, never a failure.
In phases 5 to 14 and 17 the kernel launch counters are zeroed just
before the path runs and read just after, and every kernel of the path
must have launched; in phases 5, 7 and 8 every launch of unpack_dest and
unpack_scatter_set must have gone through its plan table (the counts by C
entry point show it).  The kernel phase also holds decode_attention (one
decode step of phase 9: 8 lanes, a bf16 ring of 2080 slots; then, on a
line of its own beside SDPA, decode_32k's 32768-slot cache with the batch
cut to 8) and selective_scan (one falcon-mamba layer at L = 32768)
against their plain versions at 2e-4, each with the device time of every
kernel it launches (torch.profiler) and ptxas's registers and spills.

Then one line {"kernels": [...]} with all ten kernels' numbers (the nine
TPU kernels' and B9's backward, whose launches are the train phases'), and
last
{"ok": true, "device": {...}}.  Any failure exits non-zero before the last
line; with no CUDA device, or outside a checkout of the repository, the
script exits non-zero at once.
"""
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

N = 1 << 22
R_NZ = 16
P = 8
SHARDS_PER_NODE = 4
BLOCKSIZE = 1024
SEED = 1
STRATEGIES = ("replicate", "blockwise", "condensed", "overlap")
HEAT_N = 4096           # the field is HEAT_N x HEAT_N
MPROCS, NPROCS = 2, 4
HEAT_COEF = 0.1
HEAT_CHECK_STEPS, HEAT_TIMED_STEPS = 10, 20
CG_ITERS = 10
Y_TOL = dict(rtol=2e-4, atol=2e-4)     # as examples/spmv_strategies.py
SPMV_TOL = dict(rtol=3e-5, atol=3e-5)  # float32 sums in another order
# LM serving: llama3-8b through launch.serve (16 requests of uniform length
# in [1025, 2048], 32 tokens each, 8 slots, two arrivals a tick, chunks of
# 512, cache_len 2080), falcon-mamba-7b's prefill at the prefill_32k length
SERVE_ARGV = ["--arch", "llama3-8b", "--requests", "16", "--slots", "8",
              "--prompt-len", "2048", "--gen", "32", "--prefill-chunk", "512",
              "--seed", str(SEED)]
SSM_L = 32768
SSM_CHECK_L = 1024     # the plain recurrence loops in Python: a shorter L
# layers (of 64) whose selective_scan call in the 32k prefill is held
# against the plain recurrence on the very inputs the prefill gave it
SSM_HELD_LAYERS = (0, 63)
# The hybrid, encoder-decoder and vision families through launch.serve's
# batched demo at their published widths: hymba-1.5b with a prompt of 1040
# on a ring cut to its window of 1024 (the ring wraps and decode runs past
# the window) and its forward at L = 4096 (the banded attention schedule,
# B9 at d_inner 3200); whisper-tiny over its 1500 frames; the vision model
# cut to 20 of its 100 layers (4 of 20 cross-attention groups: 19.2B
# parameters, ~38 GB of bf16; the 100 would need 175 GB), its float32 twin
# one group
HYBRID_ARGV = ["--arch", "hymba-1.5b", "--batch", "4", "--prompt-len",
               "1040", "--gen", "32", "--seed", str(SEED)]
HYBRID_PREFILL_L = 4096
ENCDEC_ARGV = ["--arch", "whisper-tiny", "--batch", "8", "--prompt-len",
               "64", "--gen", "32", "--seed", str(SEED)]
VLM_ARGV = ["--arch", "llama-3.2-vision-90b", "--batch", "4",
            "--prompt-len", "128", "--gen", "32", "--seed", str(SEED)]
VLM_LAYERS = 20
VLM_TWIN_LAYERS = 5
# MoE serving: mixtral-8x22b at its published widths through launch.serve
# with --moe-comm over LoopbackComm(8) (one expert a rank), the serve
# phase's traffic; its 56 layers cut to 8 (8 x 4.8 GB of bf16 experts on
# one card); a warm-up batch of short prompts before the measured run; a
# float32 twin of its first 2 layers holds the hook against moe_fwd
MOE_ARGV = ["--arch", "mixtral-8x22b", "--requests", "16", "--slots", "8",
            "--prompt-len", "2048", "--gen", "32", "--prefill-chunk", "512",
            "--moe-comm", "--mesh", "8", "--seed", str(SEED)]
MOE_LAYERS = 8
MOE_TWIN_LAYERS = 2
MOE_WARMUP = dict(requests=8, prompt_len=64, gen=4)
# GNN: GNNNeighborAggregate over LoopbackComm(8) on a Zipf power-law graph
# (ogbn-products' 2.4M nodes cut to 2^19: see PERF.md section 4), 16
# neighbors, 64 float32 features; the condensed rung and auto, 3 timed
# steps each after 2
GNN_N = 1 << 19
GNN_R = 16
GNN_D = 64
GNN_ALPHA = 1.1
GNN_TOL = dict(rtol=2e-4, atol=2e-4)    # tests/test_gnn.py's
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py's, B8/B9
# Training: llama3-8b at its published widths through launch.train, 8 of
# its 32 layers (float32 master weights, gradients and two moments take 16
# B a parameter: 8 layers are 2.80B parameters, ~45 GB; 32 would need 128
# GB), train_4k's length with its global batch 256 cut to 8 (accumulation
# 4, microbatch 2); 1 warm-up step and 3 timed; then float32 twins of the
# reduced llama3-8b and mixtral-8x22b, one step on the card against the
# CPU, and lm100m end to end with a checkpoint and a resume
TRAIN_ARGV = ["--arch", "llama3-8b", "--seq", "4096", "--batch", "8",
              "--accum", "4", "--seed", str(SEED)]
TRAIN_LAYERS = 8
TRAIN_TIMED = 3
TRAIN_TWINS = ("llama3-8b", "mixtral-8x22b", "falcon-mamba-7b",
               "hymba-1.5b")
TRAIN_TWIN_ARGV = ["--seq", "64", "--batch", "8", "--accum", "2",
                   "--seed", str(SEED)]
TRAIN_TWIN_TOL = 1e-4
# Training the ssm and hybrid families through B9 and its backward:
# falcon-mamba-7b at its published widths, 16 of its 64 layers (~105M
# parameters a layer and 0.53B for the embedding and head: ~2.2B, ~36 GB at
# 16 B a parameter; 64 layers would need ~117 GB), and hymba-1.5b at its
# published widths and depth (1.66B, ~27 GB), both at train_4k's length
# with the global batch 256 cut to 8 (accumulation 4, microbatch 2), remat
# full, bf16 activations over float32 master weights
TRAIN_SSM_ARGV = ["--arch", "falcon-mamba-7b", "--seq", "4096", "--batch",
                  "8", "--accum", "4", "--seed", str(SEED)]
TRAIN_SSM_LAYERS = 16
TRAIN_SSM_TIMED = 3
TRAIN_HYBRID_ARGV = ["--arch", "hymba-1.5b", "--seq", "4096", "--batch",
                     "8", "--accum", "4", "--seed", str(SEED)]
TRAIN_HYBRID_TIMED = 2
# the backward kernel against the plain backward: each gradient within
# this share of its largest element
SCAN_BWD_TOL = 2e-4
LM100M_ARGV = ["--preset", "lm100m", "--steps", "30", "--seq", "256",
               "--batch", "8", "--save-every", "15",
               "--log-every", "10", "--seed", str(SEED)]
LM100M_RESUME = 15
# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12
BF16_OUT_TOL = dict(rtol=2.0 ** -8, atol=2e-4)   # plus one bf16 rounding
# relative L2 error of the logits, kernel vs plain inside the whole model:
# in float32 the two differ only in summation order; in bf16 a rounding
# that order flips grows through the random layers (phase 9: 32 layers,
# one step's attention), so the bf16 bound is loose and the float32 one
# tight
LOGITS_REL_F32 = 1e-3
LOGITS_REL_BF16 = 5e-2

# H100 SXM published peaks (NVIDIA data sheet): 3.35 TB/s HBM,
# 67 TFLOP/s float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# exponentials a second: 16 special-function lanes an SM a clock, 132 SMs
# at the 1.98 GHz boost clock (H100 SXM)
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# cycles a second of torch.cuda._sleep's spin: the H100's top clock (1.98
# GHz) rounded up, so a spin lasts at least the time asked for
SPIN_CYCLES_PER_S = 2e9

PROBES_SRC = pathlib.Path(__file__).resolve().parent / "tools" / \
    "spmv_probes.cu"

SOURCE = {
    "pack_gather": ("src/repro_torch/kernels/csrc/pack_gather.cu",
                    "src/repro/kernels/pack_gather.py:119"),
    "unpack_scatter_set": ("src/repro_torch/kernels/csrc/pack_gather.cu",
                           "src/repro/kernels/pack_gather.py:240"),
    "unpack_dest": ("src/repro_torch/kernels/csrc/pack_gather.cu",
                    "src/repro/kernels/pack_gather.py:185"),
    "ellpack_spmv_windowed": ("src/repro_torch/kernels/csrc/ellpack_spmv.cu",
                              "src/repro/kernels/ellpack_spmv.py:79"),
    "accumulate_segments": ("src/repro_torch/kernels/csrc/accumulate.cu",
                            "src/repro/kernels/pack_gather.py:277"),
    "accumulate_into": ("src/repro_torch/kernels/csrc/accumulate.cu",
                        "src/repro/kernels/pack_gather.py:301"),
    "stencil2d": ("src/repro_torch/kernels/csrc/stencil2d.cu",
                  "src/repro/kernels/stencil2d.py:60"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:95"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:71"),
    # the reference differentiates its chunked associative scan with
    # jax.grad: no Pallas kernel, the backward of the scan at ssm.py:67
    "selective_scan_bwd": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                           "src/repro/models/ssm.py:67"),
}
FORWARD_KERNELS = ("pack_gather", "unpack_scatter_set", "unpack_dest",
                   "ellpack_spmv_windowed")
PUSH_KERNELS = ("accumulate_segments", "accumulate_into")


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start
    of the run (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _START, 1)}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.  A
    marker kernel holds the device while the host enqueues the calls, so
    the events time the device's work even where the host enqueues a call
    more slowly than the device runs it (a short kernel behind a Python
    wrapper)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (2 * iters * enqueue_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_bound(what: str, res: dict) -> None:
    """A kernel that beats its bound shows the bound counts work the
    function does not need."""
    check(res["ms"] >= res["bound"][0],
          f"{what} ran in {res['ms']} ms, under its bound "
          f"{res['bound'][0]} ms: the bound is wrong")


def unique_rows(torch, idx, mask=None) -> int:
    """Distinct (rank, row) pairs read through ``idx`` (P, ...)."""
    total = 0
    for q in range(idx.shape[0]):
        sel = idx[q].reshape(-1)
        if mask is not None:
            sel = sel[mask[q].reshape(-1) != 0]
        total += int(torch.unique(sel).numel())
    return total


def phase_card(torch) -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    return line


def load_probes():
    """The probe kernels of tools/spmv_probes.cu, built beside the port's
    kernels: ``(library, build info)``."""
    import ctypes

    from repro_torch.kernels import _build
    lib, info = _build.build_library([PROBES_SRC], "spmv_probes")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.probe_add_chain.argtypes = [ptr, i64, ptr]
    lib.probe_spmv_gathers.argtypes = [ptr, ptr, ptr] + [i64] * 6 + [ptr]
    lib.probe_gather_list.argtypes = [ptr, ptr, ptr, i64, ptr]
    lib.probe_dest_sorted_arrays.argtypes = [ptr] * 8 + [i64] * 5 + [ptr]
    lib.probe_dest_codes.argtypes = [ptr] * 5 + [i64] * 4 + [ptr]
    for fn in (lib.probe_add_chain, lib.probe_spmv_gathers,
               lib.probe_gather_list, lib.probe_dest_sorted_arrays,
               lib.probe_dest_codes):
        fn.restype = ctypes.c_int
    return lib, info


def phase_build():
    """Build the port's kernels and the probes, the two nvcc runs side by
    side; returns the probes' library."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        probes = pool.submit(load_probes)
        _build.load()
        probes, probe_info = probes.result()
    info = _build.build_info()
    print(info["log"], file=sys.stderr, flush=True)   # ptxas registers/spills
    emit({"phase": "build", "nvcc_seconds": round(info["seconds"], 3),
          "probes_nvcc_seconds": round(probe_info["seconds"], 3),
          "load_seconds": round(time.perf_counter() - t0, 3),
          "built": info["built"], "library": pathlib.Path(info["path"]).name})
    return probes


def phase_kernels(torch, matrix, x_host, engines, y_ref):
    """Every kernel against its plain version at the main path's inputs."""
    from repro_torch.comm.strategies import own_offsets
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    full = engines[("condensed", "full")]
    dev = full.comm.device
    dest = engines[("condensed", "dest")]
    plan = full.plan
    shard, s_max = plan.shard_size, plan.s_max
    x = full.shard_vector(x_host)
    send_idx, recv_idx = full.gather.plan_args
    send_flat = send_idx.reshape(P, -1)
    recv_gidx = recv_idx.reshape(P, -1)
    results = {}

    # B1 pack_gather: the condensed pack, m = P * s_max per rank
    buf = kops.pack_gather(x, send_flat)
    buf_ref = kref.pack_gather_ref(x, send_flat)
    check(torch.equal(buf, buf_ref), "pack_gather differs from plain")
    gidx = (send_flat.long() + (torch.arange(P, device=dev) * shard)[:, None]
            ).reshape(-1)
    x_flat = x.reshape(-1)
    check(torch.equal(torch.index_select(x_flat, 0, gidx).reshape(P, -1),
                      buf_ref), "index_select disagrees with pack_gather")
    m = send_flat.shape[1]
    results["pack_gather"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: kops.pack_gather(x, send_flat)),
        plain_ms=cuda_ms(torch, lambda: kref.pack_gather_ref(x, send_flat)),
        library_ms=cuda_ms(torch, lambda: torch.index_select(x_flat, 0,
                                                             gidx)),
        bound=bound(P * m * 4 + P * m * 4
                    + unique_rows(torch, send_flat) * 4),
        shape=f"x ({P}, {shard}) f32, idx ({P}, {m}) int32")

    recv = full.comm.all_to_all(buf.reshape(P, P, s_max)).wait()
    recv_flat = recv.reshape(P, -1)
    offsets = own_offsets(P, shard, dev)

    # B2 unpack_scatter_set: the condensed full unpack, out_len = n + 1,
    # through the plan's tile table (the path's kernel) and, timed beside
    # it, the three-phase kernel that runs without one
    tiles = kops.ScatterTiles()(recv_gidx, out_len=N + 1, row_bytes=4)
    check(tiles is not None, "the condensed plan got no tile table")

    def b2(fn, **kw):
        return fn(recv_flat, recv_gidx, x, offsets, out_len=N + 1, **kw)
    x_copy = b2(kops.unpack_scatter_set, table=tiles)
    x_copy_ref = b2(kref.unpack_scatter_set_ref)
    check(torch.equal(x_copy[:, :N], x_copy_ref[:, :N]),
          "unpack_scatter_set differs from plain outside the dump row")
    check(torch.equal(b2(kops.unpack_scatter_set)[:, :N], x_copy_ref[:, :N]),
          "unpack_scatter_set without its table differs from plain")
    r = recv_flat.shape[1]
    results["unpack_scatter_set"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: b2(kops.unpack_scatter_set, table=tiles)),
        no_table_ms=cuda_ms(torch, lambda: b2(kops.unpack_scatter_set)),
        plain_ms=cuda_ms(torch, lambda: b2(kref.unpack_scatter_set_ref)),
        library_ms=None,
        bound=bound(P * r * 8 + P * shard * 4 + P * 4 + P * (N + 1) * 4),
        shape=f"recv ({P}, {r}) f32 -> x_copy ({P}, {N + 1})")
    del tiles

    # B3 unpack_dest: the condensed targeted unpack into the EllPack slots,
    # through the plan's dest table (one code and one slot a slot: 6 bytes
    # where the plan's arrays take 10) and, beside it, the kernel that reads
    # the plan's arrays
    d_send, d_recv, src, own, own_m, rem_m = dest.gather.plan_args
    check(torch.equal(d_send, send_idx) and torch.equal(d_recv, recv_idx),
          "the two condensed engines planned different exchanges")
    dargs = (recv_flat, x, src, own, own_m, rem_m)
    table = kops.DestOrder()(src, own, own_m, rem_m)
    check(table is not None, "the condensed plan got no dest table")
    slots = kops.unpack_dest(*dargs, table=table)
    slots_ref = kref.unpack_dest_ref(*dargs)
    check(torch.equal(slots, slots_ref), "unpack_dest differs from plain")
    check(torch.equal(kops.unpack_dest(*dargs), slots_ref),
          "unpack_dest without its table differs from plain")
    L = src.shape[1]
    gathered = (unique_rows(torch, src, rem_m)
                + unique_rows(torch, own, own_m)) * 4
    results["unpack_dest"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: kops.unpack_dest(*dargs, table=table)),
        no_table_ms=cuda_ms(torch, lambda: kops.unpack_dest(*dargs)),
        plain_ms=cuda_ms(torch, lambda: kref.unpack_dest_ref(*dargs)),
        library_ms=None,
        bound=bound(P * L * (4 + 2 + 4) + gathered),
        # the bound on what the kernel without a table reads: the plan's
        # four arrays and the output, 14 bytes a slot
        bound_plan_arrays_ms=bound(P * L * (4 + 4 + 1 + 1 + 4)
                                   + gathered)[0],
        shape=f"recv ({P}, {r}), x ({P}, {shard}) f32, L = {L} slots")
    del table, slots, slots_ref

    # B4 ellpack_spmv_windowed: the on-copy SpMV of the full rungs
    local_fn, (diag, vals, win_blk, cols_rel, own_rel), window, rpb = \
        spmv_inputs(torch, matrix, dev)
    # the library's yardstick of both SpMV lines: one CSR product of D + A
    # (cuSPARSE) on the global x
    csr = _csr_d_plus_a(torch, matrix, dev)
    x_col = x_flat[:, None]
    y_lib = torch.sparse.mm(csr, x_col)
    check(np.allclose(y_lib.reshape(-1).cpu().numpy(), y_ref, **Y_TOL),
          "the CSR library product disagrees with spmv_ref_np")
    library_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, x_col))

    # unpack_dest_spmv: B3 with the dest rungs' slot product as its
    # epilogue (a launch of unpack_dest), through the dest table in groups
    # of whole rows, held against the plain composition and spmv_ref_np
    ftable = kops.DestOrder(row=R_NZ)(src, own, own_m, rem_m)
    y_fused = kops.unpack_dest_spmv(*dargs, vals, diag, table=ftable)
    y_composed = kref.unpack_dest_spmv_ref(*dargs, vals, diag)
    torch.testing.assert_close(y_fused, y_composed, **SPMV_TOL)
    check(np.allclose(y_fused.reshape(-1).cpu().numpy(), y_ref, **Y_TOL),
          "unpack_dest_spmv disagrees with spmv_ref_np")
    fused = dict(
        max_abs_err=float((y_fused - y_composed).abs().max()),
        ms=cuda_ms(torch, lambda: kops.unpack_dest_spmv(
            *dargs, vals, diag, table=ftable)),
        plain_ms=cuda_ms(torch, lambda: kref.unpack_dest_spmv_ref(
            *dargs, vals, diag)),
        library_ms=library_ms,
        # the table and vals streamed once, diag, x and y once a row (the
        # owned slots read rows of x that the diagonal term reads anyway),
        # and every gathered row of recv once
        bound=bound(P * L * (4 + 2 + 4) + P * shard * 12
                    + unique_rows(torch, src, rem_m) * 4,
                    flops=2.0 * P * (L + shard)),
        shape=f"L = {L} slots, vals ({P}, {shard}, {R_NZ}) f32 -> y")
    del ftable, y_fused, y_composed
    y = local_fn(diag, vals, x_copy, win_blk, cols_rel, own_rel)
    y_plain = kref.ellpack_spmv_ref(diag, vals, cols_rel, own_rel, win_blk,
                                    x_copy, window=window,
                                    rows_per_block=rpb)
    torch.testing.assert_close(y, y_plain, **SPMV_TOL)
    err = float((y - y_plain).abs().max())
    again = local_fn(diag, vals, x_copy, win_blk, cols_rel, own_rel)
    check(torch.equal(y.view(torch.int32), again.view(torch.int32)),
          "ellpack_spmv_windowed gave other bits on a second call")
    check(np.allclose(y.reshape(-1).cpu().numpy(), y_ref, **Y_TOL),
          "the on-copy SpMV disagrees with spmv_ref_np")
    x_read = spmv_x_read(torch, win_blk, cols_rel, window, rpb)
    results["ellpack_spmv_windowed"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: local_fn(diag, vals, x_copy, win_blk,
                                           cols_rel, own_rel)),
        plain_ms=cuda_ms(torch, lambda: kref.ellpack_spmv_ref(
            diag, vals, cols_rel, own_rel, win_blk, x_copy, window=window,
            rows_per_block=rpb)),
        library_ms=library_ms,
        bound=bound(P * shard * (4 + 4 + 4) + P * shard * R_NZ * 8
                    + win_blk.numel() * 4 + x_read * 4,
                    flops=2.0 * P * shard * (R_NZ + 1)),
        shape=f"rows ({P}, {shard}) x r_nz {R_NZ} f32 on x_copy "
              f"({P}, {N + 1})")
    # the same product in bfloat16 (diag, vals and x; y in bfloat16), held
    # against the plain version on float32 copies of the same bf16 inputs
    # (float32 sums, so one bf16 rounding apart), twice for repeatability
    bf = [t.to(torch.bfloat16) for t in (diag, vals, x_copy)]
    y16 = local_fn(bf[0], bf[1], bf[2], win_blk, cols_rel, own_rel)
    want16 = kref.ellpack_spmv_ref(bf[0].float(), bf[1].float(), cols_rel,
                                   own_rel, win_blk, bf[2].float(),
                                   window=window, rows_per_block=rpb)
    check(y16.dtype == torch.bfloat16 and torch.allclose(
        y16.float(), want16, **BF16_OUT_TOL),
        "ellpack_spmv_windowed in bfloat16 differs from its plain version")
    again = local_fn(bf[0], bf[1], bf[2], win_blk, cols_rel, own_rel)
    check(torch.equal(y16.view(torch.int16), again.view(torch.int16)),
          "ellpack_spmv_windowed in bfloat16 gave other bits on a second "
          "call")
    # the library's yardstick in bfloat16: the same CSR product, its values
    # and x rounded to bfloat16 (timed only; the float32 line checks it)
    csr16 = torch.sparse_csr_tensor(
        csr.crow_indices(), csr.col_indices(),
        csr.values().to(torch.bfloat16), csr.shape)
    x_col16 = x_col.to(torch.bfloat16)
    try:
        torch.sparse.mm(csr16, x_col16)
        library16 = cuda_ms(torch, lambda: torch.sparse.mm(csr16, x_col16))
    except (RuntimeError, NotImplementedError) as exc:
        # this torch build refuses a bfloat16 CSR product on the card
        emit({"phase": "kernel", "name": "ellpack_spmv_windowed",
              "library_refused": f"sparse.mm on bfloat16 CSR: {exc}"[:300]})
        library16 = None
    bf16_line = dict(
        max_abs_err=float((y16.float() - want16).abs().max()),
        ms=cuda_ms(torch, lambda: local_fn(bf[0], bf[1], bf[2], win_blk,
                                           cols_rel, own_rel)),
        plain_ms=cuda_ms(torch, lambda: kref.ellpack_spmv_ref(
            bf[0], bf[1], cols_rel, own_rel, win_blk, bf[2], window=window,
            rows_per_block=rpb)),
        library_ms=library16,
        bound=bound(P * shard * (2 + 4 + 2) + P * shard * R_NZ * 6
                    + win_blk.numel() * 4 + x_read * 2,
                    flops=2.0 * P * shard * (R_NZ + 1)),
        shape=f"rows ({P}, {shard}) x r_nz {R_NZ} bf16 on x_copy "
              f"({P}, {N + 1}) bf16")
    del bf, y16, want16, again, csr16, x_col16
    lines = list(results.items()) + [("ellpack_spmv_windowed", bf16_line),
                                     ("unpack_dest_spmv", fused)]
    for name, res in lines:
        emit({"phase": "kernel", "name": name, "shape": res["shape"],
              "max_abs_err": res["max_abs_err"], "ms": res["ms"],
              "plain_ms": res["plain_ms"], "library_ms": res["library_ms"],
              "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
              **{k: res[k] for k in ("no_table_ms", "bound_plan_arrays_ms")
                 if k in res}})
        check_bound(name, res)
    return results


def spmv_x_read(torch, win_blk, cols_rel, window: int, rpb: int) -> int:
    """Distinct (rank, position) pairs of x that B4 reads: every column and
    every own row."""
    shard = cols_rel.shape[1]
    cols_abs = (win_blk.long() * window).repeat_interleave(
        rpb, dim=1)[:, :, None] + cols_rel
    return sum(int(torch.unique(torch.cat([
        cols_abs[q].reshape(-1), q * shard + torch.arange(
            shard, device=cols_rel.device)])).numel()) for q in range(P))


def spmv_inputs(torch, matrix, dev):
    """B4's inputs on the full rungs: ``(local_fn, (diag, vals, win_blk,
    cols_rel, own_rel), window, rows_per_block)`` from
    ``make_spmv_on_copy_sharded``, rank-stacked on ``dev``."""
    from repro_torch.kernels import ops as kops
    shard = N // P
    local_fn, kplan = kops.make_spmv_on_copy_sharded(matrix.cols, P)
    win_blk, cols_rel, own_rel = (torch.as_tensor(a).to(dev) for a in kplan)
    diag = torch.as_tensor(matrix.diag).to(dev).reshape(P, shard)
    vals = torch.as_tensor(matrix.vals).to(dev).reshape(P, shard, R_NZ)
    return (local_fn, (diag, vals, win_blk, cols_rel, own_rel),
            _on_copy_window(matrix.cols), min(256, shard))


def push_sites(torch, matrix, x_host, t_engines):
    """The push kernels' five call sites on the transposed main path:
    ``{site: (kernel, init, vals, idx, table, out_len)}`` on the card, and
    the own-target fold's result computed on the CPU (the condensed
    finish's init)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    cond, blk, rep = (t_engines[s].scatter
                      for s in ("condensed", "blockwise", "replicate"))
    dev = cond.comm.device
    plan = cond.splan
    shard, s_max, b_max = plan.shard_size, plan.s_max, plan.b_max
    nblk = plan.blocks_per_shard
    x = cond.shard_vector(x_host)
    vals = torch.as_tensor(matrix.vals).reshape(P, -1, R_NZ).to(dev)
    lanes = (vals * x[:, :, None]).reshape(P, -1)     # the contributions
    c_msg, c_unpack, c_own = (a.reshape(P, -1) for a in cond.plan_args[:3])
    b_msg, b_unpack = (a.reshape(P, -1) for a in blk.plan_args[:2])
    width = b_max * BLOCKSIZE

    def landed(src, idx, table, out_len, per_rank):
        buf = kops.accumulate_segments(src, idx, out_len=out_len,
                                       table=table)
        return cond.comm.all_to_all(
            buf[:, :P * per_rank].reshape(P, P, per_rank)).wait()

    recv_c = landed(lanes, c_msg, cond.tables["pack"], P * s_max + 1,
                    s_max).reshape(P, -1)
    recv_b = landed(lanes, b_msg, blk.tables["pack"], P * width + 1,
                    width).reshape(P, -1, BLOCKSIZE)
    own_cpu = kref.accumulate_segments_ref(lanes.cpu(), c_own.cpu(),
                                           out_len=shard + 1)
    own = own_cpu.to(dev)
    sites = {
        "pack": ("accumulate_segments", None, lanes, c_msg,
                 cond.tables["pack"], P * s_max + 1),
        "own": ("accumulate_segments", None, lanes, c_own,
                cond.tables["own"], shard + 1),
        "replicate": ("accumulate_segments", None, lanes,
                      rep.plan_args[0].reshape(P, -1), rep.tables["all"], N),
        "blocks": ("accumulate_segments", None, recv_b, b_unpack,
                   blk.tables["blocks"], nblk + 1),
        "into": ("accumulate_into", own, recv_c, c_unpack,
                 cond.tables["into"], shard + 1),
    }
    return sites, own_cpu


def push_bound(table, src, init):
    """B5/B6's bound at one site: the bytes the live rows need — the value
    and index entry of every lane that lands on a live row (dump lanes never
    do; padding lanes carry the identity by construction), the live init
    rows read and the live output rows written."""
    f = int(np.prod(src.shape[2:], dtype=np.int64))
    esize = src.element_size()
    folded = int(table.seg_ptr[:, -1].sum())
    nbytes = (folded * (f * esize + 4)
              + P * table.live_len * f * esize * (1 if init is None else 2))
    return bound(nbytes), folded


def chain_ms(torch, probes, length: int) -> float:
    """Device ms of one thread adding ``length`` float32 values one after
    another (tools/spmv_probes.cu): the floor of a fold whose longest row
    has ``length`` lanes."""
    out = torch.empty(1, device="cuda")

    def run():
        status = probes.probe_add_chain(
            out.data_ptr(), length, torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"probe_add_chain failed: cudaError_t {status}")
    return cuda_ms(torch, run, warmup=1, iters=5)


def phase_push_kernels(torch, matrix, x_host, t_engines, probes):
    """accumulate_segments at its four call sites on the transposed main
    path, and accumulate_into at the condensed finish, each against its
    plain version run on the CPU copy of the same inputs: a sequential
    fold, so the live rows must match bit for bit.  Each site's line also
    carries chain_ms, the time of one dependent add chain as long as its
    longest row, and floor_ms = max(bound_ms, chain_ms)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    sites, own_cpu = push_sites(torch, matrix, x_host, t_engines)
    dev = t_engines["condensed"].comm.device
    per_kernel = {}
    for site, (name, init, src, idx, table, out_len) in sites.items():
        live = table.live_len
        feat = src.shape[2:]
        if init is None:
            def kernel():
                return kops.accumulate_segments(src, idx, out_len=out_len,
                                                table=table)

            def plain():
                return kref.accumulate_segments_ref(src, idx,
                                                    out_len=out_len)
            want = kref.accumulate_segments_ref(src.cpu(), idx.cpu(),
                                                out_len=out_len)
        else:
            def kernel():
                return kops.accumulate_into(init, src, idx, table=table)

            def plain():
                return kref.accumulate_into_ref(init, src, idx)
            want = kref.accumulate_into_ref(own_cpu, src.cpu(), idx.cpu())
        got = kernel()[:, :live].cpu()
        check(torch.equal(got.view(torch.int32),
                          want[:, :live].view(torch.int32)),
              f"{name} ({site}) differs from its plain version on the CPU")
        # the library's yardstick: one index_add_ on rank-offset flat rows
        rows = (idx.long() + (torch.arange(P, device=dev) * out_len)[:, None]
                ).reshape(-1)
        flat_src = src.reshape((-1,) + tuple(feat))
        acc = (init.clone() if init is not None else torch.zeros(
            (P, out_len) + tuple(feat), device=dev)).reshape(
            (-1,) + tuple(feat))
        k_lanes, f = idx.shape[1], int(np.prod(feat, dtype=np.int64))
        site_bound, folded = push_bound(table, src, init)
        longest = table.longest()
        chain = chain_ms(torch, probes, longest)
        res = dict(
            site=site, max_abs_err=float((got - want[:, :live]).abs().max()),
            ms=cuda_ms(torch, kernel), plain_ms=cuda_ms(torch, plain),
            library_ms=cuda_ms(torch, lambda: acc.index_add_(0, rows,
                                                             flat_src)),
            bound=site_bound, chain_ms=chain,
            floor_ms=max(site_bound[0], chain), folded_lanes=folded,
            longest_segment=longest,
            shape=f"vals ({P}, {k_lanes}{', ' + str(f) if feat else ''}) "
                  f"f32 -> ({P}, {out_len}), live {live}")
        emit({"phase": "kernel", "name": name, **{
            k: v for k, v in res.items() if k != "bound"},
            "bound_ms": res["bound"][0], "bound_by": res["bound"][1]})
        check_bound(f"{name} ({site})", res)
        per_kernel.setdefault(name, []).append(res)
    # one entry per kernel: the sum over its call sites on the path
    results = {}
    for name, rs in per_kernel.items():
        results[name] = dict(
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=sum(r["ms"] for r in rs),
            plain_ms=sum(r["plain_ms"] for r in rs),
            library_ms=sum(r["library_ms"] for r in rs),
            bound=(sum(r["bound"][0] for r in rs), "bytes"))
    return results


def _on_copy_window(cols) -> int:
    """The common static window ``make_spmv_on_copy_sharded`` plans."""
    from repro_torch.kernels import ops as kops
    shard = cols.shape[0] // P
    return max(kops.plan_spmv_windows(cols[q * shard:(q + 1) * shard],
                                      rows_per_block=min(256, shard))[0]
               for q in range(P))


def _csr_d_plus_a(torch, matrix, dev):
    """D + A as one CSR tensor on the card (duplicate columns summed)."""
    n = matrix.n
    rows = torch.arange(n, device=dev).repeat_interleave(R_NZ + 1)
    cols = torch.cat([torch.arange(n, device=dev)[:, None],
                      torch.as_tensor(matrix.cols).to(dev).long()], dim=1)
    vals = torch.cat([torch.as_tensor(matrix.diag).to(dev)[:, None],
                      torch.as_tensor(matrix.vals).to(dev)], dim=1)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols.reshape(-1)]),
                                  vals.reshape(-1), (n, n))
    return coo.coalesce().to_sparse_csr()


# the C entry points through which B3 and B2 read their plan tables, and
# those that read the plan's arrays instead, which no path may launch
TABLE_ENTRIES = {"unpack_dest": ("rt_unpack_dest_sorted",
                                 "rt_unpack_dest_spmv_sorted"),
                 "unpack_scatter_set": ("rt_unpack_scatter_tiles",)}
ARRAY_ENTRIES = ("rt_unpack_dest", "rt_unpack_scatter_set")


def entry_diff(kops, before: dict) -> dict:
    """Launches by C entry point since ``before`` (``kops.entry_counts``)."""
    after = kops.entry_counts()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def check_table_variants(where: str, launched: dict, entries: dict) -> None:
    """Every B3/B2 launch of a path went through its plan table."""
    for k in ARRAY_ENTRIES:
        check(not entries.get(k), f"{where} launched {k}, which reads the "
              "plan's arrays: a plan table is missing")
    for kernel, table_entries in TABLE_ENTRIES.items():
        check(sum(entries.get(e, 0) for e in table_entries)
              == launched.get(kernel, 0),
              f"{where}: {kernel} did not launch through its table")


EXPECTED = {  # kernels each rung x materialize launches with use_kernel
    ("replicate", "full"): ("ellpack_spmv_windowed",),
    ("replicate", "dest"): ("unpack_dest",),
}
for _s in ("blockwise", "condensed", "overlap"):
    EXPECTED[(_s, "full")] = ("pack_gather", "unpack_scatter_set",
                              "ellpack_spmv_windowed")
    EXPECTED[(_s, "dest")] = ("pack_gather", "unpack_dest")


def time_steps(torch, step, warmup: int = 5, iters: int = 20) -> dict:
    """Device ms per step (CUDA events), and the host's enqueue and wall
    ms per step over the same back-to-back run."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        step()
    end.record()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"ms_per_iter": start.elapsed_time(end) / iters,
            "host_enqueue_ms_per_iter": (t1 - t0) / iters * 1e3,
            "wall_ms_per_iter": (t2 - t0) / iters * 1e3}


def busy_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_steps(torch, step, steps: int = 3, lead: int = 2,
                  top: int = 6, per_call: int = 1) -> dict:
    """torch.profiler's device activities (kernels, memsets, copies) over
    ``steps`` back-to-back steps: their time per step, by kernel, and the
    device's busy share — the union of their intervals over the span from
    the end of a marker kernel (``torch.cuda._sleep``, enqueued after
    ``lead`` steps, so the queue holds what the host keeps ahead) to the
    end of the last activity.  Kernels side by side count once, so the
    share is at most 1; its complement is the time the device waited.
    ``per_call`` is the number of steps one call of ``step`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # a trace now and then comes back without the marker (the profiler
    # dropped events): one more trace before failing
    for attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                step()
            torch.cuda._sleep(1000)
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        acts = [(e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.device_type == DeviceType.CUDA]
        marks = [end for _, end, name in acts if "spin_kernel" in name]
        if len(marks) == 1:
            break
    check(len(marks) == 1, "the profiler did not see the marker kernel")
    opened = marks[0]
    acts = [(max(start, opened), end, name) for start, end, name in acts
            if end > opened and "spin_kernel" not in name]
    check(acts, "the profiler saw no device time")
    span = max(end for _, end, _ in acts) - opened
    by_name = {}
    for start, end, name in acts:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    rows = sorted(by_name.items(), key=lambda r: -r[1])
    per = steps * per_call * 1e3
    return {"kernel_ms_per_step": sum(by_name.values()) / per,
            "busy_share": busy_us((a, b) for a, b, _ in acts) / span,
            "profiled_span_ms_per_step": span / per,
            "top_kernels_ms_per_step": [[k[:60], t / per]
                                        for k, t in rows[:top]]}


def phase_main_path(torch, engines, x_host, y_ref, card):
    """Every rung x materialize forward, counters zeroed before and read
    after; returns the launch counts and each engine's (timing, profile)."""
    from repro_torch.kernels import ops as kops

    measured = {}
    kops.reset_launch_counts()
    for (strategy, mat), eng in engines.items():
        before = kops.launch_counts()
        before_entries = kops.entry_counts()
        x = eng.shard_vector(x_host)
        y = eng(x)
        torch.cuda.synchronize()
        entries = entry_diff(kops, before_entries)
        check(tuple(y.shape) == (P, N // P), f"y has shape {tuple(y.shape)}")
        y_np = y.reshape(-1).cpu().numpy()
        check(np.isfinite(y_np).all(), f"{strategy}/{mat}: y not finite")
        err = float(np.abs(y_np - y_ref).max())
        check(np.allclose(y_np, y_ref, **Y_TOL),
              f"{strategy}/{mat}: y disagrees with spmv_ref_np ({err})")
        after = kops.launch_counts()
        step = {k: after[k] - before[k] for k in after}
        for k in EXPECTED[(strategy, mat)]:
            check(step[k] > 0, f"{strategy}/{mat} never launched {k}")
        check_table_variants(f"{strategy}/{mat}", step, entries)
        timing = time_steps(torch, lambda: eng(x))
        prof = profile_steps(torch, lambda: eng(x))
        measured[(strategy, mat)] = (timing, prof)
        emit({"phase": "main_path", "strategy": strategy, "materialize": mat,
              "use_kernel": True, "max_abs_err": err, **timing, **prof,
              "launches_per_step": step, "entries_per_step": entries,
              "card": card})
    counts = kops.launch_counts()
    for k in FORWARD_KERNELS:
        check(counts[k] > 0, f"the main path never launched {k}")
    return counts, measured


T_EXPECTED = {  # kernels each transposed rung launches with use_kernel
    "replicate": ("accumulate_segments",),
    "blockwise": ("accumulate_segments",),
    "condensed": PUSH_KERNELS,
    "overlap": PUSH_KERNELS,
}


def phase_transposed(torch, t_engines, x_host, y_t_ref, card):
    """Every rung of the transposed product, counters zeroed before and
    read after; returns the launch counts and each engine's (timing,
    profile)."""
    from repro_torch.kernels import ops as kops

    measured = {}
    kops.reset_launch_counts()
    for strategy, eng in t_engines.items():
        before = kops.launch_counts()
        x = eng.shard_vector(x_host)
        y = eng(x)
        torch.cuda.synchronize()
        check(tuple(y.shape) == (P, N // P), f"y has shape {tuple(y.shape)}")
        y_np = y.reshape(-1).cpu().numpy()
        check(np.isfinite(y_np).all(), f"{strategy}/transposed: y not finite")
        err = float(np.abs(y_np - y_t_ref).max())
        check(np.allclose(y_np, y_t_ref, **Y_TOL),
              f"{strategy}/transposed: y disagrees with spmv_t_ref_np "
              f"({err})")
        after = kops.launch_counts()
        step = {k: after[k] - before[k] for k in after}
        for k in T_EXPECTED[strategy]:
            check(step[k] > 0, f"{strategy}/transposed never launched {k}")
        timing = time_steps(torch, lambda: eng(x))
        prof = profile_steps(torch, lambda: eng(x))
        measured[strategy] = (timing, prof)
        emit({"phase": "transposed", "strategy": strategy,
              "use_kernel": True, "max_abs_err": err, **timing, **prof,
              "launches_per_step": step, "card": card})
    counts = kops.launch_counts()
    for k in PUSH_KERNELS:
        check(counts[k] > 0, f"the transposed path never launched {k}")
    return counts, measured


def heat_field() -> np.ndarray:
    """The field every heat phase starts from: Heat2D.init_field's draw."""
    return np.random.default_rng(SEED).standard_normal(
        (HEAT_N, HEAT_N)).astype(np.float32)


def padded_tiles(torch, field, dev):
    """Heat2D's padded assembly ``(P, m_loc + 2, n_loc + 2)``: every rank's
    tile with its four halo strips, zero outside the domain and in the
    corners (rank r = ip * NPROCS + kp holds tile (ip, kp))."""
    m_loc, n_loc = HEAT_N // MPROCS, HEAT_N // NPROCS
    g = torch.zeros((HEAT_N + 2, HEAT_N + 2), device=dev)
    g[1:-1, 1:-1] = torch.as_tensor(field).to(dev)
    tiles = torch.stack([
        g[ip * m_loc:(ip + 1) * m_loc + 2, kp * n_loc:(kp + 1) * n_loc + 2]
        for ip in range(MPROCS) for kp in range(NPROCS)])
    tiles[:, 0, 0] = tiles[:, 0, -1] = tiles[:, -1, 0] = tiles[:, -1, -1] = 0
    return tiles


def phase_stencil_kernel(torch, dev):
    """stencil2d on Heat2D's whole padded tile, bit for bit against its
    plain version on the card; F.conv2d with the five-point weights on the
    interior (TF32 off) is the library's yardstick, timed only."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    padded = padded_tiles(torch, heat_field(), dev)
    got = kops.stencil2d(padded, coef=HEAT_COEF)
    want = kref.stencil2d_ref(padded, HEAT_COEF)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "stencil2d differs from its plain version")
    c = HEAT_COEF
    weight = torch.tensor([[0.0, c, 0.0], [c, 1.0 - 4.0 * c, c],
                           [0.0, c, 0.0]], device=dev).reshape(1, 1, 3, 3)
    inp = padded[:, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = F.conv2d(inp, weight)[:, 0]
        check(torch.allclose(conv, want[:, 1:-1, 1:-1], rtol=1e-5,
                             atol=1e-5), "conv2d disagrees with stencil2d")
        library_ms = cuda_ms(torch, lambda: F.conv2d(inp, weight))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    b, m, n = padded.shape
    res = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(torch, lambda: kops.stencil2d(padded, coef=HEAT_COEF)),
        plain_ms=cuda_ms(torch, lambda: kref.stencil2d_ref(padded,
                                                           HEAT_COEF)),
        library_ms=library_ms,
        # one read and one write of the batch; 7 flops per interior cell
        bound=bound(2 * b * m * n * 4, flops=7.0 * b * (m - 2) * (n - 2)),
        shape=f"({b}, {m}, {n}) f32, coef {HEAT_COEF}")
    emit({"phase": "kernel", "name": "stencil2d", **{
        k: v for k, v in res.items() if k != "bound"},
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1]})
    check_bound("stencil2d", res)
    return {"stencil2d": res}


H_EXPECTED = {  # kernels each Heat2D rung x materialize launches
    ("replicate", "dest"): ("stencil2d", "unpack_dest"),
    ("replicate", "full"): ("stencil2d",),
}
for _s in ("blockwise", "condensed", "overlap"):
    H_EXPECTED[(_s, "dest")] = ("stencil2d", "pack_gather", "unpack_dest")
    H_EXPECTED[(_s, "full")] = ("stencil2d", "pack_gather",
                                "unpack_scatter_set")


def phase_heat2d(torch, comm, hw, card):
    """Every rung x {dest, full} of Heat2D on one shared stencil pattern
    and base plan (the plan cache's), counters zeroed before and read
    after; then the auto engine (dest).  Returns the launch counts and the
    model rows."""
    from repro_torch.comm import plan_cache
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.plan import Topology
    from repro_torch.core.heat2d import Heat2D, heat2d_predicted_times
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    t0 = time.perf_counter()
    pattern = AccessPattern.from_stencil5(HEAT_N, HEAT_N, MPROCS, NPROCS)
    t1 = time.perf_counter()
    base = plan_cache.get_comm_plan(pattern.indices, pattern.n, P,
                                    topology=Topology(P, SHARDS_PER_NODE))
    t2 = time.perf_counter()
    # the fixed rungs share the phase's plan explicitly, past the cache
    # (hashing the 16M-cell pattern for each would cost more than the
    # small halo Destination's attach)
    engines = {(s, m): Heat2D(
        comm, HEAT_N, HEAT_N, mprocs=MPROCS, nprocs=NPROCS, coef=HEAT_COEF,
        strategy=s, materialize=m, use_kernel=True,
        shards_per_node=SHARDS_PER_NODE, pattern=pattern, base_plan=base,
        use_plan_cache=False)
        for s in STRATEGIES for m in ("dest", "full")}
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    field = heat_field()
    whole = torch.as_tensor(field).to(comm.device)
    for _ in range(HEAT_CHECK_STEPS):
        whole = kref.stencil2d_ref(whole, HEAT_COEF)
    want = whole.cpu().numpy().view(np.int32)
    emit({"phase": "heat2d_setup", "field": [HEAT_N, HEAT_N],
          "grid": [MPROCS, NPROCS], "pattern_s": round(t1 - t0, 3),
          "plan_s": round(t2 - t1, 3), "engines_s": round(t3 - t2, 3),
          "s_max": base.s_max, "b_max": base.b_max,
          "blocksize": base.blocksize,
          "condensed_volume": base.counts.total_condensed_volume(),
          "blockwise_volume": base.counts.total_blockwise_volume()})

    rows = []
    kops.reset_launch_counts()
    for (strategy, mat), h in engines.items():
        phi = h.shard_field(field)
        before = kops.launch_counts()
        before_entries = kops.entry_counts()
        out = h.run(phi, HEAT_CHECK_STEPS)
        torch.cuda.synchronize()
        after = kops.launch_counts()
        entries = entry_diff(kops, before_entries)
        got = h.gather_field(out)
        check(got.shape == (HEAT_N, HEAT_N), f"field has shape {got.shape}")
        check(np.isfinite(got).all(), f"{strategy}/{mat}: field not finite")
        check(np.array_equal(got.view(np.int32), want),
              f"{strategy}/{mat}: Heat2D.run differs from the plain "
              "whole-field steps")
        step = {k: after[k] - before[k] for k in after}
        for k in H_EXPECTED[(strategy, mat)]:
            check(step[k] > 0, f"heat2d {strategy}/{mat} never launched {k}")
        check_table_variants(f"heat2d {strategy}/{mat}", step, entries)
        timing = time_steps(torch, lambda: h.run(phi, HEAT_TIMED_STEPS),
                            warmup=1, iters=1)
        timing = {k: v / HEAT_TIMED_STEPS for k, v in timing.items()}
        prof = profile_steps(torch, lambda: h.run(phi, 4), steps=1, lead=1,
                             per_call=4)
        rows.append(dict(
            path="heat2d", strategy=strategy, materialize=mat,
            ms=timing["ms_per_iter"], busy_share=prof["busy_share"],
            predicted_s=heat2d_predicted_times(
                base, HEAT_N, HEAT_N, MPROCS, NPROCS, hw,
                destination=h.gather.destination,
                materialize=mat)[strategy],
            cell={"rung": strategy, "dtype": "float32",
                  "mesh": [MPROCS, NPROCS]}))
        emit({"phase": "heat2d", "strategy": strategy, "materialize": mat,
              "split": h.overlap, "use_kernel": True,
              "bit_equal_steps": HEAT_CHECK_STEPS, **timing, **prof,
              "launches_per_check_run": step,
              "entries_per_check_run": entries, "card": card})
    counts = kops.launch_counts()
    for k in ("stencil2d", "pack_gather", "unpack_scatter_set",
              "unpack_dest"):
        check(counts[k] > 0, f"the heat2d path never launched {k}")

    # the auto engine: its base plan a memory hit of the plan cache
    t0 = time.perf_counter()
    auto = Heat2D(comm, HEAT_N, HEAT_N, mprocs=MPROCS, nprocs=NPROCS,
                  coef=HEAT_COEF, strategy="auto", hw=hw, materialize="dest",
                  use_kernel=True, shards_per_node=SHARDS_PER_NODE,
                  pattern=pattern)
    build_s = time.perf_counter() - t0
    phi = auto.shard_field(field)
    got = auto.run(phi, HEAT_CHECK_STEPS)
    want_t = engines[(auto.strategy, "dest")].run(phi, HEAT_CHECK_STEPS)
    torch.cuda.synchronize()
    check_auto("heat2d/dest", auto.predicted_times, auto.strategy,
               {r["strategy"]: r["ms"] for r in rows
                if r["materialize"] == "dest"},
               torch.equal(got, want_t), True, build_s, card)
    return counts, rows


NE_EXPECTED = {  # kernels each normal-equations rung launches
    "replicate": ("unpack_dest", "accumulate_segments"),
    "blockwise": ("pack_gather", "unpack_dest", "accumulate_segments"),
    "condensed": ("pack_gather", "unpack_dest") + PUSH_KERNELS,
    "overlap": ("pack_gather", "unpack_dest") + PUSH_KERNELS,
}


def phase_normal_equations(torch, comm, matrix, base, splan, x_host, hw,
                           card):
    """normal_equations_step on every rung and CG on the condensed rung,
    on the SpMV phases' plans, counters zeroed before and read after.
    Returns the model rows (the steps' predicted_window, CG's
    predicted_loop)."""
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.plan import Topology
    from repro_torch.comm.schedule import plan_key
    from repro_torch.core.matrix import spmv_ref_np, spmv_t_ref_np
    from repro_torch.core.solvers import ConjugateGradient
    from repro_torch.core.spmv import normal_equations_step
    from repro_torch.kernels import ops as kops

    key = plan_key(AccessPattern.from_ellpack(matrix), P, BLOCKSIZE,
                   Topology(P, SHARDS_PER_NODE))
    plans = {key: base, ("put", key): splan}
    z_ref = spmv_t_ref_np(matrix, spmv_ref_np(matrix, x_host))
    z_tol = dict(rtol=2e-4, atol=2e-4 * float(np.abs(z_ref).max()))
    # the setup's plans (their Destination delta a memory hit of the
    # cache); hw= prices the fixed rungs' window and loop
    kw = dict(blocksize=BLOCKSIZE, shards_per_node=SHARDS_PER_NODE,
              plans=plans, hw=hw)
    t0 = time.perf_counter()
    steps = {s: normal_equations_step(matrix, comm, strategy=s,
                                      use_kernel=True, **kw)
             for s in STRATEGIES}
    torch.cuda.synchronize()
    emit({"phase": "normal_equations_setup",
          "steps_s": round(time.perf_counter() - t0, 3),
          "plans": len(plans)})
    check(len(plans) == 2, "the steps built plans of their own")

    rows = []
    cell = {"workload": "spmv_kernel", "dtype": "float32", "mesh": [P]}
    kops.reset_launch_counts()
    for strategy, step in steps.items():
        x = step.shard_vector(x_host)
        before = kops.launch_counts()
        before_entries = kops.entry_counts()
        z = step(x)
        torch.cuda.synchronize()
        after = kops.launch_counts()
        entries = entry_diff(kops, before_entries)
        check(tuple(z.shape) == (P, N // P), f"z has shape {tuple(z.shape)}")
        z_np = z.reshape(-1).cpu().numpy()
        check(np.isfinite(z_np).all(), f"{strategy}/normal: z not finite")
        err = float(np.abs(z_np - z_ref).max())
        check(np.allclose(z_np, z_ref, **z_tol),
              f"{strategy}/normal: z disagrees with the numpy reference "
              f"({err})")
        launched = {k: after[k] - before[k] for k in after}
        for k in NE_EXPECTED[strategy]:
            check(launched[k] > 0, f"{strategy}/normal never launched {k}")
        check_table_variants(f"{strategy}/normal", launched, entries)
        timing = time_steps(torch, lambda: step(x))
        prof = profile_steps(torch, lambda: step(x))
        rows.append(dict(path="normal_equations", strategy=strategy,
                         materialize="dest", ms=timing["ms_per_iter"],
                         busy_share=prof["busy_share"],
                         predicted_s=step.predicted_window["total"],
                         cell=dict(cell, rung=strategy)))
        emit({"phase": "normal_equations", "strategy": strategy,
              "use_kernel": True, "max_abs_err": err,
              "ref_max_abs": float(np.abs(z_ref).max()), **timing, **prof,
              "launches_per_step": launched, "entries_per_step": entries,
              "card": card})
    del steps

    t0 = time.perf_counter()
    cgs = {uk: ConjugateGradient(matrix, comm, strategy="condensed",
                                 use_kernel=uk, **kw)
           for uk in (True, False)}
    setup_s = time.perf_counter() - t0
    b = np.random.default_rng(SEED + 1).standard_normal(N).astype(
        np.float32)
    finals = {}
    for uk, cg in cgs.items():
        carries = cg.carries(b)
        before = kops.launch_counts()
        before_entries = kops.entry_counts()
        finals[uk] = cg.schedule(*carries, n_steps=CG_ITERS)
        torch.cuda.synchronize()
        if uk:
            after = kops.launch_counts()
            check_table_variants(
                "condensed/cg", {k: after[k] - before[k] for k in after},
                entry_diff(kops, before_entries))
    (xk, rk, _), (xp, _, _) = finals[True], finals[False]
    check(bool(torch.isfinite(xk).all()), "CG iterate not finite")
    rel = float((xk - xp).abs().max() / xp.abs().max())
    check(rel < 1e-4, f"CG with kernels is {rel} from CG without")
    r0 = float(np.linalg.norm(b.astype(np.float64)))
    r_end = float(torch.linalg.vector_norm(rk.double()))
    check(r_end < r0, f"CG residual grew: {r_end} >= {r0}")
    carries = cgs[True].carries(b)
    timing = time_steps(torch, lambda: cgs[True].schedule(
        *carries, n_steps=CG_ITERS), warmup=1, iters=3)
    prof = profile_steps(torch, lambda: cgs[True].schedule(
        *carries, n_steps=CG_ITERS), steps=1, lead=1, per_call=CG_ITERS)
    loop = cgs[True].schedule.predicted_loop(CG_ITERS)
    rows.append(dict(path="cg", strategy="condensed", materialize="dest",
                     ms=timing["ms_per_iter"] / CG_ITERS,
                     busy_share=prof["busy_share"],
                     predicted_s=loop["total"] / CG_ITERS,
                     cell=dict(cell, rung="condensed")))
    emit({"phase": "cg", "strategy": "condensed", "use_kernel": True,
          "iterations": CG_ITERS, "setup_s": round(setup_s, 3),
          "rel_vs_plain": rel, "residual_start": r0, "residual_end": r_end,
          "ms_per_iteration": timing["ms_per_iter"] / CG_ITERS,
          "host_enqueue_ms_per_iteration":
              timing["host_enqueue_ms_per_iter"] / CG_ITERS,
          "busy_share": prof["busy_share"], "card": card})
    counts = kops.launch_counts()
    for k in ("pack_gather", "unpack_dest") + PUSH_KERNELS:
        check(counts[k] > 0, f"the normal-equations path never launched {k}")
    return rows


# sane ranges of the calibration of ONE rank of LoopbackComm(P) on one
# H100: a value outside fails the run.  The P ranks run stacked and share
# the card's HBM, so a rank's copy rate is at most its 1/P share of it; its
# all_to_all send is read and written once each (at most 1/(2P) of the HBM
# rate), capped here at 1/P, the factor 2 left for the part of the 64 MB
# working set that the 50 MB L2 serves.  A probe of one un-stacked tensor
# credits the rank with the whole card and reads ~P times these caps.  tau
# is the host's enqueue and synchronize of one tiny all_to_all.
CALIBRATION_RANGE = {"w_private": (1e10, HBM_BYTES_PER_S / P),
                     "w_remote": (1e10, HBM_BYTES_PER_S / P),
                     "tau": (1e-6, 1e-2), "cacheline": (16, 4096)}


def phase_calibration(torch, comm, card):
    """The §5.4 parameters of one rank of ``comm`` (``tune.
    measure_hardware``), with the stacked probes' raw times."""
    from repro_torch.comm.exchange import measure_hw
    from repro_torch.core import tune

    t0 = time.perf_counter()
    hw = measure_hw(comm)
    seconds = time.perf_counter() - t0
    raw = tune.calibration(comm)
    values = {k: getattr(hw, k) for k in CALIBRATION_RANGE}
    emit({"phase": "model", "kind": "calibration", **values, "raw": raw,
          "seconds": round(seconds, 3), "card": card})
    for k, (lo, hi) in CALIBRATION_RANGE.items():
        check(lo <= values[k] <= hi,
              f"calibration {k} = {values[k]} outside [{lo}, {hi}]")
    return hw


def spmv_prediction(eng, hw) -> float:
    """Seconds the §5 models predict for one step of a fixed-rung
    DistributedSpMV, priced as it runs: kernelized compute terms, the
    put models for the transposed product, and the unpack its
    materialize runs (the slots its Destination names under "dest")."""
    from repro_torch.comm import select
    from repro_torch.core import perfmodel as pm

    if eng.transpose:
        w = select.workload_from_plan(eng.splan, R_NZ, use_kernel=True)
        return float(pm.PUT_STRATEGY_PREDICTORS[eng.strategy](w, hw))
    w = select.workload_from_plan(eng.plan, R_NZ,
                                  materialize=eng.materialize,
                                  use_kernel=True)
    return float(pm.STRATEGY_PREDICTORS[eng.strategy](w, hw))


def path_rows(path, engines, measured, hw):
    """Model rows of the SpMV engines of one path phase."""
    rows = []
    for key, eng in engines.items():
        timing, prof = measured[key]
        rows.append(dict(
            path=path, strategy=eng.strategy, materialize=eng.materialize,
            ms=timing["ms_per_iter"], busy_share=prof["busy_share"],
            predicted_s=spmv_prediction(eng, hw),
            cell={"rung": eng.strategy, "workload": "spmv_kernel",
                  "dtype": "float32", "mesh": [P]}))
    return rows


def check_auto(what, predicted, pick, measured_ms, same, bit_equal, build_s,
               card):
    """One auto engine's line: its ranking, its pick, the measured-fastest
    rung and the regret (the pick's measured ms over the best's).  Fails
    when a prediction is not a positive number, when the pick is not the
    argmin of its own ranking, or when its output differs from the
    fixed-rung engine it resolved to."""
    for rung, t in predicted.items():
        check(np.isfinite(t) and t > 0,
              f"{what}: auto predicted {t} s for {rung}")
    check(pick == min(predicted, key=predicted.get),
          f"{what}: auto picked {pick}, not the argmin of {predicted}")
    check(same, f"{what}: the auto engine's output differs from the "
          f"{pick} engine's")
    best = min(measured_ms, key=measured_ms.get)
    emit({"phase": "model", "kind": "auto", "path": what,
          "predicted_ms": {k: v * 1e3 for k, v in predicted.items()},
          "pick": pick, "measured_best": best,
          "measured_ms": measured_ms,
          "regret": measured_ms[pick] / measured_ms[best],
          "bit_equal": bit_equal, "build_s": round(build_s, 3),
          "card": card})


def phase_auto_forward(torch, matrix, comm, engines, x_host, hw, measured,
                       card):
    """The auto forward engines (use_kernel, full and dest), base plan from
    the plan cache's memory tier, against the fixed engine each resolved
    to on the same input."""
    from repro_torch.core.spmv import DistributedSpMV

    for mat in ("full", "dest"):
        t0 = time.perf_counter()
        auto = DistributedSpMV(matrix, comm, strategy="auto", hw=hw,
                               blocksize=BLOCKSIZE,
                               shards_per_node=SHARDS_PER_NODE,
                               use_kernel=True, materialize=mat)
        build_s = time.perf_counter() - t0
        x = auto.shard_vector(x_host)
        got = auto(x)
        want = engines[(auto.strategy, mat)](x)
        torch.cuda.synchronize()
        bit_equal = torch.equal(got, want)
        # the dest rungs' fused product may hold to unpack_dest_spmv's 3e-5
        same = bit_equal or (mat == "dest" and torch.allclose(
            got, want, **SPMV_TOL))
        check_auto(f"forward/{mat}", auto.predicted_times, auto.strategy,
                   {s: measured[(s, mat)][0]["ms_per_iter"]
                    for s in STRATEGIES}, same, bit_equal, build_s, card)
        del auto


def phase_model(rows, plan_first_s, card):
    """Every measured configuration beside its §5 prediction, then the plan
    cache's counters and the seconds its memory tier saves a second
    construction.  A model miss, even past its budget, is printed, never a
    failure; a prediction that is not a positive number fails."""
    from repro_torch.comm import plan_cache
    from repro_torch.core import perfmodel as pm

    for r in rows:
        t = r["predicted_s"]
        where = f"{r['path']} {r['strategy']}/{r['materialize']}"
        check(np.isfinite(t) and t > 0, f"{where}: predicted {t} s")
        emit({"phase": "model", "kind": "model_row", "path": r["path"],
              "strategy": r["strategy"], "materialize": r["materialize"],
              "measured_ms": r["ms"], "predicted_ms": t * 1e3,
              "model_error": pm.model_error(r["ms"] * 1e-3, t),
              "error_budget": pm.error_budget(r["cell"]),
              "busy_share": r["busy_share"], "card": card})
    emit({"phase": "model", "kind": "plan_cache",
          "stats": plan_cache.stats.snapshot(), **plan_first_s,
          "card": card})


def rel_l2(torch, got, want) -> float:
    """``|got - want| / |want|`` in float32, over all elements."""
    g, w = got.float(), want.float()
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w))


def ptxas_usage(log: str, keys) -> dict:
    """ptxas's registers and spill bytes of every kernel in an nvcc ``-Xptxas
    -v`` log whose (mangled) name holds one of ``keys``."""
    usage, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if not any(k in name for k in keys):
                name = None
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            usage[name] = {"spill_stores": nums[1], "spill_loads": nums[2]}
        elif name and "Used" in line and "registers" in line:
            usage.setdefault(name, {})["registers"] = int(
                line.split("Used")[1].split()[0])
            name = None
    return usage


def decode_inputs(torch, dev, s: int, lo: int, heads=(32, 8)):
    """One decode step's decode_attention inputs at ``heads`` (llama3-8b's
    by default: 8 lanes, 32 query and 8 KV heads of 128) on a bf16 ring of
    ``s`` slots, lengths drawn from [lo, s]; with SDPA (boolean mask, GQA)
    on the same inputs, and the bound: the valid K/V prefix read once, q
    and lengths read, out written; a dot and an accumulate of D per (query
    head, live slot)."""
    import torch.nn.functional as F
    (h, hkv), b, d = heads, 8, 128
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).bfloat16()
    lengths = torch.as_tensor(np.random.default_rng(SEED).integers(
        lo, s + 1, b), dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                              attn_mask=mask, enable_gqa=True)
    live = int(lengths.sum())
    return q, k, v, lengths, sdpa, bound(
        2 * live * hkv * d * 2 + 2 * b * h * d * 2 + b * 4,
        flops=4.0 * live * h * d)


def scan_inputs(torch, dev, l: int):
    """selective_scan's inputs at one falcon-mamba-7b layer (B = 1, di
    8192, st 16) of ``l`` steps, from the seed."""
    b, di, st = 1, 8192, 16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((b, l, di), generator=gen, device=dev) * 0.3
    dt = torch.nn.functional.softplus(torch.randn(
        (b, l, di), generator=gen, device=dev))
    bm = torch.randn((b, l, st), generator=gen, device=dev) * 0.5
    cm = torch.randn((b, l, st), generator=gen, device=dev) * 0.5
    a = -torch.exp(torch.randn((di, st), generator=gen, device=dev) * 0.3)
    return x, dt, bm, cm, a


def kernel_split(torch, fn, iters: int = 10) -> list:
    """[name, mean device ms a launch, launches seen a call] of each kernel
    that ``fn`` launches, from torch.profiler over ``iters`` calls (after
    one warm-up call); the mean is over the launches the profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, seen = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.end - e.time_range.start,
                               seen + 1)
    return [[name[:60], us / seen / 1e3, seen / iters]
            for name, (us, seen) in sorted(by_name.items(),
                                           key=lambda r: -r[1][0])]


def kernel_detail(torch, fn, keys) -> dict:
    """The device time of each kernel one call of ``fn`` launches, and
    ptxas's registers and spills of the kernels named by ``keys``."""
    from repro_torch.kernels import _build
    return {"kernels_ms": kernel_split(torch, fn),
            "ptxas": ptxas_usage(_build.build_info().get("log", ""), keys)}


def phase_decode_attention_kernel(torch, dev):
    """decode_attention at one decode step of the serve phase: 8 lanes,
    llama3-8b's 32 query and 8 KV heads of 128, a bf16 ring of 2080 slots,
    lengths drawn from [1025, 2080].  Against its plain version with float32
    outputs at 2e-4 (a float32 query on the bf16 cache, and all float32),
    and with the path's bf16 output within one bf16 rounding; SDPA with a
    boolean mask is the library's yardstick, timed only.  Then the same at
    decode_32k's cache length (32768 slots, lengths from [16385, 32768],
    batch cut to 8), on a line of its own."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    q, k, v, lengths, sdpa, bnd = decode_inputs(torch, dev, 2080, 1025)
    errs = []
    for qq, kk, vv in ((q.float(), k, v), (q.float(), k.float(), v.float())):
        got = kops.decode_attention(qq, kk, vv, lengths)
        want = kref.decode_attention_ref(qq, kk, vv, lengths)
        check(torch.allclose(got, want, **MODEL_TOL),
              f"decode_attention ({kk.dtype} cache) differs from its plain "
              f"version: {float((got - want).abs().max())}")
        errs.append(float((got - want).abs().max()))
    got = kops.decode_attention(q, k, v, lengths)
    want = kref.decode_attention_ref(q.float(), k, v, lengths)
    check(got.dtype == torch.bfloat16 and torch.allclose(
        got.float(), want, **BF16_OUT_TOL),
        "decode_attention's bf16 output is more than one rounding off")
    # SDPA rounds its probabilities to bf16 before the product with V
    check(torch.allclose(sdpa()[:, :, 0].float(), want, rtol=1e-2,
                         atol=2e-3),
          "SDPA disagrees with decode_attention's plain version")

    def fn():
        return kops.decode_attention(q, k, v, lengths)
    res = dict(
        max_abs_err=max(errs), ms=cuda_ms(torch, fn),
        plain_ms=cuda_ms(torch, lambda: kref.decode_attention_ref(
            q, k, v, lengths)),
        library_ms=cuda_ms(torch, sdpa), bound=bnd,
        shape=f"q {tuple(q.shape)} bf16, k/v {tuple(k.shape)} bf16, "
              f"{int(lengths.sum())} live slots",
        **kernel_detail(torch, fn, ("decode",)))
    emit({"phase": "kernel", "name": "decode_attention", **{
        k_: v_ for k_, v_ in res.items() if k_ != "bound"},
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1]})
    check_bound("decode_attention", res)
    del q, k, v

    q, k, v, lengths, sdpa, bnd = decode_inputs(torch, dev, 32768, 16385)
    got = kops.decode_attention(q, k, v, lengths)
    want = kref.decode_attention_ref(q.float(), k, v, lengths)
    check(torch.allclose(got.float(), want, **BF16_OUT_TOL),
          "decode_attention at a 32k cache is more than one bf16 rounding "
          f"off: {float((got.float() - want).abs().max())}")
    long = dict(max_abs_err=float((got.float() - want).abs().max()),
                ms=cuda_ms(torch, lambda: kops.decode_attention(
                    q, k, v, lengths)),
                library_ms=cuda_ms(torch, sdpa), bound=bnd)
    emit({"phase": "kernel", "name": "decode_attention_32k",
          "max_abs_err": long["max_abs_err"], "ms": long["ms"],
          "library_ms": long["library_ms"], "bound_ms": bnd[0],
          "bound_by": bnd[1], "shape": f"k/v {tuple(k.shape)} bf16, "
          f"{int(lengths.sum())} live slots"})
    check_bound("decode_attention at a 32k cache", long)
    del q, k, v, want
    torch.cuda.empty_cache()
    return {"decode_attention": res}


def phase_selective_scan_kernel(torch, dev):
    """selective_scan at the shape the ssm prefill gives it (one
    falcon-mamba-7b layer: B = 1, L = SSM_L, di 8192, st 16) against its
    plain version at 2e-4; the plain loop is timed once (its Python steps
    take seconds).  No single PyTorch call computes the scan."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    args = scan_inputs(torch, dev, SSM_L)
    b, l, di = args[0].shape
    st = args[2].shape[2]
    got = kops.selective_scan(*args)
    want = kref.selective_scan_ref(*args)
    check(torch.allclose(got, want, **MODEL_TOL),
          "selective_scan differs from its plain version: "
          f"{float((got - want).abs().max())}")

    def fn():
        return kops.selective_scan(*args)
    res = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(torch, fn),
        plain_ms=cuda_ms(torch, lambda: kref.selective_scan_ref(*args),
                         warmup=0, iters=1),
        library_ms=None,
        # x, dt read and y written (f32), B and C read, a read once; per
        # (step, channel, state) a product, an exponential counted as one,
        # two fused multiply-adds and the dt * x product shared by a channel
        bound=bound(3 * b * l * di * 4 + 2 * b * l * st * 4 + di * st * 4,
                    flops=7.0 * b * l * di * st),
        shape=f"x/dt ({b}, {l}, {di}) f32, B/C ({b}, {l}, {st}), a ({di}, "
              f"{st})",
        **kernel_detail(torch, fn, ("selective",)))
    emit({"phase": "kernel", "name": "selective_scan", **{
        k_: v_ for k_, v_ in res.items() if k_ != "bound"},
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1]})
    check_bound("selective_scan", res)
    return {"selective_scan": res}


@contextlib.contextmanager
def plain_kernel(kops, name, plain):
    """Swap ``kops.<name>`` for its plain version until the block ends: the
    model calls the kernels through the ``ops`` module."""
    saved = getattr(kops, name)
    setattr(kops, name, plain)
    try:
        yield
    finally:
        setattr(kops, name, saved)


def float32_twin(torch, model, params):
    """The same model and weights with float32 activations and weights."""
    from repro_torch.models.transformer import Model, RunCtx, tree_map
    twin = Model(model.cfg, RunCtx(act_dtype=torch.float32),
                 device=model.device)
    return twin, tree_map(lambda t: t.float(), params)


def phase_serve(torch, card):
    """llama3-8b at its published widths and depth, bf16, random weights
    from the seed, through launch.serve's engine: 16 requests over 8
    slots, counters zeroed before the run and read after.  Then one decode
    step with B8 against the same step with the plain attention, and the
    device's busy share over three decode steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import serve as lserve
    from repro_torch.models.transformer import RunCtx, tree_map

    args = lserve.parse_args(SERVE_ARGV)
    cfg = get_config(args.arch, reduced=args.reduced)
    t0 = time.perf_counter()
    engine = lserve.make_engine(cfg, RunCtx(act_dtype=torch.bfloat16), args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(
        engine.params)) / 1e9
    prompt_tokens = sum(len(r.prompt) for r in engine.queue.ready(
        float("inf")))

    kops.reset_launch_counts()
    t0 = time.perf_counter()
    report = engine.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    decode_ticks = len(report.tick_seconds)
    check(len(report.completed) == args.requests,
          f"{len(report.completed)} of {args.requests} requests completed")
    check(all(len(t) == args.gen for t in report.outputs.values()),
          "a request did not get its tokens")
    check(all(0 <= t < cfg.vocab_size for ts in report.outputs.values()
              for t in ts), "a token outside the vocabulary")
    check(counts["decode_attention"] == cfg.num_layers * decode_ticks,
          f"decode_attention launched {counts['decode_attention']} times "
          f"in {decode_ticks} decode ticks of {cfg.num_layers} layers")

    model, params = engine.model, engine.params

    def step():
        return model.decode_step(params, engine.cache, engine._tokens)[0]
    errs = {}
    m32, p32 = float32_twin(torch, model, params)
    c32 = {"pos": engine.cache["pos"], "layers": tree_map(
        lambda t: t.float() if t.is_floating_point() else t.clone(),
        engine.cache["layers"])}
    for name, fn in (("bf16", step), ("f32", lambda: m32.decode_step(
            p32, c32, engine._tokens)[0])):
        got = fn()
        with plain_kernel(kops, "decode_attention",
                          kref.decode_attention_ref):
            want = fn()
        check(bool(torch.isfinite(got).all()), "decode logits not finite")
        errs[name] = rel_l2(torch, got, want)
    del m32, p32, c32
    check(errs["f32"] < LOGITS_REL_F32 and errs["bf16"] < LOGITS_REL_BF16,
          f"decode logits with B8 are {errs} (relative) from the plain "
          "attention's")
    timing = time_steps(torch, step, warmup=2, iters=10)
    prof = profile_steps(torch, step)
    ttft = list(report.ttft_seconds.values())
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "dtype": "bfloat16", "requests": args.requests,
          "slots": args.slots, "cache_len": args.prompt_len + args.gen,
          "prompt_tokens": prompt_tokens,
          "init_s": round(init_s, 3), "weights_gb": round(weights_gb, 3),
          "wall_s": wall_s, "ticks": report.ticks,
          "decode_ticks": decode_ticks,
          "decode_tokens_per_s": report.tokens_per_s,
          "p50_token_ms": report.p50_us() / 1e3,
          "p99_token_ms": report.p99_us() / 1e3,
          "mean_ttft_ms": 1e3 * sum(ttft) / len(ttft),
          "max_ttft_ms": 1e3 * max(ttft),
          "total_tokens": report.total_tokens,
          "decode_attention_launches": counts["decode_attention"],
          "logits_rel_l2_vs_plain": errs,
          "decode_step": {**timing, **prof}, "card": card})
    return counts


def b8_line(torch, name, q, k, v, lengths):
    """decode_attention on one call's own inputs from a serving phase:
    against its plain version with float32 outputs at 2e-4 (a float32
    query on the cache, and all float32) and the path's bf16 output
    within one bf16 rounding; timed beside the plain version and SDPA
    (boolean mask, GQA) on the same inputs.  The bound: the attended K/V
    read once, q and lengths read, out written; a dot and an accumulate
    of D per (query head, attended slot).  Emits the kernel line."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    errs = []
    for qq, kk, vv in ((q.float(), k, v), (q.float(), k.float(), v.float())):
        got = kops.decode_attention(qq, kk, vv, lengths)
        want = kref.decode_attention_ref(qq, kk, vv, lengths)
        errs.append(float((got - want).abs().max()))
        check(torch.allclose(got, want, **MODEL_TOL),
              f"{name} ({kk.dtype} cache) differs from its plain version: "
              f"{errs[-1]}")
    got = kops.decode_attention(q, k, v, lengths)
    want = kref.decode_attention_ref(q.float(), k, v, lengths)
    check(got.dtype == q.dtype and torch.allclose(
        got.float(), want, **BF16_OUT_TOL),
        f"{name}'s bf16 output is more than one rounding off")
    attended = torch.clamp(lengths, max=s)
    mask = (torch.arange(s, device=q.device)[None, :]
            < attended[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                              attn_mask=mask, enable_gqa=True)
    live = int(attended.sum())
    res = dict(max_abs_err=max(errs),
               ms=cuda_ms(torch, lambda: kops.decode_attention(
                   q, k, v, lengths)),
               plain_ms=cuda_ms(torch, lambda: kref.decode_attention_ref(
                   q, k, v, lengths)),
               library_ms=cuda_ms(torch, sdpa),
               bound=bound(2 * live * hkv * d * k.element_size()
                           + 2 * b * h * d * q.element_size() + b * 4,
                           flops=4.0 * live * h * d))
    emit({"phase": "kernel", "name": name, "max_abs_err": res["max_abs_err"],
          "ms": res["ms"], "plain_ms": res["plain_ms"],
          "library_ms": res["library_ms"], "bound_ms": res["bound"][0],
          "bound_by": res["bound"][1], "group": h // hkv,
          "shape": f"q {tuple(q.shape)} {str(q.dtype)[6:]}, k/v "
                   f"{tuple(k.shape)} {str(k.dtype)[6:]}, {live} attended "
                   "slots"})
    check_bound(name, res)
    return res


def family_twin(torch, model, params, cache, layers):
    """A float32 twin of the batched demo's model, weights and cache (its
    first ``layers`` layers: a vision stack keeps its first
    ``layers // period`` groups)."""
    from repro_torch.models.transformer import Model, RunCtx, tree_map
    cfg = model.cfg
    cut = (lambda t: t[:layers // cfg.cross_attn_period]) if model.groups \
        else (lambda t: t[:layers])
    params = dict(params)
    params.update({k: tree_map(cut, params[k]) for k in ("groups", "layers")
                   if k in params})
    layers_c = tree_map(cut, cache["layers"])
    twin = Model(dataclasses.replace(cfg, num_layers=layers),
                 RunCtx(act_dtype=torch.float32), device=model.device)
    return twin, tree_map(lambda t: t.float(), params), {
        "pos": cache["pos"], "layers": tree_map(
            lambda t: t.float() if t.is_floating_point() else t.clone(),
            layers_c)}


def phase_family_serve(torch, card, phase, argv, *, layers=None,
                       twin_layers=None, held=()):
    """One of the hybrid, encoder-decoder and vision families at its
    published widths, bf16, random weights from the seed, through
    launch.serve's batched demo (``setup_batch_demo``: the cross context
    from the seed and ``prefill_cross``; ``run_batch_demo``: the prompt
    through the sequential decode scan, then ``--gen`` steps), the
    counters zeroed before and read after: every lane gets its tokens
    inside the vocabulary, B8 launched once per attention a layer and
    step.  Then one decode step with B8 against the same step through the
    plain attention (bf16, and a float32 twin of ``twin_layers`` layers);
    the B8 calls numbered ``held`` of one step held against their plain
    version on their own inputs, each on a kernel line of its own; the
    decode step timed and its busy share.  ``layers`` cuts the depth."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import serve as lserve
    from repro_torch.models.transformer import RunCtx, tree_map

    args = lserve.parse_args(argv)
    full = get_config(args.arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    per_step = cfg.num_layers * (2 if cfg.is_encdec else 1)
    steps = args.prompt_len + args.gen
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    model, params, cache, prompt = lserve.setup_batch_demo(
        cfg, RunCtx(act_dtype=torch.bfloat16), args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    seq, cache, prefill_s, decode_s = lserve.run_batch_demo(
        model, params, cache, prompt, args.gen)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    n_params = sum(t.numel() for t in _leaves(params))
    weights_gb = sum(t.numel() * t.element_size()
                     for t in _leaves(params)) / 1e9
    check(tuple(seq.shape) == (args.batch, args.gen),
          f"{phase}: generated {tuple(seq.shape)}")
    check(bool(((seq >= 0) & (seq < cfg.vocab_size)).all()),
          f"{phase}: a token outside the vocabulary")
    check(counts["decode_attention"] == per_step * steps,
          f"{phase}: decode_attention launched {counts['decode_attention']} "
          f"times in {steps} steps of {per_step} attentions")

    tokens = seq[:, -1:].to(model.device, torch.int32)

    def fresh(c):
        """A copy of the cache: the recurrent states advance in place."""
        return {"pos": c["pos"], "layers": tree_map(torch.clone,
                                                    c["layers"])}
    errs = {}
    m32, p32, c32 = family_twin(torch, model, params, cache,
                                twin_layers or cfg.num_layers)
    for name, fn in (("bf16", lambda: model.decode_step(
            params, fresh(cache), tokens)[0]),
            ("f32", lambda: m32.decode_step(p32, fresh(c32), tokens)[0])):
        got = fn()
        with plain_kernel(kops, "decode_attention",
                          kref.decode_attention_ref):
            want = fn()
        check(bool(torch.isfinite(got).all()),
              f"{phase}: decode logits not finite")
        errs[name] = rel_l2(torch, got, want)
    del m32, p32, c32
    check(errs["f32"] < LOGITS_REL_F32 and errs["bf16"] < LOGITS_REL_BF16,
          f"{phase}: decode logits with B8 are {errs} (relative) from the "
          "plain attention's")
    with held_calls(kops, "decode_attention", [i for i, _ in held]) as got:
        model.decode_step(params, fresh(cache), tokens)
    kernels = {}
    for i, name in held:
        kernels[name] = b8_line(torch, name, *got.pop(i)[0])

    def step():
        return model.decode_step(params, cache, tokens)[0]
    timing = time_steps(torch, step, warmup=2, iters=10)
    prof = profile_steps(torch, step)
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
          "of_layers": full.num_layers, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads], "dtype": "bfloat16",
          "params": n_params, "weights_gb": weights_gb,
          "batch": args.batch, "prompt_len": args.prompt_len,
          "gen": args.gen, "ring": int(cache["layers"]["self"]["k"].shape[3]
                                       if model.groups else
                                       cache["layers"]["k"].shape[2]),
          "cross_len": cfg.encoder_seq or cfg.num_image_tokens,
          "setup_s": setup_s, "prefill_s": prefill_s,
          "decode_s": decode_s,
          "decode_tokens_per_s": args.batch * args.gen / decode_s,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "decode_attention_launches": counts["decode_attention"],
          "logits_rel_l2_vs_plain": errs,
          "decode_step": {**timing, **prof}, "card": card})
    return model, params, counts, kernels


def phase_hybrid_serve(torch, card):
    """hymba-1.5b (32 layers, d 1600, 25/5 heads of 64, d_inner 3200,
    window 1024) through phase_family_serve: batch 4, prompt 1040, 32
    tokens, the ring cut to the window, so it wraps and decode runs past
    the window; B8 held at group 5 on the wrapped ring.  Then
    build_prefill (the forward, last position only) at B = 1, L = 4096,
    where the banded attention schedule applies: 32 selective_scan
    launches, layer 0's call against the plain recurrence on its own
    inputs at 2e-4 (a kernel line of its own, at d_inner 3200), the
    prefill timed."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.runtime.steps import build_prefill

    model, params, counts, kernels = phase_family_serve(
        torch, card, "hybrid_serve", HYBRID_ARGV,
        held=((0, "decode_attention_g5_ring1024"),))
    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (1, HYBRID_PREFILL_L),
                           generator=gen, device=model.device)
    prefill = build_prefill(model)
    kops.reset_launch_counts()
    with held_calls(kops, "selective_scan", (0,)) as held:
        logits = prefill(params, tokens)
        torch.cuda.synchronize()
    scans = kops.launch_counts()["selective_scan"]
    check(scans == cfg.num_layers,
          f"hybrid_serve: selective_scan launched {scans} times in one "
          f"prefill of {cfg.num_layers} layers")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "hybrid_serve: prefill logits not finite or misshapen")
    args, got = held.pop(0)
    check(tuple(got.shape) == (1, HYBRID_PREFILL_L, cfg.d_inner),
          f"hybrid_serve: the scan has shape {tuple(got.shape)}")
    want = kref.selective_scan_ref(*args)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **MODEL_TOL),
          f"hybrid_serve: layer 0's selective_scan differs from the plain "
          f"recurrence on its inputs: {err}")
    b, l, di = got.shape
    st = args[2].shape[2]
    res = dict(max_abs_err=err,
               ms=cuda_ms(torch, lambda: kops.selective_scan(*args)),
               plain_ms=cuda_ms(torch, lambda: kref.selective_scan_ref(
                   *args), warmup=0, iters=1),
               library_ms=None,
               bound=bound(3 * b * l * di * 4 + 2 * b * l * st * 4
                           + di * st * 4, flops=7.0 * b * l * di * st))
    emit({"phase": "kernel", "name": "selective_scan_di3200",
          "max_abs_err": err, "ms": res["ms"], "plain_ms": res["plain_ms"],
          "library_ms": None, "bound_ms": res["bound"][0],
          "bound_by": res["bound"][1],
          "shape": f"x/dt ({b}, {l}, {di}) f32, B/C ({b}, {l}, {st})"})
    check_bound("selective_scan at d_inner 3200", res)
    del args, got, want
    timing = time_steps(torch, lambda: prefill(params, tokens), warmup=1,
                        iters=2)
    emit({"phase": "hybrid_prefill", "arch": cfg.name, "batch": 1,
          "seq": HYBRID_PREFILL_L, "d_inner": cfg.d_inner,
          "ms_per_prefill": timing["ms_per_iter"],
          "tokens_per_s": HYBRID_PREFILL_L / (timing["ms_per_iter"] / 1e3),
          "host_enqueue_ms": timing["host_enqueue_ms_per_iter"],
          "selective_scan_launches": scans, "card": card})
    counts["selective_scan"] = scans
    return counts


def phase_encdec_serve(torch, card):
    """whisper-tiny (4 + 4 layers, d 384, 6 heads of 64, 1500 frames,
    vocab 51865) through phase_family_serve: batch 8, prompt 64, 32
    tokens; the encoder and prefill_cross run once, every decode step runs
    B8 twice a layer (self, then cross over the 1500 encoded frames), held
    at group 1 on both."""
    return phase_family_serve(
        torch, card, "encdec_serve", ENCDEC_ARGV,
        held=((0, "decode_attention_g1"),
              (1, "decode_attention_g1_cross1500")))[2]


def phase_vlm_serve(torch, card):
    """llama-3.2-vision-90b at its published widths (d 8192, 64/8 heads
    of 128, d_ff 28672, vocab 128256, 1601 image tokens), VLM_LAYERS of
    its 100 layers (4 of its 20 cross-attention groups), through
    phase_family_serve: batch 4, prompt 128, 32 tokens; B8 held at group 8
    on the self-attention ring and on the 1601 image slots; the float32
    twin keeps the first group."""
    from repro_torch.configs.registry import get_config

    # a step's B8 calls: group 0's period - 1 self layers, then its cross
    cross = get_config(VLM_ARGV[1]).cross_attn_period - 1
    return phase_family_serve(
        torch, card, "vlm_serve", VLM_ARGV, layers=VLM_LAYERS,
        twin_layers=VLM_TWIN_LAYERS,
        held=((0, "decode_attention_g8"),
              (cross, "decode_attention_g8_cross1601")))[2]


def phase_moe_serve(torch, card, hw):
    """mixtral-8x22b at its published widths (d 6144, 48/8 heads of 128,
    d_ff 16384, 8 experts top-2, vocab 32768), 8 of its 56 layers, bf16,
    random weights from the seed, through launch.serve's engine with
    --moe-comm --mesh 8: every decode step's MoE FFN runs through one
    DynamicMoELayer over LoopbackComm(8), its tables derived on the card
    from the step's routing; prefill runs moe_fwd; attention decodes
    through B8 at 48/8 heads (group 6).  After a warm-up batch, 16 requests
    over 8 slots as in the serve phase, the counters zeroed before and read
    after.  Then one tick's derivation under the sync debug mode, its
    tables against the host planner's, the hook's pieces timed, a float32
    twin of 2 layers holding the hook against moe_fwd, and B8 at group 6
    against its plain version."""
    from repro_torch.comm import select
    from repro_torch.comm import strategies as strat
    from repro_torch.comm.plan import build_comm_plan, derive_scatter_plan
    from repro_torch.configs.registry import get_config
    from repro_torch.core import perfmodel as pm
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import serve as lserve
    from repro_torch.models.transformer import Model, RunCtx, tree_map
    from repro_torch.serve import Request
    from repro_torch.serve.engine import _with_moe_hook

    args = lserve.parse_args(MOE_ARGV)
    cfg = dataclasses.replace(get_config(args.arch), num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    engine = lserve.build_engine(cfg, RunCtx(act_dtype=torch.bfloat16), args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layer, model, params = engine.moe_layer, engine.model, engine.params
    dev = model.device
    weights_gb = sum(t.numel() * t.element_size()
                     for t in _leaves(params)) / 1e9
    check(set(layer.strategies.values()) <= {"condensed", "overlap"},
          f"the MoE layer resolved {layer.strategies}")

    rng = np.random.default_rng(SEED + 1)
    for i in range(MOE_WARMUP["requests"]):
        engine.submit(Request(
            id=f"warm{i}", prompt=rng.integers(
                0, cfg.vocab_size, (MOE_WARMUP["prompt_len"],)).tolist(),
            max_new_tokens=MOE_WARMUP["gen"], arrival_time=0.0))
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    n_ticks, n_tokens = len(engine._tick_seconds), len(engine._token_seconds)
    snap = engine.snapshot()
    lserve.submit_trace(engine, cfg, args)
    prompt_tokens = sum(len(r.prompt) for r in engine.queue.ready(
        float("inf")))
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    report = engine.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    delta = engine.assert_steady_state(snap)
    ids = [f"req{i}" for i in range(args.requests)]
    tick_s = report.tick_seconds[n_ticks:]
    token_s = report.token_seconds[n_tokens:]
    decode_ticks = len(tick_s)
    check(all(i in report.completed for i in ids),
          "a request of the trace did not complete")
    check(all(len(report.outputs[i]) == args.gen for i in ids),
          "a request did not get its tokens")
    check(all(0 <= t < cfg.vocab_size for i in ids
              for t in report.outputs[i]), "a token outside the vocabulary")
    check(delta["host-build"] == 0 and delta["decode_steps"] == decode_ticks,
          f"steady-state decode telemetry {delta}")
    check(delta["device-derive"] == cfg.num_layers * decode_ticks,
          f"{delta['device-derive']} device derivations in {decode_ticks} "
          f"decode ticks of {cfg.num_layers} layers")
    check(counts["decode_attention"] == cfg.num_layers * decode_ticks,
          f"decode_attention launched {counts['decode_attention']} times "
          f"in {decode_ticks} decode ticks of {cfg.num_layers} layers")

    # one tick's hook inputs, held from a decode step on the final cache
    held = []
    saved_apply = layer.apply

    def keep(x, top_e, top_w, *w):
        if not held:
            held.append((x, top_e, top_w, w))
        return saved_apply(x, top_e, top_w, *w)
    layer.apply = keep
    try:
        model.decode_step(params, engine.cache, engine._tokens)
    finally:
        layer.apply = saved_apply
    x, top_e, top_w, w = held[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cols, w_slot = layer.pack(top_e, top_w)
        gargs, sargs = layer.derive(cols)
    except RuntimeError as e:
        fail(f"the table derivation synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n, p, s_max = layer.num_tokens, layer.p, layer.pattern.s_max
    plan = build_comm_plan(cols.cpu().numpy().astype(np.int32).reshape(
        -1, 1), n, p, s_max=s_max)
    want = ((plan.send_local_idx, plan.recv_global_idx)
            + strat.scatter_plan_device_args(derive_scatter_plan(plan),
                                             layer.scatter.strategy))
    got = tuple(gargs) + tuple(sargs)
    check(len(got) == len(want) and all(
        torch.equal(g.cpu(), torch.as_tensor(np.asarray(t)))
        for g, t in zip(got, want)),
        "the tables derived on the card differ from the host planner's")

    xs = x.reshape(p, -1, x.shape[-1])
    buf = layer.dispatch(xs, cols, gargs)
    contrib = layer.experts(buf, w_slot, w)
    hook_ms = {
        "derive": cuda_ms(torch, lambda: layer.derive(
            layer.pack(top_e, top_w)[0]), warmup=2, iters=10),
        "dispatch": cuda_ms(torch, lambda: layer.dispatch(xs, cols, gargs),
                            warmup=2, iters=10),
        "experts": cuda_ms(torch, lambda: layer.experts(buf, w_slot, w),
                           warmup=2, iters=10),
        "combine": cuda_ms(torch, lambda: layer.combine(contrib, sargs),
                           warmup=2, iters=10),
        "layer": cuda_ms(torch, lambda: layer.apply(x, top_e, top_w, *w),
                         warmup=2, iters=10)}

    def step():
        return model.decode_step(params, engine.cache, engine._tokens)[0]
    timing = time_steps(torch, step, warmup=2, iters=5)
    prof = profile_steps(torch, step, steps=2, lead=1)

    # the float32 twin of the first layers: the hook against moe_fwd
    tcfg = dataclasses.replace(cfg, num_layers=MOE_TWIN_LAYERS)
    twin = Model(tcfg, RunCtx(act_dtype=torch.float32), device=dev)
    p32 = {k_: (tree_map(lambda t: t[:MOE_TWIN_LAYERS].float(), v_)
                if k_ == "layers" else tree_map(lambda t: t.float(), v_))
           for k_, v_ in params.items()}
    c32 = {"pos": engine.cache["pos"], "layers": tree_map(
        lambda t: (t[:MOE_TWIN_LAYERS].float() if t.is_floating_point()
                   else t[:MOE_TWIN_LAYERS].clone()), engine.cache["layers"])}
    got = _with_moe_hook(twin, layer).decode_step(p32, c32,
                                                  engine._tokens)[0]
    want = twin.decode_step(p32, c32, engine._tokens)[0]
    check(bool(torch.isfinite(got).all()), "hooked decode logits not finite")
    twin_err = rel_l2(torch, got, want)
    check(twin_err < LOGITS_REL_F32,
          f"float32 decode logits through the MoE hook are {twin_err} "
          "(relative L2) from moe_fwd's")
    del twin, p32, c32, got, want

    # B8 at mixtral's heads: group 6
    q, k, v, lengths, sdpa, bnd = decode_inputs(torch, dev, 2080, 1025,
                                                heads=(cfg.num_heads,
                                                       cfg.num_kv_heads))
    got = kops.decode_attention(q.float(), k, v, lengths)
    want = kref.decode_attention_ref(q.float(), k, v, lengths)
    g6_err = float((got - want).abs().max())
    check(torch.allclose(got, want, **MODEL_TOL),
          f"decode_attention at group 6 differs from its plain version: "
          f"{g6_err}")
    got = kops.decode_attention(q, k, v, lengths)
    check(got.dtype == torch.bfloat16 and torch.allclose(
        got.float(), want, **BF16_OUT_TOL),
        "decode_attention's bf16 output at group 6 is more than one "
        "rounding off")
    g6 = dict(max_abs_err=g6_err, ms=cuda_ms(
        torch, lambda: kops.decode_attention(q, k, v, lengths)),
        plain_ms=cuda_ms(torch, lambda: kref.decode_attention_ref(
            q, k, v, lengths)), library_ms=cuda_ms(torch, sdpa), bound=bnd)
    emit({"phase": "kernel", "name": "decode_attention_g6",
          **{k_: v_ for k_, v_ in g6.items() if k_ != "bound"},
          "bound_ms": bnd[0], "bound_by": bnd[1],
          "shape": f"q {tuple(q.shape)} bf16, k/v {tuple(k.shape)} bf16, "
                   f"group {cfg.num_heads // cfg.num_kv_heads}, "
                   f"{int(lengths.sum())} live slots"})
    check_bound("decode_attention at group 6", g6)
    del q, k, v

    ttft = [report.ttft_seconds[i] for i in ids]
    srt = sorted(token_s)
    emit({"phase": "moe_serve", "arch": cfg.name, "layers": cfg.num_layers,
          "published_layers": get_config(args.arch).num_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff,
          "heads": [cfg.num_heads, cfg.num_kv_heads],
          "experts": [cfg.num_experts, cfg.experts_per_token],
          "dtype": "bfloat16", "requests": args.requests,
          "slots": args.slots, "cache_len": args.prompt_len + args.gen,
          "prompt_tokens": prompt_tokens, "init_s": round(init_s, 3),
          "weights_gb": round(weights_gb, 3), "warmup_s": round(warm_s, 3),
          "wall_s": wall_s, "decode_ticks": decode_ticks,
          "decode_tokens_per_s": len(token_s) / sum(tick_s),
          "p50_token_ms": 1e3 * srt[len(srt) // 2],
          "p99_token_ms": 1e3 * srt[min(len(srt) - 1,
                                        int(round(0.99 * (len(srt) - 1))))],
          "mean_ttft_ms": 1e3 * sum(ttft) / len(ttft),
          "strategies": layer.strategies, "s_max": s_max,
          "capacity": layer.capacity, "plan_time_us": layer.plan_time * 1e6,
          "telemetry": delta,
          "decode_attention_launches": counts["decode_attention"],
          "hook_ms_per_layer": hook_ms,
          "logits_rel_l2_hook_vs_moe_fwd_f32": twin_err,
          "decode_step": {**timing, **prof}, "card": card})

    # the dispatch and combine priced with the decode floors (12δ-15δ)
    stages = [("dispatch", "get", select.workload_from_plan(
        layer.gather.plan, 1), layer.gather.strategy),
        ("combine", "put", select.workload_from_plan(
            layer.scatter.splan, 1), layer.scatter.strategy)]
    step_pred = pm.predict_decode_step(stages, hw)
    rows = [(name, strategy, pm.predict_decode_exchange(
        w_, hw, strategy=strategy, direction=d_), hook_ms[name])
        for name, d_, w_, strategy in stages]
    rows.append(("derive+dispatch+combine", layer.gather.strategy,
                 step_pred["total"] + layer.plan_time,
                 hook_ms["derive"] + hook_ms["dispatch"]
                 + hook_ms["combine"]))
    for name, strategy, t, ms in rows:
        check(np.isfinite(t) and t > 0, f"moe {name}: predicted {t} s")
        emit({"phase": "model", "kind": "model_row", "path": "moe_decode",
              "stage": name, "strategy": strategy, "measured_ms": ms,
              "predicted_ms": t * 1e3,
              "model_error": pm.model_error(ms * 1e-3, t),
              "error_budget": pm.error_budget(
                  {"rung": strategy, "workload": "moe_decode",
                   "dtype": "bfloat16", "mesh": [P]}),
              "latency_bound": list(step_pred["latency_bound"]),
              "card": card})
    return counts


def phase_gnn(torch, comm, hw, card):
    """GNNNeighborAggregate over LoopbackComm(8) on a power-law graph
    (GNN_N nodes, GNN_R Zipf(GNN_ALPHA) neighbors each, GNN_D float32
    features), on the condensed rung and under auto (one base plan, the
    plan cache's), each checked against gnn_ref_np and timed over 3 steps after
    2, with its busy share and a model_row (the §5 window of both
    exchanges)."""
    from repro_torch.core import perfmodel as pm
    from repro_torch.models.gnn import (GNNNeighborAggregate, gnn_ref_np,
                                        random_neighbors)

    t0 = time.perf_counter()
    nbrs = random_neighbors(GNN_N, GNN_R, alpha=GNN_ALPHA, seed=SEED)
    h = np.random.default_rng(SEED).standard_normal(
        (GNN_N, GNN_D)).astype(np.float32)
    t1 = time.perf_counter()
    want = gnn_ref_np(h, nbrs)
    ref_s = time.perf_counter() - t1
    graph_s = t1 - t0
    for strategy in ("condensed", "auto"):
        t0 = time.perf_counter()
        # the second construction's base plan: a memory hit of the cache
        layer = GNNNeighborAggregate(nbrs, GNN_N, comm, strategy=strategy,
                                     hw=hw)
        build_s = time.perf_counter() - t0
        hs = layer.shard_features(h)
        out = layer(hs)
        check(tuple(out.shape) == (P, GNN_N // P, GNN_D),
              f"gnn {strategy}: output has shape {tuple(out.shape)}")
        got = out.reshape(GNN_N, GNN_D).cpu().numpy()
        check(np.isfinite(got).all(), f"gnn {strategy}: output not finite")
        check(np.allclose(got, want, **GNN_TOL),
              f"gnn {strategy} differs from gnn_ref_np: "
              f"{float(np.abs(got - want).max())}")
        del out, got
        torch.cuda.reset_peak_memory_stats()
        timing = time_steps(torch, lambda: layer(hs), warmup=2, iters=3)
        prof = profile_steps(torch, lambda: layer(hs), steps=1, lead=1)
        rungs = "/".join(sorted(set(layer.strategies.values())))
        predicted = layer.predicted_window["total"]
        check(np.isfinite(predicted) and predicted > 0,
              f"gnn {strategy}: predicted {predicted} s")
        emit({"phase": "gnn", "strategy": strategy,
              "strategies": layer.strategies, "n": GNN_N, "r": GNN_R,
              "d": GNN_D, "alpha": GNN_ALPHA, "ranks": P,
              "graph_s": round(graph_s, 3), "ref_np_s": round(ref_s, 3),
              "build_s": round(build_s, 3),
              "ms_per_step": timing["ms_per_iter"],
              "host_enqueue_ms": timing["host_enqueue_ms_per_iter"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              **prof, "card": card})
        emit({"phase": "model", "kind": "model_row", "path": "gnn",
              "strategy": rungs, "requested": strategy,
              "measured_ms": timing["ms_per_iter"],
              "predicted_ms": predicted * 1e3,
              "predicted_times_ms": {
                  st: {r: t * 1e3 for r, t in (v or {}).items()}
                  for st, v in layer.predicted_times.items()},
              "model_error": pm.model_error(timing["ms_per_iter"] * 1e-3,
                                            predicted),
              "error_budget": pm.error_budget(
                  {"rung": strategy, "workload": "gnn", "dtype": "float32",
                   "mesh": [P]}),
              "busy_share": prof["busy_share"], "card": card})
        del layer, hs
        gc.collect()
        torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class _Held(dict):
    """The calls ``held_calls`` kept, by number; ``calls`` counts all."""
    calls = 0


@contextlib.contextmanager
def held_calls(kops, name, which=()):
    """Keep the arguments and result of the calls numbered ``which`` (from
    0) of ``kops.<name>`` inside the block, in the dict it yields (its
    ``calls`` counts every call); the calls themselves go on as before."""
    saved, held = getattr(kops, name), _Held()

    def keep(*args):
        out = saved(*args)
        if held.calls in which:
            held[held.calls] = (args, out)
        held.calls += 1
        return out
    setattr(kops, name, keep)
    try:
        yield held
    finally:
        setattr(kops, name, saved)


def phase_ssm_prefill(torch, card):
    """falcon-mamba-7b at its published widths and depth, bf16, random
    weights from the seed: build_prefill at B = 1, L = 32768, counters
    zeroed before the first call and read after.  The selective_scan calls
    of the first and last layer of that prefill against the plain
    recurrence on their own inputs at 2e-4, and the last-position logits
    with B9 against the plain recurrence's at L = 1024."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.models.transformer import Model, RunCtx
    from repro_torch.runtime.steps import build_prefill

    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    model = Model(cfg, RunCtx(act_dtype=torch.bfloat16))
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init_params(gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, SSM_L), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill = build_prefill(model)

    kops.reset_launch_counts()
    with held_calls(kops, "selective_scan", SSM_HELD_LAYERS) as held:
        logits = prefill(params, tokens)
        torch.cuda.synchronize()
    counts = kops.launch_counts()
    check(counts["selective_scan"] == cfg.num_layers,
          f"selective_scan launched {counts['selective_scan']} times in one "
          f"prefill of {cfg.num_layers} layers")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size),
          f"logits have shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(len(held) == len(SSM_HELD_LAYERS), "a held scan call is missing")
    scan_errs = {}
    for layer in sorted(held):
        args, got = held.pop(layer)
        check(tuple(got.shape) == (1, SSM_L, cfg.d_inner),
              f"layer {layer}'s scan has shape {tuple(got.shape)}")
        want = kref.selective_scan_ref(*args)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **MODEL_TOL),
              f"layer {layer}'s selective_scan in the prefill differs from "
              f"the plain recurrence on its inputs: {err}")
        scan_errs[layer] = {
            "max_abs_err": err, "max_abs": float(want.abs().max()),
            "dt_a_min": float((args[1].min() * args[4].abs().min()))}
    del args, got, want

    short = tokens[:, :SSM_CHECK_L]
    m32, p32 = float32_twin(torch, model, params)
    errs = {}
    for name, fn in (("bf16", lambda: prefill(params, short)),
                     ("f32", lambda: build_prefill(m32)(p32, short))):
        got = fn()
        with plain_kernel(kops, "selective_scan", kref.selective_scan_ref):
            want = fn()
        errs[name] = rel_l2(torch, got, want)
    del m32, p32
    # in bf16 the 64 random layers turn the kernel's other summation order
    # into another answer (reported, not held); float32 is held
    check(errs["f32"] < LOGITS_REL_F32,
          f"prefill logits with B9 are {errs} (relative) from the plain "
          "recurrence's")
    torch.cuda.reset_peak_memory_stats()
    timing = time_steps(torch, lambda: prefill(params, tokens), warmup=1,
                        iters=2)
    prof = profile_steps(torch, lambda: prefill(params, tokens), steps=1,
                         lead=1)
    emit({"phase": "ssm_prefill", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_inner": cfg.d_inner,
          "state": cfg.ssm_state, "dtype": "bfloat16", "batch": 1,
          "seq": SSM_L, "init_s": round(init_s, 3),
          "ms_per_prefill": timing["ms_per_iter"],
          "tokens_per_s": SSM_L / (timing["ms_per_iter"] / 1e3),
          "host_enqueue_ms": timing["host_enqueue_ms_per_iter"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "selective_scan_launches": counts["selective_scan"],
          "scan_vs_plain_by_layer": scan_errs,
          "check_seq": SSM_CHECK_L, "logits_rel_l2_vs_plain": errs, **prof,
          "card": card})
    return counts


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

# marker kernels spin MARK_SPIN_US x 2^(their number mod MARK_CODES), so
# that the profiler's durations tell which event a kept marker follows
MARK_CODES = 6
MARK_SPIN_US = 2.0


def region_marks(torch, log):
    """An autograd function that records a CUDA event, launches a marker
    kernel (a ``torch.cuda._sleep`` of MARK_SPIN_US x 2^code, code its
    number mod MARK_CODES) and appends ``(region, edge, event)`` to
    ``log`` in its forward and again in its backward: placed on
    a region's inputs (edges start/end) and outputs (end/start), its
    events bracket the region's forward and its backward on the stream, in
    launch order, and the marker kernels place the events on the
    profiler's clock.  The backward's region may have a name of its
    own."""

    def emit_mark(kind, edge):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        code = len(log) % MARK_CODES
        log.append((kind, edge, event))
        torch.cuda._sleep(int(SPIN_CYCLES_PER_S * 1e-6 * MARK_SPIN_US
                              * 2 ** code))

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kind, bwd_kind, fwd_edge, bwd_edge, *ts):
            ctx.kind, ctx.edge = bwd_kind, bwd_edge
            emit_mark(kind, fwd_edge)
            return tuple(t.view_as(t) for t in ts)

        @staticmethod
        def backward(ctx, *grads):
            emit_mark(ctx.kind, ctx.edge)
            return (None, None, None, None) + grads

    def around(kind, fn, n_in, bwd_kind=None):
        """``fn`` with its first ``n_in`` tensor arguments and its tensor
        result marked as the region ``kind`` (its backward ``bwd_kind``,
        by default ``kind`` too)."""
        back = bwd_kind or kind

        def wrapped(*args, **kw):
            marked = Mark.apply(kind, back, "start", "end", *args[:n_in])
            out = fn(*marked, *args[n_in:], **kw)
            return Mark.apply(kind, back, "end", "start", out)[0]
        return wrapped
    return emit_mark, around


# kernel-name parts of the matmul kernels (cuBLAS's sm90 kernels are
# "nvjet_*" in CUDA 12.8)
GEMM_NAMES = ("gemm", "xmma", "cutlass", "cublas", "nvjet")


def profile_train_step(torch, step_fn):
    """One train step under torch.profiler, its device time split by
    region: attention (the training attention's einsums and elementwise
    passes, forward, recompute and backward), the selective scan (B9's
    forward, recompute included: ``selective_scan``) and its backward
    kernel (``selective_scan_bwd``), the fused CE loss, the embedding (its
    gather and its backward, the bf16 ordered add), AdamW, and the rest
    (matmuls and elementwise).  Marker kernels bracket each region
    (``region_marks``); a kernel counts to the region whose markers
    enclose it.  Also the busy share of the step: the union of the device
    intervals over the span from the first to the last."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops as kops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw as A

    log = []
    emit_mark, around = region_marks(torch, log)
    saved = (L.attention, TT.fused_ce_loss, A.AdamW.apply, TT._embed_fwd,
             kops.selective_scan)
    real_apply, real_embed = A.AdamW.apply, TT._embed_fwd
    embed = around("embedding", lambda w, tokens, cfg, ctx: real_embed(
        {"w": w}, tokens, cfg, ctx), 1)

    def apply(self, *args):
        emit_mark("adamw", "start")
        out = real_apply(self, *args)
        emit_mark("adamw", "end")
        return out
    L.attention = around("attention", L.attention, 3)
    TT.fused_ce_loss = around("fused_ce", TT.fused_ce_loss, 2)
    TT._embed_fwd = lambda p, *args: embed(p["w"], *args)
    A.AdamW.apply = apply
    kops.selective_scan = around("selective_scan", kops.selective_scan, 5,
                                 bwd_kind="selective_scan_bwd")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            metrics = step_fn()
            torch.cuda.synchronize()
    finally:
        (L.attention, TT.fused_ce_loss, A.AdamW.apply, TT._embed_fwd,
         kops.selective_scan) = saved
    # the profiler's raw device events (us): building prof.events()' tree
    # of a step's ~10^5 kernels takes the host tens of seconds
    acts = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    marks = [a for a in acts if "spin_kernel" in a[2]]
    seen = [a[0] for a in marks]
    # the profiler now and then drops kernels, markers too: the events
    # and the markers' codes say which markers it kept and where the
    # missing ones were
    rel = [log[0][2].elapsed_time(e) * 1e3 for _, _, e in log]   # us
    edges = align_marks(seen, rel, mark_codes([b - a for a, b, _ in marks]))
    check(edges is not None,
          f"the profiler saw {len(seen)} markers, {len(log)} launched")
    regions, open_at = [], {}
    for (kind, edge, _), t in zip(log, edges):
        if edge == "start":
            check(kind not in open_at, f"region {kind} opened twice")
            open_at[kind] = t
        else:
            regions.append((open_at.pop(kind), t, kind))
    check(not open_at, f"regions left open: {sorted(open_at)}")
    ms, by_name = {}, {}
    kernels = [a for a in acts if "spin_kernel" not in a[2]]
    regions.sort()                  # disjoint: one stream, no nesting
    los = [lo for lo, _, _ in regions]
    for start, end, name in kernels:
        i = bisect.bisect_right(los, start) - 1
        kind = regions[i][2] if i >= 0 and start < regions[i][1] \
            else "other"
        part = "gemm" if any(g in name.lower() for g in GEMM_NAMES) \
            else "elementwise"
        key = f"{kind}_{part}_ms"
        ms[key] = ms.get(key, 0.0) + (end - start) / 1e3
        names = by_name.setdefault(key, {})
        names[name[:60]] = names.get(name[:60], 0.0) + (end - start) / 1e3
    span = kernels[-1][1] - kernels[0][0] if kernels else 0.0
    return metrics, {
        "regions_ms": dict(sorted(ms.items())),
        "top_kernels_ms": {k: sorted(v.items(), key=lambda r: -r[1])[:3]
                           for k, v in sorted(by_name.items())},
        "kernel_ms": sum(ms.values()),
        "profiled_span_ms": span / 1e3,
        "busy_share": busy_us((a, b) for a, b, _ in kernels) / span
        if span else 0.0,
        "regions": len(regions), "markers": len(log),
        "markers_profiled": len(seen)}


def mark_codes(durations):
    """Each kept marker's code (its number mod MARK_CODES) read from its
    duration in us: a duration is o + u * 2^code, o the kernel's own time
    and u the spin's MARK_SPIN_US at the card's clock, both fitted to the
    middles of the shortest and the longest code's share of the sorted
    durations; each marker takes the code whose duration is nearest."""
    ds, part = sorted(durations), 2 * MARK_CODES
    lo, hi = ds[len(ds) // part], ds[(part - 1) * len(ds) // part]
    unit = (hi - lo) / (2 ** (MARK_CODES - 1) - 1)
    return [min(range(MARK_CODES),
                key=lambda k: abs(d - lo - unit * (2 ** k - 1)))
            for d in durations]


def align_marks(seen, rel, codes):
    """The profiler's time of every event, or None.  ``rel`` are the
    events' times after the first (us, CUDA events, every one), ``seen``
    the start times of the marker kernels the profiler kept, each launched
    right after its event, and ``codes`` their codes (event k's marker has
    k mod MARK_CODES).  With none missing they pair in order.  When the
    profiler dropped some, the markers are walked in order: each goes to
    one of the next events (skipping at most the markers still unaccounted
    for) whose code is its own; with fewer than MARK_CODES drops that
    event is the only one, else the one nearest to it at the offset of the
    marker before (the offset moves with the host's launch delays and the
    clocks' drift, so only locally).  The first marker goes to the event
    that gives the least total miss.  An event whose marker is missing
    takes the offset of the marker before it (after it, at the start)."""
    drops = len(rel) - len(seen)
    if not seen or drops < 0:
        return None
    if not drops:
        return list(seen)

    def of_code(m, events):
        # a misread code (none of the events has it) leaves them all
        return [k for k in events if k % MARK_CODES == codes[m]] \
            or list(events)

    def walk(i0):
        offs, i, miss = {i0: seen[0] - rel[i0]}, i0, 0.0
        for m in range(1, len(seen)):
            left = drops - (i + 1 - len(offs))
            near = of_code(m, range(i + 1, min(i + 2 + left, len(rel))))
            if not near:
                return None, 0.0
            t = seen[m]
            j = min(near, key=lambda k: abs(t - offs[i] - rel[k]))
            miss += abs(t - offs[i] - rel[j])
            offs[j], i = t - rel[j], j
        return offs, miss
    walks = [w for w in map(walk, of_code(0, range(drops + 1)))
             if w[0] is not None]
    if not walks:
        return None
    offs = min(walks, key=lambda w: w[1])[0]
    out, off = [], offs[min(offs)]
    for k, r in enumerate(rel):
        off = offs.get(k, off)
        out.append(r + off)
    return out


def matmul_rate(torch, dev, n: int = 8192) -> float:
    """FLOP/s of one bf16 ``torch.matmul`` of two n x n matrices."""
    a = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    b = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    ms = cuda_ms(torch, lambda: torch.matmul(a, b), warmup=3, iters=10)
    return 2.0 * n ** 3 / (ms * 1e-3)


def embedding_backward_ms(torch, tr, args) -> dict:
    """Device ms of the embedding's forward and backward at one
    microbatch of the train step (its tokens, float32 master table, a
    bf16 cotangent): ``_embed_fwd``'s (the reference's bf16 ordered add)
    and the float32 add of ``F.embedding(...).to(bf16)`` that it replaced.
    CUDA events around 3 calls after one, no marker kernel: the ordered
    add reads its round count on the host."""
    import torch.nn.functional as F

    from repro_torch.models import transformer as TT
    tokens = tr.batch()[0][:args.batch // args.accum]
    w = tr.params["embed"]["w"].detach().requires_grad_(True)
    cfg, ctx = tr.model.cfg, tr.model.ctx
    ct = torch.randn(tuple(tokens.shape) + (cfg.d_model,),
                     device=w.device).to(ctx.act_dtype)
    out = {}
    for name, fn in (("reference_bf16_add", lambda: TT._embed_fwd(
            {"w": w}, tokens, cfg, ctx)), ("float32_add", lambda: F.embedding(
                tokens, w).to(ctx.act_dtype))):
        torch.autograd.grad(fn(), w, ct)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            torch.autograd.grad(fn(), w, ct)
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 3
    return out


def train_steps(torch, tr, timed: int):
    """One warm-up step and ``timed`` timed ones (CUDA events): every
    step's loss and gradient norm, and the timed steps' ms."""
    losses, gnorms, step_ms = [], [], []
    for i in range(1 + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = tr.step()
        end.record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if i:
            step_ms.append(start.elapsed_time(end))
    return losses, gnorms, step_ms


def train_phase(torch, phase, argv, layers, timed, watch=None,
                with_trainer=None):
    """A model trained through launch.train (``setup`` and the Trainer's
    step, the pieces ``main`` runs) at ``layers`` of its layers (all of
    them for None): 1 warm-up step and ``timed`` timed ones (CUDA events)
    inside the context ``watch()``, the kernel counters zeroed before the
    warm-up and read after the last timed step; then one profiled step
    split by region; every loss and gradient norm finite, the first loss
    within 2 of ln(vocab).  ``with_trainer(tr, args)`` runs before the
    trainer is dropped and gives fields of the phase's line.  Returns the
    config, the steps' launch counts, what ``watch`` yielded and the
    line's fields: ms a step, tokens/s, MFU against the bf16 spec, peak
    memory, every loss and gradient norm, the profiled step's regions and
    the wall seconds of each part."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.steps import model_flops

    args = ltrain.parse_args(argv)
    full = get_config(args.arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = ltrain.setup(cfg, args, retries=0)     # no failure retried away
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    kops.reset_launch_counts()
    with (watch or contextlib.nullcontext)() as seen:
        losses, gnorms, step_ms = train_steps(torch, tr, timed)
    counts = kops.launch_counts()
    t2 = time.perf_counter()
    metrics, prof = profile_train_step(torch, tr.step)
    t3 = time.perf_counter()
    losses.append(float(metrics["loss"]))
    gnorms.append(float(metrics["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{phase}: losses {losses}, grad norms {gnorms}")
    ln_v = float(np.log(cfg.vocab_size))
    check(abs(losses[0] - ln_v) <= 2.0,
          f"{phase}: step-0 loss {losses[0]} is not within 2 of ln(V) = "
          f"{ln_v}")
    extra = with_trainer(tr, args) if with_trainer else {}
    del tr, metrics
    gc.collect()
    torch.cuda.empty_cache()
    ms = float(np.mean(step_ms))
    flops = model_flops(cfg, mode="train", batch=args.batch, seq=args.seq)
    return cfg, counts, seen, {
        "phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
        "of_layers": full.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "params": n_params, "seq": args.seq,
        "batch": args.batch, "accum": args.accum, "remat": "full",
        "dtype": "bfloat16 activations, float32 master",
        "init_s": round(t1 - t0, 3), "step_ms": step_ms, "ms_per_step": ms,
        "tokens_per_s": args.batch * args.seq / (ms * 1e-3),
        "model_flops_per_step": flops,
        "model_tflops_per_s": flops / (ms * 1e-3) / 1e12,
        "mfu_vs_bf16_spec": flops / (ms * 1e-3) / BF16_FLOP_PER_S,
        "peak_memory_gb": peak_gb, "losses": losses, "grad_norms": gnorms,
        "loss0_minus_ln_vocab": losses[0] - ln_v, "profiled_step": prof,
        "wall_s": {"setup": round(t1 - t0, 1), "steps": round(t2 - t1, 1),
                   "profiled_step": round(t3 - t2, 1),
                   "rest": round(time.perf_counter() - t3, 1)},
        **extra}


def phase_train(torch, card):
    """llama3-8b at its published widths, TRAIN_LAYERS of its 32 layers,
    through train_phase with TRAIN_TIMED timed steps; beside the MFU
    against the bf16 spec the MFU against a bf16 matmul measured here, and
    the embedding's backward at one microbatch."""
    cfg, _, _, fields = train_phase(
        torch, "train", TRAIN_ARGV, TRAIN_LAYERS, TRAIN_TIMED,
        with_trainer=lambda tr, args: {
            "embedding_backward_ms": embedding_backward_ms(torch, tr, args)})
    rate = matmul_rate(torch, torch.device("cuda"))
    achieved = fields["model_flops_per_step"] / (fields["ms_per_step"] * 1e-3)
    emit({**fields, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "d_ff": cfg.d_ff, "bf16_matmul_tflops_per_s": rate / 1e12,
          "mfu_vs_bf16_matmul": achieved / rate, "card": card})


def scan_bwd_bound(b: int, l: int, di: int, st: int):
    """(bound_ms, bound_by) of the scan's backward, counting the
    function's own traffic and work only: x, dt, dy, B, C, a and the
    forward's checkpoints read once and dx, ddt, dB, dC and dA written
    once, float32; one exponential, exp(dt·a), a (step, channel, state)
    over the SMs' special-function lanes.  The kernel's dB/dC/dA partials
    and its second rebuild of the decays are its design's cost, not the
    function's."""
    from repro_torch.kernels.selective_scan import CKPT_STEPS
    nseg = -(-l // CKPT_STEPS)
    nbytes = 4 * (5 * b * l * di + 4 * b * l * st + 2 * di * st
                  + b * nseg * di * st)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = b * l * di * st / SFU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_exp else (t_exp, "operations")


def scan_ckpt_check(torch, name, args, out):
    """The checkpointing forward (``selective_scan_ckpt``, the forward the
    train path launches) on one call's own inputs from a train step
    (``out`` its y and checkpoints in that step): y within MODEL_TOL of the
    plain recurrence's (timed once) and bit for bit with the serving
    entry's on the same inputs, a repeat launch bit for bit in y and the
    checkpoints; its ms beside the serving entry's, and its bound (the
    serving forward's bytes and operations, and the checkpoints
    written)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import selective_scan as b9
    args = tuple(t.detach() for t in args)
    y, hck = out[0].detach(), out[1]
    b, l, di = y.shape
    st = args[2].shape[2]
    t0 = time.perf_counter()
    want = kref.selective_scan_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((y - want).abs().max())
    check(torch.allclose(y, want, **MODEL_TOL),
          f"{name}: the checkpointing forward differs from the plain "
          f"recurrence on its inputs: {err}")
    del want
    serving = torch.equal(b9.selective_scan(*args), y)
    y2, hck2 = b9.selective_scan_ckpt(*args)
    repeat = torch.equal(y2, y) and (hck is None or torch.equal(hck2, hck))
    check(serving, f"{name}: the checkpointing forward's y is not the "
          "serving entry's bit for bit")
    check(repeat, f"{name}: two checkpointing forwards differ in bits")
    del y2, hck2
    nseg = 0 if hck is None else hck.shape[1]
    res = dict(
        max_abs_err=err, plain_ms=plain_ms,
        ms=cuda_ms(torch, lambda: b9.selective_scan_ckpt(*args), warmup=2,
                   iters=10),
        serving_ms=cuda_ms(torch, lambda: b9.selective_scan(*args),
                           warmup=2, iters=10),
        bound=bound(4 * (3 * b * l * di + 2 * b * l * st + di * st
                         + b * nseg * di * st), flops=7.0 * b * l * di * st))
    check_bound(f"{name}'s checkpointing forward", res)
    return {"max_abs_err": err, "ms": res["ms"],
            "serving_ms": res["serving_ms"], "plain_ms": plain_ms,
            "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
            "bit_identical_to_serving": serving,
            "bit_identical_repeat": repeat}


def scan_bwd_line(torch, name, args, held_out, fwd_args, fwd_out):
    """The backward kernel on one call's own inputs from a train step
    (``args`` = x, dt, B, C, a, the checkpoints, dy; ``held_out`` its
    gradients in that step): against the plain backward on the card,
    every gradient within SCAN_BWD_TOL of its largest element; two more
    launches bit for bit with the step's; ms, the plain backward's ms
    (once), the bound and what sets it; no single PyTorch call computes
    the scan's gradient.  Beside it the checkpointing forward on the
    step's first forward call (``fwd_args``, ``fwd_out``; scan_ckpt_check)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import selective_scan as b9
    ckpt = scan_ckpt_check(torch, name, fwd_args, fwd_out)
    # the step saved its inputs for autograd: no graph of the plain loop
    args = tuple(t if t is None else t.detach() for t in args)
    x, dt, bm, cm, a, hck, dy = args
    b, l, di = x.shape
    st = bm.shape[2]
    runs = [b9.selective_scan_bwd(*args) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(g, h) for run in runs
               for g, h in zip(run, held_out))
    check(same, f"{name}: two launches on the same inputs differ in bits")
    t0 = time.perf_counter()
    want = kref.selective_scan_bwd_ref(x, dt, bm, cm, a, dy)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rel = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
           for g, w in zip(held_out, want)]
    check(max(rel) <= SCAN_BWD_TOL,
          f"{name} differs from the plain backward: {rel} of each "
          "gradient's largest element")
    del runs, want
    res = dict(max_abs_err=max(rel), ms=cuda_ms(
        torch, lambda: b9.selective_scan_bwd(*args), warmup=2, iters=10),
        plain_ms=plain_ms, library_ms=None, bound=scan_bwd_bound(b, l, di,
                                                                  st),
        ckpt_forward=ckpt)
    emit({"phase": "kernel", "name": name, **{
        k_: v_ for k_, v_ in res.items() if k_ != "bound"},
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
        "rel_err_by_grad": dict(zip(("dx", "ddt", "dB", "dC", "dA"), rel)),
        "bit_identical_repeat": same,
        "shape": f"x/dt/dy ({b}, {l}, {di}) f32, B/C ({b}, {l}, {st}), "
                 f"checkpoints {hck if hck is None else tuple(hck.shape)}",
        "max_abs_err_is": "relative to each gradient's largest element"})
    check_bound(name, res)
    return res


def phase_train_scan(torch, card, phase, argv, layers, timed, kernel_name):
    """A model with mamba layers through train_phase: B9's forward
    launched layers x microbatches x 2 a step (remat full runs each
    layer's forward again in the backward), its backward layers x
    microbatches, the plain scan and the plain backward never called.  The
    warm-up's first checkpointing forward (the first layer's, first
    microbatch) and first backward (the last layer's) are held, and the
    kernel line ``kernel_name`` runs on their inputs."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import selective_scan as b9

    @contextlib.contextmanager
    def watch():
        with held_calls(kref, "selective_scan_ref") as plain, \
                held_calls(kref, "selective_scan_bwd_ref") as plain_bwd, \
                held_calls(b9, "selective_scan_ckpt", (0,)) as fwd, \
                held_calls(b9, "selective_scan_bwd", (0,)) as bwd:
            yield plain, plain_bwd, fwd, bwd

    cfg, counts, seen, fields = train_phase(torch, phase, argv, layers,
                                            timed, watch)
    plain, plain_bwd, fwd, bwd = seen
    per_step = cfg.num_layers * fields["accum"]
    want = {"selective_scan": 2 * per_step * (1 + timed),
            "selective_scan_bwd": per_step * (1 + timed)}
    got = {k: counts[k] for k in want}
    check(got == want, f"{phase}: B9 launched {got} times in {1 + timed} "
          f"steps of {cfg.num_layers} layers x {fields['accum']} "
          f"microbatches, not {want}")
    plain_calls = {"selective_scan_ref": plain.calls,
                   "selective_scan_bwd_ref": plain_bwd.calls}
    check(not any(plain_calls.values()),
          f"{phase}: the plain scan ran on the card path: {plain_calls}")
    check(0 in fwd and 0 in bwd, f"{phase}: no held B9 call")
    t0 = time.perf_counter()
    res = scan_bwd_line(torch, kernel_name, *bwd.pop(0), *fwd.pop(0))
    del seen, fwd, bwd
    gc.collect()
    torch.cuda.empty_cache()
    fields["wall_s"]["kernel_line"] = round(time.perf_counter() - t0, 1)
    emit({**fields, "d_inner": cfg.d_inner, "state": cfg.ssm_state,
          "mfu_counts": "6 N tokens (runtime/steps.model_flops): the "
                        "selective scan's own work is outside it",
          "launches": got, "plain_scan_calls": plain_calls, "card": card})
    return got, res


def phase_train_ssm(torch, card):
    """falcon-mamba-7b, TRAIN_SSM_LAYERS of its 64 layers, through
    phase_train_scan; the kernel line selective_scan_bwd."""
    return phase_train_scan(torch, card, "train_ssm", TRAIN_SSM_ARGV,
                            TRAIN_SSM_LAYERS, TRAIN_SSM_TIMED,
                            "selective_scan_bwd")


def phase_train_hybrid(torch, card):
    """hymba-1.5b at its published depth through phase_train_scan, B9's
    backward at d_inner 3200 beside the banded attention; the kernel line
    selective_scan_bwd_di3200."""
    return phase_train_scan(torch, card, "train_hybrid", TRAIN_HYBRID_ARGV,
                            None, TRAIN_HYBRID_TIMED,
                            "selective_scan_bwd_di3200")


def phase_train_twins(torch, card):
    """A float32 twin of each reduced TRAIN_TWINS model takes one train
    step (launch.train's optimizer and schedule, accumulation 2) on the
    card and on the CPU, TF32 off: every leaf's gradient (build_grad_fn,
    the step's gradient half) within TRAIN_TWIN_TOL of the leaf's largest
    CPU gradient element; loss, gradient norm and every updated parameter
    within TRAIN_TWIN_TOL.  The gradients are held leaf by leaf because
    the first step's update barely depends on them: its lr is lr/warmup
    and Adam's first update is about lr times the gradient's sign."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import (Model, RunCtx, tree_leaves,
                                                tree_map)
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.steps import build_grad_fn, build_train_step

    args = ltrain.parse_args(TRAIN_TWIN_ARGV)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in TRAIN_TWINS:
            cfg = get_config(arch, reduced=True)
            tokens, labels = SyntheticLM(cfg.vocab_size, args.seq,
                                         args.batch,
                                         seed=args.seed).batch_at(0)
            master = Model(cfg, device="cpu").init_params(
                torch.Generator().manual_seed(args.seed), master=True)
            out = {}
            for dev in ("cuda", "cpu"):
                model = Model(cfg, RunCtx(act_dtype=torch.float32),
                              device=dev)
                opt = AdamW(lr=cosine_schedule(args.lr, args.warmup,
                                               args.steps),
                            weight_decay=0.01)
                params = tree_map(lambda t: t.to(model.device, copy=True),
                                  master)
                batch = tuple(torch.from_numpy(a).to(model.device,
                                                     torch.int64)
                              for a in (tokens, labels))
                grads, _ = build_grad_fn(model, accum_steps=args.accum)(
                    params, batch)
                grads = [g.cpu() for g in tree_leaves(grads)]
                params, _, met = build_train_step(
                    model, opt, accum_steps=args.accum)(
                        params, opt.init(params), batch)
                out[dev] = (float(met["loss"]), float(met["grad_norm"]),
                            [t.cpu() for t in tree_leaves(params)], grads)
            (lc, gc_, pc, dc), (lh, gh, ph, dh) = out["cuda"], out["cpu"]
            err = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
            # each leaf's gradient error over its largest CPU element
            grad_rel = [float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(dc, dh)]
            worst = int(np.argmax(grad_rel))
            emit({"phase": "train_twin", "arch": arch, "loss_cuda": lc,
                  "loss_cpu": lh, "grad_norm_cuda": gc_, "grad_norm_cpu": gh,
                  "grad_leaves": len(dh),
                  "grad_max_rel_err": grad_rel[worst],
                  "grad_worst_leaf": worst,
                  "param_max_abs_err": err, "tol": TRAIN_TWIN_TOL,
                  "card": card})
            check(len(dc) == len(dh) and grad_rel[worst] <= TRAIN_TWIN_TOL,
                  f"train twin {arch}: leaf {worst}'s gradient is "
                  f"{grad_rel[worst]} of its scale apart, card vs CPU")
            check(abs(lc - lh) <= TRAIN_TWIN_TOL
                  and abs(gc_ - gh) <= TRAIN_TWIN_TOL * max(1.0, gh)
                  and err <= TRAIN_TWIN_TOL,
                  f"train twin {arch}: card {lc}/{gc_} vs CPU {lh}/{gh}, "
                  f"parameters {err} apart")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def phase_train_lm100m(torch, ckpt_dir, card):
    """lm100m end to end through launch.train.main: 30 steps with a
    checkpoint every 15, the loss falling by more than 0.3 (the mean of
    the last 5 against the first 5); then the step-30 checkpoint removed
    and the run started again, resuming at step 15 and giving steps 15-29's
    losses bit for bit."""
    import shutil

    from repro_torch.launch import train as ltrain

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = LM100M_ARGV + ["--ckpt-dir", str(ckpt_dir)]
    try:
        t0 = time.perf_counter()
        hist = ltrain.main(argv, retries=0)
        wall_s = time.perf_counter() - t0
        first = float(np.mean([h["loss"] for h in hist[:5]]))
        last = float(np.mean([h["loss"] for h in hist[-5:]]))
        steps = len(hist)
        shutil.rmtree(ckpt_dir / f"step_{steps}")
        t0 = time.perf_counter()
        resumed = ltrain.main(argv, retries=0)
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    same = [h["loss"] for h in resumed] == [h["loss"] for h in
                                            hist[LM100M_RESUME:]]
    sec = sorted(h["sec"] for h in hist[1:])
    emit({"phase": "train_lm100m", "steps": steps,
          "loss_first5": first, "loss_last5": last,
          "losses": [h["loss"] for h in hist],
          "median_step_s": sec[len(sec) // 2], "wall_s": wall_s,
          "resumed_at": resumed[0]["step"] if resumed else None,
          "resume_wall_s": resume_s, "resume_bit_identical": same,
          "card": card})
    check(np.isfinite(last) and last < first - 0.3,
          f"lm100m: loss {first} -> {last}, not down by 0.3")
    check(resumed and resumed[0]["step"] == LM100M_RESUME and same,
          f"lm100m: the resume at step {LM100M_RESUME} gave "
          f"{[h['loss'] for h in resumed]}, the run "
          f"{[h['loss'] for h in hist[LM100M_RESUME:]]}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src}/repro_torch not found: run from a checkout")
    sys.path.insert(0, str(src))
    # the plan cache's disk tier stays inside the checkout (build/ is not
    # committed); the smoke's plans are too large for it and stay in memory
    os.environ.setdefault("REPRO_TORCH_PLAN_CACHE_DIR",
                          str(src.parent / "build" / "plan_cache"))
    from repro_torch.comm import plan_cache
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.plan import Topology
    from repro_torch.core.matrix import (make_mesh_like_matrix, spmv_ref_np,
                                         spmv_t_ref_np)
    from repro_torch.core.spmv import DistributedSpMV

    card = phase_card(torch)
    probes = phase_build()

    t0 = time.perf_counter()
    matrix = make_mesh_like_matrix(N, R_NZ, locality_window=N // 64,
                                   long_range_frac=0.02, seed=SEED)
    x_host = np.random.default_rng(SEED).standard_normal(N).astype(
        np.float32)
    y_ref = spmv_ref_np(matrix, x_host)
    y_t_ref = spmv_t_ref_np(matrix, x_host)
    t1 = time.perf_counter()
    plan_kw = dict(blocksize=BLOCKSIZE, topology=Topology(P, SHARDS_PER_NODE))
    base = plan_cache.get_comm_plan(matrix.cols, N, P, **plan_kw)
    t2 = time.perf_counter()
    splan = plan_cache.get_scatter_plan(matrix.cols, N, P, base=base,
                                        **plan_kw)
    t3 = time.perf_counter()
    # a second construction's plan: a memory hit of the cache
    check(plan_cache.get_comm_plan(matrix.cols, N, P, **plan_kw) is base,
          "the plan cache rebuilt the base plan")
    hit_s = time.perf_counter() - t3
    # the memory tier saves a construction within this process only: a
    # base plan over REPRO_TORCH_PLAN_CACHE_MAX_BYTES is never written to
    # disk, so a new process builds it again (plan_on_disk says which)
    plan_bytes = sum(v.nbytes for v in vars(base).values()
                     if isinstance(v, np.ndarray))
    plan_seconds = {"plan_build_s": t2 - t1, "plan_memory_hit_s": hit_s,
                    "plan_saved_s": t2 - t1 - hit_s,
                    "plan_bytes": plan_bytes,
                    "plan_on_disk": os.path.exists(os.path.join(
                        plan_cache.cache_dir(), plan_cache.plan_key(
                            matrix.cols, N, P, BLOCKSIZE,
                            plan_kw["topology"]) + ".npz"))}
    scatter_plan_s = t3 - t2
    t3 = time.perf_counter()
    comm = LoopbackComm(P)
    # the fixed rungs share the setup's plans; the cache serves their
    # Destination deltas (one attach for every rung but overlap's)
    fixed_kw = dict(shards_per_node=SHARDS_PER_NODE, use_kernel=True,
                    base_plan=base)
    engines = {}
    for strategy in STRATEGIES:
        for mat in ("full", "dest"):
            engines[(strategy, mat)] = DistributedSpMV(
                matrix, comm, strategy=strategy, materialize=mat,
                **fixed_kw)
    t4 = time.perf_counter()
    t_engines = {strategy: DistributedSpMV(
        matrix, comm, strategy=strategy, transpose=True, scatter_plan=splan,
        **fixed_kw) for strategy in STRATEGIES}
    torch.cuda.synchronize()
    c, tc = base.counts, splan.counts
    emit({"phase": "setup", "n": N, "r_nz": R_NZ, "ranks": P,
          "blocksize": BLOCKSIZE, "shards_per_node": SHARDS_PER_NODE,
          "matrix_s": round(t1 - t0, 3), "plan_s": round(t2 - t1, 3),
          "scatter_plan_s": round(scatter_plan_s, 3),
          "engines_s": round(t4 - t3, 3),
          "transposed_engines_s": round(time.perf_counter() - t4, 3),
          "s_max": base.s_max, "b_max": base.b_max,
          "condensed_volume": c.total_condensed_volume(),
          "blockwise_volume": c.total_blockwise_volume(),
          "put_condensed_volume": tc.total_condensed_volume(),
          "put_blockwise_volume": tc.total_blockwise_volume(),
          "device_mem_gb": round(torch.cuda.memory_allocated() / 1e9, 3)})

    hw = phase_calibration(torch, comm, card)
    results = phase_kernels(torch, matrix, x_host, engines, y_ref)
    results.update(phase_push_kernels(torch, matrix, x_host, t_engines,
                                      probes))
    results.update(phase_stencil_kernel(torch, comm.device))
    results.update(phase_decode_attention_kernel(torch, comm.device))
    results.update(phase_selective_scan_kernel(torch, comm.device))
    counts, measured = phase_main_path(torch, engines, x_host, y_ref, card)
    phase_auto_forward(torch, matrix, comm, engines, x_host, hw, measured,
                       card)
    rows = path_rows("forward", engines, measured, hw)
    t_counts, measured = phase_transposed(torch, t_engines, x_host, y_t_ref,
                                          card)
    counts.update({k: v for k, v in t_counts.items() if k in PUSH_KERNELS})
    rows += path_rows("transposed", t_engines, measured, hw)
    del engines, t_engines
    torch.cuda.empty_cache()
    h_counts, h_rows = phase_heat2d(torch, comm, hw, card)
    counts["stencil2d"] = h_counts["stencil2d"]
    rows += h_rows
    torch.cuda.empty_cache()
    rows += phase_normal_equations(torch, comm, matrix, base, splan, x_host,
                                   hw, card)
    phase_model(rows, plan_seconds, card)
    del base, splan
    plan_cache.clear_memory_cache()
    gc.collect()
    torch.cuda.empty_cache()
    counts["decode_attention"] = phase_serve(torch, card)["decode_attention"]
    gc.collect()
    torch.cuda.empty_cache()
    for phase in (phase_hybrid_serve, phase_encdec_serve, phase_vlm_serve):
        got = phase(torch, card)
        counts["decode_attention"] += got["decode_attention"]
        counts["selective_scan"] = counts.get("selective_scan", 0) + got.get(
            "selective_scan", 0)
        gc.collect()
        torch.cuda.empty_cache()
    counts["selective_scan"] += phase_ssm_prefill(torch, card)[
        "selective_scan"]
    gc.collect()
    torch.cuda.empty_cache()
    counts["decode_attention"] += phase_moe_serve(torch, card, hw)[
        "decode_attention"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_gnn(torch, comm, hw, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    ssm_counts, results["selective_scan_bwd"] = phase_train_ssm(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_counts, _ = phase_train_hybrid(torch, card)
    for name in ("selective_scan", "selective_scan_bwd"):
        counts[name] = counts.get(name, 0) + ssm_counts[name] \
            + hybrid_counts[name]
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_twins(torch, card)
    phase_train_lm100m(torch, src.parent / "build" / "train_ckpt", card)

    kernels = []
    for name, res in results.items():
        source, replaces = SOURCE[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound"][0],
            "bound_by": res["bound"][1], "library_ms": res["library_ms"],
            **({"ckpt_forward": res["ckpt_forward"]}
               if "ckpt_forward" in res else {})})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
