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
   checked against the numpy reference (rtol/atol 2e-4) and timed; then
   dist_main_path: the same eight engines over a DistComm holding the
   eight ranks in one process of a one-process NCCL group (file:// init
   under build/, world 1, destroyed at the end of the phase), sharing the
   setup's base plan, y bit for bit the LoopbackComm(8) engine's on the
   same x, pack_gather, unpack_scatter_set, unpack_dest and
   ellpack_spmv_windowed launched as on the loopback path, ms a step
   beside the loopback engine's timed again in the phase (the difference:
   the NCCL call and the payload permutes);
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
   1e-4), its residual norm below the start's; then dist_consumers, in
   two arms.  Arm nccl: the transposed product and normal_equations_step
   on every rung, 5 CG iterations (condensed) and Heat2D on every rung x
   {dest, full} (10 steps), all with use_kernel=True, over DistComm(8) in
   one process of a one-process NCCL group (as dist_main_path), on the
   phases' own plans: every output bit for bit the LoopbackComm(8)
   engine's of phases 6 to 8 (Heat2D's field the plain steps'), each
   case's kernels launched (accumulate_segments and accumulate_into in the
   push direction; pack_gather, unpack_dest and both folds in the normal
   equations and CG; pack_gather, unpack_scatter_set, unpack_dest and
   stencil2d in Heat2D), the condensed and overlap cases' ms a step
   beside their loopback engines', those timed once the arm's counts are
   read.  Arm threads:
   the same cases over two processes of four ranks played by two threads
   on the card (ThreadWorld: DistComm's surface, a CUDA stream a thread, a
   barrier with a timeout, all_reduce through the communicator's ordered
   fold), the second process at rank_offset 4, at n = 2^18 and a 1024^2
   field: the threads' rows, stacked, bit for bit a LoopbackComm(8) run's
   on the same inputs, each thread's gathered Heat2D field the loopback
   one, every kernel above launched in the threads.  ``python3
   chip_smoke.py --only dist_consumers`` runs the card, build, setup and
   calibration lines, phases 6 to 8 and this one, and an ok line that
   carries "only": "dist_consumers";
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
15. dynamic_exchange: per-batch patterns (DynamicPattern) through the
   card's kernels over LoopbackComm(8): mixtral-8x22b's MoE dispatch and
   combine (4096 tokens, 8 experts top-2, capacity 1280, d 6144 bf16) and a
   scalar float32 edge-to-node scatter-add with its node-to-edge gather on
   a Zipf(1.1) graph of 2^19 nodes and 16 neighbors, a new routing or
   graph each of 4 batches, on the condensed and overlap rungs with
   use_kernel=True and use_kernel=False on the same batches: the kernel
   arm's batches after the first derive their tables (the segment and
   tile tables included), gather and scatter under
   torch.cuda.set_sync_debug_mode("error"); pack_gather, unpack_scatter_set
   (through its tile order), accumulate_segments (twice) and
   accumulate_into launch every step and no plain version runs; outputs
   equal the plain arm's bit for bit (the gather's n rows; the float32
   scatter against the plain arm on the CPU); ms a step of both arms, its
   derivation, gather and scatter, the busy share, and the four kernels on
   one batch's derived tables against their plain versions with ms,
   library ms and bound (kernel lines <kernel>_dyn_moe, _dyn_gnn); then
   dist_per_batch, in two arms.  Arm nccl: the same workloads, envelope
   plans and batches over DistComm(8) in the one process of an NCCL group
   (world 1), every process deriving each batch's whole tables and keeping
   its rows: both rungs with use_kernel=True, the batches after the first
   under the sync debug mode (a collective that syncs by itself is named
   on a line of its own and run outside it), every output the loopback
   kernel arm's bit for bit, B1, B2, B5 (twice) and B6 launched every step,
   no plain version run, ms a step beside the loopback arm's; and, inside
   phase 14, the same warm-up and requests served with the MoE hook's
   DynamicMoELayer rebuilt over DistComm(8): the loopback engine's tokens.
   Arm threads: the exchanges at 1024 tokens and 2^16 nodes, a
   DynamicMoELayer (its __call__ and apply) and GNNNeighborAggregate at
   small widths, over two processes of four ranks played by threads
   (ThreadWorld, the second at rank_offset 4): the rows stacked, and each
   thread's apply output, bit for bit a LoopbackComm(8) run's, the
   exchange kernels launched in the threads.  ``python3 chip_smoke.py
   --only dist_per_batch`` runs the card, build and calibration lines,
   phases 14 and 15 and this one, and an ok line that carries "only":
   "dist_per_batch";
16. gnn: GNNNeighborAggregate over LoopbackComm(8) on a Zipf(1.1) graph of
   2^19 nodes, 16 neighbors, 64 float32 features, on the condensed rung
   and under auto, each against gnn_ref_np (rtol/atol 2e-4), timed, with
   its busy share and a model_row;
17. train: llama3-8b at its published widths (d 4096, 32/8 heads of 128,
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
18. train_ssm: falcon-mamba-7b at its published widths (d 4096, d_inner
   8192, state 16, dt rank 256, vocab 65024), 16 of its 64 layers (~2.2B
   parameters, ~36 GB at 16 B a parameter; 64 would need ~117 GB), trained
   through launch.train as phase 17 (seq 4096, batch 8, accum 4, remat
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
   selective_scan_bwd_di3200).  Then dist_train: launch.train --mesh 1x1
   (the 2-D path over a one-process NCCL group, as dist_main_path's: FSDP
   storage sharding over a data group of one rank, where each part is
   the whole leaf and every gather and reduce-scatter runs, and the
   model axis over a model group of one rank, where every tensor-parallel
   collective runs) on falcon-mamba-7b at its published widths,
   DIST_TRAIN_LAYERS of its 64 layers, train_ssm's settings, beside a
   --mesh local trainer from the same seed: the first step on the same
   batch gives the local step's parameters, AdamW state, loss and
   gradient norm bit for bit, with B9 launched layers x microbatches x 2
   and B9's backward layers x microbatches (every layer), and the step's
   collectives counted against its layers and microbatches (the data
   group's all-gathers and reduce-scatters, the model group's
   all-reduces, in_proj's gathers and reduce-scatters, the vocab-parallel
   cross entropy's reduces); then the two steps timed local, 2-D, 2-D,
   local, with the peak memory of each and the bytes a rank holds
   (distinct storages) beside those param_specs would place at D = 8.
   Then dist_tp_forward: two threads of a ThreadWorld as the two model
   ranks of a 1x2 mesh, each on its own stream, compute the first batch's
   loss under no_grad in float32 (TF32 off) for llama3-8b (16 query and 4
   KV heads a rank, a 64128-row vocabulary slice, the vocab-parallel
   cross entropy) and falcon-mamba-7b (B9 on 4096 of 8192 channels a
   rank, launched once a layer a rank), DIST_TP_LAYERS layers at
   published widths, each held against a --mesh local float32 model's
   loss within DIST_TP_TOL, with the ms and peak memory of each.
   ``python3 chip_smoke.py --only dist_train`` runs the card and build
   lines and these two phases, and an ok line that carries "only":
   "dist_train".  Then dist_tp_serve, serving over the model axis
   (launch.serve --mesh DxM): --mesh 1x1 in a one-process NCCL group
   beside --mesh local, llama3-8b at its published widths with the serve
   phase's engine settings, its requests cut to 4 and its layers to 4,
   the tokens and one more decode step's logits bit for bit and B8
   launched once a layer and tick; then --mesh 1x2 on two threads (a
   ThreadWorld as the model group) beside --mesh local, float32 with TF32
   off, llama3-8b (4 layers) and mixtral-8x22b (2 layers) at published
   widths, 8 requests over 4 slots: both ranks emit the local tokens, a
   decode step's logits within DIST_TP_SERVE_TOL, B8's partial entry
   (each rank's 132 of the ring's 264 slots, merged over the model
   group) launched layers x ticks x 2, a rank's bytes about half, the
   step's ms a rank and local; the partial entry's kernel line on rank
   0's block with the merge's ms; and the bytes a rank would hold at 1x8
   of the published mixtral-8x22b and llama-3.2-vision-90b under the
   serve rule at this card's limit.  ``--only dist_tp_serve`` runs the
   card and build lines and this phase.  The
   train_twin phase holds reduced falcon-mamba-7b and hymba-1.5b too.  MFU counts 6 N tokens
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
In phases 5 to 15 and 18 (dist_main_path, dist_consumers' and
dist_per_batch's arms, dist_train and dist_tp_forward included) the kernel launch counters are zeroed just
before the path runs and read just after, and every kernel of the path
must have launched; in phases 5, 7 and 8 every launch of unpack_dest and
unpack_scatter_set must have gone through its plan table (the counts by C
entry point show it).  The kernel phase also holds decode_attention (one
decode step of phase 9: 8 lanes, a bf16 ring of 2080 slots; then, on a
line of its own beside SDPA, decode_32k's 32768-slot cache with the batch
cut to 8) and selective_scan (one falcon-mamba layer at L = 32768)
against their plain versions at 2e-4, each with the device time of every
kernel it launches (torch.profiler) and ptxas's registers and spills.

Then one line {"kernels": [...]} with all eleven kernels' numbers (the
nine TPU kernels', B9's backward, whose launches are the train phases',
and B8's partial entry, whose launches are dist_tp_serve's) and,
beside them, the four exchange kernels at phase 15's two shapes on derived
tables (launches: that phase's kernel-arm run), and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before the last
line; with no CUDA device, or outside a checkout of the repository, the
script exits non-zero at once.
"""
import collections
import contextlib
import dataclasses
import gc
import json
import math
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
# the bf16 payload's kernel line holds B9b against the plain version on
# the first steps only (the plain tree runs ~60 eager calls a chunk)
SSM_BF16_CHECK_L = 4096
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
# Per-batch patterns on the card's kernels (DynamicPattern exchanges over
# LoopbackComm(8), a new routing or graph every batch): (a) mixtral-8x22b's
# MoE dispatch and combine, 4096 tokens (8 lanes x one 512-token prefill
# chunk), 8 experts top-2, capacity moe_capacity(4096) = 1280, rows of
# d 6144 in bfloat16; (b) an edge softmax's denominators in GAT-style
# mini-batch training: a scalar float32 edge-to-node scatter-add (and the
# node-to-edge gather of a score) on a Zipf(1.1) graph of 2^19 nodes, 16
# neighbors each, resampled every batch
DYN_MOE_TOKENS = 4096
DYN_BATCHES = 4
DYN_GNN_N = 1 << 19
DYN_GNN_R = 16
DYN_RUNGS = ("condensed", "overlap")
DYN_KERNELS = ("pack_gather", "unpack_scatter_set", "accumulate_segments",
               "accumulate_into")
# launches of each a step: the pack, the unpack, the pack and own folds,
# the landed-foreign fold
DYN_STEP_LAUNCHES = {"pack_gather": 1, "unpack_scatter_set": 1,
                     "accumulate_segments": 2, "accumulate_into": 1}
# the plain versions of DYN_KERNELS, which no kernel-arm step may call
DYN_PLAIN = ("pack_gather_ref", "unpack_scatter_set_ref",
             "accumulate_segments_ref", "accumulate_into_ref")
# phase dist_per_batch's arm threads (two processes of four ranks played
# by threads, THREAD_WORLD x THREAD_P_LOCAL): the exchanges at these sizes,
# and a DynamicMoELayer and a GNN at small widths beside them
DPB_THREAD_TOKENS = 1024
DPB_THREAD_GNN_N = 1 << 16
# (capacity 80: moe_capacity's at capacity factor 1.25)
DPB_LAYER = dict(tokens=256, experts=8, top=2, capacity=80, d=64, f=128,
                 routings=2)
DPB_GNN = dict(n=1 << 12, r=8, d=16)
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
TRAIN_SSM_BF16_TIMED = 1       # the bf16 payload's step: one timed
TRAIN_HYBRID_ARGV = ["--arch", "hymba-1.5b", "--seq", "4096", "--batch",
                     "8", "--accum", "4", "--seed", str(SEED)]
TRAIN_HYBRID_TIMED = 2
# data parallelism through DistComm (a one-process NCCL group): the
# fewest layers that still run the scan kernels in more than one layer
DIST_TRAIN_LAYERS = 2
NCCL_INIT = pathlib.Path(__file__).resolve().parent / "build" / "nccl_init"
# the model axis's forward on the card: two threads as the model ranks of a
# 1x2 mesh, two layers of each arch at its published widths, a batch of 2
# x 2048 tokens, float32 activations (the train twins' settings)
DIST_TP_ARCHS = ("llama3-8b", "falcon-mamba-7b")
DIST_TP_LAYERS = 2
# the tp_local MoE split: mixtral-8x22b's 8 experts on a 1x16 model axis
# (16 threads, each all 8 experts on 1024 of their 16384 columns), one
# layer at its published widths, a batch of 2 x 512 tokens: each thread's
# ThreadComm all-reduce concatenates all 16 ranks' expert outputs, 1 GB
# a thread here (at 2 x 2048 tokens, 4 GB a thread: more than an 80 GB
# H100 holds beside the 16 ranks' weights)
DIST_TP_LOCAL = ("mixtral-8x22b", 1, 16)
DIST_TP_LOCAL_ARGV = ["--seq", "512", "--batch", "2", "--seed", str(SEED)]
DIST_TP_ARGV = ["--seq", "2048", "--batch", "2", "--seed", str(SEED)]
DIST_TP_TOL = 1e-4
# serving over the model axis: launch.serve --mesh 1x1 with the serve
# phase's engine settings, its 16 requests cut to 4 and llama3-8b's 32
# layers to 4; then 1x2 on two threads, float32, a few layers of each arch
# at its published widths, 8 requests over 4 slots (cache_len 264, whose
# ring the model axis splits into two blocks of 132 slots)
DIST_TP_SERVE_1X1 = ("llama3-8b", 4, ["--requests", "4"])
DIST_TP_SERVE_LAYERS = {"llama3-8b": 4, "mixtral-8x22b": 2}
DIST_TP_SERVE_ARGV = ["--requests", "8", "--slots", "4", "--prompt-len",
                      "256", "--gen", "8", "--seed", str(SEED)]
DIST_TP_SERVE_TOL = 1e-4
# the tp_local split served: mixtral-8x22b, one layer at its published
# widths, on a 1x16 model axis of 16 threads; 4 requests of 28-token
# prompts and 4 new tokens over 4 slots (ring 32: 2 slots a rank)
DIST_TP_LOCAL_SERVE = ("mixtral-8x22b", 1, 16)
DIST_TP_LOCAL_SERVE_ARGV = ["--requests", "4", "--slots", "4", "--prompt-len",
                            "28", "--gen", "4", "--seed", str(SEED)]
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
    # B8's partial entry (the model axis's flash-decoding): the same TPU
    # kernel, on a rank's block of the ring
    "decode_attention_partial": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:95"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:71"),
    # the reference differentiates its chunked associative scan with
    # jax.grad: no Pallas kernel, the backward of the scan at ssm.py:67
    "selective_scan_bwd": (
        "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
        "src/repro/models/ssm.py:67"),
    # the bf16 payload's chunk tree (jnp, no Pallas kernel) and its
    # jax.grad
    "selective_scan_bf16": (
        "src/repro_torch/kernels/csrc/selective_scan_bf16.cu",
        "src/repro/models/ssm.py:50"),
    "selective_scan_bf16_bwd": (
        "src/repro_torch/kernels/csrc/selective_scan_bf16.cu",
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


# traces profile_steps takes while the profiler drops its marker kernel
PROFILE_TRIES = 4


def profile_steps(torch, step, steps: int = 3, lead: int = 2,
                  top: int = 6, per_call: int = 1) -> dict:
    """torch.profiler's device activities (kernels, memsets, copies) over
    ``steps`` back-to-back steps: their time per step, by kernel, and the
    device's busy share — the union of their intervals over the span from
    the end of a marker kernel (``torch.cuda._sleep``, enqueued after
    ``lead`` steps, so the queue holds what the host keeps ahead) to the
    end of the last activity.  Kernels side by side count once, so the
    share is at most 1; its complement is the time the device waited.
    ``per_call`` is the number of steps one call of ``step`` runs.

    The profiler now and then drops events, the marker among them: a trace
    without it is taken again, up to PROFILE_TRIES traces
    (``marker_dropped`` counts those that lacked it).  If none kept it,
    the last trace's activities over all its ``lead + steps`` steps give
    the time per step and by kernel, and the busy share and the span,
    which need the marker, are not measured (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dropped = 0
    for _ in range(PROFILE_TRIES):
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
        dropped += 1
    if len(marks) == 1:
        opened, counted = marks[0], steps
    else:
        opened, counted = float("-inf"), lead + steps
    acts = [(max(start, opened), end, name) for start, end, name in acts
            if end > opened and "spin_kernel" not in name]
    check(acts, "the profiler saw no device time")
    by_name = {}
    for start, end, name in acts:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    rows = sorted(by_name.items(), key=lambda r: -r[1])
    per = counted * per_call * 1e3
    out = {"kernel_ms_per_step": sum(by_name.values()) / per,
           "busy_share": None, "profiled_span_ms_per_step": None,
           "top_kernels_ms_per_step": [[k[:60], t / per]
                                       for k, t in rows[:top]],
           "marker_dropped": dropped}
    if len(marks) == 1:
        span = max(end for _, end, _ in acts) - opened
        out.update(busy_share=busy_us((a, b) for a, b, _ in acts) / span,
                   profiled_span_ms_per_step=span / per)
    return out


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


@contextlib.contextmanager
def nccl_group(torch):
    """A one-process NCCL group (world 1, file:// init under build/) on
    card 0 for the duration of the block."""
    import torch.distributed as dist
    NCCL_INIT.parent.mkdir(parents=True, exist_ok=True)
    NCCL_INIT.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{NCCL_INIT}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        NCCL_INIT.unlink(missing_ok=True)


def phase_dist_main_path(torch, matrix, base, engines, x_host, card):
    """The main path's eight engines over a DistComm holding all P ranks
    in the one process of an NCCL group: y bit for bit the loopback
    engine's on the same x, the forward kernels launched as there; ms a
    step beside the loopback engine's, timed after.  Counters zeroed
    before the dist engines run and read after; returns the counts."""
    from repro_torch.comm.communicator import DistComm
    from repro_torch.core.spmv import DistributedSpMV
    from repro_torch.kernels import ops as kops

    want = {}
    for key, eng in engines.items():
        want[key] = eng(eng.shard_vector(x_host))
    torch.cuda.synchronize()
    lines = {}
    with nccl_group(torch):
        comm = DistComm(P)
        check((comm.p, comm.p_local, comm.world, comm.device.type)
              == (P, P, 1, "cuda"), f"DistComm {vars(comm)}")
        kops.reset_launch_counts()
        for (strategy, mat), loop in engines.items():
            t0 = time.perf_counter()
            eng = DistributedSpMV(matrix, comm, strategy=strategy,
                                  materialize=mat, use_kernel=True,
                                  shards_per_node=SHARDS_PER_NODE,
                                  base_plan=base)
            build_s = time.perf_counter() - t0
            before = kops.launch_counts()
            x = eng.shard_vector(x_host)
            y = eng(x)
            torch.cuda.synchronize()
            after = kops.launch_counts()
            step = {k: after[k] - before[k] for k in after}
            check(torch.equal(y, want[(strategy, mat)]),
                  f"dist {strategy}/{mat}: y is not the LoopbackComm "
                  "engine's bit for bit")
            for k in EXPECTED[(strategy, mat)]:
                check(step[k] > 0, f"dist {strategy}/{mat} never launched "
                      f"{k}")
            lines[(strategy, mat)] = {
                "engine_s": round(build_s, 3), "launches_per_step": step,
                **time_steps(torch, lambda: eng(x))}
            del eng, x, y
        counts = kops.launch_counts()
    for k in FORWARD_KERNELS:
        check(counts[k] > 0, f"dist_main_path never launched {k}")
    for (strategy, mat), line in lines.items():
        loop = engines[(strategy, mat)]
        x = loop.shard_vector(x_host)
        twin = time_steps(torch, lambda: loop(x))
        emit({"phase": "dist_main_path", "strategy": strategy,
              "materialize": mat, "use_kernel": True,
              "comm": "DistComm, one process of an NCCL group (world 1), "
                      f"p_local {P}",
              "y_bit_for_bit_loopback": True, **line,
              "loopback_ms_per_iter": twin["ms_per_iter"],
              "loopback_wall_ms_per_iter": twin["wall_ms_per_iter"],
              "dist_minus_loopback_ms": line["ms_per_iter"]
              - twin["ms_per_iter"], "card": card})
    return counts


T_EXPECTED = {  # kernels each transposed rung launches with use_kernel
    "replicate": ("accumulate_segments",),
    "blockwise": ("accumulate_segments",),
    "condensed": PUSH_KERNELS,
    "overlap": PUSH_KERNELS,
}


def phase_transposed(torch, t_engines, x_host, y_t_ref, card, twins):
    """Every rung of the transposed product, counters zeroed before and
    read after; returns the launch counts and each engine's (timing,
    profile).  Each rung's y (and the DIST_TIMED rungs' steps) go into
    ``twins`` for ``dist_consumers``."""
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
        twins[("transposed", strategy)] = {
            "out": y, "step": (lambda e=eng, x=x: e(x))
            if strategy in DIST_TIMED else None}
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


def phase_heat2d(torch, comm, hw, card, twins):
    """Every rung x {dest, full} of Heat2D on one shared stencil pattern
    and base plan (the plan cache's), counters zeroed before and read
    after; then the auto engine (dest).  Returns the launch counts, the
    model rows and ``dist_consumers``' Heat2D inputs; each rung's field
    (and the DIST_TIMED rungs' runs) go into ``twins``."""
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
        twins[("heat2d", strategy, mat)] = {
            "out": want, "step": (lambda h=h, phi=phi: h.run(
                phi, HEAT_CHECK_STEPS)) if strategy in DIST_TIMED else None}
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
    return counts, rows, {"n": HEAT_N, "pattern": pattern, "base": base,
                          "field": field}


NE_EXPECTED = {  # kernels each normal-equations rung launches
    "replicate": ("unpack_dest", "accumulate_segments"),
    "blockwise": ("pack_gather", "unpack_dest", "accumulate_segments"),
    "condensed": ("pack_gather", "unpack_dest") + PUSH_KERNELS,
    "overlap": ("pack_gather", "unpack_dest") + PUSH_KERNELS,
}


def phase_normal_equations(torch, comm, matrix, base, splan, x_host, b,
                           hw, card, twins):
    """normal_equations_step on every rung and CG on the condensed rung,
    on the SpMV phases' plans, counters zeroed before and read after.
    Returns the model rows (the steps' predicted_window, CG's
    predicted_loop) and the plans, keyed as ``plans=``.  Each rung's z and
    CG's carries after CG_DIST_ITERS iterations (and the DIST_TIMED steps)
    go into ``twins``."""
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
        twins[("normal_equations", strategy)] = {
            "out": z, "step": (lambda s=step, x=x: s(x))
            if strategy in DIST_TIMED else None}
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
    dist_step = (lambda cg=cgs[True], c=carries: torch.stack(
        cg.schedule(*c, n_steps=CG_DIST_ITERS), dim=1))
    twins[("cg", "condensed")] = {"out": dist_step(), "step": dist_step}
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
    return rows, plans


# --------------------------------------------------------------------------
# dist_consumers: the push direction, the normal equations, CG and Heat2D
# over a DistComm, and over two processes played by threads
# --------------------------------------------------------------------------

CG_DIST_ITERS = 5
# the cases timed beside their loopback twins
DIST_TIMED = ("condensed", "overlap")
# the two-thread arm: two processes of four ranks on the one card, its
# SpMV matrix and Heat2D field cut so that both threads' engines and the
# loopback reference build in seconds (the generator's other settings the
# main path's: B5's hot edge columns still fold as long rows)
THREAD_WORLD, THREAD_P_LOCAL = 2, 4
THREAD_N = 1 << 18
THREAD_HEAT_N = 1024
THREAD_TIMEOUT_S = 300.0
DIST_KERNELS = ("pack_gather", "unpack_scatter_set", "unpack_dest",
                "accumulate_segments", "accumulate_into", "stencil2d")


class ThreadWork:
    """A ``ThreadComm`` collective issued with ``async_op=True``: the
    threads meet at ``wait()``, not at the issue, so what the caller runs
    between the two runs while the exchange is in flight, and a send
    buffer written in that span is what the other thread reads."""

    def __init__(self, meet):
        self._meet, self._out = meet, None

    def wait(self):
        if self._meet is not None:
            self._out, self._meet = self._meet(), None
        return self._out


class ThreadComm:
    """One process of a ``ThreadWorld``, with ``DistComm``'s surface:
    ``kind``, ``world``, ``rank``, ``p``, ``p_local``, ``rank_offset``,
    ``local_rows``, ``device`` and the three collectives, each split into
    its issue and its ``wait()`` under ``async_op`` (``ThreadWork``).  The
    payloads meet through the world's shared list; ``all_reduce`` folds the
    ``p`` ranks in ascending order (``communicator._fold``), as
    ``DistComm`` and ``LoopbackComm`` do."""

    kind = "dist"

    def __init__(self, tw, rank: int):
        self._tw = tw
        self.world, self.rank = tw.world, rank
        self.p_local = tw.p_local
        self.p = tw.world * tw.p_local
        self.rank_offset = rank * tw.p_local
        self.device = tw.device

    @property
    def local_rows(self) -> slice:
        return slice(self.rank_offset, self.rank_offset + self.p_local)

    def _meet(self, t, read):
        """Publish ``t`` once this thread's stream has finished it, meet
        the other threads, run ``read`` on every thread's tensor in rank
        order on this thread's stream, and meet again once that stream has
        finished reading: no thread frees a tensor another still reads."""
        tw = self._tw
        assert t.shape[0] == self.p_local and t.device == self.device
        tw.sync()
        tw.posted[self.rank] = t
        tw.barrier.wait()
        out = read(list(tw.posted))
        tw.sync()
        tw.barrier.wait()
        return out

    def _collective(self, t, read, async_op: bool):
        from repro_torch.comm.communicator import Work
        t = t.contiguous()
        if async_op:
            return ThreadWork(lambda: self._meet(t, read))
        return Work(self._meet(t, read))

    def all_to_all(self, buf, *, async_op: bool = False):
        """``(p_local, P_dst, s, ...)`` -> ``(p_local, P_src, s, ...)``."""
        torch, rows = self._tw.torch, self.local_rows
        return self._collective(buf, lambda ts: torch.cat(
            [t[:, rows] for t in ts]).transpose(0, 1).contiguous(), async_op)

    def all_gather(self, x, *, async_op: bool = False):
        """``(p_local, shard, ...)`` -> ``(p_local, P * shard, ...)``."""
        torch, pl = self._tw.torch, self.p_local

        def spread(ts):
            flat = torch.cat(ts).reshape((1, -1) + tuple(x.shape[2:]))
            return flat.expand((pl,) + tuple(flat.shape[1:])).contiguous()

        return self._collective(x, spread, async_op)

    def all_reduce(self, x, op: str = "sum", *, async_op: bool = False):
        """``(p_local, ...)`` -> ``(p_local, ...)``: the ranks folded in
        ascending order."""
        from repro_torch.comm.communicator import _fold
        torch = self._tw.torch
        assert op in ("sum", "max"), op
        return self._collective(x, lambda ts: _fold(
            torch.cat(ts), op).expand(x.shape).contiguous(), async_op)


class ThreadWorld:
    """``world`` processes of ``p_local`` ranks each, played by threads on
    one device: what the smoke's one card can show of a ``DistComm`` whose
    processes hold only some of the ranks (a nonzero ``rank_offset``).
    Each thread runs on a CUDA stream of its own, as a process runs on its
    own default stream.  The threads meet at a ``threading.Barrier`` with
    a timeout; a thread that raises breaks the barrier, so the other
    stops too and the phase fails rather than hangs."""

    def __init__(self, torch, world: int, p_local: int, device,
                 timeout: float = THREAD_TIMEOUT_S):
        self.torch, self.device = torch, device
        self.world, self.p_local, self.timeout = world, p_local, timeout
        self.barrier, self.posted = None, None

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.current_stream(self.device).synchronize()

    def run(self, fn) -> list:
        """``fn(comm)`` in every thread, each with its ``ThreadComm``;
        returns the results in rank order."""
        import threading
        import traceback
        torch = self.torch
        self.barrier = threading.Barrier(self.world, timeout=self.timeout)
        self.posted = [None] * self.world
        results, errors = [None] * self.world, {}

        def body(rank):
            try:
                stream = (torch.cuda.Stream(device=self.device)
                          if self.device.type == "cuda" else None)
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    results[rank] = fn(ThreadComm(self, rank))
                    self.sync()
            except BaseException as e:
                errors[rank] = (isinstance(e, threading.BrokenBarrierError),
                                traceback.format_exc())
                self.barrier.abort()
                raise

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout)
        check(not any(t.is_alive() for t in threads),
              f"a ThreadWorld thread is still running after {self.timeout} s")
        if errors:
            # the thread that failed first, not one the broken barrier stopped
            rank = min(errors, key=lambda r: errors[r][0])
            fail(f"ThreadWorld rank {rank} failed:\n{errors[rank][1][-3000:]}")
        return results


DIST_EXPECTED = {("transposed", s): T_EXPECTED[s] for s in STRATEGIES}
DIST_EXPECTED.update({("normal_equations", s): NE_EXPECTED[s]
                      for s in STRATEGIES})
DIST_EXPECTED[("cg", "condensed")] = NE_EXPECTED["condensed"]
DIST_EXPECTED.update({("heat2d", s, m): H_EXPECTED[(s, m)]
                      for s in STRATEGIES for m in ("dest", "full")})


def drive_consumers(torch, comm, spmv, heat, per_case=None) -> dict:
    """Every case of ``dist_consumers`` on ``comm``, with ``use_kernel=True``
    and in one fixed order (every process calls the collectives alike):
    the transposed product and ``normal_equations_step`` on every rung,
    ``CG_DIST_ITERS`` CG iterations on the condensed rung, Heat2D on every
    rung x {dest, full} for ``HEAT_CHECK_STEPS`` steps.  ``spmv`` holds
    the matrix, x, b, the plans (the base plan and its ScatterPlan, also
    keyed as ``Schedule.resolve``'s ``plans=``) and whether the plan cache
    serves the Destination deltas; ``heat`` the field, its side, its
    stencil pattern and base plan.  Returns each case's output on
    ``comm``'s rows by key (CG's x, r and p stacked on dim 1; Heat2D's
    tiles, and under ``("field", rung, mat)`` its gathered global field).
    After each case's first run ``per_case(key, got, step, per, build_s,
    launched)`` gets its output (Heat2D's: the field), its step (``per``
    steps a call) and the kernel launches of that run."""
    from repro_torch.core.heat2d import Heat2D
    from repro_torch.core.solvers import ConjugateGradient
    from repro_torch.core.spmv import DistributedSpMV, normal_equations_step
    from repro_torch.kernels import ops as kops

    m, x_host = spmv["matrix"], spmv["x"]
    kw = dict(shards_per_node=SHARDS_PER_NODE, use_kernel=True)
    sched_kw = dict(kw, blocksize=BLOCKSIZE, use_plan_cache=spmv["cache"])
    out = {}

    def case(key, build, per=1):
        t0 = time.perf_counter()
        step, field = build()
        build_s = time.perf_counter() - t0
        before = kops.launch_counts()
        got = out[key] = step()
        if comm.device.type == "cuda":
            torch.cuda.current_stream(comm.device).synchronize()
        after = kops.launch_counts()
        if field is not None:
            got = out[("field",) + key[1:]] = field(out[key])
        if per_case is not None:
            per_case(key, got, step, per, build_s,
                     {k: after[k] - before[k] for k in after})

    def transposed(s):
        eng = DistributedSpMV(m, comm, strategy=s, transpose=True,
                              base_plan=spmv["base"],
                              scatter_plan=spmv["splan"], **kw)
        x = eng.shard_vector(x_host)
        return (lambda: eng(x)), None

    def normal(s):
        step = normal_equations_step(m, comm, strategy=s,
                                     plans=dict(spmv["plans"]), **sched_kw)
        x = step.shard_vector(x_host)
        return (lambda: step(x)), None

    def cg():
        solver = ConjugateGradient(m, comm, strategy="condensed",
                                   plans=dict(spmv["plans"]), **sched_kw)
        carries = solver.carries(spmv["b"])
        return (lambda: torch.stack(solver.schedule(
            *carries, n_steps=CG_DIST_ITERS), dim=1)), None

    def heat2d(s, mat):
        h = Heat2D(comm, heat["n"], heat["n"], mprocs=MPROCS, nprocs=NPROCS,
                   coef=HEAT_COEF, strategy=s, materialize=mat,
                   pattern=heat["pattern"], base_plan=heat["base"],
                   use_plan_cache=False, **kw)
        phi = h.shard_field(heat["field"])
        return (lambda: h.run(phi, HEAT_CHECK_STEPS)), h.gather_field

    for s in STRATEGIES:
        case(("transposed", s), lambda: transposed(s))
    for s in STRATEGIES:
        case(("normal_equations", s), lambda: normal(s))
    case(("cg", "condensed"), cg, per=CG_DIST_ITERS)
    for s in STRATEGIES:
        for mat in ("dest", "full"):
            case(("heat2d", s, mat), lambda: heat2d(s, mat),
                 per=HEAT_CHECK_STEPS)
    return out


def thread_inputs():
    """The two-thread arm's SpMV and Heat2D inputs (``drive_consumers``'s
    ``spmv`` and ``heat``): the main path's generators at THREAD_N and
    THREAD_HEAT_N², their plans built here once and each Destination
    delta by its engine (no plan cache between threads)."""
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.plan import Topology, build_comm_plan
    from repro_torch.comm.schedule import plan_key
    from repro_torch.core.matrix import make_mesh_like_matrix

    topo = Topology(P, SHARDS_PER_NODE)
    m = make_mesh_like_matrix(THREAD_N, R_NZ, locality_window=THREAD_N // 64,
                              long_range_frac=0.02, seed=SEED)
    rng = np.random.default_rng(SEED)
    base = build_comm_plan(m.cols, THREAD_N, P, blocksize=BLOCKSIZE,
                           topology=topo)
    splan = base.transpose()
    key = plan_key(AccessPattern.from_ellpack(m), P, BLOCKSIZE, topo)
    spmv = {"matrix": m,
            "x": rng.standard_normal(THREAD_N).astype(np.float32),
            "b": rng.standard_normal(THREAD_N).astype(np.float32),
            "base": base, "splan": splan,
            "plans": {key: base, ("put", key): splan}, "cache": False}
    pattern = AccessPattern.from_stencil5(THREAD_HEAT_N, THREAD_HEAT_N,
                                          MPROCS, NPROCS)
    heat = {"n": THREAD_HEAT_N, "pattern": pattern,
            "base": build_comm_plan(pattern.indices, pattern.n, P,
                                    topology=topo),
            "field": rng.standard_normal(
                (THREAD_HEAT_N, THREAD_HEAT_N)).astype(np.float32)}
    return spmv, heat


def same_output(torch, got, want) -> bool:
    """Bit for bit: tensors as ``same_bits`` compares them, host arrays
    (the Heat2D fields) through their int32 views."""
    if isinstance(want, np.ndarray):
        return np.array_equal(np.asarray(got).view(np.int32),
                              want.view(np.int32))
    return same_bits(torch, got, want)


def phase_dist_consumers(torch, spmv, heat, twins, card):
    """Arm ``nccl``: every case of ``drive_consumers`` over a ``DistComm(P)``
    holding the P ranks in the one process of an NCCL group (world 1), at
    the main path's sizes on the earlier phases' plans: each output bit
    for bit its loopback twin's (``twins``, by key: the transposed,
    normal_equations and heat2d phases' outputs, Heat2D's field, and the
    DIST_TIMED rungs' steps), each case's kernels launched, the DIST_TIMED
    rungs' ms a step beside their twins' (the twins timed once the arm's
    counts are read: their launches are not the arm's).  Arm ``threads``:
    the same cases over a ``ThreadWorld`` of THREAD_WORLD processes of
    THREAD_P_LOCAL ranks at ``thread_inputs``' sizes, every output on the threads' rows, stacked, bit for bit the
    ``LoopbackComm(P)`` run's on the same inputs (each thread's Heat2D
    field the loopback field), and every kernel of the cases launched in
    the threads.  Counters zeroed before each arm's dist run and read
    after; returns both arms' counts summed."""
    from repro_torch.comm.communicator import DistComm, LoopbackComm
    from repro_torch.kernels import ops as kops

    t_start = time.perf_counter()
    lines = []

    def reps(per):
        return dict(warmup=1 if per > 1 else 5, iters=3 if per > 1 else 20)

    def per_case(key, got, step, per, build_s, launched):
        check(same_output(torch, got, twins[key]["out"]),
              f"dist_consumers nccl {key}: not the LoopbackComm engine's "
              "output bit for bit")
        for k in DIST_EXPECTED[key]:
            check(launched[k] > 0,
                  f"dist_consumers nccl {key} never launched {k}")
        line = {"consumer": key[0], "strategy": key[1],
                **({"materialize": key[2]} if len(key) == 3 else {}),
                "engine_s": round(build_s, 3),
                "launches_per_run": {k: v for k, v in launched.items() if v}}
        if key[1] in DIST_TIMED:
            # the dist step here; its loopback twin once the counts are read
            line.update({k.replace("_per_iter", "_per_step"): v / per
                         for k, v in time_steps(torch, step, **reps(per))
                         .items()})
        lines.append((key, per, line))

    with nccl_group(torch):
        comm = DistComm(P)
        check((comm.p, comm.p_local, comm.world, comm.device.type)
              == (P, P, 1, "cuda"), f"DistComm {vars(comm)}")
        kops.reset_launch_counts()
        drive_consumers(torch, comm, spmv, heat, per_case=per_case)
        counts = kops.launch_counts()
    nccl_s = time.perf_counter() - t_start
    for k in DIST_KERNELS:
        check(counts[k] > 0, f"dist_consumers nccl never launched {k}")
    for key, per, line in lines:
        if key[1] in DIST_TIMED:
            twin = time_steps(torch, twins[key]["step"], **reps(per))
            line["loopback_ms_per_step"] = twin["ms_per_iter"] / per
            line["loopback_host_enqueue_ms_per_step"] = twin[
                "host_enqueue_ms_per_iter"] / per
            line["dist_minus_loopback_ms"] = (line["ms_per_step"]
                                              - line["loopback_ms_per_step"])
        emit({"phase": "dist_consumers", "arm": "nccl",
              "comm": f"DistComm, one process of an NCCL group (world 1), "
                      f"p_local {P}", "bit_for_bit_loopback": True, **line,
              "card": card})
    twins.clear()

    # the two-thread arm: a process at rank_offset 4 on the card
    t0 = time.perf_counter()
    t_spmv, t_heat = thread_inputs()
    dev = comm.device
    want = drive_consumers(torch, LoopbackComm(P, device=dev), t_spmv,
                           t_heat)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    tw = ThreadWorld(torch, THREAD_WORLD, THREAD_P_LOCAL, dev)
    kops.reset_launch_counts()
    t1 = time.perf_counter()
    got = tw.run(lambda c: drive_consumers(torch, c, t_spmv, t_heat))
    threads_s = time.perf_counter() - t1
    t_counts = kops.launch_counts()
    for key, w in want.items():
        if key[0] == "field":
            for rank, res in enumerate(got):
                check(same_output(torch, res[key], w),
                      f"dist_consumers threads rank {rank} {key}: not the "
                      "loopback field bit for bit")
        else:
            stacked = torch.cat([res[key] for res in got])
            check(same_output(torch, stacked, w),
                  f"dist_consumers threads {key}: the ranks' rows are not "
                  "the LoopbackComm run's bit for bit")
    for k in DIST_KERNELS:
        check(t_counts[k] > 0, f"dist_consumers threads never launched {k}")
    emit({"phase": "dist_consumers", "arm": "threads",
          "world": THREAD_WORLD, "p_local": THREAD_P_LOCAL,
          "rank_offsets": [c * THREAD_P_LOCAL for c in range(THREAD_WORLD)],
          "n": THREAD_N, "heat_n": THREAD_HEAT_N,
          "cases": sorted("/".join(k) for k in want if k[0] != "field"),
          "bit_for_bit_loopback": True,
          "launches": {k: v for k, v in t_counts.items() if v},
          "loopback_s": round(ref_s, 3), "threads_s": round(threads_s, 3),
          "card": card})
    emit({"phase": "dist_consumers_summary",
          "nccl_s": round(nccl_s, 3),
          "threads_s": round(time.perf_counter() - t0, 3),
          "wall_s": round(time.perf_counter() - t_start, 3),
          "nccl_launches": {k: counts[k] for k in DIST_KERNELS},
          "threads_launches": {k: t_counts[k] for k in DIST_KERNELS}})
    return {k: counts[k] + t_counts[k] for k in DIST_KERNELS}


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


def tree_combines(c: int):
    """(up-sweep, down-sweep) combines of jax's associative scan over a
    chunk of ``c`` steps: one merge for each trailing zero of t + 1, one
    final combine where t + 1 is not a power of two."""
    return c - bin(c).count("1"), c - c.bit_length()


def scan_bf16_bound(b: int, l: int, di: int, st: int, c: int,
                    ckpt: bool = False):
    """(bound_ms, bound_by) and the tree's combines of B9b: x, dt read and
    y written (float32), B, C and a read once, and where ``ckpt`` the
    chunks' entering states written (float32); per (step, channel, state)
    dt·a, the exponential, the product with B and y's multiply-add (5
    float32 operations), a chunk's up-sweep combines 4 (three products
    and an add), its down-sweep ones 2, its fold 2."""
    up, down = tree_combines(c)
    lanes, nch = b * di * st, l // c
    flops = lanes * (5.0 * l + nch * (4 * up + 2 * down + 2))
    nbytes = 3 * b * l * di * 4 + 2 * b * l * st * 4 + di * st * 4
    if ckpt:
        nbytes += b * nch * di * st * 4
    return bound(nbytes, flops=flops), lanes * nch * (up + down)


def scan_bf16_line(torch, name, args, check_l=None, chunk=256,
                   held_out=None, ckpt=False):
    """B9b on one call's own inputs (``args`` = x, dt, B, C, a): the
    checkpointing entry against the plain bf16 scan on the first
    ``check_l`` steps (all by default; a whole number of chunks): the
    states entering the chunks bit for bit, y within 2e-4 of max |y|; the
    serving entry's y the checkpointing entry's bit for bit (whether y
    is the plain version's bit for bit is reported); ms of the
    serving entry at the call's L (of the checkpointing entry where
    ``ckpt``, with its bound: the entering states written too), the plain
    version's ms (once, at the checked length), the bound and the tree's
    combines;
    ``held_out`` (y, checkpoints) from a train step must equal the new
    launch's bits.  No single PyTorch call computes the scan."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import selective_scan as b9
    args = tuple(t.detach() for t in args)
    b, l, di = args[0].shape
    st = args[2].shape[2]
    c = kref.scan_chunk_len(l, chunk)
    lc = min(l, check_l or l)
    y, hck = b9.selective_scan_bf16_ckpt(*args, chunk=chunk)
    served = kops.selective_scan(*args, payload=torch.bfloat16, chunk=chunk)
    same = torch.equal(served, y) and (held_out is None or (
        torch.equal(held_out[0], y) and torch.equal(held_out[1], hck)))
    check(same, f"{name}: the serving entry's y, the checkpointing entry's "
          "and the train step's are not the same bits")
    short = tuple(t[:, :lc] if t.dim() == 3 else t for t in args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_y, want_h = kref.selective_scan_bf16_states_ref(*short, chunk=chunk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    states = torch.equal(hck[:, :lc // c], want_h)
    y_bits = torch.equal(y[:, :lc], want_y)
    err = float((y[:, :lc] - want_y).abs().max()) / max(
        float(want_y.abs().max()), 1e-30)
    check(states, f"{name}: the chunks' entering states differ from the "
          "plain version's")
    check(err <= 2e-4, f"{name}: y is {err} of max |y| from the plain "
          "version's")
    del y, hck, served, want_y, want_h
    bnd, combines = scan_bf16_bound(b, l, di, st, c, ckpt=ckpt)
    entry = b9.selective_scan_bf16_ckpt if ckpt else b9.selective_scan_bf16
    res = dict(max_abs_err=err, plain_ms=plain_ms, library_ms=None,
               ms=cuda_ms(torch, lambda: entry(*args, chunk=chunk),
                          warmup=1, iters=5),
               bound=bnd)
    emit({"phase": "kernel", "name": name, **{
        k_: v_ for k_, v_ in res.items() if k_ != "bound"},
        "bound_ms": bnd[0], "bound_by": bnd[1], "combines": combines,
        "entry": "checkpointing" if ckpt else "serving",
        "states_bit_identical": states, "y_bit_identical": y_bits,
        "serving_bit_identical": same,
        "checked_steps": lc, "max_abs_err_is": "of max |y|",
        "plain_ms_is": f"the plain version at {lc} steps",
        "shape": f"x/dt ({b}, {l}, {di}) f32, B/C ({b}, {l}, {st}), "
                 f"chunk {c}"})
    check_bound(name, res)
    return res


def scan_bf16_bwd_line(torch, name, args, dy, held=None, chunk=256):
    """B9b′ on one call's inputs (``args`` = x, dt, B, C, a; ``dy`` the
    cotangent; ``held`` = (checkpoints, gradients) where the call came from
    a train step, else B9b's checkpointing entry writes them): two more
    launches bit for bit (with the step's), every gradient within
    SCAN_BWD_TOL of its largest element against the plain backward (timed
    once), ms, and the bound of B9′'s kind (``scan_bwd_bound``, the
    chunks' entering states for its checkpoints)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import selective_scan as b9
    args = tuple(t.detach() for t in args)
    dy = dy.detach()
    b, l, di = args[0].shape
    st = args[2].shape[2]
    c = kref.scan_chunk_len(l, chunk)
    hck = held[0] if held else b9.selective_scan_bf16_ckpt(
        *args, chunk=chunk)[1]
    runs = [b9.selective_scan_bf16_bwd(*args, hck, dy, chunk=chunk)
            for _ in range(2)]
    ref_run = held[1] if held else runs[0]
    same = all(torch.equal(g, h) for run in runs
               for g, h in zip(run, ref_run))
    check(same, f"{name}: two launches on the same inputs differ in bits")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = kref.selective_scan_bf16_bwd_ref(*args, dy, chunk=chunk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rel = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
           for g, w in zip(runs[0], want)]
    check(max(rel) <= SCAN_BWD_TOL,
          f"{name} differs from the plain backward: {rel} of each "
          "gradient's largest element")
    del runs, want
    res = dict(max_abs_err=max(rel), plain_ms=plain_ms, library_ms=None,
               ms=cuda_ms(torch, lambda: b9.selective_scan_bf16_bwd(
                   *args, hck, dy, chunk=chunk), warmup=1, iters=3),
               bound=scan_bwd_bound(b, l, di, st, nseg=l // c))
    emit({"phase": "kernel", "name": name, **{
        k_: v_ for k_, v_ in res.items() if k_ != "bound"},
        "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
        "rel_err_by_grad": dict(zip(("dx", "ddt", "dB", "dC", "dA"), rel)),
        "bit_identical_repeat": same,
        "layout": {"threads": 128, "partials_bytes": 4 * 2 * b * l * st
                   * b9.bf16_bwd_partials(di, st),
                   "ends_bytes": 4 * math.prod(
                       b9.bf16_ends_shape(b, l, di, st, c))},
        "shape": f"x/dt/dy ({b}, {l}, {di}) f32, B/C ({b}, {l}, {st}), "
                 f"chunk {c}",
        "max_abs_err_is": "relative to each gradient's largest element"})
    check_bound(name, res)
    return res


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
    inputs at 2e-4 (a kernel line of its own, at d_inner 3200; and B9b on
    the same inputs, ``selective_scan_bf16_di3200``), the prefill
    timed."""
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
    scan_bf16_line(torch, "selective_scan_bf16_di3200", args)
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
    from repro_torch.serve import Request, ServeEngine
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

    def warm_up(eng):
        rng = np.random.default_rng(SEED + 1)
        for i in range(MOE_WARMUP["requests"]):
            eng.submit(Request(
                id=f"warm{i}", prompt=rng.integers(
                    0, cfg.vocab_size, (MOE_WARMUP["prompt_len"],)).tolist(),
                max_new_tokens=MOE_WARMUP["gen"], arrival_time=0.0))
        eng.run()

    t0 = time.perf_counter()
    warm_up(engine)
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

    # phase dist_per_batch's served tokens: the same warm-up and requests
    # on the same model and weights, the hook's DynamicMoELayer rebuilt
    # over DistComm(P) in a world-1 NCCL group
    t0 = time.perf_counter()
    with nccl_group(torch):
        from repro_torch.comm.communicator import DistComm
        dlayer = lserve.build_moe_layer(model, params, args.slots,
                                        DistComm(P))
        twin = ServeEngine(model, params, num_slots=args.slots,
                           cache_len=args.prompt_len + args.gen,
                           prefill_chunk=args.prefill_chunk,
                           moe_layer=dlayer, cache_dtype=engine.cache_dtype)
        warm_up(twin)
        d_ticks, d_tokens = len(twin._tick_seconds), len(twin._token_seconds)
        lserve.submit_trace(twin, cfg, args)
        drep = twin.run()
        torch.cuda.synchronize()
        dist_strategies = dlayer.strategies
        del dlayer, twin
    check(all(drep.outputs.get(i) == report.outputs[i] for i in ids),
          "dist_per_batch: the engine with its MoE hook over DistComm(8) "
          "did not emit the loopback engine's tokens")
    emit({"phase": "dist_per_batch", "arm": "nccl_serve", "arch": cfg.name,
          "layers": cfg.num_layers, "requests": args.requests,
          "comm": f"DistComm, one process of an NCCL group (world 1), "
                  f"p_local {P}", "strategies": dist_strategies,
          "tokens_equal_loopback": True,
          "decode_tokens_per_s": {
              "dist": len(drep.token_seconds[d_tokens:])
              / sum(drep.tick_seconds[d_ticks:]),
              "loopback": len(token_s) / sum(tick_s)},
          "wall_s": round(time.perf_counter() - t0, 3), "card": card})
    del drep

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


def same_bits(torch, got, want) -> bool:
    """Bit for bit (floats compared as their bits)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
        return torch.equal(got.view(bits), want.view(bits))
    return torch.equal(got, want)


def timed_once(torch, fn):
    """``(fn(), device ms of that one call)``, CUDA events around it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def plain_time(torch, fn):
    """``(fn(), its device ms)``: one call where it takes 20 ms or more (a
    plain bf16 fold takes up to a second), else ``cuda_ms``'s mean."""
    out, ms = timed_once(torch, fn)
    return out, (ms if ms >= 20.0 else cuda_ms(torch, fn))


def dyn_workloads(torch, dev, tokens=DYN_MOE_TOKENS, gnn_n=DYN_GNN_N):
    """The two per-batch workloads, DYN_BATCHES batches each made from the
    seed on the card (the first batch's pattern is the template), MoE at
    ``tokens`` tokens and the graph at ``gnn_n`` nodes:
    ``{name: dict(n, template (m, r) int32, cols [(m, r) int32 on dev], x
    [(P, n / P, ...)], vals [(P, m / P, r, ...)], shape)}``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.gnn import random_neighbors
    from repro_torch.models.moe import (moe_capacity, moe_dispatch_pattern,
                                        random_router)

    cfg = get_config("mixtral-8x22b")
    e, k, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    t = tokens
    cap = moe_capacity(t, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    moe, gnn = [], []
    for b in range(DYN_BATCHES):
        top_e, _ = random_router(SEED + 10 + b, t, e, k)
        idx, _ = moe_dispatch_pattern(top_e, t, e, cap, P)
        moe.append(torch.as_tensor(idx.reshape(-1, 1), device=dev))
        gnn.append(random_neighbors(gnn_n, DYN_GNN_R, alpha=GNN_ALPHA,
                                    seed=SEED + 20 + b, device=dev))
    out = {
        "moe": dict(n=t, cols=moe, x=[torch.randn(
            (P, t // P, d), generator=gen, device=dev,
            dtype=torch.bfloat16) for _ in moe], vals=[torch.randn(
                (P, c.shape[0] // P, 1, d), generator=gen, device=dev,
                dtype=torch.bfloat16) for c in moe],
            shape=f"{cfg.name}: {t} tokens, {e} experts top-{k}, capacity "
                  f"{cap} ({e * cap} slots), d {d} bf16"),
        # a node's score term gathered to its edges; exp of the edge
        # scores added into the target nodes (the softmax denominators)
        "gnn": dict(n=gnn_n, cols=gnn, x=[torch.randn(
            (P, gnn_n // P), generator=gen, device=dev) for _ in gnn],
            vals=[torch.randn((P, gnn_n // P, DYN_GNN_R), generator=gen,
                              device=dev).exp_() for _ in gnn],
            shape=f"{gnn_n} nodes, {DYN_GNN_R} Zipf({GNN_ALPHA}) "
                  f"neighbors, scalar float32"),
    }
    for w in out.values():
        w["template"] = w["cols"][0].cpu().numpy()
    return out


def dyn_kernel_lines(torch, name, w, g, s, dp):
    """B1, B2, B5 and B6 on one batch's derived tables (batch 1, the
    condensed kernel arm's own inputs), each against its plain version
    (B5/B6 in float32 on the CPU: the card's plain add sums in its own
    order), with its ms, the plain version's, a library call's and its
    bound: ``{kernel: result}``, B5's two sites summed."""
    from repro_torch.comm import dynamic as dyn
    from repro_torch.comm.strategies import own_offsets
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    comm, dev = g.comm, g.comm.device
    n, s_max, shard = w["n"], dp.s_max, w["n"] // P
    cols, x, vals = w["cols"][1], w["x"][1], w["vals"][1]
    tables = dyn.derive_gather_tables(cols, n, P, s_max)
    send, recv_idx, order = g.derive_plan_args(cols, gather_tables=tables)
    sargs = s.derive_plan_args(cols, gather_tables=tables)
    feat = tuple(x.shape[2:])
    rb = int(np.prod(feat, dtype=np.int64)) * x.element_size()
    dtype = str(x.dtype)[6:]
    send_flat, recv_gidx = send.reshape(P, -1), recv_idx.reshape(P, -1)
    m = send_flat.shape[1]
    lines = []

    buf = kops.pack_gather(x, send_flat)
    want, plain_ms = plain_time(torch, lambda: kref.pack_gather_ref(
        x, send_flat))
    check(same_bits(torch, buf, want),
          f"pack_gather ({name}, derived tables) differs from plain")
    gidx = (send_flat.long() + (torch.arange(P, device=dev) * shard)[:, None]
            ).reshape(-1)
    x_rows = x.reshape((-1,) + feat)
    lines.append(("pack_gather", dict(
        site="pack", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: kops.pack_gather(x, send_flat)),
        plain_ms=plain_ms,
        library_ms=cuda_ms(torch, lambda: torch.index_select(x_rows, 0,
                                                             gidx)),
        # the index array read, every lane written (the padded messages
        # too), each distinct row read once
        bound=bound(P * m * (4 + rb) + unique_rows(torch, send_flat) * rb),
        shape=f"x {tuple(x.shape)} {dtype}, idx ({P}, {m}) int32")))

    recv = comm.all_to_all(buf.reshape((P, P, s_max) + feat)).wait()
    recv = recv.reshape((P, -1) + feat)
    offsets = own_offsets(P, shard, dev)
    tiles = order.table(out_len=n + 1, row_bytes=rb)

    def b2(fn, **kw):
        return fn(recv, recv_gidx, x, offsets, out_len=n + 1, **kw)
    want, plain_ms = plain_time(torch, lambda: b2(
        kref.unpack_scatter_set_ref))
    check(same_bits(torch, b2(kops.unpack_scatter_set, table=tiles)[:, :n],
                    want[:, :n]),
          f"unpack_scatter_set ({name}, derived tables) differs from plain")
    kept = int(tiles.tile_ptr[:, -1].sum())
    lines.append(("unpack_scatter_set", dict(
        site="unpack", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: b2(kops.unpack_scatter_set, table=tiles)),
        plain_ms=plain_ms, library_ms=None,
        # as B3's line: the table it reads (a target and a position for
        # each landed row it keeps, the tile bounds) in place of the
        # padded index array, those rows, the own rows and the output
        bound=bound(kept * (8 + rb) + tiles.tile_ptr.numel() * 4
                    + P * shard * rb + P * (n + 1) * rb),
        kept_rows=kept,
        shape=f"recv {tuple(recv.shape)} -> x_copy ({P}, {n + 1}"
              f"{''.join(', ' + str(f) for f in feat)}) {dtype}")))

    lanes = vals.reshape((P, -1) + tuple(vals.shape[3:]))
    msg, unpack, own = (a.reshape(P, -1) for a in sargs[:3])
    seg = sargs[5]
    pack_out = kops.accumulate_segments(lanes, msg, out_len=P * s_max + 1,
                                        table=seg["pack"])
    landed = comm.all_to_all(pack_out[:, :P * s_max].reshape(
        (P, P, s_max) + tuple(lanes.shape[2:]))).wait()
    landed = landed.reshape((P, -1) + tuple(lanes.shape[2:]))
    own_out = kops.accumulate_segments(lanes, own, out_len=shard + 1,
                                       table=seg["own"])
    on_cpu = vals.dtype == torch.float32
    sites = (("pack", None, lanes, msg, seg["pack"], P * s_max + 1),
             ("own", None, lanes, own, seg["own"], shard + 1),
             ("into", own_out, landed, unpack, seg["into"], shard + 1))
    for site, init, src, idx, table, out_len in sites:
        live = table.live_len
        if init is None:
            def kernel():
                return kops.accumulate_segments(src, idx, out_len=out_len,
                                                table=table)

            def plain(init, src, idx):
                return kref.accumulate_segments_ref(src, idx,
                                                    out_len=out_len)
        else:
            def kernel():
                return kops.accumulate_into(init, src, idx, table=table)

            def plain(init, src, idx):
                return kref.accumulate_into_ref(init, src, idx)
        args = (init, src, idx)
        want, plain_ms = plain_time(torch, lambda: plain(*args))
        if on_cpu:
            want = plain(*(None if a is None else a.cpu() for a in args))
        check(same_bits(torch, kernel()[:, :live].cpu(),
                        want[:, :live].cpu()),
              f"{site} fold ({name}, derived tables) differs from its plain "
              "version")
        f = tuple(src.shape[2:])
        rows = (idx.long() + (torch.arange(P, device=dev) * out_len)[:, None]
                ).reshape(-1)
        flat_src = src.reshape((-1,) + f)
        acc = (init.clone() if init is not None else torch.zeros(
            (P, out_len) + f, dtype=src.dtype, device=dev)).reshape(
            (-1,) + f)
        site_bound, folded = push_bound(table, src, init)
        lines.append(("accumulate_segments" if init is None
                      else "accumulate_into", dict(
                          site=site, max_abs_err=0.0,
                          ms=cuda_ms(torch, kernel), plain_ms=plain_ms,
                          library_ms=cuda_ms(torch, lambda: acc.index_add_(
                              0, rows, flat_src)),
                          bound=site_bound, folded_lanes=folded,
                          live_counts=table.live_counts.tolist(),
                          shape=f"vals ({P}, {idx.shape[1]}"
                                f"{''.join(', ' + str(v) for v in f)}) "
                                f"{dtype} -> ({P}, {out_len}), live {live}")))
    per = {}
    for kernel, res in lines:
        emit({"phase": "kernel", "name": f"{kernel}_dyn_{name}", **{
            k: v for k, v in res.items() if k != "bound"},
            "bound_ms": res["bound"][0], "bound_by": res["bound"][1]})
        check_bound(f"{kernel} ({name}, {res['site']})", res)
        per.setdefault(kernel, []).append(res)
    return {k: dict(kernel=k, max_abs_err=0.0,
                    ms=sum(r["ms"] for r in rs),
                    plain_ms=sum(r["plain_ms"] for r in rs),
                    library_ms=(None if rs[0]["library_ms"] is None else
                                sum(r["library_ms"] for r in rs)),
                    bound=(sum(r["bound"][0] for r in rs), "bytes"))
            for k, rs in per.items()}


def phase_dynamic_exchange(torch, card):
    """Per-batch patterns through the card's kernels: each workload of
    dyn_workloads over LoopbackComm(8) on the condensed and overlap rungs,
    with use_kernel=True and use_kernel=False on the same batches.  Every
    kernel-arm batch after the first derives, gathers and scatters under
    torch.cuda.set_sync_debug_mode("error"); its outputs equal the plain
    arm's bit for bit (the gather's n rows; a float32 scatter against the
    plain arm run on the CPU from the same tables, whose add runs in lane
    order); B1, B2, B5 and B6 launch every step and no plain version runs.
    Then ms a step of both arms (the plain arm's from its checked steps,
    one call each), its pieces, the busy share and the kernel lines on one
    batch's derived tables.  Returns (kernel results, launches) keyed
    ``<kernel>_dyn_<workload>``, and the twins phase dist_per_batch holds
    its DistComm runs against: by workload its data, DynamicPattern,
    envelope plan, kernel-arm exchanges by rung and their outputs by
    (rung, batch)."""
    import itertools

    from repro_torch.comm import dynamic as dyn
    from repro_torch.comm import plan_cache
    from repro_torch.comm import strategies as strat
    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.plan import Topology
    from repro_torch.comm.scatter import IrregularScatter
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    comm = LoopbackComm(P)
    dev = comm.device
    t0 = time.perf_counter()
    workloads = dyn_workloads(torch, dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    results, counts, twins = {}, {}, {}
    for name, w in workloads.items():
        wall = {"start": time.perf_counter()}
        n = w["n"]
        dp = dyn.DynamicPattern.from_template(
            AccessPattern.from_indices(w["template"], n=n), P)
        # one envelope plan serves the four exchanges of each direction
        base = plan_cache.get_envelope_plan(
            w["template"], n, P, topology=Topology(P, P), s_max=dp.s_max,
            cache=False)
        arms = {(rung, kernel): (
            IrregularGather(dp, comm, strategy=rung, use_kernel=kernel,
                            base_plan=base),
            IrregularScatter(dp, comm, strategy=rung, reduce="add",
                             use_kernel=kernel, base_plan=base))
            for rung in DYN_RUNGS for kernel in (True, False)}
        float32 = w["vals"][0].dtype == torch.float32
        # a float32 scatter's plain arm on the CPU, on the card's tables
        cpu_fold = strat.make_scatter_start_local(
            arms[("condensed", False)][1].splan, "condensed",
            LoopbackComm(P, device="cpu"), "add") if float32 else None
        torch.cuda.synchronize()
        wall["build"] = time.perf_counter()

        def derive(rung, kernel, b):
            g, s = arms[(rung, kernel)]
            cols = w["cols"][b]
            tables = dyn.derive_gather_tables(cols, n, P, dp.s_max)
            return (g.derive_plan_args(cols, gather_tables=tables),
                    s.derive_plan_args(cols, gather_tables=tables))

        def exchange(rung, kernel, b, gargs, sargs):
            g, s = arms[(rung, kernel)]
            x, vals = w["x"][b], w["vals"][b]
            if rung == "overlap":
                hg = g.start_local(x, *gargs)
                hs = s.start_local(vals, *sargs)
                return hg.finish(), hs.finish()
            return g.local(x, *gargs), s.local(vals, *sargs)

        def step(rung, kernel, b):
            return exchange(rung, kernel, b, *derive(rung, kernel, b))

        def plain_step(rung, b):
            gargs, sargs = derive(rung, False, b)
            return exchange(rung, False, b, gargs, sargs), sargs

        # the path: the kernel arm, every batch, counters zeroed before
        kops.reset_launch_counts()
        outs = {}
        with contextlib.ExitStack() as stack:
            plain_calls = [stack.enter_context(held_calls(kref, f))
                           for f in DYN_PLAIN]
            for rung in DYN_RUNGS:
                for b in range(DYN_BATCHES):
                    torch.cuda.synchronize()
                    if b:
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        x_copy, y = step(rung, True, b)
                    except RuntimeError as exc:
                        fail(f"dynamic_exchange {name} {rung} batch {b}: "
                             f"{exc}")
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    outs[(rung, b)] = (x_copy[:, :n], y)
        torch.cuda.synchronize()
        wall["path"] = time.perf_counter()
        launched, entries = kops.launch_counts(), kops.entry_counts()
        steps = len(DYN_RUNGS) * DYN_BATCHES
        want_counts = {k: DYN_STEP_LAUNCHES.get(k, 0) * steps
                       for k in launched}
        check(launched == want_counts,
              f"dynamic_exchange {name}: launches {launched}, expected "
              f"{want_counts}")
        check(entries.get("rt_unpack_scatter_tiles") == steps
              and "rt_unpack_scatter_set" not in entries,
              f"dynamic_exchange {name}: B2 ran {entries}")
        check(all(h.calls == 0 for h in plain_calls),
              f"dynamic_exchange {name}: a plain version ran on the "
              f"kernel path: {[h.calls for h in plain_calls]}")
        # the plain arm on the same batches, each step timed once
        plain_ms, on_cpu = {}, {}
        for rung in DYN_RUNGS:
            for b in range(DYN_BATCHES):
                ((x_copy, y), sargs), ms = timed_once(
                    torch, lambda: plain_step(rung, b))
                if b:
                    plain_ms.setdefault(rung, []).append(ms)
                kx, ky = outs[(rung, b)]
                check(same_bits(torch, kx, x_copy[:, :n]),
                      f"dynamic_exchange {name} {rung} batch {b}: the "
                      "gather differs from the plain arm")
                if float32:
                    # the rungs' plain folds are one function of the batch
                    if b not in on_cpu:
                        sargs = [a.cpu() for a in sargs]
                        vals = w["vals"][b].cpu()
                        on_cpu[b] = cpu_fold[1](cpu_fold[0](vals, *sargs),
                                                vals, *sargs)
                    y = on_cpu[b]
                check(same_bits(torch, ky.cpu(), y.cpu()),
                      f"dynamic_exchange {name} {rung} batch {b}: the "
                      "scatter differs from the plain arm")
                check(bool(torch.isfinite(ky).all()),
                      f"dynamic_exchange {name}: a scatter not finite")
        twins[name] = dict(w=w, dp=dp, base=base, outs=outs, arms={
            rung: arms[(rung, True)] for rung in DYN_RUNGS})
        del on_cpu, x_copy, y, kx, ky
        wall["plain"] = time.perf_counter()
        # ms a step: the kernel arm cycling over the batches after the
        # first (CUDA events), the plain arm's checked steps
        step_ms = {}
        for rung in DYN_RUNGS:
            it = itertools.count()
            step_ms[rung] = {
                "kernel": time_steps(torch, lambda: step(
                    rung, True, 1 + next(it) % (DYN_BATCHES - 1)),
                    warmup=2, iters=2 * DYN_BATCHES)["ms_per_iter"],
                "plain": float(np.mean(plain_ms[rung]))}
        pieces = {}
        for kernel in (True, False):
            g, s = arms[("condensed", kernel)]
            gargs, sargs = derive("condensed", kernel, 1)
            x, vals = w["x"][1], w["vals"][1]
            pieces["kernel" if kernel else "plain"] = {
                "derive_ms": cuda_ms(torch, lambda: derive(
                    "condensed", kernel, 1), warmup=2, iters=5),
                "gather_ms": cuda_ms(torch, lambda: g.local(x, *gargs),
                                     warmup=2, iters=5),
                "scatter_ms": (cuda_ms(torch, lambda: s.local(vals, *sargs),
                                       warmup=2, iters=5) if kernel else
                               plain_time(torch, lambda: s.local(
                                   vals, *sargs))[1])}
        it = itertools.count()
        prof = profile_steps(torch, lambda: step(
            "condensed", True, 1 + next(it) % (DYN_BATCHES - 1)), steps=2,
            lead=1)
        wall["timing"] = time.perf_counter()
        g, s = arms[("condensed", True)]
        lines = dyn_kernel_lines(torch, name, w, g, s, dp)
        for k, res in lines.items():
            results[f"{k}_dyn_{name}"] = res
            counts[f"{k}_dyn_{name}"] = launched[k]
        wall["lines"] = time.perf_counter()
        marks = list(wall.values())
        emit({"phase": "dynamic_exchange", "workload": name,
              "shape": w["shape"], "ranks": P, "batches": DYN_BATCHES,
              "rungs": list(DYN_RUNGS), "m": int(w["template"].shape[0]),
              "r": int(w["template"].shape[1]), "n": n, "s_max": dp.s_max,
              "sync_free_batches": steps - len(DYN_RUNGS),
              "launches": {k: launched[k] for k in DYN_STEP_LAUNCHES},
              "step_ms": step_ms, "pieces_ms": pieces,
              "busy_share": prof["busy_share"],
              "kernel_ms_per_step": prof["kernel_ms_per_step"],
              "top_kernels_ms_per_step": prof["top_kernels_ms_per_step"],
              "data_s": round(data_s, 3),
              "wall_s": {k: round(b - a, 3) for k, a, b in zip(
                  list(wall)[1:], marks, marks[1:])},
              "card": card})
        del arms, cpu_fold, g, s
        gc.collect()
        torch.cuda.empty_cache()
    return results, counts, twins


def dyn_step(g, s, w, b):
    """One per-batch step of a gather ``g`` and a scatter-add ``s`` of one
    workload of dyn_workloads on its batch ``b``: the batch's whole tables
    derived once for both directions, each exchange run on its process's
    rows of them (the overlap rung through its handles).  Returns (the
    gather's n rows, the scatter's y), the process's rows."""
    from repro_torch.comm import dynamic as dyn

    cols, n, rows = w["cols"][b], w["n"], g.comm.local_rows
    tables = dyn.derive_gather_tables(cols, n, g.p, g.plan.s_max)
    gargs = g.derive_plan_args(cols, gather_tables=tables)
    sargs = s.derive_plan_args(cols, gather_tables=tables)
    x, vals = w["x"][b][rows], w["vals"][b][rows]
    if g.strategy == "overlap":
        hg, hs = g.start_local(x, *gargs), s.start_local(vals, *sargs)
        return hg.finish()[:, :n], hs.finish()
    return g.local(x, *gargs)[:, :n], s.local(vals, *sargs)


def quiet(torch, fn):
    """``fn()`` with torch.cuda's sync debug mode off, restored after."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class QuietWork:
    """A collective's ``Work`` whose ``wait()`` runs outside the sync
    debug mode."""

    def __init__(self, torch, work):
        self._torch, self._work = torch, work

    def wait(self):
        return quiet(self._torch, self._work.wait)


class SyncExempt:
    """``comm`` with the collectives named in ``names`` issued and waited
    on outside the sync debug mode; every other attribute is ``comm``'s,
    so the derivation and the kernels stay under the mode."""

    def __init__(self, torch, comm, names):
        self._torch, self._comm, self._names = torch, comm, set(names)

    def __getattr__(self, attr):
        fn = getattr(self._comm, attr)
        if attr not in self._names:
            return fn

        def call(*args, **kwargs):
            return QuietWork(self._torch, quiet(
                self._torch, lambda: fn(*args, **kwargs)))
        return call


def collective_syncs(torch, comm) -> dict:
    """The collective a per-batch step calls (``all_to_all``, sync and
    ``async_op``) where it synchronises with the host under
    ``torch.cuda.set_sync_debug_mode("error")``, each after a warm call:
    ``{"all_to_all" or "all_to_all async_op": the error's first line}``."""
    buf = torch.zeros((comm.p_local, comm.p, 4), device=comm.device)
    syncs = {}
    for name, async_op in (("all_to_all", False),
                           ("all_to_all async_op", True)):
        comm.all_to_all(buf, async_op=async_op).wait()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            comm.all_to_all(buf, async_op=async_op).wait()
        except RuntimeError as exc:
            syncs[name] = str(exc).splitlines()[0][:300]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return syncs


def dpb_layer_inputs():
    """Arm threads' DynamicMoELayer and GNN inputs on the host, from the
    seed: swiglu expert weights, tokens, the template and DPB_LAYER's
    routings, a Zipf(GNN_ALPHA) graph and its features."""
    from repro_torch.models.gnn import random_neighbors
    from repro_torch.models.moe import random_router

    c = DPB_LAYER
    rng = np.random.default_rng(SEED + 30)
    shapes = {"w1": (c["experts"], c["d"], c["f"]),
              "w2": (c["experts"], c["f"], c["d"]),
              "w3": (c["experts"], c["d"], c["f"])}
    params = {k: (rng.standard_normal(v) * 0.3).astype(np.float32)
              for k, v in shapes.items()}
    x = rng.standard_normal((c["tokens"], c["d"])).astype(np.float32)
    routings = [random_router(SEED + 40 + i, c["tokens"], c["experts"],
                              c["top"]) for i in range(c["routings"] + 1)]
    g = DPB_GNN
    nbrs = random_neighbors(g["n"], g["r"], alpha=GNN_ALPHA, seed=SEED + 50)
    h = rng.standard_normal((g["n"], g["d"])).astype(np.float32)
    return dict(params=params, x=x, template=routings[0][0],
                routings=routings[1:], nbrs=nbrs, h=h)


def phase_dist_per_batch(torch, twins, hw, card):
    """The per-batch consumers over a DistComm, in two arms.  Arm nccl:
    each workload of phase dynamic_exchange (``twins``: its data, pattern,
    envelope plan, kernel-arm exchanges and outputs) over ``DistComm(P)``
    in the one process of an NCCL group (world 1), condensed and overlap
    with use_kernel=True over DYN_BATCHES batches, each batch after the
    first derived, gathered and scattered under
    torch.cuda.set_sync_debug_mode("error") (a collective that syncs by
    itself is named on a line of its own and run outside the mode, the
    derivation and the kernels staying under it): every output the
    loopback kernel arm's bit for bit, B1, B2, B5 and B6 launched every
    step as there, no plain version run; then ms a step of each rung
    beside the loopback arm's (the two in turns, once the counts are
    read).  Arm
    threads: the same exchanges at DPB_THREAD_TOKENS tokens and
    DPB_THREAD_GNN_N nodes, a DynamicMoELayer (``__call__`` and ``apply``)
    and GNNNeighborAggregate at DPB_LAYER's and DPB_GNN's widths, over a
    ThreadWorld of THREAD_WORLD processes of THREAD_P_LOCAL ranks (the
    second at rank_offset 4): the threads' rows stacked, and each thread's
    ``apply`` output, bit for bit a LoopbackComm(P) run's, the exchange
    kernels launched in the threads.  Returns both arms' launches of
    DYN_KERNELS, summed."""
    import itertools

    from repro_torch.comm import dynamic as dyn
    from repro_torch.comm import plan_cache
    from repro_torch.comm.communicator import DistComm, LoopbackComm
    from repro_torch.comm.gather import IrregularGather
    from repro_torch.comm.pattern import AccessPattern
    from repro_torch.comm.plan import Topology
    from repro_torch.comm.scatter import IrregularScatter
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.models.gnn import GNNNeighborAggregate
    from repro_torch.models.moe import DynamicMoELayer

    def exchanges(comm, dp, base, rung):
        return (IrregularGather(dp, comm, strategy=rung, use_kernel=True,
                                base_plan=base),
                IrregularScatter(dp, comm, strategy=rung, reduce="add",
                                 use_kernel=True, base_plan=base))

    def cycling(arms, w):
        it = itertools.count()
        return lambda: dyn_step(*arms, w, 1 + next(it) % (DYN_BATCHES - 1))

    t_start = time.perf_counter()
    steps = len(DYN_RUNGS) * DYN_BATCHES
    counts = dict.fromkeys(DYN_KERNELS, 0)
    lines = []
    with nccl_group(torch):
        comm = DistComm(P)
        check((comm.p, comm.p_local, comm.world, comm.device.type)
              == (P, P, 1, "cuda"), f"DistComm {vars(comm)}")
        syncs = collective_syncs(torch, comm)
        if syncs:
            emit({"phase": "dist_per_batch", "arm": "nccl",
                  "collective_syncs_with_the_host": syncs,
                  "run_outside_the_sync_debug_mode": ["all_to_all"]})
            comm = SyncExempt(torch, comm, ("all_to_all",))
        for name, tw in twins.items():
            w = tw["w"]
            arms = {rung: exchanges(comm, tw["dp"], tw["base"], rung)
                    for rung in DYN_RUNGS}
            torch.cuda.synchronize()
            kops.reset_launch_counts()
            with contextlib.ExitStack() as stack:
                plain_calls = [stack.enter_context(held_calls(kref, f))
                               for f in DYN_PLAIN]
                for rung in DYN_RUNGS:
                    for b in range(DYN_BATCHES):
                        torch.cuda.synchronize()
                        if b:
                            torch.cuda.set_sync_debug_mode("error")
                        try:
                            got = dyn_step(*arms[rung], w, b)
                        except RuntimeError as exc:
                            fail(f"dist_per_batch {name} {rung} batch {b}: "
                                 f"{exc}")
                        finally:
                            torch.cuda.set_sync_debug_mode(0)
                        check(all(same_bits(torch, a, e) for a, e in zip(
                            got, tw["outs"][(rung, b)])),
                            f"dist_per_batch {name} {rung} batch {b}: not "
                            "the loopback kernel arm's bits")
            torch.cuda.synchronize()
            launched, entries = kops.launch_counts(), kops.entry_counts()
            want_counts = {k: DYN_STEP_LAUNCHES.get(k, 0) * steps
                           for k in launched}
            check(launched == want_counts,
                  f"dist_per_batch {name}: launches {launched}, expected "
                  f"{want_counts}")
            check(entries.get("rt_unpack_scatter_tiles") == steps
                  and "rt_unpack_scatter_set" not in entries,
                  f"dist_per_batch {name}: B2 ran {entries}")
            check(all(h.calls == 0 for h in plain_calls),
                  f"dist_per_batch {name}: a plain version ran: "
                  f"{[h.calls for h in plain_calls]}")
            for k in DYN_KERNELS:
                counts[k] += launched[k]
            # ms a step once the counts are read: dist, loopback,
            # loopback, dist, each cycling over the batches after the first
            step_ms = {}
            for rung in DYN_RUNGS:
                pair = (arms[rung], tw["arms"][rung])
                reads = [time_steps(torch, cycling(pair[i], w), warmup=2,
                                    iters=2 * DYN_BATCHES)
                         for i in (0, 1, 1, 0)]
                mean = {arm: {k: float(np.mean([r[k] for r in rs]))
                              for k in ("ms_per_iter",
                                        "host_enqueue_ms_per_iter")}
                        for arm, rs in (("dist", reads[::3]),
                                        ("loopback", reads[1:3]))}
                step_ms[rung] = {
                    "dist": mean["dist"]["ms_per_iter"],
                    "loopback": mean["loopback"]["ms_per_iter"],
                    "dist_minus_loopback": mean["dist"]["ms_per_iter"]
                    - mean["loopback"]["ms_per_iter"],
                    "dist_host_enqueue": mean["dist"][
                        "host_enqueue_ms_per_iter"],
                    "loopback_host_enqueue": mean["loopback"][
                        "host_enqueue_ms_per_iter"],
                    "readings_dist_loop_loop_dist": [
                        r["ms_per_iter"] for r in reads]}
            lines.append((name, launched, step_ms))
            del arms, got
    nccl_s = time.perf_counter() - t_start
    for name, launched, step_ms in lines:
        tw = twins[name]
        emit({"phase": "dist_per_batch", "arm": "nccl", "workload": name,
              "shape": tw["w"]["shape"],
              "comm": f"DistComm, one process of an NCCL group (world 1), "
                      f"p_local {P}", "rungs": list(DYN_RUNGS),
              "batches": DYN_BATCHES,
              "sync_free_batches": steps - len(DYN_RUNGS),
              "collective_syncs": sorted(syncs),
              "bit_for_bit_loopback": True,
              "launches": {k: launched[k] for k in DYN_STEP_LAUNCHES},
              "step_ms": step_ms, "card": card})

    # arm threads: a process at rank_offset 4 on the card
    t0 = time.perf_counter()
    dev = next(iter(twins.values()))["w"]["x"][0].device
    small = dyn_workloads(torch, dev, tokens=DPB_THREAD_TOKENS,
                          gnn_n=DPB_THREAD_GNN_N)
    envelopes = {}
    for name, w in small.items():
        dp = dyn.DynamicPattern.from_template(
            AccessPattern.from_indices(w["template"], n=w["n"]), P)
        envelopes[name] = (dp, plan_cache.get_envelope_plan(
            w["template"], w["n"], P, topology=Topology(P, P),
            s_max=dp.s_max, cache=False))
    inp = dpb_layer_inputs()
    lc = DPB_LAYER
    weights = [torch.as_tensor(inp["params"][k], device=dev)
               for k in ("w1", "w2", "w3")]
    x_dev = torch.as_tensor(inp["x"], device=dev)

    def drive(comm):
        out = {}
        for name, w in small.items():
            for rung in DYN_RUNGS:
                arms = exchanges(comm, *envelopes[name], rung)
                for b in range(DYN_BATCHES):
                    out[(name, rung, b)] = dyn_step(*arms, w, b)
        layer = DynamicMoELayer(
            inp["params"], inp["template"], lc["tokens"], lc["experts"],
            lc["capacity"], comm, act="swiglu", strategy="condensed", hw=hw,
            use_plan_cache=False)
        for i, (te, tw_) in enumerate(inp["routings"]):
            out[("moe_layer", i)] = (layer(layer.shard_tokens(inp["x"]), te,
                                           tw_),)
            out[("moe_apply", i)] = (layer.apply(
                x_dev, torch.as_tensor(te, device=dev),
                torch.as_tensor(tw_, device=dev), *weights),)
        for rung in DYN_RUNGS:
            gnn = GNNNeighborAggregate(inp["nbrs"], DPB_GNN["n"], comm,
                                       strategy=rung, hw=hw,
                                       use_plan_cache=False)
            out[("gnn", rung)] = (gnn(gnn.shard_features(inp["h"])),)
        return out

    want = drive(LoopbackComm(P, device=dev))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    kops.reset_launch_counts()
    t1 = time.perf_counter()
    got = ThreadWorld(torch, THREAD_WORLD, THREAD_P_LOCAL, dev).run(drive)
    threads_s = time.perf_counter() - t1
    t_counts = kops.launch_counts()
    for key, w_out in want.items():
        if key[0] == "moe_apply":
            for rank, res in enumerate(got):
                check(same_bits(torch, res[key][0], w_out[0]),
                      f"dist_per_batch threads rank {rank} {key}: not the "
                      "loopback layer's output bit for bit")
            continue
        for i, part in enumerate(w_out):
            stacked = torch.cat([res[key][i] for res in got])
            check(same_bits(torch, stacked, part),
                  f"dist_per_batch threads {key}: the ranks' rows are not "
                  "the LoopbackComm run's bit for bit")
    for k in DYN_KERNELS:
        check(t_counts[k] > 0, f"dist_per_batch threads never launched {k}")
        counts[k] += t_counts[k]
    emit({"phase": "dist_per_batch", "arm": "threads",
          "world": THREAD_WORLD, "p_local": THREAD_P_LOCAL,
          "rank_offsets": [c * THREAD_P_LOCAL for c in range(THREAD_WORLD)],
          "shapes": {name: w["shape"] for name, w in small.items()},
          "moe_layer": lc,
          "gnn": DPB_GNN, "cases": len(want),
          "bit_for_bit_loopback": True,
          "launches": {k: t_counts[k] for k in DYN_KERNELS},
          "loopback_s": round(ref_s, 3), "threads_s": round(threads_s, 3),
          "card": card})
    emit({"phase": "dist_per_batch_summary", "nccl_s": round(nccl_s, 3),
          "threads_s": round(time.perf_counter() - t0, 3),
          "wall_s": round(time.perf_counter() - t_start, 3),
          "launches": counts})
    return counts


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

    def keep(*args, **kwargs):
        out = saved(*args, **kwargs)
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
    with B9 against the plain recurrence's at L = 1024 (and a float32
    twin's with the bf16 payload, B9b against the plain bf16 scan); then
    ssm_prefill_bf16.  Returns the launch counts and B9b's kernel line."""
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
    m32b = Model(cfg, RunCtx(act_dtype=torch.float32,
                             ssm_scan_dtype=torch.bfloat16), device=dev)

    def plain32(*args, **kw):
        return kref.selective_scan_ref(*args)

    def plain_bf16(*args, chunk=256, **kw):
        return kref.selective_scan_bf16_ref(*args, chunk=chunk)
    errs = {}
    for name, fn, plain in (
            ("bf16", lambda: prefill(params, short), plain32),
            ("f32", lambda: build_prefill(m32)(p32, short), plain32),
            ("f32_bf16_payload", lambda: build_prefill(m32b)(p32, short),
             plain_bf16)):
        got = fn()
        with plain_kernel(kops, "selective_scan", plain):
            want = fn()
        errs[name] = rel_l2(torch, got, want)
    del m32, m32b, p32
    # in bf16 the 64 random layers turn the kernel's other summation order
    # into another answer (reported, not held); float32 is held, with
    # either scan payload (B9, B9b)
    check(errs["f32"] < LOGITS_REL_F32
          and errs["f32_bf16_payload"] < LOGITS_REL_F32,
          f"prefill logits with B9 / B9b are {errs} (relative) from the "
          "plain recurrence's")
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
    counts_b, res_b = ssm_prefill_bf16(torch, card, cfg, params, tokens,
                                       timing["ms_per_iter"])
    counts.update(counts_b)
    return counts, res_b


def ssm_prefill_bf16(torch, card, cfg, params, tokens, f32_ms):
    """The same model and weights with the reference's bf16 scan payload
    (``RunCtx(ssm_scan_dtype=bfloat16)``): build_prefill at the same L,
    counters zeroed before the first call and read after — B9b launched
    once a layer, B9 and every plain scan never; its ms beside the
    float32 payload's (``f32_ms``); layer 0's call as the kernel line
    ``selective_scan_bf16`` (scan_bf16_line, held against the plain
    version on the first SSM_BF16_CHECK_L steps)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.models.transformer import Model, RunCtx
    from repro_torch.runtime.steps import build_prefill

    model = Model(cfg, RunCtx(act_dtype=torch.bfloat16,
                              ssm_scan_dtype=torch.bfloat16))
    prefill = build_prefill(model)
    kops.reset_launch_counts()
    with held_calls(kops, "selective_scan", (0,)) as held, \
            held_calls(kref, "selective_scan_ref") as plain32, \
            held_calls(kref, "selective_scan_bf16_states_ref") as plain16:
        logits = prefill(params, tokens)
        torch.cuda.synchronize()
    counts = kops.launch_counts()
    launched = {k: counts[k] for k in ("selective_scan_bf16",
                                       "selective_scan")}
    plain_calls = {"selective_scan_ref": plain32.calls,
                   "selective_scan_bf16_states_ref": plain16.calls}
    check(launched == {"selective_scan_bf16": cfg.num_layers,
                       "selective_scan": 0}
          and not any(plain_calls.values()),
          f"ssm_prefill_bf16: launches {launched}, plain calls "
          f"{plain_calls} in one prefill of {cfg.num_layers} layers")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "ssm_prefill_bf16: logits not finite or misshapen")
    timing = time_steps(torch, lambda: prefill(params, tokens), warmup=0,
                        iters=2)
    args = held.pop(0)[0]
    del logits, held
    res = scan_bf16_line(torch, "selective_scan_bf16", args,
                         check_l=SSM_BF16_CHECK_L)
    del args
    emit({"phase": "ssm_prefill_bf16", "arch": cfg.name,
          "layers": cfg.num_layers, "dtype": "bfloat16, bf16 scan payload",
          "batch": 1, "seq": tokens.shape[1],
          "ms_per_prefill": timing["ms_per_iter"],
          "f32_payload_ms_per_prefill": f32_ms,
          "tokens_per_s": tokens.shape[1] / (timing["ms_per_iter"] / 1e3),
          "host_enqueue_ms": timing["host_enqueue_ms_per_iter"],
          "launches": launched, "plain_scan_calls": plain_calls,
          "card": card})
    return {"selective_scan_bf16": launched["selective_scan_bf16"]}, res


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
                with_trainer=None, profiled=True,
                ssm_scan_dtype=None):
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
    the wall seconds of each part.  ``profiled`` False skips the profiled
    step; ``ssm_scan_dtype`` is launch.train.setup's."""
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
    tr = ltrain.setup(cfg, args, retries=0,     # no failure retried away
                      ssm_scan_dtype=ssm_scan_dtype or torch.float32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    kops.reset_launch_counts()
    with (watch or contextlib.nullcontext)() as seen:
        losses, gnorms, step_ms = train_steps(torch, tr, timed)
    counts = kops.launch_counts()
    t2 = time.perf_counter()
    prof = None
    if profiled:
        metrics, prof = profile_train_step(torch, tr.step)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        del metrics
    t3 = time.perf_counter()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{phase}: losses {losses}, grad norms {gnorms}")
    ln_v = float(np.log(cfg.vocab_size))
    check(abs(losses[0] - ln_v) <= 2.0,
          f"{phase}: step-0 loss {losses[0]} is not within 2 of ln(V) = "
          f"{ln_v}")
    extra = with_trainer(tr, args) if with_trainer else {}
    del tr
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


def scan_bwd_bound(b: int, l: int, di: int, st: int, nseg=None):
    """(bound_ms, bound_by) of the scan's backward, counting the
    function's own traffic and work only: x, dt, dy, B, C, a and the
    forward's ``nseg`` checkpoints (B9's every CKPT_STEPS steps by
    default) read once and dx, ddt, dB, dC and dA written once, float32;
    one exponential, exp(dt·a), a (step, channel, state) over the SMs'
    special-function lanes.  The kernel's dB/dC/dA partials and its
    second rebuild of the decays are its design's cost, not the
    function's."""
    from repro_torch.kernels.selective_scan import CKPT_STEPS
    if nseg is None:
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
    (once), the bound and what sets it, the kernel's block and the bytes
    of its dB/dC partials; no single PyTorch call computes the scan's
    gradient.  Beside it the checkpointing forward on the step's
    first forward call (``fwd_args``, ``fwd_out``; scan_ckpt_check)."""
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
        "layout": {"threads": 256, "partials_bytes": 4 * 2 * b * l * st
                   * b9.bwd_partials(di, st)},
        "shape": f"x/dt/dy ({b}, {l}, {di}) f32, B/C ({b}, {l}, {st}), "
                 f"checkpoints {hck if hck is None else tuple(hck.shape)}",
        "max_abs_err_is": "relative to each gradient's largest element"})
    check_bound(name, res)
    return res


def phase_train_scan(torch, card, phase, argv, layers, timed, kernel_name,
                     bf16_line=None):
    """A model with mamba layers through train_phase: B9's forward
    launched layers x microbatches x 2 a step (remat full runs each
    layer's forward again in the backward), its backward layers x
    microbatches, the plain scan and the plain backward never called.  The
    warm-up's first checkpointing forward (the first layer's, first
    microbatch) and first backward (the last layer's) are held, and the
    kernel line ``kernel_name`` runs on their inputs; ``bf16_line`` names
    a line of B9b′ on the same backward's inputs (scan_bf16_bwd_line)."""
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
    bwd_args, bwd_out = bwd.pop(0)
    res = scan_bwd_line(torch, kernel_name, bwd_args, bwd_out, *fwd.pop(0))
    if bf16_line:
        x, dt, bm, cm, a, _, dy = bwd_args
        scan_bf16_bwd_line(torch, bf16_line, (x, dt, bm, cm, a), dy)
    del seen, fwd, bwd, bwd_args, bwd_out
    gc.collect()
    torch.cuda.empty_cache()
    fields["wall_s"]["kernel_line"] = round(time.perf_counter() - t0, 1)
    emit({**fields, "d_inner": cfg.d_inner, "state": cfg.ssm_state,
          "mfu_counts": "6 N tokens (runtime/steps.model_flops): the "
                        "selective scan's own work is outside it",
          "launches": got, "plain_scan_calls": plain_calls, "card": card})
    res["step_ms"] = fields["ms_per_step"]
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
                            "selective_scan_bwd_di3200",
                            bf16_line="selective_scan_bf16_bwd_di3200")


def fsdp_bytes(params, dims, parts: int, stack_scale: float = 1.0):
    """The bytes a rank holds of ``params`` and its AdamW ``m`` and ``v``
    (and the int32 step) where ``dims`` splits leaves ``parts`` ways:
    each split leaf's bytes over ``parts``, each other leaf's whole; the
    stacked leaves (``layers``) scaled by ``stack_scale``."""
    from repro_torch.runtime.sharding import _flat
    total = 4
    for keys, t, d in _flat(params, dims):
        n = 3 * t.numel() * t.element_size()
        if keys[0] == "layers":
            n *= stack_scale
        total += n / parts if d is not None else n
    return int(total)


def distinct_bytes(tree) -> int:
    """The bytes of the distinct storages that ``tree``'s leaves hold."""
    from repro_torch.models.transformer import tree_leaves
    seen = {}
    for t in tree_leaves(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


@contextlib.contextmanager
def counted_collectives(comm):
    """Count the calls of ``comm``'s collectives inside the block (an
    ``all_reduce`` also counts the ``reduce_scatter`` and ``all_gather``
    it runs)."""
    counts = collections.Counter()
    names = ("all_gather", "reduce_scatter", "all_reduce")
    saved = {n: getattr(comm, n) for n in names}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(comm, n, counting(n))
    try:
        yield counts
    finally:
        for n in names:
            delattr(comm, n)


def fsdp_collective_ms(torch, tr, accum: int):
    """Device ms (cuda_ms) and host enqueue ms of one gather and one
    reduce-scatter of FSDP trainer ``tr``'s first layer and of its
    embedding and head (their split leaves, float32), and a step's
    gathers and reduce-scatters priced from them: ``accum`` x (2 x layers
    + 1) gathers, ``accum`` x (layers + 1) reduce-scatters (the norm's
    gathers and the all_reduce not priced)."""
    from repro_torch.models.transformer import tree_map
    from repro_torch.runtime.sharding import _flat, gathered, _scattered

    gather, comm = tr.model.ctx.gather, tr.comm
    out = {}
    for name, keys, tree in (
            ("layer", ("layers",),
             tree_map(lambda t: t[0], tr.params["layers"])),
            ("embed_head", (), {k: tr.params[k] for k in ("embed",
                                                          "lm_head")})):
        split = [(t, d) for _, t, d in _flat(tree, gather.at(keys))
                 if d is not None]
        parts, dims = [t for t, _ in split], [d for _, d in split]
        with torch.no_grad():
            wholes = gathered(comm, parts, dims)
            row = {"bytes": sum(t.numel() * t.element_size()
                                for t in parts)}
            for op, fn in (("gather", lambda: gathered(comm, parts, dims)),
                           ("reduce_scatter",
                            lambda: _scattered(comm, wholes, dims))):
                row[op + "_ms"] = cuda_ms(torch, fn, warmup=2, iters=10)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                row[op + "_host_ms"] = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
        out[name] = row
        del wholes
    n, lay, top = tr.model.cfg.num_layers, out["layer"], out["embed_head"]
    out["step_priced_ms"] = accum * (
        2 * n * lay["gather_ms"] + top["gather_ms"]
        + n * lay["reduce_scatter_ms"] + top["reduce_scatter_ms"])
    return out


def model_axis_calls(cfg, accum: int, seq: int, split_m: int) -> dict:
    """The model group's collective calls in one --mesh 1x1 step of an ssm
    stack (counted_collectives' way: an all_reduce also counts the
    reduce_scatter and all_gather it runs).  Remat (torch.utils.checkpoint,
    which stops recomputing a region at the last tensor its backward
    saved) runs a region's forward once more, up to that tensor.  A mamba
    layer, a microbatch: its forward gathers in_proj (one all_gather) and
    reduces x_proj's and out_proj's partial sums (two all_reduces); the
    recomputation runs all but the last reduce; the backward all-reduces
    the two entries' gradients and reduce-scatters in_proj's.  A chunk of
    the vocab-parallel cross entropy, a microbatch: the log-sum-exp's max
    and sum and the label's logit reduced (three all_reduces), the
    recomputation all but the last, and the entry's all_reduce in the
    backward.  The global norm assembles every leaf that the model axis
    splits (one all_gather each)."""
    chunks = seq // min(512, seq)
    reduces = accum * (5 * cfg.num_layers + 6 * chunks)
    return {"all_gather": accum * 2 * cfg.num_layers + split_m + reduces,
            "reduce_scatter": accum * cfg.num_layers + reduces,
            "all_reduce": reduces}


POD_AXES = ("pod", "data", "model")


@contextlib.contextmanager
def expert_widths():
    """The (experts, columns) pairs that moe.moe_expert_local runs with
    inside the block, from any thread: a set."""
    from repro_torch.models import moe
    seen, fn = set(), moe.moe_expert_local

    def call(buf, w1, *args, **kwargs):
        seen.add((buf.shape[-3], w1.shape[-1]))
        return fn(buf, w1, *args, **kwargs)

    moe.moe_expert_local = call
    try:
        yield seen
    finally:
        moe.moe_expert_local = fn


def pod_arms(torch, cfg, args, local, local_first, state, launched) -> dict:
    """dist_train's pod axis, inside its NCCL group, after --mesh local's
    first step (``local`` holds it, ``local_first`` its metrics):
    launch.train's setup on a 1x1x1 pod x data x model mesh (a
    launch.mesh.Mesh as args.mesh; the data, pod, model and batch groups
    each of one rank) takes the same first step,
    bit for bit local's (parameters, AdamW state, loss, gradient norm),
    its split leaves' gradients through the HSDP reduction (a
    reduce-scatter over the batch group, an all-gather over the pod
    group, each layer of each microbatch); every group's collectives are
    counted and held.  Then the same under hierarchical_rules
    (opt_fsdp_axes=("pod", "data"), the reference's dry-run train rules),
    bit for bit too, the norm's gathers then over the batch group (at one
    pod each block is its part: the update's block exchange is not
    reached).  B9 and B9′ launched as in the 2-D step, added to
    ``launched``.  Returns the phase's line."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import tree_leaves

    mesh = mesh_mod.Mesh((1, 1, 1), POD_AXES)
    accum, layers = args.accum, cfg.num_layers
    out = {"phase": "dist_train", "part": "1x1x1", "arch": cfg.name,
           "layers": layers, "mesh": list(mesh.axis_sizes),
           "axes": list(POD_AXES)}
    for arm, rules in (("pod", None),
                       ("opt_fsdp_axes", ltrain.hierarchical_rules(cfg,
                                                                   mesh))):
        t0 = time.perf_counter()
        pargs = ltrain.parse_args(TRAIN_SSM_ARGV)
        pargs.mesh = mesh
        tr = ltrain.setup(cfg, pargs, retries=0, rules=rules)
        gather = tr.model.ctx.gather
        check(gather.hier is not None and tr.comm is gather.batch
              and (rules is None) == (gather.odims is None),
              f"dist_train {arm}: the trainer is not the pod one")
        groups = {"data": gather.comm, "batch": gather.batch,
                  "pod": gather.pod, "model": tr.model.ctx.model.comm}
        kops.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            calls = {k: stack.enter_context(counted_collectives(c))
                     for k, c in groups.items()}
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = tr.step()
            end.record()
            torch.cuda.synchronize()
        counts = kops.launch_counts()
        calls = {k: dict(v) for k, v in calls.items()}
        same = all(torch.equal(a, b) for a, b in zip(state(local),
                                                     state(tr)))
        for k in ("loss", "grad_norm"):
            same = same and float(got[k]) == float(local_first[k])
        check(same, f"dist_train {arm}: the 1x1x1 step is not the --mesh "
              "local step bit for bit")
        expect = {"selective_scan": 2 * layers * accum,
                  "selective_scan_bwd": layers * accum}
        got_counts = {k: counts[k] for k in expect}
        check(got_counts == expect, f"dist_train {arm}: B9 launched "
              f"{got_counts}, not {expect}")
        for k, n in got_counts.items():
            launched[k] += n
        # the norm assembles each leaf over the group of its block: the
        # data group's parts, or the batch group's opt_fsdp_axes blocks
        blocks = gather.dims if gather.odims is None else gather.odims
        norm = sum(d is not None for d in tree_leaves(blocks))
        want = {"data": {"all_gather": accum * (2 * layers + 1)},
                "batch": {"reduce_scatter": accum * (layers + 1) + 1,
                          "all_gather": 1, "all_reduce": 1},
                "pod": {"all_gather": accum * (layers + 1)}}
        want["data" if gather.wide is gather.comm else "batch"][
            "all_gather"] += norm
        for k, w in want.items():
            check(calls[k] == w, f"dist_train {arm}: the {k} group ran "
                  f"{calls[k]}, not {w}")
        out[arm] = {"bit_for_bit_mesh_local": True, "launches": got_counts,
                    "collectives_per_step": calls,
                    "step_ms": start.elapsed_time(end),
                    "loss": float(got["loss"]),
                    "wall_s": round(time.perf_counter() - t0, 1)}
        del tr, got, gather, groups
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_dist_train(torch, card):
    """launch.train --mesh 1x1 on falcon-mamba-7b at its published widths,
    DIST_TRAIN_LAYERS layers, train_ssm's settings: the 2-D path over a
    one-process NCCL group (the data group and the model group each of
    one rank; each part the whole leaf; every layer's weights all-gathered
    over the data group in its remat region, again in its recomputed
    forward, its gradients reduce-scattered, the global norm's split
    gradients assembled over both groups; the model group's collectives
    run over its one rank: in_proj gathered, x_proj's and out_proj's
    partial sums and the vocab-parallel cross entropy's reduced, the
    entries' gradients all-reduced), beside a --mesh local trainer from
    the same seed (built before the group exists, so it trains alone): the
    first step on the same batch bit for bit (parameters, AdamW state,
    loss, gradient norm), B9 and its backward launched in every layer of
    every microbatch, and both groups' collectives counted against the
    layers and microbatches; then the two steps timed in the order local,
    2-D, 2-D, local (CUDA events; peak memory allocated during each, both
    trainers resident), and the bytes a rank holds (distinct storages)
    beside those param_specs would place at D = 8.  Between the checked
    step and the timed ones, pod_arms: the same first step on a 1x1x1 pod
    x data x model mesh, without and with opt_fsdp_axes.  Returns the 2-D
    and pod steps' launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime import sharding

    args = ltrain.parse_args(TRAIN_SSM_ARGV)
    full = get_config(args.arch)
    cfg = dataclasses.replace(full, num_layers=DIST_TRAIN_LAYERS)
    t0 = time.perf_counter()

    def state(tr):
        return tree_leaves({"params": tr.params, "opt": tr.opt_state})

    def timed_step(tr):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = tr.step()
        end.record()
        torch.cuda.synchronize()
        return metrics, start.elapsed_time(end), \
            torch.cuda.max_memory_allocated()

    # --mesh local with no process group: this process alone
    local = ltrain.setup(cfg, ltrain.parse_args(
        TRAIN_SSM_ARGV + ["--mesh", "local"]), retries=0)
    with nccl_group(torch):
        dp = ltrain.setup(cfg, ltrain.parse_args(
            TRAIN_SSM_ARGV + ["--mesh", "1x1"]), retries=0)
        tp = dp.model.ctx.model
        check(local.comm is None and dp.comm.world == 1
              and dp.placed is not None
              and dp.model.ctx.gather is not None
              and tp is not None and tp.size == 1
              and tp.comm is not dp.comm
              and dp.step_fn.retries == 0,
              "dist_train: the --mesh 1x1 trainer is not the 2-D one")
        check(all(torch.equal(a, b) for a, b in zip(state(local),
                                                    state(dp))),
              "dist_train: the two trainers start from different weights")
        dims = dp.placed.dims["params"]
        split = sum(d is not None for d in tree_leaves(dims))
        split_m = sum(d is not None for d in tree_leaves(
            dp.placed.mdims["params"]))
        held = {"fsdp": distinct_bytes({"params": dp.params,
                                        "opt": dp.opt_state}),
                "local": distinct_bytes({"params": local.params,
                                         "opt": local.opt_state})}
        rules8 = ltrain.fsdp_rules(cfg, 8)
        dims8 = sharding.data_dims(rules8, dp.params)
        at_8 = {"layers": cfg.num_layers,
                "bytes": fsdp_bytes(dp.params, dims8, 8),
                "published_layers": full.num_layers,
                "published_bytes": fsdp_bytes(
                    dp.params, dims8, 8,
                    full.num_layers / cfg.num_layers),
                "published_bytes_replicated": fsdp_bytes(
                    dp.params, dims8, 1,
                    full.num_layers / cfg.num_layers)}
        t1 = time.perf_counter()
        want, _, _ = timed_step(local)
        kops.reset_launch_counts()
        with counted_collectives(dp.comm) as calls, \
                counted_collectives(tp.comm) as model_calls:
            got, first_ms, _ = timed_step(dp)
        counts = kops.launch_counts()
        same = all(torch.equal(a, b) for a, b in zip(state(local),
                                                     state(dp)))
        for k in ("loss", "grad_norm"):
            same = same and torch.equal(got[k], want[k])
        check(same, "dist_train: the --mesh 1x1 step is not the --mesh "
              "local step bit for bit")
        accum = args.accum
        per_step = cfg.num_layers * accum
        expect = {"selective_scan": 2 * per_step,
                  "selective_scan_bwd": per_step}
        launched = {k: counts[k] for k in expect}
        check(launched == expect, f"dist_train: B9 launched {launched} in "
              f"one step of {cfg.num_layers} layers x {accum} "
              f"microbatches, not {expect}")
        # a layer: gathered, gathered again when remat recomputes it,
        # reduce-scattered; the embedding and head once a microbatch; the
        # norm assembles each split leaf; one all_reduce of the whole
        # leaves' gradients and the loss (its own reduce_scatter and
        # all_gather)
        calls = dict(calls)
        want_calls = {"all_gather": accum * (2 * cfg.num_layers + 1)
                      + split + 1,
                      "reduce_scatter": accum * (cfg.num_layers + 1) + 1,
                      "all_reduce": 1}
        check(calls == want_calls, f"dist_train: the 2-D step ran the "
              f"data group's collectives {calls}, not {want_calls}")
        model_calls = dict(model_calls)
        want_model = model_axis_calls(cfg, accum, args.seq, split_m)
        check(model_calls == want_model, f"dist_train: the 2-D step ran "
              f"the model group's collectives {model_calls}, not "
              f"{want_model}")
        pod_line = pod_arms(torch, cfg, args, local, want, state, launched)
        pod_line["card"] = card
        t2 = time.perf_counter()
        ms = {"local": [], "fsdp": []}
        peak = {"local": 0, "fsdp": 0}
        losses = [float(want["loss"])]
        for name in ("local", "fsdp", "fsdp", "local"):
            metrics, t, top = timed_step(local if name == "local" else dp)
            ms[name].append(t)
            peak[name] = max(peak[name], top)
            losses.append(float(metrics["loss"]))
        check(np.isfinite(losses).all(), f"dist_train: losses {losses}")
        t3 = time.perf_counter()
        collective_ms = fsdp_collective_ms(torch, dp, accum)
        del local, dp, want, got, metrics
    gc.collect()
    torch.cuda.empty_cache()
    emit(pod_line)
    local_ms, fsdp_ms = (sum(ms[k]) / 2 for k in ("local", "fsdp"))
    emit({"phase": "dist_train", "arch": cfg.name, "layers": cfg.num_layers,
          "of_layers": full.num_layers, "d_model": cfg.d_model,
          "d_inner": cfg.d_inner, "seq": args.seq, "batch": args.batch,
          "accum": args.accum, "mesh": "1x1",
          "comm": "DistComm over a data group and a model group of one "
                  "rank each, one process of an NCCL group (world 1)",
          "fsdp": "every split leaf's part is the whole leaf at world 1",
          "bit_for_bit_mesh_local": True, "launches": launched,
          "collectives_per_step": calls,
          "model_group_collectives_per_step": model_calls,
          "split_leaves": split, "model_split_leaves": split_m,
          "bytes_held": held,
          "bytes_at_d8_by_param_specs": at_8,
          "losses": losses, "first_step_ms": first_ms,
          "order": "local, fsdp, fsdp, local",
          "fsdp_step_ms": ms["fsdp"], "local_step_ms": ms["local"],
          "fsdp_minus_local_ms": fsdp_ms - local_ms,
          "peak_allocated_bytes": peak,
          "peak_note": "max_memory_allocated during the step, both "
                       "trainers resident",
          "collective_ms": collective_ms,
          "wall_s": {"setup": round(t1 - t0, 1),
                     "checked_step": round(t2 - t1, 1),
                     "timed_steps": round(t3 - t2, 1),
                     "collectives": round(time.perf_counter() - t3, 1)},
          "card": card})
    return launched


def phase_dist_tp_forward(torch, card, dev=None):
    """The model axis on the card: a ThreadWorld of two threads holds model
    ranks 0 and 1 of a 1x2 mesh (each its own stream, a ThreadComm of two
    ranks as its model group and a LoopbackComm of one as its data
    group), each keeping its parts of the parameters drawn from the seed
    as launch.train --mesh 1x2 keeps them (fsdp_rules(cfg, 1, 2),
    vocab_shards 2), and computes the first batch's loss under no_grad,
    float32 activations and TF32 off (the train twins' settings): for
    llama3-8b at its published widths, DIST_TP_LAYERS layers (16 query and
    4 KV heads a rank, a 64128-row vocabulary slice looked up masked and
    the vocab-parallel cross entropy), and for falcon-mamba-7b the same
    way (B9 on 4096 of 8192 channels a rank, launched once a layer a
    rank).  Each loss is held against a --mesh local float32 model's from
    the same seed on the same batch, within DIST_TP_TOL relative, with
    the ms of each after a warm-up forward (CUDA events on each rank's
    stream; the local one on the default stream) and the peak memory
    allocated during each timed forward, its parameters resident (both
    ranks' threads share the card).  Returns the timed forwards' launch
    counts.  Then DIST_TP_LOCAL the same way on DIST_TP_LOCAL_ARGV's
    batch: mixtral-8x22b's 8 experts on a 1x16 model axis of 16 threads (the reference's tp_local split,
    ep_mode off: each rank all 8 experts on its 1024 columns, their
    partial sums all-reduced), each thread drawing its parameters in turn
    (a whole expert weight is 3.2 GB), its experts' columns recorded."""
    import threading

    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import Model, RunCtx, tree_leaves
    from repro_torch.runtime import sharding
    from repro_torch.runtime.model_axis import ModelAxis

    dev = dev or torch.device("cuda", torch.cuda.current_device())
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launched = collections.Counter()
    init_lock = threading.Lock()
    arms = [(a, DIST_TP_LAYERS, 2, DIST_TP_ARGV) for a in DIST_TP_ARCHS]
    arms.append(DIST_TP_LOCAL + (DIST_TP_LOCAL_ARGV,))
    try:
        for arch, layers, msize, argv in arms:
            args = ltrain.parse_args(["--arch", arch] + argv)
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_config(arch), num_layers=layers)
            tokens, labels = (torch.from_numpy(a).to(dev, torch.int64)
                              for a in SyntheticLM(
                                  cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed).batch_at(0))

            def timed(fn):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                end.synchronize()
                return out, start.elapsed_time(end)

            model = Model(cfg, RunCtx(act_dtype=torch.float32), device=dev)
            params = model.init_params(torch.Generator(device=dev).manual_seed(
                args.seed), master=True)
            with torch.no_grad():
                model.loss(params, tokens, labels)          # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                want, local_ms = timed(lambda: model.loss(params, tokens,
                                                          labels))
            torch.cuda.synchronize()
            local_peak = torch.cuda.max_memory_allocated()
            local_bytes = sum(t.numel() * t.element_size()
                              for t in tree_leaves(params))
            del params, model
            gc.collect()
            torch.cuda.empty_cache()
            rules = ltrain.fsdp_rules(cfg, 1, msize)

            def rank(comm):
                tp = ModelAxis(comm)
                gather = sharding.make_gather(
                    rules, LoopbackComm(1, device=dev), model=tp)
                m = Model(cfg, RunCtx(act_dtype=torch.float32, gather=gather,
                                      model=tp, vocab_shards=tp.size),
                          device=dev)
                with init_lock:
                    p = m.init_params(torch.Generator(
                        device=dev).manual_seed(args.seed), master=True)
                    torch.cuda.current_stream().synchronize()
                    torch.cuda.empty_cache()
                held = sum(t.numel() * t.element_size()
                           for t in tree_leaves(p))
                with torch.no_grad():
                    m.loss(p, tokens, labels)                # warm-up
                # the peak from here: both ranks' parameters drawn
                comm._tw.barrier.wait()
                if comm.rank == 0:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    kops.reset_launch_counts()
                comm._tw.barrier.wait()
                with torch.no_grad():
                    loss, ms = timed(lambda: m.loss(p, tokens, labels))
                return float(loss), ms, held

            t1 = time.perf_counter()
            with expert_widths() as columns:
                out = ThreadWorld(torch, msize, 1, dev).run(rank)
            counts = kops.launch_counts()
            torch.cuda.synchronize()
            tp_peak = torch.cuda.max_memory_allocated()
            want = float(want)
            losses = [o[0] for o in out]
            rel = max(abs(x - want) for x in losses) / abs(want)
            scans = counts.get("selective_scan", 0)
            launched["selective_scan"] += scans
            emit({"phase": "dist_tp_forward", "arch": arch,
                  "layers": cfg.num_layers, "d_model": cfg.d_model,
                  "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                  "d_inner": cfg.d_inner if cfg.ssm_state else 0,
                  "vocab": cfg.vocab_size, "seq": args.seq,
                  "batch": args.batch, "mesh": f"1x{msize}",
                  "comm": f"ThreadWorld({msize}, 1): {msize} threads, one "
                          "stream each, as the model group; LoopbackComm(1) "
                          "as each data group",
                  "experts": cfg.num_experts, "ep_mode": rules.ep_mode,
                  "experts_and_columns_run": sorted(columns),
                  "act_dtype": "float32", "tf32": False,
                  "losses": losses, "local_loss": want,
                  "max_rel_err": rel, "tol": DIST_TP_TOL,
                  "b9_launches": scans,
                  "tp_ms_by_rank": [o[1] for o in out],
                  "local_ms": local_ms,
                  "peak_allocated_bytes": {"ranks": tp_peak,
                                           "local": local_peak},
                  "param_bytes": {"rank": [o[2] for o in out],
                                  "local": local_bytes},
                  "wall_s": {"local": round(t1 - t0, 1),
                             "tp": round(time.perf_counter() - t1, 1)},
                  "card": card})
            check(len(set(losses)) == 1, f"dist_tp_forward {arch}: the "
                  f"model ranks computed the losses {losses}")
            check(rel <= DIST_TP_TOL, f"dist_tp_forward {arch}: the "
                  f"1x{msize} loss {losses[0]} is {rel} apart from the local "
                  f"{want}")
            if cfg.is_moe and cfg.num_experts < msize:
                check(not rules.ep_mode and columns == {
                    (cfg.num_experts, cfg.d_ff // msize)},
                      f"dist_tp_forward {arch}: the experts ran "
                      f"{sorted(columns)} (experts, columns), not every "
                      f"expert on d_ff/{msize}")
            if cfg.ssm_state:
                check(scans == msize * cfg.num_layers, f"dist_tp_forward "
                      f"{arch}: B9 launched {scans} times, not once a "
                      f"layer a rank ({msize * cfg.num_layers})")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return dict(launched)


def b8_partial_line(torch, q, k, v, lengths):
    """B8's partial entry on a 1x2 rank's ring block: out and lse against
    the plain version at 2e-4, out bit for bit the whole entry's on the
    lanes with slots; timed beside the plain version and SDPA on the
    block (which returns no log-sum-exp: the merge could not use it), and
    the merge of two such partials (``merge_partials``, the collective
    excluded).  The bound: the attended K/V read once, q and lengths
    read, out and lse written; a dot and an accumulate of D per (query
    head, attended slot).  Emits the kernel line."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.runtime.model_axis import merge_partials
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out, lse = kops.decode_attention_partial(q, k, v, lengths)
    want, want_lse = kref.decode_attention_partial_ref(q, k, v, lengths)
    err = max(float((out.float() - want).abs().max()),
              float((lse - want_lse).abs().nan_to_num(0.0).max()))
    check(torch.allclose(out.float(), want, **MODEL_TOL)
          and torch.allclose(lse, want_lse, **MODEL_TOL),
          f"decode_attention_partial differs from its plain version: {err}")
    live = lengths > 0
    check(torch.equal(out[live], kops.decode_attention(q, k, v, lengths)[
        live]), "decode_attention_partial's out is not the whole entry's")
    attended = torch.clamp(lengths, min=0, max=s)
    mask = (torch.arange(s, device=q.device)[None, :]
            < attended[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                              attn_mask=mask, enable_gqa=True)
    other = (out.flip(0), lse.flip(0))
    n = int(attended.sum())
    res = dict(max_abs_err=err,
               ms=cuda_ms(torch, lambda: kops.decode_attention_partial(
                   q, k, v, lengths)),
               plain_ms=cuda_ms(torch, lambda: kref.
                                decode_attention_partial_ref(q, k, v,
                                                             lengths)),
               library_ms=cuda_ms(torch, sdpa),
               merge_ms=cuda_ms(torch, lambda: merge_partials(
                   [out, other[0]], [lse, other[1]])),
               bound=bound(2 * n * hkv * d * k.element_size()
                           + 2 * b * h * d * q.element_size() + 4 * b * h
                           + 4 * b, flops=4.0 * n * h * d))
    emit({"phase": "kernel", "name": "decode_attention_partial",
          "max_abs_err": res["max_abs_err"], "ms": res["ms"],
          "plain_ms": res["plain_ms"], "library_ms": res["library_ms"],
          "library": "scaled_dot_product_attention on the block, no lse",
          "merge_ms": res["merge_ms"], "bound_ms": res["bound"][0],
          "bound_by": res["bound"][1], "group": h // hkv,
          "shape": f"q {tuple(q.shape)} {str(q.dtype)[6:]}, k/v "
                   f"{tuple(k.shape)} {str(k.dtype)[6:]}, {n} attended "
                   "slots (rank 0 of 1x2)"})
    check_bound("decode_attention_partial", res)
    return res


def phase_dist_tp_serve(torch, card, dev=None):
    """Serving over the model axis on the card, in three parts.

    1. launch.serve --mesh 1x1 in a one-process NCCL group (the DxM path:
       the serve rules, the cache blocks, every model-axis collective over
       one rank) beside --mesh local, llama3-8b at its published widths,
       the serve cell's engine settings with the requests and the depth
       cut (DIST_TP_SERVE_1X1): the tokens, and one more decode step's
       logits, bit for bit; B8's whole entry launched once a layer and
       decode tick.  Then the same on a 1x1x1 pod x data x model mesh (a
       launch.mesh.Mesh as args.mesh), bit for bit too.
    2. --mesh 1x2 played by two threads (ThreadWorld(2, 1) as the model
       group, LoopbackComm(1) as each data group, each thread its own
       engine on its own stream) beside --mesh local, float32 and TF32
       off, llama3-8b and mixtral-8x22b at their published widths, a few
       layers (DIST_TP_SERVE_LAYERS), 8 requests over 4 slots: both ranks
       emit the local tokens, one more decode step's logits within
       DIST_TP_SERVE_TOL (relative L2) of the local step's and the same
       bits on both ranks, B8's partial entry launched layers x decode
       ticks x 2 (the whole entry never), a rank's parameter bytes about
       half the local ones, and the decode step's ms on each rank beside
       the local one.  Then DIST_TP_LOCAL_SERVE: mixtral-8x22b's 8 experts
       at 1x16 on 16 threads (the tp_local split, every rank all 8 experts
       on 1024 columns), one layer, 4 requests: the same checks, B8's
       partial entry 16 x layers x ticks, a rank's bytes about 1/16.
    3. The kernel line of B8's partial entry on rank 0's ring block of
       llama3-8b's first layer (b8_partial_line), and the bytes a rank
       would hold at 1x8 of the published mixtral-8x22b and
       llama-3.2-vision-90b under the serve rule at this card's limit.
    Returns (launch counts, the kernel line's numbers)."""
    import threading

    from repro_torch.comm.communicator import LoopbackComm
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as lserve
    from repro_torch.models.transformer import RunCtx, tree_leaves
    from repro_torch.runtime import sharding

    dev = dev or torch.device("cuda", torch.cuda.current_device())
    launched = collections.Counter()

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def timed(fn, iters=5):
        fn()
        torch.cuda.current_stream().synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / iters

    # 1. --mesh 1x1 against --mesh local, bf16
    t0 = time.perf_counter()
    arch, layers, more = DIST_TP_SERVE_1X1
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    ctx = RunCtx(act_dtype=torch.bfloat16)
    runs = {}
    for spec in ("local", "1x1", "1x1x1"):
        args = lserve.parse_args(SERVE_ARGV + more + [
            "--mesh", "1x1" if spec == "1x1x1" else spec])
        if spec == "1x1x1":
            args.mesh = mesh_mod.Mesh((1, 1, 1), POD_AXES)
        with (nccl_group(torch) if spec != "local"
              else contextlib.nullcontext()):
            engine = lserve.make_engine(cfg, ctx, args)
            kops.reset_launch_counts()
            report = engine.run()
            counts = kops.launch_counts()
            logits = engine.model.decode_step(engine.params, engine.cache,
                                              engine._tokens)[0]
            torch.cuda.synchronize()
        runs[spec] = (report, counts, logits)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    (rep, counts, logits), (rep1, counts1, logits1) = runs["local"], \
        runs["1x1"]
    rep3, counts3, logits3 = runs["1x1x1"]
    ticks = len(rep1.tick_seconds)
    launched["decode_attention"] += counts1["decode_attention"] \
        + counts3["decode_attention"]
    emit({"phase": "dist_tp_serve", "part": "1x1", "arch": arch,
          "layers": layers, "d_model": cfg.d_model, "dtype": "bfloat16",
          "argv": SERVE_ARGV + more,
          "cut": "requests 16 -> 4, layers 32 -> 4",
          "comm": "a one-process NCCL group (world 1) as the 1x1 mesh",
          "completed": len(rep1.completed), "tokens": rep1.total_tokens,
          "tokens_equal_local": rep1.outputs == rep.outputs,
          "logits_bit_equal_local": bool(torch.equal(logits1, logits)),
          "decode_ticks": ticks,
          "decode_attention_launches": counts1["decode_attention"],
          "decode_tokens_per_s": {"1x1": rep1.tokens_per_s,
                                  "local": rep.tokens_per_s,
                                  "1x1x1": rep3.tokens_per_s},
          "pod_1x1x1": {"tokens_equal_local": rep3.outputs == rep.outputs,
                        "logits_bit_equal_local": bool(torch.equal(
                            logits3, logits)),
                        "decode_attention_launches":
                            counts3["decode_attention"]},
          "wall_s": round(time.perf_counter() - t0, 1), "card": card})
    check(len(rep1.completed) == int(more[1]), "dist_tp_serve 1x1: "
          f"{len(rep1.completed)} requests completed")
    check(rep1.outputs == rep.outputs, "dist_tp_serve: --mesh 1x1 emitted "
          "other tokens than --mesh local")
    check(torch.equal(logits1, logits), "dist_tp_serve: --mesh 1x1's "
          "decode logits are not --mesh local's bit for bit")
    check(counts1["decode_attention"] == layers * ticks,
          f"dist_tp_serve 1x1: B8 launched {counts1['decode_attention']} "
          f"times in {ticks} ticks of {layers} layers")
    check(rep3.outputs == rep.outputs and torch.equal(logits3, logits)
          and counts3["decode_attention"] == layers * len(rep3.tick_seconds),
          "dist_tp_serve: --mesh 1x1x1 is not --mesh local bit for bit "
          f"(B8 launched {counts3['decode_attention']} times)")
    del runs, logits, logits1, logits3

    # 2. --mesh 1x2 on two threads against --mesh local, float32
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = RunCtx(act_dtype=torch.float32)
    block = None
    init_lock = threading.Lock()
    arms = [(arch, layers, 2, DIST_TP_SERVE_ARGV)
            for arch, layers in DIST_TP_SERVE_LAYERS.items()]
    arms.append(DIST_TP_LOCAL_SERVE + (DIST_TP_LOCAL_SERVE_ARGV,))
    try:
        for arch, layers, msize, more_argv in arms:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_config(arch), num_layers=layers)
            argv = ["--arch", arch] + more_argv
            local = lserve.make_engine(cfg, ctx, lserve.parse_args(argv))
            rep = local.run()
            want, local_ms = timed(lambda: local.model.decode_step(
                local.params, local.cache, local._tokens)[0])
            local_bytes = nbytes(local.params)
            del local
            gc.collect()
            torch.cuda.empty_cache()
            args = lserve.parse_args(argv + ["--mesh", f"1x{msize}"])
            shared = {}

            def rank(comm):
                grid = mesh_mod.Grid(0, comm.rank, LoopbackComm(1, device=dev),
                                     comm)
                with init_lock:
                    eng = lserve.make_engine(cfg, ctx, args, grid=grid)
                    torch.cuda.current_stream().synchronize()
                    torch.cuda.empty_cache()
                comm._tw.barrier.wait()
                if comm.rank == 0:
                    torch.cuda.synchronize()
                    kops.reset_launch_counts()
                comm._tw.barrier.wait()
                out = eng.run()
                comm._tw.sync()
                comm._tw.barrier.wait()
                if comm.rank == 0:
                    shared["counts"] = kops.launch_counts()
                comm._tw.barrier.wait()
                got, ms = timed(lambda: eng.model.decode_step(
                    eng.params, eng.cache, eng._tokens)[0])
                kept = None
                if comm.rank == 0 and arch == "llama3-8b":
                    lc = eng.cache["layers"]
                    n = lc["k"].shape[2]
                    pos = eng.cache["pos"]
                    kept = (lc["k"][0].clone(), lc["v"][0].clone(),
                            torch.clamp(torch.clamp(pos + 1, max=eng.cache_len),
                                        0, n).to(torch.int32))
                return (out, got, ms, nbytes(eng.params),
                        tuple(eng.cache["layers"]["k"].shape), kept)

            with expert_widths() as columns:
                out = ThreadWorld(torch, msize, 1, dev).run(rank)
            counts = shared["counts"]
            ticks = len(out[0][0].tick_seconds)
            rels = [rel_l2(torch, o[1], want) for o in out]
            launched["decode_attention_partial"] += counts[
                "decode_attention_partial"]
            if out[0][5] is not None:
                block = out[0][5]
            emit({"phase": "dist_tp_serve", "part": f"1x{msize}",
                  "arch": arch, "layers": layers, "d_model": cfg.d_model,
                  "heads": [cfg.num_heads, cfg.num_kv_heads],
                  "experts": cfg.num_experts, "vocab": cfg.vocab_size,
                  "argv": argv, "mesh": f"1x{msize}", "dtype": "float32",
                  "tf32": False,
                  "comm": f"ThreadWorld({msize}, 1): {msize} threads, one "
                          "stream each, as the model group; LoopbackComm(1) "
                          "as each data group",
                  "experts_and_columns_run": sorted(columns),
                  "ring_block": list(out[0][4]),
                  "completed": [len(o[0].completed) for o in out],
                  "tokens_equal_local": [o[0].outputs == rep.outputs
                                         for o in out],
                  "logits_rel_l2_vs_local": rels, "tol": DIST_TP_SERVE_TOL,
                  "decode_ticks": ticks,
                  "partial_launches": counts["decode_attention_partial"],
                  "whole_launches": counts["decode_attention"],
                  "decode_step_ms": {"ranks": [o[2] for o in out],
                                     "local": local_ms},
                  "param_bytes": {"ranks": [o[3] for o in out],
                                  "local": local_bytes},
                  "wall_s": round(time.perf_counter() - t0, 1),
                  "card": card})
            for o in out:
                check(o[0].outputs == rep.outputs, f"dist_tp_serve {arch}: "
                      "a 1x2 rank emitted other tokens than --mesh local")
            check(all(torch.equal(o[1], out[0][1]) for o in out),
                  f"dist_tp_serve {arch}: the model ranks' logits differ")
            check(max(rels) <= DIST_TP_SERVE_TOL, f"dist_tp_serve {arch}: "
                  f"the 1x{msize} logits are {rels} apart from the local "
                  "ones")
            check(counts["decode_attention_partial"]
                  == msize * layers * ticks
                  and counts["decode_attention"] == 0,
                  f"dist_tp_serve {arch}: B8's partial entry launched "
                  f"{counts['decode_attention_partial']} times (the whole "
                  f"{counts['decode_attention']}), not {msize} x {layers} "
                  f"layers x {ticks} ticks")
            check(all(abs(o[3] / local_bytes - 1 / msize) < 0.05
                      for o in out),
                  f"dist_tp_serve {arch}: a rank holds "
                  f"{[o[3] for o in out]} bytes of {local_bytes}")
            if cfg.num_experts and cfg.num_experts < msize:
                check(columns == {(cfg.num_experts, cfg.d_ff // msize)},
                      f"dist_tp_serve {arch}: the experts ran "
                      f"{sorted(columns)} (experts, columns), not every "
                      f"expert on d_ff/{msize}")
            del out, want
            gc.collect()
            torch.cuda.empty_cache()

        # 3. the kernel line on rank 0's block of the first layer
        k, v, lengths = block
        cfg = get_config("llama3-8b")
        q = torch.randn((k.shape[0], cfg.num_heads, cfg.head_dim),
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED), device=dev)
        res = b8_partial_line(torch, q, k, v, lengths)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    at8 = {}
    for arch in ("mixtral-8x22b", "llama-3.2-vision-90b"):
        cfg = get_config(arch)
        rules = sharding.serve_rules(cfg, mesh_mod.Mesh((1, 8), (
            "data", "model")), device=dev)
        at8[arch] = {"rank_bytes": sharding.serving_bytes(cfg, rules),
                     "whole_bytes": sharding.serving_bytes(cfg),
                     "zero_inference": rules.fsdp_axes is not None}
    emit({"phase": "dist_tp_serve", "part": "bytes_at_1x8",
          "limit_bytes": sharding.serve_limit(dev),
          "by_param_specs": at8, "card": card})
    emit(pod_bytes_line(torch, dev, card))
    return dict(launched), res


def pod_bytes_line(torch, dev, card) -> dict:
    """The bytes a rank would hold of the published mixtral-8x22b at
    ``pod`` and ``multipod``, each leaf's block by param_specs: training
    (launch.train's rules) at 12 bytes a parameter (float32 weights, m
    and v), multipod also under hierarchical_rules (m and v over pod x
    data), and serving (two bytes a parameter) under the serve rule at
    this card's limit and at the reference's SERVE_RESIDENCY_LIMIT."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import Model, RunCtx, tree_leaves
    from repro_torch.runtime import sharding

    cfg = get_config("mixtral-8x22b")
    with FakeTensorMode():
        params = Model(cfg, RunCtx(), device="cpu").init_params(
            torch.Generator())
    leaves = tree_leaves(params)

    def held(rules, weight: int, state: int = 0) -> int:
        opt = rules if rules.opt_fsdp_axes is None else dataclasses.replace(
            rules, fsdp_axes=rules.opt_fsdp_axes)
        total = 0
        for r, nbytes in ((rules, weight), (opt, state)):
            if nbytes:
                specs = tree_leaves(sharding.param_specs(r, params))
                total += sum(nbytes * math.prod(sharding.block_shape(
                    r, sp, t.shape)) for sp, t in zip(specs, leaves))
        return total

    out = {"phase": "dist_tp_serve", "part": "bytes_at_pod",
           "arch": cfg.name,
           "params": sum(math.prod(t.shape) for t in leaves)}
    for spec in ("pod", "multipod"):
        mesh = mesh_mod.make_mesh(spec)
        row = {"mesh": list(mesh.axis_sizes),
               "train_12B": held(ltrain.mesh_rules(cfg, mesh), 4, 8)}
        if "pod" in mesh.shape:
            row["train_12B_opt_fsdp_axes"] = held(
                ltrain.hierarchical_rules(cfg, mesh), 4, 8)
        for name, limit in (("serve_card_limit", None),
                            ("serve_reference_limit",
                             sharding.SERVE_RESIDENCY_LIMIT)):
            rules = sharding.serve_rules(cfg, mesh, limit=limit, device=dev)
            row[name] = {"bytes": held(rules, 2),
                         "fsdp_axes": rules.fsdp_axes}
        out[spec] = row
    out["limit_bytes"] = sharding.serve_limit(dev)
    out["card"] = card
    return out


def phase_train_ssm_bf16(torch, card, f32_ms):
    """falcon-mamba-7b as train_ssm (TRAIN_SSM_LAYERS of its 64 layers, its
    settings) with the reference's bf16 scan payload
    (``launch.train.setup(ssm_scan_dtype=bfloat16)``): one warm-up and
    TRAIN_SSM_BF16_TIMED timed steps, no profiled one; B9b launched layers
    x microbatches x 2 a step and B9b′ layers x microbatches, B9, B9′ and
    every plain scan never.  The warm-up's first checkpointing forward is
    checked on its inputs (scan_bf16_line with the checkpointing entry's
    time and bound, its outputs held against a new launch), and its first
    backward gives the kernel line ``selective_scan_bf16_bwd``; its ms a
    step beside train_ssm's (``f32_ms``, the float32 payload in the same
    call)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import selective_scan as b9
    plain_names = ("selective_scan_ref", "selective_scan_bwd_ref",
                   "selective_scan_bf16_states_ref",
                   "selective_scan_bf16_bwd_ref")

    @contextlib.contextmanager
    def watch():
        with contextlib.ExitStack() as stack:
            plains = [stack.enter_context(held_calls(kref, n))
                      for n in plain_names]
            fwd = stack.enter_context(held_calls(
                b9, "selective_scan_bf16_ckpt", (0,)))
            bwd = stack.enter_context(held_calls(
                b9, "selective_scan_bf16_bwd", (0,)))
            yield plains, fwd, bwd

    timed = TRAIN_SSM_BF16_TIMED
    cfg, counts, seen, fields = train_phase(
        torch, "train_ssm_bf16", TRAIN_SSM_ARGV, TRAIN_SSM_LAYERS, timed,
        watch, profiled=False, ssm_scan_dtype=torch.bfloat16)
    plains, fwd, bwd = seen
    per_step = cfg.num_layers * fields["accum"]
    want = {"selective_scan_bf16": 2 * per_step * (1 + timed),
            "selective_scan_bf16_bwd": per_step * (1 + timed),
            "selective_scan": 0, "selective_scan_bwd": 0}
    got = {k: counts[k] for k in want}
    check(got == want, f"train_ssm_bf16: launched {got} in {1 + timed} "
          f"steps of {cfg.num_layers} layers x {fields['accum']} "
          f"microbatches, not {want}")
    plain_calls = {n: h.calls for n, h in zip(plain_names, plains)}
    check(not any(plain_calls.values()),
          f"train_ssm_bf16: a plain scan ran on the card path: {plain_calls}")
    check(0 in fwd and 0 in bwd, "train_ssm_bf16: no held B9b/B9b′ call")
    t0 = time.perf_counter()
    fargs, fout = fwd.pop(0)
    ckpt = scan_bf16_line(torch, "selective_scan_bf16_train_fwd", fargs,
                          held_out=fout, ckpt=True)
    (x, dt, bm, cm, a, hck, dy), grads = bwd.pop(0)
    res = scan_bf16_bwd_line(torch, "selective_scan_bf16_bwd",
                             (x, dt, bm, cm, a), dy, held=(hck, grads))
    res["ckpt_forward"] = {k: ckpt[k] for k in ("max_abs_err", "ms",
                                                 "plain_ms")}
    res["ckpt_forward"].update(bound_ms=ckpt["bound"][0],
                               bound_by=ckpt["bound"][1])
    del seen, fwd, bwd, fargs, fout, x, dt, bm, cm, a, hck, dy, grads
    gc.collect()
    torch.cuda.empty_cache()
    fields["wall_s"]["kernel_lines"] = round(time.perf_counter() - t0, 1)
    emit({**fields, "d_inner": cfg.d_inner, "state": cfg.ssm_state,
          "scan_payload": "bfloat16", "f32_payload_ms_per_step": f32_ms,
          "launches": got, "plain_scan_calls": plain_calls, "card": card})
    return got, res


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


def only_dist_per_batch(torch, card) -> None:
    """``--only dist_per_batch``: the phase and the two phases whose
    loopback runs it holds its outputs against (moe_serve, which serves
    its requests over the DistComm too, and dynamic_exchange), after the
    calibration line; no kernels line."""
    from repro_torch.comm.communicator import LoopbackComm

    hw = phase_calibration(torch, LoopbackComm(P), card)
    phase_moe_serve(torch, card, hw)
    gc.collect()
    torch.cuda.empty_cache()
    _, _, twins = phase_dynamic_exchange(torch, card)
    phase_dist_per_batch(torch, twins, hw, card)


def main() -> None:
    import torch
    # --only dist_consumers / dist_per_batch: the phase and the phases
    # whose loopback runs it holds its outputs against, no kernels line
    only = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--only" \
        else None
    if sys.argv[1:] and only not in ("dist_consumers", "dist_per_batch",
                                     "dist_train", "dist_tp_serve"):
        fail("usage: python3 chip_smoke.py [--only dist_consumers|"
             "dist_per_batch|dist_train|dist_tp_serve]")
    alone = only == "dist_consumers"
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
    if only in ("dist_per_batch", "dist_train", "dist_tp_serve"):
        if only == "dist_per_batch":
            only_dist_per_batch(torch, card)
        elif only == "dist_tp_serve":
            phase_dist_tp_serve(torch, card)
        else:
            phase_dist_train(torch, card)
            gc.collect()
            torch.cuda.empty_cache()
            phase_dist_tp_forward(torch, card)
        emit({"ok": True, "only": only,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}})
        return

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
    for strategy in STRATEGIES if not alone else ():
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
    counts, rows, results = {}, [], {}
    if not alone:
        results = phase_kernels(torch, matrix, x_host, engines, y_ref)
        results.update(phase_push_kernels(torch, matrix, x_host, t_engines,
                                          probes))
        results.update(phase_stencil_kernel(torch, comm.device))
        results.update(phase_decode_attention_kernel(torch, comm.device))
        results.update(phase_selective_scan_kernel(torch, comm.device))
        counts, measured = phase_main_path(torch, engines, x_host, y_ref,
                                           card)
        phase_auto_forward(torch, matrix, comm, engines, x_host, hw,
                           measured, card)
        rows = path_rows("forward", engines, measured, hw)
        dist_counts = phase_dist_main_path(torch, matrix, base, engines,
                                           x_host, card)
        for k in FORWARD_KERNELS:
            counts[k] += dist_counts[k]
    # the loopback twins of dist_consumers' cases, from the three phases
    # that run them
    twins = {}
    t_counts, measured = phase_transposed(torch, t_engines, x_host, y_t_ref,
                                          card, twins)
    counts.update({k: v for k, v in t_counts.items() if k in PUSH_KERNELS})
    rows += path_rows("transposed", t_engines, measured, hw)
    del engines, t_engines
    torch.cuda.empty_cache()
    h_counts, h_rows, heat = phase_heat2d(torch, comm, hw, card, twins)
    counts["stencil2d"] = h_counts["stencil2d"]
    rows += h_rows
    torch.cuda.empty_cache()
    b = np.random.default_rng(SEED + 1).standard_normal(N).astype(
        np.float32)
    ne_rows, plans = phase_normal_equations(
        torch, comm, matrix, base, splan, x_host, b, hw, card, twins)
    rows += ne_rows
    torch.cuda.empty_cache()
    spmv = {"matrix": matrix, "x": x_host, "b": b, "base": base,
            "splan": splan, "plans": plans, "cache": True}
    for k, n in phase_dist_consumers(torch, spmv, heat, twins,
                                     card).items():
        counts[k] = counts.get(k, 0) + n
    del spmv, heat, plans, twins
    if alone:
        # a partial run says so in its last line
        emit({"ok": True, "only": "dist_consumers",
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}})
        return
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
    ssm_counts, results["selective_scan_bf16"] = phase_ssm_prefill(
        torch, card)
    counts["selective_scan"] += ssm_counts["selective_scan"]
    counts["selective_scan_bf16"] = ssm_counts["selective_scan_bf16"]
    gc.collect()
    torch.cuda.empty_cache()
    counts["decode_attention"] += phase_moe_serve(torch, card, hw)[
        "decode_attention"]
    gc.collect()
    torch.cuda.empty_cache()
    dyn_results, dyn_counts, dyn_twins = phase_dynamic_exchange(torch, card)
    results.update(dyn_results)
    counts.update(dyn_counts)
    for k, n in phase_dist_per_batch(torch, dyn_twins, hw, card).items():
        counts[k] += n
    del dyn_twins
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
    bf16_counts, results["selective_scan_bf16_bwd"] = phase_train_ssm_bf16(
        torch, card, results["selective_scan_bwd"]["step_ms"])
    counts["selective_scan_bf16"] += bf16_counts["selective_scan_bf16"]
    counts["selective_scan_bf16_bwd"] = bf16_counts["selective_scan_bf16_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_counts, _ = phase_train_hybrid(torch, card)
    for name in ("selective_scan", "selective_scan_bwd"):
        counts[name] = counts.get(name, 0) + ssm_counts[name] \
            + hybrid_counts[name]
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in phase_dist_train(torch, card).items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in phase_dist_tp_forward(torch, card).items():
        counts[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    tp_counts, results["decode_attention_partial"] = phase_dist_tp_serve(
        torch, card)
    for name, n in tp_counts.items():
        counts[name] = counts.get(name, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_twins(torch, card)
    phase_train_lm100m(torch, src.parent / "build" / "train_ckpt", card)

    kernels = []
    for name, res in results.items():
        source, replaces = SOURCE[res.get("kernel", name)]
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
