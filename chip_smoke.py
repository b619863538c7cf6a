#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (motionbert_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit code:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; exits non-zero when torch sees no CUDA device.
  2. build: nvcc compiles ops/csrc/*.cu from this checkout.
  3. kernels: every CUDA kernel of the serving path (the pair B1 and the
     gated pair B2, temporal and spatial) against its plain PyTorch version
     at the flagship shape (B 4, F 243, J 17, C 512, 8 heads, hidden 1024),
     bf16, twice for bitwise repeatability, with its time (one call, back to
     back, and the device's own from the profiler, by kernel), the plain
     version's, a one-library-call yardstick's with its device time, and
     the least time the card could take (bound); a call's profile must hold
     the GEMM engine, the tensor-core attention core and the LayerNorm rows
     and no WMMA GEMM or CUDA-core attention kernel.
  4. main path: MotionBERT.from_config on the flagship config with the trained
     anchor weights; flip-TTA lift and get_representation of a seeded
     (8, 243, 17, 3) batch through the kernels, held against the plain fp32
     path of the same model on the card; launch counts; clips/s.
  5. profile: one more lift under torch.profiler; device time by kernel.
  6. serving: MotionBERTServer answers concurrent requests of 243 and 81
     frames from several threads; each answer is held against a direct lift.
  7. backward kernels: the pair backward (plain and gated, temporal and
     spatial) at the phase-3 shape against its plain backward, per gradient
     tensor, twice for bitwise equality, with times (one call, back to back,
     and the device's own from the profiler, by kernel), bound and a
     library yardstick (PyTorch's own operators, forward plus autograd,
     with its device time); a call's profile must hold the GEMM engine and
     the tensor-core attention core and no WMMA GEMM or CUDA-core attention
     kernel.
  8. train step: the flagship pose3d training config with the anchor weights,
     a seeded (8, 243, 17, 3) batch and a smooth root-relative target; the
     first step's loss and gradients against the fp32 plain path (batch 4),
     then 10 AdamW steps through the kernels with the launch counts per step,
     ms per step, clips/s, peak memory, and one step under torch.profiler;
     then 3 steps at the config's own batch of 32 (132,192 token rows
     through B1-B3) from the anchor weights on one seeded batch: finite
     losses, the batch's loss falls, the same launches a step, ms per step
     on the device clock, peak memory, and one step under torch.profiler.
  9. driver: train_with_config on the synthetic smoke set at the flagship
     widths, 2 epochs with evaluation, then a resumed third epoch.
 10. q8 kernels: first the s8 engine alone (csrc/hopper_gemm_s8.cuh) at
     the W8A8 pair's four products on the phase-3 rows and at ragged
     shapes, against its plain twin (bit for bit but the fp32 GELU), twice
     for bitwise equality, with its device time and TOP/s; then the column
     quantiser (quant_cols_kernel, one launch a call) at a pair call's four
     weights and a stream call's eight, bf16, and the four in fp32, bit for
     bit its plain version, twice, with its time, device time, plain time
     and byte bound; then the W8A8
     pair (plain and gated, temporal and spatial) at the phase-3 shape
     against its plain version (a max-based bar and a relative-L2 bar that
     a moved rounding point fails), twice for bitwise equality, with its
     time (one call, back to back, and the device's own, split into the
     chain's kernels and the column quantiser's), bound, the plain
     version's time, a library yardstick (torch._int_mm products,
     PyTorch's own operators for the rest) with its device time, the bf16
     pair's time from the same run, and the cost of quant_cols; a call's
     profile must hold the quantisers, the s8 engine and the tensor-core
     core once a launch, no PyTorch operator and no kernel of the first
     design.
 11. q8 main path: MotionBERT.from_config with attn_impl="kernel_q8" and the
     anchor; a flip-TTA lift and a representation through the int8 kernels;
     launch counts (the column quantiser's among them); relative L2 error against the fp32 plain path beside
     the bf16 tier's; clips/s of both tiers; one q8 lift under the profiler,
     which must hold the s8 engine and the tensor-core core and no kernel
     of the first design.
 12. task gate: the H36M protocol on the synthetic smoke set with the anchor,
     for fp32 plain, bf16 kernels and q8 kernels; the q8 tier's MPJPE drift
     must stay within max(1 mm, 1 %) of the fp32 value.
 13. wild inference: a seeded Halpe-26 AlphaPose JSON through run_wild_pose
     in both tiers; shape, X3D.npy, root handling, and each clip against a
     direct lift.
 14. straight-through: the q8 Functions' backward against the bf16
     Functions', bit for bit, counted as backward-kernel launches.
 15. q8 serving: MotionBERTServer built with attn_impl="kernel_q8".
 16. block kernels: first the GEMM engine alone (csrc/hopper_gemm.cuh):
     each (layout, epilogue) pair the MLP chains launch, at its flagship
     shape and at ragged ones, and the pair backward's wider products (qkv,
     dh1, dWqkv), against the fp32 product rounded at the same point, twice
     for bitwise equality, with its device time and TFLOP/s; then the pair
     backward's tensor-core attention core alone (csrc/attention_tc.cuh),
     forward and backward, at groups of 1, 5, 16, 17, 100 and 243 rows,
     head dim 64 and 32, temporal and spatial, against the plain core (the
     max-based and the relative-L2 bar), twice for bitwise equality, and
     its device time at the phase-3 shape;
     then the standalone attention block (B4, temporal and spatial, every
     (use_ln, residual) pair) and MLP block (B6, the flags the model uses
     and both on) at the phase-3 shape against their plain versions (the
     max-based bar and a relative-L2 bar), twice for bitwise equality, with
     times (one call at a time, back to back, and the device's own from the
     profiler, by kernel), bound, the plain version's time and a library
     yardstick; a call's profile must hold the GEMM engine (and the
     tensor-core core) and nothing but the row passes and column sums
     beside them; the attention block also at head dim 32, without times.
 17. block backward kernels: the same for the two backward chains (B5, B7),
     per gradient tensor (the relative-L2 bar on B5's).
 18. drop-path training: the flagship built with drop_path_rate=0.1; the
     first step's loss and gradients in bf16 through the kernels against the
     fp32 plain path drawing the same masks; 10 AdamW steps with the launch
     counts per step (layer 0 on the pair path, layers 1-4 through the
     blocks), ms per step, clips/s, peak memory, a profiled step; steps with
     drop_rate=0.1 (every layer through the attention block, the MLP in
     plain PyTorch); an evaluation call that runs pairs only.
 19. pretraining: augment2d on a CUDA batch, then train_with_config on the
     synthetic pretraining set at the flagship widths through the kernels: a
     3D epoch, 2D epochs joining at epoch 1, a resumed third epoch.
 20. attention core (B8): st_attention, temporal and spatial, at F 1, 27
     and the phase-3 shape against its plain version (the max-based bar and
     a relative-L2 bar), twice for bitwise equality, and on slices of a
     packed projection equal to the contiguous call; at the phase-3 shape
     with times (one call, back to back, and device), bound, the plain
     version's time and a library yardstick (scaled_dot_product_attention
     on permuted copies) with its device time; a call's profile must be one
     tensor-core core launch; the StAttention backward against the fp32
     plain backward, per tensor.
 21. legacy attention modes at the flagship width (C 512, 8 heads, hidden
     1024): vanilla, series, parallel, coupling (batch 2), spatial, temporal
     and Block(stage_para, att_fuse=True) on a seeded (4, 243, 17, 512)
     input, bf16 through the kernels against the fp32 plain module, forward
     and one backward, with the launches of each.
 22. action training at the flagship widths: ActionNet from
     MB_train_NTU60_xsub.yaml (60 classes, hidden 2048); the first step's
     loss, logits and gradients against the bf16 and the fp32 plain path on
     the same dropout masks, at batch 4 and at the config's 32 x 2 persons
     (the head's BatchNorm on its running statistics), and the head in
     training mode on the card against the CPU; 5 two-group AdamW steps at
     the config's batch with ms per step, clips/s, peak memory and launches
     per step; BatchNorm statistics; a validate pass. Then the embed head of
     MB_train_NTU120_oneshot.yaml (clip 100, batch 32): 3 SupCon steps and
     validate_1shot on seeded anchors.
 23. action drivers: train.action.train_with_config on the synthetic action
     set at the flagship widths, 2 epochs then a resumed third; the one-shot
     driver on a one-shot pickle this phase writes, 1 epoch then a resumed
     second.
 24. stream kernels (B10): the four stream functions (bf16 and W8A8,
     ungated ("s","t") and gated ("t","s")) at the phase-3 shape against
     their plain versions (the max-based and the relative-L2 bar), twice for
     bitwise repeatability and bit for bit against the ported pair chain
     (B1 -> B1 / B2, B9 -> B9), with times (one call, back to back, and
     device), the chain's times in the same run, bound, the plain version's
     time and a library yardstick (each pair's PyTorch operators, twice)
     with its device time; a W8A8 call's profile must hold both chains'
     launches of the s8 engine, the tensor-core core and the quantisers
     and no kernel of the first design.
 25. stream main path: the anchor's (8, 243) flip-TTA lift and
     representation through attn_impl "kernel_stream" and "kernel_stream_q8",
     bit for bit equal to "kernel" and "kernel_q8", with launch counts and
     clips/s of both in turns; 8 requests served under "kernel_stream"; a
     flagship train step under "kernel_stream" whose loss and gradients equal
     the pair path's bit for bit, with its launch counts.
 26. mesh at the flagship widths: MeshRegressor from MB_train_h36m.yaml (dim
     512, depth 5, hidden 1024) on a seeded 6890-vertex body model, batch
     128 x 16 frames; the first step's loss, joints and gradients against
     the bf16 and the fp32 plain path on the same dropout masks (BatchNorm
     on running statistics), at batch 4 and 128; the head in training mode
     on the card against the CPU; 5 two-group AdamW steps with ms per step,
     clips/s, peak memory and launches per step; SMPL's share of a step; a
     profiled step; the flip-TTA eval step through "kernel" and
     "kernel_stream", bit for bit equal.
 27. mesh drivers: train.mesh.train_with_config on the synthetic mesh set at
     the flagship widths, 2 epochs then a resumed third; the wild-mesh
     command line on a seeded Halpe-26 JSON with --attn_impl pallas_stream.
 28. data parallel at the flagship widths (phase 8's config, anchor and
     seeded (8, 243) batch): (a) world size 1 under NCCL on a file store in
     this process, the DistributedDataParallel step's loss and every gradient
     bit for bit the unwrapped step's, the ms per step of both; (b) two
     ranks on the one card (gloo, both on cuda:0, 4 clips each of the same
     8), 3 AdamW steps with phase 18's drop-path and dropout rates (the
     world-size-invariant draws), the losses, the first step's gradients
     and the parameters after against (a)'s world-size-1 run at phase 8's
     bars, its ms per step (two ranks sharing one card: not a scaling
     figure); (c) the pose3d, action, one-shot and mesh drivers under
     torchrun --nproc_per_node 2 --device cuda:0 --dist_backend gloo on the
     synthetic smoke sets at the flagship widths, one epoch each, at once:
     rank 0's checkpoints and logs alone, no "module." key; then the pose3d
     checkpoint resumed at world size 1 for one more epoch.
 29. wild I/O and rendering: a seeded 1920 x 1080 mp4 of write_wild_json's
     300 frames (cv2.VideoWriter) and read_video_meta; the wild_pose command
     line with --vid_path and rendering, the flagship lift on the card with
     the anchor, X3D.mp4 read back (frames, size, fps); the wild_mesh command
     line the same way on the seeded 6890-vertex body model with 13,776
     seeded faces, mesh.mp4 read back; the renderer's frames per second for
     the 2D, 3D and mesh frames.
 30. tensor parallelism (ranks share one card: not a scaling figure): (a)
     the TP modes of the block kernels (B4_tp, B5_tp temporal and spatial,
     B6_tp, B7_tp) and the LayerNorm backward at the phase-3 rows on model
     rank 0's shards of 2 (Ci 256, 4 local heads, hidden slice 512) against
     their plain twins (phase 16/17's bars), twice for bitwise
     repeatability, with times (one call, back to back, device), bound,
     the plain twin's time and a library yardstick on the same shards; a
     call's profile must hold its chain's records and kernels (B4_tp its
     LayerNorm-in-product qkv, the split forward core on 243 frames and no
     row pass), and the forward and backward cores' grids;
     (b) phase 8's flagship with the anchor weights on a 1 x 2 grid (two
     ranks, gloo, cuda:0), batch 2 x 243: the flip-TTA lift against world
     size 1's kernels (largest difference, share of elements that differ),
     the first step's loss and gathered gradients and the parameters after
     3 AdamW steps against world size 1 at phase 8's and phase 28's bars,
     the launches of a step (the TP modes only: no pair kernel); (c) a 2 x 2
     grid (four ranks), one step against world size 1; (d) (b)'s
     checkpoint (written by rank 0 after its 3 steps) resumed at 1 x 1 and
     2 x 1 for one more step against (b)'s own next step; (e) (b)'s first
     step under core.profiling.trace, rank 0's Chrome trace read back for
     its CUDA kernels and its annotate region.
 31. tensor parallelism beyond the pose3d pairs (ranks share one card):
     (a) the W8A8 pair on shards (B9_tp), temporal and spatial, gated and
     not, at the phase-3 rows on model rank 0's shards of 2 (Ci 256, 4
     local heads, hidden slice 512) against its plain twin at phase 10's
     bars, twice for bitwise repeatability, with times (one call, back to
     back, device, split into the stages and the column quantisers),
     bound, the plain twin's time and a library yardstick (torch._int_mm
     and scaled_dot_product_attention on the same shards); a call's
     profile must hold its 13 kernel records by name (no row-maximum pass,
     no dequantising pass before the LayerNorm, no PyTorch operator); the
     split column quantiser at the shards' wproj and w2 against its plain
     version with times, and over 2 and 4 ranks' slices bit for bit the
     whole weights' quantiser;
     (b) one spawn of two gloo ranks on cuda:0, a 1 x 2 grid at the
     flagship widths (dim 512, depth 5, 8 heads; the backbones with the
     anchor weights): one step each of the action model (classifier,
     dropout 0.5, 1 x 2 x 243), the one-shot model (embedding, SupCon, 4 x
     2 x 100), the mesh model (dropout 0.1, 2 x 16 frames; the heads'
     BatchNorms on their running statistics, as in phases 22 and 26) and
     phase 8's pose3d model with drop-path 0.1 and dropout 0.1 (2 x 243),
     against world size 1 at phase 28 / 30's bars (loss, gradient cosine,
     the parameters after the step; each gradient tensor to the larger of
     phase 8's bar and twice the bf16 plain path's distance from the
     kernels, phase 26's witness rule: the mesh loss sums cancelling frame
     differences); the kernel_q8 and kernel_stream_q8 lifts bit for bit
     the world-size-1 lifts, the kernel_stream lift at phase 30's lift
     bar; the launches of each (B9_tp and the TP modes, no B9 and no B10
     on the grid); (c) the 1 x 2 action checkpoint resumed at 1 x 1
     against the grid's own next step.
 32. anchor (only with --phases anchor): train.anchor's two phases, each a
     process of its own: the flagship trained on the learnable synthetic
     H36M mirror with the JAX anchor's recipe (batch 32, 60 epochs), stopped
     after 20 and resumed, its trace held to data/anchors/anchor_trace.json.
Phases 10-15 run after phase 6, phases 16-19 after phase 9, phases 20-23
after phase 19, phases 24-27 after phase 23, phases 28-31 after phase 27.
Then a JSON line of per-kernel numbers, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --phases pairs
    python3 chip_smoke.py --phases train
    python3 chip_smoke.py --phases q8
    python3 chip_smoke.py --phases blocks
    python3 chip_smoke.py --phases action
    python3 chip_smoke.py --phases mesh
    python3 chip_smoke.py --phases dist
    python3 chip_smoke.py --phases render
    python3 chip_smoke.py --phases tp
    python3 chip_smoke.py --phases tp2
    python3 chip_smoke.py --phases anchor [--epochs 60] [--mid 20]

run only phases 1, 2, 3 and 24; 1, 2, the engine and core phases of 16, 7
and 8; 1, 2 and 10-15; 1, 2 and 16-19; 1, 2 and 20-23; 1, 2 and 24-27;
1, 2 and 28; 1, 2 and 29; 1, 2 and 30; 1, 2 and 31; or 1, 2 and 32 (while
working on them), and print no last line.

    python3 chip_smoke.py --baseline ROOT [--phases ...]

also builds the pair, W8A8 pair, block, pair backward, attention core and
stream sources of the checkout at ROOT (the parent's, unpacked with git
archive) after phase 2: holds this checkout's bf16 pairs (B1, B2), bf16
streams, pair backward (B3) and MLP blocks (B6, B7) against that build,
bit for bit, and the s8 engine against that checkout's first-design int8
GEMM (gemm_q8_kernel, where it has one, built behind a C entry generated
here) on the same int8 operands at the W8A8 pair's four products, bit for
bit, with both device times in turns; holds this build's attention blocks
(B4, B5, every flag pair), bf16 pairs, W8A8 pairs (B9), streams (B10,
both tiers) and attention core (B8) to their plain versions' bars and
times both builds' in turns (other, this, this, other) at the
phase-16/17, phase-10, phase-3, phase-24 and phase-20 inputs, the device
time by kernel beside; holds B9, B10 W8A8 and B9_tp (phase 31 (a)'s
inputs) to the other build's outputs bit for bit and times B9_tp in turns
too (an other checkout without the column-quantiser kernels quantises its
weights with PyTorch's operators, as it did, and runs its own B9_tp
entries); with --phases tp instead, builds only that checkout's
block library and holds B4_tp-B7_tp (phase 30 (a)'s inputs) to it bit for
bit and times them in turns; runs phase 8's train steps and phase 18's
drop-path steps in turns with the other build's pair or block library
swapped in, then profiles one step of each; and times phase 4's lift and
phase 11's W8A8 lift in turns the same way. The in-turn times join the
kernels line.

Imports nothing of JAX or of the JAX package motionbert_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "pose3d", "MB_ft_h36m.yaml")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "pose3d", "MB_train_h36m.yaml")
SMOKE_CONFIG = os.path.join(ROOT, "configs", "pose3d",
                            "MB_train_synth_smoke.yaml")
PRETRAIN_CONFIG = os.path.join(ROOT, "configs", "pretrain",
                               "MB_pretrain_synth_smoke.yaml")
ACTION_CONFIG = os.path.join(ROOT, "configs", "action",
                             "MB_train_NTU60_xsub.yaml")
ONESHOT_CONFIG = os.path.join(ROOT, "configs", "action",
                              "MB_train_NTU120_oneshot.yaml")
ACTION_SMOKE_CONFIG = os.path.join(ROOT, "configs", "action",
                                   "MB_train_synth_smoke.yaml")
ANCHOR = os.path.join(ROOT, "data", "anchors", "flagship_synth_trained.npz")

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

KERNEL_TOL = 2e-2   # max|kernel - plain| / max|plain|, bf16 vs bf16
PATH_TOL = 2e-2     # max|bf16 kernels - fp32 plain| / max|fp32 plain|
# int8 kernel vs its plain version: the integer products are exact on both
# sides; what differs is bf16 rounding flips of qkv, attn and y (as for the
# bf16 pair) and single int8 steps where the card's rsqrtf / erff and a
# warp's summation order land an activation across a quantiser boundary
Q8_KERNEL_TOL = 2e-2
# the same comparison as a relative L2: measured 1.0e-3 to 1.5e-3 with 2-5 %
# of the outputs differing at all; a rounding point moved (LN output or
# GELU(z) through bf16, y left in fp32) measures 6e-3 to 1.8e-2 in the CPU
# tests, so this bar tells the two apart where the max-based one cannot
Q8_KERNEL_L2_TOL = 4e-3
# the W8A8 tier's gates, as the JAX package holds its own (bench.py):
# relative L2 of the lift against the fp32 plain path, and the drift of the
# H36M-protocol MPJPE against the fp32 plain path's
Q8_REL_L2_GATE = 0.05
Q8_MPJPE_GATE_MM = 1.0
Q8_MPJPE_GATE_REL = 0.01
# first train step, bf16 kernels vs fp32 plain: the cosine of all gradients
# as one vector, the loss (relative), and each tensor's max|d| / max|ref|.
# Two kinds of tensor get a wider bar: their gradient is a sum of bf16 terms
# that cancel, so its relative error is the terms' rounding over a small net
# sum (temp_embed: the input stream's gradient summed over the batch and the
# 17 joints; the gate biases: dsg0 = -dsg1 on every row). Set from a chip
# run recorded in PERF.md: cosine 0.99977, worst 0.276 (temp_embed), then
# 0.167 (a gate bias), every other tensor <= 0.064.
GRAD_COSINE_MIN = 0.999
LOSS_TOL = 2e-2
GRAD_TENSOR_TOL = 0.1
CANCELLING_SUM_TOL = 0.5


def grad_tensor_tol(name: str) -> float:
    name = name.removeprefix("backbone.")    # ActionNet's backbone
    cancelling = name == "temp_embed" or (
        name.startswith("ts_attn.") and name.endswith(".bias"))
    return CANCELLING_SUM_TOL if cancelling else GRAD_TENSOR_TOL
B, FRAMES, J, C, HEADS, HIDDEN = 4, 243, 17, 512, 8, 1024
LIFT_BATCH = 8
TRAIN_BATCH, REF_BATCH, TRAIN_STEPS = 8, 4, 10
# steps at the training config's own batch (MB_train_h36m.yaml: 32)
SHIPPED_STEPS = 3
# a flagship train step's launches: 3 pairs and 1 gated pair a layer, each
# forward once and backward once
TRAIN_LAUNCHES = {"fused_pair_block": 15, "fused_gated_pair_block": 5,
                  "fused_pair_block_bwd": 15, "fused_gated_pair_block_bwd": 5}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of `runs` single-call CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms_back_to_back(fn, calls: int = 10, runs: int = 5) -> float:
    """ms per call of `calls` calls enqueued back to back between one pair
    of events (median of `runs`): the host runs ahead of the device, so this
    is the device's time per call where a single call's is partly the host's
    launch work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# the profiler's own kernels, launched first (device_rows leaves them out)
PRIMER_KERNEL, PRIMER_LAUNCHES = "spin_kernel", 64
DEVICE_MS_TRIES = 3


@contextlib.contextmanager
def card_profile():
    """torch.profiler over the host and the card, primed. On the card a
    profile can lose its first kernel records, more of them the longer the
    process has run, and now and then all of them, so PRIMER_LAUNCHES short
    spin kernels, run to their end, take their place before the work."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_LAUNCHES):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield prof


def device_ms(fn, records, calls: int = 10):
    """device_profile's time alone."""
    return device_profile(fn, records, calls)[0]


def device_profile(fn, records, calls: int = 10) -> tuple:
    """(ms, rows): device time per call of every kernel `fn` launches, from
    torch.profiler: the card's own time, free of the host's gaps, where
    back to back a host slower than a short kernel sets the pace. A profile
    that dropped records would undercount, so it must hold them all:
    `records` device records (kernels and fills) a call, where the caller
    knows them (the port's chains), or with None (a library call, whose
    kernels PyTorch picks) each kernel a whole multiple of `calls` times.
    A profile short of them is taken again, DEVICE_MS_TRIES times in all;
    then None, logged with the last profile's rows: the CUDA-event times
    beside it stand alone. rows: the last profile's (name, device ms,
    count) of each kernel, over all `calls` calls."""
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_MS_TRIES):
        with card_profile() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        seen = sum(n for _, _, n in rows)
        if records is None:
            whole = seen > 0 and all(n % calls == 0 for _, _, n in rows)
            want = f"a multiple of {calls} for each kernel"
        else:
            whole, want = seen == records * calls, str(records * calls)
        if whole:
            return sum(ms for _, ms, _ in rows) / calls, rows
    log(f"device_ms: {DEVICE_MS_TRIES} profiles of {calls} calls, the last "
        f"with {seen} device records, expected {want}; recorded as null: "
        + json.dumps([[key[:60], n] for key, _, n in rows]))
    return None, rows


def kernel_name(key: str) -> str:
    """A profile key's kernel name with its template arguments (the
    engine's layout and epilogue, the core's head dim and key tiles) and
    without its parameter list."""
    name = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.sub(r"\((?!anonymous).*$", "", name)[:72]


def by_kernel(rows, calls: int) -> dict:
    """Device ms per call of each kernel of a profile, by kernel_name."""
    out = {}
    for key, ms, _ in rows:
        name = kernel_name(key)
        out[name] = out.get(name, 0.0) + ms / calls
    return out


def block_records(kind: str, backward: bool, use_ln: bool) -> int:
    """Device records of one call of a block wrapper, from the chains in
    csrc/block_kernels.cu: the forward's products and the attention core,
    and the LayerNorm's rows when use_ln; in the backward a weight gradient
    and a column sum are two launches each (the fixed-chunk partials, the
    in-order pass), the LayerNorm adds its forward rows, an fp32 dh and its
    backward (one pass and the in-order sum of its parameter partials) in
    place of the bf16 dx, and without it the wrapper zeroes the two
    LayerNorm gradients (no_ln_grads). Another checkout's chains may launch
    otherwise."""
    if not backward:
        return 2 + int(use_ln) + int(kind == "attention")
    # recompute 1, two weight gradients 4, two column sums 4, dz / dattn 1,
    # dx 1; the attention core forward and backward 2 more
    base = 11 + (2 if kind == "attention" else 0)
    return base + (3 if use_ln else 2)


def timed(name: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------

def pair_inputs(seed: int, gated: bool, device) -> dict:
    """Flagship-shape pair inputs from a seeded numpy RNG; weights scaled by
    fan_in^-0.5 so each sub-block moves the stream by O(1)."""
    rs = np.random.RandomState(seed)

    def t(shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        a = rs.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    p = dict(
        x=t((B, FRAMES, J, C)),
        ln1_w=t((C,), 0.1, 1.0, torch.float32), ln1_b=t((C,), 0.1, 0.0, torch.float32),
        wqkv=t((3 * C, C), C ** -0.5), bqkv=t((3 * C,), 0.1),
        wproj=t((C, C), C ** -0.5), bproj=t((C,), 0.1),
        ln2_w=t((C,), 0.1, 1.0, torch.float32), ln2_b=t((C,), 0.1, 0.0, torch.float32),
        w1=t((HIDDEN, C), C ** -0.5), b1=t((HIDDEN,), 0.1),
        w2=t((C, HIDDEN), HIDDEN ** -0.5), b2=t((C,), 0.1))
    if gated:
        p["other"] = t((B, FRAMES, J, C))
        p["wg"] = t((2, 2 * C), (2 * C) ** -0.5)
        p["bg"] = t((2,), 0.1, 0.5)
    return p


PAIR_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_w",
             "ln2_b", "w1", "b1", "w2", "b2")


def pair_args(p: dict, gated: bool) -> list:
    args = [p["x"]] + ([p["other"]] if gated else []) \
        + [p[k] for k in PAIR_KEYS]
    return args + ([p["wg"], p["bg"]] if gated else [])


def pair_library(p: dict, gated: bool, scale: float, mode: str):
    """The same function from PyTorch's own operators (layer_norm, linear,
    scaled_dot_product_attention): a yardstick of speed the port never calls."""
    x = p["x"]
    Bx, Fx, Jx, Cx = x.shape
    d = Cx // HEADS
    h = F.layer_norm(x, (Cx,), p["ln1_w"].to(x.dtype), p["ln1_b"].to(x.dtype), 1e-6)
    qkv = F.linear(h, p["wqkv"], p["bqkv"]).reshape(Bx, Fx, Jx, 3, HEADS, d)
    perm = (0, 1, 3, 2, 4) if mode == "spatial" else (0, 2, 3, 1, 4)
    q, k, v = (qkv[:, :, :, i].permute(perm) for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    inv = [perm.index(i) for i in range(5)]
    o = o.permute(inv).reshape(Bx, Fx, Jx, Cx)
    y = x + F.linear(o, p["wproj"], p["bproj"])
    h2 = F.layer_norm(y, (Cx,), p["ln2_w"].to(x.dtype), p["ln2_b"].to(x.dtype), 1e-6)
    out = y + F.linear(F.gelu(F.linear(h2, p["w1"], p["b1"])), p["w2"], p["b2"])
    if gated:
        s = F.linear(torch.cat([p["other"], out], -1), p["wg"], p["bg"])
        a = torch.softmax(s.float(), -1).to(out.dtype)
        out = p["other"] * a[..., 0:1] + out * a[..., 1:2]
    return out


def pair_cost(mode: str, gated: bool) -> tuple:
    """(FLOPs, bytes) the pair function needs at the phase-3 shape: the four
    products and the attention core; x/other read once, out written once,
    weights read once."""
    M = B * FRAMES * J
    flops = 2 * M * (3 * C * C + C * C + 2 * C * HIDDEN)
    groups, n = (B * J, FRAMES) if mode == "temporal" else (B * FRAMES, J)
    flops += 4 * groups * n * n * C          # q.k^T and p.v over all heads
    nbytes = 2 * M * C * 2                   # x in, out back (bf16)
    nbytes += (3 * C * C + C * C + 2 * C * HIDDEN) * 2
    nbytes += (3 * C + C + HIDDEN + C) * 2 + 4 * C * 4
    if gated:
        flops += 2 * M * 2 * C * 2
        nbytes += M * C * 2 + 2 * 2 * C * 2 + 2 * 2
    return flops, nbytes


def pair_records(gated: bool) -> int:
    """Device records of one pair call, from the chain in
    csrc/pair_chain.cuh: two LayerNorm row passes, four products on the
    engine and the tensor-core core; the gated pair adds the gate."""
    return 7 + int(gated)


def stream_records(gated: bool, q8_tier: bool):
    """Device records of one stream call: both passes' chains and the gate
    (csrc/stream_kernels.cu); None in the W8A8 tier, whose call and the
    pair chain it is held against quantise their weights in one launch and
    in two (device_profile then takes every kernel a whole multiple of the
    calls)."""
    return None if q8_tier else 2 * pair_records(False) + int(gated)


# column-quantiser launches of a W8A8 pair call (ops/pair_q8.py _launch:
# its four weights) and of a W8A8 stream call (ops/fused_stream.py _launch:
# both pairs' eight)
Q8_WEIGHT_LAUNCHES = 1


def pair_q8_records(gated: bool) -> int:
    """Device records of one W8A8 pair call: the chain, from
    csrc/pair_q8_common.cuh's q8_pair_chain (two LayerNorm quantisers, two
    row quantisers, four products on the s8 engine and the tensor-core
    core; the gated pair adds the gate), and the column quantiser's launch
    before it."""
    return 9 + int(gated) + Q8_WEIGHT_LAUNCHES


def stream_q8_records(gated: bool) -> int:
    """Device records of one W8A8 stream call: both chains, the gate and
    the column quantiser's one launch for both pairs' weights."""
    return 2 * 9 + int(gated) + Q8_WEIGHT_LAUNCHES


# kernel-name fragments a bf16 pair call must launch, and those of the
# first design it must not (retired_kernels)
PAIR_KERNELS = ("hg_gemm_kernel", "attn_tc_fwd_kernel", "ln_fwd_rows_kernel")


def phase_kernels(fp) -> list:
    """B1 and B2, temporal and spatial, at the flagship shape against their
    plain versions, twice for bitwise repeatability, with times (one call,
    back to back, and the device's own from the profiler, by kernel), the
    bound, the plain version's time and the library yardstick with its
    device time. A call's profile must hold the engine, the tensor-core
    core and the LayerNorm rows (and the gate when gated) and no WMMA GEMM
    or CUDA-core attention kernel."""
    scale = (C // HEADS) ** -0.5
    dev = torch.device("cuda")
    records = []
    for name, wrapper, plain, gated, replaces, main_mode in (
            ("fused_pair_block", fp.fused_pair_block, fp.pair_block_plain,
             False, "motionbert_tpu/ops/fused_pair.py:175", "temporal"),
            ("fused_gated_pair_block", fp.fused_gated_pair_block,
             fp.gated_pair_block_plain, True,
             "motionbert_tpu/ops/fused_pair.py:633", "spatial")):
        modes = {}
        for mode in ("temporal", "spatial"):
            p = pair_inputs(1 if mode == "temporal" else 2, gated, dev)
            args = pair_args(p, gated)
            call = lambda: wrapper(*args, HEADS, scale, mode)
            out = call()
            torch.cuda.synchronize()
            bitwise = torch.equal(out, call())
            ref = plain(*args, HEADS, scale, mode)
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                fail(f"{name}/{mode}: shape {tuple(out.shape)} or non-finite")
            abs_err, rel = rel_err(out, ref)
            library = lambda: pair_library(p, gated, scale, mode)
            lib_abs, lib_rel = rel_err(library(), ref)
            flops, nbytes = pair_cost(mode, gated)
            t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
            calls = 10
            dev_ms, rows = device_profile(call, pair_records(gated), calls)
            rec = dict(
                max_abs_err=abs_err, rel_err=rel, tol=KERNEL_TOL,
                rel_l2=rel_l2_t(out, ref), bitwise_repeatable=bitwise,
                ms=time_ms(call), back_to_back_ms=time_ms_back_to_back(call),
                device_ms=dev_ms,
                device_by_kernel=by_kernel(rows, calls),
                plain_ms=time_ms(lambda: plain(*args, HEADS, scale, mode),
                                 runs=10, warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(library),
                library_device_ms=device_ms(library, None),
                library_rel_err=lib_rel, gflop=flops / 1e9, mbytes=nbytes / 1e6)
            log(f"kernel {name}/{mode}: " + json.dumps(rec))
            needed = PAIR_KERNELS + (("gate_kernel",) if gated else ())
            missing = [k for k in needed
                       if not any(k in key for key, _, _ in rows)]
            if missing or retired_kernels(rows):
                fail(f"{name}/{mode}: the profile of a call misses "
                     f"{missing} or runs {retired_kernels(rows)}")
            if not rel <= KERNEL_TOL:
                fail(f"{name}/{mode}: max|d|/max|ref| {rel:.3e} > {KERNEL_TOL}")
            if not bitwise:
                fail(f"{name}/{mode}: two runs gave different bits")
            modes[mode] = rec
            del p, args, out, ref
        main = modes[main_mode]
        records.append(dict(
            name=name, route="cuda",
            source="motionbert_tpu_torch/ops/csrc/pair_kernels.cu",
            replaces=replaces, launches=None,
            max_abs_err=max(m["max_abs_err"] for m in modes.values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], device_ms=main["device_ms"],
            library_device_ms=main["library_device_ms"], mode=main_mode,
            shape=[B, FRAMES, J, C], modes=modes))
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def seeded_motion(rs, n: int, frames: int) -> np.ndarray:
    """(n, frames, 17, 3) normalized 2D keypoints with confidences."""
    xy = rs.uniform(-1.0, 1.0, size=(n, frames, 17, 2))
    conf = rs.uniform(0.5, 1.0, size=(n, frames, 17, 1))
    return np.concatenate([xy, conf], -1).astype(np.float32)


def phase_main_path(fp, records: list):
    from motionbert_tpu_torch.api import MotionBERT
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.models.factory import load_backbone

    t0 = time.perf_counter()
    mb = MotionBERT.from_config(CONFIG, checkpoint=ANCHOR)
    log(f"main: from_config on {mb.device} in {time.perf_counter() - t0:.2f} s, "
        f"compute dtype {mb.model.compute_dtype}")
    x = seeded_motion(np.random.RandomState(0), LIFT_BATCH, FRAMES)

    fp.fused_pair_block.launches = 0
    fp.fused_gated_pair_block.launches = 0
    lifted = mb.lift(x)
    launches = {"fused_pair_block": fp.fused_pair_block.launches,
                "fused_gated_pair_block": fp.fused_gated_pair_block.launches}
    log(f"main: launches in one flip-TTA lift: {json.dumps(launches)}")
    expect = {"fused_pair_block": 3 * 5 * 2, "fused_gated_pair_block": 5 * 2}
    if launches != expect:
        fail(f"lift launched {launches}, expected {expect}")
    for rec in records:
        rec["launches"] = launches[rec["name"]]

    rep = mb.get_representation(x)

    # the plain fp32 path of the same model on the card: the plain functions
    # are called directly, and TF32 is off so fp32 products stay fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_model = load_backbone(get_config(CONFIG), dtype=torch.float32,
                              device="cuda", attn_impl="plain")
    ref_model.load_state_dict(mb.model.state_dict(), strict=True)
    ref_model.eval()
    mb_ref = MotionBERT(ref_model, maxlen=mb.maxlen)
    lifted_ref = mb_ref.lift(x)
    rep_ref = mb_ref.get_representation(x)
    for what, out, ref in (("lift", lifted, lifted_ref),
                           ("get_representation", rep, rep_ref)):
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"{what}: shape {out.shape} vs {ref.shape} or non-finite")
        abs_err, rel = rel_err(torch.from_numpy(out), torch.from_numpy(ref))
        log(f"main: {what} {out.shape} bf16 kernels vs fp32 plain: "
            f"max|d| {abs_err:.4e}, max|d|/max|ref| {rel:.4e}")
        if not rel <= PATH_TOL:
            fail(f"{what} disagrees with the fp32 plain path: {rel:.3e}")
    if not np.all(lifted[:, :, 0, :] == 0):
        fail("lift is not root-relative")

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mb.lift(x)
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    mb_ref.lift(x)
    dt_ref = time.perf_counter() - t0
    log(f"main: lift ({LIFT_BATCH}, {FRAMES}, 17, 3) flip-TTA: "
        f"{reps * LIFT_BATCH / dt:.2f} clips/s ({dt / reps * 1e3:.2f} ms per "
        f"call, kernels bf16); fp32 plain path {LIFT_BATCH / dt_ref:.2f} clips/s")
    del ref_model, mb_ref
    torch.cuda.empty_cache()
    return mb, x


# the column quantisers (csrc/pair_q8_common.cuh): B9's and B10's one, and
# B9_tp's split
COL_QUANT_KERNELS = ("quant_cols_kernel", "col_amax_kernel",
                     "quant_cols_given_kernel")
# kernel-name fragments of the port's own kernels, for the profile's groups
# (with the retired ones, which another checkout's build, under --baseline,
# may still run)
PROFILE_GROUPS = ("hg_gemm_kernel", "hg_gemm_s8_kernel", "hg_gemm_pair_kernel",
                  "hg_ln_kernel",
                  "attn_tc_fwd_kernel", "attn_tc_fwd_query_kernel",
                  "attn_tc_bwd_kernel",
                  "attn_tc_bwd_query_kernel", "attn_tc_bwd_key_kernel",
                  "gemm_q8_kernel",
                  "dequant_ln_quant_rows_kernel", "ln_quant_rows_kernel",
                  "quant_rows_kernel", "quant_rows_given_kernel",
                  "dequant_rows_kernel", "dequant_gate_rows_kernel",
                  *COL_QUANT_KERNELS, "row_amax_kernel", "attention_bwd_kernel",
                  "attention_kernel", "gate_bwd_rows_kernel", "gate_kernel",
                  "gemm_kernel", "colsum_chunks_kernel", "chunk_sum_kernel",
                  "colsum_kernel", "reduce_splits_kernel", "reduce_partials_kernel",
                  "ln_fwd_rows_kernel", "ln_bwd_fused_kernel",
                  "ln_bwd_rows_kernel")
# the column-sum pass and the one-pass LayerNorm backward (every backward
# chain with a LayerNorm runs all three), and the kernels they replaced
COLUMN_SUM_KERNELS = ("colsum_chunks_kernel", "chunk_sum_kernel",
                      "ln_bwd_fused_kernel")
COLUMN_SUM_RETIRED = ("colsum_kernel", "ln_bwd_rows_kernel")


def column_sum_faults(rows) -> list:
    """A backward's profile without the column-sum pass or the one-pass
    LayerNorm backward, or with a kernel they replaced."""
    names = [key for key, _, _ in rows]
    return ([f"no {k}" for k in COLUMN_SUM_KERNELS
             if not any(k in n for n in names)]
            + [f"runs {n[:80]}" for n in names
               if any(k in n for k in COLUMN_SUM_RETIRED)])


def device_rows(prof) -> list:
    """(name, device ms, count) of the kernels in a profile: only events
    that ran on the device, so host-side ranges that enclose kernels (aten
    ops, the autograd Functions) do not count their time again; nor do the
    user annotations the profiler also puts on the device's timeline
    (``Optimizer.step#AdamW.step``, ``DistributedDataParallel.forward``),
    which enclose kernels too."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0 and PRIMER_KERNEL not in e.key]


def phase_profile(mb, x, tag: str = "profile"):
    """One more lift under torch.profiler: device time by kernel and the
    device's busy share of the wall time (the profiler's own overhead is in
    that wall time)."""
    with card_profile() as prof:
        t0 = time.perf_counter()
        mb.lift(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(ms for _, ms, _ in rows)
    log(f"{tag}: one lift ({LIFT_BATCH}, {FRAMES}) under the profiler: "
        f"{wall_ms:.2f} ms wall, {busy_ms:.2f} ms device busy "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:14]:
        log(f"{tag}: {ms:9.3f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
            f"{n:5d}x {key[:100]}")
    groups = {}
    for key, ms, n in rows:
        name = next((g for g in PROFILE_GROUPS if g in key),
                    "other (PyTorch operators: casts, embed, head)")
        groups[name] = groups.get(name, 0.0) + ms
    log(f"{tag}: by group: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(groups.items(),
                                            key=lambda kv: -kv[1])}))
    return rows


def phase_serving(mb=None, n_requests: int = 20, tag: str = "serving",
                  attn_impl=None):
    """Concurrent requests through a MotionBERTServer over ``mb``, or, with
    ``mb`` None, one built by MotionBERTServer.from_config with
    ``attn_impl``; each answer against a direct lift of the same model."""
    from motionbert_tpu_torch.serve import MotionBERTServer

    kw = dict(batch_buckets=(1, 8, 32), max_wait_ms=20)
    srv = MotionBERTServer(mb, **kw) if mb is not None else \
        MotionBERTServer.from_config(CONFIG, checkpoint=ANCHOR,
                                     attn_impl=attn_impl, **kw)
    mb = srv.mb
    rs = np.random.RandomState(5)
    clips = [seeded_motion(rs, 1, 243 if i % 2 == 0 else 81)[0]
             for i in range(n_requests)]
    direct = [mb.lift(c[None])[0] for c in clips]
    results = [None] * len(clips)
    n_threads = 4

    def client(tid):
        for i in range(tid, len(clips), n_threads):
            results[i] = srv.lift(clips[i])

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            fail("serving clients did not finish")
        answers = [f.result(timeout=600) for f in results]
    finally:
        srv.shutdown()
    dt = time.perf_counter() - t0
    worst = 0.0
    for i, (ans, ref) in enumerate(zip(answers, direct)):
        if ans.shape != ref.shape or not np.isfinite(ans).all():
            fail(f"serving answer {i}: shape {ans.shape} vs {ref.shape}")
        worst = max(worst, rel_err(torch.from_numpy(ans),
                                   torch.from_numpy(ref))[1])
    if not worst <= KERNEL_TOL:
        fail(f"served answers disagree with direct lift: {worst:.3e}")
    stats = srv.stats["lift"]
    log(f"{tag}: {len(clips)} requests (243 and 81 frames) from "
        f"{n_threads} threads in {dt:.2f} s; {stats.batches} batches, "
        f"avg batch {stats.avg_batch_size:.2f}; worst max|d|/max|ref| vs "
        f"direct lift {worst:.3e}; shutdown returned")



# ---------------------------------------------------------------------------
# phases 10-15: the W8A8 serving tier
# ---------------------------------------------------------------------------

def pair_q8_cost(mode: str, gated: bool) -> tuple:
    """(seconds by operations, bytes, int8 operations, bf16 FLOPs) of the
    W8A8 pair at the phase-3 shape: the four products at the int8 peak, the
    attention core (and the gate) at the bf16 peak. Bytes as for the bf16
    pair: the function takes the full-precision weights and quantises them
    itself."""
    flops, nbytes = pair_cost(mode, gated)
    int8_ops = 2 * B * FRAMES * J * (3 * C * C + C * C + 2 * C * HIDDEN)
    t_ops = int8_ops / PEAK_INT8_OPS + (flops - int8_ops) / PEAK_BF16_FLOPS
    return t_ops, nbytes, int8_ops, flops - int8_ops


def q8_linear_library(a: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """fp32 rows (M, K) through a W8A8 linear layer whose integer product is
    PyTorch's own (torch._int_mm, cuBLASLt): the yardstick's only."""
    s = a.abs().amax(-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    a8 = torch.round(a / s).clamp(-127, 127).to(torch.int8)
    wf = w.float()
    ws = wf.abs().amax(1).clamp_min(1e-8) * (1.0 / 127.0)
    w8 = torch.round(wf / ws[:, None]).clamp(-127, 127).to(torch.int8)
    return torch._int_mm(a8, w8.t()).float() * s * ws + b.float()


def pair_q8_library(p: dict, gated: bool, scale: float, mode: str,
                    heads: int = HEADS):
    """The W8A8 pair from PyTorch's own operators (layer_norm, _int_mm,
    scaled_dot_product_attention), on whole weights or on a rank's shards
    (``heads`` local heads of a head group, a hidden slice; the partials
    then unreduced): a yardstick of speed the port never calls."""
    x = p["x"]
    Bx, Fx, Jx, Cx = x.shape
    ci = p["wqkv"].shape[0] // 3
    rows = lambda t: t.reshape(-1, t.shape[-1])
    h = F.layer_norm(x.float(), (Cx,), p["ln1_w"], p["ln1_b"], 1e-6)
    qkv = q8_linear_library(rows(h), p["wqkv"], p["bqkv"]).to(x.dtype)
    qkv = qkv.reshape(Bx, Fx, Jx, 3, heads, ci // heads)
    perm = (0, 1, 3, 2, 4) if mode == "spatial" else (0, 2, 3, 1, 4)
    q, k, v = (qkv[:, :, :, i].permute(perm) for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    o = o.permute([perm.index(i) for i in range(5)]).reshape(Bx, Fx, Jx, ci)
    y = (q8_linear_library(rows(o.float()), p["wproj"], p["bproj"])
         .reshape(x.shape) + x.float()).to(x.dtype)
    h2 = F.layer_norm(y.float(), (Cx,), p["ln2_w"], p["ln2_b"], 1e-6)
    z = F.gelu(q8_linear_library(rows(h2), p["w1"], p["b1"]))
    out = (q8_linear_library(z, p["w2"], p["b2"]).reshape(x.shape)
           + y.float()).to(x.dtype)
    if gated:
        s = F.linear(torch.cat([p["other"], out], -1), p["wg"], p["bg"])
        a = torch.softmax(s.float(), -1).to(out.dtype)
        out = p["other"] * a[..., 0:1] + out * a[..., 1:2]
    return out


# kernel-name fragments of a W8A8 call (q8_pair_chain, the gate and the
# column quantiser; "quant_rows_kernel" also names the LayerNorm quantiser)
Q8_CHAIN_KERNELS = ("hg_gemm_s8_kernel", "attn_tc_fwd_kernel",
                    "quant_rows_kernel", "quant_cols_kernel", "gate_kernel")


def torch_operator(name: str) -> bool:
    """A profile record of one of PyTorch's own kernels (by_kernel's name or
    a raw key), not the port's."""
    return name.replace("void ", "").startswith("at::")


def q8_profile_split(by: dict) -> dict:
    """A W8A8 call's device ms by kernel (by_kernel) split into the column
    quantisers' kernels, by name; PyTorch's operators (at::, which a build
    that quantised its weights with them, the parent's under --baseline,
    runs); and the chain: the port's other kernels, this build's or
    another's."""
    out = {f"{k}_device_ms": sum(ms for n, ms in by.items() if k in n)
           for k in COL_QUANT_KERNELS}
    out["torch_operators_device_ms"] = sum(
        ms for n, ms in by.items() if torch_operator(n))
    out["chain_device_ms"] = sum(by.values()) - sum(out.values())
    return out


def q8_profile_faults(rows, calls: int, records: int, gated: bool) -> list:
    """What a W8A8 pair or stream call's profile must not show: a kernel
    missing (the s8 engine, the tensor-core core, the row quantisers, the
    column quantiser, the gate when gated), a record count other than
    `records` a call, a PyTorch operator, or a retired kernel."""
    needed = Q8_CHAIN_KERNELS[:4] + (("gate_kernel",) if gated else ())
    faults = [f"no {k}" for k in needed
              if not any(k in key for key, _, _ in rows)]
    got = sum(n for key, _, n in rows
              if any(k in key for k in Q8_CHAIN_KERNELS)) / calls
    if got != records:
        faults.append(f"{got} records a call, expected {records}")
    faults += [f"PyTorch operator {key[:60]}" for key, _, _ in rows
               if torch_operator(key)]
    return faults + [f"retired {k}" for k in retired_kernels(rows)]


# the s8 engine alone at the W8A8 pair's products (phase-3 rows): (epi,
# N, K) of qkv, proj, fc1 and fc2, then ragged shapes
Q8_ENGINE_SHAPES = (("bias", 3 * C, C), ("bias_res", C, C),
                    ("bias_gelu_f32", HIDDEN, C), ("bias_res", C, HIDDEN))
# fp32 GELU of the same sum, this card's erff against PyTorch's erf kernel
Q8_ENGINE_GELU_TOL = 1e-6


def q8_engine_operands(epi: str, M: int, N: int, K: int, seed: int) -> list:
    """a8, ascale, w8, wscale, bias and (bias_res) r on the card from a
    seeded numpy RNG, the scales of the sizes the quantisers give."""
    rs = np.random.RandomState(seed)
    dev = torch.device("cuda")
    a8 = rs.randint(-127, 128, size=(M, K)).astype(np.int8)
    w8 = rs.randint(-127, 128, size=(N, K)).astype(np.int8)
    out = [torch.from_numpy(a).to(dev) for a in (
        a8, rs.uniform(1e-3, 1e-1, M).astype(np.float32), w8,
        rs.uniform(1e-4, 1e-2, N).astype(np.float32))]
    out.append(torch.from_numpy(rs.normal(size=N).astype(np.float32)).to(
        device=dev, dtype=torch.bfloat16))
    out.append(torch.from_numpy(rs.normal(size=(M, N)).astype(np.float32))
               .to(device=dev, dtype=torch.bfloat16)
               if epi == "bias_res" else None)
    return out


def phase_q8_engine(q8) -> None:
    """The s8 engine alone (csrc/hopper_gemm_s8.cuh, through
    pair_q8.engine_gemm_q8) at the W8A8 pair's four products on the phase-3
    token rows and at ragged shapes, against its plain twin on the same
    card: bit for bit for bias and bias_res, Q8_ENGINE_GELU_TOL for the fp32
    GELU; twice for bitwise repeatability; at the products' shapes one
    call's time, the device time and TOP/s."""
    M = B * FRAMES * J
    cases = [(epi, (M, N, K), True) for epi, N, K in Q8_ENGINE_SHAPES]
    cases += [(epi, shape, False) for epi in ("bias", "bias_res",
                                              "bias_gelu_f32")
              for shape in ((37, 64, 64), (M - 1, 192, 128))]
    for epi, (m, n, k), timed_shape in cases:
        args = q8_engine_operands(epi, m, n, k, seed=m + n + k)
        got = q8.engine_gemm_q8(epi, *args)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, q8.engine_gemm_q8(epi, *args))
        want = q8.engine_gemm_q8_plain(epi, *args)
        if got.shape != want.shape or got.dtype != want.dtype \
                or not torch.isfinite(got).all():
            fail(f"s8 engine {epi} {(m, n, k)}: shape, type or non-finite")
        equal = torch.equal(got, want)
        rec = dict(shape=[m, n, k], bitwise_repeatable=bitwise,
                   equal_to_plain=equal, rel_err=rel_err(got, want)[1])
        if timed_shape:
            fn = lambda: q8.engine_gemm_q8(epi, *args)
            ms, dev_ms = time_ms(fn), device_ms(fn, 1)
            rec.update(ms=ms, device_ms=dev_ms, tops=None if dev_ms is None
                       else 2 * m * n * k / (dev_ms * 1e-3) / 1e12)
        log(f"s8 engine {epi}: " + json.dumps(rec))
        exact = epi != "bias_gelu_f32"
        if (exact and not equal) or rec["rel_err"] > Q8_ENGINE_GELU_TOL:
            fail(f"s8 engine {epi} {(m, n, k)}: {rec['rel_err']:.3e} from "
                 f"the plain twin (bit for bit: {exact})")
        if not bitwise:
            fail(f"s8 engine {epi} {(m, n, k)}: two runs gave different "
                 f"bits")
        del args, got, want
    torch.cuda.empty_cache()


QUANT_COLS_REPLACES = ("motionbert_tpu/ops/pair_q8.py:71 (quant_cols, XLA "
                       "outside _q8_launch's pallas_call, :188-191)")


def quant_cols_cost(ws) -> float:
    """Bytes the column quantisers must move for weights ws: each read
    once, its int8 and fp32 scales written (the operations, a division an
    element, are far below the card's fp32 rate)."""
    return sum(w.numel() * (w.element_size() + 1) + 4 * w.shape[0]
               for w in ws)


def quant_cols_case(tag: str, call, plain, ws, records: int) -> dict:
    """One column-quantiser call on the card (call() -> [(int8, scale)])
    against its plain version bit for bit, twice for bitwise repeatability,
    with one call's time, the device's own (the profile holding `records`
    kernel records a call and nothing else), the plain version's and the
    byte bound; no single PyTorch call computes the function."""
    got = call()
    torch.cuda.synchronize()
    again = call()
    want = plain()
    equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                for a, b in zip(got, want))
    bitwise = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                  for a, b in zip(got, again))
    calls = 10
    dev_ms, rows = device_profile(call, records, calls)
    names = [key for key, _, _ in rows]
    nbytes = quant_cols_cost(ws)
    rec = dict(shapes=[list(w.shape) for w in ws],
               dtype=str(ws[0].dtype).replace("torch.", ""),
               equal_to_plain=equal, bitwise_repeatable=bitwise,
               max_abs_err=max((a[0].int() - b[0].int()).abs().max().item()
                               for a, b in zip(got, want)),
               ms=time_ms(call), back_to_back_ms=time_ms_back_to_back(call),
               device_ms=dev_ms, device_by_kernel=by_kernel(rows, calls),
               plain_ms=time_ms(plain, runs=10, warmup=1),
               bound_ms=nbytes / PEAK_HBM_BYTES * 1e3, bound_by="bytes",
               library_ms=None, mbytes=nbytes / 1e6)
    log(f"column quantiser {tag}: " + json.dumps(rec))
    if not (equal and bitwise):
        fail(f"column quantiser {tag}: equal to the plain quantiser {equal}, "
             f"bitwise repeatable {bitwise}")
    if any(not any(k in n for k in COL_QUANT_KERNELS) for n in names):
        fail(f"column quantiser {tag}: the profile holds {names}")
    return rec


def phase_quant_cols(q8) -> list:
    """The column quantiser (quant_cols_kernel, one launch a call) at the
    weights of a W8A8 pair call (the flagship's four, bf16, as the model
    hands them) and of a W8A8 stream call (two pairs' eight), and fp32."""
    dev = torch.device("cuda")
    cases = {}
    for tag, seeds, dtype in (("pair", (6,), torch.bfloat16),
                              ("stream", (30, 40), torch.bfloat16),
                              ("pair fp32", (6,), torch.float32)):
        ws = [pair_inputs(seed, False, dev)[k].to(dtype) for seed in seeds
              for k in ("wqkv", "wproj", "w1", "w2")]
        cases[tag] = quant_cols_case(
            tag, lambda: q8.quant_cols(*ws),
            lambda: [q8.quant_cols_plain(w) for w in ws], ws, 1)
        del ws
    main = cases["pair"]
    return [dict(
        name="quant_cols", route="cuda",
        source="motionbert_tpu_torch/ops/csrc/pair_q8_common.cuh",
        replaces=QUANT_COLS_REPLACES, launches=None,
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by="bytes", library_ms=None, device_ms=main["device_ms"],
        cases=cases)]


def phase_q8_kernels(q8, fp) -> list:
    scale = (C // HEADS) ** -0.5
    dev = torch.device("cuda")
    records = []
    for name, wrapper, plain, bf16_wrapper, gated, main_mode in (
            ("fused_pair_block_q8", q8.fused_pair_block_q8,
             q8.pair_block_q8_plain, fp.fused_pair_block, False, "temporal"),
            ("fused_gated_pair_block_q8", q8.fused_gated_pair_block_q8,
             q8.gated_pair_block_q8_plain, fp.fused_gated_pair_block, True,
             "spatial")):
        modes = {}
        for mode in ("temporal", "spatial"):
            p = pair_inputs(6 if mode == "temporal" else 7, gated, dev)
            args = pair_args(p, gated)
            out = wrapper(*args, HEADS, scale, mode)
            torch.cuda.synchronize()
            bitwise = torch.equal(out, wrapper(*args, HEADS, scale, mode))
            ref = plain(*args, HEADS, scale, mode)
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                fail(f"{name}/{mode}: shape {tuple(out.shape)} or non-finite")
            abs_err, rel = rel_err(out, ref)
            l2 = (torch.linalg.norm(out.float() - ref.float())
                  / torch.linalg.norm(ref.float())).item()
            differ = (out != ref).float().mean().item()
            lib_rel = rel_err(pair_q8_library(p, gated, scale, mode), ref)[1]
            full_l2 = (torch.linalg.norm(out.float() - bf16_wrapper(
                *args, HEADS, scale, mode).float())
                / torch.linalg.norm(ref.float())).item()
            t_ops, nbytes, int8_ops, bf16_flops = pair_q8_cost(mode, gated)
            t_bytes = nbytes / PEAK_HBM_BYTES
            weights = [p[k] for k in ("wqkv", "wproj", "w1", "w2")]
            call = lambda: wrapper(*args, HEADS, scale, mode)
            library = lambda: pair_q8_library(p, gated, scale, mode)
            calls = 10
            dev_ms, rows = device_profile(call, None, calls)
            split = q8_profile_split(by_kernel(rows, calls))
            faults = q8_profile_faults(rows, calls, pair_q8_records(gated),
                                       gated)
            rec = dict(
                max_abs_err=abs_err, rel_err=rel, tol=Q8_KERNEL_TOL,
                rel_l2=l2, l2_tol=Q8_KERNEL_L2_TOL,
                outputs_that_differ=differ,
                bitwise_repeatable=bitwise,
                rel_l2_vs_bf16_pair=full_l2,
                ms=time_ms(lambda: wrapper(*args, HEADS, scale, mode)),
                bf16_pair_ms=time_ms(
                    lambda: bf16_wrapper(*args, HEADS, scale, mode)),
                back_to_back_ms=time_ms_back_to_back(
                    lambda: wrapper(*args, HEADS, scale, mode)),
                bf16_pair_back_to_back_ms=time_ms_back_to_back(
                    lambda: bf16_wrapper(*args, HEADS, scale, mode)),
                plain_ms=time_ms(lambda: plain(*args, HEADS, scale, mode),
                                 runs=10, warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(
                    lambda: pair_q8_library(p, gated, scale, mode)),
                library_rel_err=lib_rel,
                library_device_ms=device_ms(library, None),
                device_ms=dev_ms, **split,
                device_by_kernel=by_kernel(rows, calls),
                quant_cols_ms=time_ms(lambda: q8.quant_cols(*weights)),
                int8_gop=int8_ops / 1e9, bf16_gflop=bf16_flops / 1e9,
                mbytes=nbytes / 1e6)
            log(f"q8 kernel {name}/{mode}: " + json.dumps(rec))
            if faults:
                fail(f"{name}/{mode}: a call's profile: {faults}")
            if not (rel <= Q8_KERNEL_TOL and l2 <= Q8_KERNEL_L2_TOL):
                fail(f"{name}/{mode}: max|d|/max|ref| {rel:.3e} (bar "
                     f"{Q8_KERNEL_TOL}), relative L2 {l2:.3e} (bar "
                     f"{Q8_KERNEL_L2_TOL})")
            if not bitwise:
                fail(f"{name}/{mode}: two runs gave different bits")
            modes[mode] = rec
            del p, args, out, ref, weights
        main = modes[main_mode]
        records.append(dict(
            name=name, route="cuda",
            source="motionbert_tpu_torch/ops/csrc/pair_q8_kernels.cu",
            replaces="motionbert_tpu/ops/pair_q8.py:147", launches=None,
            max_abs_err=max(m["max_abs_err"] for m in modes.values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], device_ms=main["device_ms"],
            library_device_ms=main["library_device_ms"], mode=main_mode,
            shape=[B, FRAMES, J, C], modes=modes))
    torch.cuda.empty_cache()
    return records


def rel_l2(out: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def pair_counters(q8, fp) -> tuple:
    return (q8.fused_pair_block_q8, q8.fused_gated_pair_block_q8,
            fp.fused_pair_block, fp.fused_gated_pair_block, q8.quant_cols)


def phase_q8_main_path(q8, fp, records: list):
    from motionbert_tpu_torch.api import MotionBERT
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.models.factory import load_backbone

    mb8 = MotionBERT.from_config(CONFIG, checkpoint=ANCHOR,
                                 attn_impl="kernel_q8")
    mb16 = MotionBERT.from_config(CONFIG, checkpoint=ANCHOR)
    x = seeded_motion(np.random.RandomState(0), LIFT_BATCH, FRAMES)

    counters = pair_counters(q8, fp)
    for c in counters:
        c.launches = 0
    lifted = mb8.lift(x)
    launches = {c.__name__: c.launches for c in counters}
    log(f"q8 main: launches in one flip-TTA lift: {json.dumps(launches)}")
    expect = {"fused_pair_block_q8": 3 * 5 * 2,
              "fused_gated_pair_block_q8": 5 * 2,
              "fused_pair_block": 0, "fused_gated_pair_block": 0,
              "quant_cols": 4 * 5 * 2}
    if launches != expect:
        fail(f"q8 lift launched {launches}, expected {expect}")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    rep = mb8.get_representation(x)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_model = load_backbone(get_config(CONFIG), dtype=torch.float32,
                              device="cuda", attn_impl="plain")
    ref_model.load_state_dict(mb8.model.state_dict(), strict=True)
    mb_ref = MotionBERT(ref_model, maxlen=mb8.maxlen)
    lifted_ref, rep_ref = mb_ref.lift(x), mb_ref.get_representation(x)
    lifted16, rep16 = mb16.lift(x), mb16.get_representation(x)
    del ref_model, mb_ref
    torch.cuda.empty_cache()
    for what, out, out16, ref in (("lift", lifted, lifted16, lifted_ref),
                                  ("get_representation", rep, rep16,
                                   rep_ref)):
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"q8 {what}: shape {out.shape} vs {ref.shape} or non-finite")
        log(f"q8 main: {what} {out.shape} vs fp32 plain: relative L2 "
            f"{rel_l2(out, ref):.4e} (q8 kernels), {rel_l2(out16, ref):.4e} "
            f"(bf16 kernels); max|d|/max|ref| "
            f"{rel_err(torch.from_numpy(out), torch.from_numpy(ref))[1]:.4e}"
            f" (q8), "
            f"{rel_err(torch.from_numpy(out16), torch.from_numpy(ref))[1]:.4e}"
            f" (bf16); gate {Q8_REL_L2_GATE} on the lift's relative L2")
    if not rel_l2(lifted, lifted_ref) <= Q8_REL_L2_GATE:
        fail(f"q8 lift is {rel_l2(lifted, lifted_ref):.3e} from the fp32 "
             f"plain path, gate {Q8_REL_L2_GATE}")
    if np.array_equal(lifted, lifted16):
        fail("the q8 lift equals the bf16 lift bit for bit: the int8 tier "
             "did not run")
    if not np.all(lifted[:, :, 0, :] == 0):
        fail("q8 lift is not root-relative")

    # both tiers in turns: q8, bf16, bf16, q8 (weight quantisation runs
    # inside every q8 pair call, so it is in the time), at the batch of 8 and
    # for a single clip, where the host's launch work weighs most
    for batch, reps in ((LIFT_BATCH, 3), (1, 5)):
        xb, times = x[:batch], {"q8": 0.0, "bf16": 0.0}
        for tier in ("q8", "bf16", "bf16", "q8"):
            mb = mb8 if tier == "q8" else mb16
            mb.lift(xb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                mb.lift(xb)
            times[tier] += time.perf_counter() - t0
        for tier, dt in times.items():
            log(f"q8 main: lift ({batch}, {FRAMES}, 17, 3) flip-TTA, {tier} "
                f"kernels: {2 * reps * batch / dt:.2f} clips/s "
                f"({dt / (2 * reps) * 1e3:.2f} ms per call)")
    return mb8, mb16, x


def phase_task_gate(q8, fp):
    """The H36M protocol on the synthetic smoke set (16-frame clips) with the
    anchor weights in the three tiers."""
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.data.datasets import BatchLoader, MotionDataset3D
    from motionbert_tpu_torch.data.readers import DataReaderH36M
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.train.pose3d import evaluate

    args = get_config(SMOKE_CONFIG)
    args.update(dim_feat=512, dim_rep=512, num_heads=8, depth=5, mlp_ratio=2,
                maxlen=243)
    args.data_root = os.path.join(ROOT, args.data_root)
    args.dt_root = os.path.join(ROOT, args.dt_root)
    test_loader = BatchLoader(MotionDataset3D(args, args.subset_list, "test"),
                              args.batch_size, shuffle=False)
    datareader = DataReaderH36M(
        n_frames=args.clip_len, sample_stride=args.sample_stride,
        data_stride_train=args.data_stride, data_stride_test=args.clip_len,
        dt_root=args.dt_root, dt_file=args.dt_file)
    sd = load_state_dict(ANCHOR)
    torch.backends.cuda.matmul.allow_tf32 = False
    e1 = {}
    counters = pair_counters(q8, fp)
    for tier, kw in (("fp32 plain", dict(dtype=torch.float32,
                                         attn_impl="plain")),
                     ("bf16 kernels", dict(attn_impl="kernel")),
                     ("q8 kernels", dict(attn_impl="kernel_q8"))):
        model = load_backbone(args, device="cuda", **kw)
        model.load_state_dict(sd, strict=True)
        for c in counters:
            c.launches = 0
        e1[tier], e2, results = evaluate(args, model, test_loader, datareader)
        launches = [c.launches for c in counters]
        log(f"task gate: {tier}: MPJPE {e1[tier]:.4f} mm, P-MPJPE {e2:.4f} "
            f"mm over {len(results)} clips of {args.clip_len} frames; pair "
            f"launches q8 {launches[0] + launches[1]}, bf16 "
            f"{launches[2] + launches[3]}")
        if tier == "q8 kernels" and (launches[0] == 0 or launches[2] != 0):
            fail(f"task gate: the q8 tier launched {launches}")
        del model
    ref = e1["fp32 plain"]
    bar = max(Q8_MPJPE_GATE_MM, Q8_MPJPE_GATE_REL * ref)
    drift = {k: v - ref for k, v in e1.items() if k != "fp32 plain"}
    log(f"task gate: MPJPE drift vs fp32 plain: bf16 kernels "
        f"{drift['bf16 kernels']:+.4f} mm, q8 kernels "
        f"{drift['q8 kernels']:+.4f} mm; bar max({Q8_MPJPE_GATE_MM} mm, "
        f"{Q8_MPJPE_GATE_REL:.0%} of {ref:.4f}) = {bar:.4f} mm")
    if not abs(drift["q8 kernels"]) <= bar:
        fail(f"task gate: q8 MPJPE drift {drift['q8 kernels']:+.4f} mm is "
             f"over {bar:.4f} mm")
    torch.cuda.empty_cache()


def write_wild_json(path: str, frames=(300, 100), seed: int = 21) -> None:
    """Halpe-26 AlphaPose detections from a numpy seed: one smooth track per
    person in a 1920 x 1080 frame, ``frames[i]`` detections of person i."""
    rs = np.random.RandomState(seed)
    results = []
    for person, n in enumerate(frames):
        t = np.arange(n)[:, None, None] / 100.0
        rest = rs.uniform(-200, 200, size=(1, 26, 2)) + (960.0, 540.0)
        amp = rs.uniform(10, 60, size=(1, 26, 2))
        phase = rs.uniform(size=(1, 26, 2))
        xy = rest + amp * np.sin(2 * np.pi * (t + phase))
        conf = rs.uniform(0.5, 1.0, size=(n, 26, 1))
        kpts = np.concatenate([xy, conf], -1)
        results += [{"image_id": f"{f}.jpg", "idx": person, "score": 2.5,
                     "keypoints": kpts[f].ravel().tolist()} for f in range(n)]
    with open(path, "w") as fh:
        json.dump(results, fh)


def phase_wild(q8, fp, mb8, mb16):
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.data.dataset_wild import WildDetDataset
    from motionbert_tpu_torch.infer.wild_pose import run_wild_pose

    args = get_config(CONFIG)
    frames = (300, 100)
    with tempfile.TemporaryDirectory() as tmp:
        json_path = os.path.join(tmp, "alphapose-results.json")
        write_wild_json(json_path, frames)
        clips = WildDetDataset(json_path, clip_len=FRAMES, vid_size=None,
                               scale_range=[1, 1], focus=0)
        lengths = [len(clips[i]) for i in range(len(clips))]
        if lengths != [FRAMES, frames[0] - FRAMES]:
            fail(f"wild: clips of {lengths} frames")
        outs = {}
        counters = pair_counters(q8, fp)
        for tier, mb in (("bf16", mb16), ("q8", mb8)):
            out_dir = os.path.join(tmp, tier)
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            out = run_wild_pose(args, json_path=json_path, out_path=out_dir,
                                model=mb.model, focus=0, clip_len=FRAMES)
            dt = time.perf_counter() - t0
            launches = [c.launches for c in counters]
            saved = np.load(os.path.join(out_dir, "X3D.npy"))
            if out.shape != (frames[0], 17, 3) or not np.isfinite(out).all() \
                    or not np.array_equal(saved, out):
                fail(f"wild {tier}: shape {out.shape}, or X3D.npy differs")
            if not np.all(out[:, 0, :] == 0):   # rootrel: true in the config
                fail(f"wild {tier}: the root joint is not zeroed")
            worst, st = 0.0, 0
            for i in range(len(clips)):
                direct = mb.lift(clips[i][None], flip_tta=bool(args.flip),
                                 rootrel=bool(args.rootrel))[0]
                worst = max(worst, float(np.abs(
                    out[st:st + len(direct)] - direct).max()))
                st += len(direct)
            used = (launches[0] + launches[1], launches[2] + launches[3])
            log(f"wild {tier}: {frames[0]} frames of person 0 as clips of "
                f"{lengths} in {dt:.2f} s -> {out.shape}, X3D.npy written; "
                f"max|d| vs direct lifts {worst:.3e}; pair launches q8 "
                f"{used[0]}, bf16 {used[1]}")
            if worst != 0.0:
                fail(f"wild {tier}: a clip differs from its direct lift by "
                     f"{worst:.3e}")
            if (tier == "q8") != (used[0] > 0) or (tier == "q8") == (used[1] > 0):
                fail(f"wild {tier}: launched {launches}")
            outs[tier] = out
        both = WildDetDataset(json_path, clip_len=FRAMES, vid_size=None,
                              scale_range=[1, 1], focus=None)
        if len(both.vid_all) != sum(frames):
            fail(f"wild: {len(both.vid_all)} detections without focus")
    log(f"wild: q8 vs bf16 output relative L2 "
        f"{rel_l2(outs['q8'], outs['bf16']):.4e}")


def phase_straight_through(q8, fp):
    scale = (C // HEADS) ** -0.5
    dev = torch.device("cuda")
    for q8_fn, bf16_fn, bwd, gated, mode in (
            (q8.fused_pair_block_q8, fp.fused_pair_block,
             fp.fused_pair_block_bwd, False, "temporal"),
            (q8.fused_gated_pair_block_q8, fp.fused_gated_pair_block,
             fp.fused_gated_pair_block_bwd, True, "spatial")):
        p = pair_inputs(8, gated, dev)
        g = pair_inputs(9, False, dev)["x"]
        grads, before = [], bwd.launches
        for fn in (q8_fn, bf16_fn):
            leaves = [t.detach().clone().requires_grad_()
                      for t in pair_args(p, gated)]
            out = fn(*leaves, HEADS, scale, mode)
            grads.append(torch.autograd.grad(out, leaves, g))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*grads))
        finite = all(torch.isfinite(a.float()).all() for a in grads[0])
        log(f"straight-through {q8_fn.__name__}/{mode}: {len(grads[0])} "
            f"gradients, bitwise equal to {bf16_fn.__name__}'s: {same}; "
            f"{bwd.__name__} launches {bwd.launches - before}")
        if not (same and finite) or bwd.launches - before != 2:
            fail(f"{q8_fn.__name__}: backward is not the bf16 pair's")
        del p, g, grads, leaves, out
    torch.cuda.empty_cache()


def phase_q8(q8, fp) -> list:
    timed("s8 engine", phase_q8_engine, q8)
    records = timed("column quantiser", phase_quant_cols, q8)
    records += phase_q8_kernels(q8, fp)
    mb8, mb16, x = phase_q8_main_path(q8, fp, records)
    rows = phase_profile(mb8, x, tag="q8 profile")
    faults = [k for k in Q8_CHAIN_KERNELS[:4]
              if not any(k in key for key, _, _ in rows)]
    if faults or retired_kernels(rows):
        fail(f"q8 lift: the profile misses {faults} or runs "
             f"{retired_kernels(rows)}")
    phase_task_gate(q8, fp)
    phase_wild(q8, fp, mb8, mb16)
    phase_straight_through(q8, fp)
    del mb8, mb16, x
    counters = pair_counters(q8, fp)
    for c in counters:
        c.launches = 0
    phase_serving(n_requests=8, tag="q8 serving", attn_impl="kernel_q8")
    launches = [c.launches for c in counters]
    if launches[0] == 0 or launches[2] + launches[3] != 0:
        fail(f"q8 serving launched {launches}")
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phase 7: backward kernels
# ---------------------------------------------------------------------------

def pair_bwd_cost(mode: str, gated: bool) -> tuple:
    """(FLOPs, bytes) of the pair backward at the phase-3 shape. Its inputs
    are x (+ other), g and the weights, so the forward's recompute counts:
    each product runs three times (forward, input gradient, weight
    gradient) but fc2, which the ungated chain runs twice (dW2 and dz: its
    output is not needed, the gated chain recomputes it for the gate), and
    the attention core three times (the forward, then dP/dv and dq/dk at
    twice the work, as one backward). Bytes: x, g (+ other) read, dx (+
    dother) written, the weights read and their gradients written once."""
    flops, nbytes = pair_cost(mode, gated)
    M = B * FRAMES * J
    fc2 = 2 * M * C * HIDDEN
    weight_bytes = nbytes - 2 * M * C * 2 - (M * C * 2 if gated else 0)
    grad_bytes = (3 * C * C + C * C + 2 * C * HIDDEN) * 2 \
        + (3 * C + C + HIDDEN + C) * 2 + 4 * C * 4 \
        + ((2 * 2 * C + 2) * 2 if gated else 0)
    act = (2 if gated else 1) * M * C * 2
    return (3 * flops - (0 if gated else fc2),
            2 * act + M * C * 2 + weight_bytes + grad_bytes)


def pair_bwd_records(gated: bool) -> int:
    """Device records of one pair backward call, from this checkout's chain
    in csrc/pair_bwd_kernels.cu (tests/test_torch_core.py reads it): the
    recompute's two LayerNorm rows, four products and the attention core;
    four weight gradients, four bias column sums and two LayerNorm
    backwards (the one pass and the in-order sum of its parameter partials)
    of two launches each; dz, dh2, dattn, dh1 and the attention backward.
    The gated chain adds out_b, the gate's rows and five more column sums.
    Another checkout's chain may launch otherwise: under --baseline its
    profiles are held to whole multiples of the calls (in_turns)."""
    return 31 + (12 if gated else 0)


# kernel-name fragments a pair backward call must launch (the engine, the
# tensor-core core), and those of the first design no chain runs any more
# (the CUDA-core attention kernels, the int8 mma.sync GEMM, and the WMMA
# GEMM, whose name "gemm_kernel" follows no other letter: the engines'
# hg_gemm_kernel and hg_gemm_s8_kernel never match it)
PAIR_BWD_KERNELS = ("hg_gemm_kernel", "attn_tc_fwd_kernel",
                    "attn_tc_bwd_kernel")
PAIR_BWD_RETIRED = ("attention_kernel", "attention_bwd_kernel",
                    "gemm_q8_kernel")
WMMA_GEMM = re.compile(r"(?<![A-Za-z0-9_])gemm_kernel")


def retired_kernels(rows) -> list:
    """The kernels of a profile that no chain runs any more: every chain
    (the pairs, bf16 and W8A8, the blocks, forward and backward, the
    streams and the attention core alone) runs the engines and the
    tensor-core core."""
    return [key for key, _, _ in rows
            if any(k in key for k in PAIR_BWD_RETIRED)
            or WMMA_GEMM.search(key)]


def grad_errors(got, want) -> list:
    return [rel_err(a, b) for a, b in zip(got, want)]


# the bias column sums of one pair backward call at the phase-7 rows:
# (mode, N, the gradients they give)
COLUMN_SUM_CASES = (("f32", 3 * C, "dbqkv"), ("bf16", HIDDEN, "db1"),
                    ("bf16", C, "db2, dbproj"), ("gate", C, "a dwg row"),
                    ("f32", 2, "dbg"))


def order_bound(terms: torch.Tensor, splits: int) -> torch.Tensor:
    """Per column, how far a sum of the (M, N) terms in the kernels' fixed
    order may lie from the exact sum: a chain of at most ceil(M / splits)
    + 8 + splits fp32 additions (a chunk's rows, the LayerNorm backward's 8
    warps, the chunks), each rounding by at most 2^-24 of a partial sum, so
    (ceil(M / splits) + 8 + splits) * 2^-24 * sum|terms|."""
    depth = -(-terms.shape[0] // splits) + 8 + splits
    return depth * 2.0 ** -24 * terms.double().abs().sum(0)


def phase_column_sums() -> None:
    """The bias column sums of one B3 call alone (ops.attention.column_sum,
    the test entry of the chains' pass) at the phase-7 rows: against the
    float64 sum within order_bound, bitwise repeatable, the bf16 output the
    fp32 one rounded; ms one call, device and back to back beside the byte
    bound and one torch.sum."""
    from motionbert_tpu_torch.ops import attention as at

    dev = torch.device("cuda")
    M = B * FRAMES * J
    rs = np.random.RandomState(7)
    for mode, N, what in COLUMN_SUM_CASES:
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        src = torch.from_numpy(rs.normal(size=(M, N)).astype(
            np.float32)).to(dev, dt)
        w = torch.from_numpy(rs.normal(size=(M, 2)).astype(
            np.float32)).to(dev) if mode == "gate" else None
        call = lambda: at.column_sum(src, mode, w)
        got, again = call(), call()
        terms = src.double()
        if mode == "gate":
            terms = terms * w[:, :1].to(torch.bfloat16).double()
        err = (got.double() - terms.sum(0)).abs()
        slack = (err / order_bound(terms, at.COLSUM_CONSTANTS["splits"])
                 ).max().item()
        rounded = torch.equal(at.column_sum(src, mode, w, torch.bfloat16),
                              got.to(torch.bfloat16))
        nbytes = M * N * src.element_size() + (M * 8 if w is not None
                                               else 0) + N * 4
        dev_ms, rows = device_profile(call, 2)
        library = (None if mode == "gate" else
                   lambda: torch.sum(src, 0, dtype=torch.float32))
        rec = dict(
            what=what, shape=[M, N], max_abs_err=err.max().item(),
            err_over_order_bound=slack, bitwise_repeatable=torch.equal(
                got, again), bf16_is_fp32_rounded=rounded, ms=time_ms(call),
            device_ms=dev_ms, back_to_back_ms=time_ms_back_to_back(call),
            device_by_kernel=by_kernel(rows, 10),
            bound_ms=nbytes / PEAK_HBM_BYTES * 1e3, bound_by="bytes",
            library_ms=None if library is None else time_ms(library),
            library_device_ms=None if library is None
            else device_ms(library, None))
        log(f"column sum {mode}/{N}: " + json.dumps(rec))
        names = [key for key, _, _ in rows]
        missing = [k for k in COLUMN_SUM_KERNELS[:2]
                   if not any(k in n for n in names)]
        if not (slack <= 1 and rec["bitwise_repeatable"] and rounded) \
                or missing:
            fail(f"column sum {mode}/{N}: {slack:.3f} of the order bound, "
                 f"repeatable {rec['bitwise_repeatable']}, bf16 the fp32 "
                 f"sum rounded {rounded}, profile without {missing}")
        del src, w, got, again, terms
    torch.cuda.empty_cache()


def phase_backward(fp) -> list:
    timed("column sums", phase_column_sums)
    scale = (C // HEADS) ** -0.5
    dev = torch.device("cuda")
    records = []
    for name, kernel, plain, gated, main_mode in (
            ("fused_pair_block_bwd", fp.fused_pair_block_bwd,
             fp.pair_block_bwd_plain, False, "temporal"),
            ("fused_gated_pair_block_bwd", fp.fused_gated_pair_block_bwd,
             fp.gated_pair_block_bwd_plain, True, "spatial")):
        modes = {}
        for mode in ("temporal", "spatial"):
            p = pair_inputs(3 if mode == "temporal" else 4, gated, dev)
            g = pair_inputs(5, False, dev)["x"]
            fwd = pair_args(p, gated)
            args = fwd[:2 if gated else 1] + [g] + fwd[2 if gated else 1:]
            got = kernel(*args, HEADS, scale, mode)
            torch.cuda.synchronize()
            again = kernel(*args, HEADS, scale, mode)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            want = plain(*args, HEADS, scale, mode)
            if any(not torch.isfinite(t.float()).all() for t in got):
                fail(f"{name}/{mode}: non-finite gradient")
            errs = grad_errors(got, want)
            names = ["dx"] + (["dother"] if gated else []) \
                + [f"d{k}" for k in fp.PAIR_PARAMS] \
                + (["dwg", "dbg"] if gated else [])

            leaves = [t.detach().clone().requires_grad_() for t in fwd]
            lib_p = dict(zip((["x"] + (["other"] if gated else [])
                              + list(PAIR_KEYS)
                              + (["wg", "bg"] if gated else [])), leaves))

            def library():
                out = pair_library(lib_p, gated, scale, mode)
                return torch.autograd.grad(out, leaves, g)

            flops, nbytes = pair_bwd_cost(mode, gated)
            t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
            call = lambda: kernel(*args, HEADS, scale, mode)
            calls = 10
            dev_ms, rows = device_profile(call, pair_bwd_records(gated),
                                          calls)
            rec = dict(
                rel_err={n: e[1] for n, e in zip(names, errs)},
                max_abs_err=max(e[0] for e in errs), tol=KERNEL_TOL,
                bitwise_repeatable=bitwise,
                ms=time_ms(call),
                back_to_back_ms=time_ms_back_to_back(call),
                device_ms=dev_ms,
                device_by_kernel=by_kernel(rows, calls),
                plain_ms=time_ms(lambda: plain(*args, HEADS, scale, mode),
                                 runs=5, warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(library, runs=10),
                library_device_ms=device_ms(library, None),
                gflop=flops / 1e9, mbytes=nbytes / 1e6)
            log(f"backward {name}/{mode}: " + json.dumps(rec))
            missing = [k for k in PAIR_BWD_KERNELS
                       if not any(k in key for key, _, _ in rows)]
            if missing or retired_kernels(rows) or column_sum_faults(rows):
                fail(f"{name}/{mode}: the profile of a call misses "
                     f"{missing} or runs {retired_kernels(rows)}; "
                     f"{column_sum_faults(rows)}")
            worst = max(rec["rel_err"].items(), key=lambda kv: kv[1])
            if not worst[1] <= KERNEL_TOL:
                fail(f"{name}/{mode}: {worst[0]} max|d|/max|ref| "
                     f"{worst[1]:.3e} > {KERNEL_TOL}")
            if not bitwise:
                fail(f"{name}/{mode}: two runs gave different bits")
            modes[mode] = rec
            del p, g, fwd, args, got, again, want, leaves, lib_p
        main = modes[main_mode]
        records.append(dict(
            name=name, route="cuda",
            source="motionbert_tpu_torch/ops/csrc/pair_bwd_kernels.cu",
            replaces="motionbert_tpu/ops/fused_pair.py:486", launches=None,
            max_abs_err=max(m["max_abs_err"] for m in modes.values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], device_ms=main["device_ms"],
            library_device_ms=main["library_device_ms"], mode=main_mode,
            shape=[B, FRAMES, J, C], modes=modes))
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phase 8: the flagship train step
# ---------------------------------------------------------------------------

def smooth_target(rs, n: int, frames: int) -> np.ndarray:
    """(n, frames, 17, 3) root-relative 3D poses moving smoothly: a rest
    pose per clip plus slow sinusoids per joint and axis."""
    t = np.arange(frames, dtype=np.float64)[None, :, None, None] / frames
    rest = rs.normal(scale=0.3, size=(n, 1, 17, 3))
    amp = rs.normal(scale=0.1, size=(n, 1, 17, 3))
    freq = rs.uniform(0.5, 2.0, size=(n, 1, 17, 3))
    phase = rs.uniform(0.0, 2 * np.pi, size=(n, 1, 17, 3))
    y = rest + amp * np.sin(2 * np.pi * freq * t + phase)
    return (y - y[:, :, :1]).astype(np.float32)


def train_batch(n: int) -> tuple:
    rs = np.random.RandomState(11)
    y = smooth_target(rs, n, FRAMES)
    xy = y[..., :2] + rs.normal(scale=0.01, size=y[..., :2].shape)
    x = np.concatenate([xy, np.ones_like(y[..., :1])], -1).astype(np.float32)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())


def loss_and_grads(model, x, y, lambdas, **kw) -> tuple:
    from motionbert_tpu_torch.losses.pose import pose3d_total_loss
    from motionbert_tpu_torch.train.pose3d import preprocess_batch

    model.train()
    model.zero_grad(set_to_none=True)
    xb, yb, _ = preprocess_batch(x, y, rootrel=True, no_conf=False)
    total, _ = pose3d_total_loss(model(xb, **kw).float(), yb, lambdas)
    total.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return total.item(), grads


def compare_first_step(tag: str, what: str, loss, grads, ref_loss,
                       ref_grads, cosine_min: float = GRAD_COSINE_MIN,
                       tensor_tol=grad_tensor_tol,
                       sides=("bf16 kernels", "plain")) -> None:
    """The first step's loss and gradients (bf16 kernels) against a plain
    path's: the loss, the cosine of all gradients as one vector, and each
    tensor's max|d| / max|ref| (to ``tensor_tol(name)``). ``sides`` names
    the two runs in the log."""
    per = {n: rel_err(grads[n], ref_grads[n])[1] for n in ref_grads}
    cosine = grad_cosine(grads, ref_grads)
    worst = sorted(per.items(), key=lambda kv: -kv[1])
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    log(f"{tag}: {what}: loss {loss:.6f} ({sides[0]}) vs {ref_loss:.6f} "
        f"({sides[1]}), rel {loss_rel:.3e}; cosine {cosine:.6f}; median "
        f"tensor max|d|/max|ref| {statistics.median(per.values()):.3e}; worst "
        + ", ".join(f"{n} {e:.3e}" for n, e in worst[:12]))
    over = [(n, e) for n, e in worst if not e <= tensor_tol(n)]
    if not (loss_rel <= LOSS_TOL and cosine >= cosine_min) or over:
        fail(f"{tag}: {what} disagrees with the {sides[1]} run: loss rel "
             f"{loss_rel:.3e}, cosine {cosine:.6f} (bar {cosine_min}), over "
             f"the bar: {over}")


def grad_cosine(grads: dict, ref_grads: dict) -> float:
    """The cosine of two gradient dicts, each flattened into one vector."""
    flat = torch.cat([grads[n].flatten() for n in ref_grads])
    ref_flat = torch.cat([ref_grads[n].flatten() for n in ref_grads])
    return F.cosine_similarity(flat, ref_flat, dim=0).item()


def profile_step(tag: str, step, x, y, column_sums: bool = False) -> tuple:
    """One more train step under torch.profiler: device time by kernel and
    by group, and the device's busy share of the wall time; with
    column_sums, fail unless the step ran the column-sum pass and the
    one-pass LayerNorm backward and none of the kernels they replaced.
    Returns (device busy ms, {group: ms})."""
    with card_profile() as prof:
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(ms for _, ms, _ in rows)
    log(f"{tag}: one step {tuple(x.shape[:2])} under the profiler: "
        f"{wall_ms:.2f} ms wall, {busy_ms:.2f} ms device busy "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:16]:
        log(f"{tag}: {ms:9.3f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
            f"{n:5d}x {key[:100]}")
    groups = {}
    for key, ms, n in rows:
        name = next((g for g in PROFILE_GROUPS if g in key),
                    "other (PyTorch operators: LayerNorm, DropPath, gate, "
                    "casts, loss, AdamW)")
        groups[name] = groups.get(name, 0.0) + ms
    log(f"{tag}: by group: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(groups.items(),
                                            key=lambda kv: -kv[1])}))
    if column_sums and column_sum_faults(rows):
        fail(f"{tag}: {column_sum_faults(rows)}")
    return busy_ms, groups


def phase_train(fp, fwd_records: list, bwd_records: list):
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.losses.pose import LAMBDA_KEYS, pose3d_total_loss
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.train.pose3d import (
        make_train_step, preprocess_batch)
    from motionbert_tpu_torch.train.state import make_adamw

    args = get_config(TRAIN_CONFIG)
    lambdas = {k: args.get(k, 0.0) for k in LAMBDA_KEYS}
    sd = load_state_dict(ANCHOR)
    model = load_backbone(args, device="cuda")
    model.load_state_dict(sd, strict=True)
    log(f"train: {os.path.basename(TRAIN_CONFIG)} dim {args.dim_feat} depth "
        f"{args.depth} heads {args.num_heads} mlp_ratio {args.mlp_ratio}, "
        f"compute dtype {model.compute_dtype}, flip {args.flip}, lr "
        f"{args.learning_rate}, lambdas {json.dumps(lambdas)}")

    # first step against the fp32 plain path, batch REF_BATCH (the fp32
    # reference keeps every intermediate for autograd)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = train_batch(REF_BATCH)
    loss, grads = loss_and_grads(model, x, y, lambdas)
    ref_model = load_backbone(args, dtype=torch.float32, device="cuda",
                              attn_impl="plain")
    ref_model.load_state_dict(sd, strict=True)
    ref_loss, ref_grads = loss_and_grads(ref_model, x, y, lambdas)
    del ref_model
    torch.cuda.empty_cache()
    compare_first_step("train", f"first step, batch {REF_BATCH}", loss, grads,
                       ref_loss, ref_grads)
    del grads, ref_grads

    # TRAIN_STEPS steps through the kernels on one fixed batch
    x, y = train_batch(TRAIN_BATCH)
    opt = make_adamw(model.parameters(), args.learning_rate,
                     args.weight_decay)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = make_train_step(model, opt, lambdas, rootrel=args.rootrel,
                           no_conf=args.no_conf, flip_aug=bool(args.flip),
                           generator=gen)

    def eval_loss():
        with torch.no_grad():
            xb, yb, _ = preprocess_batch(x, y, rootrel=True, no_conf=False)
            return pose3d_total_loss(model(xb).float(), yb, lambdas)[0].item()

    before = eval_loss()
    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd)
    for c in counters:
        c.launches = 0
    # the first step warms the allocator up; the other steps are timed
    losses = [step(x, y)["total"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += [step(x, y)["total"] for _ in range(TRAIN_STEPS - 1)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (TRAIN_STEPS - 1)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    after = eval_loss()
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    log(f"train: launches per step {json.dumps(per_step)}")
    if per_step != TRAIN_LAUNCHES:
        fail(f"train step launched {per_step}, expected {TRAIN_LAUNCHES}")
    losses = [v.item() for v in losses]
    log(f"train: ({TRAIN_BATCH}, {FRAMES}, 17, 3) AdamW steps: "
        f"{dt * 1e3:.2f} ms per step, {TRAIN_BATCH / dt:.3f} clips/s, peak "
        f"memory {peak / 2**30:.3f} GiB; fixed-batch loss {before:.6f} "
        f"before, {after:.6f} after {TRAIN_STEPS} steps; step losses "
        + " ".join(f"{v:.5f}" for v in losses))
    if not (np.isfinite(losses).all() and np.isfinite(after)
            and after < before):
        fail(f"loss did not fall: {before} -> {after}")
    for rec in fwd_records:
        rec["launches_train"] = launches[rec["name"]]
    for rec in bwd_records:
        rec["launches"] = launches[rec["name"]]

    profile_step("train profile", step, x, y, column_sums=True)
    del model, opt, step
    torch.cuda.empty_cache()
    shipped_batch_steps(fp, args, sd, lambdas)


def shipped_batch_steps(fp, args, sd, lambdas) -> None:
    """SHIPPED_STEPS AdamW steps at the config's batch (32: 132,192 token
    rows through B1-B3) from the anchor weights, on one fixed batch through
    the kernels: finite losses, the batch's loss falls, phase 8's launches a
    step; ms per step on the device clock and peak memory; then one more
    step under the profiler."""
    from motionbert_tpu_torch.losses.pose import pose3d_total_loss
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.train.pose3d import (
        make_train_step, preprocess_batch)
    from motionbert_tpu_torch.train.state import make_adamw

    batch = args.batch_size
    model = load_backbone(args, device="cuda")
    model.load_state_dict(sd, strict=True)
    x, y = train_batch(batch)
    opt = make_adamw(model.parameters(), args.learning_rate,
                     args.weight_decay)
    step = make_train_step(model, opt, lambdas, rootrel=args.rootrel,
                           no_conf=args.no_conf, flip_aug=bool(args.flip),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))

    def batch_loss():
        with torch.no_grad():
            xb, yb, _ = preprocess_batch(x, y, rootrel=True, no_conf=False)
            return pose3d_total_loss(model(xb).float(), yb, lambdas)[0].item()

    before = batch_loss()
    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(SHIPPED_STEPS):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        losses.append(step(x, y)["total"])
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    peak = torch.cuda.max_memory_allocated()
    per_step = {c.__name__: c.launches / SHIPPED_STEPS for c in counters}
    after = batch_loss()
    losses = [v.item() for v in losses]
    clips_s = batch * 1e3 / statistics.mean(ms[1:])
    log(f"train: shipped batch ({batch}, {FRAMES}, 17, 3), "
        f"{batch * FRAMES * J} token rows: ms per step on the device clock "
        + " ".join(f"{v:.2f}" for v in ms) + f" (the first warms the "
        f"allocator and AdamW's state), {clips_s:.3f} clips/s after it, "
        f"peak memory {peak / 2**30:.3f} GiB; launches "
        f"per step {json.dumps(per_step)}; fixed-batch loss {before:.6f} "
        f"before, {after:.6f} after {SHIPPED_STEPS} steps; step losses "
        + " ".join(f"{v:.5f}" for v in losses))
    if per_step != TRAIN_LAUNCHES:
        fail(f"shipped-batch step launched {per_step}, expected "
             f"{TRAIN_LAUNCHES}")
    if not (np.isfinite(losses).all() and np.isfinite(after)
            and after < before):
        fail(f"shipped-batch loss did not fall: {before} -> {after}")
    profile_step(f"train profile, batch {batch}", step, x, y)
    del model, opt, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the epoch driver
# ---------------------------------------------------------------------------

def phase_driver():
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.train.pose3d import train_with_config

    def smoke_args(epochs):
        args = get_config(SMOKE_CONFIG)
        args.update(dim_feat=512, dim_rep=512, num_heads=8, depth=5,
                    mlp_ratio=2, epochs=epochs)
        args.data_root = os.path.join(ROOT, args.data_root)
        args.dt_root = os.path.join(ROOT, args.dt_root)
        return args

    with tempfile.TemporaryDirectory() as ckpt:
        opts = lambda: types.SimpleNamespace(
            checkpoint=ckpt, pretrained="", resume="", evaluate="",
            selection="", seed=0)
        t0 = time.perf_counter()
        first = train_with_config(smoke_args(2), opts())
        t1 = time.perf_counter()
        resumed = train_with_config(smoke_args(3), opts())
        t2 = time.perf_counter()
        roles = sorted(os.listdir(ckpt))
        latest = load_checkpoint(os.path.join(ckpt, "latest_epoch.ckpt"))
    hist = first["history"] + resumed["history"]
    log("driver: " + json.dumps([dict(epoch=h["epoch"], lr=h["lr"],
                                      loss=h["losses"]["total"], e1=h["e1"],
                                      e2=h["e2"]) for h in hist]))
    log(f"driver: 2 epochs in {t1 - t0:.2f} s, resumed third in "
        f"{t2 - t1:.2f} s; files {roles}")
    lr0 = smoke_args(1).learning_rate
    if [h["epoch"] for h in hist] != [0, 1, 2]:
        fail(f"driver ran epochs {[h['epoch'] for h in hist]}")
    if not all(np.isfinite([h["e1"], h["e2"], h["losses"]["total"]]).all()
               for h in hist):
        fail("driver: non-finite loss or error")
    if abs(resumed["history"][0]["lr"] - lr0 * 0.99 ** 2) > 1e-12:
        fail(f"driver: resumed at lr {resumed['history'][0]['lr']}")
    for role in ("latest_epoch.ckpt", "best_epoch.ckpt", "epoch_1.ckpt"):
        if role not in roles:
            fail(f"driver: {role} missing from {roles}")
    if latest["epoch"] != 3:
        fail(f"driver: latest checkpoint records epoch {latest['epoch']}")


# ---------------------------------------------------------------------------
# phase 32 (opt-in): the convergence witness
# ---------------------------------------------------------------------------

def phase_anchor(epochs: int, mid: int) -> None:
    """train.anchor's two phases, each a process of its own, on a fresh
    workdir: the flagship trained for ``epochs`` with the JAX anchor's recipe,
    stopped after ``mid`` and resumed; fails when the module's checks do."""
    cmd = [sys.executable, "-m", "motionbert_tpu_torch.train.anchor",
           "--epochs", str(epochs), "--mid", str(mid)]
    for phase, extra in (("1", ["--fresh"]), ("2", [])):
        t0 = time.perf_counter()
        done = subprocess.run(cmd + ["--phase", phase] + extra, cwd=ROOT)
        log(f"anchor: phase {phase} exit {done.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if done.returncode != 0:
            fail(f"anchor phase {phase} exited {done.returncode}")


# ---------------------------------------------------------------------------
# phase 16, first: the GEMM engine alone (csrc/hopper_gemm.cuh)
# ---------------------------------------------------------------------------

# engine vs the fp32 product rounded at the same point (torch.matmul in fp32,
# TF32 off): fp32 results differ by summation order only; a bf16 result by
# one rounding step either side of a boundary (2**-8 of the value), so twice
# that of max|reference| bounds both (tests/test_torch_cuda.py's bars)
ENGINE_F32_TOL = 1e-4
ENGINE_BF16_TOL = 2 ** -7


def engine_flagship_shape(layout: str, epi: str) -> tuple:
    """(M, N, K) at which the MLP chains launch (layout, epi) at the phase-3
    shape: fc1 and its recompute, fc2, dz and dh, the dW2 partials."""
    M = B * FRAMES * J
    if layout == "TN":
        return M, C, HIDDEN
    wide_out = epi in ("bias_gelu", "bias_gelu_z", "dgelu")
    return (M, HIDDEN, C) if wide_out else (M, C, HIDDEN)


def engine_operands(layout: str, M: int, N: int, K: int, seed: int) -> tuple:
    """(a, w, bias, r, z) on the card from a seeded numpy RNG."""
    rs = np.random.RandomState(seed)
    dev = torch.device("cuda")

    def t(*shape, scale=1.0, dt=torch.bfloat16):
        a = rs.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(device=dev, dtype=dt)

    a = t(M, N) if layout == "TN" else t(M, K)
    w = {"NT": lambda: t(N, K, scale=K ** -0.5),
         "NN": lambda: t(K, N, scale=K ** -0.5),
         "TN": lambda: t(M, K, scale=M ** -0.5)}[layout]()
    shape = (N, K) if layout == "TN" else (M, N)
    return a, w, t(shape[1], scale=0.1), t(*shape), t(*shape, dt=torch.float32)


# B3's engine launches at shapes the MLP chains do not give: qkv (NT, N
# 1536), dh1 (NN, K 1536) and dWqkv (TN, 1536 rows); (layout, epi, M, N, K)
PAIR_BWD_ENGINE_SHAPES = (("NT", "bias", B * FRAMES * J, 3 * C, C),
                          ("NN", "f32", B * FRAMES * J, C, 3 * C),
                          ("TN", "partial", B * FRAMES * J, 3 * C, C))


def engine_case(mlp, layout: str, epi: str, shape: tuple,
                timed_shape: bool) -> None:
    """One (layout, epilogue) launch of the engine at `shape` against the
    fp32 product rounded at the same point, twice for bitwise equality; with
    `timed_shape`, one call's CUDA-event time (the wrapper's host work
    included) and the kernel's device time and TFLOP/s (operations from the
    shape)."""
    args = engine_operands(layout, *shape, seed=sum(shape))
    got = mlp.engine_gemm(layout, epi, *args)
    torch.cuda.synchronize()
    again = mlp.engine_gemm(layout, epi, *args)
    want = mlp.engine_gemm_plain(layout, epi, *args)
    pairs = list(zip(got, again, want)) if epi == "bias_gelu_z" \
        else [(got, again, want)]
    rec = dict(shape=list(shape), bitwise_repeatable=all(
        torch.equal(a, b) for a, b, _ in pairs))
    errs = []
    for a, _, w in pairs:
        if a.shape != w.shape or a.dtype != w.dtype \
                or not torch.isfinite(a).all():
            fail(f"engine {layout}/{epi} {shape}: shape, type or non-finite")
        tol = ENGINE_BF16_TOL if a.dtype == torch.bfloat16 \
            else ENGINE_F32_TOL
        errs.append((rel_err(a, w)[1], rel_l2_t(a, w), tol))
    rec.update(rel_err=[e[0] for e in errs], rel_l2=[e[1] for e in errs],
               tol=[e[2] for e in errs])
    if timed_shape:
        fn = lambda: mlp.engine_gemm(layout, epi, *args)
        ms, dev_ms = time_ms(fn), device_ms(fn, 1)
        flop = 2 * shape[0] * shape[1] * shape[2]
        rec.update(ms=ms, device_ms=dev_ms, tflops=None if dev_ms
                   is None else flop / (dev_ms * 1e-3) / 1e12)
    log(f"engine {layout}/{epi}: " + json.dumps(rec))
    if any(e > tol for e, _, tol in errs):
        fail(f"engine {layout}/{epi} {shape}: max|d|/max|ref| "
             f"{[e[0] for e in errs]} above {[e[2] for e in errs]}")
    if not rec["bitwise_repeatable"]:
        fail(f"engine {layout}/{epi} {shape}: two runs gave different bits")


def phase_engine(mlp) -> None:
    """Each (layout, epilogue) pair the MLP chains launch, at its flagship
    shape and at ragged ones (M 37 and 16,524 with N = K = 64), then the
    pair backward's wider shapes (PAIR_BWD_ENGINE_SHAPES), each through
    engine_case, timed at the flagship shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    M = B * FRAMES * J
    for layout, epi in mlp.ENGINE_CASES:
        for shape in (engine_flagship_shape(layout, epi), (37, 64, 64),
                      (M, 64, 64)):
            engine_case(mlp, layout, epi, shape,
                        shape == engine_flagship_shape(layout, epi))
    for layout, epi, *shape in PAIR_BWD_ENGINE_SHAPES:
        engine_case(mlp, layout, epi, tuple(shape), True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16, second: the pair backward's attention core alone
# (csrc/attention_tc.cuh)
# ---------------------------------------------------------------------------

# tensor-core core vs the plain core as a relative L2: the forward is B8's
# function and takes B8's bar (ST_L2_TOL); the backward rounds dS and its
# three gradients to bf16 and takes the block kernels' (BLOCK_L2_TOL), as
# tests/test_torch_cuda.py holds it
CORE_L2_TOL = 1e-3
CORE_BWD_L2_TOL = 4e-3
CORE_SIZES = (1, 5, 16, 17, 100, 243)


def core_inputs(mode: str, n: int, shape=None, seed: int = 0) -> list:
    """q, k, v and an output gradient on the card, groups of n rows: n frames
    of 5 joints (temporal) or 7 frames of n joints (spatial), or `shape`."""
    shape = shape or ((2, n, 5, C) if mode == "temporal" else (2, 7, n, C))
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.normal(size=shape).astype(np.float32)).to(
        device="cuda", dtype=torch.bfloat16) for _ in range(4)]


def phase_core(fp, at) -> None:
    """The tensor-core core (fp.attention_core / attention_core_bwd, one
    launch each) against the plain core at groups of CORE_SIZES rows, head
    dim 64 and 32, temporal and spatial: the max-based bar and the relative
    L2, twice for bitwise repeatability. Then at the phase-3 shape, D 64:
    its device times (the first design's CUDA-core kernels are retired;
    --baseline profiles them in the other build's B5, B8 and B9)."""
    for mode in ("temporal", "spatial"):
        for heads in (HEADS, 2 * HEADS):
            scale = (C // heads) ** -0.5
            for n in CORE_SIZES:
                q, k, v, g = core_inputs(mode, n, seed=n)
                out = fp.attention_core(q, k, v, mode, heads, scale)
                grads = fp.attention_core_bwd(q, k, v, g, mode, heads, scale)
                torch.cuda.synchronize()
                again = (fp.attention_core(q, k, v, mode, heads, scale),) \
                    + fp.attention_core_bwd(q, k, v, g, mode, heads, scale)
                bitwise = all(torch.equal(a, b)
                              for a, b in zip((out,) + grads, again))
                want = (at.st_attention_plain(q, k, v, mode, heads, scale),) \
                    + at.st_attention_bwd_plain(q, k, v, g, mode, heads,
                                                scale)
                errs = {name: (rel_err(a, w)[1], rel_l2_t(a, w), l2_tol)
                        for name, a, w, l2_tol in zip(
                            ("out", "dq", "dk", "dv"), (out,) + grads, want,
                            (CORE_L2_TOL,) + (CORE_BWD_L2_TOL,) * 3)}
                tag = f"{mode}/n{n}/d{C // heads}"
                log(f"core {tag}: key tiles {fp.core_key_tiles(n)}, "
                    f"bitwise repeatable {bitwise}, (max-rel, rel-L2, L2 "
                    f"bar): " + json.dumps(errs))
                if any(not torch.isfinite(t.float()).all()
                       for t in (out,) + grads):
                    fail(f"core {tag}: non-finite output")
                over = {n_: e for n_, e in errs.items()
                        if not (e[0] <= KERNEL_TOL and e[1] <= e[2])}
                if over:
                    fail(f"core {tag}: over the bars: {over}")
                if not bitwise:
                    fail(f"core {tag}: two runs gave different bits")
                del q, k, v, g, out, grads, again, want
    scale = (C // HEADS) ** -0.5
    for mode in ("temporal", "spatial"):
        q, k, v, g = core_inputs(mode, 0, (B, FRAMES, J, C), seed=40)
        fwd = lambda: fp.attention_core(q, k, v, mode, HEADS, scale)
        bwd = lambda: fp.attention_core_bwd(q, k, v, g, mode, HEADS, scale)
        groups, n = (B * J, FRAMES) if mode == "temporal" else (B * FRAMES, J)
        flop = 4 * groups * n * n * C          # q.k^T and p.v, all heads
        rec = dict(shape=[B, FRAMES, J, C], ms=time_ms(fwd),
                   device_ms=device_ms(fwd, 1), bwd_ms=time_ms(bwd),
                   bwd_device_ms=device_ms(bwd, 1),
                   gflop=flop / 1e9, bwd_gflop=2 * flop / 1e9)
        for key, f in (("tflops", "device_ms"), ("bwd_tflops", "bwd_device_ms")):
            ms = rec[f]
            rec[key] = None if ms is None else \
                flop * (2 if key.startswith("bwd") else 1) / (ms * 1e-3) / 1e12
        log(f"core {mode} at the phase-3 shape: " + json.dumps(rec)
            + "; the CUDA-core kernels are retired: --baseline profiles "
            "them in the other build's B5, B8 and B9")
        del q, k, v, g
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 16 and 17: the standalone attention and MLP blocks
# ---------------------------------------------------------------------------

# bf16 block kernel vs its plain version as a relative L2: rounding flips of
# qkv, attn and the hidden activation only (measured 1.5e-4 to 1.0e-3); the
# bar is the q8 pair's, which a moved rounding point fails
BLOCK_L2_TOL = 4e-3
ATTN_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")
MLP_KEYS = ("ln2_w", "ln2_b", "w1", "b1", "w2", "b2")
# (use_ln, residual): what the model calls (the pre-LN sub-block; the T->S
# stream's unfused path without LayerNorm), then the rest
ATTN_FLAGS = ((True, False), (False, False), (True, True), (False, True))
MLP_FLAGS = ((False, False), (True, True))
# kernel-name fragments a block call's profile may hold: the engine, the
# tensor-core core, the LayerNorm forward rows and one-pass backward, the
# bias column sums, the in-order passes, and PyTorch's fills (the zero
# LayerNorm gradients without use_ln)
BLOCK_KERNELS = ("hg_gemm_kernel", "hg_gemm_pair_kernel", "hg_ln_kernel",
                 "attn_tc_fwd_kernel",
                 "attn_tc_fwd_query_kernel",
                 "attn_tc_bwd_kernel", "attn_tc_bwd_query_kernel",
                 "attn_tc_bwd_key_kernel", "ln_fwd_rows_kernel",
                 "ln_bwd_fused_kernel", "colsum_chunks_kernel",
                 "chunk_sum_kernel", "reduce_splits_kernel",
                 "reduce_partials_kernel", "FillFunctor")


def block_profile_faults(kind: str, backward: bool, rows,
                         use_ln: bool = False) -> list:
    """What a block call's profile must not show: the engine (and for the
    attention block the tensor-core core, forward and in the backward its
    backward too; in a backward the bias column sums, and with use_ln the
    one-pass LayerNorm backward) missing, a kernel outside BLOCK_KERNELS,
    or a retired one (the WMMA GEMM, the CUDA-core attention kernels)."""
    needed = ["hg_gemm_kernel"]
    if kind == "attention":
        needed += ["attn_tc_fwd_kernel"] + (["attn_tc_bwd_kernel"]
                                            if backward else [])
    if backward:
        needed += ["colsum_chunks_kernel", "chunk_sum_kernel"] + (
            ["ln_bwd_fused_kernel"] if use_ln else [])
    names = [key for key, _, _ in rows]
    retired = retired_kernels(rows)
    return ([f"no {k}" for k in needed if not any(k in n for n in names)]
            + [f"runs {n[:80]}" for n in names
               if n in retired or not any(k in n for k in BLOCK_KERNELS)])


def attn_library(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, scale, mode,
                 use_ln, residual):
    """The attention block from PyTorch's own operators: a yardstick of
    speed the port never calls."""
    Bx, Fx, Jx, Cx = x.shape
    d = Cx // HEADS
    h = F.layer_norm(x, (Cx,), ln_w.to(x.dtype), ln_b.to(x.dtype), 1e-6) \
        if use_ln else x
    qkv = F.linear(h, wqkv, bqkv).reshape(Bx, Fx, Jx, 3, HEADS, d)
    perm = (0, 1, 3, 2, 4) if mode == "spatial" else (0, 2, 3, 1, 4)
    q, k, v = (qkv[:, :, :, i].permute(perm) for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    o = o.permute([perm.index(i) for i in range(5)]).reshape(Bx, Fx, Jx, Cx)
    out = F.linear(o, wproj, bproj)
    return x + out if residual else out


def mlp_library(x, ln_w, ln_b, w1, b1, w2, b2, use_ln, residual):
    h = F.layer_norm(x, (x.shape[-1],), ln_w.to(x.dtype), ln_b.to(x.dtype),
                     1e-6) if use_ln else x
    out = F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2)
    return x + out if residual else out


def block_cost(kind: str, mode: str, backward: bool) -> tuple:
    """(FLOPs, bytes) of a block at the phase-3 shape: its products (and the
    attention core); x read and out written once, the weights read once. The
    backward's inputs are x, g and the weights, so the recompute that its
    gradients need counts: the first product (qkv, fc1) three times (the
    recompute, its weight's gradient, its input's), the output product
    (proj, fc2) twice (its weight's gradient and its input's: its output is
    never needed), the core three times (the recompute and a backward of
    four products against the forward's two); x and g read, dx written, the
    weights read and their gradients written once."""
    M = B * FRAMES * J
    if kind == "attention":
        first, second = 3 * C * C, C * C
        b_elems = 3 * C + C
        groups, n = (B * J, FRAMES) if mode == "temporal" else (B * FRAMES, J)
        core = 4 * groups * n * n * C
    else:
        first, second = C * HIDDEN, HIDDEN * C
        b_elems, core = HIDDEN + C, 0
    w_elems = first + second
    param_bytes = (w_elems + b_elems) * 2 + 2 * C * 4
    if backward:
        flops = 2 * M * (3 * first + 2 * second) + 3 * core
        return flops, 3 * M * C * 2 + 2 * param_bytes
    return 2 * M * w_elems + core, 2 * M * C * 2 + param_bytes


def rel_l2_t(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (torch.linalg.norm(out.float() - ref.float())
            / torch.linalg.norm(ref.float()).clamp_min(1e-30)).item()


def block_cases(at, mlp):
    """(kind, mode, forward wrapper, forward plain, backward wrapper,
    backward plain, library, keys, flags, extra arguments)."""
    scale = (C // HEADS) ** -0.5
    for mode in ("temporal", "spatial"):
        yield ("attention", mode, at.fused_attention_block,
               at.attention_block_plain, at.fused_attention_block_bwd,
               at.attention_block_bwd_plain,
               lambda *a, mode=mode: attn_library(*a[:7], scale, mode, *a[7:]),
               ATTN_KEYS, ATTN_FLAGS, (HEADS, scale, mode))
    yield ("mlp", "tokens", mlp.fused_mlp_block, mlp.mlp_block_plain,
           mlp.fused_mlp_block_bwd, mlp.mlp_block_bwd_plain, mlp_library,
           MLP_KEYS, MLP_FLAGS, ())


# the attention block's other head dim (32 at C 512), held to the same bars
# at the phase-16 shape without times
NARROW_HEADS = 2 * HEADS


def narrow_head_cases(mode: str):
    """(tag, extra arguments) of the attention block at head dim
    C // NARROW_HEADS, every flag pair."""
    d = C // NARROW_HEADS
    for use_ln, residual in ATTN_FLAGS:
        yield (f"{mode}/ln{int(use_ln)}res{int(residual)}/d{d}",
               (NARROW_HEADS, d ** -0.5, mode), (use_ln, residual))


def block_fwd_errors(kind: str, tag: str, out, again, ref) -> tuple:
    """(max|d|, max|d|/max|ref|, relative L2) of a block forward's output
    against the plain forward's; fails on a shape other than the plain's, a
    non-finite value, bits that differ run to run, or an error over
    KERNEL_TOL or BLOCK_L2_TOL."""
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        fail(f"{kind} block {tag}: shape {tuple(out.shape)} or non-finite")
    if not torch.equal(out, again):
        fail(f"{kind} block {tag}: two runs gave different bits")
    abs_err, rel = rel_err(out, ref)
    l2 = rel_l2_t(out, ref)
    if not (rel <= KERNEL_TOL and l2 <= BLOCK_L2_TOL):
        fail(f"{kind} block {tag}: max|d|/max|ref| {rel:.3e} (bar "
             f"{KERNEL_TOL}), relative L2 {l2:.3e} (bar {BLOCK_L2_TOL})")
    return abs_err, rel, l2


def phase_block_kernels(at, mlp) -> list:
    """B4 and B6 at the phase-3 shape, every flag pair each takes, against
    their plain versions (the max-based bar and the relative L2), twice for
    bitwise repeatability, with times and each call's profile held to the
    engine and the tensor-core core; then B4 at head dim 32, without
    times."""
    dev = torch.device("cuda")
    modes = {"attention": {}, "mlp": {}}
    for kind, mode, wrapper, plain, _, _, library, keys, flags, extra in \
            block_cases(at, mlp):
        p = pair_inputs(12 if mode == "temporal" else 13, False, dev)
        args = [p["x"]] + [p[k] for k in keys]
        for use_ln, residual in flags:
            fl = (use_ln, residual)
            tag = f"{mode}/ln{int(use_ln)}res{int(residual)}"
            out = wrapper(*args, *extra, *fl)
            torch.cuda.synchronize()
            ref = plain(*args, *extra, *fl)
            abs_err, rel, l2 = block_fwd_errors(
                kind, tag, out, wrapper(*args, *extra, *fl), ref)
            lib_rel = rel_err(library(*args, *fl), ref)[1]
            flops, nbytes = block_cost(kind, mode, False)
            t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
            calls = 10
            dev_ms, rows = device_profile(
                lambda: wrapper(*args, *extra, *fl),
                block_records(kind, False, use_ln), calls)
            rec = dict(
                max_abs_err=abs_err, rel_err=rel, tol=KERNEL_TOL, rel_l2=l2,
                l2_tol=BLOCK_L2_TOL, bitwise_repeatable=True,
                ms=time_ms(lambda: wrapper(*args, *extra, *fl)),
                back_to_back_ms=time_ms_back_to_back(
                    lambda: wrapper(*args, *extra, *fl)),
                plain_ms=time_ms(lambda: plain(*args, *extra, *fl), runs=10,
                                 warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(lambda: library(*args, *fl)),
                library_back_to_back_ms=time_ms_back_to_back(
                    lambda: library(*args, *fl)),
                device_ms=dev_ms,
                device_by_kernel=by_kernel(rows, calls),
                library_device_ms=device_ms(lambda: library(*args, *fl),
                                            None),
                library_rel_err=lib_rel, gflop=flops / 1e9,
                mbytes=nbytes / 1e6)
            log(f"block kernel {kind}/{tag}: " + json.dumps(rec))
            faults = block_profile_faults(kind, False, rows)
            if faults:
                fail(f"{kind} block {tag}: the profile of a call: {faults}")
            modes[kind][tag] = rec
        if kind == "attention":
            for tag, narrow, fl in narrow_head_cases(mode):
                out = wrapper(*args, *narrow, *fl)
                torch.cuda.synchronize()
                ref = plain(*args, *narrow, *fl)
                _, rel, l2 = block_fwd_errors(
                    kind, tag, out, wrapper(*args, *narrow, *fl), ref)
                log(f"block kernel attention/{tag}: max|d|/max|ref| and "
                    f"relative L2 {rel:.3e} / {l2:.3e}, bitwise repeatable")
        del p, args, out, ref
    torch.cuda.empty_cache()
    return [block_record("fused_attention_block", "attention.py:466",
                         modes["attention"], "temporal/ln1res0"),
            block_record("fused_mlp_block", "fused_mlp.py:50", modes["mlp"],
                         "tokens/ln0res0")]


def block_record(name: str, replaces: str, modes: dict, main: str) -> dict:
    m = modes[main]
    return dict(
        name=name, route="cuda",
        source="motionbert_tpu_torch/ops/csrc/block_kernels.cu",
        replaces=f"motionbert_tpu/ops/{replaces}", launches=None,
        max_abs_err=max(r["max_abs_err"] for r in modes.values()),
        ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
        bound_by=m["bound_by"], library_ms=m["library_ms"], mode=main,
        shape=[B, FRAMES, J, C], modes=modes)


def block_grad_errors(kind: str, tag: str, names, got, again, want,
                      use_ln: bool) -> dict:
    """{gradient: (max|d|, max|d|/max|ref|, relative L2)} of a block
    backward's outputs against the plain backward's; fails on a non-finite
    gradient, LayerNorm gradients without use_ln, bits that differ run to
    run, or a gradient over KERNEL_TOL, or for the attention block over
    BLOCK_L2_TOL (the MLP block's relative L2 is logged)."""
    if any(not torch.isfinite(t.float()).all() for t in got):
        fail(f"{kind} block backward {tag}: non-finite gradient")
    if not use_ln and (got[1].any() or got[2].any()):
        fail(f"{kind} block backward {tag}: LayerNorm gradients without "
             f"LayerNorm")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{kind} block backward {tag}: two runs gave different bits")
    errs = {n: (*rel_err(a, b), rel_l2_t(a, b))
            for n, a, b in zip(names, got, want)
            if use_ln or not n.startswith("dln")}
    l2_tol = BLOCK_L2_TOL if kind == "attention" else float("inf")
    over = {n: e[1:] for n, e in errs.items()
            if not (e[1] <= KERNEL_TOL and e[2] <= l2_tol)}
    if over:
        fail(f"{kind} block backward {tag}: (max|d|/max|ref|, relative L2) "
             f"over ({KERNEL_TOL}, {BLOCK_L2_TOL}): {over}")
    return errs


def phase_block_backward(at, mlp) -> list:
    """B5 and B7 as phase_block_kernels holds B4 and B6: each gradient
    against the plain backward's."""
    dev = torch.device("cuda")
    modes = {"attention": {}, "mlp": {}}
    grad_names = {
        "attention": ("dx", "dln_w", "dln_b", "dwqkv", "dbqkv", "dwproj",
                      "dbproj"),
        "mlp": ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")}
    for kind, mode, wrapper, _, kernel, plain, library, keys, flags, extra in \
            block_cases(at, mlp):
        p = pair_inputs(14 if mode == "temporal" else 15, False, dev)
        g = pair_inputs(5, False, dev)["x"]
        fwd = [p["x"]] + [p[k] for k in keys]
        args = [p["x"], g] + [p[k] for k in keys[:-1]]  # no output bias
        for use_ln, residual in flags:
            fl = (use_ln, residual)
            tag = f"{mode}/ln{int(use_ln)}res{int(residual)}"
            got = kernel(*args, *extra, *fl)
            torch.cuda.synchronize()
            again = kernel(*args, *extra, *fl)
            torch.cuda.synchronize()
            want = plain(*args, *extra, *fl)
            errs = block_grad_errors(kind, tag, grad_names[kind], got, again,
                                     want, use_ln)
            leaves = [t.detach().clone().requires_grad_() for t in fwd]
            used = [t for n, t in zip(("x",) + keys, leaves)
                    if use_ln or not n.startswith("ln")]

            def library_bwd():
                return torch.autograd.grad(library(*leaves, *fl), used, g)

            flops, nbytes = block_cost(kind, mode, True)
            t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
            calls = 10
            dev_ms, rows = device_profile(
                lambda: kernel(*args, *extra, *fl),
                block_records(kind, True, use_ln), calls)
            rec = dict(
                rel_err={n: e[1] for n, e in errs.items()},
                rel_l2={n: e[2] for n, e in errs.items()},
                max_abs_err=max(e[0] for e in errs.values()), tol=KERNEL_TOL,
                l2_tol=BLOCK_L2_TOL if kind == "attention" else None,
                bitwise_repeatable=True,
                ms=time_ms(lambda: kernel(*args, *extra, *fl)),
                back_to_back_ms=time_ms_back_to_back(
                    lambda: kernel(*args, *extra, *fl)),
                plain_ms=time_ms(lambda: plain(*args, *extra, *fl), runs=5,
                                 warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(library_bwd, runs=10),
                library_back_to_back_ms=time_ms_back_to_back(library_bwd),
                device_ms=dev_ms,
                device_by_kernel=by_kernel(rows, calls),
                library_device_ms=device_ms(library_bwd, None),
                gflop=flops / 1e9, mbytes=nbytes / 1e6)
            log(f"block backward {kind}/{tag}: " + json.dumps(rec))
            faults = block_profile_faults(kind, True, rows, use_ln)
            if faults:
                fail(f"{kind} block backward {tag}: the profile of a call: "
                     f"{faults}")
            modes[kind][tag] = rec
            del got, again, want, leaves, used
        if kind == "attention":
            for tag, narrow, fl in narrow_head_cases(mode):
                got = kernel(*args, *narrow, *fl)
                torch.cuda.synchronize()
                again = kernel(*args, *narrow, *fl)
                want = plain(*args, *narrow, *fl)
                errs = block_grad_errors(kind, tag, grad_names[kind], got,
                                         again, want, fl[0])
                log(f"block backward attention/{tag}: bitwise repeatable, "
                    f"(max|d|/max|ref|, relative L2): " + json.dumps(
                        {n: e[1:] for n, e in errs.items()}))
                del got, again, want
        del p, g, fwd, args
    torch.cuda.empty_cache()
    return [block_record("fused_attention_block_bwd", "attention.py:633",
                         modes["attention"], "temporal/ln1res0"),
            block_record("fused_mlp_block_bwd", "fused_mlp.py:151",
                         modes["mlp"], "tokens/ln0res0")]


# ---------------------------------------------------------------------------
# phase 18: training with drop-path and dropout
# ---------------------------------------------------------------------------

DROP_PATH_RATE = 0.1
DROP_RATE = 0.1
DROPOUT_STEPS = 3


def phase_drop_path(fp, at, mlp, fwd_records: list, bwd_records: list):
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.losses.pose import LAMBDA_KEYS, pose3d_total_loss
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.train.pose3d import (
        make_train_step, preprocess_batch)
    from motionbert_tpu_torch.train.state import make_adamw

    args = get_config(TRAIN_CONFIG)
    lambdas = {k: args.get(k, 0.0) for k in LAMBDA_KEYS}
    sd = load_state_dict(ANCHOR)
    model = load_backbone(args, device="cuda", drop_path_rate=DROP_PATH_RATE)
    model.load_state_dict(sd, strict=True)
    rates = [round(b.droppath.rate, 4) for b in model.blocks_st]
    log(f"drop-path: {os.path.basename(TRAIN_CONFIG)} built with "
        f"load_backbone(cfg, drop_path_rate={DROP_PATH_RATE}): rates per "
        f"layer {rates}, compute dtype {model.compute_dtype}")
    depth = len(rates)
    if rates[0] != 0.0 or not all(r > 0 for r in rates[1:]):
        fail(f"drop-path rates {rates}: layer 0 must be 0, the others above")

    # first step against the fp32 plain path, both drawing the same masks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = train_batch(REF_BATCH)
    seeded = lambda: torch.Generator(device="cuda").manual_seed(17)
    loss, grads = loss_and_grads(model, x, y, lambdas, generator=seeded())
    ref_model = load_backbone(args, dtype=torch.float32, device="cuda",
                              attn_impl="plain",
                              drop_path_rate=DROP_PATH_RATE)
    ref_model.load_state_dict(sd, strict=True)
    ref_loss, ref_grads = loss_and_grads(ref_model, x, y, lambdas,
                                         generator=seeded())
    ref_model.eval()
    with torch.no_grad():   # evaluation draws no mask
        xb, yb, _ = preprocess_batch(x, y, rootrel=True, no_conf=False)
        ref_eval = pose3d_total_loss(ref_model(xb).float(), yb,
                                     lambdas)[0].item()
    del ref_model
    torch.cuda.empty_cache()
    compare_first_step(
        "drop-path", f"first step, batch {REF_BATCH}, same generator seed "
        f"(the fp32 plain loss without masks: {ref_eval:.6f})", loss, grads,
        ref_loss, ref_grads)
    if ref_eval == ref_loss:
        fail("the masks changed nothing: drop-path did not run")
    del grads, ref_grads

    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd,
                at.fused_attention_block, at.fused_attention_block_bwd,
                mlp.fused_mlp_block, mlp.fused_mlp_block_bwd)

    def counted(fn) -> dict:
        for c in counters:
            c.launches = 0
        fn()
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in counters}

    # TRAIN_STEPS steps through the kernels on one fixed batch
    x, y = train_batch(TRAIN_BATCH)
    opt = make_adamw(model.parameters(), args.learning_rate,
                     args.weight_decay)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = make_train_step(model, opt, lambdas, rootrel=args.rootrel,
                           no_conf=args.no_conf, flip_aug=bool(args.flip),
                           generator=gen)

    def eval_loss():
        model.eval()
        with torch.no_grad():
            xb, yb, _ = preprocess_batch(x, y, rootrel=True, no_conf=False)
            return pose3d_total_loss(model(xb).float(), yb, lambdas)[0].item()

    before = eval_loss()
    losses, timing = [], {}

    def steps():
        losses.append(step(x, y)["total"])   # warms the allocator up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses.extend(step(x, y)["total"] for _ in range(TRAIN_STEPS - 1))
        torch.cuda.synchronize()
        timing["dt"] = (time.perf_counter() - t0) / (TRAIN_STEPS - 1)

    launches = counted(steps)
    dt = timing["dt"]
    peak = torch.cuda.max_memory_allocated()
    after = eval_loss()
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    log(f"drop-path: launches per step {json.dumps(per_step)}")
    unfused = 4 * (depth - 1)   # layers 1..: two blocks of two sub-block pairs
    expect = {"fused_pair_block": 3, "fused_gated_pair_block": 1,
              "fused_pair_block_bwd": 3, "fused_gated_pair_block_bwd": 1,
              "fused_attention_block": unfused,
              "fused_attention_block_bwd": unfused,
              "fused_mlp_block": unfused, "fused_mlp_block_bwd": unfused}
    if per_step != expect:
        fail(f"drop-path step launched {per_step}, expected {expect}")
    losses = [v.item() for v in losses]
    log(f"drop-path: ({TRAIN_BATCH}, {FRAMES}, 17, 3) AdamW steps, "
        f"drop_path_rate {DROP_PATH_RATE}: {dt * 1e3:.2f} ms per step, "
        f"{TRAIN_BATCH / dt:.3f} clips/s, peak memory {peak / 2**30:.3f} GiB; "
        f"fixed-batch evaluation loss {before:.6f} before, {after:.6f} after "
        f"{TRAIN_STEPS} steps; step losses "
        + " ".join(f"{v:.5f}" for v in losses))
    if not (np.isfinite(losses).all() and np.isfinite(after)
            and after < before):
        fail(f"drop-path: loss did not fall: {before} -> {after}")
    for rec in fwd_records + bwd_records:
        rec["launches"] = launches[rec["name"]]

    profile_step("drop-path profile", step, x, y, column_sums=True)

    # evaluation on the same model: the pair path, whatever the rates
    model.eval()
    with torch.no_grad():
        launches = counted(lambda: model(x))
    expect = dict.fromkeys(expect, 0)
    expect.update(fused_pair_block=3 * depth, fused_gated_pair_block=depth)
    log(f"drop-path: one evaluation call launched {json.dumps(launches)}")
    if launches != expect:
        fail(f"evaluation launched {launches}, expected {expect}")
    del model, opt, step
    torch.cuda.empty_cache()

    # dropout: every layer leaves the pair path, the MLP leaves its kernel
    model = load_backbone(args, device="cuda", drop_rate=DROP_RATE)
    model.load_state_dict(sd, strict=True)
    opt = make_adamw(model.parameters(), args.learning_rate,
                     args.weight_decay)
    step = make_train_step(model, opt, lambdas, rootrel=args.rootrel,
                           no_conf=args.no_conf, flip_aug=bool(args.flip),
                           generator=gen)
    t0 = time.perf_counter()
    launches = counted(lambda: losses.extend(
        step(x, y)["total"].item() for _ in range(DROPOUT_STEPS)))
    dt = (time.perf_counter() - t0) / DROPOUT_STEPS
    per_step = {k: v / DROPOUT_STEPS for k, v in launches.items()}
    expect = dict.fromkeys(expect, 0)
    expect.update(fused_attention_block=4 * depth,
                  fused_attention_block_bwd=4 * depth)
    log(f"dropout: drop_rate {DROP_RATE}: launches per step "
        f"{json.dumps(per_step)}; {dt * 1e3:.2f} ms per step (first step "
        f"included); losses "
        + " ".join(f"{v:.5f}" for v in losses[-DROPOUT_STEPS:]))
    if per_step != expect:
        fail(f"dropout step launched {per_step}, expected {expect}")
    if not np.isfinite(losses[-DROPOUT_STEPS:]).all():
        fail("dropout: non-finite loss")
    del model, opt, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: pretraining
# ---------------------------------------------------------------------------

def phase_pretrain(fp):
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.data.augment import NoiseParams, augment2d
    from motionbert_tpu_torch.train.pose3d import train_with_config

    def pretrain_args(epochs):
        args = get_config(PRETRAIN_CONFIG)
        args.update(dim_feat=512, dim_rep=512, num_heads=8, depth=5,
                    mlp_ratio=2, maxlen=243, epochs=epochs,
                    checkpoint_frequency=1)
        for key in ("data_root", "dt_root", "posetrack_root", "instav_root",
                    "noise_path", "d2c_params_path"):
            args[key] = os.path.join(ROOT, args[key])
        return args

    # the corruption on a flagship-length batch on the card
    args = pretrain_args(1)
    noise = NoiseParams.load(args.noise_path, args.d2c_params_path)
    x, _ = train_batch(TRAIN_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(3)
    t0 = time.perf_counter()
    out = augment2d(gen, x, noise, noise=True, mask=True,
                    mask_ratio=args.mask_ratio, mask_T_ratio=args.mask_T_ratio)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    conf = out[..., 2]
    gone = out.abs().sum(-1) == 0                       # (B, F, J)
    frame_gone = gone.all(0).all(-1)                    # (F,)
    frames_masked = frame_gone.float().mean().item()
    joints_masked = gone[:, ~frame_gone].float().mean().item()
    moved = (out[..., :2] - x[..., :2]).abs()[~gone].mean().item()
    log(f"pretrain: augment2d on {tuple(x.shape)} {out.device}: {dt * 1e3:.2f} "
        f"ms (first call); confidence in [{conf.min().item():.4f}, "
        f"{conf.max().item():.4f}]; frames masked {frames_masked:.4f} (ratio "
        f"{args.mask_T_ratio}), joints masked in the other frames "
        f"{joints_masked:.4f} (ratio {args.mask_ratio}); mean |xy noise| "
        f"{moved:.5f}")
    if out.device.type != "cuda" or out.shape != x.shape \
            or not torch.isfinite(out).all() \
            or conf.min().item() < 0 or conf.max().item() > 1:
        fail("augment2d: device, shape, finiteness or confidence range")
    # 243 frame draws (std 0.019) and ~30,000 joint draws (std 0.0013)
    if not (abs(frames_masked - args.mask_T_ratio) <= 0.08
            and abs(joints_masked - args.mask_ratio) <= 0.01
            and 0 < moved < 0.1):
        fail(f"augment2d: masked share {frames_masked:.4f} of the frames, "
             f"{joints_masked:.4f} of the joints, or noise {moved:.5f} out "
             f"of range")
    gen.manual_seed(3)
    again = augment2d(gen, x, noise, noise=True, mask=True,
                      mask_ratio=args.mask_ratio,
                      mask_T_ratio=args.mask_T_ratio)
    if not torch.equal(out, again):
        fail("augment2d: the same generator seed gave another corruption")

    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd)
    for c in counters:
        c.launches = 0
    with tempfile.TemporaryDirectory() as ckpt:
        opts = lambda: types.SimpleNamespace(
            checkpoint=ckpt, pretrained="", resume="", evaluate="",
            selection="", seed=0)
        t0 = time.perf_counter()
        first = train_with_config(pretrain_args(2), opts(),
                                  attn_impl="kernel")
        t1 = time.perf_counter()
        resumed = train_with_config(pretrain_args(3), opts(),
                                    attn_impl="kernel")
        t2 = time.perf_counter()
        roles = sorted(os.listdir(ckpt))
        latest = load_checkpoint(os.path.join(ckpt, "latest_epoch.ckpt"))
    hist = first["history"] + resumed["history"]
    log("pretrain: " + json.dumps([dict(epoch=h["epoch"], lr=h["lr"],
                                        losses=h["losses"], e1=h["e1"])
                                   for h in hist]))
    log(f"pretrain: 2 epochs in {t1 - t0:.2f} s, resumed third in "
        f"{t2 - t1:.2f} s; files {roles}; pair launches "
        f"{json.dumps({c.__name__: c.launches for c in counters})}")
    if [h["epoch"] for h in hist] != [0, 1, 2]:
        fail(f"pretrain ran epochs {[h['epoch'] for h in hist]}")
    if "2d_proj" in hist[0]["losses"] or not all(
            "2d_proj" in h["losses"] and "3d_pos" in h["losses"]
            for h in hist[1:]):
        fail("pretrain: the 2D loss must join at epoch 1 (curriculum 1)")
    if not all(np.isfinite(list(h["losses"].values()) + [h["e1"]]).all()
               for h in hist):
        fail("pretrain: non-finite loss or error")
    if latest["epoch"] != 3 or "latest_epoch.ckpt" not in roles \
            or "best_epoch.ckpt" not in roles:
        fail(f"pretrain: checkpoints {roles}, latest epoch {latest['epoch']}")
    if any(c.launches == 0 for c in counters):
        fail("pretrain: train_with_config did not launch the pair kernels")


def phase_blocks(fp) -> list:
    from motionbert_tpu_torch.ops import attention as at
    from motionbert_tpu_torch.ops import fused_mlp as mlp

    timed("engine", phase_engine, mlp)
    timed("core", phase_core, fp, at)
    fwd = timed("block kernels", phase_block_kernels, at, mlp)
    bwd = timed("block backward", phase_block_backward, at, mlp)
    timed("drop-path", phase_drop_path, fp, at, mlp, fwd, bwd)
    timed("pretrain", phase_pretrain, fp)
    return fwd + bwd



# ---------------------------------------------------------------------------
# phase 20: the attention core alone (B8)
# ---------------------------------------------------------------------------

# B8 kernel vs its plain version as a relative L2: summation order and
# single bf16 flips of P and the output (emulated on the CPU at this shape:
# 6e-5); P left in fp32, or the scores rounded to bf16, measure 2.6e-3 to
# 4.8e-3 there, so this bar fails a moved rounding point
ST_L2_TOL = 1e-3
ST_MODES = {"temporal": "motionbert_tpu/ops/attention.py:166",
            "spatial": "motionbert_tpu/ops/attention.py:225"}


def st_inputs(seed: int, batch: int = B) -> list:
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.normal(size=(batch, FRAMES, J, C)).astype(
        np.float32)).to(device="cuda", dtype=torch.bfloat16)
        for _ in range(3)]


def st_library(q, k, v, mode, scale):
    """softmax(q k^T * scale) v from scaled_dot_product_attention on
    permuted copies of the (B, F, J, C) tensors, the copies included: a
    yardstick of speed the port never calls."""
    Bx, Fx, Jx, Cx = q.shape
    perm = (0, 1, 3, 2, 4) if mode == "spatial" else (0, 2, 3, 1, 4)
    qh, kh, vh = (t.reshape(Bx, Fx, Jx, HEADS, Cx // HEADS).permute(
        perm).contiguous() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    return o.permute([perm.index(i) for i in range(5)]).reshape(
        Bx, Fx, Jx, Cx)


def st_cost(mode: str) -> tuple:
    """(FLOPs, bytes): q.k^T and P.v over every head and group; q, k, v read
    once and the output written once, bf16."""
    groups, n = (B * J, FRAMES) if mode == "temporal" else (B * FRAMES, J)
    return 4 * groups * n * n * C, 4 * B * FRAMES * J * C * 2


ST_FRAMES = (1, 27, FRAMES)


def st_faults(out, again, ref, sliced, tag: str) -> tuple:
    """(max-relative, relative L2) of a B8 output against its plain version;
    fails on a wrong shape, a non-finite value, a bar missed, bits that do
    not repeat, or a packed-slice call that differs from the contiguous
    one."""
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        fail(f"st_attention/{tag}: shape {tuple(out.shape)} or non-finite")
    rel, l2 = rel_err(out, ref)[1], rel_l2_t(out, ref)
    if not (rel <= KERNEL_TOL and l2 <= ST_L2_TOL):
        fail(f"st_attention/{tag}: max|d|/max|ref| {rel:.3e} (bar "
             f"{KERNEL_TOL}), relative L2 {l2:.3e} (bar {ST_L2_TOL})")
    if not torch.equal(out, again):
        fail(f"st_attention/{tag}: two runs gave different bits")
    if not torch.equal(out, sliced):
        fail(f"st_attention/{tag}: slices of a packed qkv (row stride 3C) "
             f"differ from the contiguous q, k, v")
    return rel, l2


def packed_call(at, q, k, v, mode: str, scale: float):
    """st_attention on q, k, v as slices of one packed (B, F, J, 3C)
    projection: row stride 3C, no copy."""
    packed = torch.cat([q, k, v], -1)
    Cx = q.shape[-1]
    return at.st_attention(packed[..., :Cx], packed[..., Cx:2 * Cx],
                           packed[..., 2 * Cx:], mode, HEADS, scale)


def phase_st_attention(at) -> dict:
    """B8 at F 1 and 27 (batch 4) and at the phase-3 shape, both modes,
    against its plain version (the max-based and the relative-L2 bar), twice
    for bitwise repeatability, and on slices of a packed projection equal to
    the contiguous call; at the phase-3 shape with times (one call, back to
    back, and device), bound, the plain version's time and the library
    yardstick with its device time; a call's profile must hold the
    tensor-core core alone. The StAttention backward against the fp32 plain
    backward, per tensor."""
    scale = (C // HEADS) ** -0.5
    modes = {}
    small = {}
    for i, mode in enumerate(ST_MODES):
        for frames in ST_FRAMES[:-1]:
            rs = np.random.RandomState(70 + frames + i)
            q, k, v = (torch.from_numpy(rs.normal(size=(B, frames, J, C))
                                        .astype(np.float32)).to(
                device="cuda", dtype=torch.bfloat16) for _ in range(3))
            args = (q, k, v, mode, HEADS, scale)
            small[f"{mode}/F{frames}"] = st_faults(
                at.st_attention(*args), at.st_attention(*args),
                at.st_attention_plain(*args),
                packed_call(at, q, k, v, mode, scale), f"{mode}/F{frames}")
            del q, k, v
    log("st_attention: (max-relative, relative L2) at small F: "
        + json.dumps(small))
    for i, mode in enumerate(ST_MODES):
        q, k, v = st_inputs(20 + i)
        args = (q, k, v, mode, HEADS, scale)
        out = at.st_attention(*args)
        torch.cuda.synchronize()
        ref = at.st_attention_plain(*args)
        rel, l2 = st_faults(out, at.st_attention(*args), ref,
                            packed_call(at, q, k, v, mode, scale),
                            f"{mode}/F{FRAMES}")
        abs_err = rel_err(out, ref)[0]
        # the witness: kernel and plain version (both bf16) against the
        # core in fp64; the kernel sums in another order than cuBLAS and
        # PyTorch's softmax, so its distance from plain is no measure of
        # its accuracy, this is
        exact = at.st_attention_plain(q.double(), k.double(), v.double(),
                                      mode, HEADS, scale)
        witness = (rel_l2_t(out, exact), rel_l2_t(ref, exact))
        del exact
        if not witness[0] <= WITNESS_MARGIN * witness[1]:
            fail(f"st_attention/{mode}: relative L2 {witness[0]:.3e} from "
                 f"the fp64 core, over {WITNESS_MARGIN} times the plain "
                 f"version's {witness[1]:.3e}")
        lib_rel = rel_err(st_library(q, k, v, mode, scale), ref)[1]
        flops, nbytes = st_cost(mode)
        t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
        library = lambda: st_library(q, k, v, mode, scale)
        calls = 10
        dev_ms, rows = device_profile(lambda: at.st_attention(*args), 1,
                                      calls)
        others = [key for key, _, _ in rows if "attn_tc_fwd_kernel" not in key]
        if others or not rows:
            fail(f"st_attention/{mode}: a call's profile is not one "
                 f"tensor-core core launch: {[key[:80] for key, _, _ in rows]}")
        # the backward: the Function's (plain PyTorch, bf16) against the
        # fp32 plain backward, per tensor
        g = st_inputs(30 + i)[0]
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        grads = torch.autograd.grad(at.st_attention(*leaves, mode, HEADS,
                                                    scale), leaves, g)
        want = at.st_attention_bwd_plain(q.float(), k.float(), v.float(),
                                         g.float(), mode, HEADS, scale)
        bwd_rel = {n: rel_err(a, w)[1] for n, a, w in
                   zip(("dq", "dk", "dv"), grads, want)}
        rec = dict(
            max_abs_err=abs_err, rel_err=rel, tol=KERNEL_TOL, rel_l2=l2,
            l2_tol=ST_L2_TOL, bitwise_repeatable=True,
            ms=time_ms(lambda: at.st_attention(*args)),
            back_to_back_ms=time_ms_back_to_back(
                lambda: at.st_attention(*args)),
            plain_ms=time_ms(lambda: at.st_attention_plain(*args), runs=10,
                             warmup=1),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes > t_ops else "operations",
            device_ms=dev_ms, device_by_kernel=by_kernel(rows, calls),
            library_ms=time_ms(library),
            library_device_ms=device_ms(library, None),
            library_rel_err=lib_rel, gflop=flops / 1e9, mbytes=nbytes / 1e6,
            rel_l2_vs_fp64=witness[0], plain_rel_l2_vs_fp64=witness[1],
            backward_rel_err_vs_fp32=bwd_rel,
            backward_plain_ms=time_ms(lambda: at.st_attention_bwd_plain(
                q, k, v, g, mode, HEADS, scale), runs=5, warmup=1))
        log(f"st_attention/{mode}: " + json.dumps(rec))
        worst = max(bwd_rel.items(), key=lambda kv: kv[1])
        if not worst[1] <= KERNEL_TOL:
            fail(f"st_attention/{mode} backward: {worst[0]} {worst[1]:.3e} "
                 f"from the fp32 plain backward (bar {KERNEL_TOL})")
        modes[mode] = rec
        del q, k, v, g, out, ref, leaves, grads, want
    torch.cuda.empty_cache()
    main = modes["temporal"]
    return dict(
        name="st_attention", route="cuda",
        source="motionbert_tpu_torch/ops/csrc/st_attention_kernels.cu",
        replaces=ST_MODES["temporal"], also_replaces=ST_MODES["spatial"],
        launches=None,
        max_abs_err=max(m["max_abs_err"] for m in modes.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        device_ms=main["device_ms"],
        library_device_ms=main["library_device_ms"],
        mode="temporal", shape=[B, FRAMES, J, C], modes=modes)


# ---------------------------------------------------------------------------
# phase 21: the legacy attention modes
# ---------------------------------------------------------------------------

# mode -> launches of (st_attention, fused_attention_block,
# fused_attention_block_bwd, fused_mlp_block, fused_mlp_block_bwd) in one
# forward and one backward
LEGACY_LAUNCHES = {
    "vanilla": (1, 0, 0, 0, 0), "series": (2, 0, 0, 0, 0),
    "parallel": (2, 0, 0, 0, 0), "coupling": (0, 0, 0, 0, 0),
    "spatial": (0, 1, 1, 0, 0), "temporal": (0, 1, 1, 0, 0),
    "stage_para": (0, 2, 2, 2, 2)}


def legacy_module(mode: str, attn_impl: str):
    from motionbert_tpu_torch.models import dstformer as dst

    if mode == "stage_para":
        return dst.Block(C, HEADS, HIDDEN / C, "stage_para",
                         attn_impl=attn_impl, att_fuse=True)
    return dst.Attention(C, HEADS, mode, attn_impl)


def phase_legacy(fp, at, mlp) -> dict:
    counters = (at.st_attention, at.fused_attention_block,
                at.fused_attention_block_bwd, mlp.fused_mlp_block,
                mlp.fused_mlp_block_bwd)
    pairs = (fp.fused_pair_block, fp.fused_gated_pair_block,
             fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x_all, g_all = st_inputs(40)[:2]
    for c in counters + pairs:
        c.launches = 0
    for mode, want in LEGACY_LAUNCHES.items():
        batch = 2 if mode == "coupling" else B   # fp32 scores: 2.2 GB at 4
        x, g = x_all[:batch], g_all[:batch]
        torch.manual_seed(41)
        model = legacy_module(mode, "kernel").cuda()
        ref = legacy_module(mode, "plain").cuda()
        ref.load_state_dict(model.state_dict(), strict=True)
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaf = x.detach().clone().requires_grad_()
        out = model(leaf)
        (out.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = tuple(c.launches - b for c, b in zip(counters, before))
        ref_leaf = x.detach().float().requires_grad_()
        ref_out = ref(ref_leaf)
        (ref_out * g.float()).sum().backward()
        grads = {"x": leaf.grad.float()}
        grads.update({n: p.grad.float() for n, p in model.named_parameters()})
        ref_grads = {"x": ref_leaf.grad}
        ref_grads.update({n: p.grad for n, p in ref.named_parameters()})
        per = {n: rel_err(grads[n], ref_grads[n])[1] for n in ref_grads}
        cosine = grad_cosine(grads, ref_grads)
        out_rel = rel_err(out, ref_out)[1]
        worst = sorted(per.items(), key=lambda kv: -kv[1])
        names = (c.__name__ for c in counters)
        log(f"legacy/{mode}: batch {batch}, launches "
            f"{dict(zip(names, launched))}; forward+backward {ms:.2f} ms "
            f"(first call); bf16 kernels vs "
            f"fp32 plain: output {out_rel:.3e}, gradient cosine {cosine:.6f}, "
            f"worst " + ", ".join(f"{n} {e:.3e}" for n, e in worst[:4]))
        over = [(n, e) for n, e in worst if not e <= grad_tensor_tol(n)]
        if launched != want:
            fail(f"legacy/{mode} launched {launched}, expected {want}")
        if not (out_rel <= PATH_TOL and cosine >= GRAD_COSINE_MIN) or over:
            fail(f"legacy/{mode} disagrees with the fp32 plain module: "
                 f"output {out_rel:.3e}, cosine {cosine:.6f}, over the bar: "
                 f"{over}")
        del model, ref, leaf, out, ref_leaf, ref_out, grads, ref_grads
        torch.cuda.empty_cache()
    total = {c.__name__: c.launches for c in counters + pairs}
    log(f"legacy: launches over the seven modules: {json.dumps(total)}")
    if any(c.launches for c in pairs):
        fail("legacy: a legacy module launched a pair kernel")
    return total


# ---------------------------------------------------------------------------
# phase 22: action training at the flagship widths
# ---------------------------------------------------------------------------

ACTION_STEPS, SUPCON_STEPS = 5, 3
# The first step through the kernels against the plain path on the same
# inputs and dropout masks, at REF_BATCH x 2 persons and at the config's
# batch (32 x 2, 64 backbone clips: the shapes the timed steps give the
# kernels), the head's BatchNorm on its running statistics. At
# initialisation fc1's output barely varies across a batch (see HEAD_TOL),
# so the batch's own statistics scale rounding up ~125x: with them the
# kernels read gradient cosine 0.9945 against the bf16 plain path, and the
# bf16 plain path 0.9926 against the fp32 one. The
# training-mode BatchNorm is held on its own instead: the head on the card
# against the head on the CPU, fp32 both (HEAD_TOL).
# Against the bf16 plain path (the kernels' rounding points) phase 8's bars
# hold. Against the fp32 plain path they measure bf16 arithmetic, not the
# kernels: the classification gradient is a small sum over 243 frames and 17
# joints of each clip, which bf16 moves by more than the pose3d step's. So
# the phase runs the bf16 plain path against the fp32 one too (the witness),
# and holds the kernels against fp32 to a gradient cosine of
# ACTION_FP32_COSINE_MIN and each tensor to the larger of phase 8's bar and
# WITNESS_MARGIN times the witness's distance on that tensor. Readings on the
# card: batch 4, kernels 0.998870, witness 0.999049, every tensor within
# phase 8's bars; 32 x 2, kernels 0.998697, witness 0.998597, the gate
# ts_attn.2 at 2.03 (bias) and 0.26 (weight), the witness 1.82 and 0.24,
# the kernels against bf16 plain 0.267 and 0.041 there. The head is fp32
# with a ReLU on the bf16 representation: a hidden unit whose pre-activation
# lies within the representation's rounding of 0 is on in one path and off
# in the other, which moves single elements by their whole size; so its
# tensors are held by their relative L2 (to the same bars) and left out of
# the cosine.
ACTION_FP32_COSINE_MIN = 0.995
WITNESS_MARGIN = 2.0
# The fp32 head in training mode, card against CPU: max|d| / max|CPU| of
# each output, and |g| / |g head.bn.bias| of fc1's bias (the BatchNorm
# subtracts the batch mean of fc1's output, so that bias gets no gradient but
# rounding). fc1's output varies across the batch by 5.6e-5 (eps 1e-5), so
# the batch statistics scale fp32 rounding up ~125x: read on the card at 32 x
# 2, gradients 1.64e-3 at worst, logits 2.6e-4, running statistics 1.8e-7,
# fc1's bias 3.8e-4. This holds the card's arithmetic to the CPU's; the
# BatchNorm's formulas are held against the JAX package by the CPU tests.
# The same scaling reaches the ReLU's input (BatchNorm's output): read on
# the card at 32 x 2, 2.3e-3 of its max apart, and one of the 65,536 (clip,
# unit) decisions on the other side of 0, which moved fc1's weight gradient
# by 1.12e-2 (that clip's whole share of one unit's row); with the CPU's
# decisions on both, 1.63e-3. So the ReLU's input is held to this bar, and
# the gradients with the CPU's decisions on both.
HEAD_TOL = 1e-2


def action_batch(n: int, frames: int, classes: int, seed: int) -> tuple:
    """(n, 2, frames, 17, 3) normalized keypoints with confidences, and
    labels; for SupCon (classes None) two clips of each of n / 2 classes."""
    rs = np.random.RandomState(seed)
    x = seeded_motion(rs, 2 * n, frames).reshape(n, 2, frames, 17, 3)
    y = rs.randint(0, classes, n) if classes else np.repeat(
        np.arange(n // 2), 2)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(y).long().cuda())


def checkpoint_blocks(model) -> None:
    """Recompute each backbone block of an ActionNet in the backward: the
    plain path keeps its fp32 attention probabilities for autograd, too many
    at 64 clips to keep for ten blocks at once. The values are the same."""
    from torch.utils.checkpoint import checkpoint

    bb = model.backbone
    for blk in list(bb.blocks_st) + list(bb.blocks_ts):
        blk.forward = lambda *a, _f=blk.forward, **kw: checkpoint(
            _f, *a, use_reentrant=False, **kw)


def action_first_step(model, x, y, seed: int) -> tuple:
    """Cross-entropy, fp32 logits and gradients of one training-mode step
    without the update, the head's dropout from a generator seeded with
    ``seed`` and its BatchNorm on its running statistics."""
    model.train()
    model.head.bn.eval()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = model(x, generator=gen).float()
    loss = F.cross_entropy(logits, y)
    loss.backward()
    # the backbone's output head is unused under return_rep: no gradient
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.train()
    return loss.item(), logits.detach(), grads


def compare_action_step(what: str, got: tuple, ref: tuple,
                        witness: dict = None, tag: str = "action",
                        cosine_min: float = ACTION_FP32_COSINE_MIN,
                        head_witness: dict = None) -> None:
    """``got`` against ``ref`` (each loss, logits, gradients): the logits by
    max|d| / max|ref|, the backbone by ``compare_first_step``, the head's
    tensors by relative L2. ``witness`` None: the reference is the bf16
    plain path, phase 8's bars, the logits held to KERNEL_TOL. Else
    ``witness`` is the bf16 plain path's max|d| / max|ref| from the fp32
    plain path per backbone tensor, the gradient cosine is held to
    ``cosine_min`` (see ACTION_FP32_COSINE_MIN) and each tensor to the
    larger of phase 8's bar and WITNESS_MARGIN times its witness;
    ``head_witness`` (relative L2s) widens the head's bars alike."""
    (loss, logits, grads), (ref_loss, ref_logits, ref_grads) = got, ref
    split = lambda g, head: {n: t for n, t in g.items()
                             if n.startswith("head.") == head}
    head = {n: rel_l2_t(grads[n], t)
            for n, t in split(ref_grads, True).items()}
    logit_err = rel_err(logits, ref_logits)[1]
    log(f"{tag}: {what}: logits max|d|/max|ref| {logit_err:.3e}; head "
        f"gradients by relative L2: "
        + ", ".join(f"{n} {e:.3e}" for n, e in head.items()))
    if witness is None:
        cosine_min, tensor_tol = GRAD_COSINE_MIN, grad_tensor_tol
    else:
        tensor_tol = lambda n: max(grad_tensor_tol(n),
                                   WITNESS_MARGIN * witness[n])
    head_tol = grad_tensor_tol if head_witness is None else (
        lambda n: max(grad_tensor_tol(n), WITNESS_MARGIN * head_witness[n]))
    compare_first_step(tag, what + ", backbone", loss,
                       split(grads, False), ref_loss, split(ref_grads, False),
                       cosine_min, tensor_tol)
    over = [(n, e) for n, e in head.items() if not e <= head_tol(n)]
    if over or (witness is None and not logit_err <= KERNEL_TOL):
        fail(f"{tag}: {what}: logits {logit_err:.3e}, head over the bar: "
             f"{over}")


def head_run(head, feat, y, relu_on=None) -> tuple:
    """One training-mode forward and backward of the classification head
    on ``feat``, without dropout: (tensors, fc1's output batch variance,
    BatchNorm's output). With ``relu_on`` (a boolean tensor of BatchNorm's
    output shape) the ReLU's on/off decisions are taken from it, so that
    two devices' heads can be compared on the same decisions; the rest is
    ActionHeadClassification.forward."""
    from motionbert_tpu_torch.models.action_heads import _pool_feat

    leaf = feat.detach().requires_grad_()
    z = head.fc1(_pool_feat(leaf, 0.0, None))
    pre = head.bn(z)
    act = torch.relu(pre) if relu_on is None else pre * relu_on
    logits = head.fc2(act)
    F.cross_entropy(logits, y).backward()
    t = {"logits": logits.detach(), "d feat": leaf.grad}
    t.update({f"d {n}": p.grad for n, p in head.named_parameters()})
    t.update(running_mean=head.bn.running_mean,
             running_var=head.bn.running_var)
    return ({k: v.detach().cpu().float() for k, v in t.items()},
            z.detach().var(0, unbiased=False).cpu(), pre.detach())


def action_head_check(model, x, y) -> None:
    """The classification head as the timed steps run it, in training mode
    (BatchNorm on the batch's statistics, updating its running averages), on
    the card against a copy on the CPU, fp32 both, on the kernels'
    representation of ``x`` and without dropout (the full-path comparison
    holds the masks): logits, the gradients of the head and of its input,
    and the running statistics after, each by max|d| / max|CPU|, and fc1's
    bias gradient against the BatchNorm bias's, to HEAD_TOL. BatchNorm's
    output (the ReLU's input) is held to HEAD_TOL too; where it lies within
    the two devices' rounding of 0 the ReLU decides differently on them
    (HEAD_TOL's note), and the gradients are then held with the CPU's
    decisions on both."""
    N, M, T, J, C = x.shape
    with torch.no_grad():
        rep = model.backbone(x.reshape(N * M, T, J, C), return_rep=True)
    feat = rep.reshape(N, M, T, J, -1).float()
    head0 = copy.deepcopy(model.head).train()
    runs = {dev: head_run(copy.deepcopy(head0).to(dev), feat.to(dev),
                          y.to(dev)) for dev in ("cuda", "cpu")}
    (card, var, pre_card), (cpu, _, pre_cpu) = runs["cuda"], runs["cpu"]
    # the replica is the module: its logits on the CPU, bit for bit
    with torch.no_grad():
        module_logits = copy.deepcopy(head0).cpu()(feat.cpu())
    if not torch.equal(module_logits, cpu["logits"]):
        fail("action: head_run is not ActionHeadClassification.forward")
    on_cpu = pre_cpu > 0
    flips = int(((pre_card.cpu() > 0) != on_cpu).sum())
    pre_err = rel_err(pre_card.cpu(), pre_cpu)[1]
    if flips:
        card = head_run(copy.deepcopy(head0).cuda(), feat, y.cuda(),
                        on_cpu.cuda())[0]
    vanishing = "d fc1.bias"
    errs = {k: rel_err(card[k], cpu[k])[1] for k in cpu if k != vanishing}
    norm = lambda t: torch.linalg.norm(t).item()
    vanish = max(norm(card[vanishing]), norm(cpu[vanishing])) \
        / norm(cpu["d bn.bias"])
    log(f"action: head in training mode, batch {N} x 2 persons, card against "
        f"CPU (fp32): BatchNorm output {pre_err:.3e}, ReLU decisions that "
        f"differ {flips} of {on_cpu.numel()}"
        + (" (the gradients below on the CPU's decisions)" if flips else "")
        + "; " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f"; fc1.bias |g| / |g bn.bias| {vanish:.3e}; fc1 output batch "
        f"variance mean {var.mean().item():.4e}, median "
        f"{var.median().item():.4e} (BatchNorm eps 1e-5)")
    over = {k: e for k, e in errs.items() if not e <= HEAD_TOL}
    if over or not (vanish <= HEAD_TOL and pre_err <= HEAD_TOL):
        fail(f"action: the head in training mode disagrees between card and "
             f"CPU: {over}, fc1.bias {vanish:.3e}, BatchNorm output "
             f"{pre_err:.3e}")


def action_first_steps(args, model) -> None:
    """The kernels' first step against the bf16 and the fp32 plain path at
    batch REF_BATCH and at the config's batch, and the two plain paths
    against each other (logged first: the witness for
    ACTION_FP32_COSINE_MIN); then the head in training mode at the config's
    batch."""
    from motionbert_tpu_torch.train.action import build_action_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    body = lambda g: {k: t for k, t in g.items() if not k.startswith("head.")}
    for n in (REF_BATCH, args.batch_size):
        x, y = action_batch(n, args.clip_len, args.action_classes, 50)
        got = action_first_step(model, x, y, 51)
        what = (f"first step, batch {n} x 2 persons, the same dropout masks, "
                f"BatchNorm on its running statistics")
        refs = []
        for dtype in (torch.bfloat16, torch.float32):
            ref = build_action_model(args, device="cuda", attn_impl="plain",
                                     dtype=dtype)
            ref.load_state_dict(model.state_dict(), strict=True)
            if n > REF_BATCH:
                checkpoint_blocks(ref)
            refs.append(action_first_step(ref, x, y, 51))
            del ref
            torch.cuda.empty_cache()
        bf, fp = refs
        witness = {k: rel_err(t, fp[2][k])[1] for k, t in body(bf[2]).items()}
        log(f"action: {what}: bf16 plain path against the fp32 plain path "
            f"(the witness): loss rel {abs(bf[0] - fp[0]) / abs(fp[0]):.3e}, "
            f"backbone gradient cosine "
            f"{grad_cosine(body(bf[2]), body(fp[2])):.6f}, logits max|d|/"
            f"max|ref| {rel_err(bf[1], fp[1])[1]:.3e}; worst tensors "
            + ", ".join(f"{k} {e:.3e}" for k, e in sorted(
                witness.items(), key=lambda kv: -kv[1])[:8]))
        compare_action_step(what + ", against the bf16 plain path", got, bf)
        compare_action_step(what + ", against the fp32 plain path", got, fp,
                            witness)
        del got, refs, bf, fp
        torch.cuda.empty_cache()
    action_head_check(model, x, y)


def phase_action(fp) -> None:
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.train.action import (
        build_action_model, make_action_train_step, validate)
    from motionbert_tpu_torch.train.action_1shot import (
        make_supcon_train_step, validate_1shot)
    from motionbert_tpu_torch.train.state import make_two_group_adamw

    args = get_config(ACTION_CONFIG)
    model = build_action_model(args, device="cuda")
    model.init_weights(torch.Generator().manual_seed(0))
    log(f"action: {os.path.basename(ACTION_CONFIG)} dim {args.dim_feat} depth "
        f"{args.depth} heads {args.num_heads}, {args.action_classes} classes, "
        f"hidden {args.hidden_dim}, dropout {args.dropout_ratio}, backbone "
        f"{model.backbone.compute_dtype}, head fp32, lr {args.lr_backbone} / "
        f"{args.lr_head}")

    action_first_steps(args, model)

    x, y = action_batch(args.batch_size, args.clip_len, args.action_classes,
                        52)
    opt = make_two_group_adamw(model, args.lr_backbone, args.lr_head,
                               args.weight_decay)
    step = make_action_train_step(
        model, opt, torch.Generator(device="cuda").manual_seed(0))
    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd)
    for c in counters:
        c.launches = 0
    metrics = [step(x, y)]                     # warms the allocator up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics += [step(x, y) for _ in range(ACTION_STEPS - 1)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (ACTION_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    per_step = {c.__name__: c.launches / ACTION_STEPS for c in counters}
    clips = 2 * args.batch_size
    losses = [m["loss"].item() for m in metrics]
    bn = model.head.bn
    log(f"action: ({args.batch_size}, 2, {args.clip_len}, 17, 3) two-group "
        f"AdamW steps: {dt * 1e3:.2f} ms per step, {clips / dt:.3f} clips/s "
        f"({args.batch_size / dt:.3f} samples/s), peak memory "
        f"{peak / 2**30:.3f} GiB; launches per step {json.dumps(per_step)}; "
        f"losses " + " ".join(f"{v:.5f}" for v in losses) + f"; top1 "
        + " ".join(f"{m['top1'].item():.2f}" for m in metrics)
        + f"; BN running mean |.| {bn.running_mean.abs().mean().item():.4e}, "
        f"running var mean {bn.running_var.mean().item():.6f}, batches "
        f"{bn.num_batches_tracked.item()}")
    expect = {"fused_pair_block": 15, "fused_gated_pair_block": 5,
              "fused_pair_block_bwd": 15, "fused_gated_pair_block_bwd": 5}
    if per_step != expect:
        fail(f"action step launched {per_step}, expected {expect}")
    if not np.isfinite(losses).all():
        fail(f"action: non-finite losses {losses}")
    if not (torch.isfinite(bn.running_mean).all()
            and torch.isfinite(bn.running_var).all()
            and bn.running_mean.abs().sum() > 0
            and not torch.allclose(bn.running_var, torch.ones_like(
                bn.running_var))
            and bn.num_batches_tracked.item() == ACTION_STEPS):
        fail("action: BatchNorm statistics not finite or not moved")
    del opt, step
    torch.cuda.empty_cache()
    test = [tuple(t.cpu().numpy() for t in action_batch(
        args.batch_size, args.clip_len, args.action_classes, 53 + i))
        for i in range(2)]
    t0 = time.perf_counter()
    v_loss, v_top1, v_top5 = validate(test, model)
    log(f"action: validate on 2 seeded batches of {args.batch_size}: loss "
        f"{v_loss:.5f}, top1 {v_top1:.2f}, top5 {v_top5:.2f} in "
        f"{time.perf_counter() - t0:.2f} s")
    if not (np.isfinite(v_loss) and 0 <= v_top1 <= v_top5 <= 100):
        fail(f"action: validate gave {v_loss}, {v_top1}, {v_top5}")
    del model
    torch.cuda.empty_cache()

    # one-shot: the embed head, SupCon steps, 1-NN matching
    args = get_config(ONESHOT_CONFIG)
    args.model_version = "embed"
    model = build_action_model(args, device="cuda")
    model.init_weights(torch.Generator().manual_seed(1))
    opt = make_two_group_adamw(model, args.lr_backbone, args.lr_head,
                               args.weight_decay)
    step = make_supcon_train_step(
        model, opt, args.hidden_dim, args.temp,
        torch.Generator(device="cuda").manual_seed(1))
    x, y = action_batch(args.batch_size, args.clip_len, None, 60)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(x, y).item() for _ in range(SUPCON_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SUPCON_STEPS
    peak = torch.cuda.max_memory_allocated()
    anchors = tuple(t.cpu().numpy() for t in action_batch(
        20, args.clip_len, None, 61))
    anchors = (anchors[0], np.arange(20))
    tests = tuple(t.cpu().numpy() for t in action_batch(40, args.clip_len,
                                                          20, 62))
    t0 = time.perf_counter()
    acc = validate_1shot([anchors], [tests], model)
    self_acc = validate_1shot([anchors], [anchors], model)
    log(f"oneshot: ({args.batch_size}, 2, {args.clip_len}) SupCon steps "
        f"(temperature {args.temp}): {dt * 1e3:.2f} ms per step (first "
        f"included), peak memory {peak / 2**30:.3f} GiB, losses "
        + " ".join(f"{v:.5f}" for v in losses) + f"; validate_1shot on 20 "
        f"seeded anchors: {acc:.4f} over 40 seeded tests, {self_acc:.4f} "
        f"with the anchors as tests, in {time.perf_counter() - t0:.2f} s")
    if not (np.isfinite(losses).all() and 0.0 <= acc <= 1.0
            and self_acc == 1.0):
        fail(f"oneshot: losses {losses}, accuracy {acc}, {self_acc}")
    del model, opt, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 23: the action drivers
# ---------------------------------------------------------------------------

def write_oneshot_pickle(path: str, n: int = 32, seed: int = 70) -> None:
    """A pyskl-format pickle with oneshot_train / oneshot_val splits: n
    clips of 40-120 frames, one or two persons of smooth COCO-17 tracks in
    pixels, labels 0..7 (0 and 6 are one-shot evaluation classes)."""
    import pickle

    rs = np.random.RandomState(seed)
    anns, split = [], {"oneshot_train": [], "oneshot_val": []}
    for i in range(n):
        frames, persons = int(rs.randint(40, 120)), 1 + i % 2
        t = np.arange(frames)[None, :, None, None] / frames
        shape = (persons, 1, 17, 2)
        kp = (np.array([480.0, 270.0]) + 60 * rs.normal(size=shape)
              + 20 * np.sin(2 * np.pi * (t + rs.uniform(size=shape))))
        anns.append({"frame_dir": f"S{i:03d}", "total_frames": frames,
                     "img_shape": (540, 960),
                     "keypoint": kp.astype(np.float32),
                     "keypoint_score": rs.uniform(0.5, 1.0, (
                         persons, frames, 17)).astype(np.float32),
                     "label": i % 8})
        split["oneshot_train" if i < 8 else "oneshot_val"].append(
            f"S{i:03d}")
    with open(path, "wb") as f:
        pickle.dump({"split": split, "annotations": anns}, f)


def phase_action_drivers(fp) -> None:
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.train import action, action_1shot

    flagship = dict(dim_feat=512, dim_rep=512, num_heads=8, depth=5,
                    mlp_ratio=2, hidden_dim=2048)

    def run(driver, args_fn, tag):
        with tempfile.TemporaryDirectory() as ckpt:
            opts = lambda: types.SimpleNamespace(
                checkpoint=ckpt, pretrained="", resume="", evaluate="",
                selection="", seed=0, print_freq=100)
            t0 = time.perf_counter()
            first = driver.train_with_config(args_fn(False), opts())
            t1 = time.perf_counter()
            resumed = driver.train_with_config(args_fn(True), opts())
            t2 = time.perf_counter()
            roles = sorted(os.listdir(ckpt))
            latest = load_checkpoint(os.path.join(ckpt, "latest_epoch.ckpt"))
        hist = first["history"] + resumed["history"]
        log(f"{tag}: " + json.dumps(hist))
        log(f"{tag}: {len(first['history'])} epoch(s) in {t1 - t0:.2f} s, "
            f"resumed {len(resumed['history'])} in {t2 - t1:.2f} s; files "
            f"{roles}")
        if [h["epoch"] for h in hist] != list(range(len(hist))) \
                or not resumed["history"] or not first["history"]:
            fail(f"{tag}: epochs {[h['epoch'] for h in hist]}")
        if latest["epoch"] != len(hist) or "latest_epoch.ckpt" not in roles:
            fail(f"{tag}: checkpoints {roles}, latest epoch {latest['epoch']}")
        if not np.isfinite([h["loss"] for h in hist]).all():
            fail(f"{tag}: non-finite loss")
        return hist

    def action_args(resume):
        args = get_config(ACTION_SMOKE_CONFIG)
        args.update(flagship, epochs=3 if resume else 2)
        args.data_path = os.path.join(ROOT, args.data_path)
        return args

    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd)
    for c in counters:
        c.launches = 0
    hist = run(action, action_args, "action driver")
    lr0 = action_args(False).lr_backbone
    if abs(hist[-1]["lr"] - lr0 * 0.99 ** 2) > 1e-12:
        fail(f"action driver: resumed at lr {hist[-1]['lr']}")
    with tempfile.TemporaryDirectory() as tmp:
        pkl = os.path.join(tmp, "oneshot.pkl")
        write_oneshot_pickle(pkl)

        def oneshot_args(resume):
            args = get_config(ACTION_SMOKE_CONFIG)
            args.update(flagship, epochs=2 if resume else 1, n_views=2,
                        temp=0.1, data_path=pkl, data_path_1shot=pkl)
            return args

        run(action_1shot, oneshot_args, "oneshot driver")
    launches = {c.__name__: c.launches for c in counters}
    log(f"action drivers: pair launches {json.dumps(launches)}")
    if any(v == 0 for v in launches.values()):
        fail("action drivers: the pair kernels were not launched")


def phase_action_all(fp) -> list:
    from motionbert_tpu_torch.ops import attention as at
    from motionbert_tpu_torch.ops import fused_mlp as mlp

    record = timed("st_attention", phase_st_attention, at)
    launches = timed("legacy", phase_legacy, fp, at, mlp)
    record["launches"] = launches["st_attention"]
    timed("action", phase_action, fp)
    timed("action drivers", phase_action_drivers, fp)
    return [record]


# ---------------------------------------------------------------------------
# phases 24 and 25: the whole-stream kernel (B10)
# ---------------------------------------------------------------------------

STREAM_REPLACES = "motionbert_tpu/ops/fused_stream.py:309"
# The stream against its plain version: two chained pairs, so pass 1's
# rounding flips travel through pass 2 (measured on the card at the phase-3
# shape, max|d| / max|ref| and relative L2: bf16 8.0e-3 / 2.7e-3 ungated,
# 1.2e-2 / 4.5e-3 gated; W8A8 9.8e-3 / 5.8e-3 and 1.5e-2 / 7.7e-3; the W8A8
# card test at F 81 read 2.1e-2 / 5.6e-3): twice a single pair's bars. What
# holds the rounding points is the bit for bit equality with the pair
# chain, each pair held to its own bars by phases 3 and 10.
STREAM_TOL = 2 * KERNEL_TOL
STREAM_L2_TOL = 2 * BLOCK_L2_TOL
# the four public functions at the orders the model calls them: the S->T
# stream ungated, the T->S stream gated (name, gated, q8, order)
STREAM_VARIANTS = (("fused_stream_block", False, False, ("s", "t")),
                   ("fused_gated_stream_block", True, False, ("t", "s")),
                   ("fused_stream_block_q8", False, True, ("s", "t")),
                   ("fused_gated_stream_block_q8", True, True, ("t", "s")))


def stream_modes(order) -> tuple:
    return tuple("spatial" if a == "s" else "temporal" for a in order)


def stream_args(p1: dict, p2: dict, gated: bool) -> list:
    """x, [other,] pass 1's 12 parameters, pass 2's 12, [wg, bg]."""
    args = [p1["x"]] + ([p1["other"]] if gated else [])
    args += [p1[k] for k in PAIR_KEYS] + [p2[k] for k in PAIR_KEYS]
    return args + ([p1["wg"], p1["bg"]] if gated else [])


def stream_chain(pair_fn, gated_fn, p1: dict, p2: dict, gated: bool,
                 scale: float, order) -> torch.Tensor:
    """The same stream as two calls of the ported pair wrappers."""
    m1, m2 = stream_modes(order)
    mid = pair_fn(p1["x"], *[p1[k] for k in PAIR_KEYS], HEADS, scale, m1)
    p = [p2[k] for k in PAIR_KEYS]
    if not gated:
        return pair_fn(mid, *p, HEADS, scale, m2)
    return gated_fn(mid, p1["other"], *p, p1["wg"], p1["bg"], HEADS, scale,
                    m2)


def stream_library(p1: dict, p2: dict, gated: bool, scale: float, order,
                   q8_tier: bool) -> torch.Tensor:
    """Each pair's PyTorch-operator composition (pair_library, or
    pair_q8_library in the W8A8 tier), run twice: the yardstick."""
    lib = pair_q8_library if q8_tier else pair_library
    m1, m2 = stream_modes(order)
    mid = lib(p1, False, scale, m1)
    second = dict(p2, x=mid)
    if gated:
        second.update(other=p1["other"], wg=p1["wg"], bg=p1["bg"])
    return lib(second, gated, scale, m2)


def stream_cost(order, gated: bool, q8_tier: bool) -> tuple:
    """(seconds by operations, bytes) of the stream at the phase-3 shape:
    the two pairs' operations; x (and other) read once, out written once,
    both pairs' weights read once (the inter-pair activation is the
    function's own)."""
    m1, m2 = stream_modes(order)
    inner = 2 * B * FRAMES * J * C * 2
    if q8_tier:
        (t1, b1, _, _), (t2, b2, _, _) = (pair_q8_cost(m1, False),
                                          pair_q8_cost(m2, gated))
        return t1 + t2, b1 + b2 - inner
    (f1, b1), (f2, b2) = pair_cost(m1, False), pair_cost(m2, gated)
    return (f1 + f2) / PEAK_BF16_FLOPS, b1 + b2 - inner


def phase_stream_kernels(fp, q8, fs) -> list:
    """B10's four variants at the phase-3 shape against their plain
    versions (the max-based and the relative-L2 bar), twice for bitwise
    repeatability, bit for bit against the ported pair chain, with times
    (one call, and back to back), the chain's times in the same run, the
    bound, the plain version's time and the library yardstick."""
    scale = (C // HEADS) ** -0.5
    dev = torch.device("cuda")
    records = []
    for i, (name, gated, q8_tier, order) in enumerate(STREAM_VARIANTS):
        wrapper = getattr(fs, name)
        plain = getattr(fs, ("gated_" if gated else "") + "stream_block"
                        + ("_q8" if q8_tier else "") + "_plain")
        pair_fn, gated_fn = ((q8.fused_pair_block_q8,
                              q8.fused_gated_pair_block_q8) if q8_tier else
                             (fp.fused_pair_block, fp.fused_gated_pair_block))
        p1 = pair_inputs(30 + i, gated, dev)
        p2 = pair_inputs(40 + i, False, dev)
        args = stream_args(p1, p2, gated)
        call = lambda: wrapper(*args, HEADS, scale, order)
        chain = lambda: stream_chain(pair_fn, gated_fn, p1, p2, gated, scale,
                                     order)
        out = call()
        torch.cuda.synchronize()
        bitwise = torch.equal(out, call())
        equal_chain = torch.equal(out, chain())
        ref = plain(*args, HEADS, scale, order)
        if out.shape != ref.shape or not torch.isfinite(out.float()).all():
            fail(f"{name}: shape {tuple(out.shape)} or non-finite")
        abs_err, rel = rel_err(out, ref)
        l2 = rel_l2_t(out, ref)
        tol, l2_tol = STREAM_TOL, STREAM_L2_TOL
        lib_rel = rel_err(stream_library(p1, p2, gated, scale, order,
                                         q8_tier), ref)[1]
        t_ops, nbytes = stream_cost(order, gated, q8_tier)
        t_bytes = nbytes / PEAK_HBM_BYTES
        library = lambda: stream_library(p1, p2, gated, scale, order,
                                         q8_tier)
        records_a_call = stream_records(gated, q8_tier)
        calls = 10
        dev_ms, rows = device_profile(call, records_a_call, calls)
        faults = q8_profile_faults(rows, calls, stream_q8_records(gated),
                                   gated) if q8_tier else []
        rec = dict(
            order="".join(order), max_abs_err=abs_err, rel_err=rel, tol=tol,
            rel_l2=l2, l2_tol=l2_tol, bitwise_repeatable=bitwise,
            bitwise_equal_to_pair_chain=equal_chain,
            ms=time_ms(call), back_to_back_ms=time_ms_back_to_back(call),
            device_ms=dev_ms, device_by_kernel=by_kernel(rows, calls),
            chain_ms=time_ms(chain),
            chain_back_to_back_ms=time_ms_back_to_back(chain),
            chain_device_ms=device_ms(chain, records_a_call),
            plain_ms=time_ms(lambda: plain(*args, HEADS, scale, order),
                             runs=5, warmup=1),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes > t_ops else "operations",
            library_ms=time_ms(library),
            library_device_ms=device_ms(library, None),
            library_rel_err=lib_rel, mbytes=nbytes / 1e6)
        if q8_tier:
            rec.update(q8_profile_split(rec["device_by_kernel"]))
        log(f"stream kernel {name}: " + json.dumps(rec))
        if faults:
            fail(f"{name}: a call's profile: {faults}")
        if not (rel <= tol and l2 <= l2_tol):
            fail(f"{name}: max|d|/max|ref| {rel:.3e} (bar {tol}), relative "
                 f"L2 {l2:.3e} (bar {l2_tol})")
        if not (bitwise and equal_chain):
            fail(f"{name}: bitwise repeatable {bitwise}, equal to the pair "
                 f"chain {equal_chain}")
        records.append(dict(
            name=name, route="cuda",
            source="motionbert_tpu_torch/ops/csrc/stream_kernels.cu",
            replaces=STREAM_REPLACES, launches=None, max_abs_err=abs_err,
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            device_ms=rec["device_ms"],
            library_device_ms=rec["library_device_ms"],
            shape=[B, FRAMES, J, C], detail=rec))
        del p1, p2, args, out, ref
        torch.cuda.empty_cache()
    return records


def stream_counters(fp, q8, fs) -> tuple:
    return (fs.fused_stream_block, fs.fused_gated_stream_block,
            fs.fused_stream_block_q8, fs.fused_gated_stream_block_q8,
            fs.fused_stream_block_bwd, fs.fused_gated_stream_block_bwd,
            fp.fused_pair_block, fp.fused_gated_pair_block,
            q8.fused_pair_block_q8, q8.fused_gated_pair_block_q8,
            fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd)


def counted(counters, fn) -> tuple:
    """fn()'s result and the launches of ``counters`` it made (0 omitted)."""
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in counters if c.launches}


def phase_stream_main_path(fp, q8, fs, records: list) -> None:
    """The anchor's (8, 243) flip-TTA lift and representation through
    kernel_stream and kernel_stream_q8, bit for bit equal to kernel and
    kernel_q8, with launch counts and clips/s side by side; served requests
    under kernel_stream; a flagship train step under kernel_stream whose
    gradients equal the pair path's bit for bit."""
    from motionbert_tpu_torch.api import MotionBERT
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.losses.pose import LAMBDA_KEYS
    from motionbert_tpu_torch.models.factory import load_backbone

    x = seeded_motion(np.random.RandomState(0), LIFT_BATCH, FRAMES)
    counters = stream_counters(fp, q8, fs)
    launches = {}
    for stream_impl, pair_impl in (("kernel_stream", "kernel"),
                                   ("kernel_stream_q8", "kernel_q8")):
        mbs = MotionBERT.from_config(CONFIG, checkpoint=ANCHOR,
                                     attn_impl=stream_impl)
        mbp = MotionBERT.from_config(CONFIG, checkpoint=ANCHOR,
                                     attn_impl=pair_impl)
        lifted, got = counted(counters, lambda: mbs.lift(x))
        launches[stream_impl] = got
        suffix = "_q8" if stream_impl.endswith("q8") else ""
        expect = {f"fused_stream_block{suffix}": 10,
                  f"fused_gated_stream_block{suffix}": 10}
        log(f"stream main: {stream_impl}: launches in one flip-TTA lift "
            f"({LIFT_BATCH}, {FRAMES}): {json.dumps(got)}")
        if got != expect:
            fail(f"{stream_impl} lift launched {got}, expected {expect}")
        same = (np.array_equal(lifted, mbp.lift(x)),
                np.array_equal(mbs.get_representation(x),
                               mbp.get_representation(x)))
        times = {stream_impl: [], pair_impl: []}
        for mb, impl in ((mbp, pair_impl), (mbs, stream_impl),
                         (mbs, stream_impl), (mbp, pair_impl)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mb.lift(x)
            times[impl].append(time.perf_counter() - t0)
        log(f"stream main: {stream_impl} vs {pair_impl}: lift and "
            f"representation bitwise equal {same}; clips/s (calls in turns "
            f"pair, stream, stream, pair): " + json.dumps(
                {k: [round(LIFT_BATCH / t, 3) for t in v]
                 for k, v in times.items()}))
        if not all(same):
            fail(f"{stream_impl} differs from {pair_impl}: {same}")
        del mbs, mbp
        torch.cuda.empty_cache()
    for rec in records:
        impl = "kernel_stream_q8" if rec["name"].endswith("q8") \
            else "kernel_stream"
        rec["launches"] = launches[impl][rec["name"]]

    phase_serving(n_requests=8, tag="stream serving",
                  attn_impl="kernel_stream")

    args = get_config(TRAIN_CONFIG)
    lambdas = {k: args.get(k, 0.0) for k in LAMBDA_KEYS}
    sd = load_state_dict(ANCHOR)
    xb, yb = train_batch(TRAIN_BATCH)
    results = {}
    for impl in ("kernel_stream", "kernel"):
        model = load_backbone(args, device="cuda", attn_impl=impl)
        model.load_state_dict(sd, strict=True)
        results[impl] = counted(counters, lambda: loss_and_grads(
            model, xb, yb, lambdas))
        del model
    (loss_s, grads_s), got = results["kernel_stream"]
    (loss_p, grads_p), _ = results["kernel"]
    equal = loss_s == loss_p and all(torch.equal(grads_s[k], grads_p[k])
                                     for k in grads_p)
    expect = {"fused_stream_block": 5, "fused_gated_stream_block": 5,
              "fused_stream_block_bwd": 5, "fused_gated_stream_block_bwd": 5,
              "fused_pair_block_bwd": 15, "fused_gated_pair_block_bwd": 5}
    log(f"stream main: train step ({TRAIN_BATCH}, {FRAMES}) under "
        f"kernel_stream: launches {json.dumps(got)}; loss and every "
        f"gradient bitwise equal to the pair path's: {equal}")
    if got != expect or not equal:
        fail(f"stream train step: launches {got} (expected {expect}), "
             f"bitwise equal {equal}")
    for rec in records:
        rec["launches_train"] = got.get(rec["name"], 0)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 26 and 27: human mesh recovery
# ---------------------------------------------------------------------------

MESH_CONFIG = os.path.join(ROOT, "configs", "mesh", "MB_train_h36m.yaml")
MESH_SMOKE_CONFIG = os.path.join(ROOT, "configs", "mesh",
                                 "MB_train_synth_smoke.yaml")
MESH_VERTS = 6890       # the real SMPL vertex count; the values are seeded
MESH_STEPS = 5
MESH_HEAD_BATCH = 32    # the training-mode head on the CPU: clips x 16 frames


def mesh_batch(smpl, n: int, frames: int, seed: int) -> tuple:
    """(x (n, frames, 17, 3), ground truth {theta, kp_3d, verts}) on the
    card: seeded keypoints, SMPL parameters and their root-relative mesh in
    mm from the card's SMPL forward."""
    from motionbert_tpu_torch.models.smpl import smpl_forward

    rs = np.random.RandomState(seed)
    x = torch.from_numpy(seeded_motion(rs, n, frames)).cuda()
    pose = torch.from_numpy(rs.normal(0, 0.3, (n, frames, 72)).astype(
        np.float32)).cuda()
    shape = torch.from_numpy(rs.normal(0, 1, (n, frames, 10)).astype(
        np.float32)).cuda()
    with torch.no_grad():
        verts = smpl_forward(smpl, shape.reshape(-1, 10), pose.reshape(
            -1, 72))["vertices"] * 1000.0
        kp = torch.einsum("jv,bvc->bjc", smpl.J_regressor_h36m, verts)
    gt = {"theta": torch.cat([pose, shape], -1),
          "kp_3d": (kp - kp[:, :1]).reshape(n, frames, 17, 3),
          "verts": (verts - kp[:, :1]).reshape(n, frames, -1, 3)}
    return x, gt


def mesh_first_step(model, x, gt, lambdas, seed: int) -> tuple:
    """The mesh loss, fp32 kp_3d and gradients of one training-mode step
    without the update: the head's dropout from a generator seeded with
    ``seed``, its BatchNorms on their running statistics."""
    from motionbert_tpu_torch.losses.mesh import mesh_total_loss

    model.train()
    model.head.bn1.eval()
    model.head.bn2.eval()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = model(x, generator=gen)
    loss = mesh_total_loss(out, gt, lambdas)[0]
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.train()
    return loss.item(), out["kp_3d"].detach(), grads


# The mesh loss at initialisation is far more sensitive to rounding than
# the pose3d loss: its velocity term differentiates frame differences of the
# regressed joints, so its gradient reaches a weight as a sum over frames of
# alternating terms, which cancel where the frames' activations are alike
# (the temporal attention makes them so at initialisation), and the head
# turns the representation into rotations and a mesh. On the card at batch
# 4 the bf16 plain path read a backbone gradient cosine of 0.9915 against
# the fp32 plain path, and the kernels 0.9905 against the bf16 plain path;
# with the velocity term weighted 0, 0.9978 and 0.9980 (phase 8's bar is
# 0.999). So the kernels are held twice: at the mesh step's shape with a
# well-conditioned loss (the representation's square distance from a fixed
# random tensor) against the bf16 plain backbone at phase 8's bars
# (mesh_backbone_check),
# and through the config's mesh loss by the witness rule against both plain
# paths: gradient cosine >= 1 - WITNESS_MARGIN x (1 - the witness's), capped
# at ACTION_FP32_COSINE_MIN, and each tensor to the larger of phase 8's bar
# and WITNESS_MARGIN x the witness's largest distance among the tensors that
# phase 8 holds to the same bar (the head's by relative L2). One tensor's
# own witness is too noisy a bar here: at 128 x 16 the kernels read 0.236 on
# blocks_st.2.norm2_s.weight against the bf16 plain path where the witness
# read less than half that on it, and 0.22 on other tensors.


def witness_by_kind(witness: dict) -> dict:
    """Each tensor's witness replaced by the largest among the tensors that
    phase 8 holds to the same bar (grad_tensor_tol)."""
    top = {}
    for n, e in witness.items():
        top[grad_tensor_tol(n)] = max(top.get(grad_tensor_tol(n), 0.0), e)
    return {n: top[grad_tensor_tol(n)] for n in witness}


def mesh_first_steps(args, model, smpl, lambdas) -> None:
    """The kernels' first step through the config's mesh loss against the
    bf16 and the fp32 plain path at batch REF_BATCH and at the config's
    batch, by the witness rule (compare_action_step: the 17 regressed joints
    in place of the logits)."""
    from motionbert_tpu_torch.train.mesh import build_mesh_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    body = lambda g: {k: t for k, t in g.items() if not k.startswith("head.")}
    for n in (REF_BATCH, args.batch_size):
        x, gt = mesh_batch(smpl, n, args.clip_len, 80)
        got = mesh_first_step(model, x, gt, lambdas, 81)
        refs = []
        for dtype in (torch.bfloat16, torch.float32):
            ref = build_mesh_model(args, smpl, device="cuda",
                                   attn_impl="plain", dtype=dtype)
            ref.load_state_dict(model.state_dict(), strict=True)
            refs.append(mesh_first_step(ref, x, gt, lambdas, 81))
            del ref
            torch.cuda.empty_cache()
        bf, fp32 = refs
        what = (f"first step, batch {n} x {args.clip_len} frames, the same "
                f"dropout masks, BatchNorm on its running statistics")
        witness = {k: rel_err(t, fp32[2][k])[1]
                   for k, t in body(bf[2]).items()}
        head_witness = witness_by_kind(
            {k: rel_l2_t(t, fp32[2][k])
             for k, t in bf[2].items() if k.startswith("head.")})
        wcos = grad_cosine(body(bf[2]), body(fp32[2]))
        cos_min = min(ACTION_FP32_COSINE_MIN,
                      1.0 - WITNESS_MARGIN * (1.0 - wcos))
        log(f"mesh: {what}: bf16 plain path against the fp32 plain path "
            f"(the witness): loss rel "
            f"{abs(bf[0] - fp32[0]) / abs(fp32[0]):.3e}, backbone gradient "
            f"cosine {wcos:.6f}, kp_3d max|d|/max|ref| "
            f"{rel_err(bf[1], fp32[1])[1]:.3e}; worst tensors "
            + ", ".join(f"{k} {e:.3e}" for k, e in sorted(
                witness.items(), key=lambda kv: -kv[1])[:8]))
        for ref, name in ((bf, "bf16"), (fp32, "fp32")):
            compare_action_step(
                f"{what}, against the {name} plain path", got, ref,
                witness_by_kind(witness), tag="mesh", cosine_min=cos_min,
                head_witness=head_witness)
        del got, refs, bf, fp32
        torch.cuda.empty_cache()


def mesh_backbone_check(args, model, n: int) -> None:
    """The backbone at the mesh step's shape (n x clip_len frames) through
    the kernels against the bf16 plain backbone, in training mode, on a
    well-conditioned loss (the mean square distance of its representation
    from a fixed seeded tensor): phase 8's bars."""
    from motionbert_tpu_torch.models.factory import load_backbone

    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(85)
    x = torch.from_numpy(seeded_motion(rs, n, args.clip_len)).cuda()
    w = torch.from_numpy(rs.normal(size=(n, args.clip_len, 17, args.dim_rep))
                         .astype(np.float32)).cuda()

    def loss_and_grads(bb):
        bb.train()
        bb.zero_grad(set_to_none=True)
        loss = (bb(x, return_rep=True).float() - w).square().mean()
        loss.backward()
        grads = {k: p.grad.detach().float().clone()
                 for k, p in bb.named_parameters() if p.grad is not None}
        bb.zero_grad(set_to_none=True)
        return loss.item(), grads

    loss, grads = loss_and_grads(model.backbone)
    ref = load_backbone(args, dtype=torch.bfloat16, device="cuda",
                        attn_impl="plain")
    ref.load_state_dict(model.backbone.state_dict(), strict=True)
    ref_loss, ref_grads = loss_and_grads(ref)
    del ref
    torch.cuda.empty_cache()
    compare_first_step("mesh", f"backbone at the mesh step's shape, batch {n} "
                       f"x {args.clip_len} frames, the square distance of its "
                       f"representation from a fixed random tensor, against "
                       f"the bf16 plain backbone", loss, grads, ref_loss,
                       ref_grads)


def mesh_head_check(model, smpl, lambdas, frames: int) -> None:
    """The SMPL head as the timed steps run it, in training mode
    (BatchNorms on the batch's statistics, updating their running averages),
    on the card against a copy on the CPU, fp32 both, on the kernels'
    representation and without dropout: outputs, the gradients of the head
    and of its input, the running statistics after, each by max|d| /
    max|CPU|, and fc1's / fc2's bias gradients against their BatchNorm
    bias's, to HEAD_TOL."""
    from motionbert_tpu_torch.losses.mesh import mesh_total_loss

    x, gt = mesh_batch(smpl, MESH_HEAD_BATCH, frames, 82)
    N, T = x.shape[:2]
    with torch.no_grad():
        feat = model.backbone(x, return_rep=True).reshape(N, T, 17, -1)
    out = {}
    for dev in ("cuda", "cpu"):
        head = copy.deepcopy(model.head).to(dev).train()
        leaf = feat.float().detach().to(dev).requires_grad_()
        res = head(leaf)
        res = {k: v.reshape(N, T, *v.shape[1:]) for k, v in res.items()}
        mesh_total_loss(res, {k: v.to(dev) for k, v in gt.items()},
                        lambdas)[0].backward()
        t = {k: v.detach() for k, v in res.items()}
        t["d feat"] = leaf.grad
        t.update({f"d {n}": p.grad for n, p in head.named_parameters()})
        for bn in ("bn1", "bn2"):
            t.update({f"{bn}.{b}": getattr(getattr(head, bn), b)
                      for b in ("running_mean", "running_var")})
        out[dev] = {k: v.detach().cpu().float() for k, v in t.items()}
    card, cpu = out["cuda"], out["cpu"]
    vanishing = {"d fc1.bias": "d bn1.bias", "d fc2.bias": "d bn2.bias"}
    errs = {k: rel_err(card[k], cpu[k])[1] for k in cpu if k not in vanishing}
    norm = lambda t: torch.linalg.norm(t).item()
    vanish = {k: max(norm(card[k]), norm(cpu[k])) / norm(cpu[b])
              for k, b in vanishing.items()}
    log(f"mesh: head in training mode, {N} x {T} frames, card against CPU "
        f"(fp32): " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + "; " + ", ".join(f"{k} |g| / |g bn bias| {v:.3e}"
                          for k, v in vanish.items()))
    over = {k: e for k, e in errs.items() if not e <= HEAD_TOL}
    if over or not all(v <= HEAD_TOL for v in vanish.values()):
        fail(f"mesh: the head in training mode disagrees between card and "
             f"CPU: {over}, {vanish}")


def smpl_share(smpl, n_frames: int, step_ms: float) -> None:
    """The SMPL layer's forward and backward at the step's frame count,
    timed alone with CUDA events (median of 5), against the step's time."""
    from motionbert_tpu_torch.geometry.rotations import rot6d_to_rotmat
    from motionbert_tpu_torch.models.smpl import smpl_forward

    rs = np.random.RandomState(83)
    six = torch.from_numpy(rs.normal(size=(n_frames, 24, 6)).astype(
        np.float32)).cuda().requires_grad_()
    betas = torch.from_numpy(rs.normal(size=(n_frames, 10)).astype(
        np.float32)).cuda().requires_grad_()

    def fwd_bwd():
        v = smpl_forward(smpl, betas, rot6d_to_rotmat(six),
                         pose2rot=False)["vertices"]
        v.square().mean().backward()

    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(fwd_bwd, runs=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    log(f"mesh: SMPL forward + backward alone, {n_frames} frames x "
        f"{smpl.num_verts} vertices: {ms:.3f} ms, {100 * ms / step_ms:.1f}% "
        f"of the {step_ms:.2f} ms step; peak memory {peak / 2**30:.3f} GiB")


def phase_mesh(fp, fs) -> None:
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.losses.mesh import LAMBDA_KEYS
    from motionbert_tpu_torch.models.smpl import SMPLModel
    from motionbert_tpu_torch.train.mesh import (
        build_mesh_model, make_mesh_eval_step, make_mesh_train_step)
    from motionbert_tpu_torch.train.state import make_two_group_adamw

    args = get_config(MESH_CONFIG)
    lambdas = {k: args[k] for k in LAMBDA_KEYS}
    smpl = SMPLModel.synthetic(num_verts=MESH_VERTS, seed=0).cuda()
    model = build_mesh_model(args, smpl, device="cuda")
    model.init_weights(torch.Generator().manual_seed(0))
    log(f"mesh: {os.path.basename(MESH_CONFIG)} dim {args.dim_feat} depth "
        f"{args.depth} heads {args.num_heads}, hidden {args.hidden_dim}, "
        f"dropout {args.dropout}, clip {args.clip_len}, batch "
        f"{args.batch_size}, a seeded {smpl.num_verts}-vertex body model; "
        f"backbone {model.backbone.compute_dtype}, head and SMPL fp32")

    mesh_backbone_check(args, model, args.batch_size)
    mesh_first_steps(args, model, smpl, lambdas)
    mesh_head_check(model, smpl, lambdas, args.clip_len)

    x, gt = mesh_batch(smpl, args.batch_size, args.clip_len, 84)
    opt = make_two_group_adamw(model, args.lr_backbone, args.lr_head,
                               args.weight_decay)
    step = make_mesh_train_step(model, opt, lambdas,
                                args.get("loss_type", "L1"),
                                torch.Generator(device="cuda").manual_seed(0))
    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd)
    for c in counters:
        c.launches = 0
    terms = [step(x, gt)]                      # warms the allocator up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    terms += [step(x, gt) for _ in range(MESH_STEPS - 1)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (MESH_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    per_step = {c.__name__: c.launches / MESH_STEPS for c in counters}
    losses = [t["total"].item() for t in terms]
    bn = model.head.bn1
    log(f"mesh: ({args.batch_size}, {args.clip_len}, 17, 3) two-group AdamW "
        f"steps: {dt * 1e3:.2f} ms per step, {args.batch_size / dt:.3f} "
        f"clips/s ({args.batch_size * args.clip_len / dt:.1f} frames/s), "
        f"peak memory {peak / 2**30:.3f} GiB; launches per step "
        f"{json.dumps(per_step)}; losses " + " ".join(
            f"{v:.4f}" for v in losses) + "; mpjpe " + " ".join(
            f"{t['mpjpe'].item():.2f}" for t in terms) + "; mpve " + " ".join(
            f"{t['mpve'].item():.2f}" for t in terms) + f"; bn1 running mean "
        f"|.| {bn.running_mean.abs().mean().item():.4e}, batches "
        f"{bn.num_batches_tracked.item()}")
    expect = {"fused_pair_block": 15, "fused_gated_pair_block": 5,
              "fused_pair_block_bwd": 15, "fused_gated_pair_block_bwd": 5}
    if per_step != expect:
        fail(f"mesh step launched {per_step}, expected {expect}")
    if not np.isfinite(losses).all():
        fail(f"mesh: non-finite losses {losses}")
    if not (torch.isfinite(bn.running_mean).all()
            and bn.running_mean.abs().sum() > 0
            and bn.num_batches_tracked.item() == MESH_STEPS):
        fail("mesh: BatchNorm statistics not finite or not moved")
    smpl_share(smpl, args.batch_size * args.clip_len, dt * 1e3)
    profile_step("mesh profile", step, x, gt, column_sums=True)
    del opt, step
    torch.cuda.empty_cache()

    # flip-TTA evaluation through the pair kernels and the stream kernels
    stream = build_mesh_model(args, smpl, device="cuda",
                              attn_impl="kernel_stream")
    stream.load_state_dict(model.state_dict(), strict=True)
    scounters = (fs.fused_stream_block, fs.fused_gated_stream_block,
                 fp.fused_pair_block, fp.fused_gated_pair_block)
    outs = {}
    for tag, m in (("kernel", model), ("kernel_stream", stream)):
        ev = make_mesh_eval_step(m, flip_tta=True)
        outs[tag], got = counted(scounters, lambda: ev(x))
        t = time_ms(lambda: ev(x), runs=3, warmup=1)
        log(f"mesh: flip-TTA eval step ({args.batch_size}, {args.clip_len}) "
            f"through {tag}: {t:.2f} ms, {args.batch_size / t * 1e3:.2f} "
            f"clips/s; launches {json.dumps(got)}")
    same = {k: torch.equal(outs["kernel"][k], outs["kernel_stream"][k])
            for k in outs["kernel"]}
    log(f"mesh: flip-TTA eval, stream against pair kernels, bitwise equal: "
        f"{same}")
    if not all(same.values()) or not all(
            torch.isfinite(v).all() for v in outs["kernel"].values()):
        fail(f"mesh: eval outputs differ or non-finite: {same}")
    del model, stream, outs
    torch.cuda.empty_cache()


def phase_mesh_drivers(fp, fs) -> None:
    """train.mesh.train_with_config on the synthetic mesh set at the
    flagship widths, 2 epochs then a resumed third; the wild-mesh command
    line on a seeded Halpe-26 JSON with --attn_impl pallas_stream."""
    import yaml

    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.infer import wild_mesh
    from motionbert_tpu_torch.train import mesh

    # the flagship's widths and maxlen: the wild command line takes clips
    # of 243 frames
    flagship = dict(dim_feat=512, dim_rep=512, num_heads=8, depth=5,
                    mlp_ratio=2, hidden_dim=1024, maxlen=243)

    def mesh_args(epochs):
        args = get_config(MESH_SMOKE_CONFIG)
        args.update(flagship, epochs=epochs)
        args.data_root = os.path.join(ROOT, args.data_root)
        args.smpl_model_path = os.path.join(ROOT, args.smpl_model_path)
        return args

    counters = (fp.fused_pair_block, fp.fused_gated_pair_block,
                fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd,
                fs.fused_stream_block, fs.fused_gated_stream_block)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ck")
        opts = lambda: types.SimpleNamespace(
            checkpoint=ckpt, pretrained="", resume="", evaluate="",
            selection="", seed=0, print_freq=100)
        t0 = time.perf_counter()
        first, got = counted(counters, lambda: mesh.train_with_config(
            mesh_args(2), opts()))
        t1 = time.perf_counter()
        resumed = mesh.train_with_config(mesh_args(3), opts())
        t2 = time.perf_counter()
        roles = sorted(os.listdir(ckpt))
        latest = load_checkpoint(os.path.join(ckpt, "latest_epoch.ckpt"))
        hist = first["history"] + resumed["history"]
        log("mesh driver: " + json.dumps(hist))
        log(f"mesh driver: 2 epochs in {t1 - t0:.2f} s, resumed third in "
            f"{t2 - t1:.2f} s; files {roles}; launches in the first run "
            f"{json.dumps(got)}")
        if [h["epoch"] for h in hist] != [0, 1, 2] or latest["epoch"] != 3:
            fail(f"mesh driver: epochs {[h['epoch'] for h in hist]}, latest "
                 f"{latest['epoch']}")
        if not all(np.isfinite([h["loss"], h["pw3d_mpjpe"]]).all()
                   for h in hist):
            fail("mesh driver: non-finite loss or error")
        if not (got.get("fused_pair_block_bwd") and got.get("fused_pair_block")):
            fail(f"mesh driver: the pair kernels were not launched: {got}")

        json_path = os.path.join(tmp, "alphapose-results.json")
        frames = (300, 100)
        write_wild_json(json_path, frames)
        cfg = os.path.join(tmp, "mesh_flagship.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump(dict(mesh_args(1)), f)
        out_dir = os.path.join(tmp, "wild")
        t0 = time.perf_counter()
        verts, got = counted(counters, lambda: wild_mesh.main(
            ["--config", cfg, "-j", json_path, "-o", out_dir, "--focus", "0",
             "--attn_impl", "pallas_stream"]))
        dt = time.perf_counter() - t0
        saved = np.load(os.path.join(out_dir, "mesh_verts.npy"))
        log(f"wild mesh: {frames[0]} frames of person 0 in {dt:.2f} s -> "
            f"mesh_verts.npy {saved.shape}; launches {json.dumps(got)}")
        if verts.shape[0] != frames[0] or not np.isfinite(verts).all() \
                or not np.array_equal(saved, verts):
            fail(f"wild mesh: {verts.shape}, or mesh_verts.npy differs")
        if not (got.get("fused_stream_block") and got.get(
                "fused_gated_stream_block")) or got.get("fused_pair_block"):
            fail(f"wild mesh: launched {got}, not the stream kernels")


# ---------------------------------------------------------------------------
# phase 28: data parallel at the flagship widths
# ---------------------------------------------------------------------------

DIST_STEPS = 3      # AdamW steps of the two-rank run and its reference
DIST_WORLD = 2
DIST_TIMEOUT = 600  # seconds: a rank's start-up, a collective, a driver run
# the kernels a train step launches: phase 8's (the pairs), and with
# phase 18's drop-path and dropout rates both on, the attention block's
# (every layer leaves the pair path, the MLP runs in plain PyTorch)
PAIR_TRAIN_KERNELS = ("fused_pair_block", "fused_gated_pair_block",
                      "fused_pair_block_bwd", "fused_gated_pair_block_bwd")
DROP_TRAIN_KERNELS = ("fused_attention_block", "fused_attention_block_bwd")


def train_counters() -> tuple:
    """The launch counters of every kernel a train step can launch."""
    from motionbert_tpu_torch.ops import attention as at
    from motionbert_tpu_torch.ops import fused_mlp as mlp
    from motionbert_tpu_torch.ops import fused_pair as fp

    return (fp.fused_pair_block, fp.fused_gated_pair_block,
            fp.fused_pair_block_bwd, fp.fused_gated_pair_block_bwd,
            at.fused_attention_block, at.fused_attention_block_bwd,
            mlp.fused_mlp_block, mlp.fused_mlp_block_bwd)


def param_tensor_tol(name: str) -> float:
    """Parameters after AdamW steps of two runs whose bf16 gradient sums
    run in another order: phase 8's gradient bars, and a bias takes the
    cancelling-sum bar. A bias's gradient sums every token row of the batch
    (terms of both signs), so its small elements carry the sums' rounding,
    and AdamW moves each element by about the learning rate whatever its
    size: a small element can move the other way (measured on the card:
    17 of phase 28's bias tensors at 0.10-0.14 of their largest value after
    3 steps, every weight matrix below 0.1, the first step's gradients
    within phase 8's bars)."""
    return CANCELLING_SUM_TOL if name.endswith(".bias") \
        else grad_tensor_tol(name)


def dist_model(drops: bool) -> tuple:
    """(args, lambdas, model): phase 8's flagship with the anchor weights on
    the card; with drops, phase 18's drop-path and dropout rates too."""
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.losses.pose import LAMBDA_KEYS
    from motionbert_tpu_torch.models.factory import load_backbone

    args = get_config(TRAIN_CONFIG)
    rates = dict(drop_path_rate=DROP_PATH_RATE, drop_rate=DROP_RATE) \
        if drops else {}
    model = load_backbone(args, device="cuda", **rates)
    model.load_state_dict(load_state_dict(ANCHOR), strict=True)
    return args, {k: args.get(k, 0.0) for k in LAMBDA_KEYS}, model


def dist_steps(model, net, args, lambdas, x, y, steps: int) -> dict:
    """``steps`` AdamW steps of ``net`` (the model, or its DDP wrapper) on
    this rank's rows of the global batch (x, y), the generator seeded alike
    on every rank:
    {"loss": the global batch's loss per step, "grads": the first step's
    gradients (averaged over the ranks), "params": after the steps, "ms":
    the mean time of the steps after the first, "step": the step}."""
    from motionbert_tpu_torch.parallel.mesh import mean_over_ranks, rank_rows
    from motionbert_tpu_torch.train.pose3d import make_train_step
    from motionbert_tpu_torch.train.state import make_adamw

    opt = make_adamw(model.parameters(), args.learning_rate,
                     args.weight_decay)
    names = {p: n for n, p in model.named_parameters()}
    grads = {}

    def keep_first(optimizer, *_):
        if not grads:
            grads.update({names[p]: p.grad.detach().float().clone()
                          for g in optimizer.param_groups
                          for p in g["params"] if p.grad is not None})

    opt.register_step_pre_hook(keep_first)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = make_train_step(net, opt, lambdas, rootrel=args.rootrel,
                           no_conf=args.no_conf, flip_aug=bool(args.flip),
                           generator=gen)
    xr, yr = rank_rows((x, y))
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(mean_over_ranks(step(xr, yr))["total"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"loss": losses, "grads": grads,
            "params": {n: p.detach().float().clone()
                       for n, p in model.named_parameters()},
            "ms": 1e3 * statistics.mean(times[1:]),
            "step": lambda a, b: step(*rank_rows((a, b)))}


def dist_rank(rank: int, store: str, out: str) -> None:
    """One rank of phase 28 (b): gloo, cuda:0, phase 18's rates."""
    import torch.distributed as dist
    from datetime import timedelta

    from motionbert_tpu_torch.parallel.mesh import wrap_ddp

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=DIST_WORLD,
                            timeout=timedelta(seconds=DIST_TIMEOUT))
    try:
        args, lambdas, model = dist_model(True)
        x, y = train_batch(TRAIN_BATCH)
        net = wrap_ddp(model, torch.device("cuda", 0))
        res, got = counted(train_counters(), lambda: dist_steps(
            model, net, args, lambdas, x, y, DIST_STEPS))
        res["launches"] = got
        del res["step"]
        if rank == 0:
            torch.save({k: ({n: t.cpu() for n, t in v.items()}
                            if isinstance(v, dict) and k != "launches" else v)
                        for k, v in res.items()}, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, args_of_rank, world: int, timeout: float) -> None:
    """Run target(*args_of_rank(r)) in ``world`` spawned processes; kill
    them at the deadline; fail unless every one exits 0."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of_rank(r))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    codes = [p.exitcode for p in procs]
    if alive or codes != [0] * world:
        fail(f"ranks exited {codes}" + (f", {len(alive)} killed at the "
                                       f"{timeout:.0f} s deadline"
                                       if alive else ""))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def flagship_smoke_configs(tmp: str, oneshot_pkl: str) -> dict:
    """task -> the path of a YAML config: the task's synthetic smoke set at
    the flagship widths, one epoch (phases 9, 23 and 27's sets)."""
    import yaml

    from motionbert_tpu_torch.core.config import get_config

    flagship = dict(dim_feat=512, dim_rep=512, num_heads=8, depth=5,
                    mlp_ratio=2, epochs=1)
    specs = {
        "pose3d": (SMOKE_CONFIG, {}),
        "action": (ACTION_SMOKE_CONFIG, dict(hidden_dim=2048)),
        "action_1shot": (ACTION_SMOKE_CONFIG, dict(
            hidden_dim=2048, n_views=2, temp=0.1, data_path=oneshot_pkl,
            data_path_1shot=oneshot_pkl)),
        "mesh": (MESH_SMOKE_CONFIG, dict(hidden_dim=1024)),
    }
    paths = {}
    for task, (base, extra) in specs.items():
        args = dict(get_config(base))
        args.update(flagship, **extra)
        for key in ("data_root", "dt_root", "data_path", "smpl_model_path"):
            if key in args and not os.path.isabs(args[key]):
                args[key] = os.path.join(ROOT, args[key])
        paths[task] = os.path.join(tmp, f"{task}.yaml")
        with open(paths[task], "w") as f:
            yaml.safe_dump(args, f)
    return paths


def run_commands(commands: dict, tmp: str) -> dict:
    """Start every command at once (cwd ROOT), wait for each up to
    DIST_TIMEOUT, and fail on a non-zero exit with the end of its output.
    Returns name -> seconds."""
    procs, logs, seconds = {}, {}, {}
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for name, cmd in commands.items():
        logs[name] = open(os.path.join(tmp, f"{name}.log"), "w+")
        procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                       stdout=logs[name],
                                       stderr=subprocess.STDOUT)
    failed = []
    for name, p in procs.items():
        try:
            p.wait(timeout=max(DIST_TIMEOUT - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        seconds[name] = time.perf_counter() - t0
        logs[name].seek(0)
        text = logs[name].read()
        logs[name].close()
        if p.returncode != 0:
            failed.append(name)
            log(f"{name}: exit {p.returncode}; the end of its output:\n"
                + text[-4000:])
    if failed:
        fail(f"data parallel drivers failed: {failed}")
    return seconds


def phase_dist(records: list) -> None:
    """(a) world size 1 under NCCL on a file store: the DDP-wrapped step's
    loss and gradients bit for bit the unwrapped step's, both timed; and
    the reference of (b). (b) two ranks on the one card (gloo), the global
    batch's rows 4 each, phase 18's rates: held to (a) at phase 8's bars.
    (c) the four drivers under torchrun with two ranks on the card, then
    the pose3d checkpoint resumed at world size 1."""
    import torch.distributed as dist

    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.parallel.mesh import wrap_ddp

    counters = train_counters()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) world size 1, NCCL, in this process
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store1",
                                rank=0, world_size=1)
        try:
            x, y = train_batch(TRAIN_BATCH)
            args, lambdas, model = dist_model(False)
            loss, grads = loss_and_grads(model, x, y, lambdas)
            plain_ms = dist_steps(model, model, args, lambdas, x, y,
                                  TRAIN_STEPS)["ms"]
            args, lambdas, model = dist_model(False)
            ddp = wrap_ddp(model, torch.device("cuda", 0))
            (ddp_loss, ddp_grads), ddp_launches = counted(
                counters, lambda: loss_and_grads(ddp, x, y, lambdas))
            ddp_grads = {n[len("module."):]: g for n, g in ddp_grads.items()}
            differ = [n for n in grads if not torch.equal(grads[n],
                                                          ddp_grads[n])]
            log(f"dist (a): world size 1, NCCL: DDP step loss {ddp_loss!r} "
                f"against {loss!r} unwrapped; {len(grads) - len(differ)} of "
                f"{len(grads)} gradients bit for bit; launches "
                f"{json.dumps(ddp_launches)}")
            if ddp_loss != loss or differ or ddp_grads.keys() != grads.keys():
                fail(f"dist (a): the DDP step differs from the unwrapped "
                     f"one: loss {ddp_loss} vs {loss}, gradients {differ}")
            if sorted(ddp_launches) != sorted(PAIR_TRAIN_KERNELS):
                fail(f"dist (a): the DDP step launched {ddp_launches}")
            wrapped = dist_steps(model, ddp, args, lambdas, x, y,
                                 TRAIN_STEPS)
            log(f"dist (a): ({TRAIN_BATCH}, {FRAMES}) AdamW steps: "
                f"{wrapped['ms']:.2f} ms per step DDP-wrapped at world size "
                f"1, {plain_ms:.2f} ms unwrapped")
            profile_step("dist (a) DDP profile", wrapped["step"], x, y)
            del wrapped
            del model, ddp
            torch.cuda.empty_cache()
            args, lambdas, model = dist_model(True)
            ref = dist_steps(model, wrap_ddp(model, torch.device("cuda", 0)),
                             args, lambdas, x, y, DIST_STEPS)
            del model
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        # (b) two ranks sharing the card, gloo
        out = os.path.join(tmp, "world2.pt")
        t0 = time.perf_counter()
        spawn_ranks(dist_rank, lambda r: (r, f"{tmp}/store2", out),
                    DIST_WORLD, DIST_TIMEOUT)
        two = torch.load(out, weights_only=False)
        log(f"dist (b): {DIST_WORLD} ranks sharing one card (gloo; not a "
            f"scaling figure), {TRAIN_BATCH // DIST_WORLD} clips each, "
            f"drop_path_rate {DROP_PATH_RATE}, drop_rate {DROP_RATE}: "
            f"{two['ms']:.2f} ms per step, world size 1 {ref['ms']:.2f}; "
            f"losses {two['loss']} against {ref['loss']}; launches per rank "
            f"{json.dumps(two['launches'])}; {time.perf_counter() - t0:.1f} s "
            f"with the ranks' start")
        if sorted(two["launches"]) != sorted(DROP_TRAIN_KERNELS):
            fail(f"dist (b): a rank launched {two['launches']}")
        for i, (a, b) in enumerate(zip(two["loss"], ref["loss"])):
            if not abs(a - b) <= LOSS_TOL * abs(b):
                fail(f"dist (b): step {i} loss {a} against {b}")
        sides = ("world size 2", "world size 1")
        compare_first_step("dist (b)", "the first step's gradients",
                           two["loss"][0], {n: g.cuda() for n, g in
                                            two["grads"].items()},
                           ref["loss"][0], ref["grads"], sides=sides)
        compare_first_step("dist (b)", f"the parameters after {DIST_STEPS} "
                           f"steps", two["loss"][-1],
                           {n: p.cuda() for n, p in two["params"].items()},
                           ref["loss"][-1], ref["params"], sides=sides,
                           tensor_tol=param_tensor_tol)

        # (c) the drivers under torchrun: two ranks on the card, gloo
        pkl = os.path.join(tmp, "oneshot.pkl")
        write_oneshot_pickle(pkl)
        cfgs = flagship_smoke_configs(tmp, pkl)
        run = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(DIST_WORLD), "--master_addr",
               "localhost"]
        commands = {task: run + ["--master_port", str(free_port()), "-m",
                                 f"motionbert_tpu_torch.train.{task}",
                                 "--config", cfg, "-c",
                                 os.path.join(tmp, task), "--device",
                                 "cuda:0", "--dist_backend", "gloo"]
                    for task, cfg in cfgs.items()}
        seconds = run_commands(commands, tmp)
        for task in cfgs:
            ckpt = os.path.join(tmp, task)
            payload = load_checkpoint(os.path.join(ckpt, "latest_epoch.ckpt"))
            scalars = open(os.path.join(ckpt, "logs",
                                        "scalars.jsonl")).read().splitlines()
            prefixed = [k for k in payload["model"] if k.startswith("module.")]
            log(f"dist (c): {task} under torchrun, {DIST_WORLD} ranks: "
                f"{seconds[task]:.1f} s, checkpoint epoch {payload['epoch']}, "
                f"{len(scalars)} logged scalars; "
                + "; ".join(json.loads(s)["tag"] + " " + str(round(
                    json.loads(s)["value"], 5)) for s in scalars))
            if payload["epoch"] != 1 or prefixed:
                fail(f"dist (c): {task}: epoch {payload['epoch']}, keys "
                     f"{prefixed[:3]}")
            tags = [json.loads(s)["tag"] for s in scalars]
            if len(tags) != len(set(tags)):
                fail(f"dist (c): {task}: scalars logged twice: {tags}")
        # the pose3d checkpoint of world size 2, resumed at world size 1
        with open(cfgs["pose3d"]) as f:
            text = f.read().replace("epochs: 1", "epochs: 2")
        resume_cfg = os.path.join(tmp, "pose3d_resume.yaml")
        with open(resume_cfg, "w") as f:
            f.write(text)
        seconds = run_commands({"pose3d resume": [
            sys.executable, "-m", "motionbert_tpu_torch.train.pose3d",
            "--config", resume_cfg, "-c", os.path.join(tmp, "pose3d"),
            "--device", "cuda:0"]}, tmp)
        payload = load_checkpoint(os.path.join(tmp, "pose3d",
                                               "latest_epoch.ckpt"))
        log(f"dist (c): the world-2 pose3d checkpoint resumed at world size "
            f"1 for epoch 2 in {seconds['pose3d resume']:.1f} s: checkpoint "
            f"epoch {payload['epoch']}, lr {payload['lr']}")
        if payload["epoch"] != 2:
            fail(f"dist (c): the resumed run saved epoch {payload['epoch']}")
    for rec in records:
        if rec["name"] in PAIR_TRAIN_KERNELS:
            rec["launches_dist"] = ddp_launches.get(rec["name"], 0)
    log(f"dist: phase 28 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 29: wild I/O and rendering on the card
# ---------------------------------------------------------------------------

WILD_FPS, WILD_SIZE = 25.0, (1920, 1080)   # write_wild_json's frame
FACES = 13776   # the SMPL mesh's face count


def write_seeded_video(path: str, frames: int, seed: int = 29) -> None:
    """An mp4 of ``frames`` seeded frames of write_wild_json's size."""
    import cv2

    rs = np.random.RandomState(seed)
    w, h = WILD_SIZE
    base = rs.randint(0, 255, (h // 8, w // 8, 3)).astype(np.uint8)
    base = cv2.resize(base, (w, h), interpolation=cv2.INTER_NEAREST)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), WILD_FPS,
                             WILD_SIZE)
    if not writer.isOpened():
        fail(f"render: cv2.VideoWriter cannot open {path}")
    for i in range(frames):
        writer.write(np.roll(base, 4 * i, axis=1))
    writer.release()


def seeded_faces(v_template: np.ndarray, n: int = FACES) -> np.ndarray:
    """n triangles over a body model's vertices: each vertex with its
    nearest neighbours (1st and 2nd, then 2nd and 3rd)."""
    from scipy.spatial import cKDTree

    _, nn = cKDTree(v_template).query(v_template, k=4)
    faces = np.concatenate([nn[:, [0, 1, 2]], nn[:, [0, 2, 3]]])
    return faces[:n].astype(np.int64)


def video_props(path: str) -> tuple:
    """(frames read, fps, (w, h)) of a video through cv2.VideoCapture."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n, fps, size


def frames_per_second(make, n: int) -> float:
    t0 = time.perf_counter()
    frames = make()
    if len(frames) != n:
        fail(f"render: {len(frames)} frames of {n}")
    return n / (time.perf_counter() - t0)


def phase_render(fp, records: list) -> None:
    """A seeded mp4 and read_video_meta; the wild_pose command line with
    --vid_path and rendering (the flagship lift on the card), X3D.mp4 read
    back; the wild_mesh command line the same way on the seeded 6890-vertex
    body model, mesh.mp4 read back; the renderer's frames per second."""
    import yaml

    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.infer import (
        read_video_meta, wild_mesh, wild_pose)
    from motionbert_tpu_torch.models.smpl import (
        _OPTIONAL, _REQUIRED, SMPLModel)
    from motionbert_tpu_torch.viz import render

    counters = (fp.fused_pair_block, fp.fused_gated_pair_block)
    frames = (300, 100)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        json_path = os.path.join(tmp, "alphapose-results.json")
        write_wild_json(json_path, frames)
        video = os.path.join(tmp, "video.mp4")
        t0 = time.perf_counter()
        write_seeded_video(video, frames[0])
        meta = read_video_meta(video)
        log(f"render: a seeded {WILD_SIZE[0]} x {WILD_SIZE[1]} mp4 of "
            f"{frames[0]} frames at {WILD_FPS} fps written in "
            f"{time.perf_counter() - t0:.2f} s; read_video_meta {meta}")
        if meta != (WILD_FPS, WILD_SIZE):
            fail(f"render: read_video_meta gave {meta}")

        out = os.path.join(tmp, "pose")
        t0 = time.perf_counter()
        x3d, got = counted(counters, lambda: wild_pose.main(
            ["--config", CONFIG, "-e", ANCHOR, "-j", json_path, "-o", out,
             "--vid_path", video, "--focus", "0"]))
        dt = time.perf_counter() - t0
        props = video_props(os.path.join(out, "X3D.mp4"))
        want = (frames[0], WILD_FPS, (render.FRAME_SIZE,) * 2)
        log(f"render: wild_pose --vid_path on the card in {dt:.2f} s: "
            f"X3D.npy {x3d.shape}, X3D.mp4 (frames, fps, size) {props}; "
            f"launches {json.dumps(got)}")
        if props != want or x3d.shape != (frames[0], 17, 3):
            fail(f"render: X3D.mp4 {props}, expected {want}")
        if sorted(got) != ["fused_gated_pair_block", "fused_pair_block"]:
            fail(f"render: the wild lift launched {got}")
        launches.update(got)

        smpl = SMPLModel.synthetic(num_verts=MESH_VERTS, seed=0)
        faces = seeded_faces(smpl.numpy("v_template"))
        npz = os.path.join(tmp, "smpl_seeded.npz")
        np.savez(npz, faces=faces, parents=smpl.parents, **{
            k: smpl.numpy(k) for k in _REQUIRED + _OPTIONAL
            if getattr(smpl, k) is not None})
        args = dict(get_config(MESH_SMOKE_CONFIG))
        args.update(dim_feat=512, dim_rep=512, num_heads=8, depth=5,
                    mlp_ratio=2, hidden_dim=1024, maxlen=243,
                    data_root=os.path.join(ROOT, args["data_root"]),
                    smpl_model_path=npz)
        cfg = os.path.join(tmp, "mesh.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump(args, f)
        out = os.path.join(tmp, "mesh")
        t0 = time.perf_counter()
        verts, got = counted(counters, lambda: wild_mesh.main(
            ["--config", cfg, "-j", json_path, "-o", out, "--vid_path",
             video, "--focus", "0"]))
        dt = time.perf_counter() - t0
        props = video_props(os.path.join(out, "mesh.mp4"))
        log(f"render: wild_mesh --vid_path on the card, {MESH_VERTS} "
            f"vertices, {len(faces)} faces, in {dt:.2f} s: mesh_verts.npy "
            f"{verts.shape}, mesh.mp4 (frames, fps, size) {props}; launches "
            f"{json.dumps(got)}")
        if props != want or verts.shape != (frames[0], MESH_VERTS, 3):
            fail(f"render: mesh.mp4 {props}, expected {want}")
        if sorted(got) != ["fused_gated_pair_block", "fused_pair_block"]:
            fail(f"render: the wild mesh launched {got}")
        for k, v in got.items():
            launches[k] += v

        motion2d = np.load(os.path.join(tmp, "pose", "X3D.npy"))[..., :2]
        n2d, n_mesh = 50, 50
        fps = {
            "2d": frames_per_second(lambda: render.skeleton_frames(
                render._to_jdt(motion2d[:n2d]), render.hex2rgb(
                    "#F96706#FB8D43#FDB381")), n2d),
            "3d": frames_per_second(lambda: render.skeleton3d_frames(x3d),
                                    len(x3d)),
            "mesh": frames_per_second(lambda: render.mesh_frames(
                verts[:n_mesh], faces), n_mesh)}
        log(f"render: frames per second (frame generation, no encoding, "
            f"this machine's host CPU): 2D ellipse skeleton 512 x 512 "
            f"{fps['2d']:.1f}, 3D skeleton {fps['3d']:.1f}, mesh "
            f"{MESH_VERTS} vertices / {len(faces)} faces {fps['mesh']:.1f}")
    for rec in records:
        if rec["name"] in launches:
            rec["launches_render"] = launches[rec["name"]]


# ---------------------------------------------------------------------------
# phase 30: tensor parallelism
# ---------------------------------------------------------------------------

TP_T = 2            # model ranks of the kernels' shards and of the grids
TP_BATCH = 2        # clips of the grids' global batch
TP_STEPS = 3        # AdamW steps of (b) before its checkpoint
SHARED_CARD = "ranks share one card: not a scaling figure"
# the TP modes and the TPU kernels they stand in for (the LayerNorm
# backward: B5's and B7's _ln_bwd_rows)
TP_REPLACES = {
    "fused_attention_block_tp": "motionbert_tpu/ops/attention.py:466",
    "fused_attention_block_tp_bwd": "motionbert_tpu/ops/attention.py:633",
    "fused_mlp_block_tp": "motionbert_tpu/ops/fused_mlp.py:50",
    "fused_mlp_block_tp_bwd": "motionbert_tpu/ops/fused_mlp.py:151",
    "fused_ln_bwd": "motionbert_tpu/ops/attention.py:416",
}
# device records of one call by mode, from the chains in
# csrc/block_kernels.cu at FRAMES frames and the shard widths (a weight
# gradient pair and a column sum are two each; B5_tp's core backward is two
# launches on 243-frame groups, one on a frame's joints; B4_tp's LayerNorm
# rides its qkv product and its core is one launch either way;
# tests/test_torch_tp_ops.py reads the chains)
TP_RECORDS = {"fused_attention_block_tp": {"temporal": 3, "spatial": 3},
              "fused_attention_block_tp_bwd": {"temporal": 10, "spatial": 9},
              "fused_mlp_block_tp": {"tokens": 3},
              "fused_mlp_block_tp_bwd": {"tokens": 7},
              "fused_ln_bwd": {"tokens": 2}}
# the kernels a TP call's profile must hold, by mode, and those it must not
TP_NEEDED = {
    "fused_attention_block_tp": {"temporal": ["hg_ln_kernel",
                                              "attn_tc_fwd_query_kernel",
                                              "hg_gemm_kernel"],
                                 "spatial": ["hg_ln_kernel",
                                             "attn_tc_fwd_kernel",
                                             "hg_gemm_kernel"]},
    "fused_attention_block_tp_bwd": {
        "temporal": ["hg_gemm_kernel", "hg_gemm_pair_kernel",
                     "attn_tc_bwd_query_kernel", "attn_tc_bwd_key_kernel"],
        "spatial": ["hg_gemm_kernel", "hg_gemm_pair_kernel",
                    "attn_tc_bwd_kernel"]},
    "fused_mlp_block_tp": {"tokens": ["hg_gemm_kernel"]},
    "fused_mlp_block_tp_bwd": {"tokens": ["hg_gemm_kernel",
                                          "hg_gemm_pair_kernel"]},
    "fused_ln_bwd": {"tokens": ["ln_bwd_fused_kernel", "chunk_sum_kernel"]}}
TP_BARRED = {"fused_attention_block_tp_bwd": ["attn_tc_fwd_kernel"],
             # no row pass, and on 243-frame groups no one-launch core
             "fused_attention_block_tp": ["ln_fwd_rows_kernel",
                                          "attn_tc_fwd_kernel<64, 16>",
                                          "attn_tc_fwd_kernel<32, 16>"]}


def tp_counters() -> tuple:
    from motionbert_tpu_torch.ops import attention as at
    from motionbert_tpu_torch.ops import fused_mlp as mlp

    return (at.fused_attention_block_tp, at.fused_attention_block_tp_bwd,
            mlp.fused_mlp_block_tp, mlp.fused_mlp_block_tp_bwd,
            at.fused_ln_bwd)


def tp_shards(p: dict) -> dict:
    """Model rank 0's shards of TP_T of pair_inputs' weights (the layout of
    parallel.mesh.shard_params): heads [0, HEADS / TP_T) of qkv and proj, the
    first hidden slice of fc1 and fc2."""
    ci, hl = C // TP_T, HIDDEN // TP_T
    rows = torch.cat([torch.arange(ci) + i * C for i in range(3)]).to(
        p["wqkv"].device)
    return dict(p, wqkv=p["wqkv"][rows].contiguous(),
                bqkv=p["bqkv"][rows].contiguous(),
                wproj=p["wproj"][:, :ci].contiguous(),
                w1=p["w1"][:hl].contiguous(), b1=p["b1"][:hl].contiguous(),
                w2=p["w2"][:, :hl].contiguous())


def tp_cost(name: str, mode: str) -> tuple:
    """(FLOPs, bytes) of a TP mode at the phase-3 rows and the shard shapes,
    counted as block_cost counts the whole blocks (the backward's recompute:
    the first product three times, the output product twice, the core three
    times); the partials and dh are fp32 (4 bytes an element), the row
    statistics 8 bytes a row. The LayerNorm backward: dh, x, g and the
    statistics read, dx written, ~10 operations an element."""
    M = B * FRAMES * J
    ci, hl = C // TP_T, HIDDEN // TP_T
    if name == "fused_ln_bwd":
        return 10 * M * C, M * C * (4 + 2 + 2 + 2) + M * 8 + 3 * C * 4
    if name.startswith("fused_attention"):
        first, second, biases = 3 * ci * C, C * ci, 3 * ci
        groups, n = (B * J, FRAMES) if mode == "temporal" else (B * FRAMES, J)
        core = 4 * groups * n * n * ci
    else:
        first, second, biases, core = hl * C, C * hl, hl, 0
    params = (first + second + biases) * 2 + 2 * C * 4
    if name.endswith("_bwd"):
        return (2 * M * (3 * first + 2 * second) + 3 * core,
                M * C * (2 + 2 + 4) + M * 8 + 2 * params)
    return 2 * M * (first + second) + core, M * C * (2 + 4) + params


def tp_library(name: str, args: tuple, heads: int):
    """The same function from PyTorch's own operators on the same shards: a
    yardstick of speed the port never calls (the backwards through
    autograd; the LayerNorm backward is aten's native_layer_norm_backward,
    without the residual)."""
    if name == "fused_ln_bwd":
        dh, x, stats, ln_w, _ = args
        xf, mean, rstd = x.float(), stats[..., :1], stats[..., 1:]
        zeros = torch.zeros_like(ln_w)
        return lambda: torch.ops.aten.native_layer_norm_backward(
            dh, xf, [x.shape[-1]], mean, rstd, ln_w, zeros,
            [True, True, True])
    backward = name.endswith("_bwd")
    if backward:
        x, g, *w = args
    else:
        x, *w = args
        g = None
    if name.startswith("fused_attention"):
        ln_w, ln_b, wqkv, bqkv, wproj, _, scale, mode = w

        def fwd(x, wqkv, bqkv, wproj):
            Bx, Fx, Jx, Cx = x.shape
            ci = wqkv.shape[0] // 3
            h = F.layer_norm(x, (Cx,), ln_w.to(x.dtype), ln_b.to(x.dtype),
                             1e-6)
            qkv = F.linear(h, wqkv, bqkv).reshape(Bx, Fx, Jx, 3, heads,
                                                   ci // heads)
            perm = (0, 1, 3, 2, 4) if mode == "spatial" else (0, 2, 3, 1, 4)
            q, k, v = (qkv[:, :, :, i].permute(perm) for i in range(3))
            o = F.scaled_dot_product_attention(q, k, v, scale=scale)
            o = o.permute([perm.index(i) for i in range(5)]).reshape(
                Bx, Fx, Jx, ci)
            return F.linear(o, wproj).float()
        leaves = (x, wqkv, bqkv, wproj)
    else:
        ln_w, ln_b, w1, b1, w2 = w

        def fwd(x, w1, b1, w2):
            h = F.layer_norm(x, (x.shape[-1],), ln_w.to(x.dtype),
                             ln_b.to(x.dtype), 1e-6)
            return F.linear(F.gelu(F.linear(h, w1, b1)), w2).float()
        leaves = (x, w1, b1, w2)
    if not backward:
        return lambda: fwd(*leaves)
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    return lambda: torch.autograd.grad(fwd(*leaves), leaves, g.float())


def tp_kernel_case(name: str, wrapper, plain, args: tuple, mode: str,
                   heads: int) -> dict:
    """One TP mode against its plain twin (the max-based bar, and for the
    attention modes the relative-L2 bar, per output), twice for bitwise
    repeatability, with times, bound and the library yardstick; a call's
    profile must hold only the chain's kernels."""
    call = lambda: wrapper(*args)
    got = call()
    torch.cuda.synchronize()
    again, want = call(), plain(*args)
    got, again, want = ((t,) if torch.is_tensor(t) else tuple(t)
                        for t in (got, again, want))
    errs = []
    for i, (a, b, w) in enumerate(zip(got, again, want)):
        if a.shape != w.shape or a.dtype != w.dtype or \
                not torch.isfinite(a.float()).all():
            fail(f"tp (a) {name}/{mode}: output {i} {tuple(a.shape)} "
                 f"{a.dtype} or non-finite")
        if not torch.equal(a, b):
            fail(f"tp (a) {name}/{mode}: two runs gave different bits")
        errs.append((*rel_err(a, w), rel_l2_t(a, w)))
    l2_tol = BLOCK_L2_TOL if "attention" in name else float("inf")
    if not all(e[1] <= KERNEL_TOL and e[2] <= l2_tol for e in errs):
        fail(f"tp (a) {name}/{mode}: (max|d|, max|d|/max|ref|, relative L2) "
             f"{errs} over ({KERNEL_TOL}, {l2_tol})")
    flops, nbytes = tp_cost(name, mode)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    library = tp_library(name, args, heads)
    calls = 10
    tag = mode if "attention" in name else "tokens"
    dev_ms, rows = device_profile(call, TP_RECORDS[name][tag], calls)
    names = [key for key, _, _ in rows]
    faults = [f"no {k}" for k in TP_NEEDED[name][tag]
              if not any(k in n for n in names)] \
        + [f"runs {n[:80]}" for n in names
           if not any(k in n for k in BLOCK_KERNELS)
           or any(k in n for k in TP_BARRED.get(name, ()))]
    if dev_ms is None or faults:
        fail(f"tp (a) {name}/{mode}: the profile of a call: {faults}, "
             f"{TP_RECORDS[name][tag]} device records expected")
    rec = dict(
        max_abs_err=max(e[0] for e in errs), rel_err=[e[1] for e in errs],
        rel_l2=[e[2] for e in errs], tol=KERNEL_TOL,
        l2_tol=None if l2_tol == float("inf") else l2_tol,
        bitwise_repeatable=True, ms=time_ms(call),
        back_to_back_ms=time_ms_back_to_back(call), device_ms=dev_ms,
        device_by_kernel=by_kernel(rows, calls),
        plain_ms=time_ms(lambda: plain(*args), runs=5, warmup=1),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes > t_ops else "operations",
        library_ms=time_ms(library, runs=10),
        library_device_ms=device_ms(library, None), gflop=flops / 1e9,
        mbytes=nbytes / 1e6)
    if name == "fused_ln_bwd":
        rec["l2_ms"] = l2_protocol_ms({"kernel": call, "library": library})
    if name in ("fused_attention_block_tp", "fused_attention_block_tp_bwd"):
        from motionbert_tpu_torch.ops import attention as at

        grid = at.attn_tp_bwd_core_grid if name.endswith("_bwd") \
            else at.attn_tp_fwd_core_grid
        rec["core_grid"] = grid(args[0].shape, heads, C // HEADS, mode)
    log(f"tp (a) kernel {name}/{mode} (shards of {TP_T}): " + json.dumps(rec))
    return rec


def tp_groupings() -> dict:
    """The grouped engine launches of B5_tp and B7_tp at phase 30's shard
    shapes (FRAMES-frame rows, Ci and the hidden slice of TP_T), each
    against its two products launched one after the other: bit for bit
    (into the result, a failure otherwise), and device ms in turns
    (separate, grouped, grouped, separate)."""
    from motionbert_tpu_torch.ops import fused_mlp as mlp

    dev = torch.device("cuda")
    M, ci, hl = B * FRAMES * J, C // TP_T, HIDDEN // TP_T
    rs = np.random.RandomState(18)

    def bf(*shape):
        return torch.from_numpy(rs.normal(size=shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    g, h, dz = bf(M, C), bf(M, C), bf(M, hl)
    z = torch.from_numpy(rs.normal(size=(M, hl)).astype(np.float32)).to(dev)
    cases = {
        "B5_tp dWqkv + dWproj": (("TN", "partial", bf(M, 3 * ci), h),
                                 ("TN", "partial", g, bf(M, ci))),
        "B7_tp dW2 + dz": (("TN", "partial", g, bf(M, hl)),
                           ("NN", "dgelu", g, bf(C, hl), None, None, z)),
        "B7_tp dW1 + dh": (("TN", "partial", dz, h),
                           ("NN", "f32", dz, bf(hl, C)))}
    out = {}
    for tag, (first, second) in cases.items():
        grouped = lambda: mlp.engine_gemm_pair(first, second)
        separate = lambda: (mlp.engine_gemm(*first), mlp.engine_gemm(*second))
        bitwise = all(torch.equal(a, b) for a, b in zip(grouped(), separate()))
        if not bitwise:
            fail(f"tp (a) grouped {tag}: not its two launches' bits")
        turns = []
        for which, call, records in (("separate", separate, 2),
                                     ("grouped", grouped, 1),
                                     ("grouped", grouped, 1),
                                     ("separate", separate, 2)):
            ms, rows = device_profile(call, records, 20)
            turns.append(dict(which=which, device_ms=ms,
                              device_by_kernel=by_kernel(rows, 20)))
        # the grouped launch at each lead (hg_gemm_pair's rule picks one)
        leads = {lead: device_profile(
            lambda: mlp.engine_gemm_pair(first, second, lead), 1, 20)[0]
            for lead in range(1, 6)}
        out[tag] = dict(bitwise=bitwise, turns=turns, leads=leads)
        log(f"tp (a) grouped {tag} (shards of {TP_T}): bit for bit its two "
            f"launches; in turns " + json.dumps(turns) + "; device ms by "
            f"lead " + json.dumps(leads))
    del g, h, dz, z, cases
    torch.cuda.empty_cache()
    return out


L2_FLUSH_BYTES = 256 * 2 ** 20      # five times the H100's 50 MB L2


def l2_protocol_ms(fns: dict, runs: int = 20) -> dict:
    """ms of one call of each fn, timed the same way for all: CUDA events
    around the call, a spin kernel enqueued before the first event so that
    the host has enqueued the call before the card reaches it (the events
    time the card); before the spin, either a 256 MB buffer written (the L2
    "flushed") or the same call ("warm": the L2 holds what the call last
    touched, as far as it fits). Median of runs, by "<name>_<state>"."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    out = {}
    for name, fn in fns.items():
        for state in ("flushed", "warm"):
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(runs):
                if state == "flushed":
                    flush.zero_()
                else:
                    fn()
                torch.cuda._sleep(1_000_000)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            out[f"{name}_{state}"] = statistics.median(times)
    del flush
    return out


def phase_tp_kernels() -> list:
    """(a) B4_tp-B7_tp and the LayerNorm backward at the phase-3 rows on
    model rank 0's shards of TP_T (Ci 256, 4 local heads, hidden slice 512),
    temporal and spatial, against their plain twins."""
    from motionbert_tpu_torch.ops import attention as at
    from motionbert_tpu_torch.ops import fused_mlp as mlp

    dev = torch.device("cuda")
    scale, heads = (C // HEADS) ** -0.5, HEADS // TP_T
    modes = {name: {} for name in TP_REPLACES}
    g = pair_inputs(5, False, dev)["x"]
    for mode in ("temporal", "spatial"):
        p = tp_shards(pair_inputs(30 if mode == "temporal" else 31, False,
                                  dev))
        x = p["x"]
        attn = (p["ln1_w"], p["ln1_b"], p["wqkv"], p["bqkv"], p["wproj"])
        fl = (heads, scale, mode)
        cases = [("fused_attention_block_tp", at.fused_attention_block_tp,
                  at.attention_block_tp_plain, (x, *attn, *fl)),
                 ("fused_attention_block_tp_bwd",
                  at.fused_attention_block_tp_bwd,
                  at.attention_block_tp_bwd_plain, (x, g, *attn, *fl))]
        if mode == "temporal":
            m = (p["ln2_w"], p["ln2_b"], p["w1"], p["b1"], p["w2"])
            dh, stats = at.fused_attention_block_tp_bwd(x, g, *attn, *fl)[3:]
            cases += [("fused_mlp_block_tp", mlp.fused_mlp_block_tp,
                       mlp.mlp_block_tp_plain, (x, *m)),
                      ("fused_mlp_block_tp_bwd", mlp.fused_mlp_block_tp_bwd,
                       mlp.mlp_block_tp_bwd_plain, (x, g, *m)),
                      ("fused_ln_bwd", at.fused_ln_bwd, at.ln_bwd_plain,
                       (dh, x, stats, p["ln1_w"], g))]
        for name, wrapper, plain, args in cases:
            tag = mode if "attention" in name else "tokens"
            modes[name][tag] = tp_kernel_case(name, wrapper, plain, args,
                                              mode, heads)
        del p, x, cases
    torch.cuda.empty_cache()
    records = []
    for name, m in modes.items():
        main = m.get("temporal", m.get("tokens"))
        records.append(dict(
            name=name, route="cuda",
            source="motionbert_tpu_torch/ops/csrc/" + (
                "pair_bwd_common.cuh" if name == "fused_ln_bwd"
                else "block_kernels.cu"),
            replaces=TP_REPLACES[name], launches=None,
            max_abs_err=max(r["max_abs_err"] for r in m.values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], device_ms=main["device_ms"],
            library_device_ms=main["library_device_ms"],
            mode="temporal" if "temporal" in m else "tokens",
            shape=[B, FRAMES, J, C], shards=TP_T, modes=m))
    groupings = tp_groupings()
    for rec in records:
        if rec["name"] in ("fused_attention_block_tp_bwd",
                           "fused_mlp_block_tp_bwd"):
            rec["groupings"] = {tag: g for tag, g in groupings.items()
                                if tag.startswith(
                                    "B5" if "attention" in rec["name"]
                                    else "B7")}
    return records


def tp_model(mesh):
    """(args, lambdas, model): phase 8's flagship with the anchor weights on
    the card, sharded over ``mesh`` (None: whole)."""
    from motionbert_tpu_torch.parallel.mesh import shard_params

    args, lambdas, model = dist_model(False)
    return args, lambdas, shard_params(model, mesh)


def tp_batch() -> tuple:
    x, y = train_batch(TRAIN_BATCH)
    return x[:TP_BATCH], y[:TP_BATCH]


def tp_trajectory(model, args, lambdas, x, y, steps: int, ckpt=None,
                  profile_dir=None) -> dict:
    """On this rank's grid: the flip-TTA lift of x (gathered), the first
    step's loss and gradients (gathered whole), the launches of one step,
    ``steps`` AdamW steps (the parameters after, gathered), then with
    ``ckpt`` a checkpoint (every rank calls the save) and one more step
    (its loss and parameters: the trajectory a resumed run must follow).
    With ``profile_dir`` the first step runs under core.profiling.trace
    with annotate regions."""
    from motionbert_tpu_torch.core.checkpoint import CheckpointManager
    from motionbert_tpu_torch.core.profiling import annotate, trace
    from motionbert_tpu_torch.parallel.mesh import (
        eval_rows, gather_named, mean_over_ranks, rank_rows, wrap_ddp)
    from motionbert_tpu_torch.train.pose3d import (
        make_eval_step, make_train_step)
    from motionbert_tpu_torch.train.state import make_adamw

    dev = torch.device("cuda", 0)
    out = {"lift": torch.from_numpy(eval_rows(
        make_eval_step(model, no_conf=args.no_conf, flip_tta=True),
        x.cpu().numpy(), dev, x.shape[0]))}
    opt = make_adamw(model.parameters(), args.learning_rate,
                     args.weight_decay)
    grads = {}

    def keep_first(optimizer, *_):
        if not grads:
            grads.update({n: p.grad.detach().float().clone()
                          for n, p in model.named_parameters()})

    opt.register_step_pre_hook(keep_first)
    step = make_train_step(wrap_ddp(model, dev), opt, lambdas,
                           rootrel=args.rootrel, no_conf=args.no_conf)
    xr, yr = rank_rows((x, y))

    def one():
        return mean_over_ranks(step(xr, yr))["total"].item()

    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with trace(profile_dir), annotate("tp_train_step"):
                (loss, launches) = counted(train_counters() + tp_counters(),
                                           one)
            out["launches"] = launches
        else:
            loss = one()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    out["grads"] = {n: g.cpu() for n, g in gather_named(model, grads).items()}
    out.update(loss=losses, ms=[1e3 * t for t in times],
               params={n: t.float().cpu() for n, t in
                       model.state_dict().items()})
    if ckpt is not None:
        CheckpointManager(ckpt).save_epoch(0, args.learning_rate, model, opt)
        out["next"] = {"loss": one(), "params": {
            n: t.float().cpu() for n, t in model.state_dict().items()}}
    return out


def tp_resume(path: str, mesh) -> dict:
    """(a checkpoint's next step) on ``mesh`` (None: one process): its loss
    and the parameters after, gathered."""
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.parallel.mesh import (
        mean_over_ranks, rank_rows, shard_optimizer_state, wrap_ddp)
    from motionbert_tpu_torch.train.pose3d import make_train_step
    from motionbert_tpu_torch.train.state import make_adamw

    payload = load_checkpoint(path)
    args, lambdas, model = tp_model(None)
    model.load_state_dict(payload["model"], strict=True)
    if mesh is not None:
        from motionbert_tpu_torch.parallel.mesh import shard_params

        shard_params(model, mesh)
    opt = make_adamw(model.parameters(), args.learning_rate,
                     args.weight_decay)
    opt.load_state_dict(shard_optimizer_state(payload["optimizer"], opt,
                                              model))
    step = make_train_step(wrap_ddp(model, torch.device("cuda", 0)), opt,
                           lambdas, rootrel=args.rootrel, no_conf=args.no_conf)
    x, y = tp_batch()
    loss = mean_over_ranks(step(*rank_rows((x, y))))["total"].item()
    return {"loss": loss, "params": {n: t.float().cpu() for n, t in
                                     model.state_dict().items()}}


def tp_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of phase 30 (b) (world 2: the 1 x 2 grid, its checkpoint,
    its profile, then the 2 x 1 grid resuming the checkpoint) or (c) (world
    4: the 2 x 2 grid): gloo, cuda:0."""
    import torch.distributed as dist
    from datetime import timedelta

    from motionbert_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=DIST_TIMEOUT))
    try:
        mesh = make_mesh(world // TP_T, TP_T)
        args, lambdas, model = tp_model(mesh)
        x, y = tp_batch()
        if world == TP_T:
            res = tp_trajectory(model, args, lambdas, x, y, TP_STEPS,
                                ckpt=os.path.join(out_dir, "ckpt"),
                                profile_dir=os.path.join(out_dir, "trace"))
            dist.barrier()
            res["resumed_2x1"] = tp_resume(
                os.path.join(out_dir, "ckpt", "latest_epoch.ckpt"),
                make_mesh(world, 1))
        else:
            res = tp_trajectory(model, args, lambdas, x, y, 1)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"world{world}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def tp_differs(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|d|, max|d|/max|ref|, the share of elements that differ)."""
    d = (got.float() - ref.float()).abs()
    return (d.max().item(), d.max().item() / ref.float().abs().max().item(),
            (d > 0).float().mean().item())


def trace_contents(path: str) -> tuple:
    """(CUDA kernel names, annotate regions) of a Chrome trace that
    core.profiling.trace wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"][:60] for e in events
                      if e.get("cat") == "kernel"})
    regions = sorted({e["name"] for e in events
                      if e.get("cat") == "user_annotation"})
    return kernels, regions


def adamw_reach_tol(params: dict, lr: float, steps: int):
    """Phase 28's parameter bars (``param_tensor_tol``), or AdamW's step
    bound where that is the larger: two runs of ``steps`` AdamW steps whose
    gradients differ by rounding move an element by about the learning rate
    a step each, in opposite directions where its gradient is near zero, so
    they may differ by 2 * steps * lr whatever the tensor's size (the bound
    tests/test_torch_parallel.py holds such elements to). It binds only a
    tensor whose largest value is within that reach: the anchor's att_fuse
    gate weights (max |w| 0.005-0.013 against 2 * 3 * 2e-4), whose
    gradient, like the gate bias's, sums dsg0 = -dsg1 over every row."""
    reach = {n: 2 * steps * lr / max(p.abs().max().item(), 1e-30)
             for n, p in params.items()}
    return lambda n: max(param_tensor_tol(n), reach[n])


def on_card(tensors: dict) -> dict:
    """A rank's gathered tensors back on the card (the comparisons' fp32
    sums over ~42M elements are the card's, as in phases 8 and 28)."""
    return {n: t.cuda() for n, t in tensors.items()}


def phase_tp(records: list) -> None:
    """(a) the TP modes at the shard shapes; (b) the flagship on a 1 x 2
    grid (two ranks, gloo, cuda:0) against world size 1: the lift, the
    first step and 3 AdamW steps, the launches of a step; (c) a 2 x 2 grid
    (four ranks on the card), one step; (d) (b)'s checkpoint resumed at 1 x
    1 and 2 x 1 against (b)'s own next step; (e) (b)'s first step under
    core.profiling.trace, rank 0's trace read back."""
    t_phase = time.perf_counter()
    tp_records = timed("tp (a) kernels", phase_tp_kernels)
    with tempfile.TemporaryDirectory() as tmp:
        # world size 1: the references, on whole weights through the pairs
        args, lambdas, model = tp_model(None)
        x, y = tp_batch()
        ref = tp_trajectory(model, args, lambdas, x, y, TP_STEPS)
        del model
        torch.cuda.empty_cache()
        log(f"tp: world size 1, ({TP_BATCH}, {FRAMES}) AdamW steps "
            f"{[round(t, 2) for t in ref['ms']]} ms, launches "
            f"{json.dumps(ref['launches'])}")
        sides = ("tensor parallel", "world size 1")
        for world, tag in ((TP_T, "(b) 1 x 2"), (2 * TP_T, "(c) 2 x 2")):
            t0 = time.perf_counter()
            spawn_ranks(tp_rank, lambda r: (r, world, f"{tmp}/store{world}",
                                            tmp), world, DIST_TIMEOUT)
            got = torch.load(os.path.join(tmp, f"world{world}.pt"),
                             weights_only=False)
            lift = tp_differs(got["lift"], ref["lift"])
            log(f"tp {tag}: {world} ranks ({SHARED_CARD}), {TP_BATCH} clips "
                f"x {FRAMES}: steps {[round(t, 2) for t in got['ms']]} ms "
                f"against {[round(t, 2) for t in ref['ms']]} at world size "
                f"1; {time.perf_counter() - t0:.1f} s with the ranks' start; "
                f"lift against world size 1's kernels: max|d| {lift[0]:.4e}, "
                f"max|d|/max|ref| {lift[1]:.4e}, {100 * lift[2]:.2f}% of the "
                f"elements differ; losses {got['loss']} against "
                f"{ref['loss'][:len(got['loss'])]}; launches of a step on "
                f"rank 0 {json.dumps(got['launches'])}")
            if not lift[1] <= KERNEL_TOL:
                fail(f"tp {tag}: the lift is {lift[1]:.3e} of max from world "
                     f"size 1's")
            if sorted(got["launches"]) != sorted(TP_REPLACES):
                fail(f"tp {tag}: a step launched {got['launches']}, not "
                     f"exactly the TP modes (no pair kernel, B1-B3)")
            compare_first_step(f"tp {tag}", "the first step's gradients",
                               got["loss"][0], on_card(got["grads"]),
                               ref["loss"][0], on_card(ref["grads"]),
                               sides=sides)
            if world == TP_T:
                compare_first_step(
                    f"tp {tag}", f"the parameters after {TP_STEPS} steps",
                    got["loss"][-1], on_card(got["params"]),
                    ref["loss"][-1], on_card(ref["params"]), sides=sides,
                    tensor_tol=adamw_reach_tol(ref["params"],
                                               args.learning_rate, TP_STEPS))
                main = got
        # (d) the 1 x 2 checkpoint resumed at 1 x 1 (here) and 2 x 1 (the
        # ranks of (b))
        ckpt = os.path.join(tmp, "ckpt", "latest_epoch.ckpt")
        nxt = main["next"]
        for where, res in (("1 x 1", tp_resume(ckpt, None)),
                           ("2 x 1", main["resumed_2x1"])):
            log(f"tp (d): the 1 x 2 checkpoint resumed at {where}: next "
                f"loss {res['loss']!r} against {nxt['loss']!r} on 1 x 2")
            compare_first_step(
                f"tp (d) {where}", "the parameters after the next step",
                res["loss"], on_card(res["params"]), nxt["loss"],
                on_card(nxt["params"]),
                sides=(f"resumed at {where}", "1 x 2"),
                tensor_tol=adamw_reach_tol(nxt["params"], args.learning_rate,
                                           1))
        # (e) rank 0's trace of (b)'s first step
        kernels, regions = trace_contents(os.path.join(
            tmp, "trace", "trace.rank0.json"))
        log(f"tp (e): rank 0's trace of a 1 x 2 step: {len(kernels)} CUDA "
            f"kernels {kernels}; annotate regions {regions}")
        needed = ("hg_gemm_kernel", "attn_tc_fwd_kernel", "attn_tc_bwd_kernel")
        if "tp_train_step" not in regions or not all(
                any(k in n for n in kernels) for k in needed):
            fail(f"tp (e): the trace lacks the step's region or a kernel of "
                 f"{needed}")
    for rec in tp_records:
        rec["launches"] = main["launches"].get(rec["name"], 0)
        if not rec["launches"]:
            fail(f"tp: {rec['name']} was not launched by a TP step")
    records += tp_records
    log(f"tp: phase 30 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 31: the W8A8 pair on shards, the stream tiers, the task models and
# dropout / drop-path on a grid
# ---------------------------------------------------------------------------

Q8_TP_REPLACES = "motionbert_tpu/ops/pair_q8.py:147"
# B9_tp's device records a call by kernel (csrc/pair_q8_kernels.cu's note):
# the weights' three (the whole quantiser for wqkv and w1, the split for
# wproj and w2), the attention stage's three (its core taking the row
# maxima), two a partial product, the MLP stage's two (its row pass taking
# the dequantise, LN2 and the quantiser; fc1 its row maxima), the output's
# one (the gate in it when gated); nothing else, no PyTorch operator
Q8_TP_KERNELS = {"quant_cols_kernel": 1, "col_amax_kernel": 1,
                 "quant_cols_given_kernel": 1, "ln_quant_rows_kernel": 1,
                 "hg_gemm_s8_kernel": 4, "attn_tc_fwd_kernel": 1,
                 "quant_rows_given_kernel": 2,
                 "dequant_ln_quant_rows_kernel": 1}
# clips of each task's global batch in (b): SupCon needs two of each of
# two classes; the pose3d model takes tp_batch's 2
TP2_CLIPS = {"action": 1, "supcon": 4, "mesh": 2}
TP2_LIFT_TIERS = ("kernel_q8", "kernel_stream_q8", "kernel_stream")


def pair_q8_tp_kernels(gated: bool) -> dict:
    """Device records of one B9_tp call by kernel: Q8_TP_KERNELS and the
    output pass (dequant_rows_kernel, or dequant_gate_rows_kernel)."""
    out = "dequant_gate_rows_kernel" if gated else "dequant_rows_kernel"
    return {**Q8_TP_KERNELS, out: 1}


def pair_q8_tp_records(gated: bool) -> int:
    """Device records of one B9_tp call: 13, gated or not."""
    return sum(pair_q8_tp_kernels(gated).values())


def q8_tp_profile_faults(rows, calls: int, gated: bool) -> list:
    """Where a B9_tp call's profile differs from pair_q8_tp_kernels: a
    kernel missing or launched another number of times a call, or any
    other kernel (a PyTorch operator, the retired row_amax_kernel or
    gate_kernel)."""
    got = {}
    for key, _, n in rows:
        name = kernel_name(key).split("<")[0]
        got[name] = got.get(name, 0) + n / calls
    want = pair_q8_tp_kernels(gated)
    return [f"{k}: {got.get(k, 0)} a call, expected {want.get(k, 0)}"
            for k in sorted(set(got) | set(want))
            if got.get(k, 0) != want.get(k, 0)]


def pair_q8_tp_cost(mode: str, gated: bool) -> tuple:
    """(seconds by operations, bytes, int8 operations, bf16 FLOPs) of
    B9_tp on model rank 0's shards at the phase-3 rows: the four products
    on the shards at the int8 peak, the core over the local heads and the
    gate at the bf16 peak; bytes: x (and other) read, the output written,
    the shards of the weights (bf16) and the LayerNorm parameters read,
    and each int32 partial (M x C) written for the sum and read back
    summed."""
    M = B * FRAMES * J
    ci, hl = C // TP_T, HIDDEN // TP_T
    int8_ops = 2 * M * (3 * ci * C + C * ci + 2 * C * hl)
    groups, n = (B * J, FRAMES) if mode == "temporal" else (B * FRAMES, J)
    bf16_flops = 4 * groups * n * n * ci + (4 * M * 2 * C if gated else 0)
    weights = (3 * ci * C + C * ci + 2 * C * hl + 3 * ci + hl + 2 * C) * 2
    nbytes = M * C * 2 * (2 + int(gated)) + weights + 4 * C * 4 \
        + 2 * 2 * M * C * 4
    t_ops = int8_ops / PEAK_INT8_OPS + bf16_flops / PEAK_BF16_FLOPS
    return t_ops, nbytes, int8_ops, bf16_flops


def q8_tp_args(p: dict, gated: bool) -> list:
    """B9_tp's arguments from tp_shards' inputs: x, other (None), the 12
    parameters, wg, bg (None)."""
    g = (p["other"], p["wg"], p["bg"]) if gated else (None, None, None)
    return [p["x"], g[0], *(p[k] for k in PAIR_KEYS), g[1], g[2]]


def phase_q8_tp_kernels() -> list:
    """(a) B9_tp at the phase-3 rows on model rank 0's shards of TP_T,
    ungated and gated, temporal and spatial, against its plain twin (no
    collective: rank 0's function alone, on the kernel and on the twin)."""
    from motionbert_tpu_torch.ops import pair_q8 as q8

    dev = torch.device("cuda")
    scale, heads = (C // HEADS) ** -0.5, HEADS // TP_T
    modes = {}
    for gated in (False, True):
        for mode in ("temporal", "spatial"):
            tag = ("gated " if gated else "") + mode
            p = tp_shards(pair_inputs(40 + 2 * gated + (mode == "spatial"),
                                      gated, dev))
            args = q8_tp_args(p, gated)
            call = lambda: q8.fused_pair_block_q8_tp(*args, heads, scale,
                                                     mode)
            plain = lambda: q8.pair_block_q8_tp_plain(*args, heads, scale,
                                                      mode)
            out = call()
            torch.cuda.synchronize()
            bitwise = torch.equal(out, call())
            ref = plain()
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                fail(f"q8 tp (a) {tag}: shape {tuple(out.shape)} or "
                     f"non-finite")
            abs_err, rel = rel_err(out, ref)
            l2 = rel_l2_t(out, ref)
            t_ops, nbytes, int8_ops, bf16_flops = pair_q8_tp_cost(mode, gated)
            t_bytes = nbytes / PEAK_HBM_BYTES
            library = lambda: pair_q8_library(p, gated, scale, mode, heads)
            calls = 10
            dev_ms, rows = device_profile(call, pair_q8_tp_records(gated),
                                          calls)
            split = q8_profile_split(by_kernel(rows, calls))
            faults = q8_tp_profile_faults(rows, calls, gated)
            rec = dict(
                max_abs_err=abs_err, rel_err=rel, tol=Q8_KERNEL_TOL,
                rel_l2=l2, l2_tol=Q8_KERNEL_L2_TOL,
                outputs_that_differ=(out != ref).float().mean().item(),
                bitwise_repeatable=bitwise, ms=time_ms(call),
                back_to_back_ms=time_ms_back_to_back(call),
                plain_ms=time_ms(plain, runs=5, warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(library),
                library_device_ms=device_ms(library, None),
                device_ms=dev_ms, **split,
                device_by_kernel=by_kernel(rows, calls),
                int8_gop=int8_ops / 1e9, bf16_gflop=bf16_flops / 1e9,
                mbytes=nbytes / 1e6)
            log(f"q8 tp (a) fused_pair_block_q8_tp/{tag} (shards of {TP_T}): "
                + json.dumps(rec))
            if faults:
                fail(f"q8 tp (a) {tag}: a call's profile: {faults}")
            if not (rel <= Q8_KERNEL_TOL and l2 <= Q8_KERNEL_L2_TOL):
                fail(f"q8 tp (a) {tag}: max|d|/max|ref| {rel:.3e} (bar "
                     f"{Q8_KERNEL_TOL}), relative L2 {l2:.3e} (bar "
                     f"{Q8_KERNEL_L2_TOL})")
            if not bitwise:
                fail(f"q8 tp (a) {tag}: two runs gave different bits")
            modes[tag] = rec
            del p, args, out, ref
    torch.cuda.empty_cache()
    main = modes["temporal"]
    return [dict(
        name="fused_pair_block_q8_tp", route="cuda",
        source="motionbert_tpu_torch/ops/csrc/pair_q8_kernels.cu",
        replaces=Q8_TP_REPLACES, launches=None,
        max_abs_err=max(m["max_abs_err"] for m in modes.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        device_ms=main["device_ms"],
        library_device_ms=main["library_device_ms"], mode="temporal",
        shape=[B, FRAMES, J, C], shards=TP_T, modes=modes),
        phase_quant_cols_tp(q8)]


def phase_quant_cols_tp(q8) -> dict:
    """The split column quantiser of B9_tp's row-parallel weights: on model
    rank 0's shards of TP_T (wproj (C, C / TP_T), w2 (C, HIDDEN / TP_T), the
    phase-3 weights, bf16) one quant_cols_tp call (col_amax_kernel and
    quant_cols_given_kernel; no group, so no all-reduce) against its plain
    version, timed; and over all T ranks' slices, T 2 and 4, col_amax_kernel
    on each, their maximum (the all-reduce's MAX), quant_cols_given_kernel
    on each: the plain quantiser of the whole weights bit for bit."""
    dev = torch.device("cuda")
    p = pair_inputs(40, False, dev)
    shards = tp_shards(p)
    ws = [shards["wproj"], shards["w2"]]
    rec = quant_cols_case(
        f"split (shards of {TP_T})", lambda: q8.quant_cols_tp(ws, [None] * 2),
        lambda: [q8.quant_cols_plain(w) for w in ws], ws, 2)
    for T in (2, 4):
        for name in ("wproj", "w2"):
            w = p[name]
            parts = [t.contiguous() for t in w.split(w.shape[1] // T, 1)]
            amax = [torch.empty(w.shape[0], device=dev) for _ in parts]
            q8._col_quant(q8.COLQ_AMAX, parts, amax)
            split = q8._col_quant(q8.COLQ_GIVEN, parts,
                                  [torch.stack(amax).amax(0)] * T)
            want = q8.quant_cols_plain(w)
            if not (torch.equal(torch.cat([q for q, _ in split], 1), want[0])
                    and all(torch.equal(sc, want[1]) for _, sc in split)):
                fail(f"column quantiser split over {T} ranks' slices of "
                     f"{name}: not the whole weight's quantiser bit for bit")
    log("column quantiser split over 2 and 4 ranks' slices of wproj and w2: "
        "the whole weights' bits")
    del p, shards, ws
    return dict(name="quant_cols_tp", route="cuda",
                source="motionbert_tpu_torch/ops/csrc/pair_q8_common.cuh",
                replaces=QUANT_COLS_REPLACES, launches=None,
                max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by="bytes", library_ms=None,
                device_ms=rec["device_ms"], shards=TP_T, detail=rec)


def tp2_counters() -> tuple:
    """Every counter a step or lift on the grid can move: the pair and
    block kernels, the TP modes, B9 and B9_tp, the stream kernels."""
    from motionbert_tpu_torch.ops import fused_stream as fs
    from motionbert_tpu_torch.ops import pair_q8 as q8

    return (train_counters() + tp_counters()
            + (q8.fused_pair_block_q8, q8.fused_gated_pair_block_q8,
               q8.fused_pair_block_q8_tp, q8.quant_cols, q8.quant_cols_tp,
               fs.fused_stream_block, fs.fused_gated_stream_block,
               fs.fused_stream_block_q8, fs.fused_gated_stream_block_q8))


def tp2_task(kind: str) -> tuple:
    """(model, its step factory's arguments, the global batch, its
    learning rates) of a task of (b) at the flagship widths, the backbone
    with the anchor weights and the head drawn from a seed: "action"
    (MB_train_NTU60_xsub: classifier, dropout 0.5), "supcon"
    (MB_train_NTU120_oneshot: embedding, dropout 0.1), "mesh"
    (MB_train_h36m: dropout 0.1, a seeded 6890-vertex body model), "pose"
    (phase 8's with drop-path 0.1 and dropout 0.1)."""
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config

    if kind == "pose":
        args, lambdas, model = dist_model(True)
        return model, (args, lambdas), tp_batch(), (args.learning_rate,) * 2
    anchor = load_state_dict(ANCHOR)
    if kind == "mesh":
        from motionbert_tpu_torch.losses.mesh import LAMBDA_KEYS
        from motionbert_tpu_torch.models.smpl import SMPLModel
        from motionbert_tpu_torch.train.mesh import build_mesh_model

        args = get_config(MESH_CONFIG)
        smpl = SMPLModel.synthetic(num_verts=MESH_VERTS, seed=0).cuda()
        model = build_mesh_model(args, smpl, device="cuda")
        batch = mesh_batch(smpl, TP2_CLIPS[kind], args.clip_len, 91)
        extra = ({k: args[k] for k in LAMBDA_KEYS},
                 args.get("loss_type", "L1"))
    else:
        from motionbert_tpu_torch.train.action import build_action_model

        args = get_config(ACTION_CONFIG if kind == "action"
                          else ONESHOT_CONFIG)
        model = build_action_model(args, device="cuda")
        batch = action_batch(TP2_CLIPS[kind], args.clip_len,
                             args.action_classes if kind == "action"
                             else None, 92)
        extra = (args,)
    model.init_weights(torch.Generator().manual_seed(0))
    model.backbone.load_state_dict(anchor, strict=True)
    bn_on_running_stats(model)
    return model, extra, batch, (args.lr_backbone, args.lr_head)


def bn_on_running_stats(model) -> None:
    """Keep a task model's BatchNorms on their running statistics in
    training mode too, as phases 22 and 26 hold the first steps: at 2 clips
    the batch statistics normalise each feature to about +-1 over two
    values, and a rounding apart in fc1's output moves them by orders of
    magnitude more than the kernels' own difference (measured on the card
    at 2 clips with the classifier's BatchNorm in training mode: gradient
    cosine 0.9757 against world size 1, fc1's bias, whose gradient is zero
    in exact arithmetic, 3.0 of its largest value). The training-mode
    BatchNorm on shards, its statistics over the data group, is held by
    tests/test_torch_tp_models.py against the JAX mesh."""
    from motionbert_tpu_torch.models.action_heads import BatchNorm1d

    for m in model.modules():
        if isinstance(m, BatchNorm1d):
            m.train = types.MethodType(
                lambda self, mode=True: torch.nn.Module.train(self, False), m)
            m.eval()


def tp2_step(kind: str, model, extra, lrs, gen):
    """(optimizer, step(x, y) -> the global batch's loss) through the
    task's own step factory on the DDP-wrapped model; gen, the masks'
    generator, seeded alike on every rank."""
    from motionbert_tpu_torch.parallel.mesh import mean_over_ranks, wrap_ddp
    from motionbert_tpu_torch.train import action, action_1shot, mesh, pose3d
    from motionbert_tpu_torch.train.state import (
        make_adamw, make_two_group_adamw)

    dev = torch.device("cuda", 0)
    if kind == "pose":
        args, lambdas = extra
        opt = make_adamw(model.parameters(), lrs[0], args.weight_decay)
        step = pose3d.make_train_step(
            wrap_ddp(model, dev), opt, lambdas, rootrel=args.rootrel,
            no_conf=args.no_conf, flip_aug=bool(args.flip), generator=gen)
        return opt, lambda x, y: mean_over_ranks(step(x, y))["total"].item()
    opt = make_two_group_adamw(model, *lrs, 0.01)
    net = wrap_ddp(model, dev, ignore=action.JAX_MISSING_KEYS)
    if kind == "action":
        step = action.make_action_train_step(net, opt, gen)
        return opt, lambda x, y: mean_over_ranks(step(x, y))["loss"].item()
    if kind == "supcon":
        args, = extra
        step = action_1shot.make_supcon_train_step(
            net, opt, args.hidden_dim, args.temp, gen)
        return opt, lambda x, y: step(x, y).item()
    lambdas, loss_type = extra
    step = mesh.make_mesh_train_step(net, opt, lambdas, loss_type, gen)
    return opt, lambda x, y: mean_over_ranks(step(x, y))["total"].item()


def tp2_trajectory(kind: str, model, extra, batch, lrs,
                   ckpt=None) -> dict:
    """One step of a task on this rank's grid (or in one process): its
    loss, the first step's gradients and the parameters after (gathered
    whole), the launches; with ``ckpt`` a checkpoint after it and the next
    step (the trajectory a resumed run must follow)."""
    from motionbert_tpu_torch.core.checkpoint import CheckpointManager
    from motionbert_tpu_torch.parallel.mesh import gather_named, rank_rows

    gen = torch.Generator(device="cuda").manual_seed(0)
    opt, step = tp2_step(kind, model, extra, lrs, gen)
    grads = {}

    def keep_first(optimizer, *_):
        if not grads:
            grads.update({n: p.grad.detach().float().clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None})

    opt.register_step_pre_hook(keep_first)
    x, y = rank_rows(batch)
    loss, launches = counted(tp2_counters(), lambda: step(x, y))
    out = {"loss": loss, "launches": launches,
           "grads": {n: g.cpu() for n, g in gather_named(model,
                                                         grads).items()},
           "params": {n: t.float().cpu()
                      for n, t in model.state_dict().items()}}
    if ckpt is not None:
        CheckpointManager(ckpt).save_epoch(0, lrs[0], model, opt,
                                           rng=gen.get_state())
        out["next"] = {"loss": step(x, y), "params": {
            n: t.float().cpu() for n, t in model.state_dict().items()}}
    return out


def tp2_lift(tier: str, mesh) -> tuple:
    """(the flip-TTA lift of tp_batch's clips, the launches) of phase 8's
    flagship with the anchor weights in ``tier``, sharded over ``mesh``
    (None: whole)."""
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.parallel.mesh import eval_rows, shard_params
    from motionbert_tpu_torch.train.pose3d import make_eval_step

    args = get_config(TRAIN_CONFIG)
    model = load_backbone(args, device="cuda", attn_impl=tier)
    model.load_state_dict(load_state_dict(ANCHOR), strict=True)
    shard_params(model, mesh)
    x = tp_batch()[0]
    return counted(tp2_counters(), lambda: torch.from_numpy(eval_rows(
        make_eval_step(model, no_conf=args.no_conf, flip_tta=True),
        x.cpu().numpy(), torch.device("cuda", 0), x.shape[0])))


def tp2_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase 31 (b): the 1 x 2 grid (gloo, cuda:0)."""
    import torch.distributed as dist
    from datetime import timedelta

    from motionbert_tpu_torch.parallel.mesh import make_mesh, shard_params

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=TP_T,
                            timeout=timedelta(seconds=DIST_TIMEOUT))
    try:
        mesh = make_mesh(1, TP_T)
        res = {}
        for kind in ("action", "supcon", "mesh", "pose"):
            model, extra, batch, lrs = tp2_task(kind)
            t0 = time.perf_counter()
            res[kind] = tp2_trajectory(
                kind, shard_params(model, mesh), extra, batch, lrs,
                ckpt=os.path.join(out_dir, "ckpt") if kind == "action"
                else None)
            res[kind]["s"] = time.perf_counter() - t0
            del model
            torch.cuda.empty_cache()
        for tier in TP2_LIFT_TIERS:
            res[tier] = tp2_lift(tier, mesh)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "tp2.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def tp2_reach_tol(params: dict, lrs: tuple):
    """Phase 28's parameter bars, or AdamW's reach after one step where
    that is larger, with each tensor's own learning rate (a task's head
    takes lr_head): two runs whose first gradients differ by rounding move
    an element by at most lr each, opposite ways where its gradient is near
    zero, so they differ by up to 2 lr, plus the fp32 rounding of the two
    stored values (4 ulps of the largest value). It binds the mesh head's
    residual layers (xavier gain 0.01: max |w| ~8e-4 against 2e-4)."""
    def tol(n):
        lr = lrs[1] if n.startswith("head.") else lrs[0]
        top = max(params[n].abs().max().item(), 1e-30)
        return max(param_tensor_tol(n), 2 * lr / top + 4 * 2.0 ** -23)
    return tol


def phase_tp2(records: list) -> None:
    """(a) B9_tp at the shard shapes; (b) the task models, dropout /
    drop-path and the tiers' lifts on a 1 x 2 grid against world size 1;
    (c) the grid's action checkpoint resumed at 1 x 1."""
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint
    from motionbert_tpu_torch.parallel.mesh import shard_optimizer_state

    t_phase = time.perf_counter()
    q8_records = timed("q8 tp (a) kernels", phase_q8_tp_kernels)
    sides = ("1 x 2", "world size 1")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(tp2_rank, lambda r: (r, f"{tmp}/store", tmp), TP_T,
                    DIST_TIMEOUT)
        got = torch.load(os.path.join(tmp, "tp2.pt"), weights_only=False)
        log(f"q8 tp (b): {TP_T} ranks ({SHARED_CARD}) in "
            f"{time.perf_counter() - t0:.1f} s with the ranks' start")
        grid_launches = {}
        for kind in ("action", "supcon", "mesh", "pose"):
            model, extra, batch, lrs = tp2_task(kind)
            ref = tp2_trajectory(kind, model, extra, batch, lrs)
            # the witness: the same step through the bf16 plain path
            model, extra, batch, lrs = tp2_task(kind)
            for m in model.modules():
                if hasattr(m, "attn_impl"):
                    m.attn_impl = "plain"
            witness = tp2_trajectory(kind, model, extra, batch, lrs)["grads"]
            witness = witness_by_kind({n: rel_err(witness[n], t)[1]
                                       for n, t in ref["grads"].items()})
            del model
            torch.cuda.empty_cache()
            g = got[kind]
            log(f"q8 tp (b) {kind}: loss {g['loss']!r} on 1 x 2 against "
                f"{ref['loss']!r}; {g['s']:.2f} s on the grid; launches "
                f"{json.dumps(g['launches'])} against "
                f"{json.dumps(ref['launches'])} at world size 1")
            log(f"q8 tp (b) {kind}: the witness, the bf16 plain path "
                f"against the kernels at world size 1, by bar: "
                + json.dumps({f"{grad_tensor_tol(n)}": w
                              for n, w in witness.items()}))
            compare_first_step(
                f"q8 tp (b) {kind}", "the first step's gradients", g["loss"],
                on_card(g["grads"]), ref["loss"], on_card(ref["grads"]),
                sides=sides, tensor_tol=lambda n: max(
                    grad_tensor_tol(n), WITNESS_MARGIN * witness[n]))
            compare_first_step(f"q8 tp (b) {kind}", "the parameters after "
                               "the step", g["loss"], on_card(g["params"]),
                               ref["loss"], on_card(ref["params"]),
                               sides=sides,
                               tensor_tol=tp2_reach_tol(ref["params"], lrs))
            wanted = {"fused_attention_block_tp", "fused_attention_block_tp_bwd",
                      "fused_ln_bwd"}
            if kind != "pose":     # the MLP's dropout keeps pose's MLP plain
                wanted |= {"fused_mlp_block_tp", "fused_mlp_block_tp_bwd"}
            if set(g["launches"]) != wanted:
                fail(f"q8 tp (b) {kind}: the grid's step launched "
                     f"{g['launches']}, not exactly {sorted(wanted)}")
            for name, n in g["launches"].items():
                grid_launches[name] = grid_launches.get(name, 0) + n
        for tier in TP2_LIFT_TIERS:
            lift, launches = got[tier]
            ref, ref_launches = tp2_lift(tier, None)
            d = tp_differs(lift, ref)
            log(f"q8 tp (b) {tier} lift: max|d| {d[0]:.4e}, max|d|/max|ref| "
                f"{d[1]:.4e}, {100 * d[2]:.2f}% of the elements differ; "
                f"launches {json.dumps(launches)} on 1 x 2 against "
                f"{json.dumps(ref_launches)} at world size 1")
            if "q8" in tier and not torch.equal(lift, ref):
                fail(f"q8 tp (b) {tier}: the grid's lift is not world size "
                     f"1's bit for bit")
            if d[1] > KERNEL_TOL:
                fail(f"q8 tp (b) {tier}: the lift is {d[1]:.3e} of max from "
                     f"world size 1's")
            wanted = {"fused_pair_block_q8_tp", "quant_cols",
                      "quant_cols_tp"} if "q8" in tier else {
                "fused_attention_block_tp", "fused_mlp_block_tp"}
            if set(launches) != wanted:
                fail(f"q8 tp (b) {tier}: the grid's lift launched "
                     f"{launches}, not exactly {sorted(wanted)} (no B9, no "
                     f"B10)")
            if "q8" in tier and not (
                    launches["quant_cols"] == launches["quant_cols_tp"]
                    == launches["fused_pair_block_q8_tp"]):
                fail(f"q8 tp (b) {tier}: {launches}: not one launch of each "
                     f"column quantiser a B9_tp call")
            for name, n in launches.items():
                grid_launches[name] = grid_launches.get(name, 0) + n
        # (c) the 1 x 2 action checkpoint resumed at 1 x 1
        payload = load_checkpoint(os.path.join(tmp, "ckpt",
                                               "latest_epoch.ckpt"))
        model, extra, batch, lrs = tp2_task("action")
        model.load_state_dict(payload["model"], strict=True)
        gen = torch.Generator(device="cuda")
        gen.set_state(payload["rng"])
        opt, step = tp2_step("action", model, extra, lrs, gen)
        opt.load_state_dict(shard_optimizer_state(payload["optimizer"], opt,
                                                  model))
        loss = step(*batch)
        nxt = got["action"]["next"]
        log(f"q8 tp (c): the 1 x 2 action checkpoint resumed at 1 x 1: next "
            f"loss {loss!r} against {nxt['loss']!r} on 1 x 2")
        compare_first_step(
            "q8 tp (c)", "the parameters after the next step", loss,
            on_card({n: t.float() for n, t in model.state_dict().items()}),
            nxt["loss"], on_card(nxt["params"]),
            sides=("resumed at 1 x 1", "1 x 2"),
            tensor_tol=tp2_reach_tol(nxt["params"], lrs))
        del model
        torch.cuda.empty_cache()
    for rec in q8_records:
        rec["launches"] = grid_launches.get(rec["name"], 0)
        if not rec["launches"]:
            fail(f"q8 tp: {rec['name']} was not launched on the grid")
    for rec in records:
        if rec["name"] in grid_launches:
            rec["tp2_launches"] = grid_launches[rec["name"]]
    records += q8_records
    log(f"q8 tp: phase 31 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# --baseline: another checkout's kernels, bit for bit and in turns
# ---------------------------------------------------------------------------

BASELINE_STEPS = 5


def build_other(csrc: str, name: str, tmp: str):
    """csrc/<name>.cu of another checkout, built with this one's nvcc flags
    into tmp and loaded (thread-safe: one nvcc process a call)."""
    import ctypes

    from motionbert_tpu_torch.ops import _build

    so = os.path.join(tmp, f"{name}.so")
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                          os.path.join(csrc, f"{name}.cu")],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"baseline: nvcc failed for {name}.cu:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(so)


# a C entry point for another checkout's first-design int8 GEMM
# (launch_gemm_q8 in its csrc/pair_q8_common.cuh), which no library of that
# checkout exports alone: --baseline holds the s8 engine to it bit for bit
OTHER_Q8_GEMM = """
#include "{header}"
extern "C" int mbt_other_q8_gemm(int epi, const void* A, const void* as,
                                 const void* W, const void* ws, const void* b,
                                 const void* R, void* out, int M, int N,
                                 int K, void* stream) {{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (epi) {{
#define OTHER_CASE(E) \\
        case E: return (int)launch_gemm_q8<E>(A, as, W, ws, b, R, out, M, N, K, s);
        OTHER_CASE(Q8_BIAS)
        OTHER_CASE(Q8_BIAS_RES)
        OTHER_CASE(Q8_BIAS_GELU_F32)
        default: return (int)cudaErrorInvalidValue;
    }}
}}
"""


def build_other_q8_gemm(csrc: str, tmp: str):
    """The other checkout's first-design int8 GEMM (gemm_q8_kernel through
    its launch_gemm_q8) behind mbt_other_q8_gemm, built with this
    checkout's nvcc flags into tmp and loaded; None when that checkout has
    no such GEMM."""
    import ctypes

    from motionbert_tpu_torch.ops import _build

    header = os.path.join(csrc, "pair_q8_common.cuh")
    with open(header) as fh:
        if "launch_gemm_q8" not in fh.read():
            return None
    src, so = (os.path.join(tmp, f"other_q8_gemm.{e}") for e in ("cu", "so"))
    with open(src, "w") as fh:
        fh.write(OTHER_Q8_GEMM.format(header=os.path.abspath(header)))
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"baseline: nvcc failed for the other int8 GEMM:\n"
             f"{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mbt_other_q8_gemm.argtypes = [i] + [vp] * 7 + [i] * 3 + [vp]
    lib.mbt_other_q8_gemm.restype = i
    return lib


def baseline_q8_gemm(q8, other, results: dict) -> None:
    """The s8 engine (this build's chain's products) against the other
    build's int8 GEMM on the same int8 operands, at the W8A8 pair's four
    products on the phase-3 rows and a ragged shape: bit for bit (into
    results; int32 sums are exact in any order and both epilogues take the
    same fp32 roundings), and each one's device time in turns."""
    M = B * FRAMES * J
    shapes = [(e, (M, n, k)) for e, n, k in Q8_ENGINE_SHAPES]
    for epi, (m, n, k) in shapes + [(e, (37, 192, 128))
                                    for e in q8.Q8_EPILOGUES]:
        args = q8_engine_operands(epi, m, n, k, seed=m + n + k + 1)
        a8, ascale, w8, wscale, bias, r = args

        def theirs():
            out = torch.empty((m, n), device="cuda", dtype=torch.float32
                              if epi == "bias_gelu_f32" else torch.bfloat16)
            rc = other.mbt_other_q8_gemm(
                q8.Q8_EPILOGUES[epi], a8.data_ptr(), ascale.data_ptr(),
                w8.data_ptr(), wscale.data_ptr(), bias.data_ptr(),
                None if r is None else r.data_ptr(), out.data_ptr(), m, n, k,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                fail(f"baseline: the other int8 GEMM failed with CUDA error "
                     f"{rc}")
            return out

        ours = lambda: q8.engine_gemm_q8(epi, *args)
        equal = torch.equal(ours(), theirs())
        results[f"engine_gemm_q8/{epi}/{m}x{n}x{k}"] = equal
        turns = [(w, device_ms(ours if w == "this" else theirs, 1))
                 for w in ("other", "this", "this", "other")] \
            if m == M else None
        log(f"baseline: s8 engine {epi} {(m, n, k)} vs the other build's "
            f"int8 GEMM on the same int8 operands: bitwise equal {equal}; "
            f"device ms in turns {turns}")
        del args, a8, ascale, w8, wscale, bias, r
    torch.cuda.empty_cache()


# whether the other checkout (--baseline) quantises the W8A8 weights with
# its own column-quantiser kernels (its W8A8 pair library has
# mbt_quant_cols); set by phase_baseline
OTHER_QUANT_KERNELS = True


def earlier_quant_cols(*ws):
    """The W8A8 wrappers' weight quantisation as a checkout without the
    column-quantiser kernels ran it: PyTorch's operators a weight
    (quant_cols_plain: the same operators and bits)."""
    from motionbert_tpu_torch.ops import pair_q8 as q8

    out = [q8.quant_cols_plain(w) for w in ws]
    return out[0] if len(ws) == 1 else out


class swapped_library:
    """Within the block, the wrappers load `lib` for csrc/<name>.cu. Where
    that is another checkout's W8A8 pair or stream library and the other
    checkout has no column-quantiser kernels, the W8A8 wrappers quantise
    their weights as it did (earlier_quant_cols)."""

    def __init__(self, name: str, lib):
        from motionbert_tpu_torch.ops import _build
        from motionbert_tpu_torch.ops import fused_stream as fs
        from motionbert_tpu_torch.ops import pair_q8 as q8

        self.libs, self.name, self.lib = _build._libs, name, lib
        self.quant = [] if OTHER_QUANT_KERNELS or name not in (
            "pair_q8_kernels", "stream_kernels") else [q8, fs]

    def __enter__(self):
        self.saved = self.libs[self.name]
        self.libs[self.name] = self.lib
        self.saved_quant = [m.quant_cols for m in self.quant]
        for m in self.quant:
            m.quant_cols = earlier_quant_cols

    def __exit__(self, *exc):
        self.libs[self.name] = self.saved
        for m, fn in zip(self.quant, self.saved_quant):
            m.quant_cols = fn


def baseline_blocks(other_block, results: dict) -> dict:
    """B6 and B7 of this build against the other's at the phase-16/17 shape
    with the flags the model calls: B6 bit for bit, B7 as split_bitwise
    holds it, and B7 timed against the other build in turns; B4 and B5,
    every flag pair, both modes, held to their plain bars (the other
    build's errors logged beside) and timed against the other build in
    turns. Returns {name/mode/flags: turns}."""
    from motionbert_tpu_torch.ops import attention as at
    from motionbert_tpu_torch.ops import fused_mlp as mlp

    at.block_library()
    mlp._library()
    at.bind_block_library(other_block)
    dev = torch.device("cuda")
    scale = (C // HEADS) ** -0.5
    p = pair_inputs(51, False, dev)
    g = pair_inputs(5, False, dev)["x"]
    attn = [p["x"]] + [p[k] for k in ATTN_KEYS]
    names = ("dx", "dln_w", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj")
    out = {}
    for mode in ("temporal", "spatial"):
        for use_ln, residual in ATTN_FLAGS:
            fl = (HEADS, scale, mode, use_ln, residual)
            tag = f"{mode}/ln{int(use_ln)}res{int(residual)}"
            fwd = lambda: at.fused_attention_block(*attn, *fl)
            bwd = lambda: at.fused_attention_block_bwd(attn[0], g, *attn[1:6],
                                                       *fl)
            ref = (at.attention_block_plain(*attn, *fl),
                   at.attention_block_bwd_plain(attn[0], g, *attn[1:6], *fl))
            ours = (fwd(), bwd())
            with swapped_library("block_kernels", other_block):
                theirs = (fwd(), bwd())
            errs = {}
            for build, (o, grads) in (("this", ours), ("other", theirs)):
                errs[build] = {"out": (rel_err(o, ref[0])[1],
                                       rel_l2_t(o, ref[0]))}
                errs[build].update(
                    {n: (rel_err(a, b)[1], rel_l2_t(a, b))
                     for n, a, b in zip(names, grads, ref[1])
                     if use_ln or not n.startswith("dln")})
            over = {n: e for n, e in errs["this"].items()
                    if not (e[0] <= KERNEL_TOL and e[1] <= BLOCK_L2_TOL)}
            for name, call, records in (
                    ("fused_attention_block", fwd,
                     block_records("attention", False, use_ln)),
                    ("fused_attention_block_bwd", bwd,
                     block_records("attention", True, use_ln))):
                out[f"{name}/{tag}"] = in_turns(call, records, "block_kernels",
                                                other_block)
            log(f"baseline: attention block {tag}: (max|d|/max|plain|, "
                f"relative L2) " + json.dumps(errs) + "; in turns: "
                + json.dumps({n: out[f"{n}/{tag}"] for n in (
                    "fused_attention_block", "fused_attention_block_bwd")}))
            if over:
                fail(f"baseline: attention block {tag}: over ({KERNEL_TOL}, "
                     f"{BLOCK_L2_TOL}): {over}")
            del ours, theirs, ref
    mlp_args = [p["x"]] + [p[k] for k in MLP_KEYS]
    bwd_args = [p["x"], g] + [p[k] for k in MLP_KEYS[:-1]]
    for use_ln, residual in MLP_FLAGS:
        tag = f"tokens/ln{int(use_ln)}res{int(residual)}"
        bwd = lambda: mlp.fused_mlp_block_bwd(*bwd_args, use_ln, residual)
        ours = (mlp.fused_mlp_block(*mlp_args, use_ln, residual), bwd())
        with swapped_library("block_kernels", other_block):
            theirs = (mlp.fused_mlp_block(*mlp_args, use_ln, residual),
                      bwd())
        results[f"fused_mlp_block/{tag}"] = torch.equal(ours[0], theirs[0])
        results[f"fused_mlp_block_bwd/{tag}"] = split_bitwise(
            f"baseline: MLP block backward {tag}",
            ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2"), ours[1],
            theirs[1],
            bwd(), mlp.mlp_block_bwd_plain(*bwd_args, use_ln, residual))
        out[f"fused_mlp_block_bwd/{tag}"] = in_turns(
            bwd, block_records("mlp", True, use_ln), "block_kernels",
            other_block)
        log(f"baseline: MLP block backward {tag} in turns: "
            + json.dumps(out[f"fused_mlp_block_bwd/{tag}"]))
    del p, g, attn, mlp_args, bwd_args
    torch.cuda.empty_cache()
    return out


def baseline_ln_bwd(other_block, results: dict) -> dict:
    """The LayerNorm backward at phase 30's shape (fused_ln_bwd's inputs),
    this build's through fused_ln_bwd and the other build's through its
    mbt_ln_bwd: dx bit for bit (into results); both in turns (other, this,
    this, other), device ms by kernel back to back and one call with the L2
    flushed and warm (l2_protocol_ms). Returns {"fused_ln_bwd/tokens":
    turns}."""
    from motionbert_tpu_torch.ops import attention as at

    dev = torch.device("cuda")
    p = tp_shards(pair_inputs(30, False, dev))
    g = pair_inputs(5, False, dev)["x"]
    x, w = p["x"], p["ln1_w"]
    dh, stats = at.fused_attention_block_tp_bwd(
        x, g, p["ln1_w"], p["ln1_b"], p["wqkv"], p["bqkv"], p["wproj"],
        HEADS // TP_T, (C // HEADS) ** -0.5, "temporal")[3:]
    M = x.numel() // C
    # the scratch a checkout's mbt_ln_bwd takes, under either of the sizings
    # the library has documented: mbt_block_work_floats(0, C) or (C, 1)
    work = torch.empty(max(other_block.mbt_block_work_floats(0, C),
                           other_block.mbt_block_work_floats(C, 1)),
                       dtype=torch.float32, device=dev)
    dx, dln = torch.empty_like(x), torch.empty((2, C), device=dev)

    def other():
        rc = other_block.mbt_ln_bwd(
            dh.data_ptr(), x.data_ptr(), stats.data_ptr(), w.data_ptr(),
            g.data_ptr(), dx.data_ptr(), dln[0].data_ptr(), dln[1].data_ptr(),
            work.data_ptr(), M, C, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"baseline: the other build's mbt_ln_bwd returned {rc}")

    def this():
        return at.fused_ln_bwd(dh, x, stats, w, g)

    ours = this()
    other()
    torch.cuda.synchronize()
    results["fused_ln_bwd/dx"] = torch.equal(ours[0], dx)
    turns = []
    for which, call in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        ms, rows = device_profile(call, None if which == "other"
                                  else TP_RECORDS["fused_ln_bwd"]["tokens"],
                                  20)
        turns.append(dict(build=which, device_ms=ms,
                          device_by_kernel=by_kernel(rows, 20),
                          l2_ms=l2_protocol_ms({"call": call})))
    log(f"baseline: fused_ln_bwd ({M}, {C}): dx bit for bit the other "
        f"build's {results['fused_ln_bwd/dx']}; dln_w, dln_b max|d|/max "
        f"{rel_err(ours[1], dln[0])[1]:.3e}, {rel_err(ours[2], dln[1])[1]:.3e}; "
        f"in turns: " + json.dumps(turns))
    del p, g, dh, stats, work, dx, dln, ours
    torch.cuda.empty_cache()
    return {"fused_ln_bwd/tokens": turns}


def other_constant(root: str, module: str, name: str):
    """A literal module-level constant (a slot tuple, say) of another
    checkout's motionbert_tpu_torch/ops/<module>, read from its source
    without importing it."""
    import ast

    with open(os.path.join(root, "motionbert_tpu_torch", "ops", module)) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    fail(f"baseline: {module} of {root} has no {name}")


def baseline_tp_forwards(other_block, results: dict) -> dict:
    """B4_tp (both modes) and B6_tp at phase 30's shard shapes, this build
    against the other's: the fp32 partials bit for bit (into results), and
    timed in turns (other, this, this, other). The other calls take the
    scratch the earlier chains need (the LayerNorm rows in B4_tp's attn,
    hid and h for B6_tp), allocated here. Returns {name/mode: turns}."""
    from motionbert_tpu_torch.ops import attention as at
    from motionbert_tpu_torch.ops import fused_mlp as mlp

    dev = torch.device("cuda")
    scale, heads = (C // HEADS) ** -0.5, HEADS // TP_T
    M, stream = B * FRAMES * J, lambda: torch.cuda.current_stream().cuda_stream
    out = {}

    def empty(n, dtype=torch.bfloat16):
        return torch.empty(n, dtype=dtype, device=dev)

    def held(name, mode, call, other_call, theirs):
        ours = call()
        other_call()
        torch.cuda.synchronize()
        results[f"{name}/{mode}"] = torch.equal(ours, theirs)
        out[f"{name}/{mode}"] = in_turns(call, TP_RECORDS[name][mode],
                                         "block_kernels", other_block,
                                         other_call)
        log(f"baseline: {name}/{mode} (shards of {TP_T}): bit for bit the "
            f"other build's {results[f'{name}/{mode}']}; in turns "
            + json.dumps(out[f"{name}/{mode}"]))

    for mode in ("temporal", "spatial"):
        p = tp_shards(pair_inputs(30 if mode == "temporal" else 31, False,
                                  dev))
        x = p["x"]
        w = (p["ln1_w"], p["ln1_b"], p["wqkv"], p["bqkv"], p["wproj"])
        ci = p["wqkv"].shape[0] // 3
        qkv, attn = empty(M * 3 * ci), empty(M * max(C, ci))
        theirs = empty(x.shape, torch.float32)

        def other_call():
            rc = other_block.mbt_attention_block_tp(
                x.data_ptr(), theirs.data_ptr(), qkv.data_ptr(),
                attn.data_ptr(), *(t.data_ptr() for t in w), B, FRAMES, J, C,
                ci, heads, scale, int(mode == "temporal"), stream())
            if rc != 0:
                fail(f"baseline: the other build's B4_tp returned {rc}")

        held("fused_attention_block_tp", mode,
             lambda: at.fused_attention_block_tp(x, *w, heads, scale, mode),
             other_call, theirs)
        del p, x, w, qkv, attn, theirs
    p = tp_shards(pair_inputs(30, False, dev))
    x = p["x"]
    m = (p["ln2_w"], p["ln2_b"], p["w1"], p["b1"], p["w2"])
    hl = p["w1"].shape[0]
    hid, theirs = empty(M * (hl + C)), empty(x.shape, torch.float32)

    def other_mlp():
        rc = other_block.mbt_mlp_block_tp(
            x.data_ptr(), theirs.data_ptr(), hid.data_ptr(),
            *(t.data_ptr() for t in m), M, C, hl, stream())
        if rc != 0:
            fail(f"baseline: the other build's B6_tp returned {rc}")

    held("fused_mlp_block_tp", "tokens", lambda: mlp.fused_mlp_block_tp(x, *m),
         other_mlp, theirs)
    del p, x, m, hid, theirs
    torch.cuda.empty_cache()
    return out


def baseline_tp_blocks(other_block, other_root: str, results: dict) -> dict:
    """B5_tp (both modes) and B7_tp at phase 30's shard shapes, this build
    against the other's: every output bit for bit (into results), and both
    timed in turns (other, this, this, other). B5_tp's other call passes the
    other checkout's pointer slots (read from its source; its scratch is a
    subset of this build's, sized here for both), B7_tp's runs this build's
    wrapper on the other library, whose slots are the same. Returns
    {name/mode: turns}, with baseline_tp_forwards' (B4_tp, B6_tp)."""
    from motionbert_tpu_torch.ops import attention as at
    from motionbert_tpu_torch.ops import fused_mlp as mlp

    at.block_library()
    mlp._library()
    at.bind_block_library(other_block)
    out = baseline_tp_forwards(other_block, results)
    slots = other_constant(other_root, "attention.py", "ATTN_TP_BWD_SLOTS")
    dev = torch.device("cuda")
    scale, heads = (C // HEADS) ** -0.5, HEADS // TP_T
    g = pair_inputs(5, False, dev)["x"]
    names = ("dwqkv", "dbqkv", "dwproj", "dh", "st")
    for mode in ("temporal", "spatial"):
        p = tp_shards(pair_inputs(30 if mode == "temporal" else 31, False,
                                  dev))
        x = p["x"]
        w = (p["ln1_w"], p["ln1_b"], p["wqkv"], p["bqkv"], p["wproj"])
        ci = p["wqkv"].shape[0] // 3
        t = at.tp_bwd_tensors(x, g, *w, heads)
        t["work"] = torch.empty(max(
            t["work"].numel(), other_block.mbt_block_work_floats(3 * ci, C)),
            dtype=torch.float32, device=dev)
        ptrs = at.slot_pointers(slots, t)

        def other_call():
            rc = other_block.mbt_attention_block_tp_bwd(
                ptrs, B, FRAMES, J, C, ci, heads, scale,
                int(mode == "temporal"),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                fail(f"baseline: the other build's B5_tp returned {rc}")

        call = lambda: at.fused_attention_block_tp_bwd(x, g, *w, heads, scale,
                                                       mode)
        ours = call()
        other_call()
        torch.cuda.synchronize()
        same = {n: torch.equal(a, t[n]) for n, a in zip(names, ours)}
        results[f"fused_attention_block_tp_bwd/{mode}"] = all(same.values())
        out[f"fused_attention_block_tp_bwd/{mode}"] = in_turns(
            call, TP_RECORDS["fused_attention_block_tp_bwd"][mode],
            "block_kernels", other_block, other_call)
        log(f"baseline: B5_tp/{mode} (shards of {TP_T}): bit for bit the "
            f"other build's {json.dumps(same)}; in turns "
            + json.dumps(out[f"fused_attention_block_tp_bwd/{mode}"]))
        del p, x, w, t, ours
    p = tp_shards(pair_inputs(30, False, dev))
    m = (p["x"], g, p["ln2_w"], p["ln2_b"], p["w1"], p["b1"], p["w2"])
    call = lambda: mlp.fused_mlp_block_tp_bwd(*m)
    ours = call()
    with swapped_library("block_kernels", other_block):
        theirs = call()
    same = {n: torch.equal(a, b) for n, a, b in zip(
        ("dw1", "db1", "dw2", "dh", "st"), ours, theirs)}
    results["fused_mlp_block_tp_bwd/tokens"] = all(same.values())
    out["fused_mlp_block_tp_bwd/tokens"] = in_turns(
        call, TP_RECORDS["fused_mlp_block_tp_bwd"]["tokens"], "block_kernels",
        other_block)
    log(f"baseline: B7_tp (shards of {TP_T}): bit for bit the other build's "
        f"{json.dumps(same)}; in turns "
        + json.dumps(out["fused_mlp_block_tp_bwd/tokens"]))
    del p, m, g, ours, theirs
    torch.cuda.empty_cache()
    return out


def phase_baseline_tp(other_root: str) -> dict:
    """--phases tp's baseline: another checkout's block library built with
    this one's nvcc flags, and B4_tp-B7_tp held to it bit for bit and timed
    against it in turns (baseline_tp_blocks)."""
    csrc = os.path.join(other_root, "motionbert_tpu_torch", "ops", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        results = {}
        turns = baseline_tp_blocks(build_other(csrc, "block_kernels", tmp),
                                   other_root, results)
        log(f"baseline ({other_root}): B4_tp-B7_tp bit for bit the other "
            f"build's: {json.dumps(results)}")
        if not all(results.values()):
            fail(f"baseline: outputs differ: {results}")
    return turns


def in_turns(call, records, lib_name: str, other, other_call=None) -> list:
    """call() timed in turns (other, this, this, other), with the other
    checkout's library for csrc/<lib_name>.cu swapped in on the other's
    turns (and other_call run there instead, where the other checkout's
    entries take other arguments): one call, back to back and device ms
    (this build's profile held to `records` a call; the other's, whose
    chain may launch otherwise, to whole multiples of the calls), and the
    device ms by kernel."""
    turns = []
    calls = 10
    for which in ("other", "this", "this", "other"):
        fn = other_call if which == "other" and other_call else call
        with (swapped_library(lib_name, other) if which == "other"
              else contextlib.nullcontext()):
            dev_ms, rows = device_profile(
                fn, None if which == "other" else records, calls)
            turns.append(dict(
                build=which, ms=time_ms(fn),
                back_to_back_ms=time_ms_back_to_back(fn),
                device_ms=dev_ms,
                device_by_kernel=by_kernel(rows, calls)))
    return turns


def baseline_pairs(fp, fs, other_pair, other_stream, results: dict) -> dict:
    """B1 and B2 (both modes at the phase-3 inputs) and B10 (all four
    variants at the phase-24 inputs) of this build held to their plain
    versions' bars, the bf16 ones also to the other build's outputs bit for
    bit (into results), and both builds timed in turns. Returns {name/mode
    or name: turns}."""
    dev = torch.device("cuda")
    scale = (C // HEADS) ** -0.5
    fp._library()
    fs._library()
    out = {}
    for name, wrapper, plain, gated in (
            ("fused_pair_block", fp.fused_pair_block, fp.pair_block_plain,
             False),
            ("fused_gated_pair_block", fp.fused_gated_pair_block,
             fp.gated_pair_block_plain, True)):
        for mode in ("temporal", "spatial"):
            p = pair_inputs(1 if mode == "temporal" else 2, gated, dev)
            args = pair_args(p, gated)
            call = lambda: wrapper(*args, HEADS, scale, mode)
            ref = plain(*args, HEADS, scale, mode)
            got = call()
            with swapped_library("pair_kernels", other_pair):
                other = call()
            results[f"{name}/{mode}"] = torch.equal(got, other)
            ours, theirs = rel_err(got, ref)[1], rel_err(other, ref)[1]
            turns = in_turns(call, pair_records(gated), "pair_kernels",
                             other_pair)
            log(f"baseline: {name}/{mode}: max|d|/max|plain| this build "
                f"{ours:.3e}, the other {theirs:.3e}; in turns: "
                + json.dumps(turns))
            if not ours <= KERNEL_TOL:
                fail(f"baseline: {name}/{mode}: {ours:.3e} > {KERNEL_TOL}")
            out[f"{name}/{mode}"] = turns
            del p, args, ref, got, other
    for i, (name, gated, q8_tier, order) in enumerate(STREAM_VARIANTS):
        p1 = pair_inputs(30 + i, gated, dev)
        p2 = pair_inputs(40 + i, False, dev)
        args = stream_args(p1, p2, gated)
        wrapper = getattr(fs, name)
        call = lambda: wrapper(*args, HEADS, scale, order)
        ours = call()
        with swapped_library("stream_kernels", other_stream):
            results[name] = torch.equal(ours, call())
        plain = getattr(fs, ("gated_" if gated else "") + "stream_block"
                        + ("_q8" if q8_tier else "") + "_plain")
        ref = plain(*args, HEADS, scale, order)
        errs = (rel_err(ours, ref)[1], rel_l2_t(ours, ref))
        turns = in_turns(call, stream_records(gated, q8_tier),
                         "stream_kernels", other_stream)
        if q8_tier:
            for turn in turns:
                turn.update(q8_profile_split(turn["device_by_kernel"]))
        log(f"baseline: {name}: max|d|/max|plain| and relative L2 this "
            f"build {errs[0]:.3e} / {errs[1]:.3e}; in turns: "
            + json.dumps(turns))
        if not (errs[0] <= STREAM_TOL and errs[1] <= STREAM_L2_TOL):
            fail(f"baseline: {name}: {errs} over ({STREAM_TOL}, "
                 f"{STREAM_L2_TOL})")
        out[name] = turns
        del p1, p2, args, ref, ours
    torch.cuda.empty_cache()
    return out


def baseline_st_attention(other_st) -> dict:
    """B8 of this build, both modes at the phase-20 shape, held to its
    plain version's bars (the other build's errors logged beside) and timed
    against the other build in turns. Returns {st_attention/mode: turns}."""
    from motionbert_tpu_torch.ops import attention as at

    scale = (C // HEADS) ** -0.5
    q, k, v = st_inputs(60)
    out = {}
    for mode in ("temporal", "spatial"):
        call = lambda: at.st_attention(q, k, v, mode, HEADS, scale)
        ref = at.st_attention_plain(q, k, v, mode, HEADS, scale)
        ours = call()
        with swapped_library("st_attention_kernels", other_st):
            theirs = call()
        errs = {b: (rel_err(o, ref)[1], rel_l2_t(o, ref))
                for b, o in (("this", ours), ("other", theirs))}
        out[f"st_attention/{mode}"] = in_turns(call, 1, "st_attention_kernels",
                                               other_st)
        log(f"baseline: st_attention/{mode}: (max|d|/max|plain|, relative "
            f"L2) {json.dumps(errs)}; in turns: "
            + json.dumps(out[f"st_attention/{mode}"]))
        if not (errs["this"][0] <= KERNEL_TOL and errs["this"][1] <= ST_L2_TOL):
            fail(f"baseline: st_attention/{mode}: {errs['this']} over "
                 f"({KERNEL_TOL}, {ST_L2_TOL})")
        del ours, theirs, ref
    del q, k, v
    return out


def q8_models(attn_impls=("kernel_q8", "plain_q8")) -> tuple:
    """tests/test_torch_cuda.py::test_model_q8_kernels_match_plain_q8's
    models (a depth-2 model at the flagship width, one per attn_impl, in
    the card's compute dtype but "plain" in fp32, the same weights) and its
    input."""
    from motionbert_tpu_torch.core.config import ConfigDict
    from motionbert_tpu_torch.models.factory import load_backbone

    cfg = ConfigDict(dim_feat=C, dim_rep=C, depth=2, num_heads=HEADS,
                     mlp_ratio=HIDDEN // C, num_joints=J, maxlen=81)
    models = []
    for impl in attn_impls:
        m = load_backbone(cfg, device="cuda", attn_impl=impl,
                          dtype=torch.float32 if impl == "plain" else None)
        if models:
            m.load_state_dict(models[0].state_dict())
        else:
            m.init_weights(torch.Generator().manual_seed(0))
        models.append(m)
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 81, J, 3)).astype(np.float32)).cuda()
    return (*models, x)


def q8_model_distance() -> tuple:
    """test_model_q8_kernels_match_plain_q8's statistic: the depth-2 model's
    representation through the W8A8 kernels against the plain q8 path in
    bf16, and the plain q8 path against the fp32 full-precision one
    (relative L2s)."""
    model, plain, full, x = q8_models(("kernel_q8", "plain_q8", "plain"))
    with torch.inference_mode():
        out, want = model(x, return_rep=True), plain(x, return_rep=True)
        ref = full(x, return_rep=True)
    return rel_l2_t(out, want), rel_l2_t(out, ref), rel_l2_t(want, ref)


def core_fp64(q, k, v, mode: str, num_heads: int, scale: float):
    """The plain attention core's rounding points (P and the output rounded
    to q's dtype) with everything between them in fp64: a core more
    accurate than the plain one's fp32 sums, in no kernel's order."""
    from motionbert_tpu_torch.ops.attention import from_groups, to_groups

    qh, kh, vh = (to_groups(t, mode, num_heads).double() for t in (q, k, v))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale,
                      dim=-1).to(q.dtype)
    return from_groups(torch.matmul(p.double(), vh).to(q.dtype), mode)


@contextlib.contextmanager
def plain_q8_core(core):
    """Within the block the plain W8A8 pairs call `core` for their
    attention core."""
    from motionbert_tpu_torch.ops import pair_q8

    saved = pair_q8.st_attention_plain
    pair_q8.st_attention_plain = core
    try:
        yield
    finally:
        pair_q8.st_attention_plain = saved


def q8_model_witnesses(other_st) -> dict:
    """Where test_model_q8_kernels_match_plain_q8's distance comes from, on
    its model and input. "core": the plain q8 path with nothing but its
    attention core swapped, against the plain q8 path itself (relative L2
    of the representation), for this build's B8 core, the other build's
    and core_fp64. "calls": pair call by pair call (mode, gated), the
    kernels' model against the plain one (cumulative) and one W8A8 kernel
    call on the plain model's input against the plain call (single step:
    relative L2 and the share of outputs that differ)."""
    from motionbert_tpu_torch.models import dstformer
    from motionbert_tpu_torch.ops import attention as at

    model, plain, x = q8_models()

    def other_core(*args):
        with swapped_library("st_attention_kernels", other_st):
            return at.st_attention(*args)

    out = {"core": {}, "calls": []}
    with torch.inference_mode():
        want = plain(x, return_rep=True)
        for tag, core in (("this", at.st_attention), ("other", other_core),
                          ("fp64", core_fp64)):
            with plain_q8_core(core):
                out["core"][tag] = rel_l2_t(plain(x, return_rep=True), want)
        calls = {"kernel_q8": [], "plain_q8": []}
        saved = dict(dstformer.PAIR_IMPLS)

        def recorder(fn, impl):
            def call(*args):
                y = fn(*args)
                calls[impl].append((args, y))
                return y
            return call

        try:
            for impl in calls:
                dstformer.PAIR_IMPLS[impl] = tuple(
                    recorder(fn, impl) for fn in saved[impl])
            model(x, return_rep=True)
            plain(x, return_rep=True)
        finally:
            dstformer.PAIR_IMPLS.update(saved)
        for (_, k_out), (args, p_out) in zip(calls["kernel_q8"],
                                             calls["plain_q8"]):
            gated = len(args) > 17
            one = saved["kernel_q8"][int(gated)](*args)
            out["calls"].append(
                [args[-1], gated, rel_l2_t(k_out, p_out), rel_l2_t(one, p_out),
                 (one != p_out).float().mean().item()])
    return out


def baseline_q8_pairs(q8, other_q8, results: dict) -> dict:
    """B9 of this build, both wrappers and modes at the phase-10 inputs,
    held to its plain version's bars (the other build's errors logged
    beside) and to the other build's output bit for bit (into results), and
    timed against the other build in turns. Returns {name/mode: turns}."""
    dev = torch.device("cuda")
    scale = (C // HEADS) ** -0.5
    q8._library()
    out = {}
    for wrapper, plain, gated in (
            (q8.fused_pair_block_q8, q8.pair_block_q8_plain, False),
            (q8.fused_gated_pair_block_q8, q8.gated_pair_block_q8_plain,
             True)):
        for mode in ("temporal", "spatial"):
            p = pair_inputs(6 if mode == "temporal" else 7, gated, dev)
            args = pair_args(p, gated)
            call = lambda: wrapper(*args, HEADS, scale, mode)
            ref = plain(*args, HEADS, scale, mode)
            ours = call()
            with swapped_library("pair_q8_kernels", other_q8):
                theirs = call()
            errs = {b: (rel_err(o, ref)[1], rel_l2_t(o, ref))
                    for b, o in (("this", ours), ("other", theirs))}
            tag = f"{wrapper.__name__}/{mode}"
            results[tag] = torch.equal(ours, theirs)
            out[tag] = in_turns(call, None, "pair_q8_kernels", other_q8)
            for turn in out[tag]:
                turn.update(q8_profile_split(turn["device_by_kernel"]))
            log(f"baseline: {tag}: (max|d|/max|plain|, relative L2) "
                f"{json.dumps(errs)}; in turns: " + json.dumps(out[tag]))
            if not (errs["this"][0] <= Q8_KERNEL_TOL
                    and errs["this"][1] <= Q8_KERNEL_L2_TOL):
                fail(f"baseline: {tag}: {errs['this']} over "
                     f"({Q8_KERNEL_TOL}, {Q8_KERNEL_L2_TOL})")
            del p, args, ref, ours, theirs
    torch.cuda.empty_cache()
    return out


# argument types of B9_tp's four entries in a checkout from before the
# column-quantiser kernels (its mbt_pair_q8_tp_out takes a pair_out scratch)
EARLIER_TP_ARGTYPES = {
    "mbt_pair_q8_tp_attn": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "mbt_pair_q8_tp_partial": [ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "mbt_pair_q8_tp_mlp": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "mbt_pair_q8_tp_out": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
    + [ctypes.c_void_p]}


def earlier_q8_tp(lib, args, heads: int, scale: float, mode: str):
    """B9_tp as a checkout from before the column-quantiser kernels ran it
    on one rank's shards without a group: its weights quantised with
    PyTorch's operators (earlier_quant_cols), then its four entries
    (attention stage with a row-maximum pass, the partial products, the MLP
    stage with its dequantising and LayerNorm passes, the output pass with
    pair_out and the gate), the stages' buffers as its wrapper made them."""
    x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, \
        w2, b2, wg, bg = args
    for name, argtypes in EARLIER_TP_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    B_, F_, J_, C_ = x.shape
    M, ci, hl, dev = B_ * F_ * J_, wqkv.shape[0] // 3, w1.shape[0], x.device
    (wqkv8, sqkv), (w18, s1), (wproj8, sproj), (w28, s2) = (
        earlier_quant_cols(w) for w in (wqkv, w1, wproj, w2))
    new = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                       device=dev)
    a8, ascale, amax = new(M, max(C_, ci, hl), dt=torch.int8), new(M), new(M)
    acc = new(M, C_, dt=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    qkv, attn = new(M, 3 * ci, dt=x.dtype), new(M, ci, dt=x.dtype)
    rc = [lib.mbt_pair_q8_tp_attn(
        ptr(x), ptr(a8), ptr(ascale), ptr(qkv), ptr(attn), ptr(amax),
        ptr(ln1_w), ptr(ln1_b), ptr(wqkv8), ptr(sqkv), ptr(bqkv), B_, F_, J_,
        C_, ci, heads, float(scale), int(mode == "temporal"), stream)]
    partial = lambda src, w8, ws: lib.mbt_pair_q8_tp_partial(
        ptr(src), int(src.dtype == torch.float32), ptr(amax), ptr(a8),
        ptr(ascale), ptr(w8), ptr(ws), ptr(acc), M, C_, src.shape[-1],
        stream)
    rc.append(partial(attn, wproj8, sproj))
    y, act = torch.empty_like(x), new(M, hl)
    rc.append(lib.mbt_pair_q8_tp_mlp(
        ptr(acc), ptr(ascale), ptr(sproj), ptr(bproj), ptr(x), ptr(y),
        ptr(a8), ptr(ln2_w), ptr(ln2_b), ptr(w18), ptr(s1), ptr(b1),
        ptr(act), ptr(amax), M, C_, hl, stream))
    rc.append(partial(act, w28, s2))
    out = torch.empty_like(x)
    pair_out = None if other is None else torch.empty_like(x)
    rc.append(lib.mbt_pair_q8_tp_out(
        ptr(acc), ptr(ascale), ptr(s2), ptr(b2), ptr(y), ptr(other), ptr(wg),
        ptr(bg), ptr(pair_out), ptr(out), M, C_, stream))
    if any(rc):
        fail(f"baseline: the other build's B9_tp entries returned {rc}")
    return out


def baseline_q8_tp(q8, other_q8, results: dict) -> dict:
    """B9_tp at phase 31 (a)'s inputs (model rank 0's shards of TP_T, no
    group), both modes, gated and not: this build's output bit for bit the
    other build's (into results), and both timed in turns (other, this,
    this, other) with the device time by kernel. The other checkout runs
    through earlier_q8_tp where it has no column-quantiser kernels, else
    through this checkout's wrapper on its library. Returns
    {fused_pair_block_q8_tp/tag: turns}."""
    dev = torch.device("cuda")
    scale, heads = (C // HEADS) ** -0.5, HEADS // TP_T
    out = {}
    for gated in (False, True):
        for mode in ("temporal", "spatial"):
            tag = ("gated " if gated else "") + mode
            p = tp_shards(pair_inputs(40 + 2 * gated + (mode == "spatial"),
                                      gated, dev))
            args = q8_tp_args(p, gated)
            call = lambda: q8.fused_pair_block_q8_tp(*args, heads, scale,
                                                     mode)
            other_call = None if OTHER_QUANT_KERNELS else (
                lambda: earlier_q8_tp(other_q8, args, heads, scale, mode))
            ours = call()
            with swapped_library("pair_q8_kernels", other_q8):
                theirs = (other_call or call)()
            key = f"fused_pair_block_q8_tp/{tag}"
            results[key] = torch.equal(ours, theirs)
            out[key] = in_turns(call, pair_q8_tp_records(gated),
                                "pair_q8_kernels", other_q8, other_call)
            for turn in out[key]:
                turn.update(q8_profile_split(turn["device_by_kernel"]))
            log(f"baseline: {key}: bit for bit the other build's "
                f"{results[key]}; in turns: " + json.dumps(out[key]))
            del p, args, ours, theirs
    torch.cuda.empty_cache()
    return out


# the gradients a column sum in a new fixed order produces (the LayerNorm
# backward's one pass sums its chunks in another order than the column sums
# it replaced); split_bitwise holds them to the plain bar, not to the other
# build's bits
NEW_ORDER_GRADS = ("dln_w", "dln_b", "dln1_w", "dln1_b", "dln2_w", "dln2_b")


def split_bitwise(tag: str, names, ours, theirs, again, plain) -> bool:
    """A backward's outputs of this build (ours, and again for run-to-run
    bits) against the other build's (theirs): every output bit for bit but
    NEW_ORDER_GRADS, which are held to KERNEL_TOL of the plain twin's (the
    other build's distance logged beside); every output of this build
    bitwise repeatable. Logs and returns whether all held."""
    bitwise = {n: torch.equal(a, b) for n, a, b in zip(names, ours, theirs)
               if n not in NEW_ORDER_GRADS}
    repeat = all(torch.equal(a, b) for a, b in zip(ours, again))
    errs = {n: (rel_err(a, w)[1], rel_err(b, w)[1])
            for n, a, b, w in zip(names, ours, theirs, plain)
            if n in NEW_ORDER_GRADS and w.abs().max() > 0}
    held = all(bitwise.values()) and repeat and all(
        e[0] <= KERNEL_TOL for e in errs.values())
    log(f"{tag}: bit for bit the other build's "
        f"{sorted(n for n, v in bitwise.items() if v)}, not "
        f"{sorted(n for n, v in bitwise.items() if not v)}; bitwise "
        f"repeatable {repeat}; new-order sums max|d|/max|plain| (this, "
        f"other) " + json.dumps(errs))
    return held


def baseline_pair_bwd(fp, other_bwd, results: dict) -> dict:
    """B3's four variants of this build against the other's on the phase-7
    inputs, as split_bitwise holds them, and timed against the other build
    in turns. Returns {name/mode: turns}."""
    dev = torch.device("cuda")
    scale = (C // HEADS) ** -0.5
    fp._bwd_library()
    out = {}
    for name, kernel, plain, gated in (
            ("fused_pair_block_bwd", fp.fused_pair_block_bwd,
             fp.pair_block_bwd_plain, False),
            ("fused_gated_pair_block_bwd", fp.fused_gated_pair_block_bwd,
             fp.gated_pair_block_bwd_plain, True)):
        names = ["dx"] + (["dother"] if gated else []) \
            + [f"d{k}" for k in fp.PAIR_PARAMS] \
            + (["dwg", "dbg"] if gated else [])
        for mode in ("temporal", "spatial"):
            p = pair_inputs(3 if mode == "temporal" else 4, gated, dev)
            g = pair_inputs(5, False, dev)["x"]
            fwd = pair_args(p, gated)
            args = fwd[:2 if gated else 1] + [g] + fwd[2 if gated else 1:]
            call = lambda: kernel(*args, HEADS, scale, mode)
            ours = call()
            with swapped_library("pair_bwd_kernels", other_bwd):
                theirs = call()
            results[f"{name}/{mode}"] = split_bitwise(
                f"baseline: {name}/{mode}", names, ours, theirs, call(),
                plain(*args, HEADS, scale, mode))
            out[f"{name}/{mode}"] = in_turns(
                call, pair_bwd_records(gated), "pair_bwd_kernels", other_bwd)
            log(f"baseline: {name}/{mode} in turns: "
                + json.dumps(out[f"{name}/{mode}"]))
            del p, g, fwd, args, ours, theirs
    torch.cuda.empty_cache()
    return out


def baseline_steps(name: str, other, tag: str,
                   drop_path_rate: float = 0.0) -> None:
    """Phase 8's flagship train steps (with drop_path_rate, phase 18's) in
    turns (other, this, this, other) with the other checkout's library for
    csrc/<name>.cu swapped in: ms per step; then one step of each build
    profiled."""
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.losses.pose import LAMBDA_KEYS
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.train.pose3d import make_train_step
    from motionbert_tpu_torch.train.state import make_adamw

    args = get_config(TRAIN_CONFIG)
    lambdas = {k: args.get(k, 0.0) for k in LAMBDA_KEYS}
    model = load_backbone(args, device="cuda", drop_path_rate=drop_path_rate)
    model.load_state_dict(load_state_dict(ANCHOR), strict=True)
    opt = make_adamw(model.parameters(), args.learning_rate,
                     args.weight_decay)
    step = make_train_step(model, opt, lambdas, rootrel=args.rootrel,
                           no_conf=args.no_conf, flip_aug=bool(args.flip),
                           generator=torch.Generator(device="cuda").manual_seed(0))
    x, y = train_batch(TRAIN_BATCH)
    steps_in_turns(f"{tag} step ({TRAIN_BATCH}, {FRAMES})", name, other,
                   step, x, y)
    del model, opt, step
    torch.cuda.empty_cache()


def steps_in_turns(tag: str, name: str, other, step, x, y) -> None:
    """step(x, y) in turns (other, this, this, other) with the other
    checkout's library for csrc/<name>.cu swapped in: ms per step over
    BASELINE_STEPS steps a turn, after a warm-up; then one step of each
    build profiled (this build's held to the column-sum pass)."""
    def steps() -> float:
        step(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BASELINE_STEPS):
            step(x, y)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / BASELINE_STEPS * 1e3

    steps()                 # warm-up: the first steps allocate and tune
    turns = []
    for which in ("other", "this", "this", "other"):
        with (swapped_library(name, other) if which == "other"
              else contextlib.nullcontext()):
            turns.append((which, steps()))
    log(f"baseline: {tag}, {BASELINE_STEPS} steps a turn, ms per step in "
        f"turns: " + ", ".join(f"{w} {ms:.2f}" for w, ms in turns))
    profile_tag = tag.split(" step")[0]
    with swapped_library(name, other):
        profile_step(f"baseline {profile_tag} profile (other)", step, x, y)
    profile_step(f"baseline {profile_tag} profile (this)", step, x, y,
                 column_sums=True)


def baseline_mesh_step(other) -> None:
    """Phase 26's mesh train step (configs/mesh/MB_train_h36m.yaml at its
    batch, the seeded body model) in turns (other, this, this, other) with
    the other checkout's pair backward library swapped in: ms per step; then
    one step of each build profiled."""
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.losses.mesh import LAMBDA_KEYS
    from motionbert_tpu_torch.models.smpl import SMPLModel
    from motionbert_tpu_torch.train.mesh import (
        build_mesh_model, make_mesh_train_step)
    from motionbert_tpu_torch.train.state import make_two_group_adamw

    args = get_config(MESH_CONFIG)
    smpl = SMPLModel.synthetic(num_verts=MESH_VERTS, seed=0).cuda()
    model = build_mesh_model(args, smpl, device="cuda")
    model.init_weights(torch.Generator().manual_seed(0))
    opt = make_two_group_adamw(model, args.lr_backbone, args.lr_head,
                               args.weight_decay)
    step = make_mesh_train_step(
        model, opt, {k: args[k] for k in LAMBDA_KEYS},
        args.get("loss_type", "L1"),
        torch.Generator(device="cuda").manual_seed(0))
    x, gt = mesh_batch(smpl, args.batch_size, args.clip_len, 84)
    steps_in_turns(f"mesh step ({args.batch_size}, {args.clip_len})",
                   "pair_bwd_kernels", other, step, x, gt)
    del model, opt, step, smpl
    torch.cuda.empty_cache()


def baseline_lift(other_pair, other_q8) -> None:
    """Phase 4's flip-TTA lift of the anchor, and phase 11's in the W8A8
    tier, in turns (other, this, this, other) with the other checkout's
    pair or W8A8 pair library swapped in: clips/s over BASELINE_STEPS calls
    a turn."""
    from motionbert_tpu_torch.api import MotionBERT

    x = seeded_motion(np.random.RandomState(0), LIFT_BATCH, FRAMES)
    for tag, attn_impl, name, other in (
            ("lift", None, "pair_kernels", other_pair),
            ("q8 lift", "kernel_q8", "pair_q8_kernels", other_q8)):
        mb = MotionBERT.from_config(CONFIG, checkpoint=ANCHOR,
                                    attn_impl=attn_impl)
        mb.lift(x)
        turns = []
        for which in ("other", "this", "this", "other"):
            with (swapped_library(name, other) if which == "other"
                  else contextlib.nullcontext()):
                mb.lift(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(BASELINE_STEPS):
                    mb.lift(x)
                dt = (time.perf_counter() - t0) / BASELINE_STEPS
                turns.append((which, LIFT_BATCH / dt))
        log(f"baseline: {tag} ({LIFT_BATCH}, {FRAMES}) flip-TTA, "
            f"{BASELINE_STEPS} calls a turn, clips/s in turns: "
            + ", ".join(f"{w} {v:.2f}" for w, v in turns))
        del mb
        torch.cuda.empty_cache()


def phase_baseline(fp, q8, other_root: str) -> dict:
    """Build another checkout's pair, W8A8 pair, block, pair backward,
    attention core and stream sources (the parent's, say) with this one's
    nvcc flags. Hold this checkout's bf16 pairs (B1, B2), bf16 streams,
    pair backward (B3) and MLP blocks (B6, B7) against that build bit for
    bit, through the same wrappers (B3's and B7's LayerNorm gradients, a
    sum in a new fixed order, to their plain bars: split_bitwise); hold the
    attention blocks (B4, B5), the bf16 pairs and streams, the W8A8 pairs
    (B9) and streams (B10) and the attention core alone (B8) to their plain
    bars and time them, B3 and B7 too, against the other build in turns;
    time the LayerNorm backward against the other build's, its dx bit for
    bit; then the flagship train step, the drop-path step, the mesh step,
    the lift and the W8A8 lift in turns with the other build's pair backward,
    block, pair or W8A8 pair library swapped in. Returns the in-turn times
    by record and mode."""
    from motionbert_tpu_torch.ops import fused_stream as fs

    csrc = os.path.join(other_root, "motionbert_tpu_torch", "ops", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        from concurrent.futures import ThreadPoolExecutor

        names = ("pair_kernels", "pair_q8_kernels", "block_kernels",
                 "pair_bwd_kernels", "stream_kernels", "st_attention_kernels")
        with ThreadPoolExecutor(len(names)) as pool:
            libs = dict(zip(names, pool.map(
                lambda name: build_other(csrc, name, tmp), names)))
        results = {}
        global OTHER_QUANT_KERNELS
        OTHER_QUANT_KERNELS = hasattr(libs["pair_q8_kernels"],
                                      "mbt_quant_cols")
        log(f"baseline: the other checkout has column-quantiser kernels: "
            f"{OTHER_QUANT_KERNELS}")
        other_gemm = build_other_q8_gemm(csrc, tmp)
        if other_gemm is None:
            log("baseline: the other checkout has no first-design int8 GEMM "
                "(launch_gemm_q8) to hold the s8 engine against")
        else:
            baseline_q8_gemm(q8, other_gemm, results)
        turns = baseline_q8_pairs(q8, libs["pair_q8_kernels"], results)
        turns.update(baseline_q8_tp(q8, libs["pair_q8_kernels"], results))
        dist = {"this": q8_model_distance()}
        with swapped_library("pair_q8_kernels", libs["pair_q8_kernels"]):
            dist["other"] = q8_model_distance()
        log("baseline: depth-2 W8A8 model, relative L2 of (kernels vs plain "
            "q8, kernels vs fp32, plain q8 vs fp32): " + json.dumps(dist))
        log("baseline: depth-2 W8A8 model, plain q8 with its attention core "
            "swapped vs plain q8, and pair call by pair call (mode, gated, "
            "kernels vs plain cumulative, one kernel call on the plain "
            "input, share of its outputs that differ): " + json.dumps(
                q8_model_witnesses(libs["st_attention_kernels"])))
        turns.update(baseline_blocks(libs["block_kernels"], results))
        turns.update(baseline_ln_bwd(libs["block_kernels"], results))
        turns.update(baseline_tp_blocks(libs["block_kernels"], other_root,
                                        results))
        turns.update(baseline_pair_bwd(fp, libs["pair_bwd_kernels"],
                                       results))
        turns.update(baseline_st_attention(libs["st_attention_kernels"]))
        turns.update(baseline_pairs(fp, fs, libs["pair_kernels"],
                                    libs["stream_kernels"], results))
        log(f"baseline ({other_root}): this checkout's outputs bitwise equal "
            f"to the other build's: {json.dumps(results)}")
        if not all(results.values()):
            fail(f"baseline: outputs differ: {results}")
        baseline_steps("pair_bwd_kernels", libs["pair_bwd_kernels"],
                       "train")
        baseline_steps("block_kernels", libs["block_kernels"], "drop-path",
                       DROP_PATH_RATE)
        baseline_mesh_step(libs["pair_bwd_kernels"])
        baseline_lift(libs["pair_kernels"], libs["pair_q8_kernels"])
    return turns


def attach_turns(records: list, turns: dict) -> None:
    """The in-turn times (phase_baseline) into the records they belong to:
    each mode's of B1 / B2 (phase 3) and each mode and flag pair's of B4 /
    B5 (phases 16, 17), with the main mode's at the top, and the bf16 B10
    variants' (phase 24)."""
    for rec in records:
        per_mode = {mode: turns[f"{rec['name']}/{mode}"]
                    for mode in rec.get("modes", ())
                    if f"{rec['name']}/{mode}" in turns}
        for mode, t in per_mode.items():
            rec["modes"][mode]["in_turns"] = t
        if rec.get("mode") in per_mode:
            rec["in_turns"] = per_mode[rec["mode"]]
        elif rec["name"] in turns:
            rec["in_turns"] = turns[rec["name"]]


def phase_mesh_all(fp, q8) -> list:
    from motionbert_tpu_torch.ops import fused_stream as fs

    records = timed("stream kernels", phase_stream_kernels, fp, q8, fs)
    timed("stream main path", phase_stream_main_path, fp, q8, fs, records)
    timed("mesh", phase_mesh, fp, fs)
    timed("mesh drivers", phase_mesh_drivers, fp, fs)
    return records


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases",
                        choices=("all", "pairs", "train", "q8", "blocks",
                                 "action", "mesh", "dist", "render",
                                 "tp", "tp2", "anchor"),
                        default="all",
                        help="pairs: only phases 1, 2, 3 and 24; train: only "
                             "phases 1, 2, the engine and core phases, 7 and "
                             "8; q8: only phases 1, 2 and 10-15; blocks: only "
                             "phases 1, 2 and 16-19; action: only phases 1, "
                             "2 and 20-23; mesh: only phases 1, 2 and 24-27; "
                             "dist: only phases 1, 2 and 28; render: only "
                             "phases 1, 2 and 29; tp: only phases 1, 2 and "
                             "30; tp2: only phases 1, 2 and 31; anchor: "
                             "only phases 1, 2 and 32; none of them prints "
                             "the last line")
    parser.add_argument("--baseline", default=None, metavar="ROOT",
                        help="another checkout (the parent's, say): after the "
                             "build, hold this checkout's bf16 pairs and "
                             "streams, pair backward and MLP blocks against "
                             "that checkout's build, bit for bit (the "
                             "LayerNorm gradients of the backwards to their "
                             "plain bars), hold its attention blocks, pairs, "
                             "W8A8 pairs, streams and attention core to "
                             "their plain bars and time them, the pair and "
                             "MLP backwards, the train, drop-path and mesh "
                             "steps, the lift and the W8A8 lift in turns "
                             "with that build's")
    parser.add_argument("--epochs", type=int, default=60,
                        help="--phases anchor: epochs in all (the JAX "
                             "anchor's 60)")
    parser.add_argument("--mid", type=int, default=20,
                        help="--phases anchor: epochs of the first process")
    opts = parser.parse_args()
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    log(f"device: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")
    torch.cuda.set_device(0)

    from motionbert_tpu_torch.ops import _build
    from motionbert_tpu_torch.ops import fused_pair as fp
    from motionbert_tpu_torch.ops import pair_q8 as q8

    # phase 2: build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        kernel = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                found = re.search(r"(hg_gemm_kernel|attn_tc_fwd_kernel|"
                                  r"attn_tc_bwd_kernel|hg_gemm_s8_kernel|"
                                  r"colsum_chunks_kernel|hg_gemm_pair_kernel|"
                                  r"attn_tc_bwd_query_kernel|"
                                  r"attn_tc_bwd_key_kernel|hg_ln_kernel|"
                                  r"attn_tc_fwd_query_kernel)"
                                  r"I((?:L[ib]\d+E)+)E", line)
                kernel = "" if not found else f"{found[1]}<" + ", ".join(
                    re.findall(r"L[ib](\d+)E", found[2])) + ">: "
                plain = re.search(r"(ln_bwd_fused_kernel|chunk_sum_kernel)",
                                  line)
                if plain:
                    kernel = f"{plain[1]}: "
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"build: {name}: {kernel}{line.strip()}")

    if opts.baseline and opts.phases == "tp":
        turns = timed("baseline", phase_baseline_tp, opts.baseline)
    elif opts.baseline:
        turns = timed("baseline", phase_baseline, fp, q8, opts.baseline)

    if opts.phases == "train":
        from motionbert_tpu_torch.ops import attention as at
        from motionbert_tpu_torch.ops import fused_mlp as mlp

        timed("engine", phase_engine, mlp)
        timed("core", phase_core, fp, at)
        bwd_records = timed("backward", phase_backward, fp)
        timed("train", phase_train, fp, [], bwd_records)
        log(json.dumps({"kernels": bwd_records}))
        log(f"device: {smi}")
        log("partial run (--phases train): no result line")
        return 0

    if opts.phases == "pairs":
        from motionbert_tpu_torch.ops import fused_stream as fs

        records = timed("kernels", phase_kernels, fp)
        records += timed("stream kernels", phase_stream_kernels, fp, q8, fs)
        if opts.baseline:
            attach_turns(records, turns)
        log(json.dumps({"kernels": records}))
        log(f"device: {smi}")
        log("partial run (--phases pairs): no result line")
        return 0

    if opts.phases == "mesh":
        log(json.dumps({"kernels": phase_mesh_all(fp, q8)}))
        log(f"device: {smi}")
        log("partial run (--phases mesh): no result line")
        return 0

    if opts.phases == "q8":
        records = timed("q8", phase_q8, q8, fp)
        if opts.baseline:
            attach_turns(records, turns)
        log(json.dumps({"kernels": records}))
        log(f"device: {smi}")
        log("partial run (--phases q8): no result line")
        return 0

    if opts.phases == "blocks":
        records = phase_blocks(fp)
        if opts.baseline:
            attach_turns(records, turns)
        log(json.dumps({"kernels": records}))
        log(f"device: {smi}")
        log("partial run (--phases blocks): no result line")
        return 0

    if opts.phases == "action":
        log(json.dumps({"kernels": phase_action_all(fp)}))
        log(f"device: {smi}")
        log("partial run (--phases action): no result line")
        return 0

    if opts.phases == "tp":
        records = []
        timed("tp", phase_tp, records)
        if opts.baseline:
            attach_turns(records, turns)
        log(json.dumps({"kernels": records}))
        log(f"device: {smi}")
        log("partial run (--phases tp): no result line")
        return 0

    if opts.phases == "tp2":
        records = []
        timed("tp2", phase_tp2, records)
        if opts.baseline:
            attach_turns(records, turns)
        log(json.dumps({"kernels": records}))
        log(f"device: {smi}")
        log("partial run (--phases tp2): no result line")
        return 0

    if opts.phases == "anchor":
        timed("anchor", phase_anchor, opts.epochs, opts.mid)
        log(f"device: {smi}")
        log("partial run (--phases anchor): no result line")
        return 0

    if opts.phases == "dist":
        timed("dist", phase_dist, [])
    if opts.phases == "render":
        timed("render", phase_render, fp, [])
    if opts.phases in ("dist", "render"):
        log(f"device: {smi}")
        log(f"partial run (--phases {opts.phases}): no result line")
        return 0

    records = timed("kernels", phase_kernels, fp)
    mb, x = timed("main path", phase_main_path, fp, records)
    timed("profile", phase_profile, mb, x)
    timed("serving", phase_serving, mb)
    del mb, x
    torch.cuda.empty_cache()
    q8_records = timed("q8", phase_q8, q8, fp)
    bwd_records = timed("backward", phase_backward, fp)
    timed("train", phase_train, fp, records, bwd_records)
    timed("driver", phase_driver)
    records += bwd_records + phase_blocks(fp) + q8_records
    records += phase_action_all(fp)
    records += phase_mesh_all(fp, q8)
    timed("dist", phase_dist, records)
    timed("render", phase_render, fp, records)
    timed("tp", phase_tp, records)
    timed("tp2", phase_tp2, records)
    if opts.baseline:
        attach_turns(records, turns)

    log(json.dumps({"kernels": records}))
    log(f"device: {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
