#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (motionbert_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit code:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; exits non-zero when torch sees no CUDA device.
  2. build: nvcc compiles ops/csrc/*.cu from this checkout.
  3. kernels: every CUDA kernel of the serving path against its plain PyTorch
     version at the flagship shape (B 4, F 243, J 17, C 512, 8 heads, hidden
     1024), bf16, with its time, the plain version's, a one-library-call
     yardstick's, and the least time the card could take (bound).
  4. main path: MotionBERT.from_config on the flagship config with the trained
     anchor weights; flip-TTA lift and get_representation of a seeded
     (8, 243, 17, 3) batch through the kernels, held against the plain fp32
     path of the same model on the card; launch counts; clips/s.
  5. profile: one more lift under torch.profiler; device time by kernel.
  6. serving: MotionBERTServer answers concurrent requests of 243 and 81
     frames from several threads; each answer is held against a direct lift.
  7. backward kernels: the pair backward (plain and gated, temporal and
     spatial) at the phase-3 shape against its plain backward, per gradient
     tensor, twice for bitwise equality, with times, bound and a library
     yardstick (PyTorch's own operators, forward plus autograd).
  8. train step: the flagship pose3d training config with the anchor weights,
     a seeded (8, 243, 17, 3) batch and a smooth root-relative target; the
     first step's loss and gradients against the fp32 plain path (batch 4),
     then 10 AdamW steps through the kernels with the launch counts per step,
     ms per step, clips/s, peak memory, and one step under torch.profiler.
  9. driver: train_with_config on the synthetic smoke set at the flagship
     widths, 2 epochs with evaluation, then a resumed third epoch.
 10. q8 kernels: the W8A8 pair (plain and gated, temporal and spatial) at the
     phase-3 shape against its plain version (a max-based bar and a
     relative-L2 bar that a moved rounding point fails), twice for bitwise
     equality,
     with its time, bound, the plain version's time, a library yardstick
     (torch._int_mm products, PyTorch's own operators for the rest), the
     bf16 pair's time from the same run (one call at a time, and enqueued
     back to back), and the cost of quant_cols.
 11. q8 main path: MotionBERT.from_config with attn_impl="kernel_q8" and the
     anchor; a flip-TTA lift and a representation through the int8 kernels;
     launch counts; relative L2 error against the fp32 plain path beside
     the bf16 tier's; clips/s of both tiers; one q8 lift under the profiler.
 12. task gate: the H36M protocol on the synthetic smoke set with the anchor,
     for fp32 plain, bf16 kernels and q8 kernels; the q8 tier's MPJPE drift
     must stay within max(1 mm, 1 %) of the fp32 value.
 13. wild inference: a seeded Halpe-26 AlphaPose JSON through run_wild_pose
     in both tiers; shape, X3D.npy, root handling, and each clip against a
     direct lift.
 14. straight-through: the q8 Functions' backward against the bf16
     Functions', bit for bit, counted as backward-kernel launches.
 15. q8 serving: MotionBERTServer built with attn_impl="kernel_q8".
 16. block kernels: the standalone attention block (temporal and spatial) and
     MLP block at the phase-3 shape, in the flag combinations the model uses
     and with LayerNorm and residual both on, against their plain versions
     (the max-based bar and a relative-L2 bar), twice for bitwise equality,
     with times (one call at a time, and back to back), bound, the plain
     version's time and a library yardstick.
 17. block backward kernels: the same for the two backward chains, per
     gradient tensor.
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
 20. attention core (B8): st_attention, temporal and spatial, at the phase-3
     shape against its plain version (the max-based bar and a relative-L2
     bar), twice for bitwise equality, with times (one call, and back to
     back), bound, the plain version's time and a library yardstick
     (scaled_dot_product_attention on permuted copies); the StAttention
     backward against the fp32 plain backward, per tensor.
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
     (B1 -> B1 / B2, B9 -> B9), with times (one call, and back to back), the
     chain's times in the same run, bound, the plain version's time and a
     library yardstick (each pair's PyTorch operators, twice).
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
Phases 10-15 run after phase 6, phases 16-19 after phase 9, phases 20-23
after phase 19, phases 24-27 after phase 23. Then a JSON line of per-kernel
numbers, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --phases q8
    python3 chip_smoke.py --phases blocks
    python3 chip_smoke.py --phases action
    python3 chip_smoke.py --phases mesh

run only phases 1, 2 and 10-15, 1, 2 and 16-19, 1, 2 and 20-23, or 1, 2 and
24-27 (while working on them), and print no last line.

    python3 chip_smoke.py --baseline ROOT [--phases ...]

also builds the pair and W8A8 pair sources of the checkout at ROOT (the
parent's, unpacked with git archive) and holds this checkout's pair outputs
against that build, bit for bit, after phase 2.

Imports nothing of JAX or of the JAX package motionbert_tpu.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
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


def phase_kernels(fp) -> list:
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
            out = wrapper(*args, HEADS, scale, mode)
            torch.cuda.synchronize()
            ref = plain(*args, HEADS, scale, mode)
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                fail(f"{name}/{mode}: shape {tuple(out.shape)} or non-finite")
            abs_err, rel = rel_err(out, ref)
            lib_abs, lib_rel = rel_err(pair_library(p, gated, scale, mode), ref)
            flops, nbytes = pair_cost(mode, gated)
            t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
            rec = dict(
                max_abs_err=abs_err, rel_err=rel, tol=KERNEL_TOL,
                ms=time_ms(lambda: wrapper(*args, HEADS, scale, mode)),
                plain_ms=time_ms(lambda: plain(*args, HEADS, scale, mode),
                                 runs=10, warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(lambda: pair_library(p, gated, scale, mode)),
                library_rel_err=lib_rel, gflop=flops / 1e9, mbytes=nbytes / 1e6)
            log(f"kernel {name}/{mode}: " + json.dumps(rec))
            if not rel <= KERNEL_TOL:
                fail(f"{name}/{mode}: max|d|/max|ref| {rel:.3e} > {KERNEL_TOL}")
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
            library_ms=main["library_ms"], mode=main_mode,
            shape=[B, FRAMES, J, C], modes=modes))
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


# kernel-name fragments of the port's own kernels, for the profile's groups
PROFILE_GROUPS = ("gemm_q8_kernel", "ln_quant_rows_kernel",
                  "quant_rows_kernel", "attention_bwd_kernel",
                  "attention_kernel", "gate_bwd_rows_kernel", "gate_kernel",
                  "gemm_kernel", "colsum_kernel", "reduce_splits_kernel",
                  "ln_fwd_rows_kernel", "ln_bwd_rows_kernel")


def device_rows(prof) -> list:
    """(name, device ms, count) of the kernels in a profile: only events
    that ran on the device, so host-side ranges that enclose kernels (aten
    ops, the autograd Functions) do not count their time again."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def phase_profile(mb, x, tag: str = "profile"):
    """One more lift under torch.profiler: device time by kernel and the
    device's busy share of the wall time (the profiler's own overhead is in
    that wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
                    "other (PyTorch operators: casts, quant_cols, embed, head)")
        groups[name] = groups.get(name, 0.0) + ms
    log(f"{tag}: by group: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(groups.items(),
                                            key=lambda kv: -kv[1])}))


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


def pair_q8_library(p: dict, gated: bool, scale: float, mode: str):
    """The W8A8 pair from PyTorch's own operators (layer_norm, _int_mm,
    scaled_dot_product_attention): a yardstick of speed the port never
    calls."""
    x = p["x"]
    Bx, Fx, Jx, Cx = x.shape
    d = Cx // HEADS
    rows = lambda t: t.reshape(-1, t.shape[-1])
    h = F.layer_norm(x.float(), (Cx,), p["ln1_w"], p["ln1_b"], 1e-6)
    qkv = q8_linear_library(rows(h), p["wqkv"], p["bqkv"]).to(x.dtype)
    qkv = qkv.reshape(Bx, Fx, Jx, 3, HEADS, d)
    perm = (0, 1, 3, 2, 4) if mode == "spatial" else (0, 2, 3, 1, 4)
    q, k, v = (qkv[:, :, :, i].permute(perm) for i in range(3))
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    o = o.permute([perm.index(i) for i in range(5)]).reshape(Bx, Fx, Jx, Cx)
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
                quant_cols_ms=time_ms(
                    lambda: [q8.quant_cols(w) for w in weights]),
                int8_gop=int8_ops / 1e9, bf16_gflop=bf16_flops / 1e9,
                mbytes=nbytes / 1e6)
            log(f"q8 kernel {name}/{mode}: " + json.dumps(rec))
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
            library_ms=main["library_ms"], mode=main_mode,
            shape=[B, FRAMES, J, C], modes=modes))
    torch.cuda.empty_cache()
    return records


def rel_l2(out: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def pair_counters(q8, fp) -> tuple:
    return (q8.fused_pair_block_q8, q8.fused_gated_pair_block_q8,
            fp.fused_pair_block, fp.fused_gated_pair_block)


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
              "fused_pair_block": 0, "fused_gated_pair_block": 0}
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
    records = phase_q8_kernels(q8, fp)
    mb8, mb16, x = phase_q8_main_path(q8, fp, records)
    phase_profile(mb8, x, tag="q8 profile")
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
    gradient), and the attention core three times (the forward, then dP/dv
    and dq/dk at twice the work, as one backward). Bytes: x, g (+ other)
    read, dx (+ dother) written, the weights read and their gradients
    written once."""
    flops, nbytes = pair_cost(mode, gated)
    M = B * FRAMES * J
    weight_bytes = nbytes - 2 * M * C * 2 - (M * C * 2 if gated else 0)
    grad_bytes = (3 * C * C + C * C + 2 * C * HIDDEN) * 2 \
        + (3 * C + C + HIDDEN + C) * 2 + 4 * C * 4 \
        + ((2 * 2 * C + 2) * 2 if gated else 0)
    act = (2 if gated else 1) * M * C * 2
    return 3 * flops, 2 * act + M * C * 2 + weight_bytes + grad_bytes


def grad_errors(got, want) -> list:
    return [rel_err(a, b) for a, b in zip(got, want)]


def phase_backward(fp) -> list:
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
            rec = dict(
                rel_err={n: e[1] for n, e in zip(names, errs)},
                max_abs_err=max(e[0] for e in errs), tol=KERNEL_TOL,
                bitwise_repeatable=bitwise,
                ms=time_ms(lambda: kernel(*args, HEADS, scale, mode)),
                plain_ms=time_ms(lambda: plain(*args, HEADS, scale, mode),
                                 runs=5, warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(library, runs=10),
                gflop=flops / 1e9, mbytes=nbytes / 1e6)
            log(f"backward {name}/{mode}: " + json.dumps(rec))
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
            library_ms=main["library_ms"], mode=main_mode,
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
                       tensor_tol=grad_tensor_tol) -> None:
    """The first step's loss and gradients (bf16 kernels) against a plain
    path's: the loss, the cosine of all gradients as one vector, and each
    tensor's max|d| / max|ref| (to ``tensor_tol(name)``)."""
    per = {n: rel_err(grads[n], ref_grads[n])[1] for n in ref_grads}
    cosine = grad_cosine(grads, ref_grads)
    worst = sorted(per.items(), key=lambda kv: -kv[1])
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    log(f"{tag}: {what}: loss {loss:.6f} (bf16 kernels) vs {ref_loss:.6f} "
        f"(plain), rel {loss_rel:.3e}; gradient cosine {cosine:.6f}; median "
        f"tensor max|d|/max|ref| {statistics.median(per.values()):.3e}; worst "
        + ", ".join(f"{n} {e:.3e}" for n, e in worst[:12]))
    over = [(n, e) for n, e in worst if not e <= tensor_tol(n)]
    if not (loss_rel <= LOSS_TOL and cosine >= cosine_min) or over:
        fail(f"{tag}: {what} disagrees with the plain path: loss rel "
             f"{loss_rel:.3e}, cosine {cosine:.6f} (bar {cosine_min}), over "
             f"the bar: {over}")


def grad_cosine(grads: dict, ref_grads: dict) -> float:
    """The cosine of two gradient dicts, each flattened into one vector."""
    flat = torch.cat([grads[n].flatten() for n in ref_grads])
    ref_flat = torch.cat([ref_grads[n].flatten() for n in ref_grads])
    return F.cosine_similarity(flat, ref_flat, dim=0).item()


def profile_step(tag: str, step, x, y) -> None:
    """One more train step under torch.profiler: device time by kernel and
    by group, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    expect = {"fused_pair_block": 15, "fused_gated_pair_block": 5,
              "fused_pair_block_bwd": 15, "fused_gated_pair_block_bwd": 5}
    if per_step != expect:
        fail(f"train step launched {per_step}, expected {expect}")
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

    profile_step("train profile", step, x, y)
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
# phases 16 and 17: the standalone attention and MLP blocks
# ---------------------------------------------------------------------------

# bf16 block kernel vs its plain version as a relative L2: rounding flips of
# qkv, attn and the hidden activation only (measured 1.5e-4 to 1.0e-3); the
# bar is the q8 pair's, which a moved rounding point fails
BLOCK_L2_TOL = 4e-3
ATTN_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")
MLP_KEYS = ("ln2_w", "ln2_b", "w1", "b1", "w2", "b2")
# (use_ln, residual): what the model calls, then everything on
ATTN_FLAGS = ((True, False), (True, True))
MLP_FLAGS = ((False, False), (True, True))


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
    backward's inputs are x, g and the weights, so its recompute counts: each
    product and the core three times; x and g read, dx written, the weights
    read and their gradients written once."""
    M = B * FRAMES * J
    if kind == "attention":
        w_elems, b_elems = 3 * C * C + C * C, 3 * C + C
        flops = 2 * M * w_elems
        groups, n = (B * J, FRAMES) if mode == "temporal" else (B * FRAMES, J)
        flops += 4 * groups * n * n * C
    else:
        w_elems, b_elems = 2 * C * HIDDEN, HIDDEN + C
        flops = 2 * M * w_elems
    param_bytes = (w_elems + b_elems) * 2 + 2 * C * 4
    if backward:
        return 3 * flops, 3 * M * C * 2 + 2 * param_bytes
    return flops, 2 * M * C * 2 + param_bytes


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


def phase_block_kernels(at, mlp) -> list:
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
            bitwise = torch.equal(out, wrapper(*args, *extra, *fl))
            ref = plain(*args, *extra, *fl)
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                fail(f"{kind} block {tag}: shape {tuple(out.shape)} or "
                     f"non-finite")
            abs_err, rel = rel_err(out, ref)
            l2 = rel_l2_t(out, ref)
            lib_rel = rel_err(library(*args, *fl), ref)[1]
            flops, nbytes = block_cost(kind, mode, False)
            t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
            rec = dict(
                max_abs_err=abs_err, rel_err=rel, tol=KERNEL_TOL, rel_l2=l2,
                l2_tol=BLOCK_L2_TOL, bitwise_repeatable=bitwise,
                ms=time_ms(lambda: wrapper(*args, *extra, *fl)),
                back_to_back_ms=time_ms_back_to_back(
                    lambda: wrapper(*args, *extra, *fl)),
                plain_ms=time_ms(lambda: plain(*args, *extra, *fl), runs=10,
                                 warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(lambda: library(*args, *fl)),
                library_rel_err=lib_rel, gflop=flops / 1e9,
                mbytes=nbytes / 1e6)
            log(f"block kernel {kind}/{tag}: " + json.dumps(rec))
            if not (rel <= KERNEL_TOL and l2 <= BLOCK_L2_TOL):
                fail(f"{kind} block {tag}: max|d|/max|ref| {rel:.3e} (bar "
                     f"{KERNEL_TOL}), relative L2 {l2:.3e} (bar "
                     f"{BLOCK_L2_TOL})")
            if not bitwise:
                fail(f"{kind} block {tag}: two runs gave different bits")
            modes[kind][tag] = rec
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


def phase_block_backward(at, mlp) -> list:
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
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            want = plain(*args, *extra, *fl)
            if any(not torch.isfinite(t.float()).all() for t in got):
                fail(f"{kind} block backward {tag}: non-finite gradient")
            errs = {n: rel_err(a, b) for n, a, b in
                    zip(grad_names[kind], got, want)
                    if use_ln or not n.startswith("dln")}
            if not use_ln and (got[1].any() or got[2].any()):
                fail(f"{kind} block backward {tag}: LayerNorm gradients "
                     f"without LayerNorm")
            leaves = [t.detach().clone().requires_grad_() for t in fwd]
            used = [t for n, t in zip(("x",) + keys, leaves)
                    if use_ln or not n.startswith("ln")]

            def library_bwd():
                return torch.autograd.grad(library(*leaves, *fl), used, g)

            flops, nbytes = block_cost(kind, mode, True)
            t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
            rec = dict(
                rel_err={n: e[1] for n, e in errs.items()},
                max_abs_err=max(e[0] for e in errs.values()), tol=KERNEL_TOL,
                bitwise_repeatable=bitwise,
                ms=time_ms(lambda: kernel(*args, *extra, *fl)),
                back_to_back_ms=time_ms_back_to_back(
                    lambda: kernel(*args, *extra, *fl)),
                plain_ms=time_ms(lambda: plain(*args, *extra, *fl), runs=5,
                                 warmup=1),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=time_ms(library_bwd, runs=10),
                gflop=flops / 1e9, mbytes=nbytes / 1e6)
            log(f"block backward {kind}/{tag}: " + json.dumps(rec))
            worst = max(rec["rel_err"].items(), key=lambda kv: kv[1])
            if not worst[1] <= KERNEL_TOL:
                fail(f"{kind} block backward {tag}: {worst[0]} "
                     f"max|d|/max|ref| {worst[1]:.3e} > {KERNEL_TOL}")
            if not bitwise:
                fail(f"{kind} block backward {tag}: two runs gave different "
                     f"bits")
            modes[kind][tag] = rec
            del got, again, want, leaves, used
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

    profile_step("drop-path profile", step, x, y)

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


def phase_st_attention(at) -> dict:
    scale = (C // HEADS) ** -0.5
    modes = {}
    for i, mode in enumerate(ST_MODES):
        q, k, v = st_inputs(20 + i)
        args = (q, k, v, mode, HEADS, scale)
        out = at.st_attention(*args)
        torch.cuda.synchronize()
        bitwise = torch.equal(out, at.st_attention(*args))
        ref = at.st_attention_plain(*args)
        if out.shape != ref.shape or not torch.isfinite(out.float()).all():
            fail(f"st_attention/{mode}: shape {tuple(out.shape)} or "
                 f"non-finite")
        abs_err, rel = rel_err(out, ref)
        l2 = rel_l2_t(out, ref)
        lib_rel = rel_err(st_library(q, k, v, mode, scale), ref)[1]
        flops, nbytes = st_cost(mode)
        t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
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
            l2_tol=ST_L2_TOL, bitwise_repeatable=bitwise,
            ms=time_ms(lambda: at.st_attention(*args)),
            back_to_back_ms=time_ms_back_to_back(
                lambda: at.st_attention(*args)),
            plain_ms=time_ms(lambda: at.st_attention_plain(*args), runs=10,
                             warmup=1),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes > t_ops else "operations",
            library_ms=time_ms(lambda: st_library(q, k, v, mode, scale)),
            library_rel_err=lib_rel, gflop=flops / 1e9, mbytes=nbytes / 1e6,
            backward_rel_err_vs_fp32=bwd_rel,
            backward_plain_ms=time_ms(lambda: at.st_attention_bwd_plain(
                q, k, v, g, mode, HEADS, scale), runs=5, warmup=1))
        log(f"st_attention/{mode}: " + json.dumps(rec))
        if not (rel <= KERNEL_TOL and l2 <= ST_L2_TOL):
            fail(f"st_attention/{mode}: max|d|/max|ref| {rel:.3e} (bar "
                 f"{KERNEL_TOL}), relative L2 {l2:.3e} (bar {ST_L2_TOL})")
        if not bitwise:
            fail(f"st_attention/{mode}: two runs gave different bits")
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


def action_head_check(model, x, y) -> None:
    """The classification head as the timed steps run it, in training mode
    (BatchNorm on the batch's statistics, updating its running averages), on
    the card against a copy on the CPU, fp32 both, on the kernels'
    representation of ``x`` and without dropout (the full-path comparison
    holds the masks): logits, the gradients of the head and of its input,
    and the running statistics after, each by max|d| / max|CPU|, and fc1's
    bias gradient against the BatchNorm bias's, to HEAD_TOL."""
    N, M, T, J, C = x.shape
    with torch.no_grad():
        rep = model.backbone(x.reshape(N * M, T, J, C), return_rep=True)
    feat = rep.reshape(N, M, T, J, -1).float()
    out = {}
    for dev in ("cuda", "cpu"):
        head = copy.deepcopy(model.head).to(dev).train()
        leaf = feat.detach().to(dev).requires_grad_()
        fc1 = []
        hook = head.fc1.register_forward_hook(
            lambda m, i, o: fc1.append(o.detach()))
        logits = head(leaf)
        hook.remove()
        F.cross_entropy(logits, y.to(dev)).backward()
        t = {"logits": logits.detach(), "d feat": leaf.grad}
        t.update({f"d {n}": p.grad for n, p in head.named_parameters()})
        t.update(running_mean=head.bn.running_mean,
                 running_var=head.bn.running_var)
        out[dev] = ({k: v.detach().cpu().float() for k, v in t.items()},
                    fc1[0].var(0, unbiased=False))
    (card, var), (cpu, _) = out["cuda"], out["cpu"]
    vanishing = "d fc1.bias"
    errs = {k: rel_err(card[k], cpu[k])[1] for k in cpu if k != vanishing}
    norm = lambda t: torch.linalg.norm(t).item()
    vanish = max(norm(card[vanishing]), norm(cpu[vanishing])) \
        / norm(cpu["d bn.bias"])
    log(f"action: head in training mode, batch {N} x 2 persons, card against "
        f"CPU (fp32): " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f"; fc1.bias |g| / |g bn.bias| {vanish:.3e}; fc1 output batch "
        f"variance mean {var.mean().item():.4e}, median "
        f"{var.median().item():.4e} (BatchNorm eps 1e-5)")
    over = {k: e for k, e in errs.items() if not e <= HEAD_TOL}
    if over or not vanish <= HEAD_TOL:
        fail(f"action: the head in training mode disagrees between card and "
             f"CPU: {over}, fc1.bias {vanish:.3e}")


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
        rec = dict(
            order="".join(order), max_abs_err=abs_err, rel_err=rel, tol=tol,
            rel_l2=l2, l2_tol=l2_tol, bitwise_repeatable=bitwise,
            bitwise_equal_to_pair_chain=equal_chain,
            ms=time_ms(call), back_to_back_ms=time_ms_back_to_back(call),
            chain_ms=time_ms(chain),
            chain_back_to_back_ms=time_ms_back_to_back(chain),
            plain_ms=time_ms(lambda: plain(*args, HEADS, scale, order),
                             runs=5, warmup=1),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes > t_ops else "operations",
            library_ms=time_ms(lambda: stream_library(
                p1, p2, gated, scale, order, q8_tier)),
            library_rel_err=lib_rel, mbytes=nbytes / 1e6)
        log(f"stream kernel {name}: " + json.dumps(rec))
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
    profile_step("mesh profile", step, x, gt)
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
# --baseline: the pair chains of another checkout, bit for bit
# ---------------------------------------------------------------------------

def phase_baseline(fp, q8, other_root: str) -> None:
    """Build another checkout's pair_kernels.cu and pair_q8_kernels.cu (the
    parent's, say) with this one's nvcc flags, and hold this checkout's pair
    and W8A8 pair outputs, plain and gated, temporal and spatial, against
    them bit for bit, through the same wrappers."""
    import ctypes

    from motionbert_tpu_torch.ops import _build

    csrc = os.path.join(other_root, "motionbert_tpu_torch", "ops", "csrc")
    scale = (C // HEADS) ** -0.5
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name in ("pair_kernels", "pair_q8_kernels"):
            so = os.path.join(tmp, f"{name}.so")
            out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                                  os.path.join(csrc, f"{name}.cu")],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                fail(f"baseline: nvcc failed for {name}.cu:\n{out.stdout}"
                     f"{out.stderr}")
            libs[name] = ctypes.CDLL(so)
        results = {}
        for name, module, wrapper in (
                ("pair_kernels", fp, fp.fused_pair_block),
                ("pair_kernels", fp, fp.fused_gated_pair_block),
                ("pair_q8_kernels", q8, q8.fused_pair_block_q8),
                ("pair_q8_kernels", q8, q8.fused_gated_pair_block_q8)):
            gated = "gated" in wrapper.__name__
            for mode in ("temporal", "spatial"):
                p = pair_inputs(50, gated, dev)
                args = pair_args(p, gated)
                ours = wrapper(*args, HEADS, scale, mode)
                module._library()          # argtypes set on our library
                fn_name = "mbt_pair_block_q8" if module is q8 \
                    else "mbt_pair_block"
                theirs_lib = libs[name]
                getattr(theirs_lib, fn_name).argtypes = getattr(
                    module._library(), fn_name).argtypes
                getattr(theirs_lib, fn_name).restype = ctypes.c_int
                saved = _build._libs[name]
                _build._libs[name] = theirs_lib
                try:
                    theirs = wrapper(*args, HEADS, scale, mode)
                finally:
                    _build._libs[name] = saved
                results[f"{wrapper.__name__}/{mode}"] = torch.equal(ours,
                                                                    theirs)
    log(f"baseline ({other_root}): this checkout's pair outputs bitwise "
        f"equal to the other build's: {json.dumps(results)}")
    if not all(results.values()):
        fail(f"baseline: outputs differ: {results}")


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
                        choices=("all", "q8", "blocks", "action", "mesh"),
                        default="all",
                        help="q8: only phases 1, 2 and 10-15; blocks: only "
                             "phases 1, 2 and 16-19; action: only phases 1, "
                             "2 and 20-23; mesh: only phases 1, 2 and 24-27; "
                             "none of them prints the last line")
    parser.add_argument("--baseline", default=None, metavar="ROOT",
                        help="another checkout (the parent's, say): after the "
                             "build, hold this checkout's pair and W8A8 pair "
                             "outputs against that checkout's build, bit for "
                             "bit")
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
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    if opts.baseline:
        timed("baseline", phase_baseline, fp, q8, opts.baseline)

    if opts.phases == "mesh":
        log(json.dumps({"kernels": phase_mesh_all(fp, q8)}))
        log(f"device: {smi}")
        log("partial run (--phases mesh): no result line")
        return 0

    if opts.phases == "q8":
        log(json.dumps({"kernels": timed("q8", phase_q8, q8, fp)}))
        log(f"device: {smi}")
        log("partial run (--phases q8): no result line")
        return 0

    if opts.phases == "blocks":
        log(json.dumps({"kernels": phase_blocks(fp)}))
        log(f"device: {smi}")
        log("partial run (--phases blocks): no result line")
        return 0

    if opts.phases == "action":
        log(json.dumps({"kernels": phase_action_all(fp)}))
        log(f"device: {smi}")
        log("partial run (--phases action): no result line")
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

    log(json.dumps({"kernels": records}))
    log(f"device: {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
