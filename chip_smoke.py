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
Then a JSON line of per-kernel numbers, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package motionbert_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "pose3d", "MB_ft_h36m.yaml")
ANCHOR = os.path.join(ROOT, "data", "anchors", "flagship_synth_trained.npz")

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

KERNEL_TOL = 2e-2   # max|kernel - plain| / max|plain|, bf16 vs bf16
PATH_TOL = 2e-2     # max|bf16 kernels - fp32 plain| / max|fp32 plain|
B, FRAMES, J, C, HEADS, HIDDEN = 4, 243, 17, 512, 8, 1024
LIFT_BATCH = 8


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


def phase_profile(mb, x):
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
    # device-side rows only: an aten:: row repeats the time of its kernels
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    busy_ms = sum(ms for _, ms, _ in rows)
    log(f"profile: one lift ({LIFT_BATCH}, {FRAMES}) under the profiler: "
        f"{wall_ms:.2f} ms wall, {busy_ms:.2f} ms device busy "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"profile: {ms:9.3f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
            f"{n:5d}x {key[:100]}")


def phase_serving(mb):
    from motionbert_tpu_torch.serve import MotionBERTServer

    rs = np.random.RandomState(5)
    clips = [seeded_motion(rs, 1, 243 if i % 2 == 0 else 81)[0]
             for i in range(20)]
    direct = [mb.lift(c[None])[0] for c in clips]
    results = [None] * len(clips)
    srv = MotionBERTServer(mb, batch_buckets=(1, 8, 32), max_wait_ms=20)
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
    log(f"serving: {len(clips)} requests (243 and 81 frames) from "
        f"{n_threads} threads in {dt:.2f} s; {stats.batches} batches, "
        f"avg batch {stats.avg_batch_size:.2f}; worst max|d|/max|ref| vs "
        f"direct lift {worst:.3e}; shutdown returned")


def main() -> int:
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

    # phase 2: build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    records = phase_kernels(fp)
    mb, x = phase_main_path(fp, records)
    phase_profile(mb, x)
    phase_serving(mb)

    log(json.dumps({"kernels": records}))
    log(f"device: {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
