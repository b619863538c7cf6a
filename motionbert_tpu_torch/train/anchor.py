"""Train the flagship to convergence on the learnable synthetic H36M mirror
with the JAX anchor's recipe, stopping midway and resuming in a new
process, and hold the trace to the JAX anchor's
(``data/anchors/anchor_trace.json``):

    python -m motionbert_tpu_torch.train.anchor [--epochs 60] [--mid 20]
        [--workdir DIR] [--fresh] [--phase {1,2,both}] [--device cuda]
    python -m motionbert_tpu_torch.train.anchor --smoke --device cpu

The port of ``tools/train_anchor.py``. The recipe is the JAX tool's: the
flagship DSTformer (dim 512, depth 5, 8 heads, mlp_ratio 2, maxlen 243,
att_fuse), AdamW at batch 32, lr 2e-4, weight decay 0.01, decay 0.99 an
epoch, the 3D velocity (20) and scale (0.5) losses, flip, mask and noise off
(the xy -> z map is not equivariant under the left/right swap), seed 0, on
243-frame clips at stride 81 of a pickle drawn from data seed 1 (6 train
subjects x 16 videos of ~600 frames). ``--smoke`` takes the tool's tiny
geometry (16-frame clips at stride 8, dim 64, depth 2, 4 heads, batch 8).

Phase 1 trains epochs 0..mid-1 through ``train.pose3d.train_with_config``
and stops; phase 2, another process, resumes from ``latest_epoch.ckpt``
(params, AdamW moments and step, lr, epoch, best e1, generator) and trains
to ``--epochs``. ``--phase both`` runs the two phases as two child
processes. Phase 2 then writes ``<workdir>/anchor_trace_torch.json`` (the
JAX witness's keys, the card's name and power limit, ms per step on the
device clock, peak memory, trained clips/s and the checks), prints it as
one JSON line and exits non-zero when a check fails:

- phase 2 starts at epoch ``mid``, at lr = lr0 * decay ** mid (to 1e-12),
  and AdamW's step count in the last checkpoint is both phases' steps;
- every loss and e1 is finite;
- on the full recipe (not ``--smoke``, ``--epochs`` the JAX trace's 60):
  the best e1 at most 1.2 times the JAX trace's (152.95 mm), and the mean
  ``loss_3d_pos`` of the last 5 epochs at most 1.25 times the JAX trace's.

The device defaults to the card and raises without one; ``--device cpu``
runs on the CPU. No weights leave the workdir.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_TRACE = os.path.join(ROOT, "data", "anchors", "anchor_trace.json")
TRACE_NAME = "anchor_trace_torch.json"

# the JAX tool's data (tools/train_anchor.py): drawn from seed 1, so none of
# its videos is one of the seed-0 sets'; 96 videos of ~600 frames cut into
# 480 train clips of 243 frames at stride 81 (15 steps an epoch at batch 32)
# and 12 test clips
DATA_SEED = 1
TRAIN_SUBJECTS = (1, 2, 3, 4, 5, 6)
TRAIN_VIDEOS = 16
FRAMES_PER_VIDEO = 600

# the bars against the JAX trace
E1_FACTOR = 1.2
LOSS_FACTOR = 1.25
LAST_EPOCHS = 5
LR_TOL = 1e-12


def build_args(root: str, smoke: bool):
    """The JAX tool's recipe as a config (``tools/train_anchor.py``'s
    ``build_args``), its data under ``root``."""
    from motionbert_tpu_torch.core.config import ConfigDict

    args = ConfigDict(dict(
        train_2d=False, no_eval=False, finetune=False, partial_train=None,
        epochs=30, checkpoint_frequency=10_000,  # latest and best only
        batch_size=32, dropout=0.0,
        learning_rate=2e-4, weight_decay=0.01, lr_decay=0.99,
        maxlen=243, dim_feat=512, mlp_ratio=2, depth=5, dim_rep=512,
        num_heads=8, att_fuse=True,
        data_root=os.path.join(root, "MB3D_f243s81") + os.sep,
        subset_list=["H36M-SYN"],
        dt_file="h36m_synth_anchor.pkl", dt_root=root,
        clip_len=243, data_stride=81, rootrel=True, sample_stride=1,
        num_joints=17, no_conf=False, gt_2d=False,
        lambda_3d_velocity=20.0, lambda_scale=0.5, lambda_lv=0.0,
        lambda_lg=0.0, lambda_a=0.0, lambda_av=0.0,
        synthetic=False, flip=False,
        mask_ratio=0.0, mask_T_ratio=0.0, noise=False))
    if smoke:
        args.update(dict(maxlen=16, clip_len=16, data_stride=8,
                         dim_feat=64, dim_rep=64, depth=2, num_heads=4,
                         batch_size=8))
    return args


def build_data(root: str, clip_len: int, data_stride: int) -> str:
    """The learnable-z pickle and its clips under ``root``, made once: a
    ``.complete`` marker in the clip directory says they are there."""
    from motionbert_tpu_torch.data.synthetic import (
        convert_h36m, make_h36m_pickle)

    clip_root = os.path.join(root, "MB3D_f243s81", "H36M-SYN")
    marker = os.path.join(clip_root, ".complete")
    if not os.path.exists(marker):
        make_h36m_pickle(os.path.join(root, "h36m_synth_anchor.pkl"),
                         n_frames_per_video=FRAMES_PER_VIDEO, seed=DATA_SEED,
                         learnable_z=True, train_subjects=TRAIN_SUBJECTS,
                         train_videos=TRAIN_VIDEOS)
        n_train, n_test = convert_h36m(
            root, "h36m_synth_anchor.pkl", clip_root, n_frames=clip_len,
            data_stride=data_stride)
        print(f"wrote {n_train} train / {n_test} test clips to {clip_root}")
        with open(marker, "w") as f:
            f.write("ok")
    return clip_root


def read_trace(ckpt_dir: str) -> dict:
    """Per-epoch scalars of the trainer's JSONL log, {tag: [value by
    epoch]}, rounded to 4 decimals as the JAX tool rounds them; a later
    line for the same epoch replaces an earlier one."""
    trace: dict = {}
    with open(os.path.join(ckpt_dir, "logs", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            trace.setdefault(rec["tag"], {})[rec["step"]] = round(
                rec["value"], 4)
    return {tag: [v for _, v in sorted(d.items())]
            for tag, d in trace.items()}


def workdir(cli) -> str:
    return cli.workdir + ("_smoke" if cli.smoke else "")


def nvidia_smi_line():
    """`name, power.limit` of the first card as nvidia-smi gives it, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def run_phase(phase: int, cli) -> dict:
    """Train phase 1 (epochs 0..mid-1) or phase 2 (resume, to --epochs) in
    this process; write and return its figures (``phase{n}.json``)."""
    import torch

    from motionbert_tpu_torch.models.factory import resolve_device
    from motionbert_tpu_torch.train.pose3d import train_with_config

    dev = resolve_device(cli.device)
    root = workdir(cli)
    args = build_args(root, cli.smoke)
    build_data(root, args.clip_len, args.data_stride)
    ckpt_dir = os.path.join(root, "checkpoint")
    if phase == 1 and cli.fresh and os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    if phase == 2 and not os.path.exists(
            os.path.join(ckpt_dir, "latest_epoch.ckpt")):
        raise SystemExit(f"phase 2 resumes from phase 1's checkpoint, and "
                         f"{ckpt_dir} has no latest_epoch.ckpt")
    args.epochs = cli.mid if phase == 1 else cli.epochs
    opts = SimpleNamespace(checkpoint=ckpt_dir, pretrained="", resume="",
                           evaluate="", selection="best_epoch.ckpt", seed=0)
    print(f"=== phase {phase}: epochs ..{args.epochs}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = train_with_config(args, opts, device=dev)["history"]
    stats = {
        "phase": phase, "epochs": [h["epoch"] for h in hist],
        "lr": [h["lr"] for h in hist], "steps": [h["steps"] for h in hist],
        "step_ms": [h["step_ms"] for h in hist],
        "train_s": [h["train_s"] for h in hist],
        "wall_s": time.perf_counter() - t0,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev))}
    with open(os.path.join(root, f"phase{phase}.json"), "w") as f:
        json.dump(stats, f)
    return stats


def _check(value, bar, ok: bool) -> dict:
    return {"value": value, "bar": bar, "ok": bool(ok)}


def witness(cli, phases: list) -> dict:
    """The trace of both phases against the JAX anchor's, with the checks
    of the module docstring."""
    from motionbert_tpu_torch.core.checkpoint import load_checkpoint

    root = workdir(cli)
    args = build_args(root, cli.smoke)
    trace = read_trace(os.path.join(root, "checkpoint"))
    e1 = trace.get("Error P1", [])
    loss = trace.get("loss_3d_pos", [])
    with open(JAX_TRACE) as f:
        ref = json.load(f)
    p1, p2 = phases
    mid = cli.mid
    # AdamW's step count in the last checkpoint covers both phases' steps
    # only if phase 2 took phase 1's optimizer state over
    latest = load_checkpoint(os.path.join(root, "checkpoint",
                                          "latest_epoch.ckpt"))
    adam_steps = sorted({int(st["step"]) for st in
                         latest["optimizer"]["state"].values()})
    all_steps = sum(p1["steps"]) + sum(p2["steps"])

    checks = {
        "resumed_at_epoch": _check(p2["epochs"][0] if p2["epochs"] else None,
                                   mid, p2["epochs"][:1] == [mid]),
        "lr_at_resume": _check(
            p2["lr"][0] if p2["lr"] else None,
            args.learning_rate * args.lr_decay ** mid,
            bool(p2["lr"]) and abs(p2["lr"][0] - args.learning_rate
                                   * args.lr_decay ** mid) <= LR_TOL),
        "adam_steps": _check(adam_steps, all_steps,
                             adam_steps == [all_steps]),
        "finite": _check(None, None, len(e1) == len(loss) == cli.epochs
                         and all(math.isfinite(v) for v in e1 + loss)),
    }
    full = not cli.smoke and cli.epochs == len(ref["e1_mm_trace"])
    ref_loss = sum(ref["loss_3d_pos_trace"][-LAST_EPOCHS:]) / LAST_EPOCHS
    last_loss = (sum(loss[-LAST_EPOCHS:]) / LAST_EPOCHS
                 if len(loss) >= LAST_EPOCHS else None)
    if full:
        checks["best_e1_mm"] = _check(
            min(e1), E1_FACTOR * ref["best_e1_mm"],
            min(e1) <= E1_FACTOR * ref["best_e1_mm"])
        checks["last_loss_3d_pos"] = _check(
            last_loss, LOSS_FACTOR * ref_loss,
            last_loss is not None and last_loss <= LOSS_FACTOR * ref_loss)

    timed = [(n, ms) for p in phases for n, ms in zip(p["steps"], p["step_ms"])
             if ms is not None]
    steps = sum(n for n, _ in timed)
    clips = sum(n for p in phases for n in p["steps"]) * args.batch_size
    train_s = sum(s for p in phases for s in p["train_s"])
    peaks = [p["peak_memory_bytes"] for p in phases
             if p["peak_memory_bytes"] is not None]
    return {
        "what": "pose3d training convergence witness of the PyTorch port "
                "(motionbert_tpu_torch.train.anchor)",
        "device": p2["device"],
        "nvidia_smi": nvidia_smi_line() if p2["device"] != "cpu" else None,
        "epochs": cli.epochs,
        "steps_per_epoch": p2["steps"][0] if p2["steps"] else None,
        "batch_size": args.batch_size,
        "geometry": {k: args[k] for k in
                     ("dim_feat", "depth", "dim_rep", "num_heads",
                      "mlp_ratio", "maxlen", "clip_len")},
        "loss_3d_pos_trace": loss,
        "e1_mm_trace": e1,
        "best_e1_mm": min(e1) if e1 else None,
        "resume": {"witnessed": checks["resumed_at_epoch"]["ok"],
                   "resumed_at_epoch": checks["resumed_at_epoch"]["value"],
                   "note": "phase-2 process auto-resumed from "
                           "latest_epoch.ckpt mid-run"},
        "ms_per_step": (sum(n * ms for n, ms in timed) / steps
                        if steps else None),
        "ms_per_step_clock": "CUDA events around each train step",
        "peak_memory_gib": max(peaks) / 2 ** 30 if peaks else None,
        "trained_clips_per_s": clips / train_s if train_s else None,
        "trained_clips_per_s_clock": "host clock over the epochs' training, "
                                     "data loading included",
        "wall_minutes": sum(p["wall_s"] for p in phases) / 60.0,
        "reference": {"path": os.path.relpath(JAX_TRACE, ROOT),
                      "best_e1_mm": ref["best_e1_mm"],
                      f"last_{LAST_EPOCHS}_loss_3d_pos": ref_loss,
                      "device": ref["device"]},
        "checks": checks,
        "ok": all(c["ok"] for c in checks.values()),
        "measured_at_unix": int(time.time()),
    }


def phase_two(cli) -> int:
    """Phase 2, then the witness: written, printed, its verdict the exit
    code."""
    root = workdir(cli)
    p2 = run_phase(2, cli)
    with open(os.path.join(root, "phase1.json")) as f:
        p1 = json.load(f)
    out = witness(cli, [p1, p2])
    with open(os.path.join(root, TRACE_NAME), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    failed = [k for k, c in out["checks"].items() if not c["ok"]]
    if failed:
        print(f"anchor: FAILED checks {failed}", file=sys.stderr)
        return 1
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--mid", type=int, default=20,
                    help="epochs of phase 1, before the stop and resume")
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build", "anchor"),
                    help="data, checkpoints and the trace ('_smoke' appended "
                         "with --smoke)")
    ap.add_argument("--fresh", action="store_true",
                    help="discard the workdir's checkpoints before phase 1")
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny geometry (a wiring test)")
    ap.add_argument("--phase", choices=("1", "2", "both"), default="both",
                    help="run one phase in this process, or both as two "
                         "child processes")
    ap.add_argument("--device", default="cuda",
                    help="torch device; raises when it is a card and there "
                         "is none")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    cli = parse_args(argv)
    if cli.mid <= 0 or cli.mid >= cli.epochs:
        raise SystemExit(f"--mid must lie in 1..{cli.epochs - 1}")
    if cli.phase == "1":
        run_phase(1, cli)
        return 0
    if cli.phase == "2":
        return phase_two(cli)
    base = [sys.executable, "-m", "motionbert_tpu_torch.train.anchor",
            "--epochs", str(cli.epochs), "--mid", str(cli.mid),
            "--workdir", cli.workdir, "--device", cli.device]
    base += ["--smoke"] if cli.smoke else []
    first = subprocess.run(base + ["--phase", "1"]
                           + (["--fresh"] if cli.fresh else []), cwd=ROOT)
    if first.returncode != 0:
        return first.returncode
    return subprocess.run(base + ["--phase", "2"], cwd=ROOT).returncode


if __name__ == "__main__":
    sys.exit(main())
