"""Human mesh recovery: the train step, the flip-averaged eval step,
validation and the epoch driver, with its command line:

    python -m motionbert_tpu_torch.train.mesh \\
        --config configs/mesh/MB_train_synth_smoke.yaml -c ckpt_dir [--device cpu]

The port of ``motionbert_tpu/train/mesh.py`` and the root ``train_mesh.py``
(reference train_mesh.py). Flags as there (--config -c -p -r -e -ms -sd
-freq) plus --device, which defaults to the card, --attn_impl, which
defaults to the config's key, and --dist_backend. The backbone runs
through the pair kernels (bf16 on the card), the head and the SMPL layer in
fp32. The step: the ten
weighted loss terms (``losses.mesh``), AdamW in two groups (backbone and
head learning rates) decayed per epoch, the head's BatchNorm statistics
updated in the step, and the train-time MPJPE / MPVE. Each epoch trains on
h36m while epoch < warmup_h36m, on coco while epoch < warmup_coco and on
3DPW when ``train_pw3d`` is set; it validates h36m (while in its warmup) and
3DPW (always, when the config names it), with flip averaging in SMPL theta
space; the best checkpoint follows MPJPE, 3DPW's when present. Dropout masks
draw from one ``torch.Generator`` on the model's device whose state the
checkpoints keep. Data parallel under ``torchrun`` as ``train.pose3d`` is:
the head's BatchNorms take the global batch's statistics, and the
backbone's unused output head stays out of DDP's gradient reduction.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from motionbert_tpu_torch.core.metrics import AverageMeter
from motionbert_tpu_torch.geometry.rotations import flip_thetas
from motionbert_tpu_torch.geometry.skeleton import flip_data
from motionbert_tpu_torch.losses.mesh import (
    LAMBDA_KEYS, evaluate_mesh, mesh_total_loss)
from motionbert_tpu_torch.models.mesh_head import MeshRegressor
from motionbert_tpu_torch.models.smpl import SMPLModel, smpl_forward
from motionbert_tpu_torch.parallel.mesh import (
    add_dist_backend, check_batch_size, eval_rows, init_distributed,
    mean_over_ranks, padded_eval_batches, rank_batches, run_main, world_size,
    wrap_ddp)

# the best-MPJPE value before any validation (the reference's)
NO_METRIC = 9999.0


def make_mesh_train_step(model: MeshRegressor,
                         optimizer: torch.optim.Optimizer, lambdas: dict,
                         loss_type: str = "L1",
                         generator: Optional[torch.Generator] = None
                         ) -> Callable:
    """step(batch_input (N, T, 17, 3), batch_gt {"theta", "kp_3d", "verts"})
    -> the loss terms, "total", "mpjpe" and "mpve" as 0-d fp32 tensors on
    the device, after one update. The model runs in training mode: the
    head's BatchNorms on the batch's statistics, updating their running
    averages, and the dropout masks from ``generator``."""

    def train_step(batch_input: torch.Tensor, batch_gt: dict) -> dict:
        model.train()
        out = model(batch_input, generator=generator)
        total, terms = mesh_total_loss(out, batch_gt, lambdas, loss_type)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        with torch.no_grad():   # root-relative, each to its own root
            root = out["kp_3d"][:, :, 0:1]
            groot = batch_gt["kp_3d"][:, :, 0:1]
            for name, key in (("mpjpe", "kp_3d"), ("mpve", "verts")):
                terms[name] = torch.linalg.norm(
                    (out[key] - root) - (batch_gt[key] - groot),
                    dim=-1).mean()
        return {k: v.detach() for k, v in terms.items()}

    return train_step


def make_mesh_eval_step(model: MeshRegressor, flip_tta: bool) -> Callable:
    """step(batch_input (N, T, 17, 3)) -> {"theta", "verts", "kp_3d"}, fp32,
    in evaluation mode (BatchNorm's running statistics, no dropout). With
    flip_tta the mirrored clip runs too; its thetas are flipped back
    (``flip_thetas``) and run through the SMPL layer again, and the two
    predictions are averaged (reference train_mesh.py:83-108)."""
    smpl = model.head.smpl

    @torch.inference_mode()
    def eval_step(batch_input: torch.Tensor) -> dict:
        model.eval()
        out = model(batch_input)
        if not flip_tta:
            return out
        N, T = batch_input.shape[:2]
        out_f = model(flip_data(batch_input))
        pose_f = flip_thetas(out_f["theta"][..., :72].reshape(N, T, 24, 3)
                             ).reshape(N * T, 72)
        shape_f = out_f["theta"][..., 72:].reshape(N * T, -1)
        verts_f = smpl_forward(smpl, shape_f, pose_f)["vertices"] * 1000.0
        kp_f = torch.einsum("jv,bvc->bjc", smpl.J_regressor_h36m, verts_f)
        back = {"theta": torch.cat([pose_f.reshape(N, T, -1),
                                    shape_f.reshape(N, T, -1)], -1),
                "verts": verts_f.reshape(N, T, -1, 3),
                "kp_3d": kp_f.reshape(N, T, -1, 3)}
        return {k: (out[k] + back[k]) * 0.5 for k in out}

    return eval_step


def _to_device(batch_gt: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch_gt.items()}


def validate(test_loader, model: MeshRegressor, args,
             dataset_name: str = "h36m") -> tuple:
    """(loss, mpjpe, pa_mpjpe, mpve, {term: AverageMeter}) over the loader,
    flip-averaged when ``args.flip``, the rank's rows of each padded batch
    gathered; the metrics by ``evaluate_mesh``."""
    device = next(model.parameters()).device
    eval_step = make_mesh_eval_step(model, flip_tta=args.get("flip", False))
    lambdas = {k: float(args[k]) for k in LAMBDA_KEYS}
    loss_type = args.get("loss_type", "L1")
    losses = AverageMeter()
    meters: dict = {}
    results = {"kp_3d": [], "verts": [], "kp_3d_gt": [], "verts_gt": []}
    for batch_input, batch_gt, n in padded_eval_batches(test_loader,
                                                        world_size()):
        out = eval_rows(eval_step, batch_input, device, n)
        total, terms = mesh_total_loss(_to_device(out, device),
                                       _to_device(batch_gt, device), lambdas,
                                       loss_type)
        losses.update(float(total), n)
        for k, v in terms.items():
            meters.setdefault(k, AverageMeter()).update(float(v), n)
        for k in ("kp_3d", "verts"):
            results[k].append(out[k])
            results[k + "_gt"].append(np.asarray(batch_gt[k]))
    err = evaluate_mesh({k: np.concatenate(v) for k, v in results.items()})
    print(f"=======================> {dataset_name} validation done:",
          " ".join(f"{k}: {v:.2f}mm" for k, v in err.items()))
    return losses.avg, err["mpjpe"], err["pa_mpjpe"], err["mpve"], meters


def smpl_model_path(args) -> str:
    return args.get("smpl_model_path",
                    os.path.join(args.data_root, "smpl_model.npz"))


def build_mesh_model(args, smpl_model: SMPLModel, device=None,
                     attn_impl: Optional[str] = None,
                     dtype: Optional[torch.dtype] = None) -> MeshRegressor:
    """The config's backbone (``models.factory.load_backbone``: the card by
    default, bf16 there) with the SMPL head over ``smpl_model``, on the
    backbone's device, uninitialised (``init_weights`` or a state_dict)."""
    from motionbert_tpu_torch.models.factory import load_backbone

    backbone = load_backbone(args, dtype=dtype, device=device,
                             attn_impl=attn_impl)
    model = MeshRegressor(backbone=backbone, smpl_model=smpl_model,
                          dim_rep=args.dim_rep, num_joints=args.num_joints,
                          hidden_dim=args.get("hidden_dim", 1024),
                          dropout_ratio=args.get("dropout", 0.5))
    return model.to(next(backbone.parameters()).device)


def _loaders(args, smpl_model: SMPLModel, seed: int) -> dict:
    """name -> (train loader or None, test loader) for each dataset the
    config names (dt_file_h36m, dt_file_coco, dt_file_pw3d)."""
    from motionbert_tpu_torch.data.dataset_mesh import MotionSMPL
    from motionbert_tpu_torch.data.datasets import BatchLoader

    def pair(name, batch_size, train=True):
        train_ld = BatchLoader(MotionSMPL(args, "train", name, smpl_model),
                               batch_size, shuffle=True, drop_last=True,
                               seed=seed) if train else None
        return train_ld, BatchLoader(
            MotionSMPL(args, "test", name, smpl_model), batch_size)

    loaders = {}
    if "dt_file_h36m" in args:
        loaders["h36m"] = pair("h36m", args.batch_size)
    if "dt_file_coco" in args:
        loaders["coco"] = pair("coco", args.get("batch_size_img",
                                                args.batch_size))
    if "dt_file_pw3d" in args:
        loaders["pw3d"] = pair("pw3d", args.batch_size,
                               args.get("train_pw3d", False))
    return loaders


def train_with_config(args, opts, device=None, attn_impl=None) -> dict:
    """The epoch driver (reference train_mesh.py:250-400) on ``device``
    (None: the card). opts: checkpoint, pretrained, resume, evaluate,
    selection, seed, print_freq. Resumes from the checkpoint directory's
    latest_epoch.ckpt when there is one. Returns {"best_jpe", "history": one
    dict per epoch run}, or with ``opts.evaluate`` {dataset: {"mpjpe",
    "pa_mpjpe", "mpve"}} for h36m and 3DPW."""
    from motionbert_tpu_torch.core.checkpoint import (
        CheckpointManager, is_port_checkpoint, load_checkpoint,
        load_state_dict)
    from motionbert_tpu_torch.core.logging import open_writer
    from motionbert_tpu_torch.train.action import (
        JAX_MISSING_KEYS, load_action_state, load_pretrained_backbone,
        restore_training, resume_from, save_epoch)
    from motionbert_tpu_torch.train.state import (
        freeze_except, make_two_group_adamw, scale_lr)

    dev = init_distributed(device, getattr(opts, "dist_backend", None))
    check_batch_size(args.batch_size)
    if "dt_file_coco" in args:
        check_batch_size(args.get("batch_size_img", args.batch_size))
    os.makedirs(opts.checkpoint, exist_ok=True)
    writer = open_writer(os.path.join(opts.checkpoint, "logs"))

    # the loaders' body model stays on the host; the network gets its own
    model = build_mesh_model(args, SMPLModel.from_npz(smpl_model_path(args)),
                             device=dev, attn_impl=attn_impl)
    model.init_weights(torch.Generator().manual_seed(opts.seed))
    if args.get("finetune", False) and not (opts.resume or opts.evaluate):
        chk = os.path.join(opts.pretrained, opts.selection)
        print("Loading backbone", chk)
        print("load_weight", load_pretrained_backbone(model,
                                                      load_state_dict(chk)))

    print("Loading dataset...")
    loaders = _loaders(args, SMPLModel.from_npz(smpl_model_path(args)),
                       opts.seed)

    ckpt_mgr = CheckpointManager(opts.checkpoint,
                                 args.get("checkpoint_frequency", 1))
    chk = resume_from(opts, ckpt_mgr)
    payload = None
    if chk:
        print("Loading checkpoint", chk)
        load_action_state(model, load_state_dict(chk))
        if is_port_checkpoint(chk):
            payload = load_checkpoint(chk)

    if opts.evaluate:
        out = {}
        for name in ("h36m", "pw3d"):
            if name in loaders:
                _, jpe, pa, ve, _ = validate(loaders[name][1], model, args,
                                             name)
                out[name] = {"mpjpe": jpe, "pa_mpjpe": pa, "mpve": ve}
        writer.close()
        return out

    if args.get("partial_train", None):
        freeze_except(model, args.partial_train, scope="backbone")
    optimizer = make_two_group_adamw(model, args.lr_backbone, args.lr_head,
                                     args.weight_decay)
    generator = torch.Generator(device=dev).manual_seed(opts.seed)
    st, best_jpe = restore_training(payload, optimizer, generator)
    if payload is None:
        best_jpe = NO_METRIC

    lambdas = {k: args[k] for k in LAMBDA_KEYS}
    train_step = make_mesh_train_step(
        wrap_ddp(model, dev, ignore=JAX_MISSING_KEYS), optimizer, lambdas,
        args.get("loss_type", "L1"), generator)
    print_freq = int(getattr(opts, "print_freq", 100) or 100)

    def run_train(loader, meters):
        for idx, (batch_input, batch_gt) in enumerate(
                rank_batches(loader, dev)):
            terms = mean_over_ranks(train_step(batch_input, batch_gt))
            for k, v in terms.items():
                meters.setdefault(k, AverageMeter()).update(
                    float(v), len(batch_input) * world_size())
            if (idx + 1) % print_freq == 0:
                tm = meters["total"]
                print(f"[{idx + 1}/{len(loader)}]\tloss {tm.val:.4f} "
                      f"({tm.avg:.4f})", flush=True)

    history = []
    for epoch in range(st, args.epochs):
        print(f"Training epoch {epoch}.")
        for train_ld, _ in loaders.values():
            if train_ld is not None:   # 3DPW may be evaluation only
                train_ld.set_epoch(epoch)
        meters: dict = {}
        lr = optimizer.param_groups[0]["lr"]
        record = {"epoch": epoch, "lr": lr,
                  "lr_head": optimizer.param_groups[1]["lr"]}
        test_mpjpe = None
        if "h36m" in loaders and epoch < args.get("warmup_h36m", args.epochs):
            run_train(loaders["h36m"][0], meters)
            _, test_mpjpe, pa, ve, _ = validate(loaders["h36m"][1], model,
                                                args, "h36m")
            for tag, v in (("test_mpjpe", test_mpjpe), ("test_pa_mpjpe", pa),
                           ("test_mpve", ve)):
                writer.add_scalar(tag, v, epoch + 1)
            record.update(h36m_mpjpe=test_mpjpe, h36m_pa_mpjpe=pa,
                          h36m_mpve=ve)
        if "coco" in loaders and epoch < args.get("warmup_coco", args.epochs):
            run_train(loaders["coco"][0], meters)
        if "pw3d" in loaders:
            if loaders["pw3d"][0] is not None:
                run_train(loaders["pw3d"][0], meters)
            _, test_mpjpe, pa, ve, _ = validate(loaders["pw3d"][1], model,
                                                args, "pw3d")
            for tag, v in (("test_mpjpe_pw3d", test_mpjpe),
                           ("test_pa_mpjpe_pw3d", pa),
                           ("test_mpve_pw3d", ve)):
                writer.add_scalar(tag, v, epoch + 1)
            record.update(pw3d_mpjpe=test_mpjpe, pw3d_pa_mpjpe=pa,
                          pw3d_mpve=ve)
        for k, m in meters.items():
            writer.add_scalar(f"train_loss/{k}", m.avg, epoch + 1)
        scale_lr(optimizer, args.lr_decay)
        improved = test_mpjpe is not None and test_mpjpe < best_jpe
        if improved:
            best_jpe = test_mpjpe
        loss = meters["total"].avg if "total" in meters else None
        print(f"[{epoch + 1}] train_total {loss} test_mpjpe {test_mpjpe} "
              f"best {best_jpe}")
        record.update(loss=loss, best_jpe=best_jpe)
        history.append(record)
        save_epoch(ckpt_mgr, epoch, model, optimizer, best_jpe, improved,
                   generator)
    writer.close()
    return {"best_jpe": best_jpe, "history": history}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str,
                        default="configs/mesh/MB_train_h36m.yaml",
                        help="Path to the config file.")
    parser.add_argument("-c", "--checkpoint", default="checkpoint", type=str,
                        metavar="PATH", help="checkpoint directory")
    parser.add_argument("-p", "--pretrained", default="checkpoint", type=str,
                        metavar="PATH", help="pretrained checkpoint directory")
    parser.add_argument("-r", "--resume", default="", type=str,
                        metavar="FILENAME", help="checkpoint to resume")
    parser.add_argument("-e", "--evaluate", default="", type=str,
                        metavar="FILENAME", help="checkpoint to evaluate")
    parser.add_argument("-freq", "--print_freq", type=int, default=100)
    parser.add_argument("-ms", "--selection", default="latest_epoch.ckpt",
                        type=str, metavar="FILENAME",
                        help="checkpoint to finetune")
    parser.add_argument("-sd", "--seed", default=0, type=int,
                        help="random seed")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--attn_impl", default=None,
                        help="pair implementation: kernel, plain, kernel_q8, "
                             "plain_q8, kernel_stream, kernel_stream_q8 "
                             "(default: the config's attn_impl key, "
                             "else kernel)")
    add_dist_backend(parser)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    from motionbert_tpu_torch.core.config import get_config

    opts = parse_args(argv)
    return run_main(train_with_config, opts, get_config(opts.config))


if __name__ == "__main__":
    main()
