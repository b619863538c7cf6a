"""Action recognition: the train step, the eval step, validation and the
epoch driver, with its command line:

    python -m motionbert_tpu_torch.train.action \\
        --config configs/action/MB_train_synth_smoke.yaml -c ckpt_dir [--device cpu]

The port of ``motionbert_tpu/train/action.py`` and the root
``train_action.py`` (reference train_action.py). Flags as there (--config -c
-p -r -e -ms -sd -freq) plus --device, which defaults to the card,
--attn_impl, which defaults to the config's key, and --dist_backend. The
backbone runs through the pair kernels (bf16 on the card), the head in
fp32; cross-entropy over the logits, top-1 / top-5 accuracy; AdamW in two groups (backbone and head
learning rates) decayed per epoch (StepLR, step 1); the head's BatchNorm
statistics update in the step. Dropout masks draw from one
``torch.Generator`` on the model's device whose state the checkpoints keep.
Data parallel under ``torchrun`` as ``train.pose3d`` is: the head's
BatchNorm takes the global batch's statistics, and the backbone's unused
output head stays out of DDP's gradient reduction. Tensor parallel through
the API as ``train.pose3d`` is (``shard_params`` on a grid's model axis,
then these steps on the sharded model): the head's fc1 / fc2 on slices, its
BatchNorm on the rank's features.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from motionbert_tpu_torch.core.metrics import AverageMeter, accuracy_topk
from motionbert_tpu_torch.models.action_heads import ActionNet
from motionbert_tpu_torch.parallel.mesh import (
    add_dist_backend, barrier, check_batch_size, data_size, eval_rows,
    init_distributed, is_main, mean_over_ranks, padded_eval_batches,
    rank_batches, run_main, wrap_ddp)

# keys a JAX ActionNet's state_dict lacks (module note of models/action_heads)
JAX_MISSING_KEYS = ("backbone.head.weight", "backbone.head.bias")


def make_action_train_step(model: ActionNet, optimizer: torch.optim.Optimizer,
                           generator: Optional[torch.Generator] = None
                           ) -> Callable:
    """step(batch_input (N, M, T, J, 3), batch_gt (N,) int64) -> {"loss",
    "top1", "top5"} as 0-d fp32 tensors on the device, after one update.
    The model runs in training mode: BatchNorm on the batch's statistics,
    updating its running averages, and the dropout masks from
    ``generator``."""

    def train_step(batch_input: torch.Tensor, batch_gt: torch.Tensor) -> dict:
        model.train()
        logits = model(batch_input, generator=generator).float()
        loss = F.cross_entropy(logits, batch_gt)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            top1 = (logits.argmax(-1) == batch_gt).float().mean() * 100.0
            top5 = (logits.topk(5, -1).indices == batch_gt[:, None]).any(
                -1).float().mean() * 100.0
        return {"loss": loss.detach(), "top1": top1, "top5": top5}

    return train_step


def make_action_eval_step(model: ActionNet) -> Callable:
    """step(batch_input) -> fp32 logits, in evaluation mode (BatchNorm's
    running statistics, no dropout)."""

    @torch.inference_mode()
    def eval_step(batch_input: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(batch_input).float()

    return eval_step


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=1, keepdims=True))


def validate(test_loader, model: ActionNet) -> tuple:
    """(cross-entropy, top-1, top-5) over the validation loader (reference
    train_action.py:41-75), the rank's rows of each padded batch gathered."""
    device = next(model.parameters()).device
    eval_step = make_action_eval_step(model)
    losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
    for batch_input, batch_gt, n in padded_eval_batches(test_loader,
                                                        data_size()):
        logits = eval_rows(eval_step, batch_input, device, n).astype(
            np.float64)
        labels = np.asarray(batch_gt)
        ce = -np.take_along_axis(logits - _logsumexp(logits), labels[:, None],
                                 axis=1).mean()
        a1, a5 = accuracy_topk(logits, labels, topk=(1, 5))
        losses.update(float(ce), n)
        top1.update(a1, n)
        top5.update(a5, n)
    return losses.avg, top1.avg, top5.avg


def build_action_model(args, device=None, attn_impl: Optional[str] = None,
                       dtype: Optional[torch.dtype] = None) -> ActionNet:
    """The config's backbone (``models.factory.load_backbone``: the card by
    default, bf16 there) with the head named by ``model_version``, on the
    backbone's device, uninitialised (``init_weights`` or a state_dict)."""
    from motionbert_tpu_torch.models.factory import load_backbone

    backbone = load_backbone(args, dtype=dtype, device=device,
                             attn_impl=attn_impl)
    model = ActionNet(
        backbone=backbone, dim_rep=args.dim_rep,
        num_classes=args.get("action_classes", 60),
        dropout_ratio=args.get("dropout_ratio", 0.0),
        version=args.get("model_version", "class"),
        hidden_dim=args.get("hidden_dim", 2048), num_joints=args.num_joints)
    return model.to(next(backbone.parameters()).device)


def load_action_state(model: torch.nn.Module,
                      state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a whole task model's weights (ActionNet, MeshRegressor):
    strictly, except that a state_dict converted from the JAX package may
    lack the backbone's unused output head (``JAX_MISSING_KEYS``), which
    then keeps its values."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    if unexpected or set(missing) - set(JAX_MISSING_KEYS):
        raise RuntimeError(f"checkpoint does not fit the model: missing "
                           f"{missing}, unexpected {unexpected}")


def load_pretrained_backbone(model: torch.nn.Module,
                             state_dict: Dict[str, torch.Tensor]) -> int:
    """Copy the backbone weights of a pretrained checkpoint whose names and
    shapes match, keeping the others (reference load_pretrained_weights);
    returns the number of tensors copied."""
    own = model.backbone.state_dict()
    matched = {k: v for k, v in state_dict.items()
               if k in own and tuple(own[k].shape) == tuple(v.shape)}
    model.backbone.load_state_dict(matched, strict=False)
    return len(matched)


def restore_training(payload, optimizer, generator) -> tuple:
    """(first epoch, best metric) from a port checkpoint's payload, with the
    optimizer's state (both groups' learning rates included) and the
    generator's restored; (0, 0.0) without a payload."""
    if payload is None:
        return 0, 0.0
    if payload.get("optimizer") is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if payload.get("rng") is not None:
        generator.set_state(payload["rng"])
    return payload["epoch"], payload.get("best_metric") or 0.0


def save_epoch(ckpt_mgr, epoch: int, model, optimizer, best_metric,
               improved: bool, generator) -> None:
    """The epoch's checkpoints at the first group's learning rate, written by
    rank 0 alone; every rank waits for them."""
    if is_main():
        ckpt_mgr.save_epoch(epoch, optimizer.param_groups[0]["lr"], model,
                            optimizer, best_metric=best_metric,
                            improved=improved, rng=generator.get_state())
    barrier()


def resume_from(opts, ckpt_mgr) -> str:
    """The checkpoint to resume or evaluate: -e, else -r, else the
    directory's latest_epoch.ckpt when there is one (which also sets -r)."""
    if ckpt_mgr.has_latest() and not opts.resume and not opts.evaluate:
        opts.resume = ckpt_mgr.latest_path
    return opts.evaluate or opts.resume


def train_with_config(args, opts, device=None, attn_impl=None) -> dict:
    """The epoch driver (reference train_action.py:78-238) on ``device``
    (None: the card). opts: checkpoint, pretrained, resume, evaluate,
    selection, seed, print_freq. Resumes from the checkpoint directory's
    latest_epoch.ckpt when there is one. Returns {"top1": best top-1,
    "history": one dict per epoch run}."""
    from motionbert_tpu_torch.core.checkpoint import (
        CheckpointManager, is_port_checkpoint, load_checkpoint,
        load_state_dict)
    from motionbert_tpu_torch.core.logging import open_writer
    from motionbert_tpu_torch.data.dataset_action import NTURGBD
    from motionbert_tpu_torch.data.datasets import BatchLoader
    from motionbert_tpu_torch.train.state import (
        freeze_except, make_two_group_adamw, scale_lr)

    dev = init_distributed(device, getattr(opts, "dist_backend", None))
    check_batch_size(args.batch_size)
    os.makedirs(opts.checkpoint, exist_ok=True)
    writer = open_writer(os.path.join(opts.checkpoint, "logs"))

    model = build_action_model(args, device=dev, attn_impl=attn_impl)
    model.init_weights(torch.Generator().manual_seed(opts.seed))
    if args.get("finetune", False) and not (opts.resume or opts.evaluate):
        chk = os.path.join(opts.pretrained, opts.selection)
        print("Loading backbone", chk)
        print("load_weight", load_pretrained_backbone(model,
                                                      load_state_dict(chk)))

    data_path = args.get("data_path") or f"data/action/{args.dataset}.pkl"
    print("Loading dataset...")
    train_set = NTURGBD(data_path=data_path,
                        data_split=args.data_split + "_train",
                        n_frames=args.clip_len,
                        random_move=args.get("random_move", True),
                        scale_range=args.scale_range_train)
    val_set = NTURGBD(data_path=data_path, data_split=args.data_split + "_val",
                      n_frames=args.clip_len, random_move=False,
                      scale_range=args.scale_range_test)
    train_loader = BatchLoader(train_set, args.batch_size, shuffle=True,
                               drop_last=True, seed=opts.seed)
    test_loader = BatchLoader(val_set, args.batch_size, shuffle=False)

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
        loss, t1, t5 = validate(test_loader, model)
        print(f"Loss {loss:.4f} \tAcc@1 {t1:.3f} \tAcc@5 {t5:.3f}")
        writer.close()
        return {"top1": t1, "top5": t5, "history": []}

    if args.get("partial_train", None):
        freeze_except(model, args.partial_train, scope="backbone")
    optimizer = make_two_group_adamw(model, args.lr_backbone, args.lr_head,
                                     args.weight_decay)
    generator = torch.Generator(device=dev).manual_seed(opts.seed)
    st, best_acc = restore_training(payload, optimizer, generator)

    train_step = make_action_train_step(
        wrap_ddp(model, dev, ignore=JAX_MISSING_KEYS), optimizer, generator)
    print(f"INFO: Training on {len(train_loader)} batches")
    print_freq = int(getattr(opts, "print_freq", 100) or 100)
    history = []
    for epoch in range(st, args.epochs):
        print(f"Training epoch {epoch}.")
        train_loader.set_epoch(epoch)
        meters = {k: AverageMeter() for k in ("loss", "top1", "top5")}
        lr = optimizer.param_groups[0]["lr"]
        for idx, (batch_input, batch_gt) in enumerate(
                rank_batches(train_loader, dev)):
            m = mean_over_ranks(train_step(batch_input, batch_gt.long()))
            for k, v in m.items():
                meters[k].update(float(v), len(batch_input) * data_size())
            if (idx + 1) % print_freq == 0:
                print(f"Epoch: [{epoch}][{idx + 1}/{len(train_loader)}]\t"
                      f"Loss {meters['loss'].val:.4f} "
                      f"({meters['loss'].avg:.4f})\t"
                      f"Acc@1 {meters['top1'].avg:.2f}", flush=True)
        test_loss, test_top1, test_top5 = validate(test_loader, model)
        print(f"[{epoch + 1}] loss {meters['loss'].avg:.4f} train_top1 "
              f"{meters['top1'].avg:.2f} test_top1 {test_top1:.2f} "
              f"test_top5 {test_top5:.2f}")
        for tag, v in (("train_loss", meters["loss"].avg),
                       ("train_top1", meters["top1"].avg),
                       ("train_top5", meters["top5"].avg),
                       ("test_loss", test_loss), ("test_top1", test_top1),
                       ("test_top5", test_top5)):
            writer.add_scalar(tag, v, epoch + 1)
        history.append({"epoch": epoch, "lr": lr,
                        "lr_head": optimizer.param_groups[1]["lr"],
                        "loss": meters["loss"].avg,
                        "train_top1": meters["top1"].avg,
                        "test_loss": test_loss, "test_top1": test_top1,
                        "test_top5": test_top5})
        scale_lr(optimizer, args.lr_decay)   # StepLR, step_size 1
        improved = test_top1 > best_acc
        best_acc = max(best_acc, test_top1)
        save_epoch(ckpt_mgr, epoch, model, optimizer, best_acc, improved,
                   generator)
    writer.close()
    return {"top1": best_acc, "history": history}


def parse_args(argv=None,
               default_config="configs/action/MB_train_NTU60_xsub.yaml"
               ) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default=default_config,
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
