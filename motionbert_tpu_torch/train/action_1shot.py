"""One-shot action recognition: SupCon training on the NTU120 auxiliary
classes, 1-NN cosine evaluation against one exemplar per held-out class,
with its command line:

    python -m motionbert_tpu_torch.train.action_1shot \\
        --config configs/action/MB_train_NTU120_oneshot.yaml -c ckpt_dir [--device cpu]

The port of ``motionbert_tpu/train/action_1shot.py`` and the root
``train_action_1shot.py`` (reference train_action_1shot.py). The model is an
ActionNet with the embed head; each batch holds ``n_views`` clips of each of
``batch_size // n_views`` classes (``MPerClassSampler``); the loss is
``supcon_loss`` over the embeddings reshaped (batch, -1, hidden_dim), with
base temperature 0.07. Flags as in ``train.action``. Data parallel under
``torchrun`` as ``train.pose3d`` is, the loss over the global batch's
embeddings.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from motionbert_tpu_torch.losses.supcon import supcon_loss
from motionbert_tpu_torch.models.action_heads import ActionNet
from motionbert_tpu_torch.parallel.mesh import (
    check_batch_size, data_size, eval_rows, gather_rows, init_distributed,
    padded_eval_batches, rank_batches, run_main, wrap_ddp)


def make_supcon_train_step(model: ActionNet, optimizer: torch.optim.Optimizer,
                           hidden_dim: int, temperature: float,
                           generator: Optional[torch.Generator] = None
                           ) -> Callable:
    """step(batch_input (N, M, T, J, 3), batch_gt (N,)) -> the SupCon loss,
    a 0-d fp32 tensor on the device, after one update. Each embedding is its
    own anchor with a single view (reference train_action_1shot.py:193); the
    positives come from the labels, and the loss scale is temperature / 0.07
    (the reference trainer passes only the temperature). Under data
    parallelism each rank embeds its rows and the loss compares the global
    batch's embeddings, gathered with their gradient
    (``parallel.mesh.gather_rows``): every rank computes the same loss, and
    DDP's average of the gradients is the one-process gradient. On a grid
    with a model axis the head has gathered its embedding's slices over the
    model ranks already, and ``gather_rows`` gathers over the data ranks."""

    def train_step(batch_input: torch.Tensor,
                   batch_gt: torch.Tensor) -> torch.Tensor:
        model.train()
        feat = gather_rows(model(batch_input, generator=generator))
        labels = gather_rows(batch_gt)
        feat = feat.reshape(labels.shape[0], -1, hidden_dim)
        loss = supcon_loss(feat, labels=labels, temperature=temperature,
                           base_temperature=0.07)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def extract_feats(loader, model: ActionNet) -> tuple:
    """(embeddings (n, hidden), labels (n,)) over a loader, in evaluation
    mode, as numpy; the rank's rows of each padded batch gathered."""
    device = next(model.parameters()).device
    model.eval()
    feats, gts = [], []
    with torch.inference_mode():
        for batch_input, batch_gt, n in padded_eval_batches(loader,
                                                            data_size()):
            feats.append(eval_rows(lambda x: model(x).float(), batch_input,
                                   device, n))
            gts.append(np.asarray(batch_gt))
    return np.concatenate(feats), np.concatenate(gts)


def validate_1shot(anchor_loader, test_loader, model: ActionNet) -> float:
    """1-NN cosine matching of the test embeddings against the anchors'
    (reference train_action_1shot.py:58-69): the share of test clips whose
    nearest anchor has their label."""
    train_feats, train_labels = extract_feats(anchor_loader, model)
    test_feats, test_labels = extract_feats(test_loader, model)

    def unit(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    sim = unit(train_feats) @ unit(test_feats).T      # (anchors, tests)
    pred = train_labels[sim.argmax(axis=0)]
    return float((pred == test_labels).mean())


def train_with_config(args, opts, device=None, attn_impl=None) -> dict:
    """The one-shot epoch driver on ``device`` (None: the card): data from
    ``data_path`` (training, every class but the held-out ones) and
    ``data_path_1shot`` (its oneshot_train anchors and oneshot_val tests).
    Resumes from the checkpoint directory's latest_epoch.ckpt when there is
    one. Returns {"acc": best 1-NN accuracy, "history": one dict per
    epoch run}."""
    from motionbert_tpu_torch.core.checkpoint import (
        CheckpointManager, is_port_checkpoint, load_checkpoint,
        load_state_dict)
    from motionbert_tpu_torch.core.logging import open_writer
    from motionbert_tpu_torch.core.metrics import AverageMeter
    from motionbert_tpu_torch.data.dataset_action import (
        MPerClassSampler, NTURGBD, NTURGBD1Shot)
    from motionbert_tpu_torch.data.datasets import BatchLoader
    from motionbert_tpu_torch.train.action import (
        JAX_MISSING_KEYS, build_action_model, load_action_state,
        load_pretrained_backbone, restore_training, resume_from, save_epoch)
    from motionbert_tpu_torch.train.state import (
        freeze_except, make_two_group_adamw, scale_lr)

    dev = init_distributed(device, getattr(opts, "dist_backend", None))
    check_batch_size(args.batch_size)
    os.makedirs(opts.checkpoint, exist_ok=True)
    writer = open_writer(os.path.join(opts.checkpoint, "logs"))

    args.model_version = "embed"
    model = build_action_model(args, device=dev, attn_impl=attn_impl)
    model.init_weights(torch.Generator().manual_seed(opts.seed))
    fresh_finetune = args.get("finetune", False) and not (
        opts.resume or opts.evaluate)
    if fresh_finetune:
        chk = os.path.join(opts.pretrained, opts.selection)
        print("Loading backbone", chk)
        print("load_weight", load_pretrained_backbone(model,
                                                      load_state_dict(chk)))

    oneshot_path = args.get("data_path_1shot",
                            "data/action/ntu120_hrnet_oneshot.pkl")
    anchor_set = NTURGBD(data_path=oneshot_path, data_split="oneshot_train",
                         n_frames=args.clip_len, random_move=False,
                         scale_range=args.scale_range_test)
    test_set = NTURGBD(data_path=oneshot_path, data_split="oneshot_val",
                       n_frames=args.clip_len, random_move=False,
                       scale_range=args.scale_range_test)
    anchor_loader = BatchLoader(anchor_set, args.batch_size)
    test_loader = BatchLoader(test_set, args.batch_size)

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
        acc = validate_1shot(anchor_loader, test_loader, model)
        print("one-shot 1-NN acc:", acc)
        writer.close()
        return {"acc": acc, "history": []}

    train_set = NTURGBD1Shot(
        data_path=args.get("data_path", "data/action/ntu120_hrnet.pkl"),
        data_split="", n_frames=args.clip_len,
        random_move=args.get("random_move", True),
        scale_range=args.scale_range_train, check_split=False)
    sampler = MPerClassSampler(train_set.labels, m=args.n_views,
                               batch_size=args.batch_size,
                               length=len(train_set))
    train_loader = BatchLoader(train_set, args.batch_size, sampler=sampler,
                               drop_last=True)

    # the reference freezes only on a fresh finetune, and within the
    # backbone (train_action_1shot.py:92-93)
    if args.get("partial_train", None) and fresh_finetune:
        freeze_except(model, args.partial_train, scope="backbone")
    optimizer = make_two_group_adamw(model, args.lr_backbone, args.lr_head,
                                     args.weight_decay)
    generator = torch.Generator(device=dev).manual_seed(opts.seed)
    st, best_acc = restore_training(payload, optimizer, generator)

    train_step = make_supcon_train_step(
        wrap_ddp(model, dev, ignore=JAX_MISSING_KEYS), optimizer,
        args.get("hidden_dim", 2048), args.get("temp", 0.1), generator)
    print(f"INFO: Training on {len(train_loader)} batches")
    print_freq = int(getattr(opts, "print_freq", 100) or 100)
    history = []
    for epoch in range(st, args.epochs):
        print(f"Training epoch {epoch}.")
        train_loader.set_epoch(epoch)
        losses = AverageMeter()
        lr = optimizer.param_groups[0]["lr"]
        for idx, (batch_input, batch_gt) in enumerate(
                rank_batches(train_loader, dev)):
            loss = train_step(batch_input, batch_gt.long())
            losses.update(float(loss), len(batch_input) * data_size())
            if (idx + 1) % print_freq == 0:
                print(f"Epoch: [{epoch}][{idx + 1}/{len(train_loader)}]\t"
                      f"Loss {losses.val:.4f} ({losses.avg:.4f})", flush=True)
        acc = validate_1shot(anchor_loader, test_loader, model)
        print(f"[{epoch + 1}] supcon {losses.avg:.4f} 1nn_acc {acc:.4f}")
        writer.add_scalar("train_loss_supcon", losses.avg, epoch + 1)
        writer.add_scalar("test_top1", acc, epoch + 1)
        history.append({"epoch": epoch, "lr": lr, "loss": losses.avg,
                        "acc": acc})
        scale_lr(optimizer, args.lr_decay)
        improved = acc > best_acc
        best_acc = max(best_acc, acc)
        save_epoch(ckpt_mgr, epoch, model, optimizer, best_acc, improved,
                   generator)
    writer.close()
    return {"acc": best_acc, "history": history}


def main(argv=None) -> dict:
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.train.action import parse_args

    opts = parse_args(
        argv, default_config="configs/action/MB_train_NTU120_oneshot.yaml")
    return run_main(train_with_config, opts, get_config(opts.config))


if __name__ == "__main__":
    main()
