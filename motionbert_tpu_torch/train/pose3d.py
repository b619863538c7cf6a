"""Pose3D and pretraining task: the train step, the flip-averaged eval step,
the H36M evaluation protocol and the epoch driver, with its command line:

    python -m motionbert_tpu_torch.train.pose3d \\
        --config configs/pose3d/MB_train_synth_smoke.yaml -c ckpt_dir [--device cpu]
    python -m motionbert_tpu_torch.train.pose3d \\
        --config configs/pretrain/MB_pretrain_synth_smoke.yaml -c ckpt_dir [--device cpu]

The port of ``motionbert_tpu/train/pose3d.py`` and the root ``train.py``
(reference train.py). Flags as there (--config -c -p -r -e -ms -sd) plus
--device, which defaults to the card, --attn_impl, which defaults to the
config's key, and --dist_backend. Batch conditioning (root-relative
targets, the confidence split), the random horizontal flip, the 2D
corruption of pretraining (``data/augment.py``: ``noise``, ``mask_ratio``, ``mask_T_ratio``) and the
model's dropout and drop-path masks all run on the device inside the step
and draw, in that order, from one ``torch.Generator`` on the model's device
whose state the checkpoints keep, so a resumed run draws what the
uninterrupted run would have. With ``train_2d`` the 2D datasets (PoseTrack,
InstaVariety) join from epoch ``pretrain_3d_curriculum`` on, each as an epoch
of its own before the 3D epoch, trained with the confidence-weighted 2D loss.

Data parallel under ``torchrun`` (``parallel/mesh.py``), one process per card:

    torchrun --nproc_per_node N -m motionbert_tpu_torch.train.pose3d \\
        --config configs/pose3d/MB_train_h36m.yaml -c ckpt_dir \\
        [--dist_backend gloo]

Every rank builds the same seeded loaders and trains on its rows of each
global batch (``batch_size`` must divide over the ranks) through
``DistributedDataParallel``; the random draws are the global batch's, so a
run at any world size computes what one process computes, and its
checkpoints resume at any world size. Evaluation pads the tail batch, runs
the rank's rows and gathers the predictions. Rank 0 alone writes logs and
checkpoints.

Tensor parallel through the API, as in the JAX package, whose trainers all
take ``make_mesh()`` with ``n_model`` 1: on a grid from
``parallel.mesh.make_mesh(n_data, n_model)``, ``shard_params(model, mesh)``
leaves each model rank its shards, and ``make_train_step`` (on the model
wrapped by ``wrap_ddp``, over the data group) and ``make_eval_step`` run on
the sharded model as they are; the batches go by data rank
(``rank_rows``). ``CheckpointManager.save_epoch`` gathers the shards.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from motionbert_tpu_torch.core.profiling import annotate
from motionbert_tpu_torch.data.augment import NoiseParams, augment2d
from motionbert_tpu_torch.geometry.procrustes import mpjpe, p_mpjpe
from motionbert_tpu_torch.geometry.skeleton import flip_data
from motionbert_tpu_torch.losses.pose import (
    LAMBDA_KEYS, loss_2d_weighted, pose3d_total_loss)
from motionbert_tpu_torch.models.dstformer import uniform
from motionbert_tpu_torch.parallel.mesh import (
    add_dist_backend, barrier, check_batch_size, eval_rows, init_distributed,
    is_main, mean_over_ranks, padded_eval_batches, rank_batches, rank_draw,
    data_size, run_main, wrap_ddp)

# H36M test videos excluded from evaluation (reference train.py:109-111)
BLOCK_LIST = ("s_09_act_05_subact_02", "s_09_act_10_subact_02",
              "s_09_act_13_subact_01")


def preprocess_batch(batch_input: torch.Tensor, batch_gt: torch.Tensor, *,
                     rootrel: bool, no_conf: bool,
                     has_3d: bool = True) -> tuple:
    """Input and target conditioning (reference train.py:163-170): drop the
    confidence channel with no_conf; root-relative targets with rootrel,
    else the first frame's root depth is zeroed across the clip. Returns
    (input, target, conf): 2D data (has_3d False) carries its confidence in
    the target's last channel, conf (B, F, J, 1); else conf is None."""
    if no_conf:
        batch_input = batch_input[..., :2]
    conf = None if has_3d else batch_gt[..., 2:]
    if rootrel:
        batch_gt = batch_gt - batch_gt[:, :, 0:1, :]
    else:
        anchor = batch_gt[:, 0:1, 0:1, 2:3]
        batch_gt = torch.cat([batch_gt[..., :2], batch_gt[..., 2:3] - anchor],
                             dim=-1)
    return batch_input, batch_gt, conf


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    lambdas: dict, *, rootrel: bool, no_conf: bool,
                    use_mask: bool = False, use_noise: bool = False,
                    noise_params: Optional[NoiseParams] = None,
                    mask_ratio: float = 0.0, mask_T_ratio: float = 0.0,
                    flip_aug: bool = False,
                    generator: torch.Generator = None) -> Callable:
    """step(batch_input (B, F, J, 3), batch_gt (B, F, J, 3), has_3d=True,
    has_gt=True) -> the loss terms as 0-d fp32 tensors on the device, after
    one AdamW update. has_3d False: 2D data, trained with the
    confidence-weighted 2D loss (term "2d_proj"). With flip_aug each clip and
    its label are mirrored together with probability 1/2; with use_noise
    (only where has_gt) and use_mask the input goes through ``augment2d``;
    the model runs in training mode and draws its dropout and drop-path
    masks. All of these draw from ``generator`` (on the batches' device),
    which is needed when any of them is live."""
    if (flip_aug or use_mask or use_noise) and generator is None:
        raise ValueError("flip_aug, use_mask and use_noise need a generator")
    if use_noise and noise_params is None:
        raise ValueError("use_noise needs noise_params")
    lambdas = {k: float(lambdas.get(k, 0.0)) for k in LAMBDA_KEYS}

    def forward(batch_input, batch_gt, has_3d, has_gt):
        model.train()
        if flip_aug:
            do = rank_draw(uniform, (batch_input.shape[0], 1, 1, 1),
                           generator) < 0.5
            batch_input = torch.where(do, flip_data(batch_input), batch_input)
            batch_gt = torch.where(do, flip_data(batch_gt), batch_gt)
        batch_input, batch_gt, conf = preprocess_batch(
            batch_input, batch_gt, rootrel=rootrel, no_conf=no_conf,
            has_3d=has_3d)
        if use_mask or use_noise:
            batch_input = augment2d(
                generator, batch_input, noise_params,
                noise=use_noise and has_gt, mask=use_mask,
                mask_ratio=mask_ratio, mask_T_ratio=mask_T_ratio)
        pred = model(batch_input, generator=generator).float()
        if has_3d:
            return pose3d_total_loss(pred, batch_gt.float(), lambdas)
        total = loss_2d_weighted(pred, batch_gt.float(), conf.float())
        return total, {"2d_proj": total, "total": total}

    def train_step(batch_input: torch.Tensor, batch_gt: torch.Tensor,
                   has_3d: bool = True, has_gt: bool = True) -> dict:
        with annotate("train.step", device=True):
            with annotate("train.forward", device=True):
                total, terms = forward(batch_input, batch_gt, has_3d, has_gt)
            with annotate("train.backward", device=True):
                optimizer.zero_grad(set_to_none=True)
                total.backward()
            with annotate("train.optimizer", device=True):
                optimizer.step()
        return {k: v.detach() for k, v in terms.items()}

    return train_step


def make_eval_step(model: torch.nn.Module, *, no_conf: bool,
                   flip_tta: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """step(batch_input (B, F, J, 3)) -> fp32 prediction (B, F, J, 3). With
    flip_tta the clip is also run mirrored, as a second forward, and the two
    are averaged in fp32: (pred + flip(pred_flip)) / 2 (reference
    train.py:66-72)."""

    @torch.inference_mode()
    def eval_step(batch_input: torch.Tensor) -> torch.Tensor:
        if no_conf:
            batch_input = batch_input[..., :2]
        pred = model(batch_input).float()
        if flip_tta:
            pred_flip = model(flip_data(batch_input)).float()
            pred = (pred + flip_data(pred_flip)) / 2
        return pred

    return eval_step


def evaluate(args, model: torch.nn.Module, test_loader, datareader,
             return_results: bool = False):
    """The H36M protocol (reference train.py:56-153): flip-TTA inference over
    the test loader (the rank's rows of each padded batch, gathered), then
    ``evaluate_predictions``. Returns (e1, e2, results_all[, per_action])."""
    model.eval()
    device = next(model.parameters()).device
    eval_step = make_eval_step(model, no_conf=args.get("no_conf", False),
                               flip_tta=args.get("flip", False))
    results_all = []
    for batch_input, _, n in padded_eval_batches(test_loader, data_size()):
        pred = eval_rows(eval_step, batch_input, device, n)
        if args.get("rootrel", False):
            pred[:, :, 0, :] = 0
        if args.get("gt_2d", False):
            pred[..., :2] = batch_input[:n, ..., :2]
        results_all.append(pred)
    results_all = np.concatenate(results_all)
    e1, e2, per_action = evaluate_predictions(results_all, datareader)
    if return_results:
        return e1, e2, results_all, per_action
    return e1, e2, results_all


def evaluate_predictions(results_all, datareader):
    """Score normalised per-clip predictions with the H36M protocol:
    denormalise to pixels, scale each clip by its 2.5d factor, make it
    root-relative, accumulate per-frame P1 (MPJPE) and P2 (P-MPJPE) errors
    over overlapping clips, and average per action. Returns (e1, e2,
    {action: (p1, p2)})."""
    results_all = datareader.denormalize(results_all)
    _, split_id_test = datareader.get_split_id()
    test = datareader.dt_dataset["test"]
    actions = np.array(test["action"])
    factors = np.array(test["2.5d_factor"])
    gts = np.array(test["joints_2.5d_image"])
    sources = np.array(test["source"])

    num_test_frames = len(actions)
    frames = np.arange(num_test_frames)
    action_clips = actions[split_id_test]
    factor_clips = factors[split_id_test]
    source_clips = sources[split_id_test]
    frame_clips = frames[split_id_test]
    gt_clips = gts[split_id_test]
    assert len(results_all) == len(action_clips)

    e1_all = np.zeros(num_test_frames)
    e2_all = np.zeros(num_test_frames)
    oc = np.zeros(num_test_frames)
    action_names = sorted(set(test["action"]))
    results = {a: [] for a in action_names}
    results_procrustes = {a: [] for a in action_names}
    for idx in range(len(action_clips)):
        if source_clips[idx][0][:-6] in BLOCK_LIST:
            continue
        frame_list = frame_clips[idx]
        factor = factor_clips[idx][:, None, None]
        gt = gt_clips[idx]
        pred = results_all[idx] * factor
        pred = pred - pred[:, 0:1, :]
        gt = gt - gt[:, 0:1, :]
        e1_all[frame_list] += mpjpe(pred, gt)
        e2_all[frame_list] += p_mpjpe(pred, gt)
        oc[frame_list] += 1

    for idx in np.nonzero(e1_all > 0)[0]:
        results[actions[idx]].append(e1_all[idx] / oc[idx])
        results_procrustes[actions[idx]].append(e2_all[idx] / oc[idx])
    final = [np.mean(results[a]) for a in action_names]
    final_procrustes = [np.mean(results_procrustes[a]) for a in action_names]
    per_action = {a: (float(p1), float(p2)) for a, p1, p2 in
                  zip(action_names, final, final_procrustes)}
    return float(np.mean(final)), float(np.mean(final_procrustes)), per_action


def _print_eval_table(per_action, e1, e2):
    names = list(per_action)
    w = max([len(n) for n in names] + [8])
    print(" ".join(["test_name".ljust(w)] + [n.ljust(w) for n in names]))
    print(" ".join(["P1".ljust(w)] +
                   [f"{per_action[n][0]:.2f}".ljust(w) for n in names]))
    print(" ".join(["P2".ljust(w)] +
                   [f"{per_action[n][1]:.2f}".ljust(w) for n in names]))
    print("Protocol #1 Error (MPJPE):", e1, "mm")
    print("Protocol #2 Error (P-MPJPE):", e2, "mm")
    print("----------")


def build_dataset_3d(args, split: str):
    """The split's clips: the packed native clip store
    ``<data_root>/<subset>/<split>.mbcs`` when there is one subset and the
    file exists (``data/clipstore.py``, one gather per batch), else the
    per-clip pickles (``MotionDataset3D``), as the JAX driver chooses."""
    from motionbert_tpu_torch.data.datasets import MotionDataset3D

    if len(args.subset_list) == 1:
        packed = os.path.join(args.data_root, args.subset_list[0],
                              f"{split}.mbcs")
        if os.path.exists(packed):
            from motionbert_tpu_torch.data.clipstore import ClipStoreDataset3D

            print(f"INFO: using native clip store {packed}")
            return ClipStoreDataset3D(
                packed, synthetic=args.get("synthetic", False),
                gt_2d=args.get("gt_2d", False),
                scale_range_pretrain=args.get("scale_range_pretrain"),
                data_split=split)
    return MotionDataset3D(args, args.subset_list, split)


def train_with_config(args, opts, device=None, attn_impl=None) -> dict:
    """The epoch driver (reference train.py:208-377) on ``device`` (None:
    the card, ``cuda:LOCAL_RANK`` under torchrun). opts: checkpoint,
    pretrained, resume, evaluate, selection, seed, and optionally
    dist_backend. attn_impl None takes the config's ``attn_impl`` key
    (``models.factory``). Resumes from the checkpoint directory's
    latest_epoch.ckpt when there is one. Data parallel over the process
    group (``parallel.mesh.init_distributed``). Returns {"e1": best P1,
    "history": one dict per epoch run (epoch, lr, mean loss terms of the
    global batches, e1, e2, the 3D steps, the host seconds of the epoch's
    training, and on the card the mean device ms of its train steps,
    between CUDA events; None on the CPU)}."""
    from motionbert_tpu_torch.core.checkpoint import (
        CheckpointManager, is_port_checkpoint, load_checkpoint,
        load_state_dict)
    from motionbert_tpu_torch.core.logging import open_writer
    from motionbert_tpu_torch.core.metrics import AverageMeter
    from motionbert_tpu_torch.data.datasets import (
        BatchLoader, InstaVDataset2D, PoseTrackDataset2D)
    from motionbert_tpu_torch.data.readers import DataReaderH36M
    from motionbert_tpu_torch.models.factory import load_backbone
    from motionbert_tpu_torch.train.state import (
        freeze_except, make_adamw, scale_lr, set_lr)

    dev = init_distributed(device, getattr(opts, "dist_backend", None))
    check_batch_size(args.batch_size)
    os.makedirs(opts.checkpoint, exist_ok=True)
    writer = open_writer(os.path.join(opts.checkpoint, "logs"))

    print("Loading dataset...")
    train_dataset = build_dataset_3d(args, "train")
    test_dataset = build_dataset_3d(args, "test")
    train_loader = BatchLoader(train_dataset, args.batch_size, shuffle=True,
                               drop_last=True, seed=opts.seed)
    test_loader = BatchLoader(test_dataset, args.batch_size, shuffle=False)

    # (name, loader, has_gt): PoseTrack is annotated by hand, so the noise
    # corruption applies to it; InstaVariety is detector output already
    loaders_2d = []
    if args.get("train_2d", False):
        specs = [
            (PoseTrackDataset2D,
             args.get("posetrack_root",
                      "data/motion2d/posetrack18_annotations/train/"), True),
            (InstaVDataset2D,
             args.get("instav_root", "data/motion2d/InstaVariety"), False)]
        for ds_cls, data_root, has_gt in specs:
            try:
                loader = BatchLoader(ds_cls(data_root=data_root),
                                     args.batch_size, shuffle=True,
                                     drop_last=True, seed=opts.seed)
            except FileNotFoundError as e:
                print(f"WARNING: 2D dataset {ds_cls.__name__} unavailable "
                      f"({e}); skipping")
                continue
            loaders_2d.append((ds_cls.__name__, loader, has_gt))

    datareader = DataReaderH36M(
        n_frames=args.clip_len, sample_stride=args.sample_stride,
        data_stride_train=args.data_stride, data_stride_test=args.clip_len,
        dt_root=args.get("dt_root", "data/motion3d"), dt_file=args.dt_file)

    model = load_backbone(args, device=dev, attn_impl=attn_impl)
    model.init_weights(torch.Generator().manual_seed(opts.seed))
    print("INFO: Trainable parameter count:",
          sum(p.numel() for p in model.parameters()))

    ckpt_mgr = CheckpointManager(opts.checkpoint,
                                 args.get("checkpoint_frequency", 1))
    min_loss = 1e5
    lr = args.learning_rate
    st = 0
    resume_payload = None
    if args.get("finetune", False):
        chk = opts.evaluate or opts.resume or os.path.join(
            opts.pretrained, opts.selection)
        resume = bool(opts.resume)
    else:
        if ckpt_mgr.has_latest() and not opts.resume and not opts.evaluate:
            opts.resume = ckpt_mgr.latest_path
        chk = opts.evaluate or opts.resume
        resume = True
    if chk:
        print("Loading checkpoint", chk)
        model.load_state_dict(load_state_dict(chk), strict=True)
        if resume and not opts.evaluate and is_port_checkpoint(chk):
            resume_payload = load_checkpoint(chk)

    if opts.evaluate:
        e1, e2, _, per_action = evaluate(args, model, test_loader, datareader,
                                         return_results=True)
        _print_eval_table(per_action, e1, e2)
        writer.close()
        return {"e1": e1, "e2": e2, "history": []}

    params = model.parameters()
    if args.get("partial_train", None):
        params = freeze_except(model, args.partial_train)
    optimizer = make_adamw(params, lr, args.weight_decay)
    generator = torch.Generator(device=dev).manual_seed(opts.seed)
    if resume_payload is not None:
        st = resume_payload["epoch"]
        if resume_payload.get("optimizer") is not None:
            optimizer.load_state_dict(resume_payload["optimizer"])
        lr = resume_payload.get("lr", lr)
        if resume_payload.get("best_metric") is not None:
            min_loss = resume_payload["best_metric"]
        if resume_payload.get("rng") is not None:
            generator.set_state(resume_payload["rng"])
    set_lr(optimizer, lr)

    use_mask = args.get("mask_ratio", 0) > 0 and args.get("mask_T_ratio", 0) > 0
    use_noise = bool(args.get("noise", False))
    noise_params = None
    if use_mask or use_noise:
        noise_params = NoiseParams.load(
            args.get("noise_path", "params/synthetic_noise.npz"),
            args.get("d2c_params_path", "params/d2c_params.pkl"))
    train_step = make_train_step(
        wrap_ddp(model, dev), optimizer,
        {k: args.get(k, 0.0) for k in LAMBDA_KEYS},
        rootrel=args.get("rootrel", False), no_conf=args.get("no_conf", False),
        use_mask=use_mask, use_noise=use_noise, noise_params=noise_params,
        mask_ratio=args.get("mask_ratio", 0.0),
        mask_T_ratio=args.get("mask_T_ratio", 0.0),
        flip_aug=bool(args.get("flip", False)), generator=generator)

    def run_epoch(loader, losses, has_3d, has_gt, events):
        for batch_input, batch_gt in rank_batches(loader, dev):
            if dev.type == "cuda":
                events.append([torch.cuda.Event(enable_timing=True)
                               for _ in range(2)])
                events[-1][0].record()
            terms = train_step(batch_input, batch_gt, has_3d=has_3d,
                               has_gt=has_gt)
            if dev.type == "cuda":
                events[-1][1].record()
            for k, v in mean_over_ranks(terms).items():
                losses.setdefault(k, AverageMeter()).update(
                    float(v), len(batch_input) * data_size())

    history = []
    for epoch in range(st, args.epochs):
        print(f"Training epoch {epoch}.")
        start = time.time()
        losses: dict = {}
        events: list = []
        train_loader.set_epoch(epoch)
        # curriculum: the 2D datasets join after pretrain_3d_curriculum epochs
        if loaders_2d and epoch >= args.get("pretrain_3d_curriculum", 0):
            for _, loader_2d, has_gt in loaders_2d:
                loader_2d.set_epoch(epoch)
                run_epoch(loader_2d, losses, has_3d=False, has_gt=has_gt,
                          events=events)
        run_epoch(train_loader, losses, has_3d=True, has_gt=True,
                  events=events)
        elapsed = (time.time() - start) / 60.0
        step_ms = None
        if events:
            torch.cuda.synchronize(dev)
            step_ms = float(np.mean([a.elapsed_time(b) for a, b in events]))
        record = {"epoch": epoch, "lr": lr,
                  "losses": {k: m.avg for k, m in losses.items()},
                  "e1": None, "e2": None,
                  "steps": losses["3d_pos"].count // args.batch_size,
                  "train_s": elapsed * 60.0, "step_ms": step_ms}
        if args.get("no_eval", False):
            print(f"[{epoch + 1}] time {elapsed:.2f} lr {lr:f} "
                  f"3d_train {losses['3d_pos'].avg:f}")
            improved = False
        else:
            e1, e2, _, per_action = evaluate(
                args, model, test_loader, datareader, return_results=True)
            _print_eval_table(per_action, e1, e2)
            print(f"[{epoch + 1}] time {elapsed:.2f} lr {lr:f} "
                  f"3d_train {losses['3d_pos'].avg:f} e1 {e1:f} e2 {e2:f}")
            writer.add_scalar("Error P1", e1, epoch + 1)
            writer.add_scalar("Error P2", e2, epoch + 1)
            improved = e1 < min_loss
            min_loss = min(e1, min_loss)
            record.update(e1=e1, e2=e2)
        for k, meter in losses.items():
            writer.add_scalar(f"loss_{k}", meter.avg, epoch + 1)
        history.append(record)

        # exponential per-epoch decay (reference train.py:359-362)
        lr *= args.lr_decay
        scale_lr(optimizer, args.lr_decay)
        if is_main():
            ckpt_mgr.save_epoch(epoch, lr, model, optimizer,
                                best_metric=min_loss, improved=improved,
                                rng=generator.get_state())
        barrier()
    writer.close()
    return {"e1": min_loss, "history": history}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str,
                        default="configs/pretrain/MB_pretrain.yaml",
                        help="Path to the config file.")
    parser.add_argument("-c", "--checkpoint", default="checkpoint", type=str,
                        metavar="PATH", help="checkpoint directory")
    parser.add_argument("-p", "--pretrained", default="checkpoint", type=str,
                        metavar="PATH", help="pretrained checkpoint directory")
    parser.add_argument("-r", "--resume", default="", type=str,
                        metavar="FILENAME", help="checkpoint to resume")
    parser.add_argument("-e", "--evaluate", default="", type=str,
                        metavar="FILENAME", help="checkpoint to evaluate")
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
