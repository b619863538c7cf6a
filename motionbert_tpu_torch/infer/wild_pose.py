"""In-the-wild 3D pose inference, with its command line:

    python -m motionbert_tpu_torch.infer.wild_pose \\
        --config configs/pose3d/MB_ft_h36m.yaml -e best_epoch.bin \\
        -j alphapose-results.json -o out_dir [-v video.mp4 | --vid_size W H] \\
        [--pixel] [--focus ID] [--clip_len 243] [--no_render] \\
        [--attn_impl kernel_q8] [--device cpu]

The port of ``motionbert_tpu/infer/wild_pose.py`` and the root
``infer_wild.py`` (reference infer_wild.py). AlphaPose JSON -> halpe2h36m ->
normalise -> consecutive ``clip_len`` windows -> flip-averaged DSTformer ->
root handling -> ``X3D.npy`` (optionally rescaled to pixels) and the 3D
skeleton video ``X3D.mp4`` (``viz/render.py``, at the video's frame rate),
unless ``--no_render``. ``--vid_path`` reads the source video's size and
frame rate (``infer.read_video_meta``); ``--vid_size W H`` gives the size
without a video (frame rate 30). Runs on the card unless ``--device cpu``
is given. ``--attn_impl kernel_q8`` (or ``attn_impl: pallas_q8`` in the
config) runs the W8A8 serving tier on the same checkpoint. A video that
cannot be written raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch


def run_wild_pose(args, *, json_path: str, out_path: str, model,
                  vid_size=None, fps_in: float = 30.0, pixel: bool = False,
                  focus: Optional[int] = None, clip_len: int = 243,
                  render: bool = True) -> np.ndarray:
    """The (T, 17, 3) predicted 3D motion of the detections in ``json_path``,
    also written to ``out_path``/X3D.npy, and with ``render`` drawn (before
    the pixel rescale) into ``out_path``/X3D.mp4 at ``fps_in``.

    args: the config (flip, rootrel, gt_2d, no_conf, infer_batch_size).
    model: the backbone, weights loaded, on the device to run on.
    vid_size: (w, h) of the source video; needed with ``pixel``, which keeps
    the video's scale and returns pixel coordinates. Without ``pixel`` the
    input is normalised by its own bounding square."""
    from motionbert_tpu_torch.data.dataset_wild import WildDetDataset
    from motionbert_tpu_torch.infer.batching import run_batched
    from motionbert_tpu_torch.train.pose3d import make_eval_step

    if pixel and not vid_size:
        raise ValueError("pixel=True needs vid_size (w, h): pixel-space "
                         "output needs the video's resolution")
    os.makedirs(out_path, exist_ok=True)

    if pixel:
        # keep relative scale with pixel coordinates (infer_wild.py:57-62)
        dataset = WildDetDataset(json_path, clip_len=clip_len,
                                 vid_size=vid_size, scale_range=None,
                                 focus=focus)
    else:
        dataset = WildDetDataset(json_path, clip_len=clip_len, vid_size=None,
                                 scale_range=[1, 1], focus=focus)

    # flip TTA follows the config's `flip` key (infer_wild.py:73)
    eval_step = make_eval_step(model, no_conf=args.get("no_conf", False),
                               flip_tta=args.get("flip", False))
    device = next(model.parameters()).device
    clips = [dataset[i] for i in range(len(dataset))]
    preds = run_batched(
        clips, int(args.get("infer_batch_size", 8)),
        lambda b: eval_step(torch.from_numpy(b).to(device)))
    for clip, pred in zip(clips, preds):
        if args.get("rootrel", False):
            pred[:, 0, :] = 0  # zero the root joint (infer_wild.py:81-82)
        else:
            pred[0, 0, 2] = 0  # zero frame-0 root depth (infer_wild.py:83-85)
        if args.get("gt_2d", False):  # keep detector xy (infer_wild.py:86-87)
            pred[..., :2] = clip[..., :2]
    results_all = np.concatenate(preds)

    if render:
        from motionbert_tpu_torch.viz.render import render_and_save

        render_and_save(results_all, os.path.join(out_path, "X3D.mp4"),
                        fps=fps_in)

    if pixel:
        # back to pixel coordinates (infer_wild.py:92-95)
        results_all = results_all * (min(vid_size) / 2.0)
        results_all[:, :, :2] = results_all[:, :, :2] + np.array(vid_size) / 2.0

    np.save(os.path.join(out_path, "X3D.npy"), results_all)
    return results_all


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="In-the-wild 3D pose inference: AlphaPose JSON in, "
                    "X3D.npy and the X3D.mp4 video out.")
    parser.add_argument("--config", type=str,
                        default="configs/pose3d/MB_ft_h36m_global_lite.yaml",
                        help="Path to the config file.")
    parser.add_argument("-e", "--evaluate", default="", type=str,
                        metavar="FILENAME", help="checkpoint to evaluate")
    parser.add_argument("-j", "--json_path", type=str, required=True,
                        help="alphapose detection result json path")
    parser.add_argument("-o", "--out_path", type=str, required=True,
                        help="output path")
    add_video_args(parser)
    parser.add_argument("--focus", type=int, default=None,
                        help="target person id")
    parser.add_argument("--clip_len", type=int, default=243,
                        help="clip length for network input")
    parser.add_argument("--no_render", action="store_true",
                        help="skip video rendering")
    parser.add_argument("--attn_impl", default=None,
                        help="pair implementation: kernel, plain, kernel_q8, "
                             "plain_q8, kernel_stream, kernel_stream_q8 "
                             "(default: the config's attn_impl key, "
                             "else kernel)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    return parser.parse_args(argv)


def add_video_args(parser: argparse.ArgumentParser) -> None:
    """--vid_path or --vid_size, and --pixel (the wild command lines')."""
    video = parser.add_mutually_exclusive_group()
    video.add_argument("-v", "--vid_path", type=str, default="",
                       help="the source video: its size and frame rate")
    video.add_argument("--vid_size", type=int, nargs=2, default=None,
                       metavar=("W", "H"),
                       help="width and height of the source video, without "
                            "it (frame rate 30)")
    parser.add_argument("--pixel", action="store_true",
                        help="align with pixel coordinates (needs --vid_path "
                             "or --vid_size)")


def video_meta(opts) -> tuple:
    """(fps, (w, h) or None) from --vid_path or --vid_size; exits when
    --pixel has neither."""
    from motionbert_tpu_torch.infer import read_video_meta

    if opts.pixel and not (opts.vid_path or opts.vid_size):
        raise SystemExit("--pixel requires --vid_path or --vid_size W H "
                         "(pixel-space output needs the video resolution)")
    if opts.vid_path:
        return read_video_meta(opts.vid_path)
    return 30.0, tuple(opts.vid_size) if opts.vid_size else None


def main(argv=None) -> np.ndarray:
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.models.factory import load_backbone

    opts = parse_args(argv)
    fps_in, vid_size = video_meta(opts)
    args = get_config(opts.config)
    model = load_backbone(args, device=opts.device, attn_impl=opts.attn_impl)
    if opts.evaluate:
        model.load_state_dict(load_state_dict(opts.evaluate), strict=True)
    else:
        print("WARNING: no checkpoint given (-e); using random init")
        model.init_weights(torch.Generator().manual_seed(0))
    results = run_wild_pose(
        args, json_path=opts.json_path, out_path=opts.out_path, model=model,
        vid_size=vid_size, fps_in=fps_in, pixel=opts.pixel, focus=opts.focus,
        clip_len=opts.clip_len, render=not opts.no_render)
    print("saved", os.path.join(opts.out_path, "X3D.npy"),
          "shape", results.shape)
    return results


if __name__ == "__main__":
    main()
