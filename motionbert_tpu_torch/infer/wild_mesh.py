"""In-the-wild human mesh recovery, with its command line:

    python -m motionbert_tpu_torch.infer.wild_mesh \\
        --config configs/mesh/MB_ft_pw3d.yaml -e best_epoch.bin \\
        -j alphapose-results.json -o out_dir [-v video.mp4 | --vid_size W H] \\
        [--pixel] [--focus ID] [--clip_len 243] [--no_render] \\
        [--ref_3d_motion_path X3D.npy] [--attn_impl pallas_stream] [--device cpu]

The port of ``motionbert_tpu/infer/wild_mesh.py`` and the root
``infer_wild_mesh.py`` (reference infer_wild_mesh.py). AlphaPose JSON ->
halpe2h36m -> normalise -> consecutive ``clip_len`` windows ->
MeshRegressor with flip averaging in SMPL theta space (the mesh eval step)
-> optionally the global trajectory: a scale fitted by grid search and
least squares (scipy) between the regressed joints and a reference 3D
motion, which places each frame's root -> ``mesh_verts.npy`` (T, V, 3), mm,
and the mesh video ``mesh.mp4`` (``viz/render.py``'s ``motion2video_mesh``
over the body model's faces, at the video's frame rate) unless
``--no_render``. ``--vid_path`` / ``--vid_size`` as in ``infer.wild_pose``.
Runs on the card unless ``--device cpu`` is given. A video that cannot be
written raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from motionbert_tpu_torch.infer.wild_pose import add_video_args, video_meta


def err(p, x, y) -> float:
    """Mean distance between scale p[0] times x plus offset p[1:] and y."""
    return np.linalg.norm(p[0] * x + np.array([p[1], p[2], p[3]]) - y,
                          axis=-1).mean()


def solve_scale(x: np.ndarray, y: np.ndarray) -> float:
    """The scale that aligns x to y best, from least-squares fits of scale
    and offset started at 0, 5, ..., 1995 (reference
    infer_wild_mesh.py:45-56)."""
    from scipy.optimize import least_squares

    print("Estimating camera transformation.")
    best_res, best_scale = 1e5, None
    for init_scale in range(0, 2000, 5):
        est = least_squares(err, [init_scale, 0.0, 0.0, 0.0],
                            args=(x.reshape(-1, 3), y.reshape(-1, 3)))
        res = float(est["fun"][0])
        if res < best_res:
            best_res, best_scale = res, est["x"][0]
    print("Pose matching error = %.2f mm." % best_res)
    return best_scale


def run_wild_mesh(args, *, json_path: str, out_path: str, model,
                  vid_size=None, fps_in: float = 30.0, pixel: bool = False,
                  focus: Optional[int] = None, clip_len: int = 243,
                  ref_3d_motion_path: Optional[str] = None,
                  render: bool = True) -> tuple:
    """(vertices (T, V, 3), regressed H36M joints (T, 17, 3)) of the
    detections in ``json_path``, in mm, the vertices also written to
    ``out_path``/mesh_verts.npy and with ``render`` drawn into
    ``out_path``/mesh.mp4 at ``fps_in``.

    args: the config (infer_batch_size). model: the MeshRegressor, weights
    loaded, on the device to run on. vid_size: (w, h) of the source video;
    needed with ``pixel``. ref_3d_motion_path: an (T, 17, 3) 3D motion
    (``X3D.npy`` of the wild pose CLI) whose root trajectory, scaled to the
    mesh, places the vertices."""
    from motionbert_tpu_torch.data.dataset_wild import WildDetDataset
    from motionbert_tpu_torch.infer.batching import run_batched
    from motionbert_tpu_torch.train.mesh import make_mesh_eval_step

    if pixel and not vid_size:
        raise ValueError("pixel=True needs vid_size (w, h): pixel-space "
                         "input needs the video's resolution")
    os.makedirs(out_path, exist_ok=True)
    if pixel:
        dataset = WildDetDataset(json_path, clip_len=clip_len,
                                 vid_size=vid_size, scale_range=None,
                                 focus=focus)
    else:
        dataset = WildDetDataset(json_path, clip_len=clip_len, vid_size=None,
                                 scale_range=[1, 1], focus=focus)
    eval_step = make_mesh_eval_step(model, flip_tta=True)
    device = next(model.parameters()).device
    clips = [dataset[i] for i in range(len(dataset))]
    outs = run_batched(clips, int(args.get("infer_batch_size", 8)),
                       lambda b: eval_step(torch.from_numpy(b).to(device)))
    verts_all = np.concatenate([o["verts"] for o in outs])
    reg3d_all = np.concatenate([o["kp_3d"] for o in outs])
    if ref_3d_motion_path:
        ref_pose = np.load(ref_3d_motion_path)
        scale = solve_scale(ref_pose - ref_pose[:, :1],
                            reg3d_all - reg3d_all[:, :1])
        verts_all = verts_all - reg3d_all[:, :1] + ref_pose[:, :1] * scale
    np.save(os.path.join(out_path, "mesh_verts.npy"), verts_all)
    if render:
        from motionbert_tpu_torch.viz.render import motion2video_mesh

        motion2video_mesh(verts_all, os.path.join(out_path, "mesh.mp4"),
                          fps=fps_in, faces=model.head.smpl.faces)
    return verts_all, reg3d_all


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="In-the-wild mesh recovery: AlphaPose JSON in, "
                    "mesh_verts.npy and the mesh.mp4 video out.")
    parser.add_argument("--config", type=str,
                        default="configs/mesh/MB_ft_pw3d.yaml",
                        help="Path to the config file.")
    parser.add_argument("-e", "--evaluate", default="", type=str,
                        metavar="FILENAME", help="checkpoint to evaluate")
    parser.add_argument("-j", "--json_path", type=str, required=True,
                        help="alphapose detection result json path")
    parser.add_argument("-o", "--out_path", type=str, required=True,
                        help="output path")
    parser.add_argument("--ref_3d_motion_path", type=str, default=None,
                        help="3D motion path (for global trajectory)")
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


def main(argv=None) -> np.ndarray:
    from motionbert_tpu_torch.core.checkpoint import load_state_dict
    from motionbert_tpu_torch.core.config import get_config
    from motionbert_tpu_torch.models.smpl import SMPLModel
    from motionbert_tpu_torch.train.action import load_action_state
    from motionbert_tpu_torch.train.mesh import (
        build_mesh_model, smpl_model_path)

    opts = parse_args(argv)
    fps_in, vid_size = video_meta(opts)
    args = get_config(opts.config)
    model = build_mesh_model(args, SMPLModel.from_npz(smpl_model_path(args)),
                             device=opts.device, attn_impl=opts.attn_impl)
    if opts.evaluate:
        load_action_state(model, load_state_dict(opts.evaluate))
    else:
        print("WARNING: no checkpoint given (-e); using random init")
        model.init_weights(torch.Generator().manual_seed(0))
    verts, _ = run_wild_mesh(
        args, json_path=opts.json_path, out_path=opts.out_path, model=model,
        vid_size=vid_size, fps_in=fps_in, pixel=opts.pixel, focus=opts.focus,
        clip_len=opts.clip_len, ref_3d_motion_path=opts.ref_3d_motion_path,
        render=not opts.no_render)
    print("saved", os.path.join(opts.out_path, "mesh_verts.npy"),
          "shape", verts.shape)
    return verts


if __name__ == "__main__":
    main()
