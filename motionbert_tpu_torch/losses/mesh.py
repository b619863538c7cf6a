"""The mesh recovery loss and the mesh metrics.

The port of ``motionbert_tpu/losses/mesh.py`` (reference loss_mesh.py,
train_mesh.py:179-189, utils_mesh.py:357-438). The loss: the seven pose3d
terms on root-relative keypoints, the rotation matrices of the predicted
and ground-truth axis-angle poses (L1 or MSE), the betas (L1 or MSE), and
the norm of theta, weighted by the config's ten ``lambda_*`` keys, every one
required. The metrics run on the host in numpy: MPVE, MPJPE over 14 and 17
joints, and their Procrustes-aligned versions (numpy SVD, as the JAX
package runs them).
"""

from __future__ import annotations

import numpy as np
import torch

from motionbert_tpu_torch.geometry.procrustes import rigid_align
from motionbert_tpu_torch.geometry.rotations import batch_rodrigues
from motionbert_tpu_torch.losses.pose import (
    loss_angle, loss_angle_velocity, loss_limb_gt, loss_limb_var, loss_mpjpe,
    loss_velocity, n_mpjpe, safe_norm)

# the ten loss weights a mesh config must give (reference train_mesh.py:179-189)
LAMBDA_KEYS = ("lambda_3d", "lambda_scale", "lambda_3dv", "lambda_lv",
               "lambda_lg", "lambda_a", "lambda_av", "lambda_pose",
               "lambda_shape", "lambda_norm")
# term name -> its weight's key
_WEIGHTS = {"loss_3d_pos": "lambda_3d", "loss_3d_scale": "lambda_scale",
            "loss_3d_velocity": "lambda_3dv", "loss_lv": "lambda_lv",
            "loss_lg": "lambda_lg", "loss_a": "lambda_a", "loss_av": "lambda_av",
            "loss_pose": "lambda_pose", "loss_shape": "lambda_shape",
            "loss_norm": "lambda_norm"}
# the H36M-17 joints of the 14-joint protocol
H36M_17_TO_14 = (1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)


def mesh_loss_terms(smpl_output: dict, data_gt: dict,
                    loss_type: str = "L1") -> dict:
    """smpl_output, data_gt: theta (N, T, 72 + n_betas) and kp_3d (N, T, 17,
    3). The reference's loss_dict (loss_mesh.py:40-55), 0-d tensors."""
    if loss_type == "L1":
        crit = lambda a, b: (a - b).abs().mean()
    else:
        crit = lambda a, b: ((a - b) ** 2).mean()
    gt_theta = data_gt["theta"].flatten(0, 1)
    pred_theta = smpl_output["theta"].flatten(0, 1)
    preds_local = smpl_output["kp_3d"] - smpl_output["kp_3d"][:, :, 0:1]
    gt_local = data_gt["kp_3d"] - data_gt["kp_3d"][:, :, 0:1]
    pred_rotmat = batch_rodrigues(pred_theta[:, :72].reshape(-1, 3))
    gt_rotmat = batch_rodrigues(gt_theta[:, :72].reshape(-1, 3))
    return {
        "loss_3d_pos": loss_mpjpe(preds_local, gt_local),
        "loss_3d_scale": n_mpjpe(preds_local, gt_local),
        "loss_3d_velocity": loss_velocity(preds_local, gt_local),
        "loss_lv": loss_limb_var(preds_local),
        "loss_lg": loss_limb_gt(preds_local, gt_local),
        "loss_a": loss_angle(preds_local, gt_local),
        "loss_av": loss_angle_velocity(preds_local, gt_local),
        "loss_pose": crit(pred_rotmat, gt_rotmat),
        "loss_shape": crit(pred_theta[:, 72:], gt_theta[:, 72:]),
        # safe_norm: a zero theta row would make the whole batch's gradient
        # NaN through a plain norm
        "loss_norm": safe_norm(pred_theta).mean(),
    }


def mesh_total_loss(smpl_output: dict, data_gt: dict, lambdas,
                    loss_type: str = "L1") -> tuple:
    """(total, terms with "total"): the terms weighted by ``lambdas``, which
    must hold every key of LAMBDA_KEYS (a missing or misspelt one raises,
    as the reference's attribute reads do, instead of weighting its term 0)."""
    terms = mesh_loss_terms(smpl_output, data_gt, loss_type)
    total = sum(lambdas[_WEIGHTS[k]] * v for k, v in terms.items())
    terms["total"] = total
    return total, terms


def evaluate_mesh(results: dict) -> dict:
    """MPVE, MPJPE over 14 and 17 joints and their Procrustes-aligned
    versions, root-relative, in the units of the inputs (reference
    utils_mesh.py:395-438). results: numpy verts, verts_gt (..., V, 3),
    kp_3d, kp_3d_gt (..., 17, 3)."""
    pred_verts = results["verts"].reshape(-1, results["verts"].shape[-2], 3)
    target_verts = results["verts_gt"].reshape(
        -1, results["verts_gt"].shape[-2], 3)
    pred_j3ds = results["kp_3d"].reshape(-1, 17, 3)
    target_j3ds = results["kp_3d_gt"].reshape(-1, 17, 3)
    pred_verts = pred_verts - pred_j3ds[:, :1, :]
    target_verts = target_verts - target_j3ds[:, :1, :]
    mpve = np.mean(np.mean(np.sqrt(
        np.square(pred_verts - target_verts).sum(axis=2)), axis=1))
    pred_17 = pred_j3ds - pred_j3ds[:, :1, :]
    target_17 = target_j3ds - target_j3ds[:, :1, :]
    pred_14 = pred_17[:, H36M_17_TO_14, :].copy()
    target_14 = target_17[:, H36M_17_TO_14, :].copy()
    err = lambda p, t: np.mean(np.sqrt(np.square(p - t).sum(axis=2)), axis=1)
    aligned = lambda p, t: np.array([rigid_align(p[n], t[n])
                                     for n in range(len(p))])
    return {
        "mpve": float(mpve.mean()),
        "mpjpe": float(err(pred_14, target_14).mean()),
        "pa_mpjpe": float(err(aligned(pred_14, target_14), target_14).mean()),
        "mpjpe_17j": float(err(pred_17, target_17).mean()),
        "pa_mpjpe_17j": float(err(aligned(pred_17, target_17),
                                  target_17).mean()),
    }


def compute_error(smpl_output: dict, data_gt: dict) -> tuple:
    """Batch-mean (MPJPE, MPVE), root-relative, in the units of the inputs
    (reference utils_mesh.py:357-374)."""
    mpjpes, mpves = compute_error_frames(smpl_output, data_gt)
    return mpjpes.mean(), mpves.mean()


def compute_error_frames(smpl_output: dict, data_gt: dict) -> tuple:
    """Per-sample (MPJPE, MPVE) (reference utils_mesh.py:376-393); numpy
    arrays or tensors in, numpy out."""
    host = lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    pv, tv = host(smpl_output["verts"]), host(data_gt["verts"])
    pj, tj = host(smpl_output["kp_3d"]), host(data_gt["kp_3d"])
    pv = pv.reshape(-1, pv.shape[-2], 3)
    tv = tv.reshape(-1, tv.shape[-2], 3)
    pj, tj = pj.reshape(-1, 17, 3), tj.reshape(-1, 17, 3)
    mpves = np.sqrt((((pv - pj[:, :1]) - (tv - tj[:, :1])) ** 2).sum(-1)
                    ).mean(-1)
    mpjpes = np.sqrt((((pj - pj[:, :1]) - (tj - tj[:, :1])) ** 2).sum(-1)
                     ).mean(-1)
    return mpjpes, mpves
