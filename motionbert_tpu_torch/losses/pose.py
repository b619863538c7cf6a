"""3D-pose training losses on tensors.

The port of ``motionbert_tpu/losses/pose.py`` (reference loss.py:56-203),
with the confidence-weighted 2D loss of pretraining on 2D-only data and the
weighted MPJPE and bone-length losses.
Every reduction is a full mean, as in the reference; the 16-limb and 18-angle
topologies come from ``geometry.skeleton``. Clips of one frame give zero for
the temporal terms.
"""

from __future__ import annotations

import torch

from motionbert_tpu_torch.geometry.skeleton import H36M_ANGLE_PAIRS, H36M_LIMBS

_LIMBS = torch.tensor(H36M_LIMBS)          # (16, 2)
_ANGLES = torch.tensor(H36M_ANGLE_PAIRS)   # (18, 2)
# the tables above per device: a copy from host memory would wait for all
# the work queued on the card at every loss. Made outside inference mode,
# so that a first call under it leaves an index that autograd may save.
_ON_DEVICE = {}


def _on(table: torch.Tensor, device) -> torch.Tensor:
    key = (id(table), device)
    out = _ON_DEVICE.get(key)
    if out is None:
        with torch.inference_mode(False):
            out = _ON_DEVICE[key] = table.to(device)
    return out


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero (sub)gradient at 0, where the norm of sqrt(sum)
    would give NaN: root-relative targets put the root joint there on every
    step (the JAX package's ``safe_norm``; the value is the plain norm)."""
    sq = (x * x).sum(dim)
    positive = sq > 0
    return torch.where(positive,
                       torch.sqrt(torch.where(positive, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def loss_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error."""
    assert predicted.shape == target.shape
    return safe_norm(predicted - target).mean()


def weighted_mpjpe(predicted: torch.Tensor, target: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Per-sample weighted MPJPE; w broadcasts over the per-joint errors."""
    assert predicted.shape == target.shape
    return (w * safe_norm(predicted - target)).mean()


def loss_2d_weighted(predicted: torch.Tensor, target: torch.Tensor,
                     conf: torch.Tensor) -> torch.Tensor:
    """Confidence-weighted 2D reprojection loss of 2D-only data (reference
    loss.py:72-77): the xy difference is weighted, then its L2 norm averaged.
    predicted, target (N, T, 17, C >= 2); conf (N, T, 17, 1)."""
    diff = (predicted[..., :2] - target[..., :2]) * conf
    return safe_norm(diff).mean()


def n_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE after the optimal per-sample, per-frame scale."""
    assert predicted.shape == target.shape
    norm_predicted = (predicted ** 2).sum(3, keepdim=True).mean(2, keepdim=True)
    norm_target = (target * predicted).sum(3, keepdim=True).mean(2, keepdim=True)
    return loss_mpjpe(norm_target / norm_predicted * predicted, target)


def loss_velocity(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE of the first temporal difference."""
    assert predicted.shape == target.shape
    if predicted.shape[1] <= 1:
        return predicted.new_zeros(())
    vel_p = predicted[:, 1:] - predicted[:, :-1]
    vel_t = target[:, 1:] - target[:, :-1]
    return safe_norm(vel_p - vel_t).mean()


def _limbs(x: torch.Tensor) -> torch.Tensor:
    """(N, T, 17, 3) -> (N, T, 16, 3) limb vectors."""
    idx = _on(_LIMBS, x.device)
    return x[:, :, idx[:, 0]] - x[:, :, idx[:, 1]]


def get_limb_lens(x: torch.Tensor) -> torch.Tensor:
    """(N, T, 17, 3) -> (N, T, 16) limb lengths."""
    return safe_norm(_limbs(x))


def loss_limb_var(x: torch.Tensor) -> torch.Tensor:
    """Temporal variance of the limb lengths, unbiased as torch.var."""
    if x.shape[1] <= 1:
        return x.new_zeros(())
    return torch.var(get_limb_lens(x), dim=1, unbiased=True).mean()


def loss_limb_gt(x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """L1 between predicted and ground-truth limb lengths."""
    return (get_limb_lens(x) - get_limb_lens(gt)).abs().mean()


def get_angles(x: torch.Tensor) -> torch.Tensor:
    """(N, T, 17, 3) -> (N, T, 18) angles between adjacent limbs: cosine
    similarity with the norms clamped at 1e-8, arccos of the cosine clipped
    to [-1 + 1e-7, 1 - 1e-7]."""
    eps = 1e-7
    limbs = _limbs(x)
    idx = _on(_ANGLES, x.device)
    a, b = limbs[:, :, idx[:, 0]], limbs[:, :, idx[:, 1]]
    na = safe_norm(a).clamp_min(1e-8)
    nb = safe_norm(b).clamp_min(1e-8)
    cos = (a * b).sum(-1) / (na * nb)
    return torch.arccos(cos.clamp(-1 + eps, 1 - eps))


def loss_angle(x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """L1 between predicted and ground-truth joint angles."""
    return (get_angles(x) - get_angles(gt)).abs().mean()


def loss_angle_velocity(x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """L1 of the first temporal difference of the joint angles."""
    assert x.shape == gt.shape
    if x.shape[1] <= 1:
        return x.new_zeros(())
    x_a, gt_a = get_angles(x), get_angles(gt)
    return ((x_a[:, 1:] - x_a[:, :-1]) - (gt_a[:, 1:] - gt_a[:, :-1])).abs().mean()


LAMBDA_KEYS = ("lambda_scale", "lambda_3d_velocity", "lambda_lv", "lambda_lg",
               "lambda_a", "lambda_av")


def pose3d_total_loss(predicted: torch.Tensor, target: torch.Tensor,
                      lambdas: dict) -> tuple:
    """The 7-term pose3d loss (reference train.py:177-191): (total, terms),
    ``terms`` with every term and the total."""
    terms = {
        "3d_pos": loss_mpjpe(predicted, target),
        "3d_scale": n_mpjpe(predicted, target),
        "3d_velocity": loss_velocity(predicted, target),
        "lv": loss_limb_var(predicted),
        "lg": loss_limb_gt(predicted, target),
        "angle": loss_angle(predicted, target),
        "angle_velocity": loss_angle_velocity(predicted, target),
    }
    total = (terms["3d_pos"]
             + lambdas["lambda_scale"] * terms["3d_scale"]
             + lambdas["lambda_3d_velocity"] * terms["3d_velocity"]
             + lambdas["lambda_lv"] * terms["lv"]
             + lambdas["lambda_lg"] * terms["lg"]
             + lambdas["lambda_a"] * terms["angle"]
             + lambdas["lambda_av"] * terms["angle_velocity"])
    terms["total"] = total
    return total, terms


def weighted_bonelen_loss(predict_3d_length: torch.Tensor,
                          gt_3d_length: torch.Tensor) -> torch.Tensor:
    """(reference loss.py:90-92)"""
    return 0.001 * ((predict_3d_length - gt_3d_length) ** 2).mean()


def weighted_boneratio_loss(predict_3d_length: torch.Tensor,
                            gt_3d_length: torch.Tensor) -> torch.Tensor:
    """(reference loss.py:94-96)"""
    return 0.1 * (((predict_3d_length - gt_3d_length) / gt_3d_length)
                  ** 2).mean()
