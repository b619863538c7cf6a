"""Rotation representations on tensors: axis-angle, quaternion (w, x, y, z),
rotation matrix and the 6D representation, and the SMPL theta flip.

The port of ``motionbert_tpu/geometry/rotations.py`` (reference
utils_mesh.py: batch_rodrigues 8-20, quat2mat 23-51, rot6d_to_rotmat
316-330, rotation_matrix_to_quaternion 139-219, quaternion_to_angle_axis
86-136, flip_thetas 458-484). The branches are ``torch.where`` selections,
as in the JAX package, so a batch takes no data-dependent control flow and
every gradient stays finite at the identity. The 6D representation is this
repository's (3, 2) column-major layout: the six values are a (3, 2) matrix
whose two columns are Gram-Schmidt orthonormalised.
``flip_thetas_np`` is the numpy twin the data loaders use.
"""

from __future__ import annotations

import numpy as np
import torch

# SMPL left/right body-part pairs swapped under a horizontal flip
# (reference utils_mesh.py:475)
SMPL_THETA_PAIRS = ((1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17),
                    (18, 19), (20, 21), (22, 23))


def _flip_perm() -> np.ndarray:
    perm = np.arange(24)
    for a, b in SMPL_THETA_PAIRS:
        perm[a], perm[b] = b, a
    return perm


SMPL_FLIP_PERM = _flip_perm()


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) as (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), with the
    reference's +1e-8 inside the norm (utils_mesh.py:11)."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=-1, keepdim=True)
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * (axisang / angle)],
                     dim=-1)
    return quat2mat(quat)


def f_normalize(v: torch.Tensor, dim: int = -1,
                eps: float = 1e-12) -> torch.Tensor:
    """torch's F.normalize with a NaN-free backward at a zero vector: the
    norm comes from a sum of squares guarded on both sides of the square
    root, and a zero vector maps to zero (the JAX package's
    ``f_normalize``)."""
    sq = (v * v).sum(dim, keepdim=True)
    pos = sq > 0
    n = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return v / torch.where(pos, n, torch.zeros_like(n)).clamp_min(eps)


def _gram_schmidt(x: torch.Tensor, eps: float) -> torch.Tensor:
    shape = x.shape[:-1]
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = f_normalize(a1, eps=eps)
    b2 = f_normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, eps=eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1).reshape(shape + (3, 3))


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> rotation matrix (..., 3, 3): Gram-Schmidt on
    the two columns of the (3, 2) matrix (Zhou et al. CVPR'19; reference
    utils_mesh.py:316-330, eps 1e-6)."""
    return _gram_schmidt(x, 1e-6)


def rot6d_to_rotmat_spin(x: torch.Tensor) -> torch.Tensor:
    """SPIN's variant (reference utils_mesh.py:294-313): the F.normalize
    clamp eps 1e-12, so a degenerate column gives a zero row, not NaN."""
    return _gram_schmidt(x, 1e-12)


def rotmat_to_quaternion(rotmat: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), (w, x, y, z):
    Shepperd's method, the variant of the largest trace term selected per
    matrix (reference utils_mesh.py:139-219, which reads the transpose)."""
    shape = rotmat.shape[:-2]
    mt = rotmat.reshape(-1, 3, 3).transpose(-1, -2)
    m00, m01, m02 = mt[:, 0, 0], mt[:, 0, 1], mt[:, 0, 2]
    m10, m11, m12 = mt[:, 1, 0], mt[:, 1, 1], mt[:, 1, 2]
    m20, m21, m22 = mt[:, 2, 0], mt[:, 2, 1], mt[:, 2, 2]
    mask_d2 = m22 < eps
    mask_d0_d1 = m00 > m11
    mask_d0_nd1 = m00 < -m11
    t0 = 1 + m00 - m11 - m22
    q0 = torch.stack([m12 - m21, t0, m01 + m10, m20 + m02], -1)
    t1 = 1 - m00 + m11 - m22
    q1 = torch.stack([m20 - m02, m01 + m10, t1, m12 + m21], -1)
    t2 = 1 - m00 - m11 + m22
    q2 = torch.stack([m01 - m10, m20 + m02, m12 + m21, t2], -1)
    t3 = 1 + m00 + m11 + m22
    q3 = torch.stack([t3, m12 - m21, m20 - m02, m01 - m10], -1)
    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1
    q = torch.where(c0[:, None], q0, torch.where(
        c1[:, None], q1, torch.where(c2[:, None], q2, q3)))
    t = torch.where(c0, t0, torch.where(c1, t1, torch.where(c2, t2, t3)))
    q = q * (0.5 / torch.sqrt(t))[:, None]
    return q.reshape(shape + (4,))


def quaternion_to_angle_axis(quaternion: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> axis-angle (..., 3) (ceres' formula). The
    identity branch is guarded on both sides, so its gradient is finite
    exactly at the identity, where the SMPL head starts."""
    q1, q2, q3 = quaternion[..., 1], quaternion[..., 2], quaternion[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    positive = sin_sq > 0.0
    sin_theta = torch.sqrt(torch.where(positive, sin_sq,
                                       torch.ones_like(sin_sq)))
    cos_theta = quaternion[..., 0]
    two_theta = 2.0 * torch.where(cos_theta < 0.0,
                                  torch.atan2(-sin_theta, -cos_theta),
                                  torch.atan2(sin_theta, cos_theta))
    k = torch.where(positive, two_theta / sin_theta,
                    2.0 * torch.ones_like(sin_theta))
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def rotmat_to_angle_axis(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3); NaNs become 0,
    as in the reference (utils_mesh.py:82)."""
    return torch.nan_to_num(
        quaternion_to_angle_axis(rotmat_to_quaternion(rotmat)))


def flip_thetas(thetas: torch.Tensor) -> torch.Tensor:
    """SMPL axis-angle poses (..., 24, 3) under a horizontal image flip: y
    and z components negated, left and right parts swapped (reference
    utils_mesh.py:458-513)."""
    flipped = torch.cat([thetas[..., :1], -thetas[..., 1:]], dim=-1)
    perm = torch.as_tensor(SMPL_FLIP_PERM, device=thetas.device)
    return flipped.index_select(-2, perm)


def flip_thetas_np(thetas) -> np.ndarray:
    """The numpy twin of ``flip_thetas``, for the data loaders."""
    thetas = np.asarray(thetas)
    flipped = np.concatenate([thetas[..., :1], -thetas[..., 1:]], axis=-1)
    return flipped[..., SMPL_FLIP_PERM, :]


def rectify_pose(pose) -> np.ndarray:
    """A global SMPL pose (72,) with its root rotation composed with a
    rotation by pi about x, which turns an upside-down body upright
    (reference utils_mesh.py:441-456); numpy in, numpy out."""
    pose = np.array(pose, copy=True)
    R_mod = batch_rodrigues(torch.tensor([[np.pi, 0.0, 0.0]],
                                         dtype=torch.float32))[0]
    R_root = batch_rodrigues(torch.as_tensor(pose[None, :3],
                                             dtype=torch.float32))[0]
    pose[:3] = rotmat_to_angle_axis((R_root @ R_mod)[None])[0].numpy()
    return pose
