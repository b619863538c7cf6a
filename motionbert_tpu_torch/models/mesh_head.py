"""The SMPL regression head and MeshRegressor, the backbone with the head.

The port of ``motionbert_tpu/models/mesh_head.py`` (reference
lib/model/model_mesh.py). The backbone's motion representation (N, T, J, C),
in its compute dtype (bf16 on the card, through the pair or stream
kernels), is cast to fp32, and the head runs in fp32 as the JAX head does:
a per-frame pose branch (dropout -> fc1 -> BatchNorm -> ReLU) and a
time-pooled shape branch (mean over T -> dropout -> fc2 -> BatchNorm ->
ReLU), residual heads over the body model's mean 24 x 6D pose and mean
betas, 6D -> rotation matrices, the SMPL forward (fp32), vertices in mm,
the 17 H36M joints through ``J_regressor_h36m``. Outputs: theta (the 72
axis-angle pose values and the betas), verts, kp_3d.

The BatchNorms are ``models.action_heads.BatchNorm1d`` (flax's: the biased
batch variance, momentum 0.1, eps 1e-5). Dropout draws from the
``torch.Generator`` passed to ``forward``, as the backbone's masks do.
Parameter and buffer names are the reference's (``backbone.*``,
``head.fc1``, ``head.bn1``, ``head.fc2``, ``head.bn2``, ``head.head_pose``,
``head.head_shape``); the body model's tensors are buffers of
``head.smpl`` that the state_dict leaves out. A JAX MeshRegressor has no
``backbone.head`` parameters (the backbone's output head is never called
under ``return_rep``), so its converted state_dict lacks those two keys and
nothing else.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from motionbert_tpu_torch.geometry.rotations import (
    rot6d_to_rotmat, rotmat_to_angle_axis)
from motionbert_tpu_torch.models.action_heads import BatchNorm1d
from motionbert_tpu_torch.models.dstformer import DSTformer, dropout
from motionbert_tpu_torch.models.smpl import SMPLModel, smpl_forward

# xavier-uniform gain of the residual heads (reference model_mesh.py:23-24)
HEAD_GAIN = 0.01


class SMPLRegressor(nn.Module):
    def __init__(self, smpl_model: SMPLModel, dim_rep: int = 512,
                 num_joints: int = 17, hidden_dim: int = 1024,
                 dropout_ratio: float = 0.0):
        super().__init__()
        self.smpl = smpl_model
        self.dropout_ratio = float(dropout_ratio)
        self.fc1 = nn.Linear(dim_rep * num_joints, hidden_dim)
        self.bn1 = BatchNorm1d(hidden_dim)
        self.fc2 = nn.Linear(dim_rep * num_joints, hidden_dim)
        self.bn2 = BatchNorm1d(hidden_dim)
        self.head_pose = nn.Linear(hidden_dim, 24 * 6)
        self.head_shape = nn.Linear(hidden_dim, smpl_model.num_betas)

    def forward(self, feat: torch.Tensor, generator=None) -> dict:
        """feat (N, T, J, C) fp32 -> {"theta" (N*T, 72 + n_betas), "verts"
        (N*T, V, 3), "kp_3d" (N*T, 17, 3)}, fp32, mm."""
        N, T, J, C = feat.shape
        feat = feat.reshape(N, T, J * C)
        pose = dropout(feat.reshape(N * T, J * C), self.dropout_ratio,
                       generator)
        pose = torch.relu(self.bn1(self.fc1(pose)))
        shape = dropout(feat.mean(1), self.dropout_ratio, generator)
        shape = torch.relu(self.bn2(self.fc2(shape)))
        m = self.smpl
        pred_pose = self.head_pose(pose) + m.mean_pose
        pred_shape = self.head_shape(shape) + m.mean_shape
        pred_shape = pred_shape[:, None].expand(N, T, -1).reshape(N * T, -1)
        rotmat = rot6d_to_rotmat(pred_pose.reshape(N * T, 24, 6))
        out = smpl_forward(m, pred_shape, rotmat, pose2rot=False)
        verts = out["vertices"] * 1000.0
        kp = torch.einsum("jv,bvc->bjc", m.J_regressor_h36m, verts)
        pose_aa = rotmat_to_angle_axis(rotmat.reshape(-1, 3, 3)).reshape(
            N * T, 72)
        return {"theta": torch.cat([pose_aa, pred_shape], 1), "verts": verts,
                "kp_3d": kp}


class MeshRegressor(nn.Module):
    """Backbone + SMPL head (reference model_mesh.py:82-101), outputs
    reshaped to (N, T, ...)."""

    def __init__(self, backbone: DSTformer, smpl_model: SMPLModel,
                 dim_rep: int = 512, num_joints: int = 17,
                 hidden_dim: int = 1024, dropout_ratio: float = 0.5):
        super().__init__()
        self.backbone = backbone
        self.num_joints = num_joints
        self.head = SMPLRegressor(smpl_model, dim_rep, num_joints, hidden_dim,
                                  dropout_ratio)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MeshRegressor":
        """The backbone's reference initialisation and flax's for the head:
        LeCun-normal weights truncated at 2 std for fc1 / fc2, xavier-uniform
        with gain 0.01 for head_pose / head_shape (the JAX head's
        variance_scaling(1e-4, fan_avg, uniform)), zero biases, BatchNorm
        scale 1, bias 0, unit running variance. Drawn on the CPU from
        ``generator``."""
        self.backbone.init_weights(generator)
        h = self.head
        for lin in (h.fc1, h.fc2):
            std = lin.in_features ** -0.5 / 0.87962566103423978
            lin.weight.copy_(nn.init.trunc_normal_(
                torch.empty(lin.weight.shape), std=std, a=-2 * std, b=2 * std,
                generator=generator))
        for lin in (h.head_pose, h.head_shape):
            limit = HEAD_GAIN * math.sqrt(
                6.0 / (lin.in_features + lin.out_features))
            lin.weight.copy_(torch.empty(lin.weight.shape).uniform_(
                -limit, limit, generator=generator))
        for lin in (h.fc1, h.fc2, h.head_pose, h.head_shape):
            nn.init.zeros_(lin.bias)
        h.bn1.reset_parameters()
        h.bn2.reset_parameters()
        return self

    def forward(self, x: torch.Tensor, generator=None) -> dict:
        """x (N, T, J, C) -> {"theta" (N, T, 72 + n_betas), "verts" (N, T,
        V, 3), "kp_3d" (N, T, 17, 3)}, fp32. generator: the source of every
        dropout and drop-path mask, read only in training mode with
        gradients enabled; needed then when a rate is above 0."""
        live = self.training and torch.is_grad_enabled()
        if live and generator is None and self.head.dropout_ratio > 0:
            raise ValueError("training with the head's dropout needs "
                             "forward(generator=...)")
        if not live:
            generator = None
        N, T = x.shape[:2]
        feat = self.backbone(x, return_rep=True, generator=generator)
        feat = feat.reshape(N, T, self.num_joints, -1).float()
        out = self.head(feat, generator)
        return {"theta": out["theta"].reshape(N, T, -1),
                "verts": out["verts"].reshape(N, T, -1, 3),
                "kp_3d": out["kp_3d"].reshape(N, T, -1, 3)}
