"""The plain mesh-recovery model (MotionBERT, Zhu et al., ICCV 2023;
configs/mesh/MB_ft_h36m.yaml, model_mesh.py, loss_mesh.py, utils_mesh.py
and train_mesh.py of Walter0807/MotionBERT; the SMPL body model of Loper et
al., SIGGRAPH Asia 2015, as smplx's lbs.py writes it) in float32 PyTorch,
with TF32 off. It imports nothing of the program under test and takes none
of its state: the backbone is the plain DSTformer of ``dstformer.py``, the
rest is written out here.

    rep    = tanh(pre_logits(LayerNorm(DSTformer blocks(x))))  (N, T, J, C)
    pose   = head_pose(relu(bn1(fc1(drop(rep as (N T, J C)))))) + mean_pose
    shape  = head_shape(relu(bn2(fc2(drop(mean over T of rep))))) + mean_shape
    R      = rot6d -> rotation matrices (Gram-Schmidt on two columns)
    SMPL   v_shaped = template + shapedirs . betas;  J = J_regressor v_shaped
           v_posed  = v_shaped + posedirs . vec(R[1:] - I)
           A_k = A_parent(k) [R_k | J_k - J_parent(k)]  (the 24-joint chain)
           verts = (sum_k w_vk (A_k - [0 | A_k J_k])) [v_posed; 1], in mm
    kp     = J_h36m verts (17 joints)
    loss   = sum of the ten weighted terms of loss_mesh.py
    AdamW  two groups: the backbone at lr_backbone, the head at lr_head

Departures from the published description (each the program's too):

- Dropout draws its masks as ``torch.rand(shape, generator) < 1 - rate``
  on the given generator, the pose branch's (N T, J C) mask first, then the
  shape branch's (N, J C): the masks are the program's, not new ones.
- BatchNorm normalises with the biased batch variance, computed as
  E[x^2] - E[x]^2 clamped at 0 (flax's), eps 1e-5; its running averages are
  not kept, since no step here reads them.
- rot6d's normalisation divides by max(norm, 1e-6) (the published code's
  F.normalize uses 1e-12; only a column of norm under 1e-6 differs).
- The axis-angle of a predicted rotation (for ``loss_pose`` and
  ``loss_norm``) comes through the quaternion (Shepperd's branches by
  masks, as published) with the square root of sin^2 guarded at 0, where
  the published form has an infinite gradient; NaN axis-angles become 0.
- The body model is whatever tensors are passed in, in the layout of the
  official files (v_template (V, 3), shapedirs (V, 3, n_betas), posedirs
  (V, 3, 207), J_regressor (24, V), lbs_weights (V, 24), J_regressor_h36m
  (17, V), mean_pose (144,) in rot6d, mean_shape (n_betas,)). The
  benchmark's is ``draw_body``'s, a synthetic model drawn here from the
  seed at SMPL's published sizes (6,890 vertices, 24 joints, 10 betas, 207
  pose dims, a 17 x 6,890 H36M regressor), since the official
  SMPL_NEUTRAL and the H36M regressor are licensed downloads; the program
  gets the same tables through its own constructor.
- The backbone's own output head is built (its weights load) but never
  called, so it is no trainable parameter here; the program's AdamW skips
  it too, since it gets no gradient.

``low="head_bf16"`` runs the head and SMPL under bfloat16 autocast, and
``fp8=True`` builds the backbone with its pair products in float8 (see
``dstformer.py``): the reference a precision below the configuration's,
the controls of a mesh cell's limits.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from . import dstformer
from .pose3d import AdamW, flip, full_fp32

NUM_SMPL_JOINTS = 24
# the parent of each SMPL joint (root: -1)
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21)
# SMPL body parts swapped by a horizontal flip (utils_mesh.py flip_thetas)
SMPL_PAIRS = ((1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17), (18, 19),
              (20, 21), (22, 23))
# H36M-17: the 16 limbs and the 18 pairs of adjacent limbs whose angles
# loss.py compares
H36M_LIMBS = ((0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7), (7, 8),
              (8, 9), (9, 10), (8, 11), (11, 12), (12, 13), (8, 14), (14, 15),
              (15, 16))
H36M_ANGLES = ((0, 3), (0, 6), (3, 6), (0, 1), (1, 2), (3, 4), (4, 5), (6, 7),
               (7, 10), (7, 13), (8, 13), (10, 13), (7, 8), (8, 9), (10, 11),
               (11, 12), (13, 14), (14, 15))
# the YAML's ten loss weights, by term
LAMBDAS = {"loss_3d_pos": "lambda_3d", "loss_3d_scale": "lambda_scale",
           "loss_3d_velocity": "lambda_3dv", "loss_lv": "lambda_lv",
           "loss_lg": "lambda_lg", "loss_a": "lambda_a",
           "loss_av": "lambda_av", "loss_pose": "lambda_pose",
           "loss_shape": "lambda_shape", "loss_norm": "lambda_norm"}
BODY_KEYS = ("v_template", "shapedirs", "posedirs", "J_regressor",
             "lbs_weights", "J_regressor_h36m", "mean_pose", "mean_shape")
# the SMPL joint that each H36M-17 joint of ``draw_body``'s model sits at
# (pelvis, right leg, left leg, spine, thorax, neck, head, left arm, right
# arm)
H36M_AT = (0, 2, 5, 8, 1, 4, 7, 3, 6, 12, 15, 16, 18, 20, 17, 19, 21)


def _perm(pairs, n: int) -> list:
    p = list(range(n))
    for a, b in pairs:
        p[a], p[b] = b, a
    return p


SMPL_FLIP = _perm(SMPL_PAIRS, NUM_SMPL_JOINTS)


# -- rotations ---------------------------------------------------------------

def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (w, x, y, z), normalised here -> (..., 3, 3)."""
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        w * w + x * x - y * y - z * z, 2 * x * y - 2 * w * z,
        2 * w * y + 2 * x * z,
        2 * w * z + 2 * x * y, w * w - x * x + y * y - z * z,
        2 * y * z - 2 * w * x,
        2 * x * z - 2 * w * y, 2 * w * x + 2 * y * z,
        w * w - x * x - y * y + z * z], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3), through the quaternion, with the
    published 1e-8 inside the norm."""
    angle = (aa + 1e-8).norm(dim=-1, keepdim=True)
    q = torch.cat([torch.cos(angle / 2), torch.sin(angle / 2) * aa / angle],
                  -1)
    return quat_to_rotmat(q)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) read as a (3, 2) matrix -> (..., 3, 3) whose columns are the
    two columns Gram-Schmidt orthonormalised and their cross product."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / a1.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / b2.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -1)


def rotmat_to_axis_angle(r: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) -> (B, 3): Shepperd's quaternion of the transposed matrix,
    its four cases selected by masks, then ceres' quaternion to axis-angle;
    NaNs set to 0."""
    m = r.transpose(-1, -2)
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    d2, d0_d1, d0_nd1 = m22 < 1e-6, m00 > m11, m00 < -m11
    t = [1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22,
         1 + m00 + m11 + m22]
    qs = [torch.stack([m12 - m21, t[0], m01 + m10, m20 + m02], -1),
          torch.stack([m20 - m02, m01 + m10, t[1], m12 + m21], -1),
          torch.stack([m01 - m10, m20 + m02, m12 + m21, t[2]], -1),
          torch.stack([t[3], m12 - m21, m20 - m02, m01 - m10], -1)]
    masks = [(d2 & d0_d1), (d2 & ~d0_d1), (~d2 & d0_nd1), (~d2 & ~d0_nd1)]
    masks = [c.to(r.dtype) for c in masks]
    q = sum(qi * c[:, None] for qi, c in zip(qs, masks))
    q = q / torch.sqrt(sum(ti * c for ti, c in zip(t, masks)))[:, None] * 0.5
    sin_sq = (q[:, 1:] ** 2).sum(-1)
    pos = sin_sq > 0
    sin = torch.sqrt(torch.where(pos, sin_sq, torch.ones_like(sin_sq)))
    cos = q[:, 0]
    two = 2.0 * torch.where(cos < 0, torch.atan2(-sin, -cos),
                            torch.atan2(sin, cos))
    k = torch.where(pos, two / sin, torch.full_like(sin, 2.0))
    return torch.nan_to_num(q[:, 1:] * k[:, None])


def flip_theta(theta: torch.Tensor) -> torch.Tensor:
    """(..., 72 + n_betas) SMPL parameters mirrored: each joint's axis-angle
    with y and z negated, left and right parts swapped; betas kept."""
    pose = theta[..., :72].reshape(theta.shape[:-1] + (NUM_SMPL_JOINTS, 3))
    pose = torch.cat([pose[..., :1], -pose[..., 1:]], -1)[..., SMPL_FLIP, :]
    return torch.cat([pose.flatten(-2), theta[..., 72:]], -1)


# -- the body model -----------------------------------------------------------

def smpl(body: dict, betas: torch.Tensor, rotmats: torch.Tensor) -> tuple:
    """betas (B, n_betas), rotmats (B, 24, 3, 3) -> (vertices (B, V, 3) in
    mm, H36M joints (B, 17, 3) in mm), smplx's lbs in homogeneous 4 x 4
    transforms."""
    B = betas.shape[0]
    V = body["v_template"].shape[0]
    v_shaped = body["v_template"] + torch.einsum("bl,vkl->bvk", betas,
                                                 body["shapedirs"])
    joints = torch.einsum("jv,bvk->bjk", body["J_regressor"], v_shaped)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    feature = (rotmats[:, 1:] - eye).reshape(B, -1)                # (B, 207)
    offsets = feature @ body["posedirs"].reshape(V * 3, -1).t()
    v_posed = v_shaped + offsets.reshape(B, V, 3)
    parents = SMPL_PARENTS
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, list(
        parents[1:])]], 1)
    bottom = torch.zeros(B, NUM_SMPL_JOINTS, 1, 4, dtype=rotmats.dtype,
                         device=rotmats.device)
    bottom[..., 3] = 1.0
    local = torch.cat([torch.cat([rotmats, rel[..., None]], -1), bottom], -2)
    chain = [local[:, 0]]
    for j in range(1, NUM_SMPL_JOINTS):
        chain.append(chain[parents[j]] @ local[:, j])
    world = torch.stack(chain, 1)                            # (B, 24, 4, 4)
    homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], -1)
    moved = (world @ homo[..., None])[..., 0]                    # (B, 24, 4)
    rel_world = world - torch.cat([torch.zeros_like(world[..., :3]),
                                   moved[..., None]], -1)
    blend = (body["lbs_weights"] @ rel_world.reshape(B, NUM_SMPL_JOINTS, 16)
             ).reshape(B, V, 4, 4)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
    verts = (blend @ v_homo[..., None])[..., :3, 0] * 1000.0
    kp = torch.einsum("jv,bvk->bjk", body["J_regressor_h36m"], verts)
    return verts, kp


def draw_body(num_verts: int, num_betas: int, seed: int, device) -> dict:
    """A synthetic body model from a seed, in the official files' layout
    (``BODY_KEYS``), float32 on ``device``; drawn in float64 on the host,
    so that every device gets the same tables. A rest skeleton of bones 8
    to 20 cm long in random directions; each vertex 4 cm about a joint
    that owns it; each vertex skinned to its four nearest joints by
    exp(-d^2 / 2 (6 cm)^2), normalised; each joint regressed from every
    vertex by exp(-d^2 / 2 (3 cm)^2) about that joint, normalised, and each
    H36M joint by exp(-d^2 / 2 (4 cm)^2) about its SMPL joint (``H36M_AT``);
    shape and pose blend shapes N(0, 0.01^2) and N(0, 0.001^2) in metres;
    the mean pose the identity plus N(0, 0.05^2) in rot6d, the mean shape
    N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(int(seed) + 2)
    f64 = dict(generator=g, dtype=torch.float64)
    V, J = int(num_verts), NUM_SMPL_JOINTS
    joints = torch.zeros(J, 3, dtype=torch.float64)
    for j in range(1, J):
        d = torch.randn(3, **f64)
        length = 0.08 + 0.12 * torch.rand((), **f64)
        joints[j] = joints[SMPL_PARENTS[j]] + length * d / d.norm()
    owner = torch.randint(0, J, (V,), generator=g)
    v = joints[owner] + 0.04 * torch.randn(V, 3, **f64)
    d2 = ((v[:, None] - joints[None]) ** 2).sum(-1)                # (V, J)
    near = d2.topk(4, dim=1, largest=False).indices
    logits = torch.full_like(d2, -math.inf).scatter(
        1, near, -d2.gather(1, near) / (2 * 0.06 ** 2))
    at = lambda rows, s: torch.softmax(-d2[:, rows].t() / (2 * s * s), 1)
    rot6d_eye = torch.tensor([1.0, 0, 0, 1, 0, 0], dtype=torch.float64)
    body = {
        "v_template": v,
        "shapedirs": 0.01 * torch.randn(V, 3, int(num_betas), **f64),
        "posedirs": 0.001 * torch.randn(V, 3, 9 * (J - 1), **f64),
        "J_regressor": at(list(range(J)), 0.03),
        "lbs_weights": torch.softmax(logits, 1),
        "J_regressor_h36m": at(list(H36M_AT), 0.04),
        "mean_pose": rot6d_eye.repeat(J) + 0.05 * torch.randn(J * 6, **f64),
        "mean_shape": 0.1 * torch.randn(int(num_betas), **f64)}
    return {k: body[k].to(device=device, dtype=torch.float32)
            for k in BODY_KEYS}


@torch.no_grad()
def targets(body: dict, theta: torch.Tensor) -> dict:
    """The ground truth of (N, T, 72 + n_betas) SMPL parameters: theta, and
    the vertices and H36M joints in mm, both relative to the H36M root."""
    N, T = theta.shape[:2]
    rot = rodrigues(theta[..., :72].reshape(N * T, NUM_SMPL_JOINTS, 3))
    verts, kp = smpl(body, theta[..., 72:].reshape(N * T, -1), rot)
    root = kp[:, :1]
    return {"theta": theta, "verts": (verts - root).reshape(N, T, -1, 3),
            "kp_3d": (kp - root).reshape(N, T, -1, 3)}


# -- the network --------------------------------------------------------------

class BatchNorm(nn.Module):
    """Training-mode BatchNorm over (rows, features): biased batch variance,
    eps 1e-5. The running buffers are carried for the state dict only."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(0)
        var = ((x * x).mean(0) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-5) * self.weight) + self.bias


class Head(nn.Module):
    def __init__(self, dim_rep: int, num_joints: int, hidden: int,
                 num_betas: int, dropout: float):
        super().__init__()
        self.rate = dropout
        self.fc1 = nn.Linear(dim_rep * num_joints, hidden)
        self.bn1 = BatchNorm(hidden)
        self.fc2 = nn.Linear(dim_rep * num_joints, hidden)
        self.bn2 = BatchNorm(hidden)
        self.head_pose = nn.Linear(hidden, NUM_SMPL_JOINTS * 6)
        self.head_shape = nn.Linear(hidden, num_betas)

    def _drop(self, x: torch.Tensor, gen) -> torch.Tensor:
        if gen is None or self.rate == 0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=gen, device=gen.device,
                          dtype=torch.float32) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def forward(self, rep: torch.Tensor, body: dict, gen=None,
                low: str = "") -> dict:
        """rep (N, T, J, C) -> {"theta" (N, T, 72 + n_betas), "verts" (N, T,
        V, 3), "kp_3d" (N, T, 17, 3)}."""
        N, T, J, C = rep.shape
        feat = rep.float().reshape(N, T, J * C)
        pose = self._drop(feat.reshape(N * T, J * C), gen)
        shape = self._drop(feat.mean(1), gen)
        ctx = (torch.autocast(rep.device.type, dtype=torch.bfloat16)
               if low == "head_bf16" else contextlib.nullcontext())
        with ctx:
            pose = torch.relu(self.bn1(self.fc1(pose)))
            shape = torch.relu(self.bn2(self.fc2(shape)))
            pose = self.head_pose(pose) + body["mean_pose"]
            betas = self.head_shape(shape) + body["mean_shape"]
            betas = betas[:, None].expand(N, T, -1).reshape(N * T, -1)
            rot = rot6d_to_rotmat(pose.reshape(N * T, NUM_SMPL_JOINTS, 6))
            verts, kp = smpl(body, betas, rot)
        verts, kp, rot, betas = verts.float(), kp.float(), rot.float(), \
            betas.float()
        aa = rotmat_to_axis_angle(rot.reshape(-1, 3, 3)).reshape(N * T, 72)
        return {"theta": torch.cat([aa, betas], 1).reshape(N, T, -1),
                "verts": verts.reshape(N, T, -1, 3),
                "kp_3d": kp.reshape(N, T, -1, 3)}


class MeshModel(nn.Module):
    def __init__(self, config: dict, num_betas: int, fp8: bool = False):
        super().__init__()
        self.backbone = dstformer.DSTformer(
            **{k: config[k] for k in dstformer.MODEL_KEYS}, fp8=fp8)
        self.head = Head(int(config["dim_rep"]), int(config["num_joints"]),
                         int(config["hidden_dim"]), num_betas,
                         float(config["dropout"]))

    def representation(self, x: torch.Tensor) -> torch.Tensor:
        """The DSTformer's forward up to its pre-logits (N, T, J, dim_rep)."""
        b = self.backbone
        x = b.joints_embed(x) + b.pos_embed
        x = x + b.temp_embed[:, :x.shape[1]]
        for blk_st, blk_ts, gate in zip(b.blocks_st, b.blocks_ts, b.ts_attn):
            x_st, x_ts = blk_st(x), blk_ts(x)
            a = torch.softmax(gate(torch.cat([x_st, x_ts], -1)), dim=-1)
            x = x_st * a[..., 0:1] + x_ts * a[..., 1:2]
        return b.pre_logits(b.norm(x))

    def forward(self, x: torch.Tensor, body: dict, gen=None,
                low: str = "") -> dict:
        return self.head(self.representation(x), body, gen, low)


def build(config: dict, num_betas: int, device, fp8: bool = False
          ) -> MeshModel:
    """The plain mesh model of a configuration (backbone keys, hidden_dim,
    dropout), float32 on ``device``, its parameters left for
    ``load_state_dict``."""
    with torch.device(device):
        return MeshModel(config, num_betas, fp8)


def trainable(model: MeshModel) -> list:
    """[(name, parameter)] that a step trains: all but the backbone's
    unused output head."""
    return [(n, p) for n, p in model.named_parameters()
            if not n.startswith("backbone.head.")]


def draw_weights(config: dict, num_betas: int, seed: int, device) -> dict:
    """The whole model's state dict from a seed: the backbone's as
    ``dstformer.draw_weights`` draws it (under ``backbone.``), then every
    head parameter from one more normal draw at std 0.02, the BatchNorms'
    scales at 1 + 0.02 n; running averages at 0 and 1."""
    out = {f"backbone.{k}": v for k, v in
           dstformer.draw_weights(config, seed, device).items()}
    with torch.device("meta"):
        head = Head(int(config["dim_rep"]), int(config["num_joints"]),
                    int(config["hidden_dim"]), num_betas, 0.0)
    shapes = [(n, tuple(p.shape)) for n, p in head.named_parameters()]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    flat = 0.02 * torch.randn(sum(math.prod(s) for _, s in shapes),
                              generator=gen, device=device,
                              dtype=torch.float32)
    at = 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        out[f"head.{name}"] = 1.0 + t if name.startswith("bn") and \
            name.endswith(".weight") else t
    for bn in ("bn1", "bn2"):
        h = int(config["hidden_dim"])
        out[f"head.{bn}.running_mean"] = torch.zeros(h, device=device)
        out[f"head.{bn}.running_var"] = torch.ones(h, device=device)
        out[f"head.{bn}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=device)
    return out


# -- the loss -----------------------------------------------------------------

def _mpjpe(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(p - g, dim=-1).mean()


def _limb_lens(x: torch.Tensor) -> torch.Tensor:
    a, b = zip(*H36M_LIMBS)
    return torch.linalg.vector_norm(x[:, :, list(a)] - x[:, :, list(b)],
                                    dim=-1)


def _angles(x: torch.Tensor) -> torch.Tensor:
    a, b = zip(*H36M_LIMBS)
    limbs = x[:, :, list(a)] - x[:, :, list(b)]
    i, j = zip(*H36M_ANGLES)
    la, lb = limbs[:, :, list(i)], limbs[:, :, list(j)]
    cos = (la * lb).sum(-1) / (
        torch.linalg.vector_norm(la, dim=-1).clamp_min(1e-8)
        * torch.linalg.vector_norm(lb, dim=-1).clamp_min(1e-8))
    return torch.arccos(cos.clamp(-1 + 1e-7, 1 - 1e-7))


def loss_terms(out: dict, gt: dict) -> dict:
    """The ten terms of loss_mesh.py (L1 criterion), each a full mean, on
    joints relative to their root."""
    p = out["kp_3d"] - out["kp_3d"][:, :, :1]
    g = gt["kp_3d"] - gt["kp_3d"][:, :, :1]
    scale = ((g * p).sum(3, keepdim=True).mean(2, keepdim=True)
             / (p * p).sum(3, keepdim=True).mean(2, keepdim=True))
    vp, vg = p[:, 1:] - p[:, :-1], g[:, 1:] - g[:, :-1]
    ap, ag = _angles(p), _angles(g)
    pt, gtt = out["theta"].flatten(0, 1), gt["theta"].flatten(0, 1)
    rp = rodrigues(pt[:, :72].reshape(-1, 3))
    rg = rodrigues(gtt[:, :72].reshape(-1, 3))
    return {
        "loss_3d_pos": _mpjpe(p, g),
        "loss_3d_scale": _mpjpe(scale * p, g),
        "loss_3d_velocity": _mpjpe(vp, vg),
        "loss_lv": torch.var(_limb_lens(p), dim=1, unbiased=True).mean(),
        "loss_lg": (_limb_lens(p) - _limb_lens(g)).abs().mean(),
        "loss_a": (ap - ag).abs().mean(),
        "loss_av": ((ap[:, 1:] - ap[:, :-1]) - (ag[:, 1:] - ag[:, :-1])
                    ).abs().mean(),
        "loss_pose": (rp - rg).abs().mean(),
        "loss_shape": (pt[:, 72:] - gtt[:, 72:]).abs().mean(),
        "loss_norm": torch.linalg.vector_norm(pt, dim=-1).mean(),
    }


def total_loss(terms: dict, config: dict) -> torch.Tensor:
    return sum(float(config[LAMBDAS[k]]) * v for k, v in terms.items())


# -- the finetune steps -------------------------------------------------------

def train_steps(model: MeshModel, body: dict, batches: list, flips: list,
                generator: torch.Generator, config: dict, low: str = ""
                ) -> dict:
    """Run len(batches) AdamW steps of the finetune recipe on ``model``.

    batches: [(x (N, T, 17, 3), theta (N, T, 72 + n_betas)), ...] on the
    model's device, before the flip; flips: per step an (N,) bool tensor,
    True where the clip and its parameters are mirrored; generator: the
    dropout masks' source, seeded as the program's. The whole batch runs at
    once (BatchNorm's statistics are the batch's). Returns {"loss": [total
    per step], "terms": the first step's terms, "out": the first forward's
    outputs, "grad1": [first gradient per trainable parameter], "rep_grad":
    the first loss's gradient at the representation, "delta": [their
    change after the steps], "names"}."""
    named = trainable(model)
    params = [p for _, p in named]
    start = [p.detach().clone() for p in params]
    groups = [[p for n, p in named if n.startswith("backbone.")],
              [p for n, p in named if not n.startswith("backbone.")]]
    opts = [AdamW(g, float(config[lr]), float(config["weight_decay"]))
            for g, lr in zip(groups, ("lr_backbone", "lr_head"))]
    losses, grad1, terms1, out1, rep_grad = [], None, None, None, None
    model.train()
    with full_fp32():
        for (x, theta), fl in zip(batches, flips):
            f = fl.view(-1, 1, 1)
            x = torch.where(f[..., None], flip(x), x)
            gt = targets(body, torch.where(f, flip_theta(theta), theta))
            rep = model.representation(x)
            out = model.head(rep, body, generator, low)
            terms = loss_terms(out, gt)
            total = total_loss(terms, config)
            *grads, g_rep = torch.autograd.grad(total, params + [rep])
            losses.append(float(total.detach()))
            if grad1 is None:
                grad1 = [g.clone() for g in grads]
                rep_grad = g_rep.detach()
                terms1 = {k: float(v.detach()) for k, v in terms.items()}
                out1 = {k: v.detach() for k, v in out.items()}
            by_id = {id(p): g for p, g in zip(params, grads)}
            for opt in opts:
                opt.step([by_id[id(p)] for p in opt.params])
    delta = [p.detach() - s for p, s in zip(params, start)]
    return {"loss": losses, "terms": terms1, "out": out1, "grad1": grad1,
            "rep_grad": rep_grad, "delta": delta,
            "names": [n for n, _ in named]}


def backbone_grads(model: MeshModel, x: torch.Tensor,
                   rep_grad: torch.Tensor) -> dict:
    """{name: gradient} of each trained backbone parameter when
    ``rep_grad`` (N, T, J, C) comes back into the representation of ``x``
    (N, T, 17, 3): the backbone's backward alone, from a given gradient at
    its output."""
    named = [(n, p) for n, p in trainable(model) if n.startswith("backbone.")]
    model.train()
    with full_fp32():
        rep = model.representation(x)
        grads = torch.autograd.grad(
            rep, [p for _, p in named], grad_outputs=rep_grad.to(rep),
            allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named, grads)}


def head_step(model: MeshModel, body: dict, rep: torch.Tensor, gt: dict,
              generator: torch.Generator, config: dict, low: str = ""
              ) -> dict:
    """The head, SMPL and loss alone on a given representation (N, T, J,
    C) and ground truth, in training mode, their masks from ``generator``:
    {"out": the head's outputs, "grad": {name: first gradient}, "delta":
    {name: change after one AdamW step at lr_head}} for each head
    parameter, named as in the model's state dict. The head's parameters
    are put back after the step."""
    named = [(f"head.{n}", p) for n, p in model.head.named_parameters()]
    params = [p for _, p in named]
    start = [p.detach().clone() for p in params]
    model.train()
    with full_fp32():
        out = model.head(rep, body, generator, low)
        total = total_loss(loss_terms(out, gt), config)
        grads = torch.autograd.grad(total, params)
        AdamW(params, float(config["lr_head"]),
              float(config["weight_decay"])).step(list(grads))
    with torch.no_grad():
        delta = [p - s for p, s in zip(params, start)]
        for p, s in zip(params, start):
            p.copy_(s)
    names = [n for n, _ in named]
    return {"out": {k: v.detach() for k, v in out.items()},
            "grad": dict(zip(names, grads)), "delta": dict(zip(names, delta))}
