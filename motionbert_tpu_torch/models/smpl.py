"""The SMPL body model on tensors: shape and pose blend shapes, the 24-joint
kinematic chain and linear blend skinning.

    v_shaped = v_template + shapedirs . betas
    J        = J_regressor @ v_shaped
    v_posed  = v_shaped + posedirs . vec(R[1:] - I)
    A_k      = A_parent(k) . [R_k | t_k]        (kinematic chain)
    verts    = (sum_k w_vk A'_k) . v_posed       (linear blend skinning)

The port of ``motionbert_tpu/models/smpl.py``. ``SMPLModel`` is an
``nn.Module`` whose float tensors are registered buffers, so ``.to(device)``
moves the body model with the network (they are not persistent: a mesh
model's state_dict holds the network's weights, as reference checkpoints
do); the kinematic ``parents`` and the ``faces`` stay numpy. The forward always runs
in fp32, whatever the caller's dtype. It reads the same ``.npz`` as the JAX
package (``tools/convert_smpl.py`` writes one from the official
SMPL_NEUTRAL.pkl), and ``SMPLModel.synthetic`` is this package's own copy of
the JAX package's seeded test model, equal to it for the same arguments.
The JAX package's ``array_pytree`` / ``with_arrays`` exist only to pass the
tensors through ``jax.jit`` as arguments; buffers need neither.
``smpl_forward_np`` is the numpy twin the data loaders use for their ground
truth.

Skinning keeps the top three rows of each blended transform, (B, V, 3, 4):
at a mesh training batch (2048 frames of 6890 vertices) that is 0.68 GB in
fp32 where the (B, V, 4, 4) of the JAX formulation is 0.9 GB, with the same
products for the rows that reach the vertices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from motionbert_tpu_torch.geometry.rotations import batch_rodrigues

# parent of each of the 24 joints of the SMPL kinematic tree (root: -1)
SMPL_PARENTS = np.array([
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
    19, 20, 21,
])
NUM_JOINTS = 24

# the float tensors of a model, required first
_REQUIRED = ("v_template", "shapedirs", "posedirs", "J_regressor",
             "lbs_weights")
_OPTIONAL = ("J_regressor_h36m", "J_regressor_extra", "mean_pose",
             "mean_shape")


class SMPLModel(nn.Module):
    """The body model's tensors as fp32 buffers: v_template (V, 3),
    shapedirs (V, 3, n_betas), posedirs (V, 3, 207), J_regressor (24, V),
    lbs_weights (V, 24), and where given J_regressor_h36m (17, V),
    J_regressor_extra, mean_pose (144,) in rot6d and mean_shape (n_betas,).
    ``parents`` (24,) and ``faces`` (F, 3) are numpy attributes."""

    def __init__(self, v_template, shapedirs, posedirs, J_regressor,
                 lbs_weights, parents=None, faces=None,
                 J_regressor_h36m=None, J_regressor_extra=None,
                 mean_pose=None, mean_shape=None):
        super().__init__()
        arrays = dict(v_template=v_template, shapedirs=shapedirs,
                      posedirs=posedirs, J_regressor=J_regressor,
                      lbs_weights=lbs_weights,
                      J_regressor_h36m=J_regressor_h36m,
                      J_regressor_extra=J_regressor_extra,
                      mean_pose=mean_pose, mean_shape=mean_shape)
        # not persistent: a network's state_dict holds its weights only, as
        # reference checkpoints do; the body model comes from its own file
        for name, a in arrays.items():
            self.register_buffer(name, None if a is None else torch.as_tensor(
                np.asarray(a, np.float32)), persistent=False)
        self.parents = np.asarray(SMPL_PARENTS if parents is None
                                  else parents, np.int64)
        self.faces = None if faces is None else np.asarray(faces, np.int64)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    def numpy(self, name: str) -> Optional[np.ndarray]:
        """A buffer as a numpy array on the host (None when absent)."""
        t = getattr(self, name)
        return None if t is None else t.detach().cpu().numpy()

    @classmethod
    def from_npz(cls, path: str) -> "SMPLModel":
        with np.load(path, allow_pickle=False) as z:
            get = lambda k: z[k] if k in z.files else None
            return cls(**{k: z[k] for k in _REQUIRED},
                       **{k: get(k) for k in _OPTIONAL},
                       parents=get("parents"), faces=get("faces"))

    @classmethod
    def synthetic(cls, num_verts: int = 128, num_betas: int = 10,
                  seed: int = 0) -> "SMPLModel":
        """A small random but consistent body model for tests, equal to the
        JAX package's ``SMPLModel.synthetic`` for the same arguments:
        vertices scattered around the joints of a random stick skeleton,
        skinned mostly to their joint and a little to its parent."""
        rs = np.random.RandomState(seed)
        joints = np.zeros((NUM_JOINTS, 3), np.float32)
        for j in range(1, NUM_JOINTS):
            direction = rs.normal(size=3)
            direction /= np.linalg.norm(direction)
            joints[j] = joints[SMPL_PARENTS[j]] + 0.15 * direction
        owner = rs.randint(0, NUM_JOINTS, num_verts)
        v_template = (joints[owner] + 0.05 * rs.normal(size=(num_verts, 3))
                      ).astype(np.float32)
        lbs = np.zeros((num_verts, NUM_JOINTS), np.float32)
        lbs[np.arange(num_verts), owner] = 0.8
        parent_owner = np.where(SMPL_PARENTS[owner] >= 0,
                                SMPL_PARENTS[owner], owner)
        lbs[np.arange(num_verts), parent_owner] += 0.2
        lbs /= lbs.sum(-1, keepdims=True)
        J_reg = np.zeros((NUM_JOINTS, num_verts), np.float32)
        for j in range(NUM_JOINTS):
            mask = owner == j
            if mask.any():
                J_reg[j, mask] = 1.0 / mask.sum()
            else:   # no vertex of its own: the nearest vertex
                J_reg[j, np.argmin(np.linalg.norm(v_template - joints[j],
                                                  axis=1))] = 1.0
        shapedirs = 0.01 * rs.normal(size=(num_verts, 3, num_betas))
        posedirs = 0.001 * rs.normal(size=(num_verts, 3,
                                           9 * (NUM_JOINTS - 1)))
        h36m = np.stack([J_reg[j % NUM_JOINTS] for j in range(17)])
        return cls(v_template=v_template, shapedirs=shapedirs,
                   posedirs=posedirs, J_regressor=J_reg, lbs_weights=lbs,
                   J_regressor_h36m=h36m,
                   # the identity in the (3, 2) column-major rot6d layout
                   mean_pose=np.tile(np.array([1, 0, 0, 1, 0, 0],
                                              np.float32), NUM_JOINTS),
                   mean_shape=np.zeros(num_betas, np.float32))


def _world_transforms(rotmats: torch.Tensor, joints: torch.Tensor,
                      parents: np.ndarray) -> tuple:
    """(posed joints (B, 24, 3), the (B, 24, 3, 4) top rows of each joint's
    world transform with the rest pose taken out)."""
    B = rotmats.shape[0]
    up = torch.as_tensor(parents[1:], device=joints.device)
    rel_j = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, up]], dim=1)
    bottom = rotmats.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, NUM_JOINTS,
                                                              1, 4)
    local = torch.cat([torch.cat([rotmats, rel_j[..., None]], -1), bottom],
                      -2)
    world = [local[:, 0]]
    for j in range(1, NUM_JOINTS):
        world.append(world[parents[j]] @ local[:, j])
    world = torch.stack(world, dim=1)                      # (B, 24, 4, 4)
    posed_joints = world[..., :3, 3]
    # A' = A - [0 | A . (J, 0)]: the transform of a rest-pose vertex
    shifted = (world[..., :3, :3] @ joints[..., None])[..., 0]
    rel = torch.cat([world[..., :3, :3],
                     (world[..., :3, 3] - shifted)[..., None]], -1)
    return posed_joints, rel


def smpl_forward(model: SMPLModel, betas: torch.Tensor, pose: torch.Tensor,
                 pose2rot: bool = True, transl=None) -> dict:
    """betas (B, n_betas); pose (B, 72) axis-angle, or (B, 24, 3, 3)
    rotation matrices with pose2rot=False. Returns {"vertices" (B, V, 3),
    "joints" (B, 24, 3), "rotmats" (B, 24, 3, 3)}, fp32."""
    betas = betas.float()
    B = betas.shape[0]
    if pose2rot:
        rotmats = batch_rodrigues(pose.float().reshape(B, NUM_JOINTS, 3))
    else:
        rotmats = pose.float().reshape(B, NUM_JOINTS, 3, 3)
    V = model.num_verts
    v_shaped = model.v_template + (
        betas @ model.shapedirs.reshape(V * 3, -1).t()).reshape(B, V, 3)
    joints = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)
    ident = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feature = (rotmats[:, 1:] - ident).reshape(B, -1)       # (B, 207)
    v_posed = v_shaped + (
        pose_feature @ model.posedirs.reshape(V * 3, -1).t()).reshape(B, V, 3)
    posed_joints, rel = _world_transforms(rotmats, joints, model.parents)
    T = (model.lbs_weights @ rel.reshape(B, NUM_JOINTS, 12)).reshape(
        B, V, 3, 4)
    verts = (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]
    if transl is not None:
        verts = verts + transl[:, None]
        posed_joints = posed_joints + transl[:, None]
    return {"vertices": verts, "joints": posed_joints, "rotmats": rotmats}


def vertices2joints(J_regressor: torch.Tensor,
                    vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) @ (B, V, 3) -> (B, J, 3) (smplx.lbs.vertices2joints)."""
    return torch.einsum("jv,bvc->bjc", J_regressor, vertices)


def smpl_forward_np(model: SMPLModel, betas, pose, dtype=np.float64) -> dict:
    """The numpy twin of ``smpl_forward`` (axis-angle pose), for the ground
    truth that the data loaders build on the host; float64 by default, the
    loaders pass float32. Returns fp32 {"vertices", "joints"}."""
    betas = np.asarray(betas, dtype)
    pose = np.asarray(pose, dtype).reshape(-1, NUM_JOINTS, 3)
    B = betas.shape[0]
    angle = np.linalg.norm(pose + 1e-8, axis=-1, keepdims=True)
    half = angle * 0.5
    quat = np.concatenate([np.cos(half), np.sin(half) * (pose / angle)], -1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    w, x, y, z = (quat[..., i] for i in range(4))
    R = np.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z),
        2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z,
    ], -1).reshape(B, NUM_JOINTS, 3, 3)

    arr = lambda name: model.numpy(name).astype(dtype, copy=False)
    V = model.num_verts
    v_shaped = arr("v_template") + (
        betas @ arr("shapedirs").reshape(V * 3, -1).T).reshape(B, V, 3)
    joints = np.matmul(arr("J_regressor"), v_shaped)             # (B, 24, 3)
    pose_feature = (R[:, 1:] - np.eye(3, dtype=R.dtype)).reshape(B, -1)
    v_posed = v_shaped + (
        pose_feature @ arr("posedirs").reshape(V * 3, -1).T).reshape(B, V, 3)

    parents = model.parents
    rel_j = joints.copy()
    rel_j[:, 1:] -= joints[:, parents[1:]]
    local = np.zeros((B, NUM_JOINTS, 4, 4), dtype=R.dtype)
    local[..., :3, :3] = R
    local[..., :3, 3] = rel_j
    local[..., 3, 3] = 1.0
    world = np.zeros_like(local)
    world[:, 0] = local[:, 0]
    for j in range(1, NUM_JOINTS):
        world[:, j] = world[:, parents[j]] @ local[:, j]
    posed_joints = world[..., :3, 3].copy()
    shifted = np.einsum("bjmn,bjn->bjm", world[..., :3, :3], joints)
    rel = world[:, :, :3, :].copy()
    rel[..., 3] -= shifted
    Tv = np.matmul(arr("lbs_weights"), rel.reshape(B, NUM_JOINTS, 12)
                   ).reshape(B, V, 3, 4)
    verts = (Tv[..., :3] * v_posed[:, :, None, :]).sum(-1) + Tv[..., 3]
    return {"vertices": verts.astype(np.float32),
            "joints": posed_joints.astype(np.float32)}
