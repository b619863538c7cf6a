"""The work of one SMPL forward from its sizes alone, and its least time on
the H100's float32 peak.

What the mesh head's ``mesh.smpl`` span holds, per frame: the shape blend
(template + shapedirs . betas), the 24 joints regressed from it, the pose
blend (posedirs . vec(R[1:] - I), 207 values), the kinematic chain (23
products of 4 x 4 transforms) and the rest pose taken out of each joint's
transform, the skinning weights blending the 24 transforms a vertex, each
vertex moved by its 3 x 4 transform, the vertices scaled to mm and the 17
H36M joints regressed from them. The counts are the algorithm's: each
product once, the body model's tensors read once a forward, each frame's
betas and rotation matrices read once and its vertices and joints written
once; intermediates stay on the chip. Everything is float32.
"""

from __future__ import annotations

from benchmark.work import PEAK_HBM_BYTES

# NVIDIA H100 SXM, published dense float32 peak (no tensor cores)
PEAK_FP32_FLOPS = 66.9e12
SMPL_JOINTS = 24
POSE_DIMS = 9 * (SMPL_JOINTS - 1)
FP32 = 4


def _sizes(sizes: dict) -> tuple:
    return (int(sizes["num_verts"]), int(sizes["num_betas"]),
            int(sizes.get("num_joints", 17)))


def smpl_flops_per_frame(sizes: dict) -> int:
    """FLOPs of one frame's SMPL forward (a multiply-add counts 2)."""
    V, K, H = _sizes(sizes)
    J = SMPL_JOINTS
    flops = 2 * V * 3 * K + V * 3            # shape blend, template
    flops += 2 * J * V * 3                   # joints of the shaped mesh
    flops += POSE_DIMS                       # R - I
    flops += 2 * V * 3 * POSE_DIMS + V * 3   # pose blend, added
    flops += (J - 1) * 2 * 4 * 4 * 4         # the kinematic chain
    flops += J * (2 * 3 * 3 + 3)             # rest pose out of each
    flops += 2 * V * J * 12                  # blended 3 x 4 transforms
    flops += 2 * V * 3 * 3 + V * 3           # each vertex moved
    flops += V * 3                           # to mm
    flops += 2 * H * V * 3                   # H36M joints
    return flops


def smpl_model_bytes(sizes: dict) -> int:
    """Bytes of the body model's tensors one forward reads: template,
    shapedirs, posedirs, joint regressor, skinning weights, H36M
    regressor."""
    V, K, H = _sizes(sizes)
    J = SMPL_JOINTS
    return FP32 * (V * 3 + V * 3 * K + V * 3 * POSE_DIMS + J * V + V * J
                   + H * V)


def smpl_frame_bytes(sizes: dict) -> int:
    """Bytes a frame moves: its betas and 24 rotation matrices in, its
    vertices and H36M joints out."""
    V, K, H = _sizes(sizes)
    return FP32 * (K + SMPL_JOINTS * 9 + V * 3 + H * 3)


def smpl_cost(sizes: dict, frames: int) -> tuple:
    """(FLOPs, bytes) of one SMPL forward over ``frames`` frames."""
    return (frames * smpl_flops_per_frame(sizes),
            smpl_model_bytes(sizes) + frames * smpl_frame_bytes(sizes))


def smpl_least_s(sizes: dict, frames: int) -> float:
    """The least time the card could take for it: the larger of FLOPs over
    the float32 peak and bytes over HBM bandwidth."""
    flops, nbytes = smpl_cost(sizes, frames)
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
