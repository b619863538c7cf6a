"""H36M-17 left/right flip symmetry on tensors, the limb and angle
topologies of the pose losses, and the remaps from detector skeletons
(COCO-17, Halpe-26) to H36M-17 on the host.

The port's own copy of ``motionbert_tpu/geometry/skeleton.py``'s flip
(reference utils_data.py:54-66), of its ``H36M_LIMBS`` /
``H36M_ANGLE_PAIRS`` (reference loss.py:103-108, 159-176) and of its
``coco2h36m`` / ``halpe2h36m`` / ``posetrack2h36m`` (reference
dataset_action.py:31-74, dataset_wild.py:15-65, dataset_motion_2d.py:14-74).
Joint order:
0 root, 1 rhip, 2 rkne, 3 rank, 4 lhip, 5 lkne, 6 lank, 7 belly, 8 neck,
9 nose, 10 head, 11 lsho, 12 lelb, 13 lwri, 14 rsho, 15 relb, 16 rwri.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_JOINTS_H36M = 17
H36M_LEFT_JOINTS = (4, 5, 6, 11, 12, 13)
H36M_RIGHT_JOINTS = (1, 2, 3, 14, 15, 16)


def _flip_perm():
    perm = list(range(NUM_JOINTS_H36M))
    for left, right in zip(H36M_LEFT_JOINTS, H36M_RIGHT_JOINTS):
        perm[left], perm[right] = right, left
    return tuple(perm)


# Permutation that swaps left<->right joints (identity elsewhere).
H36M_FLIP_PERM = _flip_perm()

# 16-limb topology used by limb-length losses (reference loss.py:103-108).
H36M_LIMBS = (
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (0, 7), (7, 8), (8, 9), (9, 10),
    (8, 11), (11, 12), (12, 13),
    (8, 14), (14, 15), (15, 16),
)

# 18 limb-index pairs used by joint-angle losses (reference loss.py:159-176).
H36M_ANGLE_PAIRS = (
    (0, 3), (0, 6), (3, 6), (0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 10),
    (7, 13), (8, 13), (10, 13), (7, 8), (8, 9), (10, 11), (11, 12), (13, 14),
    (14, 15),
)


def flip_data(data: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of (..., 17, D) data: negate x (channel 0) and swap
    left/right joints. Returns a new tensor."""
    flipped = torch.cat([-data[..., :1], data[..., 1:]], dim=-1)
    perm = torch.tensor(H36M_FLIP_PERM, device=data.device)
    return flipped.index_select(-2, perm)


def flip_data_np(data) -> np.ndarray:
    """The numpy twin of ``flip_data``, for the data loaders."""
    flipped = np.array(data, copy=True)
    flipped[..., 0] *= -1
    return flipped[..., H36M_FLIP_PERM, :]


def _remap_matrix(rows: dict, num_src: int) -> np.ndarray:
    """A (17, num_src) mixing matrix from {h36m joint: [(source joint,
    weight), ...]}."""
    m = np.zeros((NUM_JOINTS_H36M, num_src), dtype=np.float64)
    for dst, srcs in rows.items():
        for src, w in srcs:
            m[dst, src] += w
    return m


# the 13 joints both detector skeletons share with H36M-17, by source index
_LIMB_ROWS = {1: 12, 2: 14, 3: 16, 4: 11, 5: 13, 6: 15, 9: 0, 11: 5, 12: 7,
              13: 9, 14: 6, 15: 8, 16: 10}

# COCO-17 -> H36M-17: root, belly, neck and head are averages
_COCO2H36M = _remap_matrix({
    **{dst: [(src, 1.0)] for dst, src in _LIMB_ROWS.items()},
    0: [(11, 0.5), (12, 0.5)],
    7: [(11, 0.25), (12, 0.25), (5, 0.25), (6, 0.25)],
    8: [(5, 0.5), (6, 0.5)],
    10: [(1, 0.5), (2, 0.5)]}, num_src=17)

# Halpe-26 -> H36M-17: Halpe has the hip (19), neck (18) and head (17)
_HALPE2H36M = _remap_matrix({
    **{dst: [(src, 1.0)] for dst, src in _LIMB_ROWS.items()},
    0: [(19, 1.0)],
    7: [(18, 0.5), (19, 0.5)],
    8: [(18, 1.0)],
    10: [(17, 1.0)]}, num_src=26)


# PoseTrack-17 -> H36M-17, the linear part: PoseTrack has the head bottom (1)
# and the head top (2); the belly is (root + head bottom) / 2
_POSETRACK2H36M = _remap_matrix({
    **{dst: [(src, 1.0)] for dst, src in _LIMB_ROWS.items()},
    0: [(11, 0.5), (12, 0.5)],
    7: [(11, 0.25), (12, 0.25), (1, 0.5)],
    8: [(1, 1.0)],
    10: [(2, 1.0)]}, num_src=17)


def _apply_remap(x, matrix: np.ndarray) -> np.ndarray:
    """x (..., V, C) -> (..., 17, C), always in floating point: an integer
    input is taken as float64, so the 0.5 and 0.25 weights survive."""
    x = np.asarray(x)
    dt = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64
    return np.einsum("jv,...vc->...jc", matrix.astype(dt), x.astype(dt))


def coco2h36m(x) -> np.ndarray:
    """COCO-17 keypoints (..., 17, C) -> H36M-17 (numpy, on the host)."""
    return _apply_remap(x, _COCO2H36M)


def halpe2h36m(x) -> np.ndarray:
    """Halpe-26 keypoints (..., 26, C) -> H36M-17 (numpy, on the host)."""
    return _apply_remap(x, _HALPE2H36M)


def posetrack2h36m(x) -> np.ndarray:
    """PoseTrack-17 keypoints (..., 17, 3) -> H36M-17 (numpy, on the host).
    The root's and the belly's confidences are the minimum over the joints
    they are averaged from (reference dataset_motion_2d.py:72-73)."""
    y = _apply_remap(x, _POSETRACK2H36M)
    x = np.asarray(x)
    y[..., 0, 2] = np.minimum(x[..., 11, 2], x[..., 12, 2])
    y[..., 7, 2] = np.minimum(y[..., 0, 2], y[..., 8, 2])
    return y
