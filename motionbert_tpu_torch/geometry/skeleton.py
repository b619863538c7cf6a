"""H36M-17 left/right flip symmetry on tensors, and the limb and angle
topologies of the pose losses.

The port's own copy of ``motionbert_tpu/geometry/skeleton.py``'s flip
(reference utils_data.py:54-66) and of its ``H36M_LIMBS`` /
``H36M_ANGLE_PAIRS`` (reference loss.py:103-108, 159-176). Joint order:
0 root, 1 rhip, 2 rkne, 3 rank, 4 lhip, 5 lkne, 6 lank, 7 belly, 8 neck,
9 nose, 10 head, 11 lsho, 12 lelb, 13 lwri, 14 rsho, 15 relb, 16 rwri.
"""

from __future__ import annotations

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
