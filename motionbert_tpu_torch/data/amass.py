"""AMASS SMPL sequences to H36M-17 joints through the port's SMPL layer.

The port of ``tools/preprocess_amass.py``'s ``amass_to_h36m_joints``
(reference tools/preprocess_amass.py, which runs human_body_prior's
BodyModel): each downsampled AMASS motion's per-frame pose, shape and
translation go through ``models.smpl.smpl_forward``, and
``J_regressor_h36m`` regresses the 17 H36M joints from the vertices.
AMASS poses are SMPL-H: [0:3] the root, [3:66] 21 body joints, then the
fingers. SMPL's two hand joints (22, 23) have no SMPL-H counterpart in the
body block, so their rotations are zero rather than finger parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from motionbert_tpu_torch.models.smpl import (
    SMPLModel, smpl_forward, vertices2joints)


def amass_to_h36m_joints(all_motions, smpl_model: SMPLModel,
                         batch_frames: int = 512) -> list:
    """all_motions: dicts with "poses" (N, >= 72), "betas" (>= 10,
    optional) and "trans" (N, 3, optional). Returns one (17, N, 3) float32
    joint sequence per motion, computed ``batch_frames`` frames at a time on
    the body model's device."""
    dev = smpl_model.v_template.device
    sequences = []
    for x in all_motions:
        raw = np.asarray(x["poses"], np.float32)
        n = len(raw)
        poses = np.zeros((n, 72), np.float32)
        poses[:, :66] = raw[:, :66]
        betas = np.broadcast_to(
            np.asarray(x.get("betas", np.zeros(10)), np.float32)[:10],
            (n, 10))
        trans = np.asarray(x.get("trans", np.zeros((n, 3))), np.float32)
        joints = []
        with torch.no_grad():
            for st in range(0, n, batch_frames):
                sl = slice(st, st + batch_frames)
                out = smpl_forward(
                    smpl_model, torch.from_numpy(betas[sl].copy()).to(dev),
                    torch.from_numpy(poses[sl]).to(dev), pose2rot=True,
                    transl=torch.from_numpy(trans[sl]).to(dev))
                joints.append(vertices2joints(smpl_model.J_regressor_h36m,
                                              out["vertices"]).cpu().numpy())
        sequences.append(np.transpose(np.concatenate(joints), (1, 0, 2)))
    return sequences
