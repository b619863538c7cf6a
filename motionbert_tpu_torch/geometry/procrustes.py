"""Eval-protocol errors in numpy: MPJPE (Protocol 1) and Procrustes-aligned
P-MPJPE (Protocol 2), the similarity alignment of the mesh metrics, and the
camera translation fit.

The port's own copy of ``motionbert_tpu/geometry/procrustes.py`` (reference
loss.py:8-51, utils_mesh.py:222-355): ``mpjpe`` and ``p_mpjpe`` vectorised
over frames with a batched SVD, ``rigid_transform_3d`` / ``rigid_align`` on
one point set, ``estimate_translation_np`` / ``estimate_translation``. They
run on the host at evaluation time.
"""

from __future__ import annotations

import numpy as np


def mpjpe(predicted, target):
    """(T, 17, 3) -> (T,): mean per-joint Euclidean distance per frame."""
    assert predicted.shape == target.shape
    return np.mean(
        np.linalg.norm(predicted - target, axis=len(target.shape) - 1), axis=1)


def p_mpjpe(predicted, target):
    """(T, 17, 3) -> (T,): MPJPE after a per-frame similarity (Procrustes)
    alignment, with the reflection fix."""
    assert predicted.shape == target.shape
    muX = np.mean(target, axis=1, keepdims=True)
    muY = np.mean(predicted, axis=1, keepdims=True)
    X0 = target - muX
    Y0 = predicted - muY
    normX = np.sqrt(np.sum(X0 ** 2, axis=(1, 2), keepdims=True))
    normY = np.sqrt(np.sum(Y0 ** 2, axis=(1, 2), keepdims=True))
    X0 /= normX
    Y0 /= normY

    H = np.matmul(X0.transpose(0, 2, 1), Y0)
    U, s, Vt = np.linalg.svd(H)
    V = Vt.transpose(0, 2, 1)
    R = np.matmul(V, U.transpose(0, 2, 1))

    # an improper rotation (reflection): flip the last singular vector
    sign_detR = np.sign(np.expand_dims(np.linalg.det(R), axis=1))
    V[:, :, -1] *= sign_detR
    s[:, -1] *= sign_detR.flatten()
    R = np.matmul(V, U.transpose(0, 2, 1))

    tr = np.expand_dims(np.sum(s, axis=1, keepdims=True), axis=2)
    a = tr * normX / normY
    t = muX - a * np.matmul(muY, R)
    predicted_aligned = a * np.matmul(predicted, R) + t
    return np.mean(
        np.linalg.norm(predicted_aligned - target, axis=len(target.shape) - 1),
        axis=1)


def rigid_transform_3d(A, B):
    """The similarity (c, R, t) that aligns A onto B, A and B (n, 3)."""
    n = A.shape[0]
    centroid_A = np.mean(A, axis=0)
    centroid_B = np.mean(B, axis=0)
    H = np.dot((A - centroid_A).T, B - centroid_B) / n
    U, s, V = np.linalg.svd(H)
    R = np.dot(V.T, U.T)
    if np.linalg.det(R) < 0:
        s[-1] = -s[-1]
        V[2] = -V[2]
        R = np.dot(V.T, U.T)
    varP = np.var(A, axis=0).sum()
    c = 1 / varP * np.sum(s)
    t = -np.dot(c * R, centroid_A.T) + centroid_B.T
    return c, R, t


def rigid_align(A, B):
    """A (n, 3) Procrustes-aligned onto B (n, 3)."""
    c, R, t = rigid_transform_3d(A, B)
    return (np.dot(c * R, A.T)).T + t


def estimate_translation_np(S, joints_2d, joints_conf, focal_length=5000.0,
                            img_size=224.0):
    """The camera translation (3,) that brings 3D joints S (n, 3) onto
    their 2D detections (n, 2), by confidence-weighted least squares
    (reference utils_mesh.py:222-263); joints_conf (n,)."""
    num_joints = S.shape[0]
    f = np.array([focal_length, focal_length])
    center = np.array([img_size / 2.0, img_size / 2.0])
    Z = np.reshape(np.tile(S[:, 2], (2, 1)).T, -1)
    XY = np.reshape(S[:, 0:2], -1)
    O = np.tile(center, num_joints)
    F = np.tile(f, num_joints)
    weight2 = np.reshape(np.tile(np.sqrt(joints_conf), (2, 1)).T, -1)
    Q = np.array([
        F * np.tile(np.array([1, 0]), num_joints),
        F * np.tile(np.array([0, 1]), num_joints),
        O - np.reshape(joints_2d, -1),
    ]).T
    c = (np.reshape(joints_2d, -1) - O) * Z - F * XY
    W = np.diagflat(weight2)
    Q = np.dot(W, Q)
    c = np.dot(W, c)
    return np.linalg.solve(np.dot(Q.T, Q), np.dot(Q.T, c))


def estimate_translation(S, joints_2d, focal_length=5000.0, img_size=224.0):
    """Per-sample translations (B, 3) fitted on joints 25: (the ground-truth
    block of the 49-joint layout; reference utils_mesh.py:266-291). S (B,
    49, 3); joints_2d (B, 49, 3), confidence in channel 2."""
    S = np.asarray(S)[:, 25:, :]
    joints = np.asarray(joints_2d)[:, 25:, :]
    conf = joints[:, :, -1]
    joints = joints[:, :, :-1]
    trans = np.zeros((S.shape[0], 3), dtype=np.float32)
    for i in range(S.shape[0]):
        trans[i] = estimate_translation_np(S[i], joints[i], conf[i],
                                           focal_length=focal_length,
                                           img_size=img_size)
    return trans
