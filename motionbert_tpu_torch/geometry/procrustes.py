"""Eval-protocol errors in numpy: MPJPE (Protocol 1) and Procrustes-aligned
P-MPJPE (Protocol 2).

The port's own copy of ``motionbert_tpu/geometry/procrustes.py``'s ``mpjpe``
and ``p_mpjpe`` (reference loss.py:8-51), vectorised over frames with a
batched SVD. They run on the host at evaluation time.
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
