"""Running meters and top-k accuracy (the port of
``motionbert_tpu/core/metrics.py``; reference learning.py:8-37)."""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Tracks the current value, running sum, count and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def accuracy_topk(logits, labels, topk=(1,)) -> list:
    """Top-k accuracy in percent of (N, classes) logits against (N,)
    labels, on the host. Tied logits break toward the lower class index,
    as torch.topk does (a stable sort of the negated logits)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    pred = np.argsort(-logits, axis=1, kind="stable")[:, :max(topk)]
    correct = pred == labels[:, None]
    n = labels.shape[0]
    return [100.0 * float(correct[:, :k].any(axis=1).sum()) / n for k in topk]
