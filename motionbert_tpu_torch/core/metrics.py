"""Running meters (the port of ``motionbert_tpu/core/metrics.py``'s
``AverageMeter``; reference learning.py:8-23)."""

from __future__ import annotations


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
