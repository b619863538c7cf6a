"""Running meters and top-k accuracy (the port of
``motionbert_tpu/core/metrics.py``; reference learning.py:8-37)."""

from __future__ import annotations

import numpy as np
import torch


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


class DeviceMeters:
    """``AverageMeter``s for a step's 0-d loss tensors, kept on their device:
    ``update`` adds each term times its rows to a float64 running sum there,
    and ``read`` copies the sums and the last values to the host once. The
    sums are taken in the order and precision ``AverageMeter.update`` takes
    them, so ``read`` returns the meters that a ``float()`` of every term at
    every step would have built."""

    def __init__(self):
        self.keys, self.sums, self.last, self.count = None, None, None, 0

    def update(self, terms: dict, n: int) -> None:
        if self.keys is None:
            self.keys = list(terms)
        vals = torch.stack([terms[k].detach().double() for k in self.keys])
        self.sums = vals * n if self.sums is None else self.sums + vals * n
        self.last, self.count = vals, self.count + n

    def read(self) -> dict:
        """{term: AverageMeter} of every update so far ({} before any)."""
        if self.keys is None:
            return {}
        sums, last = torch.stack([self.sums, self.last]).cpu().tolist()
        out = {}
        for k, s, v in zip(self.keys, sums, last):
            m = out[k] = AverageMeter()
            m.val, m.sum, m.count = v, s, self.count
            m.avg = s / max(self.count, 1)
        return out


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
