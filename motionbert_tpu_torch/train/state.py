"""The optimizer: AdamW with a learning rate that the epoch loop sets.

The port of ``motionbert_tpu/train/state.py``. ``torch.optim.AdamW`` with
betas (0.9, 0.999) and eps 1e-8 over one parameter group, decaying every
parameter, is optax ``adamw``'s arithmetic: p <- p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p). The learning rate lives in the group
(``set_lr``, ``scale_lr``), as the reference decays it per epoch
(train.py:359-362). ``freeze_except`` leaves the frozen parameters out of the
optimizer: they get no update and no decay, as optax's ``set_to_zero``
gives them.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import torch


def make_adamw(params: Iterable[torch.nn.Parameter], lr: float,
               weight_decay: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def scale_lr(optimizer: torch.optim.Optimizer, factor: float) -> None:
    """Multiply every group's learning rate by ``factor``."""
    for group in optimizer.param_groups:
        group["lr"] *= factor


def freeze_except(model: torch.nn.Module,
                  patterns: Sequence[str]) -> List[torch.nn.Parameter]:
    """The parameters to train: those whose name contains one of
    ``patterns`` (reference partial_train_layers, learning.py:69-77). The
    others get ``requires_grad=False``; pass the returned list to
    ``make_adamw``."""
    train = []
    for name, p in model.named_parameters():
        keep = any(pat in name for pat in patterns)
        p.requires_grad_(keep)
        if keep:
            train.append(p)
    return train
