"""The optimizer: AdamW with a learning rate that the epoch loop sets.

The port of ``motionbert_tpu/train/state.py``. ``torch.optim.AdamW`` with
betas (0.9, 0.999) and eps 1e-8 over one parameter group, decaying every
parameter, is optax ``adamw``'s arithmetic: p <- p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p). The learning rate lives in the group
(``set_lr``, ``scale_lr``), as the reference decays it per epoch
(train.py:359-362). ``freeze_except`` leaves the frozen parameters out of the
optimizer: they get no update and no decay, as optax's ``set_to_zero``
gives them. The action tasks train two parameter groups, the backbone and
the head, at their own learning rates (``make_two_group_adamw``; optax's
``multi_transform`` there).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch


def make_adamw(params: Iterable[torch.nn.Parameter], lr: float,
               weight_decay: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def make_two_group_adamw(model: torch.nn.Module, lr_backbone: float,
                         lr_head: float,
                         weight_decay: float) -> torch.optim.AdamW:
    """AdamW over the trainable parameters in two groups: group 0 the
    top-level ``backbone`` at ``lr_backbone``, group 1 everything else (the
    task head) at ``lr_head`` (``motionbert_tpu/train/action.py``
    ``make_two_group_adamw``; reference train_action.py:142-147)."""
    groups = ([], [])
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups[name.split(".")[0] != "backbone"].append(p)
    return torch.optim.AdamW(
        [{"params": groups[0], "lr": lr_backbone},
         {"params": groups[1], "lr": lr_head}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def scale_lr(optimizer: torch.optim.Optimizer, factor: float) -> None:
    """Multiply every group's learning rate by ``factor``."""
    for group in optimizer.param_groups:
        group["lr"] *= factor


def freeze_except(model: torch.nn.Module, patterns: Sequence[str],
                  scope: Optional[str] = None) -> List[torch.nn.Parameter]:
    """The parameters to train: those whose name contains one of
    ``patterns`` (reference partial_train_layers, learning.py:69-77). The
    others get ``requires_grad=False``; pass the returned list to
    ``make_adamw``. With ``scope``, only names containing it are subject to
    freezing: the action tasks freeze within the backbone and keep the head
    trainable (reference train_action.py:95-97)."""
    train = []
    for name, p in model.named_parameters():
        keep = (scope is not None and scope not in name) or any(
            pat in name for pat in patterns)
        p.requires_grad_(keep)
        if keep:
            train.append(p)
    return train
